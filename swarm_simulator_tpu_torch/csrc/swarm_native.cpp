// swarm_native: host-side C++ runtime for swarm_simulator_tpu.
//
// Implements the irreducibly sequential/branchy host components natively,
// mirroring the role the reference's C++ plays (third_party/ecbs/*,
// dynamicEDT3D, rbp_corridor.hpp):
//   * ECBS  — bounded-suboptimal multi-agent path finding on a 3-D grid
//             with radius-aware conflicts (environment.hpp:656-681)
//   * ESDF  — exact Euclidean distance transform (Felzenszwalb 3-pass)
//   * SFC   — greedy round-robin safe-flight-corridor box expansion
//             (rbp_corridor.hpp:99-147)
//
// Exposed through a plain C ABI consumed via ctypes (no pybind11 in the
// image).  Build: g++ -O3 -std=c++17 -shared -fPIC.
//
// The Python twins (search/ecbs.py, corridor/sfc.py, world/esdf.py) define
// the semantics; cross-checked in tests/test_native.py.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <memory>
#include <queue>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- ESDF ---

// 1-D lower-envelope squared distance transform (Felzenszwalb &
// Huttenlocher 2004), f/d in units of squared cells.
void edt1d(const double* f, double* d, int n, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -std::numeric_limits<double>::infinity();
  z[1] = std::numeric_limits<double>::infinity();
  for (int q = 1; q < n; ++q) {
    double s;
    while (true) {
      s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = std::numeric_limits<double>::infinity();
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = q - v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

}  // namespace

extern "C" void esdf_compute(const uint8_t* occ, int X, int Y, int Z,
                             double res, double max_dist, float* out) {
  const double INF = 1e18;
  std::vector<double> g(static_cast<size_t>(X) * Y * Z);
  auto idx = [&](int x, int y, int z) {
    return (static_cast<size_t>(x) * Y + y) * Z + z;
  };
  for (size_t i = 0; i < g.size(); ++i) g[i] = occ[i] ? 0.0 : INF;

  int nmax = std::max(std::max(X, Y), Z);
  std::vector<double> f(nmax), d(nmax), z(nmax + 1);
  std::vector<int> v(nmax);

  // pass over z
  for (int x = 0; x < X; ++x)
    for (int y = 0; y < Y; ++y) {
      for (int k = 0; k < Z; ++k) f[k] = g[idx(x, y, k)];
      edt1d(f.data(), d.data(), Z, v.data(), z.data());
      for (int k = 0; k < Z; ++k) g[idx(x, y, k)] = d[k];
    }
  // pass over y
  for (int x = 0; x < X; ++x)
    for (int k = 0; k < Z; ++k) {
      for (int y = 0; y < Y; ++y) f[y] = g[idx(x, y, k)];
      edt1d(f.data(), d.data(), Y, v.data(), z.data());
      for (int y = 0; y < Y; ++y) g[idx(x, y, k)] = d[y];
    }
  // pass over x
  for (int y = 0; y < Y; ++y)
    for (int k = 0; k < Z; ++k) {
      for (int x = 0; x < X; ++x) f[x] = g[idx(x, y, k)];
      edt1d(f.data(), d.data(), X, v.data(), z.data());
      for (int x = 0; x < X; ++x) g[idx(x, y, k)] = d[x];
    }

  for (size_t i = 0; i < g.size(); ++i) {
    double dist = std::sqrt(g[i]) * res;
    out[i] = static_cast<float>(std::min(dist, max_dist));
  }
}

// ----------------------------------------------------------------- ECBS ---

namespace {

struct St {
  int t, x, y, z;
};

inline uint64_t cellKey(int x, int y, int z) {
  return (static_cast<uint64_t>(x) << 40) | (static_cast<uint64_t>(y) << 20) |
         static_cast<uint64_t>(z);
}
inline uint64_t stateKey(int t, int x, int y, int z) {
  return (static_cast<uint64_t>(t) << 33) | (static_cast<uint64_t>(x) << 22) |
         (static_cast<uint64_t>(y) << 11) | static_cast<uint64_t>(z);
}
// edge: (t, from-cell, move-dir 0..6)
inline uint64_t edgeKey(int t, int x, int y, int z, int dir) {
  return (stateKey(t, x, y, z) << 3) | static_cast<uint64_t>(dir);
}

const int kMoves[7][3] = {{0, 0, 0},  {-1, 0, 0}, {1, 0, 0}, {0, 1, 0},
                          {0, -1, 0}, {0, 0, 1},  {0, 0, -1}};

inline int moveDir(int dx, int dy, int dz) {
  for (int i = 0; i < 7; ++i)
    if (kMoves[i][0] == dx && kMoves[i][1] == dy && kMoves[i][2] == dz)
      return i;
  return -1;
}

double segMinDistToOrigin(double ax, double ay, double az, double bx,
                          double by, double bz) {
  // Same rule as Vector::min_dist_to_origin (environment.hpp:69-93).
  double da = std::sqrt(ax * ax + ay * ay + az * az);
  if (ax == bx && ay == by && az == bz) return da;
  double db = std::sqrt(bx * bx + by * by + bz * bz);
  double dmin = std::min(da, db);
  double nx = bx - ax, ny = by - ay, nz = bz - az;
  double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
  nx /= nn; ny /= nn; nz /= nn;
  double adn = ax * nx + ay * ny + az * nz;
  double cx = ax - adn * nx, cy = ay - adn * ny, cz = az - adn * nz;
  double dc = std::sqrt(cx * cx + cy * cy + cz * cz);
  double dot = (cx - ax) * (cx - bx) + (cy - ay) * (cy - by) +
               (cz - az) * (cz - bz);
  if (dot < 0 && dmin > dc) dmin = dc;
  return dmin;
}

struct Env {
  int dimx, dimy, dimz;
  std::unordered_set<uint64_t> obstacles;
  std::vector<St> goals;
  std::vector<double> quad;
  double gridSize;

  bool vertexConflict(int i, int j, const St& a, const St& b) const {
    double rsum = quad[i] + quad[j];
    if (rsum < gridSize)
      return a.x == b.x && a.y == b.y && a.z == b.z;
    double dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
    return std::sqrt(dx * dx + dy * dy + dz * dz) * gridSize < rsum;
  }

  bool edgeConflict(int i, int j, const St& a1, const St& b1, const St& a2,
                    const St& b2) const {
    double rsum = quad[i] + quad[j];
    if (rsum < gridSize * 0.5)
      return a1.x == b2.x && a1.y == b2.y && a1.z == b2.z && b1.x == a2.x &&
             b1.y == a2.y && b1.z == a2.z;
    double d = segMinDistToOrigin(a2.x - a1.x, a2.y - a1.y, a2.z - a1.z,
                                  b2.x - b1.x, b2.y - b1.y, b2.z - b1.z);
    return d * gridSize <= rsum;
  }
};

using Path = std::vector<St>;

inline const St& stateAt(const Path& p, int t) {
  return t < static_cast<int>(p.size()) ? p[t] : p.back();
}

struct Constraints {
  std::unordered_set<uint64_t> vertex;  // stateKey
  std::unordered_set<uint64_t> edge;    // edgeKey
};

// Focal A* (a_star_epsilon.hpp semantics): open ordered by f, focal by
// (conflicts, f, -g) within w * fmin.  g(state) == t, so first arrival
// wins and a closed set suffices.
using Clock = std::chrono::steady_clock;

bool lowLevelSearch(const Env& env, int agent, const St& start,
                    const Constraints& cons,
                    const std::vector<Path>& solution, double w, int maxTime,
                    Clock::time_point deadline,
                    Path* outPath, int* outCost, int* outFmin) {
  long steps = 0;
  const St& goal = env.goals[agent];
  int lastGoalConstraint = -1;
  for (uint64_t vk : cons.vertex) {
    int z = vk & 0x7ff, y = (vk >> 11) & 0x7ff, x = (vk >> 22) & 0x7ff;
    int t = static_cast<int>(vk >> 33);
    if (x == goal.x && y == goal.y && z == goal.z)
      lastGoalConstraint = std::max(lastGoalConstraint, t);
  }

  std::vector<std::pair<int, const Path*>> others;
  for (size_t i = 0; i < solution.size(); ++i)
    if (static_cast<int>(i) != agent && !solution[i].empty())
      others.emplace_back(static_cast<int>(i), &solution[i]);

  auto h = [&](int x, int y, int z) {
    return std::abs(x - goal.x) + std::abs(y - goal.y) + std::abs(z - goal.z);
  };

  // Focal heuristics stay the naive O(#others) scan ON PURPOSE: a
  // bucketed variant (round 4) measured SLOWER end to end — each
  // lowLevelSearch call would pay ~18k hash inserts (255 others x 72
  // timesteps at 256 agents) to prune pair checks that cost ~1-2 ns
  // each, and the root total regressed 0.29 s -> 0.60 s.  Recorded so
  // it is not re-attempted.
  auto focalState = [&](const St& s) {
    int c = 0;
    for (auto& [i, p] : others)
      if (env.vertexConflict(agent, i, s, stateAt(*p, s.t))) ++c;
    return c;
  };
  auto focalTransition = [&](const St& a, const St& b) {
    int c = 0;
    for (auto& [i, p] : others)
      if (env.edgeConflict(agent, i, a, b, stateAt(*p, a.t),
                           stateAt(*p, b.t)))
        ++c;
    return c;
  };

  struct Node {
    int f, conf, g;
    uint64_t key;
    St s;
  };
  struct OpenCmp {
    bool operator()(const Node& a, const Node& b) const {
      if (a.f != b.f) return a.f > b.f;
      return a.g < b.g;  // prefer larger g on ties
    }
  };
  struct FocalCmp {
    bool operator()(const Node& a, const Node& b) const {
      if (a.conf != b.conf) return a.conf > b.conf;
      if (a.f != b.f) return a.f > b.f;
      return a.g < b.g;
    }
  };

  std::priority_queue<Node, std::vector<Node>, OpenCmp> open, pending;
  std::priority_queue<Node, std::vector<Node>, FocalCmp> focal;
  std::unordered_set<uint64_t> seen;   // open ∪ closed membership
  std::unordered_set<uint64_t> closed;
  std::unordered_map<uint64_t, uint64_t> cameFrom;
  std::unordered_map<uint64_t, int> confOf;

  St s0 = start;
  s0.t = 0;
  uint64_t k0 = stateKey(0, s0.x, s0.y, s0.z);
  int f0 = h(s0.x, s0.y, s0.z);
  int c0 = focalState(s0);
  seen.insert(k0);
  confOf[k0] = c0;
  open.push({f0, c0, 0, k0, s0});
  focal.push({f0, c0, 0, k0, s0});
  double bound = f0 * w;

  while (true) {
    if ((++steps & 1023) == 0 && Clock::now() > deadline) return false;
    // clean stale top of open, track fmin
    while (!open.empty() && closed.count(open.top().key)) open.pop();
    if (open.empty()) return false;
    int fmin = open.top().f;
    double newBound = fmin * w;
    if (newBound > bound) {
      bound = newBound;
      // move newly-qualified pending nodes into focal
      std::vector<Node> keep;
      while (!pending.empty() && pending.top().f <= bound) {
        focal.push(pending.top());
        pending.pop();
      }
    }
    while (!focal.empty() && closed.count(focal.top().key)) focal.pop();
    if (focal.empty()) {
      // cannot normally happen (any live node within the bound is in
      // focal); requeue a copy of the open head defensively
      focal.push(open.top());
      continue;
    }
    Node cur = focal.top();
    focal.pop();
    if (closed.count(cur.key)) continue;
    closed.insert(cur.key);

    const St& s = cur.s;
    if (s.x == goal.x && s.y == goal.y && s.z == goal.z &&
        s.t > lastGoalConstraint) {
      Path path;
      uint64_t k = cur.key;
      St st = s;
      while (true) {
        path.push_back(st);
        auto it = cameFrom.find(k);
        if (it == cameFrom.end()) break;
        k = it->second;
        st.t = static_cast<int>(k >> 33);
        st.x = (k >> 22) & 0x7ff;
        st.y = (k >> 11) & 0x7ff;
        st.z = k & 0x7ff;
      }
      std::reverse(path.begin(), path.end());
      *outPath = std::move(path);
      *outCost = s.t;
      *outFmin = fmin;
      return true;
    }

    if (s.t >= maxTime) continue;
    for (int mi = 0; mi < 7; ++mi) {
      int nx = s.x + kMoves[mi][0], ny = s.y + kMoves[mi][1],
          nz = s.z + kMoves[mi][2];
      if (nx < 0 || nx >= env.dimx || ny < 0 || ny >= env.dimy || nz < 0 ||
          nz >= env.dimz)
        continue;
      if (env.obstacles.count(cellKey(nx, ny, nz))) continue;
      uint64_t nk = stateKey(s.t + 1, nx, ny, nz);
      if (cons.vertex.count(nk)) continue;
      if (cons.edge.count(edgeKey(s.t, s.x, s.y, s.z, mi))) continue;
      if (seen.count(nk)) continue;
      seen.insert(nk);
      cameFrom[nk] = cur.key;
      St ns{s.t + 1, nx, ny, nz};
      int conf = cur.conf + focalState(ns) + focalTransition(s, ns);
      confOf[nk] = conf;
      int nf = (s.t + 1) + h(nx, ny, nz);
      Node nn{nf, conf, s.t + 1, nk, ns};
      open.push(nn);
      if (nf <= bound)
        focal.push(nn);
      else
        pending.push(nn);
    }
  }
}

struct Conflict {
  int time, a1, a2;
  bool edge;
  St s1, s2, s1b, s2b;
};

// Spatially bucketed first-conflict scan.  The naive scan is
// O(N^2 * T) pair checks per high-level expansion (environment.hpp's
// getFirstConflict analog) — 4.7M checks at 256 agents, the second
// hottest loop of the search.  Conflicts only occur between agents
// within rsum (vertex, environment.hpp:656-664) or rsum + 2 cells of
// relative motion (edge: each agent moves <= 1 cell per step, so the
// relative segment endpoint wanders <= 2 cells from its start), so
// bucketing agents on a coarse grid of side R = ceil(rsum_max) + 2
// cells reduces candidates to the 27 neighboring buckets.  Candidate
// pairs are visited in exactly the nested-loop (t, vertex-then-edge,
// lexicographic i<j) order, so the returned conflict — and therefore
// the whole high-level branching sequence — is bit-identical to the
// naive scan's.
bool firstConflict(const Env& env, const std::vector<Path>& sol, int tSafe,
                   int lastAgent, Conflict* out) {
  int maxT = 0;
  for (auto& p : sol) maxT = std::max(maxT, static_cast<int>(p.size()) - 1);
  int n = static_cast<int>(sol.size());
  double qmax = 0;
  for (double q : env.quad) qmax = std::max(qmax, q);
  const int R = static_cast<int>(std::ceil(2 * qmax / env.gridSize)) + 2;

  // Restricted prefix: this node's parent had NO conflicts before time
  // tSafe (its first conflict was at tSafe, where this node's agent
  // `lastAgent` was re-planned), so conflicts at t < tSafe can only
  // involve lastAgent.  Check only those pairs, in the same
  // lexicographic order the full scan would visit them.
  const int a = lastAgent;
  for (int t = 0; a >= 0 && t < std::min(tSafe, maxT); ++t) {
    const St& sa = stateAt(sol[a], t);
    const St& sab = stateAt(sol[a], t + 1);
    for (int j = 0; j < n; ++j) {
      if (j == a) continue;
      const St& sj = stateAt(sol[j], t);
      if (env.vertexConflict(a, j, sa, sj)) {
        if (j < a)
          *out = {t, j, a, false, sj, sa, {}, {}};
        else
          *out = {t, a, j, false, sa, sj, {}, {}};
        return true;
      }
    }
    for (int j = 0; j < n; ++j) {
      if (j == a) continue;
      const St& sja = stateAt(sol[j], t);
      const St& sjb = stateAt(sol[j], t + 1);
      if (env.edgeConflict(a, j, sa, sab, sja, sjb)) {
        if (j < a)
          *out = {t, j, a, true, sja, sa, sjb, sab};
        else
          *out = {t, a, j, true, sa, sja, sab, sjb};
        return true;
      }
    }
  }

  auto bkey = [&](int x, int y, int z) {
    return cellKey(x / R + 1, y / R + 1, z / R + 1);  // +1: coords >= 0
  };
  std::unordered_map<uint64_t, std::vector<int>> buckets;
  buckets.reserve(2 * n);
  std::vector<int> cand;

  for (int t = std::max(0, a >= 0 ? tSafe : 0); t < maxT; ++t) {
    buckets.clear();
    for (int j = 0; j < n; ++j) {
      const St& s = stateAt(sol[j], t);
      buckets[bkey(s.x, s.y, s.z)].push_back(j);  // ascending j
    }
    auto candidates = [&](const St& s, int i) {
      cand.clear();
      for (int dx = -1; dx <= 1; ++dx)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dz = -1; dz <= 1; ++dz) {
            auto it = buckets.find(cellKey(s.x / R + 1 + dx, s.y / R + 1 + dy,
                                           s.z / R + 1 + dz));
            if (it == buckets.end()) continue;
            for (int j : it->second)
              if (j > i) cand.push_back(j);
          }
      std::sort(cand.begin(), cand.end());
    };
    for (int i = 0; i < n; ++i) {
      const St& s1 = stateAt(sol[i], t);
      candidates(s1, i);
      for (int j : cand) {
        const St& s2 = stateAt(sol[j], t);
        if (env.vertexConflict(i, j, s1, s2)) {
          *out = {t, i, j, false, s1, s2, {}, {}};
          return true;
        }
      }
    }
    for (int i = 0; i < n; ++i) {
      const St& s1a = stateAt(sol[i], t);
      const St& s1b = stateAt(sol[i], t + 1);
      candidates(s1a, i);
      for (int j : cand) {
        const St& s2a = stateAt(sol[j], t);
        const St& s2b = stateAt(sol[j], t + 1);
        if (env.edgeConflict(i, j, s1a, s1b, s2a, s2b)) {
          *out = {t, i, j, true, s1a, s2a, s1b, s2b};
          return true;
        }
      }
    }
  }
  return false;
}

// Conflicts involving ONE agent — the incremental piece of
// countConflicts.  When a high-level child re-plans a single agent
// (ecbs.hpp:252-293 semantics), the pairwise conflict count changes
// only in pairs containing that agent, PROVIDED no two goals conflict
// permanently (checked once per solve; countConflicts is exact over
// [0, maxT) and agents other than `a` sit at their goals on the range
// where maxT differs between parent and child).
int conflictsInvolving(const Env& env, const std::vector<Path>& sol, int a,
                       int maxT) {
  int n = static_cast<int>(sol.size());
  int count = 0;
  for (int t = 0; t < maxT; ++t) {
    const St& s1 = stateAt(sol[a], t);
    const St& s1b = stateAt(sol[a], t + 1);
    for (int j = 0; j < n; ++j) {
      if (j == a) continue;
      if (env.vertexConflict(a, j, s1, stateAt(sol[j], t))) ++count;
      if (env.edgeConflict(a, j, s1, s1b, stateAt(sol[j], t),
                           stateAt(sol[j], t + 1)))
        ++count;
    }
  }
  return count;
}

int solMaxT(const std::vector<Path>& sol) {
  int maxT = 0;
  for (auto& p : sol) maxT = std::max(maxT, static_cast<int>(p.size()) - 1);
  return maxT;
}

int countConflicts(const Env& env, const std::vector<Path>& sol) {
  int maxT = 0;
  for (auto& p : sol) maxT = std::max(maxT, static_cast<int>(p.size()) - 1);
  int n = static_cast<int>(sol.size());
  int count = 0;
  for (int t = 0; t < maxT; ++t) {
    for (int i = 0; i < n; ++i) {
      const St& s1 = stateAt(sol[i], t);
      for (int j = i + 1; j < n; ++j)
        if (env.vertexConflict(i, j, s1, stateAt(sol[j], t))) ++count;
    }
    for (int i = 0; i < n; ++i) {
      const St& s1a = stateAt(sol[i], t);
      const St& s1b = stateAt(sol[i], t + 1);
      for (int j = i + 1; j < n; ++j)
        if (env.edgeConflict(i, j, s1a, s1b, stateAt(sol[j], t),
                             stateAt(sol[j], t + 1)))
          ++count;
    }
  }
  return count;
}

struct HLNode {
  std::vector<Path> solution;
  std::vector<Constraints> constraints;
  int cost, focalH;
  long id;
  // first-conflict prefix guarantee: conflicts at t < tSafe can only
  // involve lastAgent (the agent re-planned when this node was created)
  int tSafe = 0;
  int lastAgent = -1;
};

}  // namespace

extern "C" int ecbs_solve(int dimx, int dimy, int dimz,
                          const int32_t* obstacles, int nObstacles,
                          const int32_t* starts, const int32_t* goals,
                          const double* quadSize, int nAgents,
                          double gridSize, double w, long maxExpansions,
                          int maxTime, double timeoutSec, int32_t* outPaths,
                          int32_t* outLengths, int maxPathLen) {
  auto deadline = Clock::now() + std::chrono::microseconds(
      static_cast<long>((timeoutSec > 0 ? timeoutSec : 3600.0) * 1e6));
  Env env;
  env.dimx = dimx;
  env.dimy = dimy;
  env.dimz = dimz;
  env.gridSize = gridSize;
  for (int i = 0; i < nObstacles; ++i)
    env.obstacles.insert(
        cellKey(obstacles[3 * i], obstacles[3 * i + 1], obstacles[3 * i + 2]));
  for (int i = 0; i < nAgents; ++i) {
    env.goals.push_back({0, goals[3 * i], goals[3 * i + 1], goals[3 * i + 2]});
    env.quad.push_back(quadSize[i]);
  }
  if (maxTime <= 0) maxTime = 2 * dimx * dimy * dimz + 100;

  const bool verbose = std::getenv("SWARM_ECBS_VERBOSE") != nullptr;
  auto tRoot0 = Clock::now();

  // root node
  auto root = std::make_shared<HLNode>();
  root->solution.resize(nAgents);
  root->constraints.resize(nAgents);
  root->cost = 0;
  root->id = 0;
  for (int i = 0; i < nAgents; ++i) {
    St s{0, starts[3 * i], starts[3 * i + 1], starts[3 * i + 2]};
    int cost, fmin;
    if (!lowLevelSearch(env, i, s, root->constraints[i], root->solution, w,
                        maxTime, deadline, &root->solution[i], &cost, &fmin))
      return -1;
    root->cost += cost;
  }
  root->focalH = countConflicts(env, root->solution);
  // incremental focalH is exact iff no two goals conflict permanently
  // (see conflictsInvolving); check once, fall back to full recounts if so
  bool goalsClean = true;
  for (int i = 0; i < nAgents && goalsClean; ++i)
    for (int j = i + 1; j < nAgents; ++j) {
      const St& gi = env.goals[i];
      const St& gj = env.goals[j];
      if (env.vertexConflict(i, j, gi, gj) ||
          env.edgeConflict(i, j, gi, gi, gj, gj)) {
        goalsClean = false;
        break;
      }
    }
  auto tRoot1 = Clock::now();
  if (verbose)
    std::fprintf(stderr, "[ecbs] root: %.3fs focalH=%d\n",
                 std::chrono::duration<double>(tRoot1 - tRoot0).count(),
                 root->focalH);

  struct OpenCmp {
    bool operator()(const std::shared_ptr<HLNode>& a,
                    const std::shared_ptr<HLNode>& b) const {
      if (a->cost != b->cost) return a->cost > b->cost;
      return a->id > b->id;
    }
  };
  struct FocalCmp {
    bool operator()(const std::shared_ptr<HLNode>& a,
                    const std::shared_ptr<HLNode>& b) const {
      if (a->focalH != b->focalH) return a->focalH > b->focalH;
      if (a->cost != b->cost) return a->cost > b->cost;
      return a->id > b->id;
    }
  };

  std::priority_queue<std::shared_ptr<HLNode>,
                      std::vector<std::shared_ptr<HLNode>>, OpenCmp>
      open, pending;
  std::priority_queue<std::shared_ptr<HLNode>,
                      std::vector<std::shared_ptr<HLNode>>, FocalCmp>
      focal;
  std::unordered_set<long> popped;

  open.push(root);
  focal.push(root);
  double bound = root->cost * w;
  long nextId = 1;
  long expansions = 0;
  double tFirstConf = 0, tLowLevel = 0, tCountConf = 0, tCopy = 0;

  while (true) {
    while (!open.empty() && popped.count(open.top()->id)) open.pop();
    if (open.empty()) return -2;
    double newBound = open.top()->cost * w;
    if (newBound > bound) {
      bound = newBound;
      while (!pending.empty() && pending.top()->cost <= bound) {
        focal.push(pending.top());
        pending.pop();
      }
    }
    while (!focal.empty() && popped.count(focal.top()->id)) focal.pop();
    if (focal.empty()) {
      focal.push(open.top());
      continue;
    }
    auto node = focal.top();
    focal.pop();
    if (popped.count(node->id)) continue;
    popped.insert(node->id);
    if (++expansions > maxExpansions) return -3;
    if (Clock::now() > deadline) return -4;

    Conflict conflict;
    auto tc0 = Clock::now();
    bool hasConflict = firstConflict(env, node->solution, node->tSafe,
                                     node->lastAgent, &conflict);
    tFirstConf += std::chrono::duration<double>(Clock::now() - tc0).count();
    if (!hasConflict) {
      if (verbose)
        std::fprintf(
            stderr,
            "[ecbs] high-level: %.3fs expansions=%ld firstConf=%.3fs "
            "lowLevel=%.3fs countConf=%.3fs copy=%.3fs\n",
            std::chrono::duration<double>(Clock::now() - tRoot1).count(),
            expansions, tFirstConf, tLowLevel, tCountConf, tCopy);
      // write out the solution
      for (int i = 0; i < nAgents; ++i) {
        const Path& p = node->solution[i];
        int len = std::min(static_cast<int>(p.size()), maxPathLen);
        outLengths[i] = len;
        for (int t = 0; t < len; ++t) {
          outPaths[(static_cast<long>(i) * maxPathLen + t) * 3 + 0] = p[t].x;
          outPaths[(static_cast<long>(i) * maxPathLen + t) * 3 + 1] = p[t].y;
          outPaths[(static_cast<long>(i) * maxPathLen + t) * 3 + 2] = p[t].z;
        }
      }
      return 0;
    }

    // branch: constrain each conflicting agent in turn.  The two child
    // re-plans are independent (disjoint constraint copies, const env /
    // parent node) — run them on two threads (ecbs.hpp:252-293 does
    // them serially); push order stays side 0 then 1, so the search
    // remains deterministic.
    auto tll0 = Clock::now();
    std::shared_ptr<HLNode> children[2];
    bool childOk[2] = {false, false};
    auto makeChild = [&](int side) {
      int agent = side == 0 ? conflict.a1 : conflict.a2;
      auto child = std::make_shared<HLNode>(*node);
      child->tSafe = conflict.time;
      child->lastAgent = agent;
      if (!conflict.edge) {
        const St& s = side == 0 ? conflict.s1 : conflict.s2;
        child->constraints[agent].vertex.insert(
            stateKey(conflict.time, s.x, s.y, s.z));
      } else {
        const St& a = side == 0 ? conflict.s1 : conflict.s2;
        const St& b = side == 0 ? conflict.s1b : conflict.s2b;
        int dir = moveDir(b.x - a.x, b.y - a.y, b.z - a.z);
        child->constraints[agent].edge.insert(
            edgeKey(conflict.time, a.x, a.y, a.z, dir));
      }
      // incremental focal heuristic: subtract this agent's pair
      // conflicts in the parent solution before the re-plan, add them
      // back on the child's — identical counts to a full recount
      // (goalsClean guard above), at O(N*T) instead of O(N^2*T)
      int confBefore =
          goalsClean
              ? conflictsInvolving(env, node->solution, agent,
                                   solMaxT(node->solution))
              : 0;
      St s{0, starts[3 * agent], starts[3 * agent + 1], starts[3 * agent + 2]};
      int cost, fmin;
      if (!lowLevelSearch(env, agent, s, child->constraints[agent],
                          child->solution, w, maxTime, deadline,
                          &child->solution[agent], &cost, &fmin))
        return;
      child->cost = 0;
      for (auto& p : child->solution)
        child->cost += static_cast<int>(p.size()) - 1;
      if (goalsClean)
        child->focalH = node->focalH - confBefore +
                        conflictsInvolving(env, child->solution, agent,
                                           solMaxT(child->solution));
      else
        child->focalH = countConflicts(env, child->solution);
      children[side] = child;
      childOk[side] = true;
    };
    std::thread t1(makeChild, 1);
    makeChild(0);
    t1.join();
    tLowLevel += std::chrono::duration<double>(Clock::now() - tll0).count();

    for (int side = 0; side < 2; ++side) {
      if (!childOk[side]) continue;
      auto& child = children[side];
      child->id = nextId++;
      open.push(child);
      if (child->cost <= bound)
        focal.push(child);
      else
        pending.push(child);
    }
  }
}

// ------------------------------------------------------------------ SFC ---

namespace {

struct SfcCtx {
  const float* esdf;
  int X, Y, Z;
  double res;
  const int64_t* i0;
  const double* wmin;
  const double* wmax;
  double bxy, bz;
};

constexpr double kEps = 1e-9;      // SP_EPSILON
constexpr double kEpsF = 1e-6;     // SP_EPSILON_FLOAT

double queryEsdf(const SfcCtx& c, double px, double py, double pz) {
  long ix = static_cast<long>(std::floor(px / c.res)) - c.i0[0];
  long iy = static_cast<long>(std::floor(py / c.res)) - c.i0[1];
  long iz = static_cast<long>(std::floor(pz / c.res)) - c.i0[2];
  if (ix < 0 || ix >= c.X || iy < 0 || iy >= c.Y || iz < 0 || iz >= c.Z)
    return -1.0;
  return c.esdf[(ix * c.Y + iy) * c.Z + iz];
}

// isObstacleInBox (rbp_corridor.hpp:44-78): sample the box at box res with
// epsilon-shifted boundaries.
bool obstacleInBox(const SfcCtx& c, const double* box, double margin) {
  int count1 = 0;
  for (double i = box[0]; i < box[3] + kEpsF; i += c.bxy) {
    int count2 = 0;
    for (double j = box[1]; j < box[4] + kEpsF; j += c.bxy) {
      int count3 = 0;
      for (double k = box[2]; k < box[5] + kEpsF; k += c.bz) {
        double x = i + kEpsF;
        if (count1 == 0 && box[0] > c.wmin[0] + kEpsF) x = box[0] - kEpsF;
        double y = j + kEpsF;
        if (count2 == 0 && box[1] > c.wmin[1] + kEpsF) y = box[1] - kEpsF;
        double z = k + kEpsF;
        if (count3 == 0 && box[2] > c.wmin[2] + kEpsF) z = box[2] - kEpsF;
        double dist = queryEsdf(c, x, y, z);
        if (dist < margin - kEpsF) return true;
        ++count3;
      }
      ++count2;
    }
    ++count1;
  }
  return false;
}

bool boxInBoundary(const SfcCtx& c, const double* box) {
  return box[0] > c.wmin[0] - kEps && box[1] > c.wmin[1] - kEps &&
         box[2] > c.wmin[2] - kEps && box[3] < c.wmax[0] + kEps &&
         box[4] < c.wmax[1] + kEps && box[5] < c.wmax[2] + kEps;
}

bool pointInBox(const double* p, const double* box) {
  return p[0] > box[0] - kEps && p[1] > box[1] - kEps && p[2] > box[2] - kEps &&
         p[0] < box[3] + kEps && p[1] < box[4] + kEps && p[2] < box[5] + kEps;
}

// expand_box (rbp_corridor.hpp:99-147): greedy round-robin axis expansion.
void expandBox(const SfcCtx& c, double* box, double margin) {
  std::vector<int> axisCand{0, 1, 2, 3, 4, 5};
  int i = -1;
  while (!axisCand.empty()) {
    double boxCand[6], boxUpdate[6];
    std::memcpy(boxCand, box, sizeof boxCand);
    std::memcpy(boxUpdate, box, sizeof boxUpdate);
    while (!obstacleInBox(c, boxUpdate, margin) && boxInBoundary(c, boxUpdate)) {
      ++i;
      if (i >= static_cast<int>(axisCand.size())) i = 0;
      int axis = axisCand[i];
      std::memcpy(box, boxCand, sizeof boxCand);
      std::memcpy(boxUpdate, boxCand, sizeof boxCand);
      if (axis < 3) {
        boxUpdate[axis + 3] = boxCand[axis];
        boxCand[axis] -= (axis == 2) ? c.bz : c.bxy;
        boxUpdate[axis] = boxCand[axis];
      } else {
        boxUpdate[axis - 3] = boxCand[axis];
        boxCand[axis] += (axis == 5) ? c.bz : c.bxy;
        boxUpdate[axis] = boxCand[axis];
      }
    }
    axisCand.erase(axisCand.begin() + i);
    if (i > 0)
      --i;
    else
      i = static_cast<int>(axisCand.size()) - 1;
  }
}

}  // namespace

// Per-agent SFC box generation (updateObsBox loop, rbp_corridor.hpp:154-193).
// Returns number of boxes, or -1 if the initial trajectory hits an obstacle.
extern "C" int sfc_expand_agent(const float* esdf, int X, int Y, int Z,
                                double res, const int64_t* i0,
                                const double* worldMin, const double* worldMax,
                                double boxXyRes, double boxZRes,
                                const double* traj, int L, double margin,
                                double* outBoxes, int maxBoxes) {
  SfcCtx c{esdf, X, Y, Z, res, i0, worldMin, worldMax, boxXyRes, boxZRes};
  double boxPrev[6] = {0, 0, 0, 0, 0, 0};
  int nBoxes = 0;
  for (int s = 0; s + 1 < L; ++s) {
    const double* p0 = traj + 3 * s;
    const double* p1 = traj + 3 * (s + 1);
    if (pointInBox(p1, boxPrev)) continue;
    double box[6] = {
        std::round(std::min(p0[0], p1[0]) / boxXyRes) * boxXyRes,
        std::round(std::min(p0[1], p1[1]) / boxXyRes) * boxXyRes,
        std::round(std::min(p0[2], p1[2]) / boxZRes) * boxZRes,
        std::round(std::max(p0[0], p1[0]) / boxXyRes) * boxXyRes,
        std::round(std::max(p0[1], p1[1]) / boxXyRes) * boxXyRes,
        std::round(std::max(p0[2], p1[2]) / boxZRes) * boxZRes,
    };
    if (obstacleInBox(c, box, margin)) return -1;
    expandBox(c, box, margin);
    if (nBoxes >= maxBoxes) return -2;
    std::memcpy(outBoxes + 6 * nBoxes, box, sizeof box);
    std::memcpy(boxPrev, box, sizeof box);
    ++nBoxes;
  }
  return nBoxes;
}
