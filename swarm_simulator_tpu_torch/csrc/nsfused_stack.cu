// The fused knot-state ADMM chunk over a stack of problems (sm_90a).
//
// Replaces the batch axis that the JAX package writes as jax.vmap around
// its knot-state loop and the Pallas TPU kernel
// swarm_simulator_tpu/ops/pallas_nsfused.py::_kernel inside it
// (qp/nullspace.py::solve_ns_batched, the Jacobi groups of
// parallel/mesh.py::jacobi_sweep, the scenarios of parallel/scenarios.py):
// n_inner ADMM iterations of every running entry of the stack in ONE
// launch, each entry at its own rung.  An iteration is K1's
// (csrc/nsfused.cu):
//   rhs   = sigma w - g + N^T A^T (rho z - y)
//   w_t   = K(rho)^-1 rhs        block-tridiagonal Thomas over Mi knots
//   x_t   = x_pin + N w_t,  A x_t = (x_t, pair rows)
//   relax with alpha, clip z to the box / pair bounds, update the duals.
//
// What bounds it on an H100: the entries are small (a Jacobi group of 4
// agents: bs = 36, Mi = 35, a 181,440-byte rung, P = 246 pairs of D = 216
// rows), so an iteration is a chain of 2 Mi - 1 dependent [bs] x [bs, bs]
// matvecs (latency: 50 x 69 stages a chunk, far above the operations
// bound) between two memory-bound phases, the A^T gather (each agent's
// ~63 pairs at every row) and the pair rows (P x D elements).  Run on one
// block of 1024 threads an entry (the first form), the chain paid two
// block-wide barriers a stage and the phases streamed the entry's float64
// state through one SM's L1: 39% of the iteration was the pair rows, 20%
// the gather, 37% the chain (PERF.md, a clock64 build).
//
// What the design does about it: an entry is a thread-block cluster of
// 1 + Q blocks (ops/nsfused.stack_plan), launched with cudaLaunchKernelEx.
// Rank 0 is the chain block: the active rung (float32, one TMA bulk copy on
// an mbarrier), the right-hand sides, the Thomas rows and Ho (float64) in
// its shared memory.  Its chain runs on a team of warps that each hold
// whole agent-axis triples, four lanes a row; kStagers other threads
// widen the next stage's rows to float64 into one of two slots while the
// team works on this stage's, so the team converts nothing.  A stage's
// coupling reads only its warp's rows of T, so a stage is one named
// barrier (bar.sync 2, the team and the stagers) and the vector is
// double-buffered.  Ranks 1..Q are partners, each owning a run of knots
// [k0, k1): the pair and box rows of the columns d those knots map (the
// end half of segment k and the start half of segment k + 1 are knot k's,
// a contiguous range), so every phase outside the chain reads only its own
// columns.  A partner keeps its columns of the whole state in its shared
// memory for the launch: z_box, y_box, the pair rows' relaxed values v (z
// = clip(v), y = rho (v - z) recomputed bit for bit, so rho z - y needs no
// store), their bounds and normals, and w of its knots.  An iteration is
// two cluster barriers: the partners gather A^T (rho z - y) at their
// columns (each agent's pair list split kMaxSplit ways at most, summed in
// a fixed order) and write their knots' rows of rhs into the chain block's
// shared memory (distributed shared memory), barrier; the chain, barrier;
// each partner copies its knots' w_t from the chain block, then x_t, the
// box and pair relaxations and w at its columns.  No partner reads
// another's memory, and nothing but the final state goes back to device
// memory.  What is left bounds it the same way: each chain stage takes
// ~0.6 us, several times the latencies of its loads, FMAs and barrier
// (PERF.md §7).
// Arithmetic: float32 operands are read as they are and widened; the
// entry's state is float64 for the chunk (the wrapper widens it and rounds
// it back; PERF.md: a float32 state fails phase 20's per-group twin rule),
// every sum is a float64 FMA, and y / rho is y * (1 / rho) (one reciprocal
// an entry).  Every element's arithmetic, and the order of every sum,
// depend on the shapes alone, never on the block or the stack, so an
// entry's result is bit-for-bit the same in any stack.
#include <cooperative_groups.h>

#include "probe_common.cuh"

namespace cg = cooperative_groups;

// Variants for the measuring tools (ops/_build's "nsfused_stack@<tag>";
// tools/chain_bench.py --stack): STACK_PROFILE stamps each phase of an
// iteration with clock64() in every block (nsfused_stack_stamps reads
// them); STACK_STATE_F32 keeps the chunk's state and arithmetic in float32.
#ifdef STACK_STATE_F32
typedef float real;
#else
typedef double real;
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPhi = 4;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxSplit = 8;    // ways an agent's pair list is split
constexpr int kRowSplit = 4;    // chain lanes a row (lanes 4r .. 4r+3)
constexpr int kStagers = 256;   // threads widening the next stage's rows
constexpr double kBig = 1e8;    // qp/assemble.BIG: the pair rows' upper bound
constexpr int kBarBytes = 16;   // ops/nsfused.STACK_BAR_BYTES

constexpr int kStampBlocks = 128;  // blocks whose phase cycles are kept
constexpr int kStamps = 16;        // up to 15 phases (kPhases), then the total
constexpr const char* kPhases =
    "A^T gather,rhs,wait for the chain,x_t box w,pair rows,"
    "wait for the partners,forward coupling and barrier,forward matvec,"
    "back coupling and barrier,back matvec";
__device__ long long g_stamps[kStampBlocks * kStamps];

struct Params {
  const float* dinv;   // [L, R, rung] flat rungs, each padded to `rung`
  const float* ho;     // [L, Mi-1, phi, phi]
  const float* lmap;   // [L, M, phi, phi]
  const float* rmap;   // [L, M, phi, phi]
  const float* xpin;   // [L, B3, D]
  const float* g;      // [L, Mi, bs]
  const float* lb;     // [L, B3, D]
  const float* ub;     // [L, B3, D]
  const float* pl;     // [L, P, D]
  const float* pnm;    // [L, P, M, 3]
  const int* pi;       // [L, P]
  const int* pj;       // [L, P]
  const float* ci;     // [L, P]
  const float* cj;     // [L, P]
  const int* aptr;     // [L, B+1] within the entry's own list
  const int* aoff;     // [L] the entry's first list entry
  const int* apair;    // [nnz]
  const float* acoef;  // [nnz]
  const int* entry;    // [n] the cluster's stack entry
  const int* rung;     // [n] its rung
  const float* rho;    // [n] its rho
  real* w;             // [n, Mi, bs] the cluster's state, in place
  real* zb;            // [n, B3, D]
  real* zp;            // [n, P, D]
  real* yb;            // [n, B3, D]
  real* yp;            // [n, P, D]
  int B, M, phi, P, n_inner, R, rung_floats, cluster;
  double sigma, alpha;
};

// byte offsets of a block's shared arrays (each 16-byte aligned) and the
// partners' split; the same formulas as ops/nsfused.stack_smem_bytes /
// stack_partner_bytes
struct Layout {
  // chain block
  size_t rung, rhs, t, vec, ho, stage, chain_end;
  // partner
  size_t xt, zb, yb, w, wt, v, xpin, lb, ub, pl, g, lmap, rmap, pidx, pc,
      aptr, list, lcoef, pnm, partner_end;
  int kq;     // knots a partner
  int dmax;   // columns a partner at most
  int split;  // ways an agent's pair list is split in the gather
};

__host__ __device__ inline size_t up16(size_t b) {
  return (b + 15) & ~size_t(15);
}

__host__ __device__ inline Layout layout(int B, int M, int phi, int P,
                                         int rung_floats, int cluster) {
  Layout l;
  const int Q = cluster - 1, Mi = M - 1, B3 = 3 * B, bs = B3 * phi;
  const int npp = 2 * phi, D = M * npp;
  const size_t r = sizeof(real);
  l.kq = (Mi + Q - 1) / Q;
  l.dmax = l.kq * npp + 2 * phi < D ? l.kq * npp + 2 * phi : D;
  int split = kThreads / (B * l.kq * npp);
  l.split = split < 1 ? 1 : (split > kMaxSplit ? kMaxSplit : split);
  size_t o = kBarBytes;
  l.rung = o;
  o = up16(o + 4 * (size_t)rung_floats);
  l.rhs = o;
  o = up16(o + r * Mi * bs);
  l.t = o;
  o = up16(o + r * Mi * bs);
  l.vec = o;  // the chain's vector, two buffers
  o = up16(o + 2 * r * bs);
  l.ho = o;
  o = up16(o + r * (size_t)(Mi - 1) * phi * phi);
  l.stage = o;  // two slots of one stage's rows, widened
  l.chain_end = up16(o + 2 * r * (size_t)bs * bs);
  // x_t [B3, dmax] and the gather's partial sums [B3, split, kq npp]
  // alias: the partials live from the gather to the rhs, x_t from w_t to
  // the pair rows
  const size_t xt = (size_t)B3 * l.dmax;
  const size_t part = (size_t)B3 * l.split * l.kq * npp;
  o = 0;
  l.xt = o;
  o = up16(o + r * (xt > part ? xt : part));
  l.zb = o;
  o = up16(o + r * B3 * l.dmax);
  l.yb = o;
  o = up16(o + r * B3 * l.dmax);
  l.w = o;
  o = up16(o + r * l.kq * bs);
  l.wt = o;
  o = up16(o + r * l.kq * bs);
  l.v = o;
  o = up16(o + r * (size_t)P * l.dmax);
  l.xpin = o;
  o = up16(o + 4 * (size_t)B3 * l.dmax);
  l.lb = o;
  o = up16(o + 4 * (size_t)B3 * l.dmax);
  l.ub = o;
  o = up16(o + 4 * (size_t)B3 * l.dmax);
  l.pl = o;
  o = up16(o + 4 * (size_t)P * l.dmax);
  l.g = o;
  o = up16(o + 4 * (size_t)l.kq * bs);
  l.lmap = o;
  o = up16(o + 4 * (size_t)M * phi * phi);
  l.rmap = o;
  o = up16(o + 4 * (size_t)M * phi * phi);
  l.pidx = o;  // the pairs' (i, j) agents
  o = up16(o + 8 * (size_t)P);
  l.pc = o;  // and mask weights
  o = up16(o + 8 * (size_t)P);
  l.aptr = o;  // the agents' pair lists: pointers, pairs, weights
  o = up16(o + 4 * (size_t)(B + 1));
  l.list = o;
  o = up16(o + 8 * (size_t)P);
  l.lcoef = o;
  o = up16(o + 8 * (size_t)P);
  l.pnm = o;  // the pair normals of the kq + 1 segments the columns touch
  l.partner_end = up16(o + 12 * (size_t)P * (l.kq + 1));
  return l;
}

// named barriers of the chain block: 1 for the chain's team, 2 for the
// team and the stagers (bar.sync id, threads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ real clip_pair(real v, float pl) {
  return fmin(fmax(v, (real)pl), (real)kBig);
}

// the four lanes of a row sum their partial dots: (s0 + s1) + (s2 + s3)
// in every lane
__device__ __forceinline__ real lanes_sum(real s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// the knot of stage st of the chain's 2 Mi - 1 (forward, then back)
__device__ __forceinline__ int stage_knot(int st, int Mi) {
  return st < Mi ? st : 2 * Mi - 2 - st;
}

// the coupling of chain stage st into vec[r] (a row's lead lane): forward
// y_k = rhs_k - (I (x) Ho_{k-1})^T T_{k-1}, back (I (x) Ho_k) x_{k+1}; the
// T or x rows it reads are its own agent-axis triple's, in its warp
__device__ __forceinline__ void couple(int st, int Mi, int bs, int phi,
                                       int r, int a, const real* rhs,
                                       const real* t, const real* ho,
                                       real* vec) {
  const int k = stage_knot(st, Mi);
  real c = 0;
  if (st < Mi) {
    if (k > 0) {
      const real* H = ho + (k - 1) * phi * phi + a;
      const real* tg = t + (k - 1) * bs + (r - a);
#pragma unroll
      for (int q = 0; q < kMaxPhi; ++q)
        if (q < phi) c = fma(H[q * phi], tg[q], c);
    }
    vec[r] = rhs[k * bs + r] - c;
  } else {
    const real* H = ho + k * phi * phi + a * phi;
    const real* xg = t + (k + 1) * bs + (r - a);
#pragma unroll
    for (int q = 0; q < kMaxPhi; ++q)
      if (q < phi) c = fma(H[q], xg[q], c);
    vec[r] = c;
  }
}

// the Thomas chain of one iteration on the chain block's team, 2 Mi - 1
// stages: forward T_k = Dinv_k (rhs_k - (I (x) Ho_{k-1})^T T_{k-1}) for k =
// 0 .. Mi-1, then back in place x_k = T_k - Dinv_k (I (x) Ho_k) x_{k+1}
// for k = Mi-2 .. 0.  A warp holds whole agent-axis triples (rows_w rows,
// kRowSplit lanes a row), so a stage's coupling needs only its warp's rows
// of T: one barrier a stage (with the stagers), the vector double-buffered.
// Stage g of the launch reads its rows, widened by the stagers, from slot
// g % 2; lane h of a row's four sums the elements j = h + 4i, the even i
// and the odd i each in order, then adds the two, and the four lanes sum
// (s0 + s1) + (s2 + s3) by shuffles.
__device__ __forceinline__ void chain(const real* slots, const real* rhs,
                                      real* t, real* vecs, const real* ho,
                                      int Mi, int bs, int phi, int rows_w,
                                      int team, int synced, int& g,
                                      long long* cyc, long long& t_prev) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int rw = lane / kRowSplit, h = lane % kRowSplit;
  const int r = (tid >> 5) * rows_w + rw;
  const bool live = rw < rows_w && r < bs, lead = live && h == 0;
  const int a = live ? r % phi : 0;
  const int cols = live ? (bs - h + kRowSplit - 1) / kRowSplit : 0;
  const int stages = 2 * Mi - 1;
#ifdef STACK_PROFILE
#define CSTAMP(i)                     \
  do {                                \
    const long long now_ = clock64(); \
    cyc[i] += now_ - t_prev;          \
    t_prev = now_;                    \
  } while (0)
#else
#define CSTAMP(i) \
  do {            \
  } while (0)
#endif
  if (lead) couple(0, Mi, bs, phi, r, a, rhs, t, ho, vecs + (g & 1) * bs);
  named_sync(1, team);
  CSTAMP(6);
  for (int st = 0; st < stages; ++st, ++g) {
    const int k = stage_knot(st, Mi);
    const real* vec = vecs + (g & 1) * bs + h;
    const real* row =
        slots + (size_t)(g & 1) * bs * bs + (live ? r * bs : 0) + h;
    real s = 0, u = 0;
    int i = 0;
#pragma unroll 4
    for (; i + 1 < cols; i += 2) {
      s = fma(row[kRowSplit * i], vec[kRowSplit * i], s);
      u = fma(row[kRowSplit * (i + 1)], vec[kRowSplit * (i + 1)], u);
    }
    if (i < cols) s = fma(row[kRowSplit * i], vec[kRowSplit * i], s);
    s += u;
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (lead) {
      if (st < Mi)
        t[k * bs + r] = s;
      else
        t[k * bs + r] -= s;
    }
    CSTAMP(st < Mi ? 7 : 9);
    if (st + 1 < stages) {
      __syncwarp();
      if (lead)
        couple(st + 1, Mi, bs, phi, r, a, rhs, t, ho,
               vecs + ((g + 1) & 1) * bs);
    }
    named_sync(2, synced);
    CSTAMP(st < Mi ? 6 : 8);
  }
#undef CSTAMP
}

// the stagers' part of one iteration: during stage g they widen the next
// stage's rows of the rung into slot (g + 1) % 2
__device__ __forceinline__ void stage_rows(const float* rung, real* slots,
                                           int Mi, int bs, int synced,
                                           int& g) {
  const int stages = 2 * Mi - 1, n = bs * bs;
  const int me = threadIdx.x - (int)(blockDim.x - kStagers);
  for (int st = 0; st < stages; ++st, ++g) {
    const int k = stage_knot(st + 1 < stages ? st + 1 : 0, Mi);
    const float* src = rung + (size_t)k * n;
    real* dst = slots + (size_t)((g + 1) & 1) * n;
    for (int e = me; e < n; e += kStagers) dst[e] = (real)src[e];
    named_sync(2, synced);
  }
}

__global__ void __launch_bounds__(kThreads)
nsfused_stack_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int phi = p.phi, M = p.M, Mi = M - 1, npp = 2 * phi;
  const int B3 = 3 * p.B, D = M * npp, bs = B3 * phi, P = p.P;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int blk = blockIdx.x / p.cluster, en = p.entry[blk];
  const real rho = p.rho[blk], sigma = p.sigma, alpha = p.alpha;
  const real beta = 1 - (real)p.alpha, irho = 1 / rho;
  const Layout l = layout(p.B, M, phi, P, p.rung_floats, p.cluster);
  const int last = p.n_inner - 1;

  long long cyc[kStamps] = {}, t_prev = 0;
#ifdef STACK_PROFILE
  t_prev = clock64();
  const long long t_start = t_prev;
#define STAMP(i)                      \
  do {                                \
    const long long now_ = clock64(); \
    cyc[i] += now_ - t_prev;          \
    t_prev = now_;                    \
  } while (0)
#else
#define STAMP(i) \
  do {           \
  } while (0)
#endif

  // the chain block's right-hand sides and Thomas rows, in every block's
  // own address (the partners map them to rank 0)
  real* rhs = reinterpret_cast<real*>(smem + l.rhs);  // [Mi, bs]
  real* t = reinterpret_cast<real*>(smem + l.t);      // [Mi, bs] T_k, w_t

  if (rank == 0) {
    // ================= the chain block =================
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    const float* rung = reinterpret_cast<const float*>(smem + l.rung);
    real* vec = reinterpret_cast<real*>(smem + l.vec);  // [2, bs]
    real* ho = reinterpret_cast<real*>(smem + l.ho);    // [Mi-1, phi, phi]
    real* slots = reinterpret_cast<real*>(smem + l.stage);  // [2, bs, bs]
    // the team: warps of rows_w rows (whole agent-axis triples) at
    // kRowSplit lanes a row, from thread 0; the stagers: the block's last
    // kStagers threads
    const int rows_w = (32 / kRowSplit) / phi * phi;
    const int team = 32 * ((bs + rows_w - 1) / rows_w);
    const int synced = team + kStagers;
    const bool stager = tid >= kThreads - kStagers;
    if (tid == 0) {  // the rung, one bulk copy; the stagers wait for it
      probe::mbar_init(bar, 1);
      probe::mbar_fence_init();
      const float* src =
          p.dinv + ((size_t)en * p.R + p.rung[blk]) * p.rung_floats;
      const uint32_t bytes = (uint32_t)p.rung_floats * 4u;
      probe::fence_proxy_async();
      probe::mbar_expect_tx(bar, bytes);
      probe::bulk_copy(smem + l.rung, src, bytes, bar);
    }
    const float* hog = p.ho + (size_t)en * (Mi - 1) * phi * phi;
    for (int e = tid; e < (Mi - 1) * phi * phi; e += kThreads)
      ho[e] = (real)hog[e];
    __syncthreads();  // publishes the barrier's initialisation and Ho
    cluster.sync();   // every block of the cluster has started
    if (stager) {     // the first stage's rows into slot 0
      probe::mbar_wait(bar, 0);
      for (int e = tid - (kThreads - kStagers); e < bs * bs; e += kStagers)
        slots[e] = (real)rung[e];
    }
    if (tid < team || stager) named_sync(2, synced);
    int g = 0;  // the launch's chain stage
    for (int it = 0; it < p.n_inner; ++it) {
      cluster.sync();  // the partners' rows of rhs are in place
      STAMP(5);
      if (tid < team)
        chain(slots, rhs, t, vec, ho, Mi, bs, phi, rows_w, team, synced, g,
              cyc, t_prev);
      else if (stager)
        stage_rows(rung, slots, Mi, bs, synced, g);
      cluster.sync();  // w_t is in t
    }
    // the partners read the last w_t from this block's shared memory:
    // it stays until they have
    cluster.sync();
  } else {
    // ================= a partner: knots [k0, k1), columns [d0, d1) ======
    const int q = rank - 1, S = l.split, kq = l.kq;
    const int k0 = q * kq < Mi ? q * kq : Mi;
    const int k1 = k0 + kq < Mi ? k0 + kq : Mi;
    const int nk = k1 - k0;
    // knot k's columns are [k npp + phi, (k+1) npp + phi); the first and
    // the last partner also own the path's ends, which no knot maps
    const int d0 = k0 == 0 ? 0 : k0 * npp + phi;
    const int d1 = k1 == Mi ? D : k1 * npp + phi;
    const int nd = d1 - d0, kd0 = k0 * npp + phi, nkd = nk * npp;
    const int dm = l.dmax;  // row stride of the [*, dmax] arrays
    real* xt = reinterpret_cast<real*>(smem + l.xt);    // [B3, dmax]
    real* part = xt;                                    // [B3, S, nkd]
    real* zb = reinterpret_cast<real*>(smem + l.zb);    // [B3, dmax]
    real* yb = reinterpret_cast<real*>(smem + l.yb);    // [B3, dmax]
    real* w = reinterpret_cast<real*>(smem + l.w);      // [kq, bs]
    real* wt = reinterpret_cast<real*>(smem + l.wt);    // [kq, bs]
    real* v = reinterpret_cast<real*>(smem + l.v);      // [P, dmax]
    float* xpin = reinterpret_cast<float*>(smem + l.xpin);  // [B3, dmax]
    float* lb = reinterpret_cast<float*>(smem + l.lb);      // [B3, dmax]
    float* ub = reinterpret_cast<float*>(smem + l.ub);      // [B3, dmax]
    float* pl = reinterpret_cast<float*>(smem + l.pl);      // [P, dmax]
    float* gk = reinterpret_cast<float*>(smem + l.g);       // [kq, bs]
    float* lmap = reinterpret_cast<float*>(smem + l.lmap);  // [M, phi, phi]
    float* rmap = reinterpret_cast<float*>(smem + l.rmap);  // [M, phi, phi]
    int* pidx = reinterpret_cast<int*>(smem + l.pidx);      // [P, 2] i, j
    float* pc = reinterpret_cast<float*>(smem + l.pc);      // [P, 2] ci, cj
    int* aptr = reinterpret_cast<int*>(smem + l.aptr);      // [B+1]
    int* list = reinterpret_cast<int*>(smem + l.list);      // [2P]
    float* lcoef = reinterpret_cast<float*>(smem + l.lcoef);
    // [P, kq + 1, 3]: segments m0 .. of the columns
    float* pnm = reinterpret_cast<float*>(smem + l.pnm);
    const int m0 = d0 / npp, ns = l.kq + 1;
    // a thread's elements of a [*, columns] sweep: columns c0, c0 +
    // cstep, ..., rows r0, r0 + rstep, ... (no thread when r0 >= rstep)
    const int cstep = nd < kThreads ? nd : kThreads;
    const int rstep = kThreads / cstep, c0 = tid % cstep, r0 = tid / cstep;
    const int rows_on = r0 < rstep ? 1 : 0;
    const size_t eBD = (size_t)en * B3 * D, jBD = (size_t)blk * B3 * D;
    const size_t ePD = (size_t)en * P * D, jPD = (size_t)blk * P * D;
    real* zpg = p.zp + jPD;
    real* ypg = p.yp + jPD;
    real* wg = p.w + (size_t)blk * Mi * bs;

    // ---- the operands and the state of the columns and knots ----
    for (int e = tid; e < B3 * nd; e += kThreads) {
      const int b3 = e / nd, c = e - b3 * nd;
      const size_t ge = (size_t)b3 * D + d0 + c;
      xpin[b3 * dm + c] = p.xpin[eBD + ge];
      lb[b3 * dm + c] = p.lb[eBD + ge];
      ub[b3 * dm + c] = p.ub[eBD + ge];
      zb[b3 * dm + c] = p.zb[jBD + ge];
      yb[b3 * dm + c] = p.yb[jBD + ge];
    }
    for (int e = tid; e < P * nd; e += kThreads) {
      const int pp = e / nd, c = e - pp * nd;
      pl[pp * dm + c] = p.pl[ePD + (size_t)pp * D + d0 + c];
    }
    for (int e = tid; e < nk * bs; e += kThreads) {
      w[e] = wg[k0 * bs + e];
      gk[e] = p.g[(size_t)en * Mi * bs + k0 * bs + e];
    }
    for (int e = tid; e < M * phi * phi; e += kThreads) {
      lmap[e] = p.lmap[(size_t)en * M * phi * phi + e];
      rmap[e] = p.rmap[(size_t)en * M * phi * phi + e];
    }
    for (int e = tid; e < P; e += kThreads) {
      pidx[2 * e] = p.pi[(size_t)en * P + e];
      pidx[2 * e + 1] = p.pj[(size_t)en * P + e];
      pc[2 * e] = p.ci[(size_t)en * P + e];
      pc[2 * e + 1] = p.cj[(size_t)en * P + e];
    }
    for (int e = tid; e <= p.B; e += kThreads)
      aptr[e] = p.aptr[(size_t)en * (p.B + 1) + e];
    const int nseg = (d1 - 1) / npp - m0 + 1;
    for (int e = tid; e < P * nseg * 3; e += kThreads) {
      const int pp = e / (nseg * 3), r3 = e - pp * nseg * 3;
      pnm[pp * ns * 3 + r3] =
          p.pnm[((size_t)en * P + pp) * M * 3 + m0 * 3 + r3];
    }
    __syncthreads();
    for (int e = tid; e < aptr[p.B]; e += kThreads) {
      list[e] = p.apair[p.aoff[en] + e];
      lcoef[e] = p.acoef[p.aoff[en] + e];
    }
    __syncthreads();
    cluster.sync();  // every block of the cluster has started
    real* rhs0 = cluster.map_shared_rank(rhs, 0);
    const real* t0 = cluster.map_shared_rank(t, 0);

    for (int it = 0; it < p.n_inner; ++it) {
      // ---- partial sums of A^T (rho z - y) at the knots' columns over S
      //      slices of each agent's pair list, a thread a (b, slice, d) ----
      for (int task = tid; task < p.B * S * nkd; task += kThreads) {
        const int b = task / (S * nkd), rem = task - b * S * nkd;
        const int s = rem / nkd, c = rem - s * nkd;
        const int d = kd0 + c, m = d / npp, lc = d - d0;
        real a0 = 0, a1 = 0, a2 = 0;
        if (s == 0) {
          const int e = (3 * b) * dm + lc;
          a0 = rho * zb[e] - yb[e];
          a1 = rho * zb[e + dm] - yb[e + dm];
          a2 = rho * zb[e + 2 * dm] - yb[e + 2 * dm];
        }
        const int lo = aptr[b], n = aptr[b + 1] - lo;
        const int qa = lo + (n * s) / S, qb = lo + (n * (s + 1)) / S;
#pragma unroll 4
        for (int k = qa; k < qb; ++k) {
          const int pp = list[k];
          real x;
          if (it == 0) {  // rho z - y of the chunk's first state
            const size_t ge = (size_t)pp * D + d;
            x = rho * zpg[ge] - ypg[ge];
          } else {
            const real vo = v[pp * dm + lc];
            const real zo = clip_pair(vo, pl[pp * dm + lc]);
            x = rho * zo - rho * (vo - zo);
          }
          const float cf = lcoef[k];
          const float* nm = pnm + (pp * ns + m - m0) * 3;
          a0 = fma((real)cf * nm[0], x, a0);
          a1 = fma((real)cf * nm[1], x, a1);
          a2 = fma((real)cf * nm[2], x, a2);
        }
        const int o = ((3 * b) * S + s) * nkd + c;
        part[o] = a0;
        part[o + S * nkd] = a1;
        part[o + 2 * S * nkd] = a2;
      }
      __syncthreads();
      STAMP(0);
      // ---- rhs = sigma w - g + N^T at of the knots, a thread per (knot,
      //      row), into the chain block's shared memory ----
      for (int e = tid; e < nk * B3; e += kThreads) {
        const int kk = e / B3, b3 = e - kk * B3, k = k0 + kk;
        real acc[kMaxPhi];  // registers: every index is unrolled
#pragma unroll
        for (int f = 0; f < kMaxPhi; ++f)
          if (f < phi)
            acc[f] = sigma * w[kk * bs + b3 * phi + f] -
                     gk[kk * bs + b3 * phi + f];
        // knot k+1 starts segment k+1 (L map) and ends segment k (R map)
        const float* Lk = lmap + (k + 1) * phi * phi;
        const float* Rk = rmap + k * phi * phi;
        const real* pr = part + (b3 * S) * nkd + kk * npp;
        for (int i = 0; i < phi; ++i) {
          real al = 0, ar = 0;
          for (int s = 0; s < S; ++s) {
            al += pr[s * nkd + phi + i];  // column (k+1) npp + i
            ar += pr[s * nkd + i];        // column k npp + phi + i
          }
#pragma unroll
          for (int f = 0; f < kMaxPhi; ++f)
            if (f < phi) acc[f] += Lk[i * phi + f] * al + Rk[i * phi + f] * ar;
        }
#pragma unroll
        for (int f = 0; f < kMaxPhi; ++f)
          if (f < phi) rhs0[k * bs + b3 * phi + f] = acc[f];
      }
      STAMP(1);
      cluster.sync();  // rhs in place
      cluster.sync();  // w_t in the chain block's t
      STAMP(2);
      for (int e = tid; e < nk * bs; e += kThreads) wt[e] = t0[k0 * bs + e];
      __syncthreads();
      // ---- x_t = x_pin + N w_t at the columns; box relaxation, clip,
      //      duals; then the w update of the knots ----
      for (int c = c0; rows_on && c < nd; c += cstep)
      for (int b3 = r0; b3 < B3; b3 += rstep) {
        const int d = d0 + c;
        const int m = d / npp, i = d - m * npp, le = b3 * dm + c;
        real x = xpin[le];
        // segment start: knot m (interior m-1), L map; segment end: knot
        // m+1 (interior m), R map; none at the path's ends
        if (i < phi ? m >= 1 : m <= M - 2) {
          const float* mp = i < phi ? lmap + (m * phi + i) * phi
                                    : rmap + (m * phi + (i - phi)) * phi;
          const real* wk = wt + ((i < phi ? m - 1 : m) - k0) * bs + b3 * phi;
          for (int f = 0; f < phi; ++f) x += mp[f] * wk[f];
        }
        xt[le] = x;
        const real vb = alpha * x + beta * zb[le] + yb[le] * irho;
        const real zn = fmin(fmax(vb, (real)lb[le]), (real)ub[le]);
        zb[le] = zn;
        yb[le] = rho * (vb - zn);
      }
      for (int e = tid; e < nk * bs; e += kThreads)
        w[e] = alpha * wt[e] + beta * w[e];
      __syncthreads();
      STAMP(3);
      // ---- pair rows at the columns: A x_t by pair index; relaxation,
      //      clip, duals; v kept (the chunk's last: z and y stored) ----
      for (int c = c0; rows_on && c < nd; c += cstep)
      for (int pp = r0; pp < P; pp += rstep) {
        const int d = d0 + c;
        const float* nrm = pnm + (pp * ns + d / npp - m0) * 3;
        const real* xi = xt + pidx[2 * pp] * 3 * dm + c;
        const real* xj = xt + pidx[2 * pp + 1] * 3 * dm + c;
        const real c_i = pc[2 * pp], c_j = pc[2 * pp + 1];
        real axp = 0;
        for (int k = 0; k < 3; ++k)
          axp += nrm[k] * (c_j * xj[k * dm] - c_i * xi[k * dm]);
        const int le = pp * dm + c;
        const float lo = pl[le];
        real zo, yo;
        if (it == 0) {
          const size_t ge = (size_t)pp * D + d;
          zo = zpg[ge];
          yo = ypg[ge];
        } else {
          const real vo = v[le];
          zo = clip_pair(vo, lo);
          yo = rho * (vo - zo);
        }
        const real vn = alpha * axp + beta * zo + yo * irho;
        v[le] = vn;
        if (it == last) {
          const real zn = clip_pair(vn, lo);
          const size_t ge = (size_t)pp * D + d;
          zpg[ge] = zn;
          ypg[ge] = rho * (vn - zn);
        }
      }
      __syncthreads();
      STAMP(4);
    }
    cluster.sync();  // the last w_t read: the chain block may exit
    // ---- the columns' box state and the knots' w back to device memory
    for (int e = tid; e < B3 * nd; e += kThreads) {
      const int b3 = e / nd, c = e - b3 * nd;
      const size_t ge = (size_t)b3 * D + d0 + c;
      p.zb[jBD + ge] = zb[b3 * dm + c];
      p.yb[jBD + ge] = yb[b3 * dm + c];
    }
    for (int e = tid; e < nk * bs; e += kThreads) wg[k0 * bs + e] = w[e];
  }
#ifdef STACK_PROFILE
  if (tid == 0 && blockIdx.x < kStampBlocks) {
    cyc[kStamps - 1] = clock64() - t_start;
    for (int i = 0; i < kStamps; ++i)
      g_stamps[blockIdx.x * kStamps + i] = cyc[i];
  }
#else
  (void)cyc;
  (void)t_prev;
#endif
}

}  // namespace

extern "C" {

// Shared memory of one block of a cluster of `cluster` blocks (the larger
// of the chain block's and a partner's), in bytes; 0 for a refused shape.
long long nsfused_stack_smem(int B, int M, int phi, int P, int rung_floats,
                             int cluster) {
  if (phi < 1 || phi > kMaxPhi || M < 2 || B < 1 || P < 0 || cluster < 2 ||
      cluster > kMaxCluster)
    return 0;
  const Layout l = layout(B, M, phi, P, rung_floats, cluster);
  return (long long)(l.chain_end > l.partner_end ? l.chain_end
                                                 : l.partner_end);
}

// One chunk of the n clusters' entries on `stream`, their states updated
// in place.  Returns a cudaError_t (0 = launched): a refused argument, the
// shared-memory opt-in's or the cluster launch's error, or
// cudaGetLastError() after the launch.
int nsfused_stack(void* dinv, void* ho, void* lmap, void* rmap, void* xpin,
                  void* g, void* lb, void* ub, void* pl, void* pnm, void* pi,
                  void* pj, void* ci, void* cj, void* aptr, void* aoff,
                  void* apair, void* acoef, void* entry, void* rung,
                  void* rho, void* w, void* zb, void* zp, void* yb, void* yp,
                  int B, int M, int phi, int P, int n_inner, int n, int R,
                  int rung_floats, int cluster, double sigma, double alpha,
                  void* stream) {
  const long long bs = 3LL * B * phi;
  const int Mi = M - 1;
  if (phi < 1 || phi > kMaxPhi || n < 1 || R < 1 || n_inner < 0 ||
      rung_floats % 4 != 0 ||
      rung_floats < Mi * bs * bs || (uintptr_t)dinv % 16 != 0 ||
      32 * ((bs + (32 / kRowSplit) / phi * phi - 1) /
            ((32 / kRowSplit) / phi * phi)) > kThreads - kStagers ||
      cluster < 2 ||
      (cluster - 2) * ((Mi + cluster - 2) / (cluster - 1)) >= Mi)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      nsfused_stack_smem(B, M, phi, P, rung_floats, cluster);
  int dev = 0, optin = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return (int)c;
  c = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (c != cudaSuccess) return (int)c;
  if (smem < 1 || smem > optin) return (int)cudaErrorInvalidValue;
  c = cudaFuncSetAttribute(nsfused_stack_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (c != cudaSuccess) return (int)c;
  Params p;
  p.dinv = (const float*)dinv;
  p.ho = (const float*)ho;
  p.lmap = (const float*)lmap;
  p.rmap = (const float*)rmap;
  p.xpin = (const float*)xpin;
  p.g = (const float*)g;
  p.lb = (const float*)lb;
  p.ub = (const float*)ub;
  p.pl = (const float*)pl;
  p.pnm = (const float*)pnm;
  p.pi = (const int*)pi;
  p.pj = (const int*)pj;
  p.ci = (const float*)ci;
  p.cj = (const float*)cj;
  p.aptr = (const int*)aptr;
  p.aoff = (const int*)aoff;
  p.apair = (const int*)apair;
  p.acoef = (const float*)acoef;
  p.entry = (const int*)entry;
  p.rung = (const int*)rung;
  p.rho = (const float*)rho;
  p.w = (real*)w;
  p.zb = (real*)zb;
  p.zp = (real*)zp;
  p.yb = (real*)yb;
  p.yp = (real*)yp;
  p.B = B;
  p.M = M;
  p.phi = phi;
  p.P = P;
  p.n_inner = n_inner;
  p.R = R;
  p.rung_floats = rung_floats;
  p.cluster = cluster;
  p.sigma = sigma;
  p.alpha = alpha;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  c = cudaOccupancyMaxActiveClusters(&fit, nsfused_stack_kernel, &cfg);
  if (c != cudaSuccess) return (int)c;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  c = cudaLaunchKernelEx(&cfg, nsfused_stack_kernel, p);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

// The phase cycles of the last launch's first kStampBlocks blocks
// (STACK_PROFILE builds; zeros otherwise) into `out` [kStampBlocks,
// kStamps]; returns a cudaError_t.
int nsfused_stack_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}

// the names of the stamped phases, comma-separated
const char* nsfused_stack_phases() { return kPhases; }

const char* nsfused_stack_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
