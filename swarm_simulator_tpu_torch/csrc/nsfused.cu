// Fused knot-state ADMM chunk for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swarm_simulator_tpu/ops/pallas_nsfused.py
// ::_kernel: n_inner ADMM iterations of one joint trajectory QP in ONE
// launch.  Each iteration (qp/nullspace admm step):
//   rhs   = sigma w - g + N^T A^T (rho z - y)
//   w_t   = K(rho)^-1 rhs        block-tridiagonal Thomas over Mi knots
//   x_t   = x_pin + N w_t,  A x_t = (x_t, pair rows)
//   relax with alpha, clip z to the box / pair bounds, update the duals.
//
// What bounds it on an H100: the Thomas sweeps are 2*Mi-1 strictly
// sequential [bs] x [bs, bs] matvecs against the active rung's pivot
// inverses.  At 64 agents (bs = 576, Mi = 35) that is ~93 MB of pivot
// reads per iteration and one rung is 46 MB, just under the 50 MB L2; the
// pair work (2016 pairs x 216 control points) is small.  So the limits are
// the pivot stream and the synchronisation between dependent chain steps,
// not FLOPs.
//
// What the design does about it: one persistent cooperative kernel per
// chunk (grid = one block per SM, checked against the occupancy query so
// every block is co-resident).  The pair, box and dual phases use all
// blocks, with cooperative_groups grid syncs between them.  The Thomas
// sweeps run on the chain blocks alone (csrc/chain_ring.cuh), each owning
// gpb whole (agent, axis) row groups: no grid sync between stages, the
// vector passes from stage to stage in tagged entries that each block
// waits for, and each block streams its pivot rows through a TMA ring
// that runs ahead of the chain, across stages and across the other
// phases into the next iteration's sweeps; the rung (46 MB at 64 agents)
// stays in the 50 MB L2 over the chunk, so these are mostly L2 reads.
// The block that owns a row group forms the next stage's vector entries
// for it (the small off-diagonal block Ho), so a chain stage costs one L2
// round trip for the vector and the dot of the block's rows from shared
// memory.  The 132 - ncb other blocks wait at the grid sync after the
// sweeps.
// Arithmetic is true float32 FMA on CUDA cores: unlike the TPU kernel's
// bf16 mantissa split (two-term split in production, ~1e-5 relative), the
// pair contractions here are exact float32.  A^T y is a deterministic
// per-agent gather over a CSR of the agent's pairs (no atomics), A x a
// gather by pair index, and the off-diagonal block Ho is read per knot, so
// non-uniform segment durations need no special layout.
#include "chain_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = chain::kThreads;
constexpr int kMaxPhi = 4;
constexpr float kBig = 1e8f;  // qp/assemble.BIG: the pair rows' upper bound

struct Params {
  const float* dinv;   // [Mi, bs, bs] pivots of the active rung
  const float* ho;     // [Mi-1, phi, phi]
  const float* lmap;   // [M, phi, phi]
  const float* rmap;   // [M, phi, phi]
  const float* xpin;   // [B3, D]
  const float* g;      // [Mi, bs]
  const float* lb;     // [B3, D]
  const float* ub;     // [B3, D]
  const float* pl;     // [P, D]
  const float* pnm;    // [P, M, 3]
  const int* pi;       // [P]
  const int* pj;       // [P]
  const float* ci;     // [P]
  const float* cj;     // [P]
  const int* aptr;     // [B+1]
  const int* apair;    // [nnz]
  const float* acoef;  // [nnz]
  const float* w_in;   // [Mi, bs]
  const float* zb_in;  // [B3, D]
  const float* zp_in;  // [P, D]
  const float* yb_in;  // [B3, D]
  const float* yp_in;  // [P, D]
  float* w;            // [Mi, bs]   state, updated in place
  float* zb;           // [B3, D]
  float* zp;           // [P, D]
  float* yb;           // [B3, D]
  float* yp;           // [P, D]
  float* rhs;          // [Mi, bs]   scratch: rhs, then the forward y rows
  float* t;            // [Mi, bs]   scratch: T_k rows, then w_t
  float* at;           // [B3, D]    scratch: A^T (rho z - y)
  float* xt;           // [B3, D]    scratch: x_t
  unsigned long long* vbuf;  // [2, bs] scratch: tagged chain vector entries
  int B, M, phi, P, n_inner;
  int gpb, tile_rows, nslots;  // the chain's ring plan (ops/thomas)
  float rho, sigma, alpha;
};

__global__ void __launch_bounds__(kThreads)
nsfused_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];

  const int phi = p.phi, M = p.M, Mi = M - 1, npp = 2 * phi;
  const int B3 = 3 * p.B, D = M * npp, bs = B3 * phi, P = p.P;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float rho = p.rho, sigma = p.sigma, alpha = p.alpha;
  const float beta = 1.f - alpha;

  // the chain: ncb blocks of gpb row groups; the other blocks skip it
  const int rows = p.gpb * phi;
  const int ncb = (B3 + p.gpb - 1) / p.gpb;
  const bool chain_block = (int)blockIdx.x < ncb;
  const int nstage = 2 * Mi - 1;
  chain::RowRing<float> ring;
  ring.dinv = p.dinv;
  ring.bs = bs;
  ring.Mi = Mi;
  ring.r0 = min((int)blockIdx.x * rows, bs);
  ring.r1 = min(ring.r0 + rows, bs);
  ring.tile_rows = p.tile_rows;
  ring.nslots = p.nslots;
  ring.ntile = (ring.r1 - ring.r0 + p.tile_rows - 1) / p.tile_rows;
  ring.nstage = nstage;
  ring.ntiles = chain_block ? (long long)p.n_inner * nstage * ring.ntile : 0;
  ring.aligned = bs % 4 == 0;
  float* vec = reinterpret_cast<float*>(ring.carve(smem));  // [bs]
  float* tv = vec + bs;  // [rows] this stage's products of the block
  const int r0 = ring.r0, nrows = ring.r1 - ring.r0;
  if (threadIdx.x == 0 && chain_block) ring.start();
  for (int e = tid; e < 2 * bs; e += nthreads) p.vbuf[e] = 0ull;

  for (int e = tid; e < Mi * bs; e += nthreads) p.w[e] = p.w_in[e];
  for (int e = tid; e < B3 * D; e += nthreads) {
    p.zb[e] = p.zb_in[e];
    p.yb[e] = p.yb_in[e];
  }
  for (int e = tid; e < P * D; e += nthreads) {
    p.zp[e] = p.zp_in[e];
    p.yp[e] = p.yp_in[e];
  }
  grid.sync();

  long long tile = 0;  // this block's next ring tile
  for (int it = 0; it < p.n_inner; ++it) {
    // ---- at = A^T (rho z - y): box identity + per-agent pair gather ----
    for (int e = tid; e < B3 * D; e += nthreads) {
      const int b3 = e / D, d = e - (e / D) * D;
      const int b = b3 / 3, ax = b3 - 3 * b, m = d / npp;
      float a = rho * p.zb[e] - p.yb[e];
      for (int q = p.aptr[b]; q < p.aptr[b + 1]; ++q) {
        const int pp = p.apair[q];
        const size_t pd = (size_t)pp * D + d;
        const float rx = rho * p.zp[pd] - p.yp[pd];
        a = fmaf(p.acoef[q] * p.pnm[((size_t)pp * M + m) * 3 + ax], rx, a);
      }
      p.at[e] = a;
    }
    grid.sync();

    // ---- rhs = sigma w - g + N^T at, one thread per (knot, agent-axis) ----
    for (int e = tid; e < Mi * B3; e += nthreads) {
      const int k = e / B3, b3 = e - (e / B3) * B3;
      float acc[kMaxPhi];
      for (int f = 0; f < phi; ++f) {
        const int r = k * bs + b3 * phi + f;
        acc[f] = sigma * p.w[r] - p.g[r];
      }
      // knot k+1 starts segment k+1 (L map) and ends segment k (R map)
      const float* Lk = p.lmap + (size_t)(k + 1) * phi * phi;
      const float* Rk = p.rmap + (size_t)k * phi * phi;
      const float* atb = p.at + (size_t)b3 * D;
      for (int i = 0; i < phi; ++i) {
        const float al = atb[(k + 1) * npp + i];
        const float ar = atb[k * npp + phi + i];
        for (int f = 0; f < phi; ++f)
          acc[f] += Lk[i * phi + f] * al + Rk[i * phi + f] * ar;
      }
      for (int f = 0; f < phi; ++f) p.rhs[k * bs + b3 * phi + f] = acc[f];
    }
    grid.sync();

    // ---- Thomas sweeps over the chain blocks: forward T_k = Dinv_k y_k,
    //      y_{k+1} = rhs_{k+1} - Ho_k^T T_k; back substitution
    //      x_k = T_k - Dinv_k (Ho_k x_{k+1}), in place in t ----
    if (chain_block) {
      for (int s = 0; s < nstage; ++s) {
        const int k = ring.knot_of(s);
        // rhs_0 (written before the last grid sync), then the vector the
        // chain's last stage formed, tagged with the stage's count
        const unsigned tag = (unsigned)(it * nstage + s);
        if (s == 0) {
          for (int j = threadIdx.x; j < bs; j += kThreads)
            vec[j] = __ldcg(p.rhs + j);
          __syncthreads();
        } else {
          chain::gather_tagged(p.vbuf + (size_t)(s & 1) * bs, vec, bs, tag);
        }
        for (int t = 0; t < ring.ntile; ++t, ++tile) {
          int row0, nr;
          const float* A = ring.acquire(tile, &row0, &nr);
          for (int r = warp; r < nr; r += chain::kWarps) {
            const float v = chain::dot_shared(A + (size_t)r * bs, vec, bs,
                                              lane, ring.aligned);
            if (lane == 0) tv[row0 + r] = v;
          }
          ring.release(tile);
        }
        float* tk = p.t + (size_t)k * bs + r0;
        if (s >= Mi) {  // x_k = T_k - Dinv_k (Ho_k x_{k+1})
          for (int e = threadIdx.x; e < nrows; e += kThreads) {
            const float x = tk[e] - tv[e];
            tv[e] = x;
            tk[e] = x;
          }
          __syncthreads();
        }
        const float* H = nullptr;
        if (s < Mi - 1) H = p.ho + (size_t)k * phi * phi;
        else if (k > 0) H = p.ho + (size_t)(k - 1) * phi * phi;
        for (int e = threadIdx.x; e < nrows; e += kThreads) {
          const int a = e % phi;
          const float* tg = tv + (e - a);  // the row group's T_k or x_k
          if (s < Mi) tk[e] = tg[a];
          float next = 0.f, c = 0.f;
          if (s < Mi - 1) {  // y_{k+1}
            for (int q = 0; q < phi; ++q) c = fmaf(H[q * phi + a], tg[q], c);
            next = __ldcg(p.rhs + (size_t)(k + 1) * bs + r0 + e) - c;
          } else if (k > 0) {  // Ho_{k-1} x_k
            for (int q = 0; q < phi; ++q) c = fmaf(H[a * phi + q], tg[q], c);
            next = c;
          }
          if (s + 1 < nstage)
            chain::put_tagged(p.vbuf + (size_t)((s + 1) & 1) * bs + r0 + e,
                              next, tag + 1);
        }
        __syncthreads();  // vec and tv are rewritten by the next stage
      }
    }
    grid.sync();

    // ---- x_t = x_pin + N w_t; box relaxation, clip, duals; w update ----
    for (int e = tid; e < B3 * D; e += nthreads) {
      const int b3 = e / D, d = e - (e / D) * D;
      const int m = d / npp, i = d - m * npp;
      float x = p.xpin[e];
      if (i < phi) {
        if (m >= 1) {  // segment start: knot m, interior index m-1
          const float* L = p.lmap + ((size_t)m * phi + i) * phi;
          const float* wt = p.t + (size_t)(m - 1) * bs + b3 * phi;
          for (int f = 0; f < phi; ++f) x += L[f] * wt[f];
        }
      } else if (m <= M - 2) {  // segment end: knot m+1, interior index m
        const float* R = p.rmap + ((size_t)m * phi + (i - phi)) * phi;
        const float* wt = p.t + (size_t)m * bs + b3 * phi;
        for (int f = 0; f < phi; ++f) x += R[f] * wt[f];
      }
      p.xt[e] = x;
      const float v = alpha * x + beta * p.zb[e] + p.yb[e] / rho;
      const float zn = fminf(fmaxf(v, p.lb[e]), p.ub[e]);
      p.zb[e] = zn;
      p.yb[e] = rho * (v - zn);
    }
    for (int e = tid; e < Mi * bs; e += nthreads)
      p.w[e] = alpha * p.t[e] + beta * p.w[e];
    grid.sync();

    // ---- pair rows: A x_t by pair index; relaxation, clip, duals ----
    for (int e = tid; e < P * D; e += nthreads) {
      const int pp = e / D, d = e - (e / D) * D, m = d / npp;
      const float* nrm = p.pnm + ((size_t)pp * M + m) * 3;
      const float* xi = p.xt + (size_t)p.pi[pp] * 3 * D + d;
      const float* xj = p.xt + (size_t)p.pj[pp] * 3 * D + d;
      const float c_i = p.ci[pp], c_j = p.cj[pp];
      float axp = 0.f;
      for (int k = 0; k < 3; ++k)
        axp += nrm[k] * (c_j * xj[k * D] - c_i * xi[k * D]);
      const float v = alpha * axp + beta * p.zp[e] + p.yp[e] / rho;
      const float zn = fminf(fmaxf(v, p.pl[e]), kBig);
      p.zp[e] = zn;
      p.yp[e] = rho * (v - zn);
    }
    grid.sync();
  }
}

}  // namespace

extern "C" {

// One chunk on `stream`.  Returns a cudaError_t (0 = launched): the
// cooperative-launch error, or cudaGetLastError() after it.
int nsfused_chunk(void* dinv, void* ho, void* lmap, void* rmap, void* xpin,
                  void* g, void* lb, void* ub, void* pl, void* pnm, void* pi,
                  void* pj, void* ci, void* cj, void* aptr, void* apair,
                  void* acoef, void* w_in, void* zb_in, void* zp_in,
                  void* yb_in, void* yp_in, void* w, void* zb, void* zp,
                  void* yb, void* yp, void* rhs, void* t, void* at, void* xt,
                  void* vbuf, int B, int M, int phi, int P,
                  int n_inner, int gpb, int tile_rows, int nslots, int smem,
                  float rho, float sigma, float alpha, void* stream) {
  if (phi < 1 || phi > kMaxPhi || M < 2 || B < 1)
    return (int)cudaErrorInvalidValue;
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
  p.apair = (const int*)apair;
  p.acoef = (const float*)acoef;
  p.w_in = (const float*)w_in;
  p.zb_in = (const float*)zb_in;
  p.zp_in = (const float*)zp_in;
  p.yb_in = (const float*)yb_in;
  p.yp_in = (const float*)yp_in;
  p.w = (float*)w;
  p.zb = (float*)zb;
  p.zp = (float*)zp;
  p.yb = (float*)yb;
  p.yp = (float*)yp;
  p.rhs = (float*)rhs;
  p.t = (float*)t;
  p.at = (float*)at;
  p.xt = (float*)xt;
  p.B = B;
  p.M = M;
  p.phi = phi;
  p.P = P;
  p.n_inner = n_inner;
  p.rho = rho;
  p.sigma = sigma;
  p.alpha = alpha;

  p.vbuf = (unsigned long long*)vbuf;
  p.gpb = gpb;
  p.tile_rows = tile_rows;
  p.nslots = nslots;
  const int bs = 3 * B * phi, rows = gpb * phi;
  if (gpb < 1 || tile_rows < 1 || tile_rows > rows || nslots < 1 ||
      nslots > chain::kMaxSlots ||
      (size_t)smem < chain::kBarBytes +
                         nslots * chain::slot_bytes(tile_rows, bs, 4) +
                         sizeof(float) * ((size_t)bs + rows))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, grid = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return (int)c;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int e = probe::coop_grid((const void*)nsfused_kernel, kThreads, smem, sms,
                           &grid);
  if (e != 0) return e;
  // one block per SM, the chain's among them, all co-resident
  if (grid < sms || (3 * B + gpb - 1) / gpb > grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  c = cudaLaunchCooperativeKernel((const void*)nsfused_kernel, dim3(grid),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

const char* nsfused_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
