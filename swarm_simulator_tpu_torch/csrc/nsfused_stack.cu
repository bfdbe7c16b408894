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
// agents: bs = 36, Mi = 35, a 181,440-byte rung), so an entry's chain of
// 2*Mi - 1 dependent [bs] x [bs, bs] matvecs an iteration is latency, not
// bandwidth: K1 ran it on a cooperative grid of 132 blocks with a tenth of
// the work, paying its cross-block stage exchange and grid syncs for
// nothing.  The pair phases gather an entry's P x D pair rows from L2.
//
// What the design does about it: one block runs one running entry
// (blockIdx.x -> entry through an int32 list), an ordinary launch, so any
// stack length works (blocks beyond the SMs queue).  The block copies its
// entry's active rung [Mi, bs, bs] into shared memory once per launch, one
// bulk copy (TMA) on an mbarrier that lands while the block runs the first
// A^T and rhs phases; the right-hand sides and the Thomas rows stay in
// shared memory too.  The chain runs inside the block: a stage is the dot
// of the rung's rows from shared memory against a vector in shared memory,
// a warp a row, with __syncthreads() between stages and between K1's
// phases where K1 has grid.sync(); no exchange between blocks.
// Arithmetic: the float32 operands (pivots, maps, bounds, normals) are
// read as they are and widened; the entry's state (w, z, y) is widened to
// float64 by the wrapper for the launch and rounded back to float32 after
// it, and every sum, product and update of the chunk is a float64 FMA.  A
// Jacobi group's state is small, and in float32 the rounding of the state
// from one iteration to the next alone moves a group's duals by as much as
// the plain float32 twin's own error against a float64 twin, in either
// direction (PERF.md, Findings): a float32 kernel, K1 included, passes the
// twin rule group by group only by the draw.  A^T y is the per-agent CSR
// gather (each entry's own list, at its offset) and A x a gather by pair
// index.  A block reads only its own entry and its thread -> element maps
// depend on the shapes alone, so an entry's result is bit-for-bit the same
// in any stack.
#include "probe_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPhi = 4;
constexpr double kBig = 1e8;  // qp/assemble.BIG: the pair rows' upper bound
constexpr int kBarBytes = 16;  // ops/nsfused.STACK_BAR_BYTES

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
  const int* entry;    // [n] the block's stack entry
  const int* rung;     // [n] its rung
  const float* rho;    // [n] its rho
  double* w;           // [n, Mi, bs] the block's state, in place
  double* zb;          // [n, B3, D]
  double* zp;          // [n, P, D]
  double* yb;          // [n, B3, D]
  double* yp;          // [n, P, D]
  double* at;          // [n, B3, D] scratch: A^T (rho z - y)
  double* xt;          // [n, B3, D] scratch: x_t
  int B, M, phi, P, n_inner, R, rung_floats;
  double sigma, alpha;
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dot(row, v) of n elements in shared memory, a float32 row against a
// float64 vector, lanes over the elements; every lane returns the full sum
// (the order depends on n alone)
__device__ __forceinline__ double dot_row(const float* row, const double* v,
                                          int n, int lane) {
  double s = 0.0;
  for (int j = lane; j < n; j += 32) s = fma((double)row[j], v[j], s);
  return warp_sum(s);
}

__global__ void __launch_bounds__(kThreads)
nsfused_stack_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int phi = p.phi, M = p.M, Mi = M - 1, npp = 2 * phi;
  const int B3 = 3 * p.B, D = M * npp, bs = B3 * phi, P = p.P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, en = p.entry[blk];
  const double rho = p.rho[blk], sigma = p.sigma, alpha = p.alpha;
  const double beta = 1.0 - alpha;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* rung = reinterpret_cast<float*>(smem + kBarBytes);  // [Mi, bs, bs]
  double* rhs = reinterpret_cast<double*>(rung + p.rung_floats);  // [Mi, bs]
  double* t = rhs + (size_t)Mi * bs;  // [Mi, bs] T_k rows, then w_t
  double* vec = t + (size_t)Mi * bs;  // [bs] the chain's vector

  if (tid == 0) {  // the rung, one bulk copy; waited for before the chain
    probe::mbar_init(bar, 1);
    probe::mbar_fence_init();
    const float* src =
        p.dinv + ((size_t)en * p.R + p.rung[blk]) * p.rung_floats;
    const uint32_t bytes = (uint32_t)p.rung_floats * 4u;
    probe::fence_proxy_async();
    probe::mbar_expect_tx(bar, bytes);
    probe::bulk_copy(rung, src, bytes, bar);
  }

  // the entry's operands
  const size_t eBD = (size_t)en * B3 * D, ePD = (size_t)en * P * D;
  const float* ho = p.ho + (size_t)en * (Mi - 1) * phi * phi;
  const float* lmap = p.lmap + (size_t)en * M * phi * phi;
  const float* rmap = p.rmap + (size_t)en * M * phi * phi;
  const float* xpin = p.xpin + eBD;
  const float* g = p.g + (size_t)en * Mi * bs;
  const float* lb = p.lb + eBD;
  const float* ub = p.ub + eBD;
  const float* pl = p.pl + ePD;
  const float* pnm = p.pnm + (size_t)en * P * M * 3;
  const int* pi = p.pi + (size_t)en * P;
  const int* pj = p.pj + (size_t)en * P;
  const float* ci = p.ci + (size_t)en * P;
  const float* cj = p.cj + (size_t)en * P;
  const int* aptr = p.aptr + (size_t)en * (p.B + 1);
  const int* apair = p.apair + p.aoff[en];
  const float* acoef = p.acoef + p.aoff[en];
  // the block's state and scratch
  const size_t jBD = (size_t)blk * B3 * D, jPD = (size_t)blk * P * D;
  double* w = p.w + (size_t)blk * Mi * bs;
  double* zb = p.zb + jBD;
  double* yb = p.yb + jBD;
  double* zp = p.zp + jPD;
  double* yp = p.yp + jPD;
  double* at = p.at + jBD;
  double* xt = p.xt + jBD;
  __syncthreads();  // publishes the barrier's initialisation

  for (int it = 0; it < p.n_inner; ++it) {
    // ---- at = A^T (rho z - y): box identity + per-agent pair gather ----
    for (int e = tid; e < B3 * D; e += kThreads) {
      const int b3 = e / D, d = e - (e / D) * D;
      const int b = b3 / 3, ax = b3 - 3 * b, m = d / npp;
      double a = rho * zb[e] - yb[e];
      for (int q = aptr[b]; q < aptr[b + 1]; ++q) {
        const int pp = apair[q];
        const size_t pd = (size_t)pp * D + d;
        const double rx = rho * zp[pd] - yp[pd];
        a = fma((double)acoef[q] * pnm[((size_t)pp * M + m) * 3 + ax], rx,
                a);
      }
      at[e] = a;
    }
    __syncthreads();

    // ---- rhs = sigma w - g + N^T at, one thread per (knot, agent-axis) ----
    for (int e = tid; e < Mi * B3; e += kThreads) {
      const int k = e / B3, b3 = e - (e / B3) * B3;
      double acc[kMaxPhi];
      for (int f = 0; f < phi; ++f) {
        const int r = k * bs + b3 * phi + f;
        acc[f] = sigma * w[r] - g[r];
      }
      // knot k+1 starts segment k+1 (L map) and ends segment k (R map)
      const float* Lk = lmap + (size_t)(k + 1) * phi * phi;
      const float* Rk = rmap + (size_t)k * phi * phi;
      const double* atb = at + (size_t)b3 * D;
      for (int i = 0; i < phi; ++i) {
        const double al = atb[(k + 1) * npp + i];
        const double ar = atb[k * npp + phi + i];
        for (int f = 0; f < phi; ++f)
          acc[f] += Lk[i * phi + f] * al + Rk[i * phi + f] * ar;
      }
      for (int f = 0; f < phi; ++f) rhs[k * bs + b3 * phi + f] = acc[f];
    }
    if (it == 0) probe::mbar_wait(bar, 0);
    __syncthreads();

    // ---- Thomas forward: y_0 = rhs_0, T_k = Dinv_k y_k,
    //      y_{k+1} = rhs_{k+1} - (I (x) Ho_k)^T T_k ----
    for (int k = 0; k < Mi; ++k) {
      for (int e = tid; e < bs; e += kThreads) {
        double v = rhs[k * bs + e];
        if (k > 0) {
          const int a = e % phi;
          const float* H = ho + (size_t)(k - 1) * phi * phi;
          const double* tg = t + (size_t)(k - 1) * bs + (e - a);
          double c = 0.0;
          for (int q = 0; q < phi; ++q)
            c = fma((double)H[q * phi + a], tg[q], c);
          v -= c;
        }
        vec[e] = v;
      }
      __syncthreads();
      const float* Dk = rung + (size_t)k * bs * bs;
      for (int r = warp; r < bs; r += kWarps) {
        const double s = dot_row(Dk + (size_t)r * bs, vec, bs, lane);
        if (lane == 0) t[k * bs + r] = s;
      }
      __syncthreads();
    }
    // ---- back substitution in place in t: x_{Mi-1} = T_{Mi-1},
    //      x_k = T_k - Dinv_k ((I (x) Ho_k) x_{k+1}) ----
    for (int k = Mi - 2; k >= 0; --k) {
      for (int e = tid; e < bs; e += kThreads) {
        const int a = e % phi;
        const float* H = ho + (size_t)k * phi * phi;
        const double* xg = t + (size_t)(k + 1) * bs + (e - a);
        double c = 0.0;
        for (int q = 0; q < phi; ++q)
          c = fma((double)H[a * phi + q], xg[q], c);
        vec[e] = c;
      }
      __syncthreads();
      const float* Dk = rung + (size_t)k * bs * bs;
      for (int r = warp; r < bs; r += kWarps) {
        const double s = dot_row(Dk + (size_t)r * bs, vec, bs, lane);
        if (lane == 0) t[k * bs + r] -= s;
      }
      __syncthreads();
    }

    // ---- x_t = x_pin + N w_t; box relaxation, clip, duals; w update ----
    for (int e = tid; e < B3 * D; e += kThreads) {
      const int b3 = e / D, d = e - (e / D) * D;
      const int m = d / npp, i = d - m * npp;
      double x = xpin[e];
      if (i < phi) {
        if (m >= 1) {  // segment start: knot m, interior index m-1
          const float* L = lmap + ((size_t)m * phi + i) * phi;
          const double* wt = t + (size_t)(m - 1) * bs + b3 * phi;
          for (int f = 0; f < phi; ++f) x += L[f] * wt[f];
        }
      } else if (m <= M - 2) {  // segment end: knot m+1, interior index m
        const float* Rm = rmap + ((size_t)m * phi + (i - phi)) * phi;
        const double* wt = t + (size_t)m * bs + b3 * phi;
        for (int f = 0; f < phi; ++f) x += Rm[f] * wt[f];
      }
      xt[e] = x;
      const double v = alpha * x + beta * zb[e] + yb[e] / rho;
      const double zn = fmin(fmax(v, (double)lb[e]), (double)ub[e]);
      zb[e] = zn;
      yb[e] = rho * (v - zn);
    }
    for (int e = tid; e < Mi * bs; e += kThreads)
      w[e] = alpha * t[e] + beta * w[e];
    __syncthreads();

    // ---- pair rows: A x_t by pair index; relaxation, clip, duals ----
    for (int e = tid; e < P * D; e += kThreads) {
      const int pp = e / D, d = e - (e / D) * D, m = d / npp;
      const float* nrm = pnm + ((size_t)pp * M + m) * 3;
      const double* xi = xt + (size_t)pi[pp] * 3 * D + d;
      const double* xj = xt + (size_t)pj[pp] * 3 * D + d;
      const double c_i = ci[pp], c_j = cj[pp];
      double axp = 0.0;
      for (int k = 0; k < 3; ++k)
        axp += nrm[k] * (c_j * xj[k * D] - c_i * xi[k * D]);
      const double v = alpha * axp + beta * zp[e] + yp[e] / rho;
      const double zn = fmin(fmax(v, (double)pl[e]), kBig);
      zp[e] = zn;
      yp[e] = rho * (v - zn);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// One chunk of the n blocks' entries on `stream`, their states updated in
// place.  Returns a cudaError_t (0 = launched): a refused argument, the
// shared-memory opt-in's error, or cudaGetLastError() after the launch.
int nsfused_stack(void* dinv, void* ho, void* lmap, void* rmap, void* xpin,
                  void* g, void* lb, void* ub, void* pl, void* pnm, void* pi,
                  void* pj, void* ci, void* cj, void* aptr, void* aoff,
                  void* apair, void* acoef, void* entry, void* rung,
                  void* rho, void* w, void* zb, void* zp, void* yb, void* yp,
                  void* at, void* xt, int B, int M, int phi, int P,
                  int n_inner, int n, int R, int rung_floats, double sigma,
                  double alpha, void* stream) {
  const long long bs = 3LL * B * phi;
  if (phi < 1 || phi > kMaxPhi || M < 2 || B < 1 || n < 1 || R < 1 ||
      rung_floats % 4 != 0 || rung_floats < (M - 1) * bs * bs ||
      (uintptr_t)dinv % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kBarBytes + sizeof(float) * (size_t)rung_floats +
                      sizeof(double) * (size_t)(2 * (M - 1) * bs + bs);
  int dev = 0, optin = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return (int)c;
  c = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (c != cudaSuccess) return (int)c;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
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
  p.w = (double*)w;
  p.zb = (double*)zb;
  p.zp = (double*)zp;
  p.yb = (double*)yb;
  p.yp = (double*)yp;
  p.at = (double*)at;
  p.xt = (double*)xt;
  p.B = B;
  p.M = M;
  p.phi = phi;
  p.P = P;
  p.n_inner = n_inner;
  p.R = R;
  p.rung_floats = rung_floats;
  p.sigma = sigma;
  p.alpha = alpha;
  nsfused_stack_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* nsfused_stack_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
