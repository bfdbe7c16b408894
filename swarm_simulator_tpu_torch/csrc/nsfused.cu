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
// every block is co-resident), with cooperative_groups grid syncs between
// dependent stages.  The rung's pivots stay flat float32 in device memory
// and are read with coalesced row loads that the L2 keeps warm across the
// chunk's iterations; each knot step is split by (agent, axis) row groups
// over all warps, and the group that owns rows of T_k also applies the
// small off-diagonal block locally, so a chain step costs one grid sync.
// Arithmetic is true float32 FMA on CUDA cores: unlike the TPU kernel's
// bf16 mantissa split (two-term split in production, ~1e-5 relative), the
// pair contractions here are exact float32.  A^T y is a deterministic
// per-agent gather over a CSR of the agent's pairs (no atomics), A x a
// gather by pair index, and the off-diagonal block Ho is read per knot, so
// non-uniform segment durations need no special layout.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
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
  int B, M, phi, P, n_inner;
  float rho, sigma, alpha;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dot(row of length n, shared vector); every lane returns the full sum
__device__ __forceinline__ float row_dot(const float* __restrict__ row,
                                         const float* vec, int n, int lane,
                                         bool vec4) {
  float s = 0.f;
  if (vec4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(vec);
    for (int j = lane; j < (n >> 2); j += 32) {
      float4 a = __ldg(r4 + j);
      float4 b = v4[j];
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
  } else {
    for (int j = lane; j < n; j += 32) s = fmaf(__ldg(row + j), vec[j], s);
  }
  return warp_sum(s);
}

__global__ void __launch_bounds__(kThreads)
nsfused_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);

  const int phi = p.phi, M = p.M, Mi = M - 1, npp = 2 * phi;
  const int B3 = 3 * p.B, D = M * npp, bs = B3 * phi, P = p.P;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * warps_per_block;
  // blocks whose first warp owns no (agent, axis) group skip the chain's
  // shared-memory staging
  const bool chain_block = blockIdx.x * warps_per_block < B3;
  const bool vec4 = (bs & 3) == 0;
  const float rho = p.rho, sigma = p.sigma, alpha = p.alpha;
  const float beta = 1.f - alpha;
  const size_t blk = (size_t)bs * bs;

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

    // ---- forward sweep: T_k = Dinv_k y_k, y_{k+1} = b_{k+1} - Ho_k^T T_k ----
    for (int k = 0; k < Mi; ++k) {
      if (chain_block) {
        for (int i = threadIdx.x; i < bs; i += blockDim.x)
          sh[i] = p.rhs[k * bs + i];
        __syncthreads();
        const float* Dk = p.dinv + (size_t)k * blk;
        for (int grp = gwarp; grp < B3; grp += nwarps) {
          float tv[kMaxPhi];
          for (int a = 0; a < phi; ++a)
            tv[a] = row_dot(Dk + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                            vec4);
          if (lane == 0) {
            for (int a = 0; a < phi; ++a) p.t[k * bs + grp * phi + a] = tv[a];
            if (k + 1 < Mi) {
              const float* H = p.ho + (size_t)k * phi * phi;
              for (int i = 0; i < phi; ++i) {
                float s = 0.f;
                for (int a = 0; a < phi; ++a) s += H[a * phi + i] * tv[a];
                p.rhs[(k + 1) * bs + grp * phi + i] -= s;
              }
            }
          }
        }
      }
      grid.sync();
    }

    // ---- back substitution: x_k = T_k - Dinv_k (Ho_k x_{k+1}), in place ----
    for (int k = Mi - 2; k >= 0; --k) {
      if (chain_block) {
        const float* H = p.ho + (size_t)k * phi * phi;
        const float* xn = p.t + (size_t)(k + 1) * bs;
        for (int i = threadIdx.x; i < bs; i += blockDim.x) {
          const int grp = i / phi, a = i - grp * phi;
          float s = 0.f;
          for (int c = 0; c < phi; ++c) s += H[a * phi + c] * xn[grp * phi + c];
          sh[i] = s;
        }
        __syncthreads();
        const float* Dk = p.dinv + (size_t)k * blk;
        for (int grp = gwarp; grp < B3; grp += nwarps) {
          float tv[kMaxPhi];
          for (int a = 0; a < phi; ++a)
            tv[a] = row_dot(Dk + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                            vec4);
          if (lane == 0)
            for (int a = 0; a < phi; ++a) p.t[k * bs + grp * phi + a] -= tv[a];
        }
      }
      grid.sync();
    }

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
                  int B, int M, int phi, int P, int n_inner, float rho,
                  float sigma, float alpha, void* stream) {
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

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = (size_t)3 * B * phi * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nsfused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nsfused_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  // a cooperative grid larger than what can co-reside would deadlock
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)nsfused_kernel, dim3(sms),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* nsfused_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
