// Block-tridiagonal (Thomas) solves for Hopper (sm_90a): K2, one full
// solve x = K(rho_r)^-1 b, and K3a/K3b, the forward and backward sweeps
// over one knot chunk of the cross-device pipeline.
//
// K2 replaces the Pallas TPU kernel swarm_simulator_tpu/ops/pallas_thomas.py
// ::_kernel (thomas_solve_pallas): the KKT solve of the knot-state ADMM
// against one rung's stored pivot inverses.  With y_0 = b_0,
//   forward   T_k = Dinv_k y_k,  y_{k+1} = b_{k+1} - (I (x) Ho_k)^T T_k
//   backward  x_{Mi-1} = T_{Mi-1},
//             x_k = Dinv_k (y_k - (I (x) Ho_k) x_{k+1})
// over Mi interior knots, blocks of bs = B3*phi rows (row index
// (agent*3 + axis)*phi + derivative order), Ho_k [phi, phi] per knot.
//
// K3a / K3b replace pallas_thomas.py::_chunk_fwd_kernel / _chunk_bwd_kernel
// (thomas_chunk_fwd / thomas_chunk_bwd).  A chunk holds L knots of the
// chain; kin_j couples the previous knot into knot j, kout_j knot j into
// the next (zero at the chain's ends and on pad knots):
//   K3a  y_j = b_j - (I (x) kin_j)^T T_{j-1}  (T_{-1} = t_in, the carry),
//        T_j = Dinv_j y_j; writes T (the carry out is T_{L-1})
//   K3b  x_j = T_j - Dinv_j (I (x) kout_j) x_{j+1}  (x_L = x_in),
//        writes x (the carry out is x_0)
//
// What bounds them on an H100: a chain of strictly dependent
// [bs] x [bs, bs] matvecs (K2: 2*Mi - 1 of them; K3a and K3b: L each).  At
// 64 agents (bs = 576) one pivot block is 1.33 MB, so K2 reads 91.6 MB
// (27 us at 3.35 TB/s) and a 35-knot chunk sweep 46.4 MB (14 us); the
// dependency chain, not the bytes, sets the time.
//
// What the design does about it: one cooperative launch per solve or
// chunk sweep with a grid sync per chain step, and a grid only as large as
// the chain needs (one warp per (agent, axis) row group, so ceil(B3 / 8)
// blocks of 256 threads): a smaller grid makes each sync cheaper.  The
// warp that owns a row group computes its phi rows of Dinv_k v with
// coalesced float4 row reads and applies the small coupling block to them
// itself, so a chain step costs one sync.  Ho is read per knot (no
// uniform-duration rule) and the pivots stay flat and unpadded.  The
// pivots are NOT assumed symmetric (the device prep's LU-plus-Newton
// inverses are not): every product is Dinv_k @ v, a row of Dinv_k against
// the vector.  Arithmetic is float32 FMA on CUDA cores.
//
// K2 also reads bf16 pivots (the preconditioner-only inventory of
// NSSettings.precond_dtype="bfloat16", the Pallas kernel's bf16 double
// buffer): each pivot is widened to float32 at the multiply, as the TPU
// kernel promotes its bf16 slab, and b, y, x stay float32.  The rows are
// read 8 bf16 (16 bytes) per lane, so the stream is half of float32's: at
// 256 agents (bs = 2304, Mi = 71) a rung is 0.754 GB instead of 1.508 GB,
// read once by each sweep.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPhi = 4;

template <typename T>
struct Params {
  const T* dinv;      // [Mi, bs, bs] pivot inverses of the rung
  const float* ho;    // [Mi-1, phi, phi]
  const float* b;     // [Mi, bs]
  float* y;           // [Mi, bs] scratch: forward rows y_k
  float* x;           // [Mi, bs] solution
  int B3, Mi, phi;
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

// the same for a bf16 row, each element widened to float32 at the FMA;
// vec8: 8 bf16 (one 16-byte load) per lane step
__device__ __forceinline__ float row_dot(const __nv_bfloat16* __restrict__ row,
                                         const float* vec, int n, int lane,
                                         bool vec8) {
  float s = 0.f;
  if (vec8) {
    const uint4* r8 = reinterpret_cast<const uint4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(vec);
    for (int j = lane; j < (n >> 3); j += 32) {
      const uint4 u = __ldg(r8 + j);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float4 b0 = v4[2 * j], b1 = v4[2 * j + 1];
      const float2 a0 = __bfloat1622float2(h[0]);
      const float2 a1 = __bfloat1622float2(h[1]);
      const float2 a2 = __bfloat1622float2(h[2]);
      const float2 a3 = __bfloat1622float2(h[3]);
      s = fmaf(a0.x, b0.x, s);
      s = fmaf(a0.y, b0.y, s);
      s = fmaf(a1.x, b0.z, s);
      s = fmaf(a1.y, b0.w, s);
      s = fmaf(a2.x, b1.x, s);
      s = fmaf(a2.y, b1.y, s);
      s = fmaf(a3.x, b1.z, s);
      s = fmaf(a3.y, b1.w, s);
    }
  } else {
    for (int j = lane; j < n; j += 32)
      s = fmaf(__bfloat162float(row[j]), vec[j], s);
  }
  return warp_sum(s);
}

// elements of T in one 16-byte row load
template <typename T>
__device__ __forceinline__ bool rows_vectorised(int bs) {
  return bs % (16 / (int)sizeof(T)) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_kernel(const Params<T> p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);

  const int phi = p.phi, Mi = p.Mi, B3 = p.B3, bs = B3 * phi;
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * warps_per_block;
  const bool vec = rows_vectorised<T>(bs);
  const size_t blk = (size_t)bs * bs;

  // ---- forward sweep ----
  for (int k = 0; k < Mi; ++k) {
    // y_k, written by other blocks before the last grid sync: read it
    // through L2 (__ldcg), not a possibly stale L1 line
    const float* yk = k == 0 ? p.b : p.y + (size_t)k * bs;
    for (int i = threadIdx.x; i < bs; i += blockDim.x) sh[i] = __ldcg(yk + i);
    __syncthreads();
    const T* Dk = p.dinv + (size_t)k * blk;
    for (int grp = gwarp; grp < B3; grp += nwarps) {
      float tv[kMaxPhi];
      for (int a = 0; a < phi; ++a)
        tv[a] = row_dot(Dk + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                        vec);
      if (lane == 0) {
        const int r0 = grp * phi;
        if (k == 0)
          for (int a = 0; a < phi; ++a) p.y[r0 + a] = sh[r0 + a];
        if (k + 1 < Mi) {
          const float* H = p.ho + (size_t)k * phi * phi;
          const float* bn = p.b + (size_t)(k + 1) * bs + r0;
          float* yn = p.y + (size_t)(k + 1) * bs + r0;
          for (int i = 0; i < phi; ++i) {
            float s = 0.f;
            for (int a = 0; a < phi; ++a) s = fmaf(H[a * phi + i], tv[a], s);
            yn[i] = bn[i] - s;
          }
        } else {
          for (int a = 0; a < phi; ++a)
            p.x[(size_t)k * bs + r0 + a] = tv[a];
        }
      }
    }
    grid.sync();
  }

  // ---- back substitution ----
  for (int k = Mi - 2; k >= 0; --k) {
    const float* H = p.ho + (size_t)k * phi * phi;
    const float* xn = p.x + (size_t)(k + 1) * bs;
    const float* yk = p.y + (size_t)k * bs;
    for (int i = threadIdx.x; i < bs; i += blockDim.x) {
      const int grp = i / phi, a = i - grp * phi;
      float s = __ldcg(yk + i);
      for (int c = 0; c < phi; ++c)
        s = fmaf(-H[a * phi + c], __ldcg(xn + grp * phi + c), s);
      sh[i] = s;
    }
    __syncthreads();
    const T* Dk = p.dinv + (size_t)k * blk;
    for (int grp = gwarp; grp < B3; grp += nwarps) {
      float tv[kMaxPhi];
      for (int a = 0; a < phi; ++a)
        tv[a] = row_dot(Dk + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                        vec);
      if (lane == 0)
        for (int a = 0; a < phi; ++a)
          p.x[(size_t)k * bs + grp * phi + a] = tv[a];
    }
    if (k > 0) grid.sync();
  }
}

struct ChunkParams {
  const float* dinv;   // [L, bs, bs] pivot inverses of the rung, the chunk's knots
  const float* kc;     // [L, phi, phi] couplings: kin (K3a) or kout (K3b)
  const float* v;      // K3a: b [L, bs]; K3b: T [L, bs]
  const float* carry;  // K3a: t_in [bs]; K3b: x_in [bs]
  float* y;            // K3a scratch [L, bs]: forward rows y_j (K3b: unused)
  float* out;          // K3a: T [L, bs]; K3b: x [L, bs]
  int B3, L, phi;
};

// K3a: the forward sweep over one chunk, carry folded into y_0
__global__ void __launch_bounds__(kThreads) chunk_fwd_kernel(
    const ChunkParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);

  const int phi = p.phi, L = p.L, B3 = p.B3, bs = B3 * phi;
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * warps_per_block;
  const bool vec4 = (bs & 3) == 0;
  const size_t blk = (size_t)bs * bs;

  for (int j = 0; j < L; ++j) {
    if (j == 0) {
      // y_0 = b_0 - (I (x) kin_0)^T t_in, staged by every block
      for (int i = threadIdx.x; i < bs; i += blockDim.x) {
        const int grp = i / phi, a = i - grp * phi;
        float s = p.v[i];
        for (int c = 0; c < phi; ++c)
          s = fmaf(-p.kc[c * phi + a], __ldg(p.carry + grp * phi + c), s);
        sh[i] = s;
      }
    } else {
      // y_j, written by other blocks before the last grid sync: read it
      // through L2 (__ldcg), not a possibly stale L1 line
      const float* yj = p.y + (size_t)j * bs;
      for (int i = threadIdx.x; i < bs; i += blockDim.x) sh[i] = __ldcg(yj + i);
    }
    __syncthreads();
    const float* Dj = p.dinv + (size_t)j * blk;
    for (int grp = gwarp; grp < B3; grp += nwarps) {
      float tv[kMaxPhi];
      for (int a = 0; a < phi; ++a)
        tv[a] = row_dot(Dj + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                        vec4);
      if (lane == 0) {
        const int r0 = grp * phi;
        for (int a = 0; a < phi; ++a) p.out[(size_t)j * bs + r0 + a] = tv[a];
        if (j + 1 < L) {
          const float* H = p.kc + (size_t)(j + 1) * phi * phi;
          const float* bn = p.v + (size_t)(j + 1) * bs + r0;
          float* yn = p.y + (size_t)(j + 1) * bs + r0;
          for (int i = 0; i < phi; ++i) {
            float s = 0.f;
            for (int a = 0; a < phi; ++a) s = fmaf(H[a * phi + i], tv[a], s);
            yn[i] = bn[i] - s;
          }
        }
      }
    }
    if (j + 1 < L) grid.sync();
  }
}

// K3b: the back substitution over one chunk, from x_in at j = L-1
__global__ void __launch_bounds__(kThreads) chunk_bwd_kernel(
    const ChunkParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);

  const int phi = p.phi, L = p.L, B3 = p.B3, bs = B3 * phi;
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * warps_per_block;
  const bool vec4 = (bs & 3) == 0;
  const size_t blk = (size_t)bs * bs;

  for (int j = L - 1; j >= 0; --j) {
    // stage (I (x) kout_j) x_{j+1}; x_{j+1} is the carry or a row that
    // other blocks wrote before the last grid sync (__ldcg)
    const float* H = p.kc + (size_t)j * phi * phi;
    const float* xn = j == L - 1 ? p.carry : p.out + (size_t)(j + 1) * bs;
    for (int i = threadIdx.x; i < bs; i += blockDim.x) {
      const int grp = i / phi, a = i - grp * phi;
      float s = 0.f;
      for (int c = 0; c < phi; ++c)
        s = fmaf(H[a * phi + c], __ldcg(xn + grp * phi + c), s);
      sh[i] = s;
    }
    __syncthreads();
    const float* Dj = p.dinv + (size_t)j * blk;
    for (int grp = gwarp; grp < B3; grp += nwarps) {
      float tv[kMaxPhi];
      for (int a = 0; a < phi; ++a)
        tv[a] = row_dot(Dj + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                        vec4);
      if (lane == 0) {
        const size_t r0 = (size_t)j * bs + grp * phi;
        for (int a = 0; a < phi; ++a) p.out[r0 + a] = p.v[r0 + a] - tv[a];
      }
    }
    if (j > 0) grid.sync();
  }
}

// One cooperative launch of `kernel` on a grid sized to the chain (one
// warp per row group), `bs` floats of dynamic shared memory.  Returns a
// cudaError_t: the launch's, or cudaGetLastError() after it.
template <typename P>
int launch_coop(void (*kernel)(const P), P p, int B3, int phi,
                void* stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = (size_t)B3 * phi * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  // a cooperative grid larger than what can co-reside would deadlock
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = (B3 + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int solve_as(void* dinv, void* ho, void* b, void* y, void* x, int B3, int Mi,
             int phi, void* stream) {
  if (phi < 1 || phi > kMaxPhi || Mi < 1 || B3 < 1)
    return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.dinv = (const T*)dinv;
  p.ho = (const float*)ho;
  p.b = (const float*)b;
  p.y = (float*)y;
  p.x = (float*)x;
  p.B3 = B3;
  p.Mi = Mi;
  p.phi = phi;
  return launch_coop(thomas_kernel<T>, p, B3, phi, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a cudaError_t
// (0 = launched): the cooperative-launch error, or cudaGetLastError()
// after it.  `dinv` points at the rung's pivots.

// K2: x [Mi, bs] = K^-1 b; `y` is [Mi, bs] scratch.
int thomas_solve(void* dinv, void* ho, void* b, void* y, void* x, int B3,
                 int Mi, int phi, void* stream) {
  return solve_as<float>(dinv, ho, b, y, x, B3, Mi, phi, stream);
}

// K2 on bf16 pivots (`dinv` [Mi, bs, bs] bf16; ho, b, y, x float32).
int thomas_solve_bf16(void* dinv, void* ho, void* b, void* y, void* x,
                      int B3, int Mi, int phi, void* stream) {
  return solve_as<__nv_bfloat16>(dinv, ho, b, y, x, B3, Mi, phi, stream);
}

// K3a on `stream`: T [L, bs] of one chunk from b [L, bs], the couplings
// kin [L, phi, phi] and the carry t_in [bs]; `y` is [L, bs] scratch.
int thomas_chunk_fwd(void* dinv, void* kin, void* b, void* t_in, void* y,
                     void* T, int B3, int L, int phi, void* stream) {
  if (phi < 1 || phi > kMaxPhi || L < 1 || B3 < 1)
    return (int)cudaErrorInvalidValue;
  ChunkParams p;
  p.dinv = (const float*)dinv;
  p.kc = (const float*)kin;
  p.v = (const float*)b;
  p.carry = (const float*)t_in;
  p.y = (float*)y;
  p.out = (float*)T;
  p.B3 = B3;
  p.L = L;
  p.phi = phi;
  return launch_coop(chunk_fwd_kernel, p, B3, phi, stream);
}

// K3b on `stream`: x [L, bs] of one chunk from K3a's T [L, bs], the
// couplings kout [L, phi, phi] and the carry x_in [bs].
int thomas_chunk_bwd(void* dinv, void* kout, void* T, void* x_in, void* x,
                     int B3, int L, int phi, void* stream) {
  if (phi < 1 || phi > kMaxPhi || L < 1 || B3 < 1)
    return (int)cudaErrorInvalidValue;
  ChunkParams p;
  p.dinv = (const float*)dinv;
  p.kc = (const float*)kout;
  p.v = (const float*)T;
  p.carry = (const float*)x_in;
  p.y = nullptr;
  p.out = (float*)x;
  p.B3 = B3;
  p.L = L;
  p.phi = phi;
  return launch_coop(chunk_bwd_kernel, p, B3, phi, stream);
}

const char* thomas_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
