// Block-tridiagonal (Thomas) solve x = K(rho_r)^-1 b for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel swarm_simulator_tpu/ops/pallas_thomas.py
// ::_kernel (thomas_solve_pallas): the KKT solve of the knot-state ADMM
// against one rung's stored pivot inverses.  With y_0 = b_0,
//   forward   T_k = Dinv_k y_k,  y_{k+1} = b_{k+1} - (I (x) Ho_k)^T T_k
//   backward  x_{Mi-1} = T_{Mi-1},
//             x_k = Dinv_k (y_k - (I (x) Ho_k) x_{k+1})
// over Mi interior knots, blocks of bs = B3*phi rows (row index
// (agent*3 + axis)*phi + derivative order), Ho_k [phi, phi] per knot.
//
// What bounds it on an H100: 2*Mi - 1 strictly dependent
// [bs] x [bs, bs] matvecs.  At 64 agents (bs = 576, Mi = 35) one solve
// reads 69 pivot blocks, 91.6 MB, whose byte floor at 3.35 TB/s is 27 us;
// the dependency chain, not the bytes, sets the time.
//
// What the design does about it: one cooperative launch per solve with a
// grid sync per chain step, and a grid only as large as the chain needs
// (one warp per (agent, axis) row group, so ceil(B3 / 8) blocks of 256
// threads): a smaller grid makes each sync cheaper.  The warp that owns a
// row group computes its phi rows of Dinv_k v with coalesced float4 row
// reads and applies the small off-diagonal block to them itself, so a
// chain step costs one sync.  Ho is read per knot (no uniform-duration
// rule) and the pivots stay flat and unpadded.  The pivots are NOT
// assumed symmetric (the device prep's LU-plus-Newton inverses are not):
// every product is Dinv_k @ v, a row of Dinv_k against the vector.
// Arithmetic is float32 FMA on CUDA cores.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPhi = 4;

struct Params {
  const float* dinv;  // [Mi, bs, bs] pivot inverses of the rung
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

__global__ void __launch_bounds__(kThreads) thomas_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);

  const int phi = p.phi, Mi = p.Mi, B3 = p.B3, bs = B3 * phi;
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * warps_per_block;
  const bool vec4 = (bs & 3) == 0;
  const size_t blk = (size_t)bs * bs;

  // ---- forward sweep ----
  for (int k = 0; k < Mi; ++k) {
    // y_k, written by other blocks before the last grid sync: read it
    // through L2 (__ldcg), not a possibly stale L1 line
    const float* yk = k == 0 ? p.b : p.y + (size_t)k * bs;
    for (int i = threadIdx.x; i < bs; i += blockDim.x) sh[i] = __ldcg(yk + i);
    __syncthreads();
    const float* Dk = p.dinv + (size_t)k * blk;
    for (int grp = gwarp; grp < B3; grp += nwarps) {
      float tv[kMaxPhi];
      for (int a = 0; a < phi; ++a)
        tv[a] = row_dot(Dk + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                        vec4);
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
    const float* Dk = p.dinv + (size_t)k * blk;
    for (int grp = gwarp; grp < B3; grp += nwarps) {
      float tv[kMaxPhi];
      for (int a = 0; a < phi; ++a)
        tv[a] = row_dot(Dk + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                        vec4);
      if (lane == 0)
        for (int a = 0; a < phi; ++a)
          p.x[(size_t)k * bs + grp * phi + a] = tv[a];
    }
    if (k > 0) grid.sync();
  }
}

}  // namespace

extern "C" {

// One solve on `stream`: x [Mi, bs] = K^-1 b for the rung whose pivots
// start at `dinv`; `y` is [Mi, bs] scratch.  Returns a cudaError_t
// (0 = launched): the cooperative-launch error, or cudaGetLastError()
// after it.
int thomas_solve(void* dinv, void* ho, void* b, void* y, void* x, int B3,
                 int Mi, int phi, void* stream) {
  if (phi < 1 || phi > kMaxPhi || Mi < 1 || B3 < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.dinv = (const float*)dinv;
  p.ho = (const float*)ho;
  p.b = (const float*)b;
  p.y = (float*)y;
  p.x = (float*)x;
  p.B3 = B3;
  p.Mi = Mi;
  p.phi = phi;

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = (size_t)B3 * phi * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(thomas_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, thomas_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  // a cooperative grid larger than what can co-reside would deadlock
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = (B3 + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)thomas_kernel, dim3(grid),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* thomas_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
