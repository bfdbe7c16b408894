// T3, the staged Thomas probe for Hopper (sm_90a): the block-tridiagonal
// solve with a DENSE coupling koM [bs, bs], cut into stages that add one
// cost at a time.  It replaces the Pallas TPU kernels of the JAX package's
// tools/pallas_debug/thomas_probe.py (k_dma, k_mv, k_fwd, and the full
// ops/pallas_thomas.py::thomas_solve_pallas it probes), over Mi pivot blocks
// D_k = dinv[r, k] [bs, bs]:
//   dma   out[k] = D_k[0, :]  (every row of D_k read, as the TPU copies it)
//   mv    out[k] = D_k b_k
//   fwd   y_0 = b_0, y_k = b_k - koM^T (D_{k-1} y_{k-1}); out = y
//   full  fwd, then x_{Mi-1} = D_{Mi-1} y_{Mi-1},
//         x_k = D_k^T (y_k - koM x_{k+1}); out = x
//
// What bounds it on an H100: the chain of dependent [bs] x [bs, bs]
// products, as in K2 (csrc/thomas.cu); with a dense koM every stage of fwd
// and full also reads a second [bs, bs] matrix (1.3 MB at bs 576, 21 MB at
// bs 2304, from L2 when it fits).
//
// What the design does about it: K2's first grid and loop (one cooperative
// launch, ceil(bs / 24) blocks of 256 threads, a grid sync per stage, one
// warp per row with float4 row reads against a vector staged in shared
// memory).  A dense coupling needs every element of t = D y before any row
// of koM^T t, so fwd and full pay a SECOND grid sync per stage where K2's
// per-row-group coupling needs none.  D_k^T u (full's back substitution)
// runs column-wise: a block owns 32 columns, its eight warps split the rows,
// and the partial sums meet in shared memory in warp order.
#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Stage { DMA = 0, MV, FWD, FULL };

struct Params {
  const float* dinv;  // [Mi, bs, bs] the rung's pivot blocks
  const float* koM;   // [bs, bs]
  const float* koMT;  // [bs, bs] koM transposed
  const float* b;     // [Mi, bs]
  float* y;           // [Mi, bs] scratch (full): the forward rows
  float* t;           // [bs] scratch: D y, or y - koM x
  float* out;         // [Mi, bs]
  float* sink;        // [grid * 256] scratch: what dma read
  int bs, Mi, stage;
};

// dot(row, vec) over bs floats (bs a multiple of 4); every lane gets it
__device__ __forceinline__ float row_dot(const float* __restrict__ row,
                                         const float* vec, int bs, int lane) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* v4 = reinterpret_cast<const float4*>(vec);
  float s = 0.f;
  for (int j = lane; j < (bs >> 2); j += 32) {
    const float4 a = __ldg(r4 + j), v = v4[j];
    s = fmaf(a.x, v.x, s);
    s = fmaf(a.y, v.y, s);
    s = fmaf(a.z, v.z, s);
    s = fmaf(a.w, v.w, s);
  }
  return probe::warp_sum(s);
}

// stage src[0..bs) (written before the last grid sync: read through L2)
// into shared memory
__device__ __forceinline__ void stage_vec(float* sh, const float* src,
                                          int bs) {
  for (int i = threadIdx.x; i < bs; i += blockDim.x) sh[i] = __ldcg(src + i);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) probe_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sh[];  // [bs] vector, [8][32] sums
  float* red = sh + p.bs;
  const int bs = p.bs, Mi = p.Mi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const size_t blk = (size_t)bs * bs;

  // out_row[i] = M[i, :] . sh for every row i (M [bs, bs] row-major)
  auto rows_times = [&](const float* M, float* out_row) {
    for (int i = gwarp; i < bs; i += nwarps) {
      const float v = row_dot(M + (size_t)i * bs, sh, bs, lane);
      if (lane == 0) out_row[i] = v;
    }
  };

  if (p.stage == DMA) {
    float s = 0.f;
    for (int k = 0; k < Mi; ++k) {
      const float* Dk = p.dinv + (size_t)k * blk;
      for (int i = gwarp; i < bs; i += nwarps) {
        const float4* r4 = reinterpret_cast<const float4*>(Dk + (size_t)i * bs);
        float4* o4 = reinterpret_cast<float4*>(p.out + (size_t)k * bs);
        for (int j = lane; j < (bs >> 2); j += 32) {
          const float4 a = __ldg(r4 + j);
          if (i == 0) o4[j] = a;
          s += (a.x + a.y) + (a.z + a.w);
        }
      }
      grid.sync();
    }
    p.sink[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
    return;
  }

  if (p.stage == MV) {
    for (int k = 0; k < Mi; ++k) {
      stage_vec(sh, p.b + (size_t)k * bs, bs);
      rows_times(p.dinv + (size_t)k * blk, p.out + (size_t)k * bs);
      grid.sync();
    }
    return;
  }

  // ---- forward: y_k = b_k - koM^T (D_{k-1} y_{k-1}) ----
  float* y = p.stage == FWD ? p.out : p.y;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < bs; i += blockDim.x) y[i] = p.b[i];
  grid.sync();
  for (int k = 1; k < Mi; ++k) {
    stage_vec(sh, y + (size_t)(k - 1) * bs, bs);
    rows_times(p.dinv + (size_t)(k - 1) * blk, p.t);
    grid.sync();
    stage_vec(sh, p.t, bs);
    const float* bk = p.b + (size_t)k * bs;
    float* yk = y + (size_t)k * bs;
    for (int j = gwarp; j < bs; j += nwarps) {
      const float v = row_dot(p.koMT + (size_t)j * bs, sh, bs, lane);
      if (lane == 0) yk[j] = bk[j] - v;
    }
    grid.sync();
  }
  if (p.stage == FWD) return;

  // ---- x_{Mi-1} = D_{Mi-1} y_{Mi-1} ----
  stage_vec(sh, y + (size_t)(Mi - 1) * bs, bs);
  rows_times(p.dinv + (size_t)(Mi - 1) * blk, p.out + (size_t)(Mi - 1) * bs);
  grid.sync();

  // ---- back substitution: x_k = D_k^T (y_k - koM x_{k+1}) ----
  for (int k = Mi - 2; k >= 0; --k) {
    stage_vec(sh, p.out + (size_t)(k + 1) * bs, bs);
    const float* yk = y + (size_t)k * bs;
    for (int i = gwarp; i < bs; i += nwarps) {
      const float v = row_dot(p.koM + (size_t)i * bs, sh, bs, lane);
      if (lane == 0) p.t[i] = __ldcg(yk + i) - v;
    }
    grid.sync();
    stage_vec(sh, p.t, bs);
    const float* Dk = p.dinv + (size_t)k * blk;
    for (int c0 = blockIdx.x * 32; c0 < bs; c0 += gridDim.x * 32) {
      const int c = c0 + lane;
      float s = 0.f;
      if (c < bs)
        for (int i = warp; i < bs; i += kWarps)
          s = fmaf(__ldg(Dk + (size_t)i * bs + c), sh[i], s);
      red[warp * 32 + lane] = s;
      __syncthreads();
      if (warp == 0 && c < bs) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += red[w * 32 + lane];
        p.out[(size_t)k * bs + c] = v;
      }
      __syncthreads();
    }
    grid.sync();
  }
}

size_t smem_bytes(int bs) { return (size_t)(bs + kWarps * 32) * sizeof(float); }

}  // namespace

extern "C" {

// The blocks thomas_probe launches for bs (K2's first ceil(bs / 24), capped at
// what can co-reside), through `grid`; returns a cudaError_t.
int thomas_probe_grid(int bs, int* grid) {
  return probe::coop_grid((const void*)probe_kernel, kThreads, smem_bytes(bs),
                          (bs + 23) / 24, grid);
}

// One cooperative launch of `stage` (0 dma, 1 mv, 2 fwd, 3 full) on `grid`
// blocks: dinv [Mi, bs, bs] (the rung, 16-byte aligned), koM and koMT
// [bs, bs], b [Mi, bs]; scratch y [Mi, bs], t [bs], sink [grid * 256];
// out [Mi, bs].  bs a multiple of 4.  Returns a cudaError_t (0 = launched).
int thomas_probe(void* dinv, void* koM, void* koMT, void* b, void* y, void* t,
                 void* out, void* sink, int bs, int Mi, int stage, int grid,
                 void* stream) {
  if (stage < DMA || stage > FULL || bs < 4 || bs % 4 || Mi < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bs);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.dinv = (const float*)dinv;
  p.koM = (const float*)koM;
  p.koMT = (const float*)koMT;
  p.b = (const float*)b;
  p.y = (float*)y;
  p.t = (float*)t;
  p.out = (float*)out;
  p.sink = (float*)sink;
  p.bs = bs;
  p.Mi = Mi;
  p.stage = stage;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)probe_kernel, dim3(grid),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* thomas_probe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
