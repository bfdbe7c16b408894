// T5, the row-assembly patterns for Hopper (sm_90a).  They replace the
// fourteen Pallas TPU kernels of the JAX package's
// tools/pallas_debug/mosaic_patterns.py (`run`, kernels k1 ... k12), which
// asked which ways of assembling rows the TPU's kernel compiler lowers:
// lane and sublane concatenation, reshapes, pads, dynamic row writes,
// broadcasts, a lane roll, dynamic_update_slice and .at[].add.  On Hopper
// each is an index map from the output element to its source, so one
// kernel computes all of them, one thread per output element, the pattern
// chosen by its number (ops/row_patterns.PATTERNS gives names, shapes and
// the plain versions).  P11, the update the TPU's compiler refused, is
// computed like the others.  P8, the one pattern that sums (576 outputs,
// each over 192 products), has a launch of its own: one thread an output
// chained 192 dependent loads and FMAs on 3 blocks, so it splits each sum
// over the 8 warps of a block.  A block owns 32 outputs, one a lane, so
// that the loads of a b-row stay coalesced along c; each warp takes 24 of
// the 192 b-rows, its loads unrolled to be in flight together; the
// partial sums meet in shared memory in warp order (deterministic): 18
// blocks.
//
// What bounds them on an H100: nothing but the launch; the largest moves
// 0.3 MB (P4) or sums 110,592 products (P8).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// P8: g [192, 3, 192] summed over its 192 b-rows, 24 a warp
constexpr int kP8Rows = 192;
constexpr int kP8PerWarp = kP8Rows / kWarps;
constexpr int kP8Id = 9;

// P8: out[e] = sum_b g[b * n + e] col[b] for the n = 576 outputs e
__global__ void __launch_bounds__(kThreads)
    p8_kernel(const float* __restrict__ g, const float* __restrict__ col,
              float* __restrict__ out, int n) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int b0 = warp * kP8PerWarp;
  float s = 0.f;
  if (e < n) {
    float v[kP8PerWarp];
#pragma unroll
    for (int u = 0; u < kP8PerWarp; ++u)
      v[u] = __ldg(g + (size_t)(b0 + u) * n + e);
#pragma unroll
    for (int u = 0; u < kP8PerWarp; ++u)
      s = fmaf(v[u], __ldg(col + b0 + u), s);
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < n) {
    float t = part[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += part[w][lane];
    out[e] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    pattern_kernel(int id, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ c,
                   float* __restrict__ out, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = 0.f;
  switch (id) {
    case 0: {  // P1: [8, 768] = cat(a, b, c) of [8, 256] along lanes
      const int r = e / 768, col = e % 768, src = col / 256;
      const float* p = src == 0 ? a : (src == 1 ? b : c);
      v = p[r * 256 + col % 256];
      break;
    }
    case 1: {  // P1b: [8, 384] = cat(x, 2x) of x [8, 192]
      const int r = e / 384, col = e % 384;
      v = col < 192 ? a[r * 192 + col] : a[r * 192 + col - 192] * 2.0f;
      break;
    }
    case 2: {  // P2: [8, 256] = cat(0 * x[:1], x[:7]) along rows
      const int r = e / 256, col = e % 256;
      v = r == 0 ? a[col] * 0.0f : a[(r - 1) * 256 + col];
      break;
    }
    case 3: {  // P3: [35, 3, 192] = stack(x, 2x, 3x) on the middle axis
      const int m = e / 576, f = (e / 192) % 3, col = e % 192;
      const float x = a[m * 192 + col];
      v = f == 0 ? x : x * (float)(f + 1);
      break;
    }
    case 4:  // P4: [216, 192] through [36, 6, 192] and back, times 2
      v = a[e] * 2.0f;
      break;
    case 5: {  // P5: [8, 256] = x [8, 192] padded with zero lanes
      const int r = e / 256, col = e % 256;
      v = col < 192 ? a[r * 192 + col] : 0.f;
      break;
    }
    case 6: {  // P6: [8, 768] zeros, row k lanes 256:512 = 2 a[k, :256]
      const int r = e / 768, col = e % 768;
      v = col >= 256 && col < 512 ? a[r * 256 + col - 256] * 2.0f : 0.f;
      break;
    }
    case 7: {  // P6b: [8, 768] zeros, row k lanes 0:192 = 2 a[k, :192]
      const int r = e / 768, col = e % 768;
      v = col < 192 ? a[r * 256 + col] * 2.0f : 0.f;
      break;
    }
    case 8: {  // P7: [8, 3, 192], out[k, f] = a[k, :192] (1 + f)
      const int r = e / 576, f = (e / 192) % 3, col = e % 192;
      v = a[r * 256 + col] * (1.0f + (float)f);
      break;
    }
    // case 9 (P8) runs in p8_kernel
    case 10: {  // P9: [8, 3, 192] = x[:, None, :] * [0, 1, 2][None, :, None]
      const int r = e / 576, f = (e / 192) % 3, col = e % 192;
      v = a[r * 192 + col] * (float)f;
      break;
    }
    case 11: {  // P10: [8, 768] = x rolled by 256 lanes
      const int r = e / 768, col = e % 768;
      v = a[r * 768 + (col + 512) % 768];
      break;
    }
    case 12: {  // P11: [8, 768] zeros with lanes 256:512 = a
      const int r = e / 768, col = e % 768;
      v = col >= 256 && col < 512 ? a[r * 256 + col - 256] : 0.f;
      break;
    }
    case 13: {  // P12: [8, 3, 192] zeros, [1:8, 1, :] += a[:7, :192]
      const int r = e / 576, f = (e / 192) % 3, col = e % 192;
      v = r >= 1 && f == 1 ? 0.f + a[(r - 1) * 256 + col] : 0.f;
      break;
    }
  }
  out[e] = v;
}

}  // namespace

extern "C" {

// Pattern `id` (0-13, the order of ops/row_patterns.PATTERNS) into out
// [n] from up to three inputs, on `stream`: P8 on its warp-split grid of
// ceil(n / 32) blocks, the others one thread an element.  Returns a
// cudaError_t (0 = launched).
int row_pattern(int id, void* a, void* b, void* c, void* out, int n,
                void* stream) {
  if (id < 0 || id > 13 || n < 1) return (int)cudaErrorInvalidValue;
  if (id == kP8Id)
    p8_kernel<<<(n + 31) / 32, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)out, n);
  else
    pattern_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(id, (const float*)a,
                                             (const float*)b,
                                             (const float*)c, (float*)out, n);
  return (int)cudaGetLastError();
}

const char* row_pattern_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
