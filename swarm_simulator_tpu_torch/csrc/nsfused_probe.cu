// T1, the fused-chunk probes for Hopper (sm_90a).  They replace the four
// Pallas TPU kernels of the JAX package's tools/pallas_debug/nsfused_probe.py
// (P1 :67, P2 :106, P3 :156, P4 :231), the pieces of K1
// (ops/pallas_nsfused.py) on their own, at the 64-agent tile form (Mi = 35
// knots, phi = 3, B3 = 192):
//   P1  reshape-combine [216, 192] -> [108, 192]:
//       out[3i + j] = x[6i + j] + 2 x[6i + 3 + j]
//   P2  tile-form pivot apply: out[g, c] = sum_f sum_b D6[r, 3, f, g, b, c]
//       y[f, b], D6 [R, 35, 3, 3, 192, 192]
//   P3  split-precision pair product [216, 192] @ [192, 2048]: x split into
//       three bf16 parts by bit masks, the three products accumulated in
//       float32 on the tensor cores (mma.sync m16n8k16 bf16 -> f32)
//   P4  `inner` iterations of the tile-form Thomas sweeps in one launch:
//       t_{k-1} = D(k-1) y_{k-1}, y_k = b_k - hoT(t_{k-1}) (y_0 = b_0);
//       x_{Mi-1} = D(Mi-1) y_{Mi-1}; x_k = t_k - D(k) ho_(x_{k+1}), with
//       D(k) v [g, c] = sum_f sum_b D6[0, k, f, g, b, c] v[f, b],
//       hoT(t)[g] = sum_f ho[f, g] t[f], ho_(v)[f] = sum_g ho[f, g] v[g]
//
// What bounds them on an H100: P1 moves 0.25 MB, P2 reads 1.3 MB, P3 does
// 0.24 GFLOP (three bf16 passes) on 1.9 MB; all three are launch-bound at
// these sizes.  P4's 46.4 MB rung fits the 50 MB L2 but not the 132 SMs'
// 29.97 MB of shared memory, and each iteration is a chain of 69
// dependent applies of 1.33 MB each.
//
// What the design does about it: P1 one thread per output; P2 a block per
// (g, 32 columns), eight warps splitting the 576 rows (f, b), partial sums
// added in warp order in shared memory; P3 a warp per 16 x 32 output tile,
// the split done in registers as the fragments are loaded.  P4 "resident"
// means resident in L2: one cooperative launch of 24 blocks, block j owning
// columns [8j, 8j + 8) of all three g, so an apply and its ho coupling
// stay inside the block and each chain stage costs one grid sync; after the
// first iteration the rung is read from L2, not device memory.
#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kB3 = 192, kPhi = 3;
constexpr int kThreads = 256;

// ---- P1 ----
__global__ void p1_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 108 * kB3) return;
  const int row = e / kB3, c = e - row * kB3;
  const int i = row / 3, j = row - 3 * i;
  out[e] = x[(6 * i + j) * kB3 + c] + 2.0f * x[(6 * i + 3 + j) * kB3 + c];
}

// ---- P2: grid (3 g, 6 column chunks), 256 threads ----
__global__ void __launch_bounds__(kThreads)
    p2_kernel(const float* __restrict__ d, const float* __restrict__ y,
              float* __restrict__ out) {
  __shared__ float red[8][32];
  const int g = blockIdx.x, c = blockIdx.y * 32 + (threadIdx.x & 31);
  const int warp = threadIdx.x >> 5;
  float s = 0.f;
  for (int rr = warp; rr < kPhi * kB3; rr += 8) {
    const int f = rr / kB3, b = rr - f * kB3;
    s = fmaf(__ldg(d + (((size_t)(f * kPhi + g) * kB3 + b) * kB3 + c)),
             __ldg(y + rr), s);
  }
  red[warp][threadIdx.x & 31] = s;
  __syncthreads();
  if (warp == 0) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[w][threadIdx.x];
    out[g * kB3 + c] = v;
  }
}

// ---- P3 ----
__device__ __forceinline__ void split3(float a, float* p) {
  const uint32_t mask = 0xFFFF0000u;
  const float a0 = __uint_as_float(__float_as_uint(a) & mask);
  const float r = a - a0;
  const float a1 = __uint_as_float(__float_as_uint(r) & mask);
  p[0] = a0;
  p[1] = a1;
  p[2] = r - a1;
}

// a warp per 16 x 32 tile of out [M, N]; x [M, K], s [K, N] (K % 16 == 0,
// N % 32 == 0)
__global__ void __launch_bounds__(kThreads)
    p3_kernel(const float* __restrict__ x, const float* __restrict__ s,
              float* __restrict__ out, int M, int K, int N) {
  const int lane = threadIdx.x & 31;
  const int wt = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int ntn = N / 32, ntm = (M + 15) / 16;
  if (wt >= ntm * ntn) return;
  const int m0 = (wt / ntn) * 16, n0 = (wt % ntn) * 32;
  const int g = lane >> 2, q = lane & 3;
  float d[4][4] = {};
  auto xat = [&](int m, int k, float* p3) {
    if (m < M) split3(__ldg(x + (size_t)m * K + k), p3);
    else p3[0] = p3[1] = p3[2] = 0.f;
  };
  for (int k0 = 0; k0 < K; k0 += 16) {
    // the A fragments of the three parts: rows g, g + 8; columns 2q, 2q+1,
    // 2q+8, 2q+9 of this k-slab
    float v[4][2][3];  // [rows g / g+8 x cols lo / hi][pair][part]
    const int ks[4] = {k0 + 2 * q, k0 + 2 * q, k0 + 2 * q + 8, k0 + 2 * q + 8};
    const int ms[4] = {m0 + g, m0 + g + 8, m0 + g, m0 + g + 8};
    for (int e = 0; e < 4; ++e) {
      xat(ms[e], ks[e], v[e][0]);
      xat(ms[e], ks[e] + 1, v[e][1]);
    }
    uint32_t bf[4][2];
    for (int nc = 0; nc < 4; ++nc) {
      const int n = n0 + nc * 8 + g;
      const int kk = k0 + 2 * q;
      bf[nc][0] = probe::pack_bf16(__ldg(s + (size_t)kk * N + n),
                                   __ldg(s + (size_t)(kk + 1) * N + n));
      bf[nc][1] = probe::pack_bf16(__ldg(s + (size_t)(kk + 8) * N + n),
                                   __ldg(s + (size_t)(kk + 9) * N + n));
    }
    for (int part = 0; part < 3; ++part) {
      uint32_t a[4];
      for (int e = 0; e < 4; ++e)
        a[e] = probe::pack_bf16(v[e][0][part], v[e][1][part]);
      for (int nc = 0; nc < 4; ++nc) probe::mma_bf16_16816(d[nc], a, bf[nc]);
    }
  }
  for (int nc = 0; nc < 4; ++nc) {
    const int n = n0 + nc * 8 + 2 * q;
    if (m0 + g < M) {
      out[(size_t)(m0 + g) * N + n] = d[nc][0];
      out[(size_t)(m0 + g) * N + n + 1] = d[nc][1];
    }
    if (m0 + g + 8 < M) {
      out[(size_t)(m0 + g + 8) * N + n] = d[nc][2];
      out[(size_t)(m0 + g + 8) * N + n + 1] = d[nc][3];
    }
  }
}

// ---- P4: 24 cooperative blocks, block j owns columns [8j, 8j + 8) ----
struct P4Params {
  const float* d;   // [Mi, 3, 3, 192, 192] the rung
  const float* ho;  // [3, 3]
  const float* b;   // [Mi, 3, 192]
  float* t;         // [Mi, 3, 192] scratch
  float* x;         // [Mi, 3, 192] out
  int Mi, inner;
};

__global__ void __launch_bounds__(kThreads) p4_kernel(const P4Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float v[kPhi * kB3];
  __shared__ float red[32][kPhi][8];
  __shared__ float res[kPhi][8];
  __shared__ float ho[kPhi][kPhi];
  const int col = threadIdx.x & 7, rp = threadIdx.x >> 3;
  const int c0 = blockIdx.x * 8;
  const int n = kPhi * kB3;
  if (threadIdx.x < kPhi * kPhi) ho[threadIdx.x / kPhi][threadIdx.x % kPhi] =
      p.ho[threadIdx.x];
  __syncthreads();

  // res[g][col] = D(k) v [g, c0 + col]
  auto dapply = [&](int k) {
    float acc[kPhi] = {0.f, 0.f, 0.f};
    for (int rr = rp; rr < n; rr += 32) {
      const int f = rr / kB3, bb = rr - f * kB3;
      const float vr = v[rr];
      for (int g = 0; g < kPhi; ++g)
        acc[g] = fmaf(__ldg(p.d + ((((size_t)k * kPhi + f) * kPhi + g) * kB3 +
                                   bb) * kB3 + c0 + col),
                      vr, acc[g]);
    }
    for (int g = 0; g < kPhi; ++g) red[rp][g][col] = acc[g];
    __syncthreads();
    if (threadIdx.x < kPhi * 8) {
      const int g = threadIdx.x >> 3, cc = threadIdx.x & 7;
      float s = 0.f;
      for (int r = 0; r < 32; ++r) s += red[r][g][cc];
      res[g][cc] = s;
    }
    __syncthreads();
  };

  const int Mi = p.Mi;
  const int gg = threadIdx.x >> 3, cc = threadIdx.x & 7;  // < 24: (g, col)
  const size_t row = kPhi * kB3;
  for (int it = 0; it < p.inner; ++it) {
    // ---- forward ----
    for (int k = 1; k < Mi; ++k) {
      const float* src = k == 1 ? p.b : p.x + (size_t)(k - 1) * row;
      for (int i = threadIdx.x; i < n; i += kThreads) v[i] = __ldcg(src + i);
      __syncthreads();
      dapply(k - 1);
      if (threadIdx.x < kPhi * 8) {
        const int c = c0 + cc;
        p.t[(size_t)(k - 1) * row + gg * kB3 + c] = res[gg][cc];
        float s = 0.f;
        for (int f = 0; f < kPhi; ++f) s = fmaf(ho[f][gg], res[f][cc], s);
        // y_k lives in x's row k until the back substitution overwrites it
        p.x[(size_t)k * row + gg * kB3 + c] =
            p.b[(size_t)k * row + gg * kB3 + c] - s;
      }
      grid.sync();
    }
    // ---- x_{Mi-1} = D(Mi-1) y_{Mi-1} ----
    {
      const float* src = Mi == 1 ? p.b : p.x + (size_t)(Mi - 1) * row;
      for (int i = threadIdx.x; i < n; i += kThreads) v[i] = __ldcg(src + i);
      __syncthreads();
      dapply(Mi - 1);
      if (threadIdx.x < kPhi * 8)
        p.x[(size_t)(Mi - 1) * row + gg * kB3 + c0 + cc] = res[gg][cc];
      grid.sync();
    }
    // ---- back substitution ----
    for (int k = Mi - 2; k >= 0; --k) {
      const float* xn = p.x + (size_t)(k + 1) * row;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int f = i / kB3, bb = i - f * kB3;
        float s = 0.f;
        for (int g = 0; g < kPhi; ++g)
          s = fmaf(ho[f][g], __ldcg(xn + g * kB3 + bb), s);
        v[i] = s;
      }
      __syncthreads();
      dapply(k);
      if (threadIdx.x < kPhi * 8) {
        const size_t e = (size_t)k * row + gg * kB3 + c0 + cc;
        p.x[e] = p.t[e] - res[gg][cc];
      }
      grid.sync();
    }
  }
}

int finish(cudaError_t e) {
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a cudaError_t
// (0 = launched).

// P1: out [108, 192] from x [216, 192].
int nsfused_probe_p1(void* x, void* out, void* stream) {
  p1_kernel<<<(108 * kB3 + kThreads - 1) / kThreads, kThreads, 0,
              (cudaStream_t)stream>>>((const float*)x, (float*)out);
  return finish(cudaSuccess);
}

// P2: out [3, 192] = the apply of d [3, 3, 192, 192] (D6[r, 3]) to y [3, 192].
int nsfused_probe_p2(void* d, void* y, void* out, void* stream) {
  p2_kernel<<<dim3(kPhi, kB3 / 32), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)y, (float*)out);
  return finish(cudaSuccess);
}

// P3: out [M, N] = x [M, K] @ s [K, N] through three bf16 parts of x
// (K % 16 == 0, N % 32 == 0; s exact in bf16).
int nsfused_probe_p3(void* x, void* s, void* out, int M, int K, int N,
                     void* stream) {
  if (M < 1 || K < 16 || K % 16 || N < 32 || N % 32)
    return (int)cudaErrorInvalidValue;
  const int tiles = ((M + 15) / 16) * (N / 32);
  const int per_block = kThreads / 32;
  p3_kernel<<<(tiles + per_block - 1) / per_block, kThreads, 0,
              (cudaStream_t)stream>>>((const float*)x, (const float*)s,
                                      (float*)out, M, K, N);
  return finish(cudaSuccess);
}

// P4: `inner` iterations of both sweeps: d [Mi, 3, 3, 192, 192] (the rung),
// ho [3, 3], b [Mi, 3, 192]; scratch t [Mi, 3, 192]; x [Mi, 3, 192] out.
int nsfused_probe_p4(void* d, void* ho, void* b, void* t, void* x, int Mi,
                     int inner, void* stream) {
  if (Mi < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  P4Params p;
  p.d = (const float*)d;
  p.ho = (const float*)ho;
  p.b = (const float*)b;
  p.t = (float*)t;
  p.x = (float*)x;
  p.Mi = Mi;
  p.inner = inner;
  void* args[] = {&p};
  return finish(cudaLaunchCooperativeKernel((const void*)p4_kernel,
                                            dim3(kB3 / 8), dim3(kThreads),
                                            args, 0, (cudaStream_t)stream));
}

const char* nsfused_probe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
