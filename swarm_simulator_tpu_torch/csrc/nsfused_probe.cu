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
//       float32 on the tensor cores (mma.sync m16n8k16 bf16 -> f32), s
//       exact in bf16
//   P4  `inner` iterations of the tile-form Thomas sweeps in one launch:
//       t_{k-1} = D(k-1) y_{k-1}, y_k = b_k - hoT(t_{k-1}) (y_0 = b_0);
//       x_{Mi-1} = D(Mi-1) y_{Mi-1}; x_k = t_k - D(k) ho_(x_{k+1}), with
//       D(k) v [g, c] = sum_f sum_b D6[0, k, f, g, b, c] v[f, b],
//       hoT(t)[g] = sum_f ho[f, g] t[f], ho_(v)[f] = sum_g ho[f, g] v[g]
//
// What bounds them on an H100: P1 moves 0.25 MB and P2 reads 1.3 MB, both
// launch-bound at these sizes.  P3 does 0.51 GFLOP (three bf16 passes) on
// 3.5 MB moved once (x 0.17 MB, s 1.57 MB, out 1.77 MB): 1.05 us at the
// HBM rate, 0.5 us at the bf16 tensor-core rate, so the launch and a
// block's serial phases set its time: 10.4-10.9 us on an H100 80GB HBM3
// at 700 W, of which a launch of the same grid and shared memory with
// the tile's store takes 5.3-5.8 and the panels' copy, the split and the
// products ~1.8 each (PERF.md).  P4's 46.4 MB rung fits the 50 MB L2
// but not the 132 SMs' 29.97 MB of shared memory, and each iteration is a
// chain of 69 dependent applies of 1.33 MB each.
//
// What the design does about it: P1 one thread per output; P2 a block per
// (g, 32 columns), eight warps splitting the 576 rows (f, b), partial sums
// added in warp order in shared memory.  P3 one block per 64 x 64 output
// tile (4 x 32 = 128 blocks at 216 x 2048, one wave on 132 SMs; the M edge
// masked): the block copies its x rows [64, 192] and s columns [192, 64]
// into shared memory at once (16-byte cp.async, all in flight), splits
// each x element once into three bf16 planes and rounds s to bf16 there,
// then each of eight warps takes a 16 x 32 part of the tile with
// mma.sync m16n8k16 on fragments read by ldmatrix (rows padded by 16
// bytes, so a read hits no bank twice), and the tile leaves through
// shared memory in 16-byte row stores.  (The first design, a warp per
// 16 x 32 tile loading every fragment from device memory, read x 64
// times and s 14 times and lost to torch.matmul, PERF.md.)  P4 "resident"
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

// one block per kP3Tile x kP3Tile tile of out [M, N]; x [M, K], s [K, N]
// (K % 16 == 0, N % kP3Tile == 0; rows of x past M read as zeros).
// Dynamic shared memory, in bytes (p3_smem, ops/nsfused_probe.p3_plan):
//   stage  max(512 K, out tile): the block's x rows [64, K] and s columns
//          [K, 64] as float32, copied in with cp.async; then the out tile
//          [64, kP3OutLd] float32
//   xs     [3][64][K + kP3Pad] bf16: the three parts of x's rows
//   ss     [K][64 + kP3Pad] bf16: s's columns
constexpr int kP3Tile = 64;
constexpr int kP3Pad = 8;     // bf16 a row is padded by: ldmatrix's eight
                              // 16-byte row reads fall in distinct banks
constexpr int kP3OutLd = kP3Tile + 8;

__host__ __device__ inline size_t p3_stage_bytes(int K) {
  const size_t panels = (size_t)2 * kP3Tile * K * sizeof(float);
  const size_t out = (size_t)kP3Tile * kP3OutLd * sizeof(float);
  return panels > out ? panels : out;
}

__host__ __device__ inline size_t p3_smem(int K) {
  return p3_stage_bytes(K) +
         2 * ((size_t)3 * kP3Tile * (K + kP3Pad) +
              (size_t)K * (kP3Tile + kP3Pad));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   probe::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, row addresses from lanes
// 8i..8i+7 for matrix i (.trans: each transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(probe::smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(probe::smem_addr(p))
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
    p3_kernel(const float* __restrict__ x, const float* __restrict__ s,
              float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kP3Tile, n0 = blockIdx.x * kP3Tile;
  const int ldx = K + kP3Pad, lds = kP3Tile + kP3Pad;
  float* xf = reinterpret_cast<float*>(smem);  // [64, K]
  float* sf = xf + kP3Tile * K;                // [K, 64]
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + p3_stage_bytes(K));
  __nv_bfloat16* ss = xs + 3 * kP3Tile * ldx;

  // ---- both panels in flight at once, 16 bytes a copy ----
  const int kq = K / 4;  // float4s of an x row
#pragma unroll 4
  for (int e = tid; e < kP3Tile * kq; e += kThreads) {
    const int r = e / kq, c = (e - r * kq) * 4;
    const bool in = m0 + r < M;
    cp_async16(xf + r * K + c, x + (size_t)(in ? m0 + r : 0) * K + c, in);
  }
#pragma unroll 4
  for (int e = tid; e < K * (kP3Tile / 4); e += kThreads) {
    const int k = e / (kP3Tile / 4), c = (e % (kP3Tile / 4)) * 4;
    cp_async16(sf + k * kP3Tile + c, s + (size_t)k * N + n0 + c, true);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
  __syncthreads();

  // ---- each element of x split once into three bf16 planes, s rounded
  // to bf16 (exact for the probe's s) ----
#pragma unroll 4
  for (int e = tid; e < kP3Tile * kq; e += kThreads) {
    const int r = e / kq, c = (e - r * kq) * 4;
    const float4 v = *reinterpret_cast<const float4*>(xf + r * K + c);
    float p[4][3];
    split3(v.x, p[0]);
    split3(v.y, p[1]);
    split3(v.z, p[2]);
    split3(v.w, p[3]);
    for (int part = 0; part < 3; ++part)
      *reinterpret_cast<uint2*>(xs + (part * kP3Tile + r) * ldx + c) =
          make_uint2(probe::pack_bf16(p[0][part], p[1][part]),
                     probe::pack_bf16(p[2][part], p[3][part]));
  }
#pragma unroll 4
  for (int e = tid; e < K * (kP3Tile / 4); e += kThreads) {
    const int k = e / (kP3Tile / 4), c = (e % (kP3Tile / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(sf + k * kP3Tile + c);
    *reinterpret_cast<uint2*>(ss + k * lds + c) = make_uint2(
        probe::pack_bf16(v.x, v.y), probe::pack_bf16(v.z, v.w));
  }
  __syncthreads();

  // ---- warp w: rows 16 (w % 4) .. +16, columns 32 (w / 4) .. +32 ----
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  float d[4][4] = {};
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t bf[4][2];  // B fragments of the four 8-column slabs
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4];
      ldsm_x4_trans(r, ss + (k0 + (lane & 15)) * lds + wn + h * 16 +
                           8 * (lane >> 4));
      bf[2 * h][0] = r[0];
      bf[2 * h][1] = r[1];
      bf[2 * h + 1][0] = r[2];
      bf[2 * h + 1][1] = r[3];
    }
    for (int part = 0; part < 3; ++part) {
      uint32_t a[4];
      ldsm_x4(a, xs + (part * kP3Tile + wm + (lane & 15)) * ldx + k0 +
                     8 * (lane >> 4));
      for (int nc = 0; nc < 4; ++nc) probe::mma_bf16_16816(d[nc], a, bf[nc]);
    }
  }

  // ---- the out tile through shared memory (the float32 panels are read
  // no more), then 16-byte stores of whole rows ----
  float* ot = xf;  // [64, kP3OutLd]
  const int g = lane >> 2, q = lane & 3;
  for (int nc = 0; nc < 4; ++nc) {
    const int c = wn + nc * 8 + 2 * q;
    *reinterpret_cast<float2*>(ot + (wm + g) * kP3OutLd + c) =
        make_float2(d[nc][0], d[nc][1]);
    *reinterpret_cast<float2*>(ot + (wm + g + 8) * kP3OutLd + c) =
        make_float2(d[nc][2], d[nc][3]);
  }
  __syncthreads();
  for (int e = tid; e < kP3Tile * (kP3Tile / 4); e += kThreads) {
    const int r = e / (kP3Tile / 4), c = (e % (kP3Tile / 4)) * 4;
    if (m0 + r < M)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const float4*>(ot + r * kP3OutLd + c);
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
// (K % 16 == 0, N % 64 == 0, p3_smem(K) within a block's 227 KB; s exact
// in bf16; x, s and out 16-byte aligned): one block per 64 x 64 tile.
int nsfused_probe_p3(void* x, void* s, void* out, int M, int K, int N,
                     void* stream) {
  if (M < 1 || K < 16 || K % 16 || N < kP3Tile || N % kP3Tile ||
      ((uintptr_t)x | (uintptr_t)s | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = p3_smem(K);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)p3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  p3_kernel<<<dim3(N / kP3Tile, (M + kP3Tile - 1) / kP3Tile), kThreads, smem,
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
