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
// chain of 69 dependent applies of 1.33 MB each: the latency of a chain
// stage sets its time, as K2's (csrc/thomas.cu).
//
// What the design does about it: P1 one thread per output.  P2 one
// thread-block cluster per 16 output columns (all three g; ops/
// nsfused_probe.p2_plan: 12 clusters of 8 blocks at B3 = 192), the blocks
// splitting the 576 rows (f, b): each of a block's 96 threads loads its
// 16-byte row segments all at once (9 at 72 rows a block), so a block
// waits one memory round trip, not a chain of dependent loads; the eight
// lanes of a (g, 4 columns) add in registers, and each block stores its
// partial tile into the cluster leader's shared memory (distributed shared
// memory), which adds them in rank order after one cluster barrier
// (deterministic, no atomics, nothing through device memory).  (The first
// design, a block per (g, 32 columns) on 18 SMs, walked 72 dependent loads
// a thread.)  P3 one block per 64 x 64 output
// tile (4 x 32 = 128 blocks at 216 x 2048, one wave on 132 SMs; the M edge
// masked): the block copies its x rows [64, 192] and s columns [192, 64]
// into shared memory at once (16-byte cp.async, all in flight), splits
// each x element once into three bf16 planes and rounds s to bf16 there,
// then each of eight warps takes a 16 x 32 part of the tile with
// mma.sync m16n8k16 on fragments read by ldmatrix (rows padded by 16
// bytes, so a read hits no bank twice), and the tile leaves through
// shared memory in 16-byte row stores.  (The first design, a warp per
// 16 x 32 tile loading every fragment from device memory, read x 64
// times and s 14 times and lost to torch.matmul, PERF.md.)  P4 is K2's
// chain with P4's back substitution: through the permutation
// row (c, g) -> 3c + g, column (b, f) -> 3b + f, the tile-form apply
// D(k) v is the flat [576, 576] block M_k[3c + g, 3b + f] =
// D6[r, k, f, g, b, c] against v in the same order, hoT and ho_ are
// K2's (I (x) ho)^T and (I (x) ho) on groups of 3, and the back form is
// x_k = t_k - M_k (I (x) ho) x_{k+1}.  So P4 is two launches: the
// re-layout (the TPU kernel's copy of the rung into VMEM), a tiled
// transpose through shared memory that reads and writes the rung once
// (32 c x 32 b x 3 f a block, coalesced on c in and on (b, f) out, the
// source read under evict-first so the flat rung stays in L2), then all
// `inner` iterations in one launch of the template csrc/thomas_chain.cuh
// (kTForm): 96 chain blocks of 2 row groups on the chain ring, the
// vector in stage-tagged entries with no grid sync between stages or
// iterations, each block's T rows in shared memory, and optionally its
// rows of the last few knots (ops/nsfused_probe.p4_plan).  (The first
// design, 24 cooperative blocks of 8 columns, synced the grid after each
// of the 3450 stages and reloaded the vector from device memory: 5.74 us
// a stage.)
#include "thomas_chain.cuh"

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

// ---- P2: a cluster per kP2Cols output columns, kP2Threads a block ----
constexpr int kP2Cols = 16;                  // ops/nsfused_probe.P2_COLS
constexpr int kP2Quads = kP2Cols / 4;        // float4 columns of a tile
constexpr int kP2Lanes = 8;                  // threads of one (g, quad)
constexpr int kP2Steps = 12;                 // rows a lane at most
constexpr int kP2Threads = kPhi * kP2Quads * kP2Lanes;  // 96
constexpr int kP2MaxCluster = 8;             // the portable cluster size

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// block `rank` of cluster `tile` sums rows [rank * rows, +rows) of the
// 576 (f, b) for columns [tile * kP2Cols, +kP2Cols) of all three g; thread
// (q, l) takes quad q = g * kP2Quads + column quad, rows l, l + 8, ...
__global__ void __launch_bounds__(kP2Threads)
    p2_kernel(const float* __restrict__ d, const float* __restrict__ y,
              float* __restrict__ out, int cluster, int rows) {
  __shared__ float4 part[kP2MaxCluster][kPhi * kP2Quads];  // the leader's
  // the cluster's blocks must all have started before one writes into
  // another's shared memory: arrive now, wait once the loads are in
  cluster_arrive_relaxed();
  const int rank = blockIdx.x % cluster, tile = blockIdx.x / cluster;
  const int q = threadIdx.x / kP2Lanes, l = threadIdx.x % kP2Lanes;
  const int g = q / kP2Quads, c = tile * kP2Cols + (q % kP2Quads) * 4;
  const int r0 = rank * rows, r1 = min(r0 + rows, kPhi * kB3);
  float4 v[kP2Steps];
  float w[kP2Steps];
#pragma unroll
  for (int u = 0; u < kP2Steps; ++u) {  // every load in flight at once
    const int j = r0 + l + u * kP2Lanes;
    if (j < r1) {
      const int f = j / kB3, bb = j - f * kB3;
      v[u] = __ldg(reinterpret_cast<const float4*>(
          d + ((size_t)(f * kPhi + g) * kB3 + bb) * kB3 + c));
      w[u] = __ldg(y + j);
    } else {
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      w[u] = 0.f;
    }
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < kP2Steps; ++u) {
    acc.x = fmaf(v[u].x, w[u], acc.x);
    acc.y = fmaf(v[u].y, w[u], acc.y);
    acc.z = fmaf(v[u].z, w[u], acc.z);
    acc.w = fmaf(v[u].w, w[u], acc.w);
  }
  // the kP2Lanes lanes of a quad are neighbours in one warp
  for (int off = kP2Lanes / 2; off > 0; off >>= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  cluster_wait();
  cg::cluster_group cl = cg::this_cluster();
  if (l == 0) *cl.map_shared_rank(&part[rank][q], 0) = acc;
  cl.sync();  // every partial has landed in the leader's slots
  if (rank == 0 && threadIdx.x < kPhi * kP2Quads) {
    const int qq = threadIdx.x;
    float4 s = part[0][qq];
    for (int r = 1; r < cluster; ++r) {  // in rank order
      const float4 o = part[r][qq];
      s.x += o.x;
      s.y += o.y;
      s.z += o.z;
      s.w += o.w;
    }
    *reinterpret_cast<float4*>(out + (qq / kP2Quads) * kB3 + tile * kP2Cols +
                               (qq % kP2Quads) * 4) = s;
  }
}

// an empty kernel: the launch floor of a grid (tools/chain_bench --floor)
__global__ void floor_kernel() {}

// launch `kernel` over `blocks` blocks of `threads` in clusters of
// `cluster` blocks (1: no cluster) on `stream`
template <typename... Args>
cudaError_t launch_clustered(void (*kernel)(Args...), int blocks,
                             int threads, int cluster, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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

// ---- P4: the re-layout, then the chain (csrc/thomas_chain.cuh) ----
constexpr int kRelTile = 32;  // c and b a re-layout block takes

// m [Mi, 576, 576] from the rung d [Mi, 3 f, 3 g, 192 b, 192 c]:
// m[k, 3c + g, 3b + f] = d[k, f, g, b, c].  Block (b tile, c tile, 3k + g)
// reads 3 f x 32 b rows of 32 c (128 bytes each) and writes 32 rows
// (c, g) of 96 (b, f), through a tile padded to 97 floats a row (the
// reads down a column and along a row each hit 32 banks)
__global__ void __launch_bounds__(kThreads)
    p4_relayout_kernel(const float* __restrict__ d, float* __restrict__ m) {
  __shared__ float tile[kRelTile][kPhi * kRelTile + 1];
  const int b0 = blockIdx.x * kRelTile, c0 = blockIdx.y * kRelTile;
  const int k = blockIdx.z / kPhi, g = blockIdx.z - kPhi * k;
  const int n = kPhi * kB3;
  for (int e = threadIdx.x; e < kPhi * kRelTile * kRelTile; e += kThreads) {
    const int cl = e % kRelTile, bl = (e / kRelTile) % kRelTile;
    const int f = e / (kRelTile * kRelTile);
    tile[cl][bl * kPhi + f] = __ldcs(
        d + (((size_t)(k * kPhi + f) * kPhi + g) * kB3 + b0 + bl) * kB3 + c0 +
        cl);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRelTile * kPhi * kRelTile; e += kThreads) {
    const int j = e % (kPhi * kRelTile), cl = e / (kPhi * kRelTile);
    m[((size_t)k * n + (size_t)(c0 + cl) * kPhi + g) * n + kPhi * b0 + j] =
        tile[cl][j];
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

// P2: out [3, 192] = the apply of d [3, 3, 192, 192] (D6[r, 3]) to y [3, 192]
// (d and out 16-byte aligned): ops/nsfused_probe.p2_plan's clusters of
// `cluster` blocks, `rows` of the 576 (f, b) a block.
int nsfused_probe_p2(void* d, void* y, void* out, int cluster, int rows,
                     void* stream) {
  if (cluster < 1 || cluster > kP2MaxCluster || rows < 1 ||
      rows > kP2Lanes * kP2Steps || cluster * rows < kPhi * kB3 ||
      ((uintptr_t)d | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  return finish(launch_clustered(
      p2_kernel, cluster * (kB3 / kP2Cols), kP2Threads, cluster,
      (cudaStream_t)stream, (const float*)d, (const float*)y, (float*)out,
      cluster, rows));
}

// an empty kernel over `blocks` blocks of `threads` in clusters of
// `cluster` (blocks a multiple of it)
int nsfused_probe_floor(int blocks, int threads, int cluster, void* stream) {
  if (blocks < 1 || threads < 1 || cluster < 1 ||
      cluster > kP2MaxCluster || blocks % cluster)
    return (int)cudaErrorInvalidValue;
  return finish(launch_clustered(floor_kernel, blocks, threads, cluster,
                                 (cudaStream_t)stream));
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

// P4's re-layout: m [Mi, 576, 576] from the rung d [Mi, 3, 3, 192, 192].
int nsfused_probe_p4_relayout(void* d, void* m, int Mi, void* stream) {
  if (Mi < 1) return (int)cudaErrorInvalidValue;
  p4_relayout_kernel<<<dim3(kB3 / kRelTile, kB3 / kRelTile, Mi * kPhi),
                       kThreads, 0, (cudaStream_t)stream>>>((const float*)d,
                                                            (float*)m);
  return finish(cudaSuccess);
}

// P4's chain: `inner` iterations of both sweeps over the re-laid rung
// m [Mi, 576, 576] with ho [3, 3] at every knot, from b [Mi, 576] (rows
// 3c + g) into x [Mi, 576]; vbuf [3, 576] 64-bit scratch; gpb,
// tile_rows, nslots, resident and smem the plan of
// ops/nsfused_probe.p4_plan.
int nsfused_probe_p4(void* m, void* ho, void* b, void* vbuf, void* x, int Mi,
                     int inner, int gpb, int tile_rows, int nslots,
                     int resident, int smem, void* stream) {
  chain::SolveParams<float> p;
  p.dinv = (const float*)m;
  p.ho = (const float*)ho;
  p.b = (const float*)b;
  p.vbuf = (unsigned long long*)vbuf;
  p.x = (float*)x;
  p.B3 = kB3;
  p.Mi = Mi;
  p.phi = kPhi;
  p.gpb = gpb;
  p.tile_rows = tile_rows;
  p.nslots = nslots;
  p.ho_stride = 0;
  p.nperiod = inner;
  p.resident = resident;
  return chain::launch_solve<float, true, true>(p, smem, (cudaStream_t)stream);
}

const char* nsfused_probe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
