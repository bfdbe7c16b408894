// T4, the pivot-stream study for Hopper (sm_90a): a kernel that does
// nothing but stream one rung of the Thomas pivot inventory from device
// memory, the ceiling of what K2's sweeps can read.  It replaces the
// Pallas TPU kernel of the JAX package's tools/thomas_bw_study.py
// (make_dma_kernel), which computes
//   out[c] = sum_k sum_rows dinvs[r, k, row, c]
// over the rung's Mi pivot blocks [bs, bs] with a 2- or 4-slot ring of
// asynchronous copies, each block copied whole or as two halves on
// separate semaphores (the dma2 / dma4 / dma2split / dma4split variants).
//
// What bounds it on an H100: bytes.  At 256 agents (Mi = 71, bs = 2304)
// a rung is 1.508 GB in float32 (0.450 ms at 3.35 TB/s) and 0.754 GB in
// bf16; one add per element is ~0.2 GFLOP, nothing.
//
// What the design does about it: a persistent grid (as many blocks as can
// be resident, each walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// so the grid moves through the rung together).  A tile is a run of whole
// rows, contiguous in memory; one thread of each block keeps SLOTS tiles
// in flight with 1-D TMA bulk copies (cp.async.bulk) that complete on an
// mbarrier per slot, or, split, two half-tile copies on two mbarriers.
// The block's threads own columns (c = threadIdx.x + j * blockDim.x),
// wait on the slot's barrier(s), add the tile's rows of their columns in
// order into a shared-memory accumulator, and hand the slot back (block
// barrier) before the next copy is issued into it.  Each block then
// writes its partial sums [bs]; a second kernel adds the partials in block
// order.  The result is deterministic for a given grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of transactions to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D TMA: `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dynamic shared memory: [2 * SLOTS mbarriers][SLOTS tiles][bs floats]
template <typename T, int SLOTS, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const T* __restrict__ rung, long long nrows, int bs,
                  int tile_rows, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* tiles = reinterpret_cast<T*>(smem + 16 * SLOTS);
  const size_t tile_elems = (size_t)tile_rows * bs;
  float* acc = reinterpret_cast<float*>(tiles + SLOTS * tile_elems);

  const long long ntiles = (nrows + tile_rows - 1) / tile_rows;
  const long long mine =
      blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  for (int c = threadIdx.x; c < bs; c += blockDim.x) acc[c] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * SLOTS; ++s) mbar_init(&bars[s], 1);
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto rows_of = [&](long long i) -> int {
    const long long r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const long long left = nrows - r0;
    return left < tile_rows ? (int)left : tile_rows;
  };
  // thread 0 only: the copy of this block's i-th tile into slot i % SLOTS
  auto issue = [&](long long i) {
    const int s = (int)(i % SLOTS);
    const long long r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const uint32_t bytes = (uint32_t)((size_t)rows_of(i) * bs * sizeof(T));
    const char* src = reinterpret_cast<const char*>(rung + r0 * bs);
    char* dst = reinterpret_cast<char*>(tiles + s * tile_elems);
    // the slot's previous contents were read through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (SPLIT) {
      const uint32_t h = (bytes / 2) & ~15u;
      mbar_expect_tx(&bars[2 * s], h);
      bulk_copy(dst, src, h, &bars[2 * s]);
      mbar_expect_tx(&bars[2 * s + 1], bytes - h);
      bulk_copy(dst + h, src + h, bytes - h, &bars[2 * s + 1]);
    } else {
      mbar_expect_tx(&bars[2 * s], bytes);
      bulk_copy(dst, src, bytes, &bars[2 * s]);
    }
  };

  if (threadIdx.x == 0)
    for (long long i = 0; i < SLOTS && i < mine; ++i) issue(i);

  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % SLOTS);
    const uint32_t parity = (uint32_t)((i / SLOTS) & 1);
    mbar_wait(&bars[2 * s], parity);
    if (SPLIT) mbar_wait(&bars[2 * s + 1], parity);
    const int rows = rows_of(i);
    const T* tile = tiles + s * tile_elems;
    for (int c = threadIdx.x; c < bs; c += blockDim.x) {
      float v = 0.f;
      for (int r = 0; r < rows; ++r) v += widen(tile[(size_t)r * bs + c]);
      acc[c] += v;
    }
    __syncthreads();  // every thread is done with slot s
    if (threadIdx.x == 0 && i + SLOTS < mine) issue(i + SLOTS);
  }
  // each thread wrote only its own columns of acc
  for (int c = threadIdx.x; c < bs; c += blockDim.x)
    partial[(size_t)blockIdx.x * bs + c] = acc[c];
}

// out[c] = sum over blocks b (in order) of partial[b, c]
__global__ void reduce_partials(const float* __restrict__ partial,
                                int nblocks, int bs, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= bs) return;
  float v = 0.f;
  for (int b = 0; b < nblocks; ++b) v += partial[(size_t)b * bs + c];
  out[c] = v;
}

size_t smem_bytes(int slots, int elt, int bs, int tile_rows) {
  return (size_t)16 * slots + (size_t)slots * tile_rows * bs * elt +
         (size_t)bs * sizeof(float);
}

template <typename T, int SLOTS, bool SPLIT>
const void* kernel_of() {
  return (const void*)stream_kernel<T, SLOTS, SPLIT>;
}

// the kernel for (element size, slots, split), or nullptr
const void* pick(int elt, int slots, int split) {
  if (elt == 4) {
    if (slots == 2) return split ? kernel_of<float, 2, true>()
                                 : kernel_of<float, 2, false>();
    if (slots == 4) return split ? kernel_of<float, 4, true>()
                                 : kernel_of<float, 4, false>();
  } else if (elt == 2) {
    if (slots == 2) return split ? kernel_of<__nv_bfloat16, 2, true>()
                                 : kernel_of<__nv_bfloat16, 2, false>();
    if (slots == 4) return split ? kernel_of<__nv_bfloat16, 4, true>()
                                 : kernel_of<__nv_bfloat16, 4, false>();
  }
  return nullptr;
}

// the persistent grid: as many blocks as can be resident at once, or an
// error code (negative)
int grid_for(const void* kernel, size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  return 0;
}

}  // namespace

extern "C" {

// The number of blocks (the rows of `partial`) that thomas_stream launches
// for this variant, through `grid`; returns a cudaError_t (0 = ok).
// elt: 4 (float32 pivots) or 2 (bf16); slots: 2 or 4; split: 0 or 1.
int thomas_stream_grid(int elt, int slots, int split, int bs, int tile_rows,
                       int* grid) {
  const void* k = pick(elt, slots, split);
  if (k == nullptr || bs < 1 || tile_rows < 1)
    return (int)cudaErrorInvalidValue;
  return grid_for(k, smem_bytes(slots, elt, bs, tile_rows), grid);
}

// out [bs] = the sum of every row of `rung` ([nrows, bs], 16-byte aligned,
// each row a multiple of 32 bytes), on `stream`; `partial` is
// [grid, bs] float32 scratch with grid from thomas_stream_grid.  Returns
// a cudaError_t (0 = launched).
int thomas_stream(void* rung, long long nrows, int bs, int elt, int slots,
                  int split, int tile_rows, int grid, void* partial,
                  void* out, void* stream) {
  const void* k = pick(elt, slots, split);
  if (k == nullptr || nrows < 1 || bs < 1 || tile_rows < 1 || grid < 1 ||
      ((size_t)bs * elt) % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(slots, elt, bs, tile_rows);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)partial;
  void* args[] = {&rung, &nrows, &bs, &tile_rows, &part};
  e = cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<(bs + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)partial, grid, bs, (float*)out);
  return (int)cudaGetLastError();
}

const char* thomas_stream_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
