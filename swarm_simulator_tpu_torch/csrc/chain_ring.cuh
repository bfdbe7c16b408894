// The Thomas chain's row stream and vector exchange, shared by K1
// (csrc/nsfused.cu), K2, K3a and K3b (csrc/thomas.cu), T1's P4 (with K2
// through csrc/thomas_chain.cuh), the staged probe T3
// (csrc/thomas_probe.cu) and the chain-primitive bench T2
// (csrc/thomas_prim.cu) on Hopper (sm_90a).
//
// A chain of dependent stages runs on `ncb` chain blocks; each stage
// reads one knot's pivot block, in an order the kernel names (Order):
// K1, K2 and P4 run 2*Mi - 1 stages, the forward sweep over knots
// 0..Mi-1 and the back substitution over Mi-2..0; K3a one chunk's knots
// forward, K3b backward.
// Chain block c owns the row groups [c*gpb, (c+1)*gpb) (gpb*phi rows) of
// every knot's pivot block, so its rows of one knot are one contiguous
// byte span.  The pivot rows of a stage do not depend on the chain, only
// the vector does: each block streams its spans through a ring of
// `nslots` shared-memory slots, tiles of `tile_rows` rows, filled by 1-D
// TMA bulk copies (cp.async.bulk on an mbarrier per slot), and issues a
// tile as soon as its slot is consumed, so the copies of later stages
// are in flight while the block waits for the vector and takes the dot.
// The stream of tiles is periodic, `nstage` stages a period: K1 runs it
// once per ADMM iteration, P4 once per iteration, T2 once per repetition
// (the forward order repeated: step s reads knot s mod Mi).
//
// TMA needs 16-byte aligned addresses and sizes.  A block's span starts
// on a 16-byte boundary only when a row is a multiple of 16 bytes
// (bs % 4 == 0 in float32, bs % 8 == 0 in bf16): otherwise the copy
// moves the aligned middle of the span and the block's threads load the
// ragged head and tail (fewer than 16 bytes each) themselves before
// waiting on the slot.  A slot holds the span at the offset its address
// has within 16 bytes, so a row's elements keep their index.
//
// Between two stages every chain block needs the whole vector that all of
// them formed in the last one, an all-to-all dependency.  No barrier
// carries it: each vector entry is one 64-bit word, the float's bits and
// its stage's tag, stored and loaded whole (single-copy atomic), so an
// entry is valid exactly when it carries the tag the reader waits for.
// A block stores its entries, and every block loads the whole vector,
// reloading a batch of entries until all of them carry the tag: one L2
// round trip after the last entry lands, where a counter barrier took an
// atomic, a poll and then the read (PERF.md).  The vector is
// double-buffered by stage parity: a block can only be writing the
// entries of stage s + 1 after it has read the whole vector of stage s,
// which every block formed after reading its own of stage s - 1, so the
// buffer it overwrites has been read by all.
#pragma once

#include "probe_common.cuh"

namespace chain {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 8;
constexpr int kBarBytes = 128;  // kMaxSlots mbarriers, 16-byte padded

// bytes of one ring slot for tiles of `tile_rows` rows of `bs` elements
// of `es` bytes: the tile rounded up to 16 bytes, plus 16 for a span that
// starts inside a 16-byte line (ops/thomas.ring_plan computes the same)
__host__ __device__ inline size_t slot_bytes(int tile_rows, int bs, int es) {
  return ((size_t)tile_rows * bs * es + 15) / 16 * 16 + 16;
}

// one arrival on `bar` with no transactions
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   probe::smem_addr(bar))
               : "memory");
}

// entries of the vector each thread loads at once while it waits
constexpr int kGatherBatch = 12;

// vector entry `dst` = v, tagged `tag` (> 0; the buffers start zeroed)
__device__ __forceinline__ void put_tagged(unsigned long long* dst, float v,
                                           unsigned tag) {
  const unsigned long long w =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(dst), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_tagged(
    const unsigned long long* src) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(src)
               : "memory");
  return w;
}

// every thread of the block: vec[j] = the float of src[j] once all n
// entries carry `tag`.  Each thread reloads its batch of entries whole
// until every one is in (reloading one entry at a time would pay a round
// trip for each entry read before it landed); ends in a block barrier.
__device__ __forceinline__ void gather_tagged(const unsigned long long* src,
                                              float* vec, int n,
                                              unsigned tag) {
  const unsigned long long ready = (unsigned long long)tag << 32;
  for (int j0 = threadIdx.x; j0 < n; j0 += kGatherBatch * kThreads) {
    unsigned long long w[kGatherBatch];
    bool done;
    do {
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int j = j0 + u * kThreads;
        w[u] = j < n ? ld_tagged(src + j) : ready;
      }
      done = true;
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u)
        done &= (unsigned)(w[u] >> 32) == tag;
    } while (!done);
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int j = j0 + u * kThreads;
      if (j < n) vec[j] = __uint_as_float((unsigned)w[u]);
    }
  }
  __syncthreads();
}

// gather_tagged over a strided set: dst[r * ncol + c] = the float of
// src[r * ld + c] for r < nrow, c < ncol, once all carry `tag` (T3 reads
// its rows' columns of every block's partial sums this way); ends in a
// block barrier
__device__ __forceinline__ void gather_tagged_rows(
    const unsigned long long* src, int ld, int nrow, int ncol, float* dst,
    unsigned tag) {
  const unsigned long long ready = (unsigned long long)tag << 32;
  const int n = nrow * ncol;
  for (int j0 = threadIdx.x; j0 < n; j0 += kGatherBatch * kThreads) {
    unsigned long long w[kGatherBatch];
    bool done;
    do {
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int j = j0 + u * kThreads;
        w[u] = j < n ? ld_tagged(src + (size_t)(j / ncol) * ld + j % ncol)
                     : ready;
      }
      done = true;
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u)
        done &= (unsigned)(w[u] >> 32) == tag;
    } while (!done);
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int j = j0 + u * kThreads;
      if (j < n) dst[j] = __uint_as_float((unsigned)w[u]);
    }
  }
  __syncthreads();
}

// dot(row of n elements in shared memory, shared float vector); every lane
// returns the full sum.  vec16: 16-byte loads (row and vector 16-byte
// aligned, n a multiple of 16 bytes of T)
__device__ __forceinline__ float dot_shared(const float* row, const float* v,
                                            int n, int lane, bool vec16) {
  float s = 0.f;
  if (vec16) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int j = lane; j < (n >> 2); j += 32) {
      const float4 a = r4[j], b = v4[j];
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
  } else {
    for (int j = lane; j < n; j += 32) s = fmaf(row[j], v[j], s);
  }
  return probe::warp_sum(s);
}

// the same for a bf16 row, each element widened to float32 at the FMA
__device__ __forceinline__ float dot_shared(const __nv_bfloat16* row,
                                            const float* v, int n, int lane,
                                            bool vec16) {
  float s = 0.f;
  if (vec16) {
    const uint4* r8 = reinterpret_cast<const uint4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int j = lane; j < (n >> 3); j += 32) {
      const uint4 u = r8[j];
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
      s = fmaf(__bfloat162float(row[j]), v[j], s);
  }
  return probe::warp_sum(s);
}

// the knot a ring's stage s reads, of Mi knots: forward then back (K1,
// K2, T3: s < Mi ? s : 2 Mi - 2 - s), forward (K3a, T2: s), backward
// (K3b: Mi - 1 - s)
enum Order { kForwardBack = 0, kForward, kBackward };

// One chain block's ring over the pivot rows [r0, r1) of every knot block
// of `dinv` [Mi, bs, bs]: tile i of the stream is tile i % ntile of stage
// (i / ntile) % nstage, whose knot is the stage's in the order kOrder
// (fixed at compile time: the stream's address arithmetic takes no
// branch on it).  With kSkip the stream leaves out the `nskip` stages of
// a period from stage `skip0` on (their rows sit in shared memory
// beside the ring, T1's P4): `nstage` then counts the stages a period
// streams, and streamed stage q is stage q, or q + nskip from skip0 on.
// With kIssueLast the block's last thread refills a released slot, not
// thread 0, which owns the block's first row: the copy's issue then does
// not delay that row's entry of the next vector (T1's P4; 5% of P4's
// time, and 8-10% of K1's and K2's, which still issue from thread 0,
// on an H100, PERF.md).
template <typename T, int kOrder = kForwardBack, bool kSkip = false,
          bool kIssueLast = false>
struct RowRing {
  uint64_t* bars;
  unsigned char* slots;
  size_t slot;  // bytes of one slot
  const T* dinv;
  int bs, Mi, r0, r1, tile_rows, nslots, ntile, nstage;
  int skip0, nskip;  // kSkip only
  long long ntiles;  // tiles of the whole stream
  bool aligned;      // rows are 16-byte multiples: no ragged edges

  // carve the barriers and slots from the front of `smem` (16-byte
  // aligned); returns the first byte after them
  __device__ unsigned char* carve(unsigned char* smem) {
    bars = reinterpret_cast<uint64_t*>(smem);
    slots = smem + kBarBytes;
    slot = slot_bytes(tile_rows, bs, (int)sizeof(T));
    return slots + (size_t)nslots * slot;
  }

  __device__ int knot_of(int s) const {
    if (kOrder == kForward) return s;
    if (kOrder == kBackward) return Mi - 1 - s;
    return s < Mi ? s : 2 * Mi - 2 - s;
  }

  // the global span of tile i: its first row and row count, and where it
  // starts
  __device__ const T* span(long long i, int* row0, int* nr) const {
    int s = (int)((i / ntile) % nstage);
    if (kSkip && s >= skip0) s += nskip;
    const int t = (int)(i % ntile);
    const int a = r0 + t * tile_rows;
    *row0 = a - r0;
    *nr = r1 - a < tile_rows ? r1 - a : tile_rows;
    return dinv + (size_t)knot_of(s) * bs * bs + (size_t)a * bs;
  }

  // thread 0: barrier initialisation, then the first tiles (the block
  // barrier that follows publishes the barriers to the other threads)
  __device__ void start() {
    for (int k = 0; k < nslots; ++k) probe::mbar_init(&bars[k], 1);
    probe::mbar_fence_init();
    for (long long i = 0; i < nslots && i < ntiles; ++i) issue(i);
  }

  // thread 0: copy tile i into slot i % nslots (its previous tile has been
  // consumed by every thread)
  __device__ void issue(long long i) const {
    int row0, nr;
    const uintptr_t a = (uintptr_t)span(i, &row0, &nr);
    const uintptr_t e = a + (size_t)nr * bs * sizeof(T);
    const uintptr_t lo = (a + 15) & ~(uintptr_t)15, hi = e & ~(uintptr_t)15;
    const int k = (int)(i % nslots);
    unsigned char* dst =
        slots + (size_t)k * slot + (lo - (a & ~(uintptr_t)15));
    probe::fence_proxy_async();
    if (hi > lo) {
      probe::mbar_expect_tx(&bars[k], (uint32_t)(hi - lo));
      probe::bulk_copy(dst, reinterpret_cast<const void*>(lo),
                       (uint32_t)(hi - lo), &bars[k]);
    } else {
      mbar_arrive(&bars[k]);
    }
  }

  // every thread: tile i once it has landed (its rows at the returned
  // pointer, row r at + r * bs); the ragged head and tail are loaded here
  __device__ const T* acquire(long long i, int* row0, int* nr) const {
    const T* g = span(i, row0, nr);
    const int k = (int)(i % nslots);
    T* d = reinterpret_cast<T*>(slots + (size_t)k * slot +
                                ((uintptr_t)g & 15));
    if (!aligned) {
      const uintptr_t a = (uintptr_t)g;
      const uintptr_t e = a + (size_t)*nr * bs * sizeof(T);
      const uintptr_t lo = (a + 15) & ~(uintptr_t)15;
      const uintptr_t hi = e & ~(uintptr_t)15;
      const int n = *nr * bs;
      const int h = hi > lo ? (int)((lo - a) / sizeof(T)) : n;
      const int t = hi > lo ? (int)((hi - a) / sizeof(T)) : n;
      for (int j = threadIdx.x; j < h; j += blockDim.x) d[j] = g[j];
      for (int j = t + threadIdx.x; j < n; j += blockDim.x) d[j] = g[j];
      __syncthreads();
    }
    probe::mbar_wait(&bars[k], (uint32_t)((i / nslots) & 1));
    return d;
  }

  // every thread, after its last read of tile i's slot: thread 0 (or,
  // kIssueLast, the last thread) refills the slot with tile i + nslots
  __device__ void release(long long i) const {
    __syncthreads();
    const unsigned issuer = kIssueLast ? blockDim.x - 1 : 0;
    if (threadIdx.x == issuer && i + nslots < ntiles) issue(i + nslots);
  }
};

}  // namespace chain
