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
// What bounds it on an H100: the stream of pivot rows (1.33 MB a knot at
// bs 576, 21.2 MB at bs 2304) and, in fwd and full, the chain of dependent
// stages, as in K2 (csrc/thomas.cu); a dense coupling also reads a second
// [bs, bs] matrix every stage (koM^T in fwd, koM too in full).
//
// What the design does about it: K2's ring (csrc/chain_ring.cuh).  A
// cooperative grid of one block per SM at most (ops/thomas_probe.probe_plan
// sizes it), each block streaming its rows through a ring of 1-D TMA
// copies on mbarriers, ahead of use, under an L2 evict_first policy (read
// once); warps take whole rows of a landed tile against a vector in shared
// memory.
//   dma, mv  no chain: knot k does not depend on knot k-1, so nothing but
//            the ring sits between knots, and the rung is split as Mi * bs
//            flat rows, a span a block, in tiles of up to 48 KB: an SM's
//            bulk copies land one after another, each at about a memory
//            latency, so a knot's few rows a copy (11.5 KB at bs 576) would
//            bound the stream by that latency (PERF.md).  mv's b rows of
//            the span's knots sit in shared memory; the owner of a knot's
//            row 0 writes dma's out[k], every thread keeps a checksum of
//            what it read.  On the chain's spans (knot_spans: a block's
//            rows of every knot, a stage a knot) they time the stream and
//            the dot of a chain stage; there mv's b_k rides in a ring of
//            its own (one slot a row slot, a bulk copy issued with the
//            knot's first tile).
//   fwd      the chain's spans, ceil(bs / SMs) rows a block, and two
//            exchanges a stage in K2's stage-tagged 64-bit entries (parity
//            double buffers): the block puts t[R] = D_{k-1}[R, :] y_{k-1},
//            gathers all of t, forms y_k[R] = b_k[R] - koM^T[R, :] t and
//            puts it; the next stage gathers all of y_k.
//   full     fwd, then the back substitution as partial column sums: the
//            owner of rows R forms p[j] = sum_{i in R} D_k[i, j] u[i] for
//            every column j from its own rows (u = y_k - koM x_{k+1} on R,
//            local), puts its p tagged, and reads its columns R of every
//            block's p, summed in block order (deterministic).  So a back
//            stage also passes two exchanges (x_{k+1}, then the partials)
//            and keeps the row stream of the forward sweep; a 2-D TMA
//            column panel of D_k per block was the alternative.
// The block's coupling rows (koM^T, and koM for full) sit in shared memory
// when a two-slot ring of two-row tiles still fits beside them: at bs 576
// (11.5 KB each) beside the full ring, at bs 2304 koM^T (166 KB) beside
// two slots of 3 rows; full's two (332 KB) at bs 2304 are read through L2
// under evict_last, the block's threads splitting the columns and each
// keeping one sum per row so that all rows' loads are in flight together.
// One grid sync at the start of fwd and full (the tagged buffers zeroed),
// none between knots.
#include "chain_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = chain::kThreads;
constexpr int kWarps = chain::kWarps;
// rows a block may own when its coupling rows are read through L2 (one
// register sum a row; ops/thomas_probe.MAX_L2_ROWS)
constexpr int kMaxRows = 32;

enum Stage { DMA = 0, MV, FWD, FULL };

struct Params {
  const float* dinv;  // [Mi, bs, bs] the rung's pivot blocks
  const float* koM;   // [bs, bs]
  const float* koMT;  // [bs, bs] koM transposed (fwd, full)
  const float* b;     // [Mi, bs]
  // fwd, full: tagged entries t [2, bs], y [2, bs], x [2, bs], and (full)
  // the partial sums p [2, grid, bs]
  unsigned long long* vbuf;
  float* out;   // [Mi, bs]
  float* sink;  // dma: [grid * kThreads] what each thread read
  int bs, Mi, stage, rows, tile_rows, nslots, resident;
  int knot_spans;  // dma, mv: the chain's spans, not flat ones
};

// b rows a flat span of `rows` rows of bs may touch
__host__ __device__ inline int span_knots(int rows, int bs, int Mi) {
  const int n = (rows + bs - 2) / bs + 1;
  return n < Mi ? n : Mi;
}

// floats of shared memory beside the ring (ops/thomas_probe.probe_plan
// computes the same)
__host__ __device__ inline size_t probe_floats(int stage, int bs, int Mi,
                                               int rows, int grid,
                                               int nslots, int resident,
                                               int knot_spans) {
  const size_t coup = resident ? (size_t)rows * bs : 0;
  const size_t red = kWarps * kMaxRows;
  if (stage == MV)
    return (size_t)(knot_spans ? nslots : span_knots(rows, bs, Mi)) * bs;
  if (stage == FWD) return bs + coup + red + rows;
  if (stage == FULL)
    return 2 * (size_t)bs + 2 * coup + red + rows + (size_t)grid * rows +
           (size_t)Mi * rows;
  return 0;
}

// cv[e] = C[r0 + e, :] . vec for e < n, the rows of C [bs, bs] read
// through L2: each thread takes 16-byte columns and keeps a sum per row
// (so the loads of all rows are in flight together), the warps' sums meet
// in `red` [kWarps, kMaxRows] in warp order.  Ends in a block barrier.
__device__ void coupling_l2(const float* __restrict__ C, int r0, int n,
                            const float* vec, int bs, float* red,
                            float* cv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // kept in L2 while the pivot stream (evict_first) passes through it
  const uint64_t keep = probe::l2_evict_last();
  float acc[kMaxRows];
#pragma unroll
  for (int e = 0; e < kMaxRows; ++e) acc[e] = 0.f;
  const float4* v4 = reinterpret_cast<const float4*>(vec);
  for (int j = threadIdx.x; j < (bs >> 2); j += kThreads) {
    const float4 v = v4[j];
#pragma unroll
    for (int e = 0; e < kMaxRows; ++e)
      if (e < n) {
        const float4 a = probe::ldg_hint(
            reinterpret_cast<const float4*>(C + (size_t)(r0 + e) * bs) + j,
            keep);
        acc[e] = fmaf(a.x, v.x, acc[e]);
        acc[e] = fmaf(a.y, v.y, acc[e]);
        acc[e] = fmaf(a.z, v.z, acc[e]);
        acc[e] = fmaf(a.w, v.w, acc[e]);
      }
  }
#pragma unroll
  for (int e = 0; e < kMaxRows; ++e)
    if (e < n) {
      const float s = probe::warp_sum(acc[e]);
      if (lane == 0) red[warp * kMaxRows + e] = s;
    }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kMaxRows + e];
    cv[e] = s;
  }
  __syncthreads();
}

// (row0 . v0, row1 . v1) for rows and vectors of n floats in shared
// memory (16-byte aligned, n a multiple of 4); every lane returns both
// sums.  Two rows and two partial sums a row keep four FMA chains in
// flight where one row's dot is one chain.
__device__ __forceinline__ float2 dot2_shared(const float* row0,
                                              const float* v0,
                                              const float* row1,
                                              const float* v1, int n,
                                              int lane) {
  const float4* a4 = reinterpret_cast<const float4*>(row0);
  const float4* c4 = reinterpret_cast<const float4*>(row1);
  const float4* x4 = reinterpret_cast<const float4*>(v0);
  const float4* y4 = reinterpret_cast<const float4*>(v1);
  float s0 = 0.f, s1 = 0.f, t0 = 0.f, t1 = 0.f;
  for (int j = lane; j < (n >> 2); j += 32) {
    const float4 a = a4[j], x = x4[j], c = c4[j], y = y4[j];
    s0 = fmaf(a.x, x.x, s0);
    s1 = fmaf(a.y, x.y, s1);
    t0 = fmaf(c.x, y.x, t0);
    t1 = fmaf(c.y, y.y, t1);
    s0 = fmaf(a.z, x.z, s0);
    s1 = fmaf(a.w, x.w, s1);
    t0 = fmaf(c.z, y.z, t0);
    t1 = fmaf(c.w, y.w, t1);
  }
  float s = s0 + s1, t = t0 + t1;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  return make_float2(s, t);
}

__global__ void __launch_bounds__(kThreads) probe_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bs = p.bs, Mi = p.Mi, ncb = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool chained = p.stage == FWD || p.stage == FULL;
  // dma and mv stream the rung as Mi * bs flat rows unless asked for the
  // chain's spans (a block's rows of every knot, one stage a knot)
  const bool flat = !chained && !p.knot_spans;
  const int nstage = flat ? 1
                     : p.stage == FULL ? 2 * Mi - 1
                     : p.stage == FWD  ? Mi - 1
                                       : Mi;
  const int nrow = flat ? Mi * bs : bs;

  chain::RowRing<float> ring;
  ring.dinv = p.dinv;
  ring.bs = bs;
  ring.Mi = flat ? 1 : Mi;
  ring.r0 = min((int)blockIdx.x * p.rows, nrow);
  ring.r1 = min(ring.r0 + p.rows, nrow);
  ring.tile_rows = p.tile_rows;
  ring.nslots = p.nslots;
  ring.ntile = (ring.r1 - ring.r0 + p.tile_rows - 1) / p.tile_rows;
  ring.nstage = nstage > 0 ? nstage : 1;
  ring.ntiles = (long long)nstage * ring.ntile;
  ring.aligned = true;  // bs % 4 == 0 and the rung on 16 bytes
  float* fl = reinterpret_cast<float*>(ring.carve(smem));
  const int r0 = ring.r0, nrows = ring.r1 - ring.r0, rows = p.rows;
  // mv on the chain's spans: a ring of b rows, slot q holding b_s for the
  // stages s = q (mod nslots), its barriers after the row ring's; on flat
  // spans the block's b rows from knot kb0 on, loaded at the start
  uint64_t* bbars = ring.bars + chain::kMaxSlots;
  const int kb0 = r0 / bs;
  // the flat row (knot * bs + row) of tile i's first row
  auto first_row = [&](long long i, int row0) -> int {
    return flat ? r0 + row0 : (int)(i / ring.ntile) * bs + r0 + row0;
  };

  // thread 0: tile i of the ring, read once: evict_first in L2 (the
  // coupling rows read through L2 are kept); for mv on the chain's spans,
  // with a stage's first tile that stage's b row (its slot was read by a
  // stage that is complete: one b slot per row slot covers any number of
  // tiles a stage)
  const uint64_t once = probe::l2_evict_first();
  auto issue = [&](long long i) {
    int row0, nr;
    const float* g = ring.span(i, &row0, &nr);
    const int q = (int)(i % ring.nslots);
    const uint32_t n = (uint32_t)(nr * bs * sizeof(float));
    probe::fence_proxy_async();  // the slot was read by generic loads
    probe::mbar_expect_tx(&ring.bars[q], n);
    probe::bulk_copy_hint(ring.slots + (size_t)q * ring.slot, g, n,
                          &ring.bars[q], once);
    if (p.stage == MV && !flat && i % ring.ntile == 0) {
      const int s = (int)(i / ring.ntile), qb = s % p.nslots;
      probe::mbar_expect_tx(&bbars[qb], (uint32_t)(bs * sizeof(float)));
      probe::bulk_copy(fl + (size_t)qb * bs, p.b + (size_t)s * bs,
                       (uint32_t)(bs * sizeof(float)), &bbars[qb]);
    }
  };
  // every thread, after its last read of tile i's slot
  auto release = [&](long long i) {
    __syncthreads();
    if (tid == 0 && i + p.nslots < ring.ntiles) issue(i + p.nslots);
  };

  // ---- the layout beside the ring (probe_floats) ----
  float* vec = fl;                                          // [bs]
  float* kT = vec + bs;                                     // [rows, bs]
  float* kM = kT + (p.resident ? (size_t)rows * bs : 0);    // [rows, bs]
  float* pacc = kM + (p.resident && p.stage == FULL ? (size_t)rows * bs : 0);
  float* red = pacc + (p.stage == FULL ? bs : 0);           // [8, 32]
  float* tv = red + kWarps * kMaxRows;                      // [rows]
  float* pg = tv + rows;                                    // [grid, rows]
  float* ysh = pg + (size_t)ncb * rows;                     // [Mi, rows]
  unsigned long long* Tb = p.vbuf;
  unsigned long long* Yb = Tb + 2 * (size_t)bs;
  unsigned long long* Xb = Yb + 2 * (size_t)bs;
  unsigned long long* Pb = Xb + 2 * (size_t)bs;

  if (tid == 0) {
    for (int q = 0; q < p.nslots; ++q) {
      probe::mbar_init(&ring.bars[q], 1);
      if (p.stage == MV && !flat) probe::mbar_init(&bbars[q], 1);
    }
    probe::mbar_fence_init();
    for (long long i = 0; i < p.nslots && i < ring.ntiles; ++i) issue(i);
  }
  if (!chained) {
    if (p.stage == MV && flat)
      for (int j = tid; j < ((ring.r1 - 1) / bs - kb0 + 1) * bs;
           j += kThreads)
        fl[j] = __ldg(p.b + (size_t)kb0 * bs + j);
    __syncthreads();  // the barriers initialised, the b rows in
  } else {
    const size_t nbuf =
        6 * (size_t)bs + (p.stage == FULL ? 2 * (size_t)ncb * bs : 0);
    for (size_t j = (size_t)blockIdx.x * kThreads + tid; j < nbuf;
         j += (size_t)ncb * kThreads)
      p.vbuf[j] = 0ull;
    if (p.resident) {
      const float4* s4 =
          reinterpret_cast<const float4*>(p.koMT + (size_t)r0 * bs);
      const float4* m4 =
          reinterpret_cast<const float4*>(p.koM + (size_t)r0 * bs);
      for (int j = tid; j < nrows * bs / 4; j += kThreads) {
        reinterpret_cast<float4*>(kT)[j] = __ldg(s4 + j);
        if (p.stage == FULL) reinterpret_cast<float4*>(kM)[j] = __ldg(m4 + j);
      }
    }
    for (int e = tid; e < nrows; e += kThreads) {  // y_0 = b_0
      if (p.stage == FWD) p.out[r0 + e] = p.b[r0 + e];
      else ysh[e] = p.b[r0 + e];
    }
    // no entry carries a tag yet, for every block
    cg::this_grid().sync();
  }

  long long i = 0;  // this block's next tile
  if (p.stage == DMA) {
    const int q4 = bs >> 2;
    float s = 0.f;
    for (; i < ring.ntiles; ++i) {
      int row0, nr;
      const float4* A4 =
          reinterpret_cast<const float4*>(ring.acquire(i, &row0, &nr));
      const int a0 = first_row(i, row0);
      for (int j = tid; j < nr * q4; j += kThreads) {
        const float4 a = A4[j];
        s += (a.x + a.y) + (a.z + a.w);
      }
      // the tile's rows 0 of a knot: D_k[0, :] at out[k] (k = row / bs)
      for (int r = (bs - a0 % bs) % bs; r < nr; r += bs)
        for (int c = tid; c < q4; c += kThreads)
          reinterpret_cast<float4*>(p.out + a0 + r)[c] = A4[r * q4 + c];
      release(i);
    }
    p.sink[(size_t)blockIdx.x * kThreads + tid] = s;
    return;
  }

  if (p.stage == MV) {
    for (; i < ring.ntiles; ++i) {
      int row0, nr;
      const float* A = ring.acquire(i, &row0, &nr);
      const int a0 = first_row(i, row0);
      const float* v = fl;  // b_k of the tile's rows (chain's spans)
      if (!flat) {
        const int st = (int)(i / ring.ntile), q = st % p.nslots;
        if (i % ring.ntile == 0)
          probe::mbar_wait(&bbars[q], (uint32_t)((st / p.nslots) & 1));
        v = fl + (size_t)q * bs;
      }
      // rows r and r + 8 of the tile a warp at a time, the last alone
      auto vec_of = [&](int row) {
        return flat ? fl + (size_t)(row / bs - kb0) * bs : v;
      };
      for (int r = warp; r < nr; r += 2 * kWarps) {
        const int r2 = r + kWarps;
        if (r2 < nr) {
          const float2 d =
              dot2_shared(A + (size_t)r * bs, vec_of(a0 + r),
                          A + (size_t)r2 * bs, vec_of(a0 + r2), bs, lane);
          if (lane == 0) {
            p.out[a0 + r] = d.x;
            p.out[a0 + r2] = d.y;
          }
        } else {
          const float d = chain::dot_shared(A + (size_t)r * bs,
                                            vec_of(a0 + r), bs, lane, true);
          if (lane == 0) p.out[a0 + r] = d;
        }
      }
      release(i);
    }
    return;
  }

  // cv[e] = (row r0 + e of koM^T or koM) . vec for the block's rows: from
  // shared memory (sm) when resident, else through L2 (g); ends in a block
  // barrier
  auto coupling = [&](const float* sm, const float* g, float* cv) {
    if (p.resident) {
      for (int e = warp; e < nrows; e += kWarps) {
        const float d =
            chain::dot_shared(sm + (size_t)e * bs, vec, bs, lane, true);
        if (lane == 0) cv[e] = d;
      }
      __syncthreads();
    } else {
      coupling_l2(g, r0, nrows, vec, bs, red, cv);
    }
  };

  // ---- fwd and full: the chain ----
  for (int s = 0; s < nstage; ++s) {
    const int k = ring.knot_of(s);
    const bool back = s >= Mi;  // full's back substitution, x_k
    const unsigned tag = (unsigned)(s + 1), par = (s + 1) & 1;
    // the stage's vector: b_0, y_s (forward), x_{k+1} (back)
    if (s == 0) {
      for (int j = tid; j < bs; j += kThreads) vec[j] = __ldg(p.b + j);
      __syncthreads();
    } else {
      chain::gather_tagged((back ? Xb : Yb) + (size_t)(s & 1) * bs, vec, bs,
                           (unsigned)s);
    }
    if (!back) {
      // t[R] = D_k[R, :] vec: y_s's product (forward), or x_{Mi-1}
      for (int t = 0; t < ring.ntile; ++t, ++i) {
        int row0, nr;
        const float* A = ring.acquire(i, &row0, &nr);
        for (int r = warp; r < nr; r += kWarps) {
          const float d =
              chain::dot_shared(A + (size_t)r * bs, vec, bs, lane, true);
          if (lane == 0) tv[row0 + r] = d;
        }
        release(i);
      }
      if (s == Mi - 1) {  // full: x_{Mi-1} = D_{Mi-1} y_{Mi-1}
        for (int e = tid; e < nrows; e += kThreads) {
          p.out[(size_t)k * bs + r0 + e] = tv[e];
          if (s + 1 < nstage)
            chain::put_tagged(Xb + par * (size_t)bs + r0 + e, tv[e], tag);
        }
        __syncthreads();
        continue;
      }
      // exchange 1: all of t
      for (int e = tid; e < nrows; e += kThreads)
        chain::put_tagged(Tb + par * (size_t)bs + r0 + e, tv[e], tag);
      chain::gather_tagged(Tb + par * (size_t)bs, vec, bs, tag);
      // y_{k+1}[R] = b_{k+1}[R] - koM^T[R, :] t
      coupling(kT, p.koMT, tv);
      for (int e = tid; e < nrows; e += kThreads) {
        const float y = __ldg(p.b + (size_t)(k + 1) * bs + r0 + e) - tv[e];
        if (p.stage == FWD) p.out[(size_t)(k + 1) * bs + r0 + e] = y;
        else ysh[(size_t)(k + 1) * rows + e] = y;
        chain::put_tagged(Yb + par * (size_t)bs + r0 + e, y, tag);
      }
      __syncthreads();  // vec is rewritten by the next stage
      continue;
    }
    // ---- back: u[R] = y_k[R] - koM[R, :] x_{k+1}, local to the block ----
    coupling(kM, p.koM, tv);
    for (int e = tid; e < nrows; e += kThreads)
      tv[e] = ysh[(size_t)k * rows + e] - tv[e];
    for (int j = tid; j < bs; j += kThreads) pacc[j] = 0.f;
    __syncthreads();
    // p[j] = sum over the block's rows i (in order) of D_k[i, j] u[i]
    for (int t = 0; t < ring.ntile; ++t, ++i) {
      int row0, nr;
      const float* A = ring.acquire(i, &row0, &nr);
      for (int j = tid; j < bs; j += kThreads) {
        float a = pacc[j];
        for (int r = 0; r < nr; ++r)
          a = fmaf(A[(size_t)r * bs + j], tv[row0 + r], a);
        pacc[j] = a;
      }
      release(i);
    }
    // exchange 2: every block's partials of the block's columns R
    unsigned long long* P = Pb + par * (size_t)ncb * bs;
    for (int j = tid; j < bs; j += kThreads)
      chain::put_tagged(P + (size_t)blockIdx.x * bs + j, pacc[j], tag);
    chain::gather_tagged_rows(P + r0, bs, ncb, nrows, pg, tag);
    for (int e = warp; e < nrows; e += kWarps) {
      float x = 0.f;
      for (int c = lane; c < ncb; c += 32) x += pg[(size_t)c * nrows + e];
      x = probe::warp_sum(x);
      if (lane == 0) {
        p.out[(size_t)k * bs + r0 + e] = x;
        if (s + 1 < nstage)
          chain::put_tagged(Xb + par * (size_t)bs + r0 + e, x, tag);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// The blocks thomas_probe launches for `nrow` rows split into the plan's
// `rows` a block (bs, or Mi * bs for dma and mv on flat spans):
// ceil(nrow / rows), refused unless all can co-reside with `smem` bytes of
// dynamic shared memory each; through `grid`.  Returns a cudaError_t.
int thomas_probe_grid(int nrow, int rows, int smem, int* grid) {
  if (nrow < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const int want = (nrow + rows - 1) / rows;
  int g = 0;
  const int e = probe::coop_grid((const void*)probe_kernel, kThreads,
                                 (size_t)smem, want, &g);
  if (e != 0) return e;
  if (g < want) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = want;
  return 0;
}

// One cooperative launch of `stage` (0 dma, 1 mv, 2 fwd, 3 full) on the
// plan of ops/thomas_probe.probe_plan (rows a block, tile_rows, nslots,
// resident coupling rows, dma and mv on the chain's spans, smem bytes):
// dinv [Mi, bs, bs] (the rung), koM and koMT [bs, bs], b [Mi, bs], all
// 16-byte aligned; scratch vbuf (fwd, full: 64-bit [6 bs], full + [2,
// grid, bs]) and sink (dma: [grid * 256]); out [Mi, bs].  bs a multiple
// of 4.  Returns a cudaError_t (0 = launched).
int thomas_probe(void* dinv, void* koM, void* koMT, void* b, void* vbuf,
                 void* out, void* sink, int bs, int Mi, int stage, int rows,
                 int tile_rows, int nslots, int resident, int knot_spans,
                 int smem, void* stream) {
  if (stage < DMA || stage > FULL || bs < 4 || bs % 4 || Mi < 1 ||
      rows < 1 || tile_rows < 1 || tile_rows > rows || nslots < 1 ||
      nslots > chain::kMaxSlots ||
      (stage >= FWD && !resident && rows > kMaxRows))
    return (int)cudaErrorInvalidValue;
  const bool flat = stage <= MV && !knot_spans;
  int grid = 0;
  int e = thomas_probe_grid(flat ? Mi * bs : bs, rows, smem, &grid);
  if (e != 0) return e;
  const size_t need =
      chain::kBarBytes + nslots * chain::slot_bytes(tile_rows, bs, 4) +
      sizeof(float) * probe_floats(stage, bs, Mi, rows, grid, nslots,
                                   resident ? 1 : 0, flat ? 0 : 1);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  Params p;
  p.dinv = (const float*)dinv;
  p.koM = (const float*)koM;
  p.koMT = (const float*)koMT;
  p.b = (const float*)b;
  p.vbuf = (unsigned long long*)vbuf;
  p.out = (float*)out;
  p.sink = (float*)sink;
  p.bs = bs;
  p.Mi = Mi;
  p.stage = stage;
  p.rows = rows;
  p.tile_rows = tile_rows;
  p.nslots = nslots;
  p.resident = resident ? 1 : 0;
  p.knot_spans = flat ? 0 : 1;
  void* args[] = {&p};
  cudaError_t c = cudaLaunchCooperativeKernel(
      (const void*)probe_kernel, dim3(grid), dim3(kThreads), args, smem,
      (cudaStream_t)stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

const char* thomas_probe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
