// T2, the chain-primitive bench for Hopper (sm_90a): what one step of the
// Thomas chain costs, primitive by primitive.  It replaces the Pallas TPU
// kernel of the JAX package's tools/pallas_debug/thomas_prim_bench.py
// (`kern`), which runs REPS x Mi steps over one rung of pivot blocks A_k
// [bs, bs] with a state acc [bs, bs] (vrow = acc row 0, vcol = acc col 0):
//   dma      row 0 += A[0, :]
//   mv_sub   row 0  = vcol^T A          (a column reduction)
//   mv_lane  col 0  = A vrow            (a row reduction)
//   mv_mxu   row 0  = bf16(vrow) @ bf16(A), float32 accumulation, tensor cores
//   trans    acc    = 0.5 acc + A^T
//   fwd      t = A vrow; row 0 = b_k - t^T koM + 1e-30 t^T A
//   dmag     groups of nbuf blocks per step, row 0 += row 0 of the group's
//            first block; Mi // nbuf groups (the remainder dropped)
//   dmaq     as dma, each tile copied as nbuf parts on their own barriers
// and writes row 0 of acc.  The TPU kernel reads acc before it ever writes
// it; here acc starts from what the caller gives (zeros, or a seeded acc0).
//
// What bounds it on an H100: per step, the block's bytes (1.6 MB at bs 640,
// 21 MB at bs 2304) and, where a step reads what the last one reduced
// across blocks, the exchange; the operations are 2 bs^2 per matvec at
// most.
//
// What the design does about it: K2's chain ring (csrc/chain_ring.cuh).
// Every step moves the whole pivot block from device memory into shared
// memory, as the TPU moves it into VMEM, split by rows: block c owns rows
// [c * rows, (c + 1) * rows) of every block (ops/thomas_prim.prim_plan:
// one block per SM, row groups as ops/thomas.ring_plan splits the chain's,
// or one block of all rows, the TPU probe's single core) and streams its
// spans through a ring of 1-D TMA bulk copies on mbarriers in RowRing's
// forward order, periodic over the repetitions (step s reads block s mod
// Mi; dmag's group s mod (Mi / nbuf), its nbuf spans in one slot as one
// 3-D tensor-map copy, the rung seen as [Mi][bs*bs/C][C] floats, C the
// largest multiple of 4 up to 256 dividing bs, a box of nbuf knots x the
// tile's chunks of C).  The mode is a template parameter: each mode's
// step loop is compiled alone.  No barrier stands between steps:
// a mode exchanges what its next step reads, in K2's stage-tagged 64-bit
// entries
// (zeroed by the caller, tag = step + 1), and nothing else:
//   dma, dmag, dmaq, trans  nothing (row 0 is block 0's alone; trans's acc
//            columns are the block's own rows)
//   mv_lane  vrow[0] from the owner of row 0, an entry a step
//   mv_sub   vcol[0] for the owner of row 0: every block's column-0
//            partial, an entry a block a step, summed in block order
//   mv_mxu   vrow on the block's own rows: every block's partial row,
//            read back by column as T3's full reads its partials
//            (gather_tagged_rows) and summed in block order
//   fwd      the same partial rows, then the whole state row (two
//            exchanges a step)
// so runs stay deterministic.  Entries read by one block or written once
// a step sit in one place a step; the partial rows and the state row,
// which every block waits on, alternate between two by step parity.
#include <cuda.h>

#include "chain_ring.cuh"

namespace {

constexpr int kThreads = chain::kThreads;
constexpr int kWarps = chain::kWarps;
constexpr int kBarBytes = 512;   // room for 64 mbarriers
constexpr int kSlotAlign = 128;  // ops/thomas_prim.SLOT_ALIGN

enum Mode { DMA = 0, MV_SUB, MV_LANE, MV_MXU, TRANS, FWD, DMAG, DMAQ };

struct Params {
  CUtensorMap tmap;        // dmag's group copy
  const float* dinv;       // [Mi, bs, bs] the rung's pivot blocks
  const float* koM;        // [bs, bs]
  const float* b;          // [Mi, bs]
  float* acc;              // [bs, bs] the state, set by the caller
  unsigned long long* xb;  // tagged exchange entries, zeroed by the caller
  int bs, Mi, reps, nbuf, rows, tile_rows, nslots, slot_bytes;
  int chunk;  // dmag: the tensor map's innermost box dimension
};

// the largest multiple of 4 up to 256 that divides bs (0 if none): the
// innermost box dimension of dmag's tensor map
inline int map_chunk(int bs) {
  for (int c = 256; c >= 4; c -= 4)
    if (bs % c == 0) return c;
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// dmag's tensor map of the rung dinv [Mi, bs, bs]: [Mi][bs*bs/C][C] floats,
// a box of grp knots x tile_rows rows (tile_rows * bs / C chunks of C);
// the driver's encoder found through the runtime.  Returns a cudaError_t.
int encode_group_map(CUtensorMap* m, const float* dinv, int bs, int Mi,
                     int tile_rows, int grp, int C) {
  if (C == 0 || (long long)tile_rows * bs / C > 256 || grp > 256)
    return (int)cudaErrorInvalidValue;
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)bs * bs / C,
                              (cuuint64_t)Mi};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(float),
                                 (cuuint64_t)bs * bs * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)C, (cuuint32_t)(tile_rows * bs / C),
                             (cuuint32_t)grp};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(dinv), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// floats beside the ring (ops/thomas_prim.prim_plan computes the same):
// the state row, the partial row, a tile's row products, and only for
// the modes that read them the gathered partials (mv_sub, mv_mxu, fwd)
// and b_k's rows (fwd)
__host__ __device__ inline size_t prim_floats(int mode, int bs, int rows,
                                              int tile_rows, int blocks) {
  const bool gather = mode == MV_SUB || mode == MV_MXU || mode == FWD;
  return 2 * (size_t)bs + tile_rows + (gather ? (size_t)blocks * rows : 0) +
         (mode == FWD ? rows : 0);
}

// for every row e < n: put(e, the sum over c < ncb of src[c * n + e]) in
// one fixed order: under 32 blocks a thread a row adds them in block
// order; else a warp a row, its lanes taking c strided, then the warp's
// butterfly (put by lane 0)
template <typename F>
__device__ __forceinline__ void sum_blocks(const float* src, int ncb, int n,
                                           F put) {
  if (ncb < 32) {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      float v = 0.f;
      for (int c = 0; c < ncb; ++c) v += src[(size_t)c * n + e];
      put(e, v);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < n; e += kWarps) {
    float v = 0.f;
    for (int c = lane; c < ncb; c += 32) v += src[(size_t)c * n + e];
    v = probe::warp_sum(v);
    if (lane == 0) put(e, v);
  }
}

template <int mode>
__global__ void __launch_bounds__(kThreads)
    prim_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bs = p.bs, nbuf = p.nbuf, tr = p.tile_rows;
  const int nslots = p.nslots;
  const int q = mode == DMAQ ? nbuf : 1;    // copies (and barriers) a tile
  const int grp = mode == DMAG ? nbuf : 1;  // pivot blocks a step
  const int spr = p.Mi / grp;               // steps a repetition
  const long long S = (long long)p.reps * spr;
  const int ncb = gridDim.x, bid = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the block's rows of every pivot block (dmag: of each group's first),
  // a stage a step in the forward order, periodic over the repetitions
  chain::RowRing<float, chain::kForward> ring;
  ring.dinv = p.dinv;
  ring.bs = bs;
  ring.Mi = spr;
  ring.r0 = min(bid * p.rows, bs);
  ring.r1 = min(ring.r0 + p.rows, bs);
  ring.tile_rows = tr;
  ring.nslots = nslots;
  ring.ntile = (ring.r1 - ring.r0 + tr - 1) / tr;
  ring.nstage = spr > 0 ? spr : 1;
  ring.ntiles = S * ring.ntile;
  ring.bars = reinterpret_cast<uint64_t*>(smem);
  ring.slots = smem + kBarBytes;
  ring.slot = p.slot_bytes;
  const int r0 = ring.r0, nrows = ring.r1 - ring.r0;
  float* vec = reinterpret_cast<float*>(ring.slots + nslots * ring.slot);
  float* part = vec + bs;                  // [bs] the block's partial row
  float* tvec = part + bs;                 // [tile_rows] fwd's t
  float* pg = tvec + tr;                   // [ncb, nrows] gathered partials
  float* pb = pg + (size_t)ncb * p.rows;   // [nrows] fwd: b_k's rows
  // (pg and pb lie past the end of the modes' shared memory that do not
  // read them: prim_floats)
  // the exchanges (ops/thomas_prim.exchange_words)
  unsigned long long* xp = p.xb;  // partial rows [2, ncb, bs]
  unsigned long long* xv = p.xb + 2 * (size_t)ncb * bs;  // fwd: row 0 [2, bs]
  unsigned long long* xf = p.xb + S * ncb;  // mv_sub: the last partials

  // thread 0: tile i (its rows of step i / ntile's pivot blocks) into slot
  // i % nslots, whose last tile every thread has read: dmag's nbuf spans
  // in one tensor-map copy, dmaq's tile in q parts on q barriers
  auto issue = [&](long long i) {
    int row0, nr;
    const float* g = ring.span(i, &row0, &nr);
    const int k = (int)(i % nslots);
    char* dst = reinterpret_cast<char*>(ring.slots + (size_t)k * ring.slot);
    const uint32_t bytes = (uint32_t)((size_t)nr * bs * sizeof(float));
    probe::fence_proxy_async();
    if (mode == DMAG) {
      // the whole box: rows past the block's own land too (zeros past the
      // rung's end) and are not read
      const int st = (int)((i / ring.ntile) % spr);
      probe::mbar_expect_tx(&ring.bars[k],
                            (uint32_t)(grp * tr * bs * sizeof(float)));
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
              probe::smem_addr(dst)),
          "l"(reinterpret_cast<uint64_t>(&p.tmap)),
          "r"(probe::smem_addr(&ring.bars[k])), "r"(0),
          "r"((r0 + row0) * bs / p.chunk), "r"(st * grp)
          : "memory");
      return;
    }
    uint32_t off = 0;
    for (int c = 0; c < q; ++c) {
      const uint32_t n = c + 1 < q ? ((bytes / q) & ~15u) : bytes - off;
      uint64_t* bar = &ring.bars[k * q + c];
      probe::mbar_expect_tx(bar, n);
      if (n)
        probe::bulk_copy(dst + off, reinterpret_cast<const char*>(g) + off, n,
                         bar);
      off += n;
    }
  };

  if (tid == 0) {
    for (int k = 0; k < nslots * q; ++k) probe::mbar_init(&ring.bars[k], 1);
    probe::mbar_fence_init();
    for (long long i = 0; i < nslots && i < ring.ntiles; ++i) issue(i);
  }
  // ---- the state the first step reads: only what this block uses, so
  // that no block reads what another writes at its end ----
  for (int j = tid; j < bs; j += kThreads) {
    float v = 0.f;
    if (mode == MV_SUB) {  // vcol of the block's rows (index r - r0)
      if (j < nrows) v = p.acc[(size_t)(r0 + j) * bs];
    } else if (mode == MV_MXU) {  // vrow on the block's rows
      if (j >= r0 && j < r0 + nrows) v = p.acc[j];
    } else if (mode == FWD || (mode == MV_LANE && j > 0) ||
               ((mode == DMA || mode == DMAG || mode == DMAQ) && bid == 0)) {
      v = p.acc[j];  // row 0 (mv_lane's vrow[0] comes through its entry)
    }
    vec[j] = v;
    part[j] = 0.f;
  }
  if (mode == MV_LANE && bid == 0 && tid == 0 && S > 0)
    chain::put_tagged(p.xb, p.acc[0], 1u);
  __syncthreads();

  long long i = 0;  // this block's next tile
  for (long long s = 0; s < S; ++s) {
    const int st = (int)(s % spr);  // the step's pivot block (dmag: group)
    const unsigned tag = (unsigned)(s + 1);
    const bool last = s + 1 == S;
    // ---- what this step reads from the last ----
    if (mode == MV_LANE) {  // vrow[0], from the owner of row 0
      chain::gather_tagged(p.xb + s, vec, 1, tag);
    } else if (mode == MV_SUB && bid == 0 && s > 0) {
      // vcol[0]: step s - 1's column-0 partials of every block
      chain::gather_tagged(p.xb + (s - 1) * ncb, pg, ncb, (unsigned)s);
      sum_blocks(pg, ncb, 1, [&](int, float v) { vec[0] = v; });
      __syncthreads();
    } else if (mode == FWD) {  // b_k's rows, for the end of the step
      for (int e = tid; e < nrows; e += kThreads)
        pb[e] = __ldg(p.b + (size_t)st * bs + r0 + e);
    }

    for (int t = 0; t < ring.ntile; ++t, ++i) {
      const int k = (int)(i % nslots);
      const uint32_t parity = (uint32_t)((i / nslots) & 1);
      for (int c = 0; c < q; ++c)
        probe::mbar_wait(&ring.bars[k * q + c], parity);
      const float* A =
          reinterpret_cast<const float*>(ring.slots + (size_t)k * ring.slot);
      const int a0 = r0 + t * tr;  // the tile's first row
      const int nr = ring.r1 - a0 < tr ? ring.r1 - a0 : tr;

      if (mode == DMA || mode == DMAQ || mode == DMAG) {
        if (a0 == 0)  // row 0 (dmag: of the group's first block)
          for (int j = tid; j < bs; j += kThreads) vec[j] += A[j];
      } else if (mode == MV_SUB) {
        for (int j = tid; j < bs; j += kThreads) {
          float v = part[j];
          for (int r = 0; r < nr; ++r)
            v = fmaf(A[(size_t)r * bs + j], vec[a0 - r0 + r], v);
          part[j] = v;
        }
      } else if (mode == MV_LANE) {
        for (int r = warp; r < nr; r += kWarps) {
          const float v =
              chain::dot_shared(A + (size_t)r * bs, vec, bs, lane, true);
          if (lane == 0) {
            if (a0 + r > 0)
              p.acc[(size_t)(a0 + r) * bs] = v;
            else if (!last)  // vrow[0] of the next step
              chain::put_tagged(p.xb + s + 1, v, tag + 1);
            else
              p.acc[0] = v;
          }
        }
      } else if (mode == MV_MXU) {
        const int g = lane >> 2, qd = lane & 3;
        for (int n0 = warp * 8; n0 < bs; n0 += kWarps * 8) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k0 = 0; k0 < nr; k0 += 16) {
            uint32_t a[4] = {0u, 0u, 0u, 0u}, bf[2];
            auto vr = [&](int kk) {
              return k0 + kk < nr ? vec[a0 + k0 + kk] : 0.f;
            };
            auto ar = [&](int kk) {
              return k0 + kk < nr ? A[(size_t)(k0 + kk) * bs + n0 + g] : 0.f;
            };
            if (g == 0) {
              a[0] = probe::pack_bf16(vr(2 * qd), vr(2 * qd + 1));
              a[2] = probe::pack_bf16(vr(2 * qd + 8), vr(2 * qd + 9));
            }
            bf[0] = probe::pack_bf16(ar(2 * qd), ar(2 * qd + 1));
            bf[1] = probe::pack_bf16(ar(2 * qd + 8), ar(2 * qd + 9));
            probe::mma_bf16_16816(d, a, bf);
          }
          if (g == 0) {
            part[n0 + 2 * qd] += d[0];
            part[n0 + 2 * qd + 1] += d[1];
          }
        }
      } else if (mode == TRANS) {
        // acc[j, a0 + r] = 0.5 acc[j, a0 + r] + A[r, j]: r fastest, so a
        // thread group writes a contiguous run of acc's row j
        const int n = nr * bs;
        for (int e = tid; e < n; e += kThreads) {
          const int j = e / nr, r = e - j * nr;
          float* dst = p.acc + (size_t)j * bs + a0 + r;
          *dst = fmaf(0.5f, *dst, A[(size_t)r * bs + j]);
        }
      } else {  // FWD
        for (int r = warp; r < nr; r += kWarps) {
          const float v =
              chain::dot_shared(A + (size_t)r * bs, vec, bs, lane, true);
          if (lane == 0) tvec[r] = v;
        }
        __syncthreads();
        for (int j = tid; j < bs; j += kThreads) {
          float v = part[j];
          for (int r = 0; r < nr; ++r)
            v = fmaf(tvec[r],
                     fmaf(1e-30f, A[(size_t)r * bs + j],
                          -p.koM[(size_t)(a0 + r) * bs + j]),
                     v);
          part[j] = v;
        }
      }
      __syncthreads();  // every thread is done with the slot
      if (tid == 0 && i + nslots < ring.ntiles) issue(i + nslots);
    }

    // ---- what the next step (or the end) reads from this one ----
    if (mode == MV_SUB && !last) {
      if (tid == 0) chain::put_tagged(p.xb + s * ncb + bid, part[0], tag);
      for (int j = tid; j < bs; j += kThreads) part[j] = 0.f;
    } else if (mode == MV_SUB || mode == MV_MXU || mode == FWD) {
      // every block's partial row; this block sums its columns of them
      unsigned long long* P =
          mode == MV_SUB ? xf : xp + (size_t)(s & 1) * ncb * bs;
      for (int j = tid; j < bs; j += kThreads) {
        chain::put_tagged(P + (size_t)bid * bs + j, part[j], tag);
        part[j] = 0.f;
      }
      chain::gather_tagged_rows(P + r0, bs, ncb, nrows, pg, tag);
      unsigned long long* V = xv + (size_t)(s & 1) * bs;
      sum_blocks(pg, ncb, nrows, [&](int e, float v) {
        if (mode == FWD) v += pb[e];
        if (last) p.acc[r0 + e] = v;  // row 0 of the end state
        else if (mode == MV_MXU) vec[r0 + e] = v;
        else chain::put_tagged(V + r0 + e, v, tag);
      });
      if (mode == FWD && !last)
        chain::gather_tagged(V, vec, bs, tag);  // the whole state row
      else
        __syncthreads();
    }
  }

  // ---- row 0 of the end state (the others wrote theirs above) ----
  if ((mode == DMA || mode == DMAG || mode == DMAQ) && bid == 0 && S > 0)
    for (int j = tid; j < bs; j += kThreads) p.acc[j] = vec[j];
}

}  // namespace

extern "C" {

// One cooperative launch of REPS x steps of `mode` on ceil(bs / rows)
// blocks, the plan of ops/thomas_prim.prim_plan (rows a block, tile_rows,
// nslots, slot_bytes, smem): dinv [Mi, bs, bs] (the rung), koM [bs, bs],
// b [Mi, bs], acc [bs, bs] (the start state in, row 0 of the end state
// out), xb the zeroed exchange entries (ops/thomas_prim.exchange_words).
// bs a multiple of 16, dinv 16-byte aligned.  Returns a cudaError_t
// (0 = launched): refused if the plan does not fit the layout the kernel
// carves or its blocks cannot all co-reside.
int thomas_prim(void* dinv, void* koM, void* b, void* acc, void* xb, int bs,
                int Mi, int reps, int mode, int nbuf, int rows, int tile_rows,
                int nslots, int slot_bytes, int smem, void* stream) {
  static const void* const kernels[] = {
      (const void*)prim_kernel<DMA>,   (const void*)prim_kernel<MV_SUB>,
      (const void*)prim_kernel<MV_LANE>, (const void*)prim_kernel<MV_MXU>,
      (const void*)prim_kernel<TRANS>, (const void*)prim_kernel<FWD>,
      (const void*)prim_kernel<DMAG>,  (const void*)prim_kernel<DMAQ>};
  const int grp = mode == DMAG ? nbuf : 1;
  const int q = mode == DMAQ ? nbuf : 1;
  if (mode < DMA || mode > DMAQ || nbuf < 1 || nbuf > 8 || bs < 16 ||
      bs % 16 || Mi < 1 || reps < 0 || rows < 1 || tile_rows < 1 ||
      tile_rows > rows || nslots < 1 || nslots > 8 ||
      nslots * q * 8 > kBarBytes || slot_bytes % kSlotAlign ||
      (size_t)slot_bytes < (size_t)grp * tile_rows * bs * sizeof(float))
    return (int)cudaErrorInvalidValue;
  const int want = (bs + rows - 1) / rows;
  const size_t need =
      kBarBytes + (size_t)nslots * slot_bytes +
      sizeof(float) * prim_floats(mode, bs, rows, tile_rows, want);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  const void* kernel = kernels[mode];
  int grid = 0;
  int e = probe::coop_grid(kernel, kThreads, smem, want, &grid);
  if (e != 0) return e;
  // the exchanges need every block resident at once
  if (grid < want) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p;
  p.chunk = map_chunk(bs);
  if (mode == DMAG) {
    e = encode_group_map(&p.tmap, (const float*)dinv, bs, Mi, tile_rows,
                         grp, p.chunk);
    if (e != 0) return e;
  }
  p.dinv = (const float*)dinv;
  p.koM = (const float*)koM;
  p.b = (const float*)b;
  p.acc = (float*)acc;
  p.xb = (unsigned long long*)xb;
  p.bs = bs;
  p.Mi = Mi;
  p.reps = reps;
  p.nbuf = nbuf;
  p.rows = rows;
  p.tile_rows = tile_rows;
  p.nslots = nslots;
  p.slot_bytes = slot_bytes;
  void* args[] = {&p};
  cudaError_t c = cudaLaunchCooperativeKernel(
      kernel, dim3(want), dim3(kThreads), args, smem, (cudaStream_t)stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

const char* thomas_prim_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
