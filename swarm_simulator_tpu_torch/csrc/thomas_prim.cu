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
// 21 MB at bs 2304) and, on a grid, one grid sync; the operations are
// 2 bs^2 per matvec at most.
//
// What the design does about it: every step moves the whole block from
// device memory into shared memory, as the TPU moves it into VMEM.  A block
// does not fit one SM's shared memory at bs >= 576, so the grid splits it
// by rows (block b owns rows [b * ceil(bs / G), ...)) and each block streams
// its rows in tiles of whole rows through a ring of `nslots` slots filled by
// 1-D TMA bulk copies on mbarriers (one thread issues them, up to nslots
// tiles ahead, across step boundaries).  The same code runs on one block
// (the TPU probe's single core) and on K2's first grid (ceil(bs / 24)
// cooperative blocks); every step ends in a grid sync on both, so the two
// differ in the sync's width and the rows per SM.  Sums over rows that
// cross blocks go through per-block partial rows, double-buffered by step
// parity, and are added in block order by every block that needs them
// after the sync.
#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBarBytes = 512;  // room for 64 mbarriers

enum Mode { DMA = 0, MV_SUB, MV_LANE, MV_MXU, TRANS, FWD, DMAG, DMAQ };

struct Params {
  const float* dinv;  // [Mi, bs, bs] the rung's pivot blocks
  const float* koM;   // [bs, bs]
  const float* b;     // [Mi, bs]
  float* acc;         // [bs, bs] the state, set by the caller
  float* part;        // [2, grid, bs] per-block partial rows
  int bs, Mi, reps, mode, nbuf, tile_rows;
};

__device__ __forceinline__ int nslots_of(int mode, int nbuf) {
  return (mode == DMAG || mode == DMAQ) ? 2 : nbuf;
}

__global__ void __launch_bounds__(kThreads) prim_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int bs = p.bs, Mi = p.Mi, mode = p.mode, nbuf = p.nbuf;
  const int tr = p.tile_rows;
  const int nslots = nslots_of(mode, nbuf);
  const int q = mode == DMAQ ? nbuf : 1;          // copies per tile
  const int nb = mode == DMAG ? nbuf : 1;         // blocks per step
  const int spr = mode == DMAG ? Mi / nbuf : Mi;  // steps per rep
  const long long S = (long long)p.reps * spr;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* tiles = reinterpret_cast<float*>(smem + kBarBytes);
  const size_t tile_elems = (size_t)tr * bs;
  float* vec = tiles + nslots * tile_elems;  // [bs] vrow, vcol or row 0
  float* part_s = vec + bs;                  // [bs] this block's partial row
  float* tvec = part_s + bs;                 // [tile_rows] t of fwd

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, bid = blockIdx.x;
  const int rpb = (bs + G - 1) / G;
  const int rb0 = bid * rpb < bs ? bid * rpb : bs;
  const int rb1 = rb0 + rpb < bs ? rb0 + rpb : bs;
  const int ntile = (rb1 - rb0 + tr - 1) / tr;
  const long long per_step = (long long)nb * ntile;
  const long long ntiles = S * per_step;
  const size_t blk = (size_t)bs * bs;

  if (tid == 0) {
    for (int i = 0; i < nslots * q; ++i) probe::mbar_init(&bars[i], 1);
    probe::mbar_fence_init();
  }
  for (int j = tid; j < bs; j += kThreads) {
    part_s[j] = 0.f;
    if (mode == MV_SUB)  // vcol of this block's rows (index r - rb0)
      vec[j] = j < rb1 - rb0 ? p.acc[(size_t)(rb0 + j) * bs] : 0.f;
    else
      vec[j] = p.acc[j];  // row 0
  }
  __syncthreads();

  // the pivot block that step s reads as its jb-th block
  auto block_of = [&](long long s, int jb) -> int {
    const int k = (int)(s % spr);
    return mode == DMAG ? k * nbuf + jb : k;
  };
  // thread 0 only: the copy of this block's i-th tile into slot i % nslots
  auto issue = [&](long long i) {
    const long long s = i / per_step;
    const int rem = (int)(i % per_step);
    const int jb = rem / ntile, t = rem % ntile;
    const int r0 = rb0 + t * tr;
    const int nr = rb1 - r0 < tr ? rb1 - r0 : tr;
    const int slot = (int)(i % nslots);
    const char* src = reinterpret_cast<const char*>(
        p.dinv + (size_t)block_of(s, jb) * blk + (size_t)r0 * bs);
    char* dst = reinterpret_cast<char*>(tiles + slot * tile_elems);
    const uint32_t bytes = (uint32_t)((size_t)nr * bs * sizeof(float));
    probe::fence_proxy_async();
    uint32_t off = 0;
    for (int c = 0; c < q; ++c) {
      const uint32_t n =
          c + 1 < q ? ((bytes / q) & ~15u) : bytes - off;
      uint64_t* bar = &bars[slot * q + c];
      probe::mbar_expect_tx(bar, n);
      if (n) probe::bulk_copy(dst + off, src + off, n, bar);
      off += n;
    }
  };

  if (tid == 0)
    for (long long i = 0; i < nslots && i < ntiles; ++i) issue(i);

  long long i = 0;  // this block's next tile
  for (long long s = 0; s < S; ++s) {
    const int par = (int)(s & 1), prev = par ^ 1;
    const float* pprev = p.part + (size_t)prev * G * bs;
    // ---- the state this step reads, from the step before ----
    if (s > 0) {
      if (mode == MV_SUB) {
        if (rb0 == 0 && rb1 > 0 && tid == 0) {
          float v = 0.f;
          for (int g = 0; g < G; ++g) v += __ldcg(pprev + (size_t)g * bs);
          vec[0] = v;
        }
      } else if (mode == MV_LANE) {
        if (tid == 0) vec[0] = __ldcg(pprev);
      } else if (mode == MV_MXU || mode == FWD) {
        const float* bk = p.b + (size_t)block_of(s - 1, 0) * bs;
        for (int j = tid; j < bs; j += kThreads) {
          float v = 0.f;
          for (int g = 0; g < G; ++g) v += __ldcg(pprev + (size_t)g * bs + j);
          vec[j] = mode == FWD ? bk[j] + v : v;
        }
      }
    }
    __syncthreads();

    for (int jb = 0; jb < nb; ++jb) {
      for (int t = 0; t < ntile; ++t, ++i) {
        const int slot = (int)(i % nslots);
        const uint32_t parity = (uint32_t)((i / nslots) & 1);
        for (int c = 0; c < q; ++c) probe::mbar_wait(&bars[slot * q + c], parity);
        const float* A = tiles + slot * tile_elems;
        const int r0 = rb0 + t * tr;
        const int nr = rb1 - r0 < tr ? rb1 - r0 : tr;

        if (mode == DMA || mode == DMAQ || mode == DMAG) {
          if (r0 == 0 && jb == 0)
            for (int j = tid; j < bs; j += kThreads) vec[j] += A[j];
        } else if (mode == MV_SUB) {
          for (int j = tid; j < bs; j += kThreads) {
            float v = part_s[j];
            for (int r = 0; r < nr; ++r)
              v = fmaf(A[(size_t)r * bs + j], vec[r0 - rb0 + r], v);
            part_s[j] = v;
          }
        } else if (mode == MV_LANE) {
          for (int r = warp; r < nr; r += kWarps) {
            float v = 0.f;
            for (int j = lane; j < bs; j += 32)
              v = fmaf(A[(size_t)r * bs + j], vec[j], v);
            v = probe::warp_sum(v);
            if (lane == 0) {
              if (r0 + r == 0)
                p.part[(size_t)par * G * bs] = v;  // vrow[0] of the next step
              else
                p.acc[(size_t)(r0 + r) * bs] = v;
            }
          }
        } else if (mode == MV_MXU) {
          const int g = lane >> 2, qd = lane & 3;
          for (int n0 = warp * 8; n0 < bs; n0 += kWarps * 8) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            for (int k0 = 0; k0 < nr; k0 += 16) {
              uint32_t a[4] = {0u, 0u, 0u, 0u}, bf[2];
              auto vr = [&](int k) {
                return k0 + k < nr ? vec[r0 + k0 + k] : 0.f;
              };
              auto ar = [&](int k) {
                return k0 + k < nr ? A[(size_t)(k0 + k) * bs + n0 + g] : 0.f;
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
              part_s[n0 + 2 * qd] += d[0];
              part_s[n0 + 2 * qd + 1] += d[1];
            }
          }
        } else if (mode == TRANS) {
          // acc[j, r0 + r] = 0.5 acc[j, r0 + r] + A[r, j]: r fastest, so a
          // thread group writes a contiguous run of acc's row j
          const int n = nr * bs;
          for (int e = tid; e < n; e += kThreads) {
            const int j = e / nr, r = e - j * nr;
            float* dst = p.acc + (size_t)j * bs + r0 + r;
            *dst = fmaf(0.5f, *dst, A[(size_t)r * bs + j]);
          }
        } else {  // FWD
          for (int r = warp; r < nr; r += kWarps) {
            float v = 0.f;
            for (int j = lane; j < bs; j += 32)
              v = fmaf(A[(size_t)r * bs + j], vec[j], v);
            v = probe::warp_sum(v);
            if (lane == 0) tvec[r] = v;
          }
          __syncthreads();
          for (int j = tid; j < bs; j += kThreads) {
            float v = part_s[j];
            for (int r = 0; r < nr; ++r)
              v = fmaf(tvec[r],
                       fmaf(1e-30f, A[(size_t)r * bs + j],
                            -p.koM[(size_t)(r0 + r) * bs + j]),
                       v);
            part_s[j] = v;
          }
        }
        __syncthreads();  // every thread is done with the slot
        if (tid == 0 && i + nslots < ntiles) issue(i + nslots);
      }
    }
    if (mode == MV_SUB || mode == MV_MXU || mode == FWD) {
      float* pout = p.part + ((size_t)par * G + bid) * bs;
      for (int j = tid; j < bs; j += kThreads) {
        pout[j] = part_s[j];
        part_s[j] = 0.f;
      }
    }
    grid.sync();
  }

  // ---- row 0 of the final state ----
  if (bid != 0 || S == 0) return;
  const int last = (int)((S - 1) & 1);
  const float* plast = p.part + (size_t)last * G * bs;
  if (mode == DMA || mode == DMAQ || mode == DMAG) {
    for (int j = tid; j < bs; j += kThreads) p.acc[j] = vec[j];
  } else if (mode == MV_LANE) {
    if (tid == 0) p.acc[0] = __ldcg(plast);
  } else if (mode != TRANS) {
    const float* bk = p.b + (size_t)block_of(S - 1, 0) * bs;
    for (int j = tid; j < bs; j += kThreads) {
      float v = 0.f;
      for (int g = 0; g < G; ++g) v += __ldcg(plast + (size_t)g * bs + j);
      p.acc[j] = mode == FWD ? bk[j] + v : v;
    }
  }
}

size_t smem_bytes(int mode, int nbuf, int bs, int tile_rows) {
  const int nslots = (mode == DMAG || mode == DMAQ) ? 2 : nbuf;
  return kBarBytes + (size_t)nslots * tile_rows * bs * sizeof(float) +
         (size_t)(2 * bs + tile_rows) * sizeof(float);
}

}  // namespace

extern "C" {

// The blocks thomas_prim launches for `want` (1, or K2's first ceil(bs / 24)),
// capped at what can co-reside, through `grid`; returns a cudaError_t.
int thomas_prim_grid(int mode, int nbuf, int bs, int tile_rows, int want,
                     int* grid) {
  return probe::coop_grid((const void*)prim_kernel, kThreads,
                          smem_bytes(mode, nbuf, bs, tile_rows), want, grid);
}

// One cooperative launch of REPS x steps of `mode` on `grid` blocks (from
// thomas_prim_grid): dinv [Mi, bs, bs] (the rung), koM [bs, bs], b [Mi, bs],
// acc [bs, bs] (the start state in, row 0 of the end state out), part
// [2, grid, bs] scratch.  bs a multiple of 16, dinv 16-byte aligned.
// Returns a cudaError_t (0 = launched).
int thomas_prim(void* dinv, void* koM, void* b, void* acc, void* part, int bs,
                int Mi, int reps, int mode, int nbuf, int tile_rows, int grid,
                void* stream) {
  if (mode < DMA || mode > DMAQ || nbuf < 1 || nbuf > 8 || bs < 16 ||
      bs % 16 || Mi < 1 || reps < 0 || tile_rows < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(mode, nbuf, bs, tile_rows);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)prim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.dinv = (const float*)dinv;
  p.koM = (const float*)koM;
  p.b = (const float*)b;
  p.acc = (float*)acc;
  p.part = (float*)part;
  p.bs = bs;
  p.Mi = Mi;
  p.reps = reps;
  p.mode = mode;
  p.nbuf = nbuf;
  p.tile_rows = tile_rows;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)prim_kernel, dim3(grid),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* thomas_prim_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
