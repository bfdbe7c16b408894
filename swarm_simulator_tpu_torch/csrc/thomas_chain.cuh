// The block-Thomas solve on the chain ring (csrc/chain_ring.cuh), one
// kernel template shared by K2 (csrc/thomas.cu) and T1's P4
// (csrc/nsfused_probe.cu) on Hopper (sm_90a).
//
// Over Mi knots of [bs, bs] pivot blocks Dinv_k (bs = B3 * phi, row groups
// of phi rows) and coupling blocks H (I_B3 (x) H between neighbours), with
// y_0 = b_0, both forms run the forward sweep
//   T_k = Dinv_k y_k,  y_{k+1} = b_{k+1} - (I (x) H_k)^T T_k
// and a back substitution from x_{Mi-1} = T_{Mi-1}:
//   K2 form (kTForm false)  x_k = Dinv_k (y_k - (I (x) H_k) x_{k+1}),
//                           the y rows kept
//   P4 form (kTForm true)   x_k = T_k - Dinv_k (I (x) H_k) x_{k+1},
//                           the T rows kept
// H_k is the block `ho_stride` floats on from the previous knot's (K2 one
// per knot, P4 one for all, stride 0).  With kPeriodic the chain runs
// `nperiod` times in one launch, each period a whole solve from b (P4's
// iterations; K2 runs one): the ring streams the rows of every period
// without a break,
// and the vector passes in stage-tagged entries with no barrier between
// stages or periods.  The tags count the stages of the whole launch.  A
// period's first stage reads b_0 and no exchange, so a block may form the
// entries of a period's second stage while a slower one still reads the
// last stage's: the entries rotate over three buffers when periodic (two
// for one period, as chain_ring.cuh argues).
//
// P4 may also keep its rows of the last `resident` knots in shared memory,
// loaded once by bulk copies on their own mbarrier: those knots' stages
// (Mi - resident .. Mi + resident - 2, the turn of the chain) read shared
// memory with no copy, and the ring streams the other stages only
// (RowRing's skipped range).  P4's ring is refilled by the block's last
// thread, which owns no row (RowRing's kIssueLast); K2's by thread 0.
//
// Shared memory, from the front: the ring's barriers (the resident copies'
// barrier is the one after the ring's kMaxSlots), the slots, the resident
// rows [resident, rows, bs], the vector [bs], the stage's products
// [rows], the kept rows [Mi, rows] (y or T).
#pragma once

#include "chain_ring.cuh"

namespace chain {

constexpr int kMaxPhi = 4;

template <typename T>
struct SolveParams {
  const T* dinv;    // [Mi, bs, bs] pivot inverses of the rung
  const float* ho;  // coupling blocks [phi, phi], ho_stride floats apart
  const float* b;   // [Mi, bs]
  unsigned long long* vbuf;  // [nbuf, bs] scratch: tagged vector entries
  float* x;                  // [Mi, bs] solution
  int B3, Mi, phi, gpb, tile_rows, nslots;
  int ho_stride;  // floats from one knot's coupling block to the next
  int nperiod;    // solves in one launch, each from b (kPeriodic; else 1)
  int resident;   // knots whose rows stay in shared memory (kTForm only)
};

// vector buffers of the tagged entries: three for a periodic chain
__host__ __device__ constexpr int solve_buffers(bool periodic) {
  return periodic ? 3 : 2;
}

// dynamic shared memory a block needs (ops/thomas.ring_plan computes the
// same with hist_knots = Mi)
template <typename T>
inline size_t solve_smem(const SolveParams<T>& p) {
  const int bs = p.B3 * p.phi, rows = p.gpb * p.phi;
  return kBarBytes + p.nslots * slot_bytes(p.tile_rows, bs, sizeof(T)) +
         (size_t)p.resident * rows * bs * sizeof(T) +
         sizeof(float) * ((size_t)bs + rows + (size_t)p.Mi * rows);
}

template <typename T, bool kTForm, bool kPeriodic>
__global__ void __launch_bounds__(kThreads) solve_kernel(const SolveParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int phi = p.phi, Mi = p.Mi, bs = p.B3 * phi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nstage = 2 * Mi - 1;
  const int rows = p.gpb * phi;
  // the resident knots Mi - h .. Mi - 1 are the stages kres0 .. kres0 +
  // nskip - 1 of every period
  const int h = kTForm ? p.resident : 0;
  const int kres0 = Mi - h, nskip = h > 0 ? 2 * h - 1 : 0;
  const int nperiod = kPeriodic ? p.nperiod : 1;
  constexpr int nbuf = solve_buffers(kPeriodic);

  RowRing<T, kForwardBack, kTForm, kTForm> ring;
  ring.dinv = p.dinv;
  ring.bs = bs;
  ring.Mi = Mi;
  ring.r0 = min((int)blockIdx.x * rows, bs);
  ring.r1 = min(ring.r0 + rows, bs);
  ring.tile_rows = p.tile_rows;
  ring.nslots = p.nslots;
  ring.ntile = (ring.r1 - ring.r0 + p.tile_rows - 1) / p.tile_rows;
  ring.nstage = nstage - nskip;
  ring.skip0 = kres0;
  ring.nskip = nskip;
  ring.ntiles = (long long)nperiod * ring.nstage * ring.ntile;
  ring.aligned = (bs * (int)sizeof(T)) % 16 == 0;
  T* res = reinterpret_cast<T*>(ring.carve(smem));  // [h, rows, bs]
  float* vec = reinterpret_cast<float*>(res + (size_t)h * rows * bs);
  float* tv = vec + bs;     // [rows] this stage's products of the block
  float* hist = tv + rows;  // [Mi, rows] the block's y_k (K2) or T_k (P4)
  uint64_t* resbar = ring.bars + kMaxSlots;
  const int r0 = ring.r0, nrows = ring.r1 - ring.r0;

  if (tid == 0) {
    if (kTForm && h > 0) probe::mbar_init(resbar, 1);
    ring.start();  // its fence publishes resbar's initialisation too
    if (kTForm && h > 0) {
      const uint32_t span = (uint32_t)(nrows * bs * sizeof(T));
      probe::mbar_expect_tx(resbar, span * h);
      for (int j = 0; j < h; ++j)
        probe::bulk_copy(res + (size_t)j * rows * bs,
                         p.dinv + ((size_t)(kres0 + j) * bs + r0) * bs, span,
                         resbar);
    }
  }
  for (int j = blockIdx.x * kThreads + tid; j < nbuf * bs;
       j += gridDim.x * kThreads)
    p.vbuf[j] = 0ull;
  // no entry carries a tag yet, for every block
  cooperative_groups::this_grid().sync();

  long long i = 0;  // this block's next tile
  int cur = 0;      // the buffer of this stage's vector: its stage mod nbuf
  for (int it = 0; it < nperiod; ++it) {
    for (int s = 0; s < nstage; ++s) {
      const unsigned tag = (unsigned)(it * nstage + s);
      const int nxt = cur + 1 == nbuf ? 0 : cur + 1;
      const int k = ring.knot_of(s);
      // ---- the stage's vector: b_0, then what the last stage formed ----
      if (s == 0) {
        for (int j = tid; j < bs; j += kThreads) vec[j] = __ldg(p.b + j);
        __syncthreads();
      } else {
        gather_tagged(p.vbuf + (size_t)cur * bs, vec, bs, tag);
      }
      // ---- the block's rows of Dinv_k against it ----
      if (kTForm && k >= kres0) {  // resident rows
        if (it == 0 && s == kres0) probe::mbar_wait(resbar, 0);
        const T* A = res + (size_t)(k - kres0) * rows * bs;
        for (int r = warp; r < nrows; r += kWarps) {
          const float v =
              dot_shared(A + (size_t)r * bs, vec, bs, lane, ring.aligned);
          if (lane == 0) tv[r] = v;
        }
        __syncthreads();
      } else {
        for (int t = 0; t < ring.ntile; ++t, ++i) {
          int row0, nr;
          const T* A = ring.acquire(i, &row0, &nr);
          for (int r = warp; r < nr; r += kWarps) {
            const float v =
                dot_shared(A + (size_t)r * bs, vec, bs, lane, ring.aligned);
            if (lane == 0) tv[row0 + r] = v;
          }
          ring.release(i);
        }
      }
      // ---- each owned row: its result, and its entry of the next vector ----
      const float* H = nullptr;  // the coupling of the next stage's vector
      if (s < Mi - 1) H = p.ho + (size_t)k * p.ho_stride;  // H_k^T T_k
      else if (k > 0) H = p.ho + (size_t)(k - 1) * p.ho_stride;  // H_{k-1} x_k
      if (kTForm && s >= Mi) {  // x_k = T_k - Dinv_k (I (x) H_k) x_{k+1}
        for (int e = tid; e < nrows; e += kThreads)
          tv[e] = hist[(size_t)k * rows + e] - tv[e];
        __syncthreads();
      }
      for (int e = tid; e < nrows; e += kThreads) {
        const int a = e % phi;
        const float* tg = tv + (e - a);  // the row group's T_k or x_k
        float next = 0.f;
        if (s < Mi - 1) {  // forward: y_{k+1} = b_{k+1} - (I (x) H_k)^T T_k
          if (kTForm) hist[(size_t)k * rows + e] = tg[a];  // T_k
          else if (k == 0) hist[e] = vec[r0 + e];          // y_0 = b_0
          float c = 0.f;
          for (int q = 0; q < phi; ++q) c = fmaf(H[q * phi + a], tg[q], c);
          next = __ldg(p.b + (size_t)(k + 1) * bs + r0 + e) - c;
          if (!kTForm) hist[(size_t)(k + 1) * rows + e] = next;
        } else {  // x_k; then (K2) y_{k-1} less, or (P4) just, H_{k-1} x_k
          p.x[(size_t)k * bs + r0 + e] = tg[a];
          if (k > 0) {
            float c = 0.f;
            for (int q = 0; q < phi; ++q) c = fmaf(H[a * phi + q], tg[q], c);
            next = kTForm ? c : hist[(size_t)(k - 1) * rows + e] - c;
          }
        }
        if (s + 1 < nstage)
          put_tagged(p.vbuf + (size_t)nxt * bs + r0 + e, next, tag + 1);
      }
      __syncthreads();  // vec and tv are rewritten by the next stage
      cur = nxt;
    }
  }
}

// One launch of the solve on the ring plan in `p` (gpb, tile_rows,
// nslots: ops/thomas.ring_plan; `smem` its bytes), one block per gpb row
// groups; refused if the plan does not fit the layout the kernel carves,
// the resident rows are not whole 16-byte lines, or the grid cannot
// co-reside.  Returns a cudaError_t (0 = launched).
template <typename T, bool kTForm, bool kPeriodic>
int launch_solve(const SolveParams<T>& p, int smem, cudaStream_t stream) {
  if (p.phi < 1 || p.phi > kMaxPhi || p.Mi < 1 || p.B3 < 1 || p.gpb < 1 ||
      p.tile_rows < 1 || p.tile_rows > p.gpb * p.phi || p.nslots < 1 ||
      p.nslots > kMaxSlots || p.nperiod < 1 ||
      (!kPeriodic && p.nperiod != 1) || p.ho_stride < 0 ||
      p.resident < 0 || p.resident > p.Mi || (!kTForm && p.resident))
    return (int)cudaErrorInvalidValue;
  const int bs = p.B3 * p.phi;
  if (p.resident && (bs * sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  if ((size_t)smem < solve_smem(p)) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)solve_kernel<T, kTForm, kPeriodic>;
  const int want = (p.B3 + p.gpb - 1) / p.gpb;
  int grid = 0;
  int e = probe::coop_grid(kernel, kThreads, smem, want, &grid);
  if (e != 0) return e;
  // the chain needs every block of the plan resident at once
  if (grid < want) return (int)cudaErrorCooperativeLaunchTooLarge;
  SolveParams<T> q = p;
  void* args[] = {&q};
  cudaError_t c = cudaLaunchCooperativeKernel(kernel, dim3(want),
                                              dim3(kThreads), args, smem,
                                              stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

}  // namespace chain
