// Block-tridiagonal (Thomas) solves for Hopper (sm_90a): K2, one full
// solve x = K(rho_r)^-1 b, and K3a/K3b, the forward and backward sweeps
// over one knot chunk of the cross-device pipeline.
//
// K2 replaces the Pallas TPU kernel swarm_simulator_tpu/ops/pallas_thomas.py
// ::_kernel (thomas_solve_pallas): the KKT solve of the knot-state ADMM
// against one rung's stored pivot inverses.  With y_0 = b_0,
//   forward   T_k = Dinv_k y_k,  y_{k+1} = b_{k+1} - (I (x) Ho_k)^T T_k
//   backward  x_{Mi-1} = T_{Mi-1},
//             x_k = Dinv_k (y_k - (I (x) Ho_k) x_{k+1})
// over Mi interior knots, blocks of bs = B3*phi rows (row index
// (agent*3 + axis)*phi + derivative order), Ho_k [phi, phi] per knot.
//
// K3a / K3b replace pallas_thomas.py::_chunk_fwd_kernel / _chunk_bwd_kernel
// (thomas_chunk_fwd / thomas_chunk_bwd).  A chunk holds L knots of the
// chain; kin_j couples the previous knot into knot j, kout_j knot j into
// the next (zero at the chain's ends and on pad knots):
//   K3a  y_j = b_j - (I (x) kin_j)^T T_{j-1}  (T_{-1} = t_in, the carry),
//        T_j = Dinv_j y_j; writes T (the carry out is T_{L-1})
//   K3b  x_j = T_j - Dinv_j (I (x) kout_j) x_{j+1}  (x_L = x_in),
//        writes x (the carry out is x_0)
//
// What bounds them on an H100: a chain of strictly dependent
// [bs] x [bs, bs] matvecs (K2: 2*Mi - 1 of them; K3a and K3b: L each).  At
// 64 agents (bs = 576) one pivot block is 1.33 MB, so K2 reads 91.6 MB
// (27 us at 3.35 TB/s) and a 35-knot chunk sweep 46.4 MB (14 us): the
// latency of a chain stage (the barrier between dependent stages, the
// rows' arrival, the dot), not the bytes, sets the time.  At 256 agents
// (bs = 2304) a stage moves 21.2 MB, ~6.3 us at the HBM rate, and the
// stream of rows does.
//
// K2's design (csrc/chain_ring.cuh; its kernel body, the template
// csrc/thomas_chain.cuh, also runs T1's P4): a persistent cooperative grid of
// chain blocks, one per SM at most, block c owning gpb whole row groups of
// every knot, so its rows of a stage are one contiguous span.  The rows
// of a stage do not depend on the chain, only the vector does: each block
// streams its spans through a TMA ring (1-D bulk copies on an mbarrier per
// slot) that runs ahead of the chain, the copies of the next stages in
// flight while the block waits for the vector and takes the dot of the
// current one.  Each warp takes whole rows of the landed tile against the
// stage's vector, both from shared memory, in float32 FMA (bf16 pivots
// widened at the FMA, 8 a 16-byte load).  The block that owns a row group
// also forms the NEXT stage's vector entries of it (the small coupling
// block Ho, and the y rows it keeps in shared memory) and stores them
// tagged with the stage, to a parity-buffered vector in global memory;
// every block then loads the whole vector once all its entries carry the
// stage's tag.  So a stage costs one L2 round trip after its last entry
// lands, no barrier, and the dot of the block's few rows.  The ring's
// tile plan (groups per block, rows per tile, slots) comes from
// ops/thomas.ring_plan.  Ho is read per knot (no uniform-duration rule)
// and the pivots stay flat and unpadded; they are NOT assumed symmetric
// (the device prep's LU-plus-Newton inverses are not): every product is
// Dinv_k @ v.
//
// K3a and K3b run on the same ring, one kernel template: ring.Mi =
// ring.nstage = L, stage s streams knot s (K3a, the forward order) or knot
// L - 1 - s (K3b, the backward order), and the chunk's L stages pass the
// vector in tagged entries with no barrier between knots.  Stage 0's
// vector is formed whole by every block from the carry: b_0 less the
// coupling of t_in (K3a), (I (x) kout_{L-1}) x_in (K3b).  The owner of a
// row group then stores its result (T_s, or x_k = T_k less its dot) and
// the next stage's entries of it.  What a stage's rows need besides the
// dot (K3a: b_{s+1}'s rows and kin_{s+1}; K3b: T_k's rows and
// kout_{k-1}) is loaded, where the chain's latency sets the pace (a
// block's rows of a stage fit one ring slot), into registers before the
// block waits for the vector, so its latency passes with the wait; where
// the stream sets it (the rows stream in several tiles a stage), after
// the dot (chunk_ring picks).  They are K2's forward half with a carry
// in, so the same things bound them: the latency of a chain stage at 64
// agents (a 35-knot chunk reads 46.4 MB, 14 us at the HBM rate), the row
// stream at 256.  Beside the ring a block keeps the vector and its
// products, no rows of earlier knots (ops/thomas.chunk_plan).
#include "thomas_chain.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = chain::kThreads;
constexpr int kMaxPhi = chain::kMaxPhi;

// K3a / K3b: one chunk's sweep on the chain ring (the note above)
struct ChunkParams {
  const float* dinv;         // [L, bs, bs] pivot inverses, the chunk's knots
  const float* kc;           // [L, phi, phi] couplings: kin (K3a), kout (K3b)
  const float* v;            // [L, bs]: b (K3a), T (K3b)
  const float* carry;        // [bs]: t_in (K3a), x_in (K3b)
  unsigned long long* vbuf;  // [2, bs] scratch: tagged vector entries
  float* out;                // [L, bs]: T (K3a), x (K3b)
  int B3, L, phi, gpb, tile_rows, nslots;
};

template <bool kBack, bool kEarly>
__global__ void __launch_bounds__(kThreads)
    chunk_kernel(const ChunkParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int phi = p.phi, L = p.L, bs = p.B3 * phi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = p.gpb * phi;

  chain::RowRing<float, kBack ? chain::kBackward : chain::kForward> ring;
  ring.dinv = p.dinv;
  ring.bs = bs;
  ring.Mi = L;
  ring.r0 = min((int)blockIdx.x * rows, bs);
  ring.r1 = min(ring.r0 + rows, bs);
  ring.tile_rows = p.tile_rows;
  ring.nslots = p.nslots;
  ring.ntile = (ring.r1 - ring.r0 + p.tile_rows - 1) / p.tile_rows;
  ring.nstage = L;
  ring.ntiles = (long long)L * ring.ntile;
  ring.aligned = bs % 4 == 0;
  float* vec = reinterpret_cast<float*>(ring.carve(smem));  // [bs]
  // [rows] this stage's products of the block (K3b: then its x_k)
  float* tv = vec + bs;
  const int r0 = ring.r0, nrows = ring.r1 - ring.r0;

  if (tid == 0) ring.start();
  for (int j = blockIdx.x * kThreads + tid; j < 2 * bs;
       j += gridDim.x * kThreads)
    p.vbuf[j] = 0ull;
  // no entry carries a tag yet, for every block
  cg::this_grid().sync();

  long long i = 0;  // this block's next tile
  for (int s = 0; s < L; ++s) {
    const int k = ring.knot_of(s);
    const int kn = kBack ? k - 1 : k + 1;  // the next stage's knot
    const bool more = s + 1 < L;
    // the coupling of the next stage's entries: K3a kin_{s+1}, K3b
    // kout_{k-1}
    const float* Hn = p.kc + (size_t)(more ? kn : k) * phi * phi;
    // ---- kEarly: loaded into registers before the wait, used after the
    // dot (so neither waits on the other): thread e's row of the
    // right-hand side the stage needs (K3a b_{s+1}, K3b T_k) and its
    // row's coupling entries (K3a kin_{s+1}[:, a], K3b kout_{k-1}[a, :]);
    // rows past the first kThreads load theirs when they are used ----
    const int a0 = tid % phi;
    float pre = 0.f, h[kMaxPhi];
    if (kEarly && tid < nrows && (kBack || more))
      pre = __ldg(p.v + (size_t)(kBack ? k : kn) * bs + r0 + tid);
#pragma unroll
    for (int q = 0; q < kMaxPhi; ++q)
      h[q] = kEarly && more && q < phi && tid < nrows
                 ? __ldg(Hn + (kBack ? a0 * phi + q : q * phi + a0))
                 : 0.f;
    // ---- the stage's vector ----
    if (s == 0) {  // K3a: b_0 - (I (x) kin_0)^T t_in; K3b: (I (x) kout) x_in
      const float* H = p.kc + (size_t)k * phi * phi;
      for (int j = tid; j < bs; j += kThreads) {
        const int a = j % phi;
        const float* cg0 = p.carry + (j - a);  // the carry's row group
        float c = 0.f;
        for (int q = 0; q < phi; ++q)
          c = fmaf(__ldg(H + (kBack ? a * phi + q : q * phi + a)),
                   __ldg(cg0 + q), c);
        vec[j] = kBack ? c : __ldg(p.v + j) - c;
      }
      __syncthreads();
    } else {
      chain::gather_tagged(p.vbuf + (size_t)(s & 1) * bs, vec, bs,
                           (unsigned)s);
    }
    // ---- the block's rows of Dinv_k against it ----
    for (int t = 0; t < ring.ntile; ++t, ++i) {
      int row0, nr;
      const float* A = ring.acquire(i, &row0, &nr);
      for (int r = warp; r < nr; r += chain::kWarps) {
        const float v = chain::dot_shared(A + (size_t)r * bs, vec, bs, lane,
                                          ring.aligned);
        if (lane == 0) tv[row0 + r] = v;
      }
      ring.release(i);
    }
    // ---- each owned row: its result (K3a T_s; K3b x_k = T_k - dot, kept
    // in tv for the row group's entries), and its entry of the next
    // vector: K3a y_{s+1} = b_{s+1} - (I (x) kin_{s+1})^T T_s, K3b
    // (I (x) kout_{k-1}) x_k ----
    if (kBack) {
      for (int e = tid; e < nrows; e += kThreads) {
        const float T = kEarly && e < kThreads
                            ? pre
                            : __ldg(p.v + (size_t)k * bs + r0 + e);
        tv[e] = T - tv[e];
        p.out[(size_t)k * bs + r0 + e] = tv[e];
      }
      __syncthreads();
    }
    for (int e = tid; e < nrows; e += kThreads) {
      const int a = e % phi, g0 = e - a;  // the row group's first row
      if (!kBack) p.out[(size_t)k * bs + r0 + e] = tv[e];
      if (!more) continue;
      float c = 0.f, bn = 0.f;
      if (kEarly) {
        const bool mine = e < kThreads;  // loaded before the wait
#pragma unroll
        for (int q = 0; q < kMaxPhi; ++q)  // unrolled: h stays in registers
          if (q < phi)
            c = fmaf(mine ? h[q]
                          : __ldg(Hn + (kBack ? a * phi + q : q * phi + a)),
                     tv[g0 + q], c);
        bn = kBack ? 0.f
                   : (mine ? pre : __ldg(p.v + (size_t)kn * bs + r0 + e));
      } else {
        for (int q = 0; q < phi; ++q)
          c = fmaf(Hn[kBack ? a * phi + q : q * phi + a], tv[g0 + q], c);
        if (!kBack) bn = __ldg(p.v + (size_t)kn * bs + r0 + e);
      }
      chain::put_tagged(p.vbuf + (size_t)((s + 1) & 1) * bs + r0 + e,
                        kBack ? c : bn - c, (unsigned)(s + 1));
    }
    __syncthreads();  // vec and tv are rewritten by the next stage
  }
}

// K2 on pivots of type T: the ring plan (gpb, tile_rows, nslots, smem) of
// ops/thomas.ring_plan, one period, Ho per knot (chain::launch_solve
// refuses what the plan or the card cannot take)
template <typename T>
int solve_as(void* dinv, void* ho, void* b, void* vbuf, void* x, int B3,
             int Mi, int phi, int gpb, int tile_rows, int nslots, int smem,
             void* stream) {
  chain::SolveParams<T> p;
  p.dinv = (const T*)dinv;
  p.ho = (const float*)ho;
  p.b = (const float*)b;
  p.vbuf = (unsigned long long*)vbuf;
  p.x = (float*)x;
  p.B3 = B3;
  p.Mi = Mi;
  p.phi = phi;
  p.gpb = gpb;
  p.tile_rows = tile_rows;
  p.nslots = nslots;
  p.ho_stride = phi * phi;
  p.nperiod = 1;
  p.resident = 0;
  return chain::launch_solve<T, false, false>(p, smem, (cudaStream_t)stream);
}

// K3a / K3b: the ring plan (gpb, tile_rows, nslots, smem) of
// ops/thomas.chunk_plan, one block per gpb row groups; refused as K2's is.
// The loads a stage's results need go before the vector's wait where a
// block's rows of a stage fit one slot (the chain's latency sets the
// pace, as at 64 agents), after the dot where they stream in several
// tiles (the stream does, as at 256 agents, where the early loads made
// both sweeps 3-4% slower on an H100).
template <bool kBack>
int chunk_ring(ChunkParams p, int smem, void* stream) {
  if (p.phi < 1 || p.phi > kMaxPhi || p.L < 1 || p.B3 < 1 || p.gpb < 1 ||
      p.tile_rows < 1 || p.tile_rows > p.gpb * p.phi || p.nslots < 1 ||
      p.nslots > chain::kMaxSlots)
    return (int)cudaErrorInvalidValue;
  const int bs = p.B3 * p.phi, rows = p.gpb * p.phi;
  const size_t need =
      chain::kBarBytes +
      p.nslots * chain::slot_bytes(p.tile_rows, bs, sizeof(float)) +
      sizeof(float) * ((size_t)bs + rows);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  const int want = (p.B3 + p.gpb - 1) / p.gpb;
  const void* kernel = p.tile_rows >= rows
                           ? (const void*)chunk_kernel<kBack, true>
                           : (const void*)chunk_kernel<kBack, false>;
  int grid = 0;
  int e = probe::coop_grid(kernel, kThreads, smem, want, &grid);
  if (e != 0) return e;
  // the chain needs every block of the plan resident at once
  if (grid < want) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  cudaError_t c = cudaLaunchCooperativeKernel(
      kernel, dim3(want), dim3(kThreads), args, smem, (cudaStream_t)stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

// K3a's / K3b's operands as ChunkParams (their entry points below)
ChunkParams chunk_params(void* dinv, void* kc, void* v, void* carry,
                         void* vbuf, void* out, int B3, int L, int phi,
                         int gpb, int tile_rows, int nslots) {
  ChunkParams p;
  p.dinv = (const float*)dinv;
  p.kc = (const float*)kc;
  p.v = (const float*)v;
  p.carry = (const float*)carry;
  p.vbuf = (unsigned long long*)vbuf;
  p.out = (float*)out;
  p.B3 = B3;
  p.L = L;
  p.phi = phi;
  p.gpb = gpb;
  p.tile_rows = tile_rows;
  p.nslots = nslots;
  return p;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a cudaError_t
// (0 = launched): the cooperative-launch error, or cudaGetLastError()
// after it.  `dinv` points at the rung's pivots.

// K2: x [Mi, bs] = K^-1 b; `vbuf` is [2, bs] 64-bit scratch; gpb,
// tile_rows, nslots and smem are the ring plan of ops/thomas.ring_plan.
int thomas_solve(void* dinv, void* ho, void* b, void* vbuf, void* x, int B3,
                 int Mi, int phi, int gpb, int tile_rows, int nslots,
                 int smem, void* stream) {
  return solve_as<float>(dinv, ho, b, vbuf, x, B3, Mi, phi, gpb, tile_rows,
                         nslots, smem, stream);
}

// K2 on bf16 pivots (`dinv` [Mi, bs, bs] bf16; ho, b, x float32).
int thomas_solve_bf16(void* dinv, void* ho, void* b, void* vbuf, void* x,
                      int B3, int Mi, int phi, int gpb, int tile_rows,
                      int nslots, int smem, void* stream) {
  return solve_as<__nv_bfloat16>(dinv, ho, b, vbuf, x, B3, Mi, phi, gpb,
                                 tile_rows, nslots, smem, stream);
}

// K3a / K3b on `stream`, one chunk's sweep: K3a T [L, bs] from b [L, bs],
// the couplings kin [L, phi, phi] and the carry t_in [bs]; K3b x [L, bs]
// from K3a's T, the couplings kout and the carry x_in.  `vbuf` is [2, bs]
// 64-bit scratch; gpb, tile_rows, nslots and smem are the ring plan of
// ops/thomas.chunk_plan.
int thomas_chunk_fwd(void* dinv, void* kin, void* b, void* t_in, void* vbuf,
                     void* T, int B3, int L, int phi, int gpb, int tile_rows,
                     int nslots, int smem, void* stream) {
  return chunk_ring<false>(chunk_params(dinv, kin, b, t_in, vbuf, T, B3, L,
                                        phi, gpb, tile_rows, nslots),
                           smem, stream);
}

int thomas_chunk_bwd(void* dinv, void* kout, void* T, void* x_in, void* vbuf,
                     void* x, int B3, int L, int phi, int gpb, int tile_rows,
                     int nslots, int smem, void* stream) {
  return chunk_ring<true>(chunk_params(dinv, kout, T, x_in, vbuf, x, B3, L,
                                       phi, gpb, tile_rows, nslots),
                          smem, stream);
}

const char* thomas_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
