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
// K2's design (csrc/chain_ring.cuh): a persistent cooperative grid of
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
// K3a runs on the same ring: ring.Mi = ring.nstage = L, so stage s
// streams knot s, and the chunk's L forward stages pass the vector in
// tagged entries with no barrier; stage 0's vector (b_0 less the carry's
// coupling) is formed whole by every block from the operands.  It is K2's
// forward half with a carry in, so the same things bound it: the latency
// of a chain stage at 64 agents (a 35-knot chunk reads 46.4 MB, 14 us at
// the HBM rate), the row stream at 256.  The ring plan keeps no rows for
// a back sweep (ops/thomas.ring_plan with hist_knots = 0).
//
// K3b keeps the first design: one warp per (agent, axis) row group on
// ceil(B3 / 8) cooperative blocks, coalesced row reads from device memory
// into registers, one grid sync per chain step.  The sync and the
// register row reads of every knot, not the bytes, bound it (~6.6 us a
// stage at 64 agents on an H100 80GB HBM3 at 700 W, PERF.md).
#include "chain_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = chain::kThreads;
constexpr int kMaxPhi = 4;

// dot(row of length n in device memory, shared vector); every lane
// returns the full sum
__device__ __forceinline__ float row_dot(const float* __restrict__ row,
                                         const float* vec, int n, int lane,
                                         bool vec4) {
  float s = 0.f;
  if (vec4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(vec);
    for (int j = lane; j < (n >> 2); j += 32) {
      float4 a = __ldg(r4 + j);
      float4 b = v4[j];
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
  } else {
    for (int j = lane; j < n; j += 32) s = fmaf(__ldg(row + j), vec[j], s);
  }
  return probe::warp_sum(s);
}

template <typename T>
struct Params {
  const T* dinv;    // [Mi, bs, bs] pivot inverses of the rung
  const float* ho;  // [Mi-1, phi, phi]
  const float* b;   // [Mi, bs]
  unsigned long long* vbuf;  // [2, bs] scratch: tagged vector entries
  float* x;                  // [Mi, bs] solution
  int B3, Mi, phi, gpb, tile_rows, nslots;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int phi = p.phi, Mi = p.Mi, bs = p.B3 * phi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nstage = 2 * Mi - 1;
  const int rows = p.gpb * phi;

  chain::RowRing<T> ring;
  ring.dinv = p.dinv;
  ring.bs = bs;
  ring.Mi = Mi;
  ring.r0 = min((int)blockIdx.x * rows, bs);
  ring.r1 = min(ring.r0 + rows, bs);
  ring.tile_rows = p.tile_rows;
  ring.nslots = p.nslots;
  ring.ntile = (ring.r1 - ring.r0 + p.tile_rows - 1) / p.tile_rows;
  ring.nstage = nstage;
  ring.ntiles = (long long)nstage * ring.ntile;
  ring.aligned = (bs * (int)sizeof(T)) % 16 == 0;
  float* vec = reinterpret_cast<float*>(ring.carve(smem));  // [bs]
  float* tv = vec + bs;    // [rows] this stage's products of the block
  float* ysh = tv + rows;  // [Mi, rows] the block's forward rows y_k
  const int r0 = ring.r0, nrows = ring.r1 - ring.r0;

  if (tid == 0) ring.start();
  for (int j = blockIdx.x * kThreads + tid; j < 2 * bs;
       j += gridDim.x * kThreads)
    p.vbuf[j] = 0ull;
  // no entry carries a tag yet, for every block
  cg::this_grid().sync();

  long long i = 0;  // this block's next tile
  for (int s = 0; s < nstage; ++s) {
    const int k = ring.knot_of(s);
    // ---- the stage's vector: b_0, then what the last stage formed ----
    if (s == 0) {
      for (int j = tid; j < bs; j += kThreads) vec[j] = __ldg(p.b + j);
      __syncthreads();
    } else {
      chain::gather_tagged(p.vbuf + (size_t)(s & 1) * bs, vec, bs,
                           (unsigned)s);
    }
    // ---- the block's rows of Dinv_k against it ----
    for (int t = 0; t < ring.ntile; ++t, ++i) {
      int row0, nr;
      const T* A = ring.acquire(i, &row0, &nr);
      for (int r = warp; r < nr; r += chain::kWarps) {
        const float v = chain::dot_shared(A + (size_t)r * bs, vec, bs, lane,
                                          ring.aligned);
        if (lane == 0) tv[row0 + r] = v;
      }
      ring.release(i);
    }
    // ---- each owned row: its result, and its entry of the next vector ----
    const float* H = nullptr;  // the coupling of the next stage's vector
    if (s < Mi - 1) H = p.ho + (size_t)k * phi * phi;   // Ho_k^T T_k
    else if (k > 0) H = p.ho + (size_t)(k - 1) * phi * phi;  // Ho_{k-1} x_k
    for (int e = tid; e < nrows; e += kThreads) {
      const int a = e % phi;
      const float* tg = tv + (e - a);  // the row group's results
      float next = 0.f;
      if (s < Mi - 1) {  // forward: y_{k+1} = b_{k+1} - (I (x) Ho_k)^T T_k
        if (k == 0) ysh[e] = vec[r0 + e];  // y_0 = b_0
        float c = 0.f;
        for (int q = 0; q < phi; ++q) c = fmaf(H[q * phi + a], tg[q], c);
        next = __ldg(p.b + (size_t)(k + 1) * bs + r0 + e) - c;
        ysh[(size_t)(k + 1) * rows + e] = next;
      } else {  // x_k; then y_{k-1} - (I (x) Ho_{k-1}) x_k
        p.x[(size_t)k * bs + r0 + e] = tg[a];
        if (k > 0) {
          float c = 0.f;
          for (int q = 0; q < phi; ++q) c = fmaf(H[a * phi + q], tg[q], c);
          next = ysh[(size_t)(k - 1) * rows + e] - c;
        }
      }
      if (s + 1 < nstage)
        chain::put_tagged(p.vbuf + (size_t)((s + 1) & 1) * bs + r0 + e, next,
                          (unsigned)(s + 1));
    }
    __syncthreads();  // vec and tv are rewritten by the next stage
  }
}

// K3a: the forward sweep over one chunk on the chain ring (the note above)
struct ChunkFwdParams {
  const float* dinv;         // [L, bs, bs] pivot inverses, the chunk's knots
  const float* kin;          // [L, phi, phi]
  const float* b;            // [L, bs]
  const float* t_in;         // [bs] the carry
  unsigned long long* vbuf;  // [2, bs] scratch: tagged vector entries
  float* out;                // T [L, bs]
  int B3, L, phi, gpb, tile_rows, nslots;
};

__global__ void __launch_bounds__(kThreads)
    chunk_fwd_kernel(const ChunkFwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int phi = p.phi, L = p.L, bs = p.B3 * phi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = p.gpb * phi;

  chain::RowRing<float> ring;
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
  float* tv = vec + bs;  // [rows] this stage's products of the block
  const int r0 = ring.r0, nrows = ring.r1 - ring.r0;

  if (tid == 0) ring.start();
  for (int j = blockIdx.x * kThreads + tid; j < 2 * bs;
       j += gridDim.x * kThreads)
    p.vbuf[j] = 0ull;
  // no entry carries a tag yet, for every block
  cg::this_grid().sync();

  long long i = 0;  // this block's next tile
  for (int s = 0; s < L; ++s) {
    if (s == 0) {  // y_0 = b_0 - (I (x) kin_0)^T t_in
      for (int j = tid; j < bs; j += kThreads) {
        const int a = j % phi;
        const float* tg = p.t_in + (j - a);
        float c = 0.f;
        for (int q = 0; q < phi; ++q) c = fmaf(__ldg(p.kin + q * phi + a),
                                               __ldg(tg + q), c);
        vec[j] = __ldg(p.b + j) - c;
      }
      __syncthreads();
    } else {
      chain::gather_tagged(p.vbuf + (size_t)(s & 1) * bs, vec, bs,
                           (unsigned)s);
    }
    // ---- the block's rows of Dinv_s against it ----
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
    // ---- each owned row: T_s, and its entry of the next vector,
    // y_{s+1} = b_{s+1} - (I (x) kin_{s+1})^T T_s ----
    const float* H = s + 1 < L ? p.kin + (size_t)(s + 1) * phi * phi : nullptr;
    for (int e = tid; e < nrows; e += kThreads) {
      const int a = e % phi;
      p.out[(size_t)s * bs + r0 + e] = tv[e];
      if (s + 1 < L) {
        const float* tg = tv + (e - a);  // the row group's results
        float c = 0.f;
        for (int q = 0; q < phi; ++q) c = fmaf(H[q * phi + a], tg[q], c);
        chain::put_tagged(p.vbuf + (size_t)((s + 1) & 1) * bs + r0 + e,
                          __ldg(p.b + (size_t)(s + 1) * bs + r0 + e) - c,
                          (unsigned)(s + 1));
      }
    }
    __syncthreads();  // vec and tv are rewritten by the next stage
  }
}

// K3b's operands
struct ChunkParams {
  const float* dinv;   // [L, bs, bs] pivot inverses, the chunk's knots
  const float* kc;     // [L, phi, phi] couplings kout
  const float* v;      // T [L, bs]
  const float* carry;  // x_in [bs]
  float* out;          // x [L, bs]
  int B3, L, phi;
};

// K3b: the back substitution over one chunk, from x_in at j = L-1
__global__ void __launch_bounds__(kThreads) chunk_bwd_kernel(
    const ChunkParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);

  const int phi = p.phi, L = p.L, B3 = p.B3, bs = B3 * phi;
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * warps_per_block;
  const bool vec4 = (bs & 3) == 0;
  const size_t blk = (size_t)bs * bs;

  for (int j = L - 1; j >= 0; --j) {
    // stage (I (x) kout_j) x_{j+1}; x_{j+1} is the carry or a row that
    // other blocks wrote before the last grid sync (__ldcg)
    const float* H = p.kc + (size_t)j * phi * phi;
    const float* xn = j == L - 1 ? p.carry : p.out + (size_t)(j + 1) * bs;
    for (int i = threadIdx.x; i < bs; i += blockDim.x) {
      const int grp = i / phi, a = i - grp * phi;
      float s = 0.f;
      for (int c = 0; c < phi; ++c)
        s = fmaf(H[a * phi + c], __ldcg(xn + grp * phi + c), s);
      sh[i] = s;
    }
    __syncthreads();
    const float* Dj = p.dinv + (size_t)j * blk;
    for (int grp = gwarp; grp < B3; grp += nwarps) {
      float tv[kMaxPhi];
      for (int a = 0; a < phi; ++a)
        tv[a] = row_dot(Dj + (size_t)(grp * phi + a) * bs, sh, bs, lane,
                        vec4);
      if (lane == 0) {
        const size_t r0 = (size_t)j * bs + grp * phi;
        for (int a = 0; a < phi; ++a) p.out[r0 + a] = p.v[r0 + a] - tv[a];
      }
    }
    if (j > 0) grid.sync();
  }
}

// K3b's cooperative launch of `kernel` on a grid sized to the chain (one
// warp per row group), `bs` floats of dynamic shared memory.  Returns a
// cudaError_t: the launch's, or cudaGetLastError() after it.
template <typename P>
int launch_coop(void (*kernel)(const P), P p, int B3, int phi,
                void* stream) {
  int grid = 0;
  int e = probe::coop_grid((const void*)kernel, kThreads,
                           (size_t)B3 * phi * sizeof(float),
                           (B3 + kThreads / 32 - 1) / (kThreads / 32), &grid);
  if (e != 0) return e;
  void* args[] = {&p};
  cudaError_t c = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(kThreads), args,
      (size_t)B3 * phi * sizeof(float), (cudaStream_t)stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

// K2 on pivots of type T: the ring plan (gpb, tile_rows, nslots, smem) of
// ops/thomas.ring_plan, one block per gpb row groups; refused if the plan
// does not fit the layout the kernel carves or the grid cannot co-reside
template <typename T>
int solve_as(void* dinv, void* ho, void* b, void* vbuf, void* x, int B3,
             int Mi, int phi, int gpb, int tile_rows, int nslots, int smem,
             void* stream) {
  if (phi < 1 || phi > kMaxPhi || Mi < 1 || B3 < 1 || gpb < 1 ||
      tile_rows < 1 || tile_rows > gpb * phi || nslots < 1 ||
      nslots > chain::kMaxSlots)
    return (int)cudaErrorInvalidValue;
  const int bs = B3 * phi, rows = gpb * phi;
  const size_t need = chain::kBarBytes +
                      nslots * chain::slot_bytes(tile_rows, bs, sizeof(T)) +
                      sizeof(float) * ((size_t)bs + rows + (size_t)Mi * rows);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  const int want = (B3 + gpb - 1) / gpb;
  int grid = 0;
  int e = probe::coop_grid((const void*)thomas_kernel<T>, kThreads, smem,
                           want, &grid);
  if (e != 0) return e;
  // the chain needs every block of the plan resident at once
  if (grid < want) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<T> p;
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
  void* args[] = {&p};
  cudaError_t c = cudaLaunchCooperativeKernel(
      (const void*)thomas_kernel<T>, dim3(want), dim3(kThreads), args, smem,
      (cudaStream_t)stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
}

// K3a: the ring plan (gpb, tile_rows, nslots, smem) of ops/thomas.ring_plan
// with no rows kept, one block per gpb row groups; refused as K2's is
int chunk_fwd_ring(ChunkFwdParams p, int smem, void* stream) {
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
  int grid = 0;
  int e = probe::coop_grid((const void*)chunk_fwd_kernel, kThreads, smem,
                           want, &grid);
  if (e != 0) return e;
  // the chain needs every block of the plan resident at once
  if (grid < want) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  cudaError_t c = cudaLaunchCooperativeKernel(
      (const void*)chunk_fwd_kernel, dim3(want), dim3(kThreads), args, smem,
      (cudaStream_t)stream);
  if (c != cudaSuccess) return (int)c;
  return (int)cudaGetLastError();
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

// K3a on `stream`: T [L, bs] of one chunk from b [L, bs], the couplings
// kin [L, phi, phi] and the carry t_in [bs]; `vbuf` is [2, bs] 64-bit
// scratch; gpb, tile_rows, nslots and smem are the ring plan of
// ops/thomas.ring_plan with hist_knots = 0.
int thomas_chunk_fwd(void* dinv, void* kin, void* b, void* t_in, void* vbuf,
                     void* T, int B3, int L, int phi, int gpb, int tile_rows,
                     int nslots, int smem, void* stream) {
  ChunkFwdParams p;
  p.dinv = (const float*)dinv;
  p.kin = (const float*)kin;
  p.b = (const float*)b;
  p.t_in = (const float*)t_in;
  p.vbuf = (unsigned long long*)vbuf;
  p.out = (float*)T;
  p.B3 = B3;
  p.L = L;
  p.phi = phi;
  p.gpb = gpb;
  p.tile_rows = tile_rows;
  p.nslots = nslots;
  return chunk_fwd_ring(p, smem, stream);
}

// K3b on `stream`: x [L, bs] of one chunk from K3a's T [L, bs], the
// couplings kout [L, phi, phi] and the carry x_in [bs].
int thomas_chunk_bwd(void* dinv, void* kout, void* T, void* x_in, void* x,
                     int B3, int L, int phi, void* stream) {
  if (phi < 1 || phi > kMaxPhi || L < 1 || B3 < 1)
    return (int)cudaErrorInvalidValue;
  ChunkParams p;
  p.dinv = (const float*)dinv;
  p.kc = (const float*)kout;
  p.v = (const float*)T;
  p.carry = (const float*)x_in;
  p.out = (float*)x;
  p.B3 = B3;
  p.L = L;
  p.phi = phi;
  return launch_coop(chunk_bwd_kernel, p, B3, phi, stream);
}

const char* thomas_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
