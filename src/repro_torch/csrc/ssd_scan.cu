// Mamba-2 SSD chunk scan forward for Hopper (sm_90a): bf16 x, B, C; fp32
// dt, A; y in bf16, the final state in fp32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan (_kernel; pallas_call
//   at :71)
// and computes what it computes: per chunk of L steps, cum = cumsum(dt a);
// y = [(C B^T) * exp(cum_i - cum_j) * dt_j]_(i>=j) x + (C * exp(cum)) S_prev;
// S = S * exp(cum_L) + (B * exp(cum_L - cum) dt)^T x, with y rounded once
// to bf16. It also writes the final state S [N, P], which the Pallas kernel
// keeps in VMEM and drops: prefill needs it for the decode cache (it is
// ``final`` of models/ssm.py::ssd_chunked).
//
// What bounds it on an H100: at mamba2_780m's prefill (B = 4, S = 2048,
// H = 48, P = 64, N = 128, L = 256) chip_smoke.py counts 32.29 GFLOP
// against 112.72 MB of inputs and outputs: 0.0336 ms at 3.35 TB/s, just
// above the 0.033 ms at the bf16 tensor rate, so the bytes bound it. The
// design adds ~200 MB of scratch traffic (~0.06 ms at that rate) and,
// with the hi/lo operands below, ~45 GFLOP of wgmma (~0.046 ms).
//
// Why the chunk axis is parallel here. The TPU grid runs the chunk axis in
// order and carries S in VMEM; only the N x P state is a recurrence, the
// rest of a chunk's work depends on its own inputs alone. H100 blocks run
// in no order, and one block per (batch, head) looping over its chunks
// gives 192 blocks at the main shape, two waves on 132 SMs. So the one C
// entry issues three launches on the caller's stream, all reading the
// model layout through 4-D TMA descriptors (128B-swizzled 64-wide boxes):
//   (a) ssd_chunk_state, one warpgroup per (b, h, chunk): a warp-parallel
//       cumsum of dt a (in log2 units) over the chunk, written to scratch
//       as (cum, dt) pairs; then
//       S_c = B^T (w o x), w_j = 2^(cum_L - cum_j) dt_j, on wgmma: A = the
//       B tile read MN-major straight from its TMA box (the N state rows
//       as one or two m64 tiles), B = w o x, formed by the threads at the
//       swizzled place of the x box it was read from. 2-stage TMA ring.
//   (b) ssd_state_pass, one thread per (b, h, n, 4 p): the fp32 recurrence
//       S <- S 2^(cum_L) + S_c over the chunks, writing each chunk's
//       previous state as a bf16 hi/lo pair ready for TMA, and the final
//       state. Elementwise, ~100 MB at the main shape.
//   (c) ssd_chunk_scan, persistent (one block per SM), items of 256 query
//       rows of one (b, h, chunk), the longest of a chunk first: a
//       producer warpgroup loads an item's C tile (double-buffered, so the
//       next item's loads run under this one's math), streams 64-key B
//       and x tiles with their (cum, dt) pairs through a TMA ring, and
//       loads S_prev last. Two consumer warpgroups own query tiles {0, 3}
//       and {1, 2} of the item (5 key tiles each). Per key tile: C B^T on
//       wgmma (both K-major over N) into registers, the decay and dt_j on
//       the accumulator fragments (masked only on the diagonal tile), and
//       M x as register-A wgmma (x read MN-major from its box); at the end
//       2^(cum_i) (C S_prev) on wgmma, and y stored once.
// Scratch (the (cum, dt) pairs, the chunk states S_c in fp32, the previous
// states as bf16 hi/lo) is one workspace the caller allocates; the kernels
// allocate nothing. Under autograd the caller also passes `keep`, where
// the pairs and the previous states go instead, kept for the backward
// (ssd_scan_bwd.cu), which then never runs (a) and (b) again. No atomics:
// two calls give bit-identical results, and the Pallas layout gives the
// model layout's bits.
//
// Operand precision. C B^T takes exact bf16 inputs, so bf16 wgmma is exact
// up to fp32 accumulation. The three fp32-weighted operands (M, S_prev and
// w o x) are each split into bf16 hi + bf16 lo (split_bf16), two wgmmas
// into one fp32 accumulator. Rounding them to plain bf16 instead puts 116
// of 131,072 y elements outside chip_smoke's atol = rtol = 2e-2 (CPU
// emulation: one sequence, S = 512, 4 heads, N = 128, P = 64, chunk 256);
// hi/lo puts none outside, with a final-state max error of 4.0e-5 against
// 7.3e-3 for bf16 (tf32 truncated by the hardware: 3.1e-3).
// tests/test_torch_kernels.py::test_ssd_kernel_rounding_at_mamba2_geometry
// repeats the comparison at 2 heads.
//
// Masking: every decay is 2^ of a difference of cumsums, formed only where
// i >= j (masked before the exponential, to -inf: above the diagonal
// cum_i - cum_j > 0 can overflow, and inf * 0 would give NaN). Never
// exp(cum_i) / exp(cum_j). Rows past the chunk's end (a ragged chunk such
// as 100) are neither used as keys (weight 0) nor stored as queries.
//
// Layouts by element strides: x [B, S, H, P], dt [B, S, H], A [H], B/C
// [B, S, G, N] read at group h / (H / G) without expanding groups, y
// [B, S, H, P]; the Pallas layout [BH, S, *] runs as B = 1, H = G = BH,
// through the same descriptors. N < 64 (or not a multiple of 64) loads as
// a 64-wide box that TMA zero-fills past N.

#include "ssd_scan.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int QT = 64;                  // query rows per tile
constexpr int QB = 4 * QT;              // query rows per chunk-scan block
constexpr int SCAN_STAGES = 2;
constexpr int SCAN_THREADS = 384;       // (c): WG0, WG1 consume; WG2 loads

// ---------------------------------------------------------------------------
// (c) chunk scan
// ---------------------------------------------------------------------------

template <int NB>                       // 64-wide boxes over N
struct ScanTiles {
  static constexpr int C_BOX = QB * BOX_ROW_BYTES;   // [256 queries][64 n]
  static constexpr int C_BYTES = NB * C_BOX;
  static constexpr int KSTEPS = NB * BOX / 16;       // k steps over N
  static constexpr int SP_BYTES = NB * TILE;         // [64 NB n][64 p]
  static constexpr int STAGE = NB * TILE + TILE;     // B [64 keys][N], x
  static constexpr int SMEM = 2 * C_BYTES + 2 * SP_BYTES +
                              SCAN_STAGES * STAGE + SCAN_STAGES * KV_BYTES +
                              2 * QB * 8 + 1024;
};

// M = s 2^(cum_i - cum_j) dt_j in place, with j <= i < chunk enforced on
// the exponent (-inf) when MASK (a tile on the diagonal or past the
// chunk's end). This thread's keys are 8 i + 2 (lane % 4) + e, its rows
// row0 (+ 8).
template <bool MASK>
__device__ __forceinline__ void decay(float (&s)[32], const float2* kv,
                                      int t, int row0,
                                      const float (&cum_r)[2], int chunk,
                                      int lane) {
#pragma unroll
  for (int i = 0; i < KT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 8 * i + 2 * (lane % 4) + e;
      const float2 cj = kv[k];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        float d = cum_r[half] - cj.x;
        if (MASK && !(t * KT + k <= row && row < chunk)) d = -INFINITY;
        s[4 * i + 2 * half + e] *= ex2(d) * cj.y;
      }
    }
}

// acc += M x_t for the 64 query rows at `qa` (C, K-major) against key
// tile t (B at `bk`, x at `xk`): s = C B_t^T on wgmma, the decay on its
// fragments, then M as hi + lo bf16 register A operands, two wgmmas per
// k step (k step kk covers keys 16 kk .. 16 kk + 15, accumulator column
// blocks 2 kk and 2 kk + 1).
template <int NB>
__device__ __forceinline__ void intra_tile(float (&acc)[32],
                                           const uint8_t* qa,
                                           const uint8_t* bk,
                                           const uint8_t* xk,
                                           const float2* kv, int t,
                                           bool mask, int row0,
                                           const float (&cum_r)[2],
                                           int chunk, int lane) {
  using T = ScanTiles<NB>;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk)
    Wgmma<KT, 0, 0>::ss(s, desc_kmajor(qa, kk, T::C_BOX),
                        desc_kmajor(bk, kk, TILE), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  if (mask)
    decay<true>(s, kv, t, row0, cum_r, chunk, lane);
  else
    decay<false>(s, kv, t, row0, cum_r, chunk, lane);
  uint32_t hi[KT / 16][4], lo[KT / 16][4];
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], hi[kk][q],
                 lo[kk][q]);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint64_t dx = desc_mnmajor(xk, kk, TILE);
    Wgmma<P, 0, 1>::rs(acc, hi[kk], dx, 1);
    Wgmma<P, 0, 1>::rs(acc, lo[kk], dx, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// y = acc + 2^(cum_i) (C S_prev) for the 64 query rows at `qa`, S_prev as
// hi + lo, stored for the rows inside the chunk.
template <int NB>
__device__ __forceinline__ void finish_tile(float (&acc)[32],
                                            const uint8_t* qa,
                                            const uint8_t* sp_hi,
                                            const uint8_t* sp_lo, int row0,
                                            const float (&cum_r)[2],
                                            int chunk, bf16* yb,
                                            long long ys, int lane) {
  using T = ScanTiles<NB>;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk) {
    const uint64_t da = desc_kmajor(qa, kk, T::C_BOX);
    Wgmma<P, 0, 1>::ss(o, da, desc_mnmajor(sp_hi, kk, TILE), 1);
    Wgmma<P, 0, 1>::ss(o, da, desc_mnmajor(sp_lo, kk, TILE), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row < chunk) {
      const float e = ex2(cum_r[half]);
      bf16* yrow = yb + row * ys;
#pragma unroll
      for (int i = 0; i < P / 8; ++i)
        *reinterpret_cast<uint32_t*>(yrow + 8 * i + 2 * (lane % 4)) =
            pack_bf16(acc[4 * i + 2 * half] + e * o[4 * i + 2 * half],
                      acc[4 * i + 2 * half + 1] +
                          e * o[4 * i + 2 * half + 1]);
    }
  }
}

// Work item w of the chunk scan: query tiles 4 qb .. 4 qb + 3 of chunk c
// of head bh; the longest items of a chunk first.
struct ScanItem {
  int bhc, b, h, g, c0, i0, n_kt;
};

__device__ __forceinline__ ScanItem scan_item(int w, int S, int H, int G,
                                              int chunk) {
  const int n_qb = (chunk + QB - 1) / QB;
  ScanItem it;
  it.bhc = w / n_qb;
  const int bh = it.bhc / (S / chunk);
  it.b = bh / H;
  it.h = bh % H;
  it.g = it.h / (H / G);
  it.c0 = it.bhc % (S / chunk) * chunk;
  it.i0 = (n_qb - 1 - w % n_qb) * QB;
  it.n_kt = (min(it.i0 + QB, chunk) + KT - 1) / KT;
  return it;
}

// Persistent: block i takes items i, i + gridDim.x, ... The C tile is
// double-buffered, so the next item's loads run under this item's math.
template <int NB>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
ssd_chunk_scan(const __grid_constant__ CUtensorMap tc,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tsp,
               const float2* __restrict__ cd, bf16* __restrict__ y, int S,
               int H, int G, int chunk, int items, Strides ys) {
  using T = ScanTiles<NB>;
  __shared__ __align__(8) uint64_t c_full[2], c_empty[2];
  __shared__ __align__(8) uint64_t sp_full, sp_empty;
  __shared__ __align__(8) uint64_t full[SCAN_STAGES];
  __shared__ __align__(8) uint64_t empty[SCAN_STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* cq_base = align1024(smem_raw);           // two C buffers
  uint8_t* sp_hi = cq_base + 2 * T::C_BYTES;
  uint8_t* sp_lo = sp_hi + T::SP_BYTES;
  uint8_t* ring = sp_lo + T::SP_BYTES;
  float2* kv_ring = reinterpret_cast<float2*>(ring + SCAN_STAGES * T::STAGE);
  float2* cum_q = kv_ring + SCAN_STAGES * KT;       // [2][QB] query rows'
  const int lp = chunk_pitch(chunk);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&c_full[i], 1);
      mbar_init(&c_empty[i], 8);        // lane 0 of each consumer warp
    }
    mbar_init(&sp_full, 1);
    mbar_init(&sp_empty, 8);
    for (int s = 0; s < SCAN_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {             // loader warpgroup
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      Ring<SCAN_STAGES> ring_pos;
      int n = 0;                        // items done by this block
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const ScanItem it = scan_item(w, S, H, G, chunk);
        const int cb = n & 1;
        uint8_t* cq = cq_base + cb * T::C_BYTES;
        mbar_wait(&c_empty[cb], ((n >> 1) & 1) ^ 1u);
        const float2* cdc = cd + static_cast<long long>(it.bhc) * lp;
        const int q_bytes = min(QB, lp - it.i0) * 8;   // (cum, dt) of rows
        mbar_expect_tx(&c_full[cb], T::C_BYTES + q_bytes);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load_4d(cq + j * T::C_BOX, &tc, &c_full[cb], j * BOX, it.g,
                      it.c0 + it.i0, it.b);
        bulk_load(cum_q + cb * QB, cdc + it.i0, q_bytes, &c_full[cb]);
        for (int t = 0; t < it.n_kt; ++t) {
          mbar_wait(&empty[ring_pos.stage], ring_pos.phase ^ 1u);
          uint8_t* st = ring + ring_pos.stage * T::STAGE;
          uint64_t* bar = &full[ring_pos.stage];
          mbar_expect_tx(bar, T::STAGE + KV_BYTES);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            tma_load_4d(st + j * TILE, &tb, bar, j * BOX, it.g,
                        it.c0 + t * KT, it.b);
          tma_load_4d(st + NB * TILE, &tx, bar, 0, it.h, it.c0 + t * KT,
                      it.b);
          bulk_load(kv_ring + ring_pos.stage * KT, cdc + t * KT, KV_BYTES,
                    bar);
          ring_pos.advance();
          if (t == min(it.n_kt, SCAN_STAGES) - 1) {  // S_prev is needed last
            mbar_wait(&sp_empty, (n & 1) ^ 1u);
            mbar_expect_tx(&sp_full, 2 * T::SP_BYTES);
            tma_load_3d(sp_hi, &tsp, &sp_full, 0, 0, 2 * it.bhc);
            tma_load_3d(sp_lo, &tsp, &sp_full, 0, 0, 2 * it.bhc + 1);
          }
        }
      }
    }
    return;
  }

  // warpgroup w owns query tiles w and 3 - w of an item (1 + 4 and 2 + 3
  // key tiles when all four are inside the chunk)
  regs_alloc<240>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qt[2] = {wg, 3 - wg};
  Ring<SCAN_STAGES> ring_pos;
  int n = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
    const ScanItem it = scan_item(w, S, H, G, chunk);
    const int cb = n & 1;
    const uint8_t* cq = cq_base + cb * T::C_BYTES;
    mbar_wait(&c_full[cb], (n >> 1) & 1);
    int row0[2], diag[2];
    bool live[2], full_rows[2];
    float cum_r[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q0 = it.i0 + qt[u] * QT;
      row0[u] = q0 + 16 * warp + lane / 4;
      live[u] = q0 < chunk;
      diag[u] = q0 / KT;                // the key tile on its diagonal
      full_rows[u] = q0 + QT <= chunk;  // below the diagonal: no mask
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0[u] + 8 * half;
        cum_r[u][half] = r < chunk ? cum_q[cb * QB + r - it.i0].x : 0.f;
      }
    }
    const uint8_t* qa0 = cq + qt[0] * QT * BOX_ROW_BYTES;
    const uint8_t* qa1 = cq + qt[1] * QT * BOX_ROW_BYTES;

    float acc0[32], acc1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    for (int t = 0; t < it.n_kt; ++t) {
      mbar_wait(&full[ring_pos.stage], ring_pos.phase);
      const uint8_t* bk = ring + ring_pos.stage * T::STAGE;
      const uint8_t* xk = bk + NB * TILE;
      const float2* kv = kv_ring + ring_pos.stage * KT;
      if (live[0] && t <= diag[0])
        intra_tile<NB>(acc0, qa0, bk, xk, kv, t,
                       t == diag[0] || !full_rows[0], row0[0], cum_r[0],
                       chunk, lane);
      if (live[1] && t <= diag[1])
        intra_tile<NB>(acc1, qa1, bk, xk, kv, t,
                       t == diag[1] || !full_rows[1], row0[1], cum_r[1],
                       chunk, lane);
      if (lane == 0) mbar_arrive(&empty[ring_pos.stage]);
      ring_pos.advance();
    }

    // inter-chunk term, then y, written once
    mbar_wait(&sp_full, n & 1);
    bf16* yb = y + it.b * ys.b + it.h * ys.h +
               static_cast<long long>(it.c0) * ys.s;
    if (live[0])
      finish_tile<NB>(acc0, qa0, sp_hi, sp_lo, row0[0], cum_r[0], chunk, yb,
                      ys.s, lane);
    if (live[1])
      finish_tile<NB>(acc1, qa1, sp_hi, sp_lo, row0[1], cum_r[1], chunk, yb,
                      ys.s, lane);
    if (lane == 0) {
      mbar_arrive(&sp_empty);
      mbar_arrive(&c_empty[cb]);
    }
  }
}


// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int NB>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, bf16* y, float* state,
                   uint8_t* work, uint8_t* keep, int batch, int S, int H,
                   int G, int N, int chunk, const long long* st,
                   cudaStream_t stream) {
  const Workspace ws = workspace(batch, S, H, N, chunk);
  float* sc = reinterpret_cast<float*>(work + ws.sc);
  // the (cum, dt) pairs and S_prev in the workspace, or where the caller
  // keeps them for the backward
  float2* cd = reinterpret_cast<float2*>(keep != nullptr ? keep : work);
  bf16* sp = reinterpret_cast<bf16*>(
      keep != nullptr ? keep + kept(batch, S, H, N, chunk).sp
                      : work + ws.sp);
  const int nc = S / chunk;
  const long long bhc = static_cast<long long>(batch) * H * nc;

  CUtensorMap tb, tc, tx, tsp;
  if (!make_tmap_bshw(&tx, x, P, batch, S, H, st, KT) ||
      !make_tmap_bshw(&tb, Bm, N, batch, S, G, st + 7, KT) ||
      !make_tmap_bshw(&tc, Cm, N, batch, S, G, st + 10, QB) ||
      !make_tmap_state(&tsp, sp, bhc, N, NB))
    return cudaErrorInvalidValue;

  static unsigned long long state_devices = 0, scan_devices = 0;
  cudaError_t err = allow_smem(ssd_chunk_state<NB, false>, StateTiles<NB>::SMEM,
                               state_devices);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_chunk_scan<NB>, ScanTiles<NB>::SMEM, scan_devices);
  if (err != cudaSuccess) return err;

  ssd_chunk_state<NB, false><<<static_cast<unsigned>(bhc), STATE_THREADS,
                        StateTiles<NB>::SMEM, stream>>>(
      tb, tx, dt, A, cd, sc, S, H, G, N, chunk, Strides{st[3], st[4], st[5]},
      st[6]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long quads = static_cast<long long>(batch) * H * N * P / 4;
  ssd_state_pass<<<static_cast<unsigned>((quads + PASS_THREADS - 1) /
                                         PASS_THREADS),
                   PASS_THREADS, 0, stream>>>(cd, sc, sp, state, S, N, chunk,
                                              quads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long items = bhc * ((chunk + QB - 1) / QB);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(items < sms ? items : sms);
  ssd_chunk_scan<NB><<<grid, SCAN_THREADS, ScanTiles<NB>::SMEM, stream>>>(
      tc, tb, tx, tsp, cd, y, S, H, G, chunk, static_cast<int>(items),
      Strides{st[13], st[14], st[15]});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace ssd_scan_fwd_bf16 needs for these sizes (0 for
// shapes it does not take).
long long ssd_scan_workspace_bytes(int batch, int S, int H, int N,
                                   int chunk) {
  if (batch < 1 || S < 1 || H < 1 || !admit(S, H, 1, N, P, chunk)) return 0;
  return static_cast<long long>(workspace(batch, S, H, N, chunk).bytes);
}

// Bytes the forward keeps for the backward when given `keep`: the chunks'
// (cum, dt) pairs and their previous states as bf16 hi/lo (0 for shapes
// it does not take).
long long ssd_scan_keep_bytes(int batch, int S, int H, int N, int chunk) {
  if (batch < 1 || S < 1 || H < 1 || !admit(S, H, 1, N, P, chunk)) return 0;
  return static_cast<long long>(kept(batch, S, H, N, chunk).bytes);
}

// strides: 16 element strides: (batch, seq, head) of x, of dt, the head
// stride of A, (batch, seq, group) of B, of C, and (batch, seq, head) of
// y; those of x, B, C and y multiples of 8 with 16-byte aligned data.
// state is a contiguous fp32 [batch, H, N, P]; work is a 16-byte aligned
// buffer of ssd_scan_workspace_bytes(batch, S, H, N, chunk) bytes; keep
// is null (serving) or a 16-byte aligned buffer of
// ssd_scan_keep_bytes(batch, S, H, N, chunk) bytes that receives what
// ssd_scan_bwd_bf16 reads. Issues three launches on `stream` and returns
// the first non-zero cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernels do not take.
int ssd_scan_fwd_bf16(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, void* y, void* state,
                      void* work, void* keep, int batch, int S, int H, int G,
                      int N, int p, int chunk, const long long* strides,
                      void* stream) {
  if (batch < 1 || H < 1 || !admit(S, H, G, N, p, chunk))
    return cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  bf16* yp = static_cast<bf16*>(y);
  float* stp = static_cast<float*>(state);
  uint8_t* wp = static_cast<uint8_t*>(work);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > BOX)
    return launch<2>(x, dtp, ap, B, C, yp, stp, wp, kp, batch, S, H, G, N,
                     chunk, strides, s);
  return launch<1>(x, dtp, ap, B, C, yp, stp, wp, kp, batch, S, H, G, N,
                   chunk, strides, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
