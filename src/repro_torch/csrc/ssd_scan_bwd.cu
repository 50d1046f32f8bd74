// Mamba-2 SSD chunk scan backward for Hopper (sm_90a): bf16 x, B, C, dy;
// fp32 dt, A; dx in bf16, ddt and dA in fp32, dB and dC in bf16 summed
// over the heads of each group.
//
// Stands for the gradient of the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan (pallas_call at :71).
// That kernel is forward-only: the reference's gradients are XLA's
// autodiff of its chunked einsums (repro/models/ssm.py:ssd_chunked),
// outside any Pallas kernel. This file computes that gradient as the
// port's plain version kernels/ssd_scan/ops.py:ssd_scan_bwd does (the
// chain rule of the chunked form, every decay masked to -inf above the
// diagonal before its exponential, so chunk 256 stays finite), for y's
// gradient dy and, optionally, the final state's.
//
// What bounds it on an H100: the least work the gradient needs
// (kernels/ssd_scan/ops.py:bwd_work, which chip_smoke.py divides by the
// card's rates): over the causal triangle of each chunk, C B^T and the
// intra-chunk dB, dC products once per group, dM and M^T dy once per head,
// and four L x N x P state products per head. At mamba2_780m's train shape
// (B = 4, S = 2048, H = 48, G = 1, P = 64, N = 128, L = 256) that is 39.5
// GFLOP, 0.040 ms at the bf16 tensor rate, against 163 MB of inputs and
// gradients, 0.049 ms at 3.35 TB/s: the bytes bound it (zamba2_1_2b's
// H = 64, N = 64: 34.8 GFLOP, 210 MB, 0.063 ms). What this design issues
// beyond that: S = C B^T once per (tile pair, head slice, warpgroup), the
// full 64 x 64 diagonal tiles, the kept states' 54.5 MB, and the fp32
// scratch round trips below.
//
// Design. B and C belong to a group of H / G heads (all 48 heads at
// mamba2_780m), so C B^T is the same for every head of the group (the
// main kernel computes it once per tile pair for each warpgroup of each
// head slice that walks the pair: 8 times at mamba2_780m, 4 slices x 2
// warpgroups, against once per head before), and dB, dC are sums over
// the group's heads of products with the same B or C: dB_j = sum_i (sum_h dS^h_ij) C_i and
// dC_i = sum_j (sum_h dS^h_ij) B_j. The intra-chunk part of both is
// therefore one product per tile pair of dS summed over heads (fp32, a
// fixed head order, rounded to bf16 once), and no per-head dB or dC is
// ever stored. The forward keeps its (cum, dt) pairs and each chunk's
// previous state S_prev (bf16 hi/lo) when autograd records it
// (ssd_scan.cu's `keep`), so nothing of the forward runs again. Per chunk
// of L steps (cum = cumsum(dt a), in log2 units; w_j = 2^(cum_L - cum_j)
// dt_j; e_i = 2^(cum_i)), six launches on the caller's stream:
//   1. the forward's (a) chunk states (ssd_scan.cuh) with C for B, dy for
//      x and e for w: dS_prev = C^T (e dy), y's gradient of each chunk's
//      previous state;
//   2. ssd_bwd_state_pass, one block per (b, h): the state recurrence in
//      reverse, g <- g 2^(cum_L) + dS_prev, keeping each chunk's g (the
//      gradient of the state after it) as bf16 hi/lo and
//      dd_c = <g, S_prev>, a fixed-order block sum over N x P;
//   3. ssd_bwd_main, persistent, 256 threads (two warpgroups), items of
//      (b, group, chunk, 64-key tile, slice of the group's heads), the key
//      tiles with the most query tiles first. B's key tile stays in shared
//      memory; C's next query tile loads while this one's heads run. For
//      each query tile at or below the diagonal each warpgroup computes
//      S^T = B C^T once and then walks its half of the slice's heads (even
//      / odd), each head's key-tile x and query-tile dy coming through a
//      2-stage TMA ring: dM^T = x dy^T on wgmma, the decay and dt_j on the
//      fragments, dx += M^T dy with M^T as the bf16 register A operand,
//      dS^T summed over the heads in registers, and the rows' and
//      columns' sums that feed ddt (ka_j, sum_i dseg_ij per key tile, and
//      sum dseg (cum_i - cum_j)). A head's dx over the query tiles is
//      carried in the block's slot of fp32 scratch (L2) and rounded to
//      bf16 at the last one; its first visit starts it with the
//      chunk-state term w (B g) (g as hi/lo) and writes d w = <B g, x>.
//      At the end of a query tile the two warpgroups' dS^T are added
//      (WG0 + WG1) and stored as the slice's fp32 partial of that pair.
//      Its wgmmas are m64n64 (64 keys by 64 queries): a warpgroup holds
//      S^T, dM^T, the heads' dS^T sum and its dx tile as 32 fp32 registers
//      a thread each, plus M^T's 16 as the A operand, and ptxas gives the
//      kernel 255 registers a thread, the most there is, without a spill
//      (chip_smoke.py's build log). A 128-wide query tile doubles the first
//      three (+96 registers a thread), which would spill, as a 168-register
//      warpgroup of the flash backward did; it would also double C's query
//      tile and the ring's dy tiles, 48 KB on top of the ~192 KB of shared
//      memory the kernel takes at N = 128, past the SM's 227 KB;
//   4. ssd_bwd_bc, one block of two warpgroups per (b, group, chunk, 64-row
//      tile t): WG0 forms dB_t, WG1 dC_t. First the intra-chunk terms:
//      the pair's partials summed over the slices in order and rounded to
//      bf16 once, times C's query tiles (dB, register A operand) or, written
//      transposed into a K-major box, times B's key tiles (dC). Then for
//      every head of the group in order, from one TMA stage of x, dy, g and
//      S_prev: dB += w (x g^T) (g's hi half) in WG0, and in WG1
//      dC += e (dy S_prev^T) (S_prev as hi/lo) and, from the same product
//      and C's resident tile, y's inter-chunk term of d cum,
//      e_i <dy_i, (C S_prev)_i> = e_i <C_i, (dy S_prev^T)_i>;
//   5. ssd_bwd_finish, one block per (b, h, chunk): d cum, its reverse
//      cumsum, ddt = ... + d(dt a) a, and the chunk's share of dA;
//   6. a fixed-order sum of dA over (b, chunk).
// No atomics: two calls give bit-identical results. Scratch is one
// workspace the caller allocates (ssd_scan_bwd_workspace_bytes); the
// kernels allocate nothing.
//
// Operand precision, chosen by a CPU emulation of these roundings at one
// mamba2_780m head geometry (tests/test_torch_ssd_grad.py,
// test_ssd_bwd_kernel_rounding_at_mamba2_geometry): C B^T and dy x^T take exact
// bf16 inputs. M^T goes into its product as plain bf16, and so does dS once
// summed over the heads: dx, dB and dC are bf16 outputs held to one bf16 step
// of their largest magnitude (8e-3), and the emulation puts them at ~3e-3 so. g
// (like S_prev, and the forward's w o x and e o dy in launch 1) is split into
// bf16 hi + lo, two wgmmas into one fp32 accumulator, with w and e applied to
// the fp32 results, wherever it feeds ddt or dA (B g, dy S_prev^T, dS_prev):
// those are held to 1e-4 of their largest magnitude, and a plain bf16 g puts
// ddt at ~3e-4. dB's state-side term x g^T takes g's hi half alone: in the
// emulation the lo half moves dB by less than 1e-5 of its largest magnitude. dA
// is summed directly as sum_ij dseg_ij (cdt_i - cdt_j) plus the other terms of
// d cum weighted by cdt = cumsum(dt) (cdt = cum / a): the same quantity as
// sum_k dt_k revcumsum(d cum)_k, but without its cancellation between the row
// and column sums of dseg, which cost fp32 ~1e-4 of dA in the emulation (a = 0
// makes dA NaN; Mamba-2's A = -exp(A_log) is never 0).
//
// Layouts by element strides: x, dy, dx [B, S, H, P], dt, ddt [B, S, H],
// A [H], B/C [B, S, G, N] read at group h / (H / G); dB, dC contiguous
// [B, S, G, N]; dstate (optional) contiguous fp32 [B, H, N, P]. Rows past
// a chunk's end are neither used nor stored.

#include "ssd_scan.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int FIN_THREADS = 256;        // (2), (5)
constexpr int MAIN_THREADS = 256;       // (3): two warpgroups
constexpr int BC_THREADS = 256;         // (4): two warpgroups
constexpr int RING = 2;                 // (3): stages a warpgroup
constexpr int MAX_HS = 24;              // (3): heads of a slice
constexpr int FRAG = KT * KT;           // floats of a [64 x 64] fp32 tile

// Index of the tile pair (query tile q, key tile k <= q).
__host__ __device__ inline int pair_of(int q, int k) {
  return q * (q + 1) / 2 + k;
}

// Head slices of (3): about three items a SM, at most MAX_HS heads each.
struct Slices {
  int n, hs;
};

inline Slices slices(int batch, int G, int nc, int n_t, int rep, int sms) {
  const long long base = static_cast<long long>(batch) * G * nc * n_t;
  long long s = (3LL * sms + base - 1) / base;
  const long long least = (rep + MAX_HS - 1) / MAX_HS;
  if (s < least) s = least;
  if (s > rep) s = rep;
  Slices sl;
  sl.hs = static_cast<int>((rep + s - 1) / s);
  sl.n = (rep + sl.hs - 1) / sl.hs;
  return sl;
}

struct Plan {
  int nc, n_t, rep, items, grid;
  Slices sl;
};

inline Plan plan(int batch, int S, int H, int G, int chunk, int sms) {
  Plan p;
  p.nc = S / chunk;
  p.n_t = (chunk + KT - 1) / KT;
  p.rep = H / G;
  p.sl = slices(batch, G, p.nc, p.n_t, p.rep, sms);
  p.items = batch * G * p.nc * p.n_t * p.sl.n;
  p.grid = p.items < sms ? p.items : sms;
  return p;
}

// Byte offsets of the backward's scratch.
struct BwdWorkspace {
  size_t dsp;      // [bhc][N][P] fp32: dS_prev = C^T (e dy), read by (2);
                   // then (3)'s dx carry, [grid][slice heads][64 x 64]
  size_t gs;       // g per chunk, [bhc][hi, lo][N][P] bf16
  size_t dd;       // <g, S_prev> per chunk
  size_t rows;     // 3 x [bhc][pitch]: qb, ka, kb (fp32)
  size_t qa;       // [bhc][key tiles][pitch]: sum_j dseg_ij over a key tile
  size_t daseg;    // [bhc][key tiles]: sum dseg (cum_i - cum_j)
  size_t dapart;   // [bhc]: the chunk's share of dA
  size_t ds;       // [B G nc][pairs][slices][64 x 64] fp32: dS^T summed
                   // over a slice's heads
  size_t bytes;
};

inline BwdWorkspace bwd_workspace(int batch, int S, int H, int G, int N,
                                  int chunk, int sms) {
  const Plan pl = plan(batch, S, H, G, chunk, sms);
  const size_t bhc = static_cast<size_t>(batch) * H * pl.nc;
  const size_t lp = chunk_pitch(chunk);
  const size_t dsp = bhc * N * P * sizeof(float);
  const size_t carry = static_cast<size_t>(pl.grid) * pl.sl.hs * FRAG *
                       sizeof(float);
  BwdWorkspace w;
  w.dsp = 0;
  w.gs = round_up(dsp > carry ? dsp : carry, 1024);
  w.dd = w.gs + round_up(bhc * 2 * N * P * sizeof(bf16), 1024);
  w.rows = w.dd + round_up(bhc * sizeof(float), 1024);
  w.qa = w.rows + round_up(3 * bhc * lp * sizeof(float), 1024);
  w.daseg = w.qa + round_up(bhc * pl.n_t * lp * sizeof(float), 1024);
  w.dapart = w.daseg + round_up(bhc * pl.n_t * sizeof(float), 1024);
  w.ds = w.dapart + round_up(bhc * sizeof(float), 1024);
  const size_t pairs = static_cast<size_t>(pl.n_t) * (pl.n_t + 1) / 2;
  w.bytes = w.ds + round_up(static_cast<size_t>(batch) * G * pl.nc * pairs *
                                pl.sl.n * FRAG * sizeof(float),
                            1024);
  return w;
}

// Sum of `v` over the block, in a fixed order (a shuffle tree in each
// warp, then the warps' sums in order by thread 0); every thread gets it.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();                      // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// Sum over the 4 lanes that share a fragment row (lane / 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Sum over the 8 lanes that share a fragment column (lane % 4).
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Byte offset of element (row, col) in a [64][64] bf16 box as TMA lays it
// out with the 128-byte swizzle: 16-byte chunk j of row r sits at chunk
// j ^ (r % 8).
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * BOX_ROW_BYTES + ((((col * 2) >> 4) ^ (row & 7)) << 4) +
         (col * 2 & 15);
}

// <v, t> over this thread's 16 columns of fragment row `row` (half `half`
// of its rows) and the 4 lanes that share the row: sum_p v[row, p]
// t[row, p], t the bf16 [64][64] box `box` in shared memory.
__device__ __forceinline__ float row_dot(const float (&v)[32], int half,
                                         const uint8_t* box, int row,
                                         int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < P / 8; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(
            box + swizzled(row, 8 * i + 2 * (lane % 4))));
    s += v[4 * i + 2 * half] * t.x + v[4 * i + 2 * half + 1] * t.y;
  }
  return quad_sum(s);
}

// ---------------------------------------------------------------------------
// (2) the state recurrence in reverse
// ---------------------------------------------------------------------------

constexpr int MAX_QUADS = MAX_N * P / 4 / FIN_THREADS;   // per thread

__global__ void __launch_bounds__(FIN_THREADS)
ssd_bwd_state_pass(const float2* __restrict__ cd, const bf16* __restrict__ sp,
                   const float* __restrict__ dsp,
                   const float* __restrict__ dstate, bf16* __restrict__ gs,
                   float* __restrict__ dd, int S, int N, int chunk) {
  __shared__ float red[FIN_THREADS / 32];
  const int np = N * P, quads = np / 4;
  const int nc = S / chunk, lp = chunk_pitch(chunk);
  const long long bh = blockIdx.x;
  float4 g[MAX_QUADS];
#pragma unroll
  for (int u = 0; u < MAX_QUADS; ++u) {
    const int e = threadIdx.x + u * FIN_THREADS;
    g[u] = (dstate != nullptr && e < quads)
               ? *reinterpret_cast<const float4*>(dstate + bh * np + 4 * e)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = nc - 1; c >= 0; --c) {
    const long long bhc = bh * nc + c;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_QUADS; ++u) {
      const int e = threadIdx.x + u * FIN_THREADS;
      if (e < quads) {
        const int r = 4 * e;
        uint2 hi, lo;
        split_bf16(g[u].x, g[u].y, hi.x, lo.x);
        split_bf16(g[u].z, g[u].w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(gs + 2 * bhc * np + r) = hi;
        *reinterpret_cast<uint2*>(gs + (2 * bhc + 1) * np + r) = lo;
        const uint2 sh = *reinterpret_cast<const uint2*>(sp + 2 * bhc * np + r);
        const uint2 sl =
            *reinterpret_cast<const uint2*>(sp + (2 * bhc + 1) * np + r);
        const float2 h0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sh.x));
        const float2 h1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sh.y));
        const float2 l0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sl.x));
        const float2 l1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sl.y));
        part += g[u].x * (h0.x + l0.x) + g[u].y * (h0.y + l0.y) +
                g[u].z * (h1.x + l1.x) + g[u].w * (h1.y + l1.y);
      }
    }
    part = block_sum<FIN_THREADS>(part, red);
    if (threadIdx.x == 0) dd[bhc] = part;
    const float decay = ex2(cd[bhc * lp + chunk - 1].x);
#pragma unroll
    for (int u = 0; u < MAX_QUADS; ++u) {
      const int e = threadIdx.x + u * FIN_THREADS;
      if (e < quads) {
        const float4 a = *reinterpret_cast<const float4*>(dsp + bhc * np +
                                                          4 * e);
        g[u].x = g[u].x * decay + a.x;
        g[u].y = g[u].y * decay + a.y;
        g[u].z = g[u].z * decay + a.z;
        g[u].w = g[u].w * decay + a.w;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (3) the tile pairs: dx, dS^T summed over a slice's heads, ddt's sums
// ---------------------------------------------------------------------------

template <int NB>                       // 64-wide boxes over N
struct MainTiles {
  static constexpr int NT = NB * TILE;          // [64 rows][64 NB] of B or C
  static constexpr int ST = NB * TILE;          // [64 NB n][64 p]: g
  static constexpr int STAGE = 2 * TILE;        // key-tile x, query-tile dy
  static constexpr int WG_BYTES = RING * STAGE + 2 * ST;   // + g hi, lo
  static constexpr int SMEM = 2 * NT + 2 * WG_BYTES + FRAG * 4 + 1024;
};

struct MainItem {
  int b, g, c, kt, sl, h0, nh;
};

// Item w: the key tiles with the most query tiles first; within one key
// tile, the slices of one (b, group, chunk) side by side.
__device__ __forceinline__ MainItem main_item(int w, int batch, int G,
                                              int nc, int n_sl, int rep,
                                              int hs) {
  MainItem it;
  const int per_kt = batch * G * nc * n_sl;
  it.kt = w / per_kt;
  int r = w % per_kt;
  it.sl = r % n_sl;
  r /= n_sl;
  it.c = r % nc;
  r /= nc;
  it.g = r % G;
  it.b = r / G;
  it.h0 = it.g * rep + it.sl * hs;
  it.nh = min(hs, rep - it.sl * hs);
  return it;
}

template <int NB>
__global__ void __launch_bounds__(MAIN_THREADS, 1)
ssd_bwd_main(const __grid_constant__ CUtensorMap tb,
             const __grid_constant__ CUtensorMap tc,
             const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tdy,
             const __grid_constant__ CUtensorMap tg,
             const float2* __restrict__ cd, bf16* __restrict__ dx,
             float* __restrict__ carry,
             float* __restrict__ ds, float* __restrict__ ka,
             float* __restrict__ kb, float* __restrict__ qa,
             float* __restrict__ daseg, int batch, int S, int H, int G,
             int chunk, int n_sl, int hs, int items, Strides dxs) {
  using T = MainTiles<NB>;
  __shared__ __align__(8) uint64_t b_full, c_full, g_full[2];
  __shared__ __align__(8) uint64_t full[2][RING];
  __shared__ __align__(16) float2 kpair[2][RING][KT];
  __shared__ __align__(16) float2 qpair[2][RING][KT];
  __shared__ float ka_s[2][MAX_HS / 2][KT];
  __shared__ float dsg_s[2][MAX_HS / 2][4];
  __shared__ float qred[2][2][4][KT];   // [wg][step parity][warp][column]
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bt = align1024(smem_raw);    // B's key tile
  uint8_t* cq = bt + T::NT;             // C's query tile
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* ring = cq + T::NT + wg * T::WG_BYTES;
  uint8_t* ghi = ring + RING * T::STAGE;
  uint8_t* glo = ghi + T::ST;
  float* xbuf = reinterpret_cast<float*>(cq + T::NT + 2 * T::WG_BYTES);
  const bool leader = wt == 0;

  const int nc = S / chunk, n_t = (chunk + KT - 1) / KT;
  const int lp = chunk_pitch(chunk), rep = H / G;
  const int n_pairs = n_t * (n_t + 1) / 2;

  if (tid == 0) {
    mbar_init(&b_full, 1);
    mbar_init(&c_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&g_full[i], 1);
      for (int s = 0; s < RING; ++s) mbar_init(&full[i][s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int jr = 16 * warp + lane / 4;  // this thread's key rows jr (+ 8)
  float* my_carry = carry + static_cast<long long>(blockIdx.x) * hs * FRAG;
  // running counts, so that barrier parities carry across items
  int n_items = 0, c_use = 0, steps = 0, g_use = 0;

  for (int w = blockIdx.x; w < items; w += gridDim.x, ++n_items) {
    const MainItem it = main_item(w, batch, G, nc, n_sl, rep, hs);
    const int kt = it.kt, k0 = kt * KT, c0 = it.c * chunk;
    const int n_q = n_t - kt;           // query tiles kt .. n_t - 1
    const int n_my = it.nh > wg ? (it.nh - wg + 1) / 2 : 0;
    const int total = n_q * n_my;       // this warpgroup's steps
    const int bgc = (it.b * G + it.g) * nc + it.c;
    auto bhc_of = [&](int r) {          // r-th head of this warpgroup
      return (it.b * H + it.h0 + wg + 2 * r) * nc + it.c;
    };
    // step st: query tile kt + st / n_my, head st % n_my
    auto load_step = [&](int st) {
      const int s = (steps + st) % RING, r = st % n_my;
      const int q = kt + st / n_my, h = it.h0 + wg + 2 * r;
      const float2* cdc = cd + static_cast<long long>(bhc_of(r)) * lp;
      uint8_t* stg = ring + s * T::STAGE;
      mbar_expect_tx(&full[wg][s], T::STAGE + 2 * KV_BYTES);
      tma_load_4d(stg, &tx, &full[wg][s], 0, h, c0 + k0, it.b);
      tma_load_4d(stg + TILE, &tdy, &full[wg][s], 0, h, c0 + q * KT, it.b);
      bulk_load(kpair[wg][s], cdc + k0, KV_BYTES, &full[wg][s]);
      bulk_load(qpair[wg][s], cdc + q * KT, KV_BYTES, &full[wg][s]);
    };
    auto load_g = [&](int r) {
      const int bhc = bhc_of(r);
      mbar_expect_tx(&g_full[wg], 2 * T::ST);
      tma_load_3d(ghi, &tg, &g_full[wg], 0, 0, 2 * bhc);
      tma_load_3d(glo, &tg, &g_full[wg], 0, 0, 2 * bhc + 1);
    };

    __syncthreads();                    // the last item is done
    if (tid == 0) {
      mbar_expect_tx(&b_full, T::NT);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load_4d(bt + j * TILE, &tb, &b_full, j * BOX, it.g, c0 + k0,
                    it.b);
      mbar_expect_tx(&c_full, T::NT);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load_4d(cq + j * TILE, &tc, &c_full, j * BOX, it.g, c0 + k0,
                    it.b);
    }
    if (leader) {
      for (int st = 0; st < min(RING, total); ++st) load_step(st);
      if (n_my > 0) load_g(0);
    }
    for (int r = 0; r < n_my; ++r) {
      if (lane % 4 == 0) ka_s[wg][r][jr] = ka_s[wg][r][jr + 8] = 0.f;
      if (lane == 0) dsg_s[wg][r][warp] = 0.f;
    }
    mbar_wait(&b_full, n_items & 1);

    for (int qi = 0; qi < n_q; ++qi) {
      const int q = kt + qi, q0 = q * KT;
      mbar_wait(&c_full, (c_use + qi) & 1);
      // S^T = B C^T for this tile pair: [64 keys][64 queries], K over N
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NB * 4; ++kk)
        Wgmma<KT, 0, 0>::ss(sc, desc_kmajor(bt, kk, TILE),
                            desc_kmajor(cq, kk, TILE), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      named_sync(4, MAIN_THREADS);      // both warpgroups have read C
      if (tid == 0 && qi + 1 < n_q) {   // the next query tile's, under
        mbar_expect_tx(&c_full, T::NT); // this one's heads
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load_4d(cq + j * TILE, &tc, &c_full, j * BOX, it.g,
                      c0 + (q + 1) * KT, it.b);
      }

      float dst[32];                    // dS^T over this warpgroup's heads
#pragma unroll
      for (int i = 0; i < 32; ++i) dst[i] = 0.f;
      for (int r = 0; r < n_my; ++r) {
        const int st = qi * n_my + r, gi = steps + st, s = gi % RING;
        const int h = it.h0 + wg + 2 * r, bhc = bhc_of(r);
        float* slot = my_carry + (wg + 2 * r) * FRAG;
        float acc[32];                  // dx of this head's key tile
        if (qi > 0) {                   // the carry, read ahead of its use
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = __ldcg(slot + i * 128 + wt);
        }
        mbar_wait(&full[wg][s], (gi / RING) & 1);
        const uint8_t* xt = ring + s * T::STAGE;
        const uint8_t* dyt = xt + TILE;
        const float2* kp = kpair[wg][s];
        const float2* qp = qpair[wg][s];
        float cj[2], dtj[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          cj[half] = kp[jr + 8 * half].x;
          dtj[half] = kp[jr + 8 * half].y;
        }
        if (qi == 0) {
          // first visit: the chunk-state term dx = w (B g), d w = <B g, x>
          // (spreading these visits over the query tiles, to give each g
          // load more time, measured slower on an H100)
          mbar_wait(&g_full[wg], g_use & 1);
          ++g_use;
          float bg[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) bg[i] = 0.f;
          fence_regs(bg);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NB * 4; ++kk) {
            const uint64_t da = desc_kmajor(bt, kk, TILE);
            Wgmma<P, 0, 1>::ss(bg, da, desc_mnmajor(ghi, kk, TILE), 1);
            Wgmma<P, 0, 1>::ss(bg, da, desc_mnmajor(glo, kk, TILE), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(bg);
          named_sync(1 + wg, 128);      // g's buffer is free
          if (leader && r + 1 < n_my) load_g(r + 1);
          const float cl =
              cd[static_cast<long long>(bhc) * lp + chunk - 1].x;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = k0 + jr + 8 * half;
            const bool in = j < chunk;
            const float wj = in ? ex2(cl - cj[half]) * dtj[half] : 0.f;
            const float dw = row_dot(bg, half, xt, jr + 8 * half, lane);
            if (in && lane % 4 == 0)
              kb[static_cast<long long>(bhc) * lp + j] = dw;
#pragma unroll
            for (int i = 0; i < P / 8; ++i) {
              acc[4 * i + 2 * half] = wj * bg[4 * i + 2 * half];
              acc[4 * i + 2 * half + 1] = wj * bg[4 * i + 2 * half + 1];
            }
          }
        }

        // dM^T = x dy^T: [64 keys][64 queries], K over P
        float dm[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dm[i] = 0.f;
        fence_regs(dm);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk)
          Wgmma<KT, 0, 0>::ss(dm, desc_kmajor(xt, kk, TILE),
                              desc_kmajor(dyt, kk, TILE), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dm);

        float rk[2] = {0.f, 0.f}, dseg = 0.f, qcol[KT / 8][2];
        float mt[32];                   // M^T
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + 2 * (lane % 4) + e;
            const int qpos = q0 + col;  // query position in the chunk
            const float ci = qp[col].x;
            qcol[i][e] = 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int idx = 4 * i + 2 * half + e;
              const bool ok = k0 + jr + 8 * half <= qpos && qpos < chunk;
              const float seg = ci - cj[half];
              const float dec = ex2(ok ? seg : -INFINITY);
              const float tt = dm[idx] * sc[idx] * dec;
              const float td = tt * dtj[half];
              rk[half] += tt;
              dseg += ok ? td * seg : 0.f;
              qcol[i][e] += td;
              const float f = dec * dtj[half];
              mt[idx] = sc[idx] * f;
              dm[idx] *= f;             // dS^T
              dst[idx] += dm[idx];
            }
          }
        uint32_t ma[KT / 16][4];
        pack_a<KT / 16>(mt, ma);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          Wgmma<P, 0, 1>::rs(acc, ma[kk], desc_mnmajor(dyt, kk, TILE), 1);
        wgmma_commit();

        // ddt's sums while the product runs: ka_j (rows), sum_i over this
        // key tile of dseg_ij (columns, warps summed below), sum dseg seg
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = quad_sum(rk[half]);
          if (lane % 4 == 0) ka_s[wg][r][jr + 8 * half] += v;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dseg += __shfl_xor_sync(0xffffffffu, dseg, off);
        if (lane == 0) dsg_s[wg][r][warp] += dseg;
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = column_sum(qcol[i][e]);
            if (lane < 4) qred[wg][gi & 1][warp][8 * i + 2 * lane + e] = v;
          }

        wgmma_wait<0>();
        fence_regs(acc);
        if (q == n_t - 1) {
          // last query tile: this head's dx, rounded once
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = k0 + jr + 8 * half;
            if (j < chunk) {
              bf16* drow = dx + it.b * dxs.b + h * dxs.h +
                           static_cast<long long>(c0 + j) * dxs.s;
#pragma unroll
              for (int i = 0; i < P / 8; ++i)
                *reinterpret_cast<uint32_t*>(drow + 8 * i + 2 * (lane % 4)) =
                    pack_bf16(acc[4 * i + 2 * half],
                              acc[4 * i + 2 * half + 1]);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) __stcg(slot + i * 128 + wt, acc[i]);
        }
        named_sync(1 + wg, 128);        // stage s and qred are complete
        if (warp == 0) {
          // the four warps' column sums, in order
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = lane + 32 * u;
            const float* qr = &qred[wg][gi & 1][0][col];
            qa[(static_cast<long long>(bhc) * n_t + kt) * lp + q0 + col] =
                qr[0] + qr[KT] + qr[2 * KT] + qr[3 * KT];
          }
        }
        if (leader && st + RING < total) load_step(st + RING);
      }

      // this tile pair's dS^T over the slice: WG1's added to WG0's
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) xbuf[i * 128 + wt] = dst[i];
      }
      named_sync(5, MAIN_THREADS);
      if (wg == 0) {
        float* out = ds + ((static_cast<long long>(bgc) * n_pairs +
                            pair_of(q, kt)) * n_sl + it.sl) * FRAG;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          out[i * 128 + wt] = dst[i] + xbuf[i * 128 + wt];
      }
    }

    // ka and sum dseg seg of this warpgroup's heads
    named_sync(1 + wg, 128);
    for (int r = 0; r < n_my; ++r) {
      const int bhc = bhc_of(r);
      if (lane % 4 == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = k0 + jr + 8 * half;
          if (j < chunk)
            ka[static_cast<long long>(bhc) * lp + j] =
                ka_s[wg][r][jr + 8 * half];
        }
      }
      if (wt == 0)
        daseg[static_cast<long long>(bhc) * n_t + kt] =
            dsg_s[wg][r][0] + dsg_s[wg][r][1] + dsg_s[wg][r][2] +
            dsg_s[wg][r][3];
    }
    c_use += n_q;
    steps += total;
  }
}

// ---------------------------------------------------------------------------
// (4) dB and dC of one 64-row tile, summed over the group's heads
// ---------------------------------------------------------------------------

template <int NB>
struct BcTiles {
  static constexpr int NT = NB * TILE;          // [64 rows][64 NB] of B or C
  static constexpr int ST = NB * TILE;          // [64 NB n][64 p] state
  // intra-chunk terms: a 2-tile ring a warpgroup and WG1's dS box
  static constexpr int A_BYTES = 4 * NT + TILE;
  // heads: stages of x, dy, g hi, S_prev hi/lo
  static constexpr int STAGE = 2 * TILE + 3 * ST;
  static constexpr int B_BYTES = 2 * STAGE;
  static constexpr int SMEM =
      NT + (A_BYTES > B_BYTES ? A_BYTES : B_BYTES) + 1024;
};

template <int NB>
__global__ void __launch_bounds__(BC_THREADS, 1)
ssd_bwd_bc(const __grid_constant__ CUtensorMap tb,
           const __grid_constant__ CUtensorMap tc,
           const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tdy,
           const __grid_constant__ CUtensorMap tg,
           const __grid_constant__ CUtensorMap tsp,
           const float2* __restrict__ cd, const float* __restrict__ ds,
           bf16* __restrict__ db, bf16* __restrict__ dc,
           float* __restrict__ qb, int S, int H, int G, int N, int chunk,
           int n_sl) {
  using T = BcTiles<NB>;
  __shared__ __align__(8) uint64_t ct_full, a_full[2][2], h_full[2];
  __shared__ __align__(16) float2 pairs[2][KT];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ct = align1024(smem_raw);    // C's tile t, for C S_prev
  uint8_t* area = ct + T::NT;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const bool leader = wt == 0;

  const int nc = S / chunk, n_t = (chunk + KT - 1) / KT;
  const int lp = chunk_pitch(chunk), rep = H / G;
  const int n_pairs = n_t * (n_t + 1) / 2;
  const int t = blockIdx.x % n_t;
  int rest = blockIdx.x / n_t;
  const int c = rest % nc;
  rest /= nc;
  const int g = rest % G, b = rest / G;
  const int c0 = c * chunk, t0 = t * KT;
  const int bgc = (b * G + g) * nc + c;

  if (tid == 0) {
    mbar_init(&ct_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&h_full[i], 1);
      mbar_init(&a_full[i][0], 1);
      mbar_init(&a_full[i][1], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&ct_full, T::NT);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(ct + j * TILE, &tc, &ct_full, j * BOX, g, c0 + t0, b);
  }

  const int jr = 16 * warp + lane / 4;  // this thread's rows jr (+ 8)
  float acc[NB * 32];                   // WG0: dB_t, WG1: dC_t
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;

  // intra-chunk terms: WG0 dB_t += dS^T C_q for q >= t, WG1
  // dC_t += dS B_k for k <= t; dS of a pair summed over the slices in order
  uint8_t* aring = area + wg * 2 * T::NT;
  uint8_t* dsbox = area + 4 * T::NT;
  const int n_a = wg == 0 ? n_t - t : t + 1;
  auto load_a = [&](int u) {
    const int s = u & 1;
    const int row = c0 + (wg == 0 ? t + u : u) * KT;
    mbar_expect_tx(&a_full[wg][s], T::NT);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(aring + s * T::NT + j * TILE, wg == 0 ? &tc : &tb,
                  &a_full[wg][s], j * BOX, g, row, b);
  };
  if (leader)
    for (int u = 0; u < min(2, n_a); ++u) load_a(u);
  for (int u = 0; u < n_a; ++u) {
    const int s = u & 1;
    const int pr = wg == 0 ? pair_of(t + u, t) : pair_of(t, u);
    const float* src = ds + (static_cast<long long>(bgc) * n_pairs + pr) *
                                n_sl * FRAG;
    float v[32];                        // dS^T: [64 keys][64 queries]
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = src[i * 128 + wt];
    for (int sl = 1; sl < n_sl; ++sl) {
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] += src[sl * FRAG + i * 128 + wt];
    }
    mbar_wait(&a_full[wg][s], (u >> 1) & 1);
    const uint8_t* tile = aring + s * T::NT;
    if (wg == 0) {
      // the fragment's rows are tile t's keys: the register A operand
      uint32_t sa[KT / 16][4];
      pack_a<KT / 16>(v, sa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        Wgmma<NB * 64, 0, 1>::rs(acc, sa[kk], desc_mnmajor(tile, kk, TILE),
                                 1);
    } else {
      // dS = (dS^T)^T into a K-major [64 queries][64 keys] box
#pragma unroll
      for (int i = 0; i < KT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<bf16*>(
                dsbox + swizzled(8 * i + 2 * (lane % 4) + e, jr + 8 * half)) =
                __float2bfloat16_rn(v[4 * i + 2 * half + e]);
      fence_proxy_async();
      named_sync(1 + wg, 128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        Wgmma<NB * 64, 0, 1>::ss(acc, desc_kmajor(dsbox, kk, TILE),
                                 desc_mnmajor(tile, kk, TILE), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    named_sync(1 + wg, 128);            // stage s and the dS box are free
    if (leader && u + 2 < n_a) load_a(u + 2);
  }

  // the heads in order: dB_t += w (x g^T) (g's hi half: its lo half moves
  // dB by far less than one bf16 step), dC_t += e (dy S_prev^T) (S_prev as
  // hi/lo) and, from the same product, qb_i = e_i <C_i, (dy S_prev^T)_i>
  __syncthreads();                      // the intra-chunk buffers are free
  auto load_h = [&](int r) {
    const int s = r & 1, h = g * rep + r;
    const int bhc = (b * H + h) * nc + c;
    uint8_t* st = area + s * T::STAGE;
    mbar_expect_tx(&h_full[s], T::STAGE + KV_BYTES);
    tma_load_4d(st, &tx, &h_full[s], 0, h, c0 + t0, b);
    tma_load_4d(st + TILE, &tdy, &h_full[s], 0, h, c0 + t0, b);
    uint8_t* sts = st + 2 * TILE;
    tma_load_3d(sts, &tg, &h_full[s], 0, 0, 2 * bhc);
    tma_load_3d(sts + T::ST, &tsp, &h_full[s], 0, 0, 2 * bhc);
    tma_load_3d(sts + 2 * T::ST, &tsp, &h_full[s], 0, 0, 2 * bhc + 1);
    bulk_load(pairs[s], cd + static_cast<long long>(bhc) * lp + t0,
              KV_BYTES, &h_full[s]);
  };
  if (tid == 0)
    for (int r = 0; r < min(2, rep); ++r) load_h(r);
  mbar_wait(&ct_full, 0);
  for (int r = 0; r < rep; ++r) {
    const int s = r & 1, h = g * rep + r;
    const long long bhc = static_cast<long long>(b * H + h) * nc + c;
    mbar_wait(&h_full[s], (r >> 1) & 1);
    const uint8_t* st = area + s * T::STAGE;
    const uint8_t* sts = st + 2 * TILE;           // g hi, S_prev hi, lo
    // WG0: x g^T (g's hi half), WG1: dy S_prev^T (hi and lo)
    float tmp[NB * 32];
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) tmp[i] = 0.f;
    fence_regs(tmp);
    wgmma_fence();
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        Wgmma<NB * 64, 0, 0>::ss(tmp, desc_kmajor(st, kk, TILE),
                                 desc_kmajor(sts, kk, TILE), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const uint64_t da = desc_kmajor(st + TILE, kk, TILE);
        Wgmma<NB * 64, 0, 0>::ss(tmp, da, desc_kmajor(sts + T::ST, kk, TILE),
                                 1);
        Wgmma<NB * 64, 0, 0>::ss(
            tmp, da, desc_kmajor(sts + 2 * T::ST, kk, TILE), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
    const float cl = cd[bhc * lp + chunk - 1].x;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = jr + 8 * half;
      const float2 pr = pairs[s][row];
      const bool in = t0 + row < chunk;
      const float scale =
          !in ? 0.f : (wg == 0 ? ex2(cl - pr.x) * pr.y : ex2(pr.x));
      if (wg == 1) {
        // y's inter-chunk term of d cum: qb_i = e_i <dy_i, (C S_prev)_i>
        // = e_i <C_i, (dy S_prev^T)_i>, C's row from its resident tile
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < NB * 8; ++i) {
          const int n = 8 * i + 2 * (lane % 4);
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  ct + (n / BOX) * TILE + swizzled(row, n % BOX)));
          d += tmp[4 * i + 2 * half] * cv.x +
               tmp[4 * i + 2 * half + 1] * cv.y;
        }
        d = quad_sum(d);
        if (in && lane % 4 == 0) qb[bhc * lp + t0 + row] = scale * d;
      }
#pragma unroll
      for (int i = 0; i < NB * 8; ++i) {
        acc[4 * i + 2 * half] += scale * tmp[4 * i + 2 * half];
        acc[4 * i + 2 * half + 1] += scale * tmp[4 * i + 2 * half + 1];
      }
    }
    __syncthreads();                    // stage s is free
    if (tid == 0 && r + 2 < rep) load_h(r + 2);
  }

  // dB_t (WG0) or dC_t (WG1), rows inside the chunk
  bf16* out = wg == 0 ? db : dc;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + jr + 8 * half;
    if (row < chunk) {
      bf16* orow =
          out + ((static_cast<long long>(b) * S + c0 + row) * G + g) * N;
#pragma unroll
      for (int i = 0; i < NB * 8; ++i) {
        const int n = 8 * i + 2 * (lane % 4);
        if (n < N)
          *reinterpret_cast<uint32_t*>(orow + n) =
              pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (5) d cum, its reverse cumsum, ddt and the chunk's dA
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(FIN_THREADS)
ssd_bwd_finish(const float2* __restrict__ cd, const float* __restrict__ A,
               const float* __restrict__ qa, const float* __restrict__ qb,
               const float* __restrict__ ka, const float* __restrict__ kb,
               const float* __restrict__ dd, const float* __restrict__ daseg,
               float* __restrict__ ddt, float* __restrict__ dapart, int S,
               int H, int chunk, long long as, Strides ds) {
  __shared__ float red[FIN_THREADS / 32];
  __shared__ float warp_tot[FIN_THREADS / 32];
  const int bhc = blockIdx.x, nc = S / chunk;
  const int bh = bhc / nc, c = bhc % nc, b = bh / H, h = bh % H;
  const int lp = chunk_pitch(chunk), n_kt = (chunk + KT - 1) / KT;
  const long long base = static_cast<long long>(bhc) * lp;
  const float2* cdc = cd + base;
  const float a = A[h * as];
  const float inv = 1.f / (a * LOG2E);  // cum (log2 units) -> cumsum(dt)
  const float cl = cdc[chunk - 1].x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // pass 1: sum_j kb_j w_j and the terms of dA outside dseg
  float s_w = 0.f, s_a = 0.f;
  for (int i = tid; i < chunk; i += FIN_THREADS) {
    const float2 v = cdc[i];
    const float dww = kb[base + i] * ex2(cl - v.x) * v.y;
    s_w += dww;
    s_a += (qb[base + i] - dww) * (v.x * inv);
  }
  s_w = block_sum<FIN_THREADS>(s_w, red);
  s_a = block_sum<FIN_THREADS>(s_a, red);
  const float tail = s_w + dd[bhc] * ex2(cl);   // extra d cum at L - 1
  if (tid == 0) {
    float seg = 0.f;
    for (int t = 0; t < n_kt; ++t)
      seg += daseg[static_cast<long long>(bhc) * n_kt + t];
    dapart[bhc] = seg * inv + s_a + cl * inv * tail;
  }

  // pass 2: the reverse cumsum of d cum, FIN_THREADS positions at a time
  // from the chunk's end (a shuffle scan in each warp, then the later
  // warps' totals), and ddt
  float carry = 0.f;
  const int segs = (chunk + FIN_THREADS - 1) / FIN_THREADS;
  for (int sg = segs - 1; sg >= 0; --sg) {
    const int i = sg * FIN_THREADS + tid;
    float v = 0.f;
    float2 p = make_float2(0.f, 0.f);
    if (i < chunk) {
      p = cdc[i];
      float qs = 0.f;                   // sum_j dseg_ij, key tiles in order
      for (int kt = 0; kt <= i / KT; ++kt)
        qs += qa[(static_cast<long long>(bhc) * n_kt + kt) * lp + i];
      v = qs + qb[base + i] - p.y * ka[base + i] -
          kb[base + i] * ex2(cl - p.x) * p.y + (i == chunk - 1 ? tail : 0.f);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v += u;
    }
    if (lane == 0) warp_tot[warp] = v;
    __syncthreads();
    float after = carry;
    for (int w = FIN_THREADS / 32 - 1; w > warp; --w) after += warp_tot[w];
    const float dda = v + after;        // sum of d cum over positions >= i
    if (i < chunk)
      ddt[b * ds.b + static_cast<long long>(c * chunk + i) * ds.s +
          h * ds.h] = ka[base + i] + kb[base + i] * ex2(cl - p.x) + dda * a;
    for (int w = 0; w < FIN_THREADS / 32; ++w) carry += warp_tot[w];
    __syncthreads();                    // warp_tot is reused
  }
}

// ---------------------------------------------------------------------------
// (6) dA: a fixed-order sum over (b, chunk)
// ---------------------------------------------------------------------------

// dA[h] = sum over (b, chunk) of the chunks' shares, in that order.
__global__ void ssd_bwd_da(const float* __restrict__ dapart,
                           float* __restrict__ da, int batch, int H, int nc) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < batch; ++b)
      for (int c = 0; c < nc; ++c)
        s += dapart[(static_cast<long long>(b) * H + h) * nc + c];
    da[h] = s;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int NB>
cudaError_t launch_bwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const void* dy,
                       const float* dstate, const uint8_t* saved, bf16* dx,
                       float* ddt, float* da, bf16* db, bf16* dc,
                       uint8_t* work, int batch, int S, int H, int G, int N,
                       int chunk, int sms, const long long* st,
                       cudaStream_t stream) {
  const Plan pl = plan(batch, S, H, G, chunk, sms);
  const BwdWorkspace ws = bwd_workspace(batch, S, H, G, N, chunk, sms);
  const Kept kp = kept(batch, S, H, N, chunk);
  const float2* cd = reinterpret_cast<const float2*>(saved);
  const bf16* sp = reinterpret_cast<const bf16*>(saved + kp.sp);
  float* dsp = reinterpret_cast<float*>(work + ws.dsp);
  float* carry = dsp;                   // (3) runs after (2) has read dsp
  bf16* gs = reinterpret_cast<bf16*>(work + ws.gs);
  float* dd = reinterpret_cast<float*>(work + ws.dd);
  const long long bhc = static_cast<long long>(batch) * H * pl.nc;
  const size_t rows = bhc * chunk_pitch(chunk);
  float* qb = reinterpret_cast<float*>(work + ws.rows);
  float* ka = qb + rows;
  float* kb = ka + rows;
  float* qa = reinterpret_cast<float*>(work + ws.qa);
  float* daseg = reinterpret_cast<float*>(work + ws.daseg);
  float* dapart = reinterpret_cast<float*>(work + ws.dapart);
  float* dsum = reinterpret_cast<float*>(work + ws.ds);

  CUtensorMap tx, tb, tc, tdy, tsp, tg;
  if (!make_tmap_bshw(&tx, x, P, batch, S, H, st, KT) ||
      !make_tmap_bshw(&tb, Bm, N, batch, S, G, st + 7, KT) ||
      !make_tmap_bshw(&tc, Cm, N, batch, S, G, st + 10, KT) ||
      !make_tmap_bshw(&tdy, dy, P, batch, S, H, st + 13, KT) ||
      !make_tmap_state(&tsp, sp, bhc, N, NB) ||
      !make_tmap_state(&tg, gs, bhc, N, NB))
    return cudaErrorInvalidValue;

  static unsigned long long dy_devices = 0, main_devices = 0, bc_devices = 0;
  cudaError_t err = allow_smem(ssd_chunk_state<NB, true>,
                               StateTiles<NB>::SMEM, dy_devices);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_main<NB>, MainTiles<NB>::SMEM, main_devices);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_bc<NB>, BcTiles<NB>::SMEM, bc_devices);
  if (err != cudaSuccess) return err;

  // 1: C^T (e dy), y's gradient of each chunk's previous state
  ssd_chunk_state<NB, true><<<static_cast<unsigned>(bhc), STATE_THREADS,
                              StateTiles<NB>::SMEM, stream>>>(
      tc, tdy, dt, A, const_cast<float2*>(cd), dsp, S, H, G, N, chunk,
      Strides{st[3], st[4], st[5]}, st[6]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 2: the recurrence in reverse
  ssd_bwd_state_pass<<<static_cast<unsigned>(batch * H), FIN_THREADS, 0,
                       stream>>>(cd, sp, dsp, dstate, gs, dd, S, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3: the tile pairs
  ssd_bwd_main<NB><<<pl.grid, MAIN_THREADS, MainTiles<NB>::SMEM, stream>>>(
      tb, tc, tx, tdy, tg, cd, dx, carry, dsum, ka, kb, qa, daseg, batch, S,
      H, G, chunk, pl.sl.n, pl.sl.hs, pl.items,
      Strides{st[16], st[17], st[18]});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4: dB and dC
  ssd_bwd_bc<NB><<<static_cast<unsigned>(batch * G * pl.nc * pl.n_t),
                   BC_THREADS, BcTiles<NB>::SMEM, stream>>>(
      tb, tc, tx, tdy, tg, tsp, cd, dsum, db, dc, qb, S, H, G, N, chunk,
      pl.sl.n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 5: d cum, ddt, dA per chunk
  ssd_bwd_finish<<<static_cast<unsigned>(bhc), FIN_THREADS, 0, stream>>>(
      cd, A, qa, qb, ka, kb, dd, daseg, ddt, dapart, S, H, chunk, st[6],
      Strides{st[19], st[20], st[21]});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 6: dA over (b, chunk)
  ssd_bwd_da<<<1, 128, 0, stream>>>(dapart, da, batch, H, pl.nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace ssd_scan_bwd_bf16 needs for these sizes on
// `sms` SMs (0 for shapes it does not take).
long long ssd_scan_bwd_workspace_bytes(int batch, int S, int H, int G, int N,
                                       int chunk, int sms) {
  if (batch < 1 || S < 1 || H < 1 || sms < 1 || !admit(S, H, G, N, P, chunk))
    return 0;
  return static_cast<long long>(
      bwd_workspace(batch, S, H, G, N, chunk, sms).bytes);
}

// strides: 22 element strides: (batch, seq, head) of x, of dt, the head
// stride of A, (batch, seq, group) of B, of C, and (batch, seq, head) of
// dy, of dx and of ddt; those of x, B, C, dy and dx multiples of 8 with
// 16-byte aligned data. dstate: null or a contiguous fp32 [batch, H, N, P];
// saved: what ssd_scan_fwd_bf16 kept (`keep`) for these inputs; dA: fp32
// [H]; dB, dC: contiguous bf16 [batch, S, G, N]; work: a 16-byte aligned
// buffer of ssd_scan_bwd_workspace_bytes(batch, S, H, G, N, chunk, sms)
// bytes. Issues six launches on `stream` and returns the first non-zero
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the kernels do not take.
int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* dy,
                      const void* dstate, const void* saved, void* dx,
                      void* ddt, void* dA, void* dB, void* dC, void* work,
                      int batch, int S, int H, int G, int N, int p, int chunk,
                      int sms, const long long* strides, void* stream) {
  if (batch < 1 || H < 1 || sms < 1 || saved == nullptr ||
      !admit(S, H, G, N, p, chunk))
    return cudaErrorInvalidValue;
  // cuTensorMapEncodeTiled needs a current context, which the thread
  // autograd runs a backward on may not have yet
  cudaError_t err = bind_device_of(x);
  if (err != cudaSuccess) return err;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  const float* dsp = static_cast<const float*>(dstate);
  const uint8_t* svp = static_cast<const uint8_t*>(saved);
  bf16* dxp = static_cast<bf16*>(dx);
  float* ddtp = static_cast<float*>(ddt);
  float* dap = static_cast<float*>(dA);
  bf16* dbp = static_cast<bf16*>(dB);
  bf16* dcp = static_cast<bf16*>(dC);
  uint8_t* wp = static_cast<uint8_t*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > BOX)
    return launch_bwd<2>(x, dtp, ap, B, C, dy, dsp, svp, dxp, ddtp, dap, dbp,
                         dcp, wp, batch, S, H, G, N, chunk, sms, strides, s);
  return launch_bwd<1>(x, dtp, ap, B, C, dy, dsp, svp, dxp, ddtp, dap, dbp,
                       dcp, wp, batch, S, H, G, N, chunk, sms, strides, s);
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
