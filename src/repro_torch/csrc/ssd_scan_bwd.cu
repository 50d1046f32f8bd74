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
// What bounds it on an H100: at mamba2_780m's train shape (B = 4,
// S = 2048, H = 48, P = 64, N = 128, L = 256) chip_smoke.py counts ~142
// GFLOP of products against ~163 MB of inputs and gradients: ~0.14 ms at
// the bf16 tensor rate, so the operations bound it. This first design
// adds ~1.1 GB of scratch traffic (the per-head fp32 dB and dC, 0.4 GB,
// written and read again by the group sum, and the re-run forward
// passes' workspace: ~0.33 ms at 3.35 TB/s) and recomputes C B^T, dy x^T
// and the decay in two kernels, so it cannot reach that bound.
//
// Per chunk of L steps (cum = cumsum(dt a), in log2 units in the kernels;
// w_j = 2^(cum_L - cum_j) dt_j; e_i = 2^(cum_i)), nine launches on the
// caller's stream:
//   1, 2. the forward's (a) chunk states and (b) state passing
//         (ssd_scan.cuh), for each chunk's previous state S_prev (bf16
//         hi/lo) and the (cum, dt) pairs;
//   3.    (a) again with C for B, dy for x and e for w: dS_prev = C^T (e dy),
//         y's gradient of each chunk's previous state;
//   4.    ssd_bwd_state_pass, one block per (b, h): the state recurrence in
//         reverse, g <- g 2^(cum_L) + dS_prev, keeping each chunk's g (the
//         gradient of the state after it) as bf16 hi/lo and
//         dd_c = <g, S_prev>, a fixed-order block sum over N x P;
//   5.    ssd_bwd_keys, one warpgroup per (b, h, chunk, 64-key tile): the
//         query tiles at or below the diagonal stream through a 2-stage
//         TMA ring; per tile S^T = B C^T and dM^T = x dy^T on wgmma, the
//         decay and dt_j on the accumulator fragments, then dx += M^T dy
//         and dB += dS^T C with M^T and dS^T (bf16) as register A operands;
//         at the end B g and x g^T (g as hi/lo) give the chunk-state terms
//         dx += w (B g), dB += w (x g^T) and d w. dx is written in bf16, dB
//         per head in fp32 scratch, with the row sums that feed ddt;
//   6.    ssd_bwd_queries, one warpgroup per (b, h, chunk, 64-query tile):
//         the key tiles at or below the diagonal; S = C B^T, dM = dy x^T,
//         dC += dS B; at the end C S_prev and dy S_prev^T (S_prev as hi/lo)
//         give y's inter-chunk terms of dC and of d cum;
//   7.    ssd_bwd_finish, one block per (b, h, chunk): d cum, its reverse
//         cumsum, ddt = ... + d(dt a) a, and the chunk's share of dA;
//   8, 9. fixed-order sums: dB and dC over the heads of a group, dA over
//         (b, chunk).
// No atomics: two calls give bit-identical results. Scratch is one
// workspace the caller allocates (ssd_scan_bwd_workspace_bytes); the
// kernels allocate nothing.
//
// Operand precision, chosen by a CPU emulation of these roundings at one
// mamba2_780m head geometry (tests/test_torch_ssd_grad.py,
// test_ssd_bwd_kernel_rounding_at_mamba2_geometry): C B^T and dy x^T take
// exact bf16 inputs. M^T and dS^T go into their products as plain bf16:
// dx, dB and dC are bf16 outputs held to one bf16 step of their largest
// magnitude (8e-3), and the emulation puts them at ~3e-3 so. g (like
// S_prev and the forward's w o x, and e o dy in launch 3) is split into
// bf16 hi + lo, two wgmmas into one fp32 accumulator: ddt and dA are held
// to 1e-4 of their largest magnitude, and a plain bf16 g puts ddt at
// ~3e-4. dA is summed directly as sum_ij dseg_ij (cdt_i - cdt_j) plus the
// other terms of d cum weighted by cdt = cumsum(dt) (cdt = cum / a): the
// same quantity as sum_k dt_k revcumsum(d cum)_k, but without its
// cancellation between the row and column sums of dseg, which cost fp32
// ~1e-4 of dA in the emulation (a = 0 makes dA NaN; Mamba-2's
// A = -exp(A_log) is never 0).
//
// Layouts by element strides: x, dy, dx [B, S, H, P], dt, ddt [B, S, H],
// A [H], B/C [B, S, G, N] read at group h / (H / G); dB, dC contiguous
// [B, S, G, N]; dstate (optional) contiguous fp32 [B, H, N, P]. Rows past
// a chunk's end are neither used nor stored.

#include "ssd_scan.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BWD_THREADS = 128;        // (5), (6): one warpgroup
constexpr int BWD_STAGES = 2;
constexpr int FIN_THREADS = 256;        // (4), (7)
constexpr int SUM_THREADS = 256;        // (8)

// Byte offsets of the backward's scratch after the forward's workspace.
struct BwdWorkspace {
  Workspace fwd;   // (cum, dt) pairs; S_c, then C^T (e dy); S_prev hi/lo
  size_t state;    // the re-run forward's final state, unused
  size_t gs;       // g per chunk, [bhc][hi, lo][N][P] bf16
  size_t dd;       // <g, S_prev> per chunk
  size_t rows;     // 4 x [bhc][pitch]: qa, qb, ka, kb (fp32)
  size_t daseg;    // [bhc][key tiles]: sum dseg (cum_i - cum_j)
  size_t dapart;   // [bhc]: the chunk's share of dA
  size_t dbh, dch;  // [B][S][H][N] fp32: dB and dC per head
  size_t bytes;
};

inline BwdWorkspace bwd_workspace(int batch, int S, int H, int N,
                                  int chunk) {
  const size_t bh = static_cast<size_t>(batch) * H;
  const size_t bhc = bh * (S / chunk);
  const size_t n_kt = (chunk + KT - 1) / KT;
  BwdWorkspace w;
  w.fwd = workspace(batch, S, H, N, chunk);
  w.state = w.fwd.bytes;
  w.gs = w.state + round_up(bh * N * P * sizeof(float), 1024);
  w.dd = w.gs + round_up(bhc * 2 * N * P * sizeof(bf16), 1024);
  w.rows = w.dd + round_up(bhc * sizeof(float), 1024);
  w.daseg = w.rows + round_up(4 * bhc * chunk_pitch(chunk) * sizeof(float),
                              1024);
  w.dapart = w.daseg + round_up(bhc * n_kt * sizeof(float), 1024);
  w.dbh = w.dapart + round_up(bhc * sizeof(float), 1024);
  const size_t per_head = static_cast<size_t>(batch) * S * H * N;
  w.dch = w.dbh + round_up(per_head * sizeof(float), 1024);
  w.bytes = w.dch + round_up(per_head * sizeof(float), 1024);
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

// ---------------------------------------------------------------------------
// (4) the state recurrence in reverse
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
// (5), (6) the chunk kernels
// ---------------------------------------------------------------------------

template <int NB>                       // 64-wide boxes over N
struct BwdTiles {
  static constexpr int NT = NB * TILE;          // [64 rows][64 NB] of B or C
  static constexpr int ST = NB * TILE;          // [64 NB n][64 p]: g, S_prev
  static constexpr int STAGE = NT + TILE;       // streamed: B or C, x or dy
  static constexpr int SMEM = NT + TILE + 2 * ST + BWD_STAGES * STAGE + 1024;
};

// The two [64 x 64] products of a tile pair over N and P: s = a1 b1^T (K
// over the NB boxes of N), dm = a2 b2^T (K over P), all K-major.
template <int NB>
__device__ __forceinline__ void pair_products(float (&s)[32], float (&dm)[32],
                                              const uint8_t* a1,
                                              const uint8_t* b1,
                                              const uint8_t* a2,
                                              const uint8_t* b2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dm[i] = 0.f;
  fence_regs(s);
  fence_regs(dm);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk)
    Wgmma<KT, 0, 0>::ss(s, desc_kmajor(a1, kk, TILE), desc_kmajor(b1, kk, TILE),
                        1);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    Wgmma<KT, 0, 0>::ss(dm, desc_kmajor(a2, kk, TILE),
                        desc_kmajor(b2, kk, TILE), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dm);
}

// The two products of the resident tiles with a [N][P] state held as
// bf16 hi + lo (two wgmmas each): o1 = a1 st (K over N, st MN-major,
// [64 x P]) and o2 = a2 st^T (K over P, st K-major, [64 x 64 NB]).
template <int NB>
__device__ __forceinline__ void state_products(float (&o1)[32],
                                               float (&o2)[NB * 32],
                                               const uint8_t* a1,
                                               const uint8_t* a2,
                                               const uint8_t* hi,
                                               const uint8_t* lo) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) o2[i] = 0.f;
  fence_regs(o1);
  fence_regs(o2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk) {
    const uint64_t da = desc_kmajor(a1, kk, TILE);
    Wgmma<P, 0, 1>::ss(o1, da, desc_mnmajor(hi, kk, TILE), 1);
    Wgmma<P, 0, 1>::ss(o1, da, desc_mnmajor(lo, kk, TILE), 1);
  }
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    const uint64_t da = desc_kmajor(a2, kk, TILE);
    Wgmma<NB * 64, 0, 0>::ss(o2, da, desc_kmajor(hi, kk, TILE), 1);
    Wgmma<NB * 64, 0, 0>::ss(o2, da, desc_kmajor(lo, kk, TILE), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o1);
  fence_regs(o2);
}

// <v, row> over this thread's 16 columns of one fragment row half and
// the 4 lanes that share the row: sum_p v[row, p] t[row, p], t a bf16 row
// in device memory (null: 0).
__device__ __forceinline__ float row_dot(const float (&v)[32], int half,
                                         const bf16* row, int lane) {
  float s = 0.f;
  if (row != nullptr) {
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(row + 8 * i +
                                                   2 * (lane % 4)));
      s += v[4 * i + 2 * half] * t.x + v[4 * i + 2 * half + 1] * t.y;
    }
  }
  return quad_sum(s);
}

// One fp32 row of [.., N] per head (dB or dC) from a [64 x 64 NB]
// fragment, columns below N.
template <int NB>
__device__ __forceinline__ void store_row_n(float* out,
                                            const float (&v)[NB * 32],
                                            int half, int N, int lane) {
#pragma unroll
  for (int i = 0; i < NB * 8; ++i) {
    const int n = 8 * i + 2 * (lane % 4);
    if (n < N)
      *reinterpret_cast<float2*>(out + n) =
          make_float2(v[4 * i + 2 * half], v[4 * i + 2 * half + 1]);
  }
}

struct Chunk {
  int bhc, b, h, g, c0;
};

__device__ __forceinline__ Chunk chunk_of(int bhc, int S, int H, int G,
                                          int chunk) {
  Chunk k;
  k.bhc = bhc;
  const int bh = bhc / (S / chunk);
  k.b = bh / H;
  k.h = bh % H;
  k.g = k.h / (H / G);
  k.c0 = bhc % (S / chunk) * chunk;
  return k;
}

// (5) one block per (b, h, chunk, key tile): dx, dB per head, the key rows'
// sums ka (sum_i dM^T S^T decay = d dt_j of the intra-chunk term), kb
// (d w_j) and the tile's sum of dseg (cum_i - cum_j).
template <int NB>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ssd_bwd_keys(const __grid_constant__ CUtensorMap tb,
             const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tc,
             const __grid_constant__ CUtensorMap tdy,
             const __grid_constant__ CUtensorMap tg,
             const float2* __restrict__ cd, const bf16* __restrict__ x,
             bf16* __restrict__ dx, float* __restrict__ dbh,
             float* __restrict__ ka, float* __restrict__ kb,
             float* __restrict__ daseg, int S, int H, int G, int N,
             int chunk, Strides xs, Strides dxs) {
  using T = BwdTiles<NB>;
  __shared__ __align__(8) uint64_t res_full;
  __shared__ __align__(8) uint64_t full[BWD_STAGES];
  __shared__ __align__(16) float2 kpair[KT];
  __shared__ __align__(16) float2 qpair[BWD_STAGES][KT];
  __shared__ float red[BWD_THREADS / 32];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bt = align1024(smem_raw);    // resident: B, x, g hi, g lo
  uint8_t* xt = bt + T::NT;
  uint8_t* ghi = xt + TILE;
  uint8_t* glo = ghi + T::ST;
  uint8_t* ring = glo + T::ST;          // stage: C tile, dy tile

  const int n_kt = (chunk + KT - 1) / KT;
  const Chunk ck = chunk_of(blockIdx.x / n_kt, S, H, G, chunk);
  const int kt = blockIdx.x % n_kt, k0 = kt * KT;
  const int lp = chunk_pitch(chunk);
  const float2* cdc = cd + static_cast<long long>(ck.bhc) * lp;
  const int items = n_kt - kt;          // query tiles kt .. n_kt - 1
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&res_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_q = [&](int t, int s) {
    const int row = ck.c0 + (kt + t) * KT;
    uint8_t* st = ring + s * T::STAGE;
    mbar_expect_tx(&full[s], T::STAGE + KV_BYTES);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(st + j * TILE, &tc, &full[s], j * BOX, ck.g, row, ck.b);
    tma_load_4d(st + T::NT, &tdy, &full[s], 0, ck.h, row, ck.b);
    bulk_load(qpair[s], cdc + (kt + t) * KT, KV_BYTES, &full[s]);
  };
  if (tid == 0) {
    mbar_expect_tx(&res_full, T::NT + TILE + 2 * T::ST + KV_BYTES);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(bt + j * TILE, &tb, &res_full, j * BOX, ck.g, ck.c0 + k0,
                  ck.b);
    tma_load_4d(xt, &tx, &res_full, 0, ck.h, ck.c0 + k0, ck.b);
    tma_load_3d(ghi, &tg, &res_full, 0, 0, 2 * ck.bhc);
    tma_load_3d(glo, &tg, &res_full, 0, 0, 2 * ck.bhc + 1);
    bulk_load(kpair, cdc + k0, KV_BYTES, &res_full);
    for (int t = 0; t < min(BWD_STAGES, items); ++t) load_q(t, t);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int jr = 16 * warp + lane / 4;  // this thread's key rows jr (+ 8)
  float acc_dx[32], acc_db[NB * 32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dx[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc_db[i] = 0.f;
  float rk[2] = {0.f, 0.f}, dseg = 0.f;

  mbar_wait(&res_full, 0);
  float cj[2], dtj[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    cj[half] = kpair[jr + 8 * half].x;
    dtj[half] = kpair[jr + 8 * half].y;
  }

  for (int t = 0; t < items; ++t) {
    const int s = t % BWD_STAGES, q0 = (kt + t) * KT;
    mbar_wait(&full[s], (t / BWD_STAGES) & 1);
    const uint8_t* ct = ring + s * T::STAGE;
    const uint8_t* dyt = ct + T::NT;

    float sc[32], dm[32];               // S^T, dM^T: [64 keys][64 queries]
    pair_products<NB>(sc, dm, bt, ct, xt, dyt);
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * (lane % 4) + e;
        const int qi = q0 + col;        // query position in the chunk
        const float ci = qpair[s][col].x;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int idx = 4 * i + 2 * half + e;
          const bool ok = k0 + jr + 8 * half <= qi && qi < chunk;
          const float seg = ci - cj[half];
          const float dec = ex2(ok ? seg : -INFINITY);
          const float tt = dm[idx] * sc[idx] * dec;
          rk[half] += tt;
          dseg += ok ? tt * dtj[half] * seg : 0.f;
          const float f = dec * dtj[half];
          sc[idx] *= f;                 // M^T
          dm[idx] *= f;                 // dS^T
        }
      }
    uint32_t ma[KT / 16][4], sa[KT / 16][4];
    pack_a<KT / 16>(sc, ma);
    pack_a<KT / 16>(dm, sa);
    fence_regs(acc_dx);
    fence_regs(acc_db);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      Wgmma<P, 0, 1>::rs(acc_dx, ma[kk], desc_mnmajor(dyt, kk, TILE), 1);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      Wgmma<NB * 64, 0, 1>::rs(acc_db, sa[kk], desc_mnmajor(ct, kk, TILE), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dx);
    fence_regs(acc_db);

    __syncthreads();                    // stage s free
    if (tid == 0 && t + BWD_STAGES < items) load_q(t + BWD_STAGES, s);
  }

  // the chunk-state terms: dx += w (B g), dB += w (x g^T), d w = <B g, x>
  float bg[32], xg[NB * 32];
  state_products<NB>(bg, xg, bt, xt, ghi, glo);
  const float cl = cdc[chunk - 1].x;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = k0 + jr + 8 * half;
    const bool in = j < chunk;
    const float w = in ? ex2(cl - cj[half]) * dtj[half] : 0.f;
    const long long pos = ck.c0 + j;
    const float dw =
        row_dot(bg, half, in ? x + ck.b * xs.b + ck.h * xs.h + pos * xs.s
                             : nullptr, lane);
    const float r = quad_sum(rk[half]);
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      acc_dx[4 * i + 2 * half] += w * bg[4 * i + 2 * half];
      acc_dx[4 * i + 2 * half + 1] += w * bg[4 * i + 2 * half + 1];
    }
#pragma unroll
    for (int i = 0; i < NB * 8; ++i) {
      acc_db[4 * i + 2 * half] += w * xg[4 * i + 2 * half];
      acc_db[4 * i + 2 * half + 1] += w * xg[4 * i + 2 * half + 1];
    }
    if (in) {
      if (lane % 4 == 0) {
        ka[static_cast<long long>(ck.bhc) * lp + j] = r;
        kb[static_cast<long long>(ck.bhc) * lp + j] = dw;
      }
      bf16* drow = dx + ck.b * dxs.b + ck.h * dxs.h + pos * dxs.s;
#pragma unroll
      for (int i = 0; i < P / 8; ++i)
        *reinterpret_cast<uint32_t*>(drow + 8 * i + 2 * (lane % 4)) =
            pack_bf16(acc_dx[4 * i + 2 * half], acc_dx[4 * i + 2 * half + 1]);
      store_row_n<NB>(dbh + ((ck.b * static_cast<long long>(S) + pos) * H +
                             ck.h) * N,
                      acc_db, half, N, lane);
    }
  }
  dseg = block_sum<BWD_THREADS>(dseg, red);
  if (tid == 0) daseg[static_cast<long long>(ck.bhc) * n_kt + kt] = dseg;
}

// (6) one block per (b, h, chunk, query tile): dC per head and the query
// rows' sums qa (sum_j dseg_ij) and qb (e_i <dy_i, (C S_prev)_i>).
template <int NB>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ssd_bwd_queries(const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tc,
                const __grid_constant__ CUtensorMap tdy,
                const __grid_constant__ CUtensorMap tsp,
                const float2* __restrict__ cd, const bf16* __restrict__ dy,
                float* __restrict__ dch, float* __restrict__ qa,
                float* __restrict__ qb, int S, int H, int G, int N,
                int chunk, Strides dys) {
  using T = BwdTiles<NB>;
  __shared__ __align__(8) uint64_t res_full;
  __shared__ __align__(8) uint64_t full[BWD_STAGES];
  __shared__ __align__(16) float2 qpair[KT];
  __shared__ __align__(16) float2 kpair[BWD_STAGES][KT];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ct = align1024(smem_raw);    // resident: C, dy, S_prev hi, lo
  uint8_t* dyt = ct + T::NT;
  uint8_t* sph = dyt + TILE;
  uint8_t* spl = sph + T::ST;
  uint8_t* ring = spl + T::ST;          // stage: B tile, x tile

  const int n_qt = (chunk + KT - 1) / KT;
  const Chunk ck = chunk_of(blockIdx.x / n_qt, S, H, G, chunk);
  const int qt = blockIdx.x % n_qt, q0 = qt * KT;
  const int lp = chunk_pitch(chunk);
  const float2* cdc = cd + static_cast<long long>(ck.bhc) * lp;
  const int items = qt + 1;             // key tiles 0 .. qt
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&res_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_k = [&](int t, int s) {
    const int row = ck.c0 + t * KT;
    uint8_t* st = ring + s * T::STAGE;
    mbar_expect_tx(&full[s], T::STAGE + KV_BYTES);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(st + j * TILE, &tb, &full[s], j * BOX, ck.g, row, ck.b);
    tma_load_4d(st + T::NT, &tx, &full[s], 0, ck.h, row, ck.b);
    bulk_load(kpair[s], cdc + t * KT, KV_BYTES, &full[s]);
  };
  if (tid == 0) {
    mbar_expect_tx(&res_full, T::NT + TILE + 2 * T::ST + KV_BYTES);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(ct + j * TILE, &tc, &res_full, j * BOX, ck.g, ck.c0 + q0,
                  ck.b);
    tma_load_4d(dyt, &tdy, &res_full, 0, ck.h, ck.c0 + q0, ck.b);
    tma_load_3d(sph, &tsp, &res_full, 0, 0, 2 * ck.bhc);
    tma_load_3d(spl, &tsp, &res_full, 0, 0, 2 * ck.bhc + 1);
    bulk_load(qpair, cdc + q0, KV_BYTES, &res_full);
    for (int t = 0; t < min(BWD_STAGES, items); ++t) load_k(t, t);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int ir = 16 * warp + lane / 4;  // this thread's query rows ir (+ 8)
  float acc_dc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc_dc[i] = 0.f;
  float rq[2] = {0.f, 0.f};

  mbar_wait(&res_full, 0);
  float ci[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) ci[half] = qpair[ir + 8 * half].x;

  for (int t = 0; t < items; ++t) {
    const int s = t % BWD_STAGES, j0 = t * KT;
    mbar_wait(&full[s], (t / BWD_STAGES) & 1);
    const uint8_t* bt = ring + s * T::STAGE;
    const uint8_t* xt = bt + T::NT;

    float sc[32], dm[32];               // S, dM: [64 queries][64 keys]
    pair_products<NB>(sc, dm, ct, bt, dyt, xt);
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * (lane % 4) + e;
        const float2 kj = kpair[s][col];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int idx = 4 * i + 2 * half + e;
          const int qi = q0 + ir + 8 * half;
          const bool ok = j0 + col <= qi && qi < chunk;
          const float f = ex2(ok ? ci[half] - kj.x : -INFINITY) * kj.y;
          dm[idx] *= f;                 // dS
          rq[half] += dm[idx] * sc[idx];
        }
      }
    uint32_t sa[KT / 16][4];
    pack_a<KT / 16>(dm, sa);
    fence_regs(acc_dc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      Wgmma<NB * 64, 0, 1>::rs(acc_dc, sa[kk], desc_mnmajor(bt, kk, TILE), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dc);

    __syncthreads();                    // stage s free
    if (tid == 0 && t + BWD_STAGES < items) load_k(t + BWD_STAGES, s);
  }

  // y's inter-chunk term: dC += e (dy S_prev^T), d cum_i += e <dy, C S_prev>
  float cs[32], dys_p[NB * 32];
  state_products<NB>(cs, dys_p, ct, dyt, sph, spl);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + ir + 8 * half;
    const bool in = i < chunk;
    const float e = in ? ex2(ci[half]) : 0.f;
    const long long pos = ck.c0 + i;
    const float d = row_dot(cs, half, in ? dy + ck.b * dys.b +
                                               ck.h * dys.h + pos * dys.s
                                         : nullptr, lane);
    const float r = quad_sum(rq[half]);
#pragma unroll
    for (int k = 0; k < NB * 8; ++k) {
      acc_dc[4 * k + 2 * half] += e * dys_p[4 * k + 2 * half];
      acc_dc[4 * k + 2 * half + 1] += e * dys_p[4 * k + 2 * half + 1];
    }
    if (in) {
      if (lane % 4 == 0) {
        qa[static_cast<long long>(ck.bhc) * lp + i] = r;
        qb[static_cast<long long>(ck.bhc) * lp + i] = e * d;
      }
      store_row_n<NB>(dch + ((ck.b * static_cast<long long>(S) + pos) * H +
                             ck.h) * N,
                      acc_dc, half, N, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// (7) d cum, its reverse cumsum, ddt and the chunk's dA
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
      v = qa[base + i] + qb[base + i] - p.y * ka[base + i] -
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
// (8), (9) fixed-order sums over heads
// ---------------------------------------------------------------------------

// dB, dC [B, S, G, N] (bf16) = sum over the H / G heads of each group of
// the per-head fp32 rows, in head order; one thread per 2 values.
__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_group_sum(const float* __restrict__ dbh, const float* __restrict__ dch,
                  bf16* __restrict__ db, bf16* __restrict__ dc, int H, int G,
                  int N, long long pairs) {
  const long long e = static_cast<long long>(blockIdx.x) * SUM_THREADS +
                      threadIdx.x;
  if (e >= pairs) return;
  const int half_n = N / 2;
  const int n = 2 * static_cast<int>(e % half_n);
  const long long bsg = e / half_n;
  const int g = static_cast<int>(bsg % G);
  const long long bs = bsg / G;
  const int rep = H / G;
  float2 sb = make_float2(0.f, 0.f), sc = make_float2(0.f, 0.f);
  for (int r = 0; r < rep; ++r) {
    const long long at = (bs * H + g * rep + r) * N + n;
    const float2 vb = *reinterpret_cast<const float2*>(dbh + at);
    const float2 vc = *reinterpret_cast<const float2*>(dch + at);
    sb.x += vb.x;
    sb.y += vb.y;
    sc.x += vc.x;
    sc.y += vc.y;
  }
  *reinterpret_cast<uint32_t*>(db + 2 * e) = pack_bf16(sb.x, sb.y);
  *reinterpret_cast<uint32_t*>(dc + 2 * e) = pack_bf16(sc.x, sc.y);
}

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
                       const float* dstate, bf16* dx, float* ddt, float* da,
                       bf16* db, bf16* dc, uint8_t* work, int batch, int S,
                       int H, int G, int N, int chunk, const long long* st,
                       cudaStream_t stream) {
  const BwdWorkspace ws = bwd_workspace(batch, S, H, N, chunk);
  float2* cd = reinterpret_cast<float2*>(work);
  float* sc = reinterpret_cast<float*>(work + ws.fwd.sc);
  bf16* sp = reinterpret_cast<bf16*>(work + ws.fwd.sp);
  float* state = reinterpret_cast<float*>(work + ws.state);
  bf16* gs = reinterpret_cast<bf16*>(work + ws.gs);
  float* dd = reinterpret_cast<float*>(work + ws.dd);
  const long long bhc = static_cast<long long>(batch) * H * (S / chunk);
  const size_t rows = bhc * chunk_pitch(chunk);
  float* qa = reinterpret_cast<float*>(work + ws.rows);
  float* qb = qa + rows;
  float* ka = qb + rows;
  float* kb = ka + rows;
  float* daseg = reinterpret_cast<float*>(work + ws.daseg);
  float* dapart = reinterpret_cast<float*>(work + ws.dapart);
  float* dbh = reinterpret_cast<float*>(work + ws.dbh);
  float* dch = reinterpret_cast<float*>(work + ws.dch);
  const int nc = S / chunk, n_kt = (chunk + KT - 1) / KT;

  CUtensorMap tx, tb, tc, tdy, tsp, tg;
  if (!make_tmap_bshw(&tx, x, P, batch, S, H, st, KT) ||
      !make_tmap_bshw(&tb, Bm, N, batch, S, G, st + 7, KT) ||
      !make_tmap_bshw(&tc, Cm, N, batch, S, G, st + 10, KT) ||
      !make_tmap_bshw(&tdy, dy, P, batch, S, H, st + 13, KT) ||
      !make_tmap_state(&tsp, sp, bhc, N, NB) ||
      !make_tmap_state(&tg, gs, bhc, N, NB))
    return cudaErrorInvalidValue;

  static unsigned long long fwd_devices = 0, dy_devices = 0, key_devices = 0,
                            query_devices = 0;
  cudaError_t err = allow_smem(ssd_chunk_state<NB, false>,
                               StateTiles<NB>::SMEM, fwd_devices);
  if (err == cudaSuccess)
    err = allow_smem(ssd_chunk_state<NB, true>, StateTiles<NB>::SMEM,
                     dy_devices);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_keys<NB>, BwdTiles<NB>::SMEM, key_devices);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_queries<NB>, BwdTiles<NB>::SMEM, query_devices);
  if (err != cudaSuccess) return err;

  const Strides dts{st[3], st[4], st[5]};
  // 1, 2: the forward's chunk states and state passing
  ssd_chunk_state<NB, false><<<static_cast<unsigned>(bhc), STATE_THREADS,
                               StateTiles<NB>::SMEM, stream>>>(
      tb, tx, dt, A, cd, sc, S, H, G, N, chunk, dts, st[6]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long quads = static_cast<long long>(batch) * H * N * P / 4;
  ssd_state_pass<<<static_cast<unsigned>((quads + PASS_THREADS - 1) /
                                         PASS_THREADS),
                   PASS_THREADS, 0, stream>>>(cd, sc, sp, state, S, N, chunk,
                                              quads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3: C^T (e dy) into the chunk states' place
  ssd_chunk_state<NB, true><<<static_cast<unsigned>(bhc), STATE_THREADS,
                              StateTiles<NB>::SMEM, stream>>>(
      tc, tdy, dt, A, cd, sc, S, H, G, N, chunk, dts, st[6]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4: the recurrence in reverse
  ssd_bwd_state_pass<<<static_cast<unsigned>(batch * H), FIN_THREADS, 0,
                       stream>>>(cd, sp, sc, dstate, gs, dd, S, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 5, 6: the chunk kernels
  ssd_bwd_keys<NB><<<static_cast<unsigned>(bhc * n_kt), BWD_THREADS,
                     BwdTiles<NB>::SMEM, stream>>>(
      tb, tx, tc, tdy, tg, cd, static_cast<const bf16*>(x), dx, dbh, ka, kb,
      daseg, S, H, G, N, chunk, Strides{st[0], st[1], st[2]},
      Strides{st[16], st[17], st[18]});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_queries<NB><<<static_cast<unsigned>(bhc * n_kt), BWD_THREADS,
                        BwdTiles<NB>::SMEM, stream>>>(
      tb, tx, tc, tdy, tsp, cd, static_cast<const bf16*>(dy), dch, qa, qb, S,
      H, G, N, chunk, Strides{st[13], st[14], st[15]});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 7: d cum, ddt, dA per chunk
  ssd_bwd_finish<<<static_cast<unsigned>(bhc), FIN_THREADS, 0, stream>>>(
      cd, A, qa, qb, ka, kb, dd, daseg, ddt, dapart, S, H, chunk, st[6],
      Strides{st[19], st[20], st[21]});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 8, 9: the sums over heads
  const long long pairs = static_cast<long long>(batch) * S * G * N / 2;
  ssd_bwd_group_sum<<<static_cast<unsigned>((pairs + SUM_THREADS - 1) /
                                            SUM_THREADS),
                      SUM_THREADS, 0, stream>>>(dbh, dch, db, dc, H, G, N,
                                                pairs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da<<<1, 128, 0, stream>>>(dapart, da, batch, H, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace ssd_scan_bwd_bf16 needs for these sizes (0 for
// shapes it does not take).
long long ssd_scan_bwd_workspace_bytes(int batch, int S, int H, int N,
                                       int chunk) {
  if (batch < 1 || S < 1 || H < 1 || !admit(S, H, 1, N, P, chunk)) return 0;
  return static_cast<long long>(bwd_workspace(batch, S, H, N, chunk).bytes);
}

// strides: 22 element strides: (batch, seq, head) of x, of dt, the head
// stride of A, (batch, seq, group) of B, of C, and (batch, seq, head) of
// dy, of dx and of ddt; those of x, B, C, dy and dx multiples of 8 with
// 16-byte aligned data. dstate: null or a contiguous fp32 [batch, H, N, P];
// dA: fp32 [H]; dB, dC: contiguous bf16 [batch, S, G, N]; work: a 16-byte
// aligned buffer of ssd_scan_bwd_workspace_bytes(batch, S, H, N, chunk)
// bytes. Issues nine launches on `stream` and returns the first non-zero
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the kernels do not take.
int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* dy,
                      const void* dstate, void* dx, void* ddt, void* dA,
                      void* dB, void* dC, void* work, int batch, int S, int H,
                      int G, int N, int p, int chunk,
                      const long long* strides, void* stream) {
  if (batch < 1 || H < 1 || !admit(S, H, G, N, p, chunk))
    return cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  const float* dsp = static_cast<const float*>(dstate);
  bf16* dxp = static_cast<bf16*>(dx);
  float* ddtp = static_cast<float*>(ddt);
  float* dap = static_cast<float*>(dA);
  bf16* dbp = static_cast<bf16*>(dB);
  bf16* dcp = static_cast<bf16*>(dC);
  uint8_t* wp = static_cast<uint8_t*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > BOX)
    return launch_bwd<2>(x, dtp, ap, B, C, dy, dsp, dxp, ddtp, dap, dbp, dcp,
                         wp, batch, S, H, G, N, chunk, strides, s);
  return launch_bwd<1>(x, dtp, ap, B, C, dy, dsp, dxp, ddtp, dap, dbp, dcp,
                       wp, batch, S, H, G, N, chunk, strides, s);
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
