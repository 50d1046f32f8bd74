// Flash attention backward (causal or not, native GQA) for Hopper
// (sm_90a), bf16 in and out, fp32 inside.
//
// Stands for the gradient of the Pallas TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py:flash_attention
// (pallas_call at :83). That kernel is forward-only: the reference's
// gradients are XLA's autodiff of its attention einsums, outside any
// Pallas kernel. This file computes what that gradient computes, as the
// port's plain version kernels/flash_attn/ops.py:attention_bwd does:
// dq, dk, dv of softmax(Q K^T * scale) V with GQA (dk and dv summed over
// the H / KV query heads of a group) and causal queries end-aligned
// (q_offset = skv - sq), with its rounding points: bf16 operands into
// fp32 accumulators, P rounded to bf16 before P^T dO, dS rounded to bf16
// before dS K and dS^T Q, the softmax and dS = P (dP - D) in fp32.
//
// P is not stored by the forward: it is recomputed from the row
// log-sum-exp the forward writes (csrc/flash_attn.cu, `lse`, in log2
// units of the scaled scores: m + log2(max(l, 1e-20))), as
// P = 2^(s * scale * log2(e) - lse), masked scores at the forward's -1e30
// and keys past the end at -inf. D = rowsum(dO o O) is a small first
// launch (flash_bwd_delta) over the saved bf16 O.
//
// What bounds it on an H100: at olmo_1b's train shape (B = 4, S = 2048,
// H = 16, hd = 128, causal) chip_smoke.py counts the five products over
// the kept (query, key) pairs, ~172 GFLOP, against ~235 MB of q, k, v, dO
// and the three gradients: the tensor cores bound it (0.17 ms at 989
// TFLOP/s; the bytes take 0.07 ms). This first design recomputes S and dP
// in both kernels below (7 products, not 5), so it can reach at best 5/7
// of that bound.
//
// Determinism. Every output element is summed by one thread in a fixed
// order, no atomics, so two calls give the same bits (chip_smoke checks a
// granite_moe_1b_a400m train step twice, bitwise). Hence two kernels
// after the delta pass, each a single warpgroup of 128 threads working on
// 64-row tiles with wgmma (bf16, fp32 accumulators) from TMA-loaded,
// 128B-swizzled shared memory, as the forward:
//   flash_bwd_dkdv, one block per (batch, KV head, 64-key tile): K and V
//     are loaded once; the block walks the G query heads of the group and,
//     for each, the 64-query tiles that reach the key tile (causal: from
//     the diagonal on), Q and dO tiles streaming through a 2-stage TMA
//     ring. Per tile: S^T = K Q^T and dP^T = V dO^T (wgmma, shared-memory
//     operands), P^T and dS^T on the accumulator fragments, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T as bf16 register A
//     operands. dK and dV stay in registers and are written once.
//   flash_bwd_dq, one block per (batch, head, 64-query tile): Q and dO
//     loaded once, K and V tiles streamed (causal: up to the diagonal);
//     S = Q K^T, dP = dO V^T, dS on the fragments, dQ += dS K; dQ written
//     once.
// Register pressure at hd 128 is what shapes the tiles: kernel A holds
// two fp32 [64 x hd] accumulators (128 registers a thread) beside S^T and
// dP^T (64), so one warpgroup takes 64 keys and the block is that one
// warpgroup.
//
// Layout: q, o, dO, dq [B, Sq, H, hd], k, v, dk, dv [B, Skv, KV, hd] by
// element strides (multiples of 8, unit stride on hd), so the model layout
// and the Pallas layout [BH, S, hd] (as B = 1, H = BH) run without a copy;
// lse and D are fp32 [B, H, Sq]. Lengths need not divide 64: TMA
// zero-fills rows past the end, such query rows get lse = +inf (P = 0),
// keys past the end are -inf, and rows past the end are not stored.

#include <math.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int T = 64;                   // rows of every tile
constexpr int THREADS = 128;            // one warpgroup
constexpr int STAGES = 2;
constexpr int DELTA_THREADS = 256;      // 8 rows a block
constexpr float MASK_VALUE = -1e30f;    // the forward's masked score
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int NBOX = (HD + BOX - 1) / BOX;   // 64-wide boxes
  static constexpr int KSTEPS = HD / 16;              // k steps over hd
  static constexpr int BOX_BYTES = T * BOX_ROW_BYTES;  // [64 rows][64]
  static constexpr int TILE = NBOX * BOX_BYTES;       // one [64][hd] tile
  // two resident tiles and a ring of two tiles a stage
  static constexpr int SMEM = 2 * TILE + STAGES * 2 * TILE + 1024;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
};

struct Strides {
  long long b, s, h;                    // element strides of [B, S, H, hd]
};

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], one warp per row,
// summed in a fixed order (lane pairs, then a shuffle tree).
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                float* __restrict__ delta, int H, int sq, int hd, Strides os,
                Strides ds, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (DELTA_THREADS / 32) +
      threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int h = static_cast<int>(row % H);
  const long long bi = row / H;
  const int i = static_cast<int>(bi % sq);
  const int b = static_cast<int>(bi / sq);
  const bf16* orow = o + b * os.b + i * os.s + h * os.h;
  const bf16* drow = dout + b * ds.b + i * ds.s + h * ds.h;
  float acc = 0.f;
  for (int c = 2 * lane; c < hd; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(drow + c));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * sq + i] = acc;
}

// The two [64 x 64] score-shaped products of a tile pair: s = A1 B1^T and
// dp = A2 B2^T over hd, all four operands K-major tiles in shared memory.
template <int HD>
__device__ __forceinline__ void two_products(float (&s)[32], float (&dp)[32],
                                             const uint8_t* a1,
                                             const uint8_t* b1,
                                             const uint8_t* a2,
                                             const uint8_t* b2) {
  using Tl = Tiles<HD>;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Tl::KSTEPS; ++kk)
    Wgmma<T, 0, 0>::ss(s, desc_kmajor(a1, kk, Tl::BOX_BYTES),
                       desc_kmajor(b1, kk, Tl::BOX_BYTES), 1);
#pragma unroll
  for (int kk = 0; kk < Tl::KSTEPS; ++kk)
    Wgmma<T, 0, 0>::ss(dp, desc_kmajor(a2, kk, Tl::BOX_BYTES),
                       desc_kmajor(b2, kk, Tl::BOX_BYTES), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (batch, KV head, 64-key tile)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV,
               int sq, int skv, int causal, float scale_log2, float scale,
               Strides dks, Strides dvs) {
  using Tl = Tiles<HD>;
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ float stats[STAGES][2][T];   // a stage's query rows: lse, D
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + Tl::TILE;
  uint8_t* ring = vs + Tl::TILE;          // stage s: Q tile, dO tile

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * T;
  const int q_offset = skv - sq;
  const int n_qt = (sq + T - 1) / T;
  // query rows i reach key k0 when i + q_offset >= k0 (causal)
  const int qt0 = causal ? max(0, k0 - q_offset) / T : 0;
  const int per_head = n_qt - qt0;
  const int items = G * per_head;         // (head, query tile) pairs
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_item = [&](int t, int s) {   // one thread: TMA of Q, dO tiles
    const int h = kvh * G + t / per_head, qt = qt0 + t % per_head;
    uint8_t* st = ring + s * 2 * Tl::TILE;
    mbar_expect_tx(&full[s], 2 * Tl::TILE);
#pragma unroll
    for (int j = 0; j < Tl::NBOX; ++j) {
      tma_load_4d(st + j * Tl::BOX_BYTES, &tq, &full[s], j * BOX, h, qt * T,
                  b);
      tma_load_4d(st + Tl::TILE + j * Tl::BOX_BYTES, &tdo, &full[s], j * BOX,
                  h, qt * T, b);
    }
  };
  auto load_stats = [&](int t, int s) {  // all threads: lse and D rows
    const int h = kvh * G + t / per_head, qt = qt0 + t % per_head;
    const int r = tid % T, i = qt * T + r;
    const long long at = (static_cast<long long>(b) * H + h) * sq + i;
    if (tid < T)
      stats[s][0][r] = i < sq ? lse[at] : INFINITY;   // P = 0 past sq
    else
      stats[s][1][r] = i < sq ? delta[at] : 0.f;
  };

  if (tid == 0) {
    mbar_expect_tx(&kv_full, 2 * Tl::TILE);
#pragma unroll
    for (int j = 0; j < Tl::NBOX; ++j) {
      tma_load_4d(ks + j * Tl::BOX_BYTES, &tk, &kv_full, j * BOX, kvh, k0, b);
      tma_load_4d(vs + j * Tl::BOX_BYTES, &tv, &kv_full, j * BOX, kvh, k0, b);
    }
    for (int t = 0; t < min(STAGES, items); ++t) load_item(t, t);
  }
  for (int t = 0; t < min(STAGES, items); ++t) load_stats(t, t);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int krow0 = k0 + 16 * warp + lane / 4;   // (+ 8) this thread's keys
  float acc_dk[HD / 2], acc_dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(&kv_full, 0);
  for (int t = 0; t < items; ++t) {
    const int s = t % STAGES;
    const int q0 = (qt0 + t % per_head) * T;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* qs = ring + s * 2 * Tl::TILE;
    const uint8_t* dos = qs + Tl::TILE;

    float st[32], dpt[32];                // S^T, dP^T: [64 keys][64 queries]
    two_products<HD>(st, dpt, ks, qs, vs, dos);

    // P^T = 2^(s scale log2(e) - lse), dS^T = P^T (dP^T - D), per query
    // column; masked above the end-aligned diagonal
    const bool edge = causal && k0 + T - 1 > q0 + q_offset;
#pragma unroll
    for (int i = 0; i < T / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * (lane % 4) + e;
        const float l2 = stats[s][0][col], d = stats[s][1][col];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int idx = 4 * i + 2 * half + e;
          float x = st[idx] * scale_log2;
          if (edge && krow0 + 8 * half > q0 + col + q_offset) x = MASK_VALUE;
          const float p = exp2f(x - l2);
          st[idx] = p;
          dpt[idx] = p * (dpt[idx] - d);
        }
      }
    uint32_t pa[T / 16][4], sa[T / 16][4];
    pack_a<T / 16>(st, pa);
    pack_a<T / 16>(dpt, sa);

    // dV += P^T dO, dK += dS^T Q: B operands read MN-major (hd contiguous)
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
      Wgmma<HD, 0, 1>::rs(acc_dv, pa[kk],
                          desc_mnmajor(dos, kk, Tl::BOX_BYTES), 1);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
      Wgmma<HD, 0, 1>::rs(acc_dk, sa[kk],
                          desc_mnmajor(qs, kk, Tl::BOX_BYTES), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);

    __syncthreads();                      // stage s and its stats free
    if (t + STAGES < items) {
      if (tid == 0) load_item(t + STAGES, s);
      load_stats(t + STAGES, s);
    }
  }

  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = krow0 + 8 * half;
    if (row < skv) {
      bf16* krow = dk + b * dks.b + kvh * dks.h + row * dks.s;
      bf16* vrow = dv + b * dvs.b + kvh * dvs.h + row * dvs.s;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<uint32_t*>(krow + 8 * i + c0) =
            pack_bf16(acc_dk[4 * i + 2 * half] * scale,
                      acc_dk[4 * i + 2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * i + c0) =
            pack_bf16(acc_dv[4 * i + 2 * half], acc_dv[4 * i + 2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (batch, head, 64-query tile)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int H, int KV, int sq, int skv,
             int causal, float scale_log2, float scale, Strides dqs) {
  using Tl = Tiles<HD>;
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + Tl::TILE;
  uint8_t* ring = dos + Tl::TILE;         // stage s: K tile, V tile

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;   // longest tiles first
  const int q_offset = skv - sq;
  int kv_end = skv;
  if (causal) kv_end = max(0, min(skv, min(q0 + T, sq) + q_offset));
  const int n_tiles = (kv_end + T - 1) / T;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int t, int s) {
    uint8_t* st = ring + s * 2 * Tl::TILE;
    mbar_expect_tx(&full[s], 2 * Tl::TILE);
#pragma unroll
    for (int j = 0; j < Tl::NBOX; ++j) {
      tma_load_4d(st + j * Tl::BOX_BYTES, &tk, &full[s], j * BOX, kvh, t * T,
                  b);
      tma_load_4d(st + Tl::TILE + j * Tl::BOX_BYTES, &tv, &full[s], j * BOX,
                  kvh, t * T, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&q_full, 2 * Tl::TILE);
#pragma unroll
    for (int j = 0; j < Tl::NBOX; ++j) {
      tma_load_4d(qs + j * Tl::BOX_BYTES, &tq, &q_full, j * BOX, h, q0, b);
      tma_load_4d(dos + j * Tl::BOX_BYTES, &tdo, &q_full, j * BOX, h, q0, b);
    }
    for (int t = 0; t < min(STAGES, n_tiles); ++t) load_kv(t, t);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + 16 * warp + lane / 4;   // (+ 8) this thread's rows
  float l2[2], d[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + 8 * half;
    const long long at = (static_cast<long long>(b) * H + h) * sq + i;
    l2[half] = i < sq ? lse[at] : INFINITY;
    d[half] = i < sq ? delta[at] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, j0 = t * T;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* kt = ring + s * 2 * Tl::TILE;
    const uint8_t* vt = kt + Tl::TILE;

    float sc[32], dp[32];                 // S, dP: [64 queries][64 keys]
    two_products<HD>(sc, dp, qs, kt, dos, vt);

    const bool edge = j0 + T > skv || (causal && j0 + T - 1 > q0 + q_offset);
#pragma unroll
    for (int i = 0; i < T / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float x = sc[4 * i + e] * scale_log2;
        if (edge) {
          const int col = j0 + 8 * i + 2 * (lane % 4) + (e & 1);
          const int row = row0 + 8 * half;
          if (col >= skv) x = -INFINITY;                      // not a key
          else if (causal && col > row + q_offset) x = MASK_VALUE;
        }
        const float p = exp2f(x - l2[half]);
        dp[4 * i + e] = p * (dp[4 * i + e] - d[half]);
      }
    uint32_t sa[T / 16][4];
    pack_a<T / 16>(dp, sa);

    // dQ += dS K: K read MN-major (hd contiguous)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
      Wgmma<HD, 0, 1>::rs(acc, sa[kk], desc_mnmajor(kt, kk, Tl::BOX_BYTES), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();                      // stage s free
    if (tid == 0 && t + STAGES < n_tiles) load_kv(t + STAGES, s);
  }

  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row < sq) {
      bf16* qrow = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(qrow + 8 * i + c0) =
            pack_bf16(acc[4 * i + 2 * half] * scale,
                      acc[4 * i + 2 * half + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// 4-D descriptor of a [B, S, H, hd] tensor with element strides `st`
// (batch, seq, head), boxes of 64 values of hd x 64 positions of S.
bool make_tmap_bshd(CUtensorMap* map, const void* base, int hd, int B, int S,
                    int H, const long long* st) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {BOX, 1, T, 1};
  return make_tmap(map, base, 4, dims, strides, box);
}

inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   bf16* dq, bf16* dk, bf16* dv, int B, int H, int KV, int sq,
                   int skv, int causal, float scale, const long long* st,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_tmap_bshd(&tq, q, HD, B, sq, H, st) ||
      !make_tmap_bshd(&tk, k, HD, B, skv, KV, st + 3) ||
      !make_tmap_bshd(&tv, v, HD, B, skv, KV, st + 6) ||
      !make_tmap_bshd(&tdo, dout, HD, B, sq, H, st + 12))
    return cudaErrorInvalidValue;
  const int bytes = Tiles<HD>::SMEM;
  static unsigned long long dkdv_devices = 0, dq_devices = 0;
  cudaError_t err = allow_smem(flash_bwd_dkdv<HD>, bytes, dkdv_devices);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq<HD>, bytes, dq_devices);
  if (err != cudaSuccess) return err;
  const float sl2 = scale * LOG2E;
  flash_bwd_dkdv<HD><<<dim3(B * KV, (skv + T - 1) / T), THREADS, bytes,
                       stream>>>(tq, tk, tv, tdo, lse, delta, dk, dv, H, KV,
                                 sq, skv, causal, sl2, scale,
                                 strides_at(st, 6), strides_at(st, 7));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<HD><<<dim3(B * H, (sq + T - 1) / T), THREADS, bytes,
                     stream>>>(tq, tk, tv, tdo, lse, delta, dq, H, KV, sq,
                               skv, causal, sl2, scale, strides_at(st, 5));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Gradients of flash attention. strides: 24 element strides, (batch, seq,
// head) for q, k, v, o, dout, dq, dk, dv in turn; all multiples of 8, hd
// has unit stride, pointers 16-byte aligned. lse: the forward's fp32
// [B, H, sq] row log-sum-exp (log2 units); delta: an fp32 [B, H, sq]
// scratch buffer. Causal needs sq <= skv. Issues three launches on
// `stream` (delta, dk/dv, dq) and returns the first non-zero
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the kernels do not take.
int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, void* dk, void* dv, void* delta, int B,
                        int H, int KV, int sq, int skv, int hd, int causal,
                        float scale, const long long* strides, void* stream) {
  if (B < 1 || sq < 1 || skv < 1 || KV < 1 || H % KV != 0 ||
      (causal && sq > skv))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(B) * sq * H;
  flash_bwd_delta<<<static_cast<unsigned>((rows + DELTA_THREADS / 32 - 1) /
                                          (DELTA_THREADS / 32)),
                    DELTA_THREADS, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), dl, H, sq,
      hd, strides_at(strides, 3), strides_at(strides, 4), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* lp = static_cast<const float*>(lse);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  switch (hd) {
    case 64: return launch<64>(q, k, v, dout, lp, dl, dqp, dkp, dvp, B, H, KV, sq, skv, causal, scale, strides, s);
    case 80: return launch<80>(q, k, v, dout, lp, dl, dqp, dkp, dvp, B, H, KV, sq, skv, causal, scale, strides, s);
    case 96: return launch<96>(q, k, v, dout, lp, dl, dqp, dkp, dvp, B, H, KV, sq, skv, causal, scale, strides, s);
    case 128: return launch<128>(q, k, v, dout, lp, dl, dqp, dkp, dvp, B, H, KV, sq, skv, causal, scale, strides, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
