// Shared by the SSD scan kernels, forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): sizes, the workspace of the forward's three launches
// and what it keeps for the backward, and its launches (a) chunk states
// and (b) state passing; the backward runs (a) again with dy for x. See
// ssd_scan.cu for the design and the operand precision.
#pragma once

#include <math.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int P = 64;                   // head dim: columns of x, y, state
constexpr int MAX_N = 128;              // state rows: two 64-wide boxes
constexpr int KT = 64;                  // rows per B / C / x / dy tile
constexpr int TILE = KT * BOX_ROW_BYTES;   // one [64 rows][64] box, 8 KB
constexpr int KV_BYTES = KT * 8;        // (cum, dt) pairs of a key tile
constexpr int STATE_STAGES = 2;
constexpr int STATE_THREADS = 128;      // (a): one warpgroup
constexpr int PASS_THREADS = 256;       // (b)

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, s, h;                    // element strides of [B, S, H, *]
};

// 2^x in one instruction (relative error below 2^-22; 2^-inf = 0). The
// cumsums are kept in log2 units, so every decay is one ex2 of a
// difference.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offsets of the workspace's three arrays and its size.
struct Workspace {
  size_t sc, sp, bytes;
};

inline size_t round_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// (cum, dt) pairs of one chunk, padded to whole key tiles so that a key
// tile's pairs are one aligned bulk copy.
__host__ __device__ inline int chunk_pitch(int chunk) {
  return (chunk + KT - 1) / KT * KT;
}

inline Workspace workspace(int batch, int S, int H, int N, int chunk) {
  const size_t bh = static_cast<size_t>(batch) * H;
  const size_t bhc = bh * (S / chunk);
  Workspace w;
  w.sc = round_up(bhc * chunk_pitch(chunk) * sizeof(float2), 1024);
  w.sp = w.sc + round_up(bhc * N * P * sizeof(float), 1024);  // S_c
  w.bytes = w.sp + round_up(bhc * 2 * N * P * sizeof(bf16), 1024);
  return w;                                   // S_prev as [bhc][hi, lo]
}

// What the forward keeps for the backward when asked (ssd_scan_fwd_bf16's
// `keep`): the (cum, dt) pairs at 0 and the previous states S_prev as
// bf16 hi/lo at `sp`, laid out as in the workspace.
struct Kept {
  size_t sp, bytes;
};

inline Kept kept(int batch, int S, int H, int N, int chunk) {
  const size_t bhc = static_cast<size_t>(batch) * H * (S / chunk);
  Kept k;
  k.sp = round_up(bhc * chunk_pitch(chunk) * sizeof(float2), 1024);
  k.bytes = k.sp + round_up(bhc * 2 * N * P * sizeof(bf16), 1024);
  return k;
}

// ---------------------------------------------------------------------------
// (a) chunk states
// ---------------------------------------------------------------------------

template <int NM>                       // 64-row blocks of the state
struct StateTiles {
  static constexpr int B_BYTES = NM * TILE;     // B tile [64 keys][64 n] x NM
  static constexpr int STAGE = B_BYTES + TILE;  // + x tile [64 keys][64 p]
  static constexpr int SMEM = STATE_STAGES * STAGE + 2 * TILE + 1024;
};

// The key tile at sequence row `row`: NM boxes of B, one of x, into `st`.
template <int NM>
__device__ __forceinline__ void load_state_tile(
    uint8_t* st, uint64_t* bar, const CUtensorMap* tb, const CUtensorMap* tx,
    int b, int h, int g, int row) {
  mbar_expect_tx(bar, StateTiles<NM>::STAGE);
#pragma unroll
  for (int m = 0; m < NM; ++m)
    tma_load_4d(st + m * TILE, tb, bar, m * BOX, g, row, b);
  tma_load_4d(st + StateTiles<NM>::B_BYTES, tx, bar, 0, h, row, b);
}

// DY = false: S_c = B^T (w o x) with w_j = 2^(cum_L - cum_j) dt_j, after
// writing the chunk's (cum, dt) pairs. DY = true (the backward's gradient
// of the previous state from y's inter-chunk term): the same product with
// C for B, dy for x and e_i = 2^(cum_i) for w, reading the pairs that the
// DY = false launch wrote; `sc` then receives C^T (e o dy).
template <int NM, bool DY>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_chunk_state(const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tx,
                const float* __restrict__ dt, const float* __restrict__ A,
                float2* __restrict__ cd, float* __restrict__ sc, int S,
                int H, int G, int N, int chunk, Strides ds, long long as) {
  using T = StateTiles<NM>;
  __shared__ __align__(8) uint64_t full[STATE_STAGES];
  __shared__ float warp_sum[STATE_THREADS / 32];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* xhi = ring + STATE_STAGES * T::STAGE;     // w o x, split
  uint8_t* xlo = xhi + TILE;

  const int nc = S / chunk;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk;
  const int n_kt = (chunk + KT - 1) / KT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < STATE_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid == 0)
    for (int t = 0; t < min(STATE_STAGES, n_kt); ++t)
      load_state_tile<NM>(ring + t * T::STAGE, &full[t], &tb, &tx, b, h, g,
                          c0 + t * KT);

  // cum = cumsum(dt a) log2(e) over the chunk, 128 steps at a time: a
  // shuffle scan in each warp, then the warps' totals in order.
  const float a = A[h * as] * LOG2E;    // cum in log2 units
  const float* db = dt + b * ds.b + h * ds.h;
  float2* cdc = cd + static_cast<long long>(blockIdx.x) * chunk_pitch(chunk);
  float carry = 0.f;                    // pairs past the chunk are zeros
  for (int i0 = 0; !DY && i0 < chunk_pitch(chunk); i0 += STATE_THREADS) {
    const int i = i0 + tid;
    const float d = i < chunk ? db[static_cast<long long>(c0 + i) * ds.s] : 0.f;
    float v = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (i < chunk_pitch(chunk))
      cdc[i] = i < chunk ? make_float2(before + v, d) : make_float2(0.f, 0.f);
    for (int w = 0; w < STATE_THREADS / 32; ++w) carry += warp_sum[w];
    __syncthreads();                    // warp_sum is reused; cdc visible
  }
  const float cl = cdc[chunk - 1].x;

  float acc[NM][32];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const uint8_t* bt = ring + (t % STATE_STAGES) * T::STAGE;
    const uint8_t* xt = bt + T::B_BYTES;
    mbar_wait(&full[t % STATE_STAGES], (t / STATE_STAGES) & 1);
    // w o x, split into hi/lo at the same swizzled place: a 16-byte chunk
    // stays in its 128-byte row, so its row (key) is its offset / 128
    for (int e = tid; e < KT * 8; e += STATE_THREADS) {
      const int j = t * KT + e / 8;
      float w = 0.f;                    // keys past the chunk weigh 0
      if (j < chunk) {
        const float2 v = cdc[j];
        w = DY ? ex2(v.x) : ex2(cl - v.x) * v.y;
      }
      const uint4 raw = *reinterpret_cast<const uint4*>(xt + e * 16);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 hi, lo;
      uint32_t* hv = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lv = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(xv[k]);
        split_bf16(f.x * w, f.y * w, hv[k], lv[k]);
      }
      *reinterpret_cast<uint4*>(xhi + e * 16) = hi;
      *reinterpret_cast<uint4*>(xlo + e * 16) = lo;
    }
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NM; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < NM; ++m) {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint64_t da = desc_mnmajor(bt + m * TILE, kk, TILE);
        Wgmma<P, 1, 1>::ss(acc[m], da, desc_mnmajor(xhi, kk, TILE), 1);
        Wgmma<P, 1, 1>::ss(acc[m], da, desc_mnmajor(xlo, kk, TILE), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < NM; ++m) fence_regs(acc[m]);
    __syncthreads();                    // stage, xhi and xlo free again
    if (tid == 0 && t + STATE_STAGES < n_kt)
      load_state_tile<NM>(ring + (t % STATE_STAGES) * T::STAGE,
                          &full[t % STATE_STAGES], &tb, &tx, b, h, g,
                          c0 + (t + STATE_STAGES) * KT);
  }

  // S_c rows n = 64 m + 16 warp + lane / 4 (+ 8), columns 8 i + 2 (lane % 4)
  float* scb = sc + static_cast<long long>(blockIdx.x) * N * P;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 64 * m + 16 * warp + lane / 4 + 8 * half;
      if (n < N) {
#pragma unroll
        for (int i = 0; i < P / 8; ++i)
          *reinterpret_cast<float2*>(scb + n * P + 8 * i + 2 * (lane % 4)) =
              make_float2(acc[m][4 * i + 2 * half],
                          acc[m][4 * i + 2 * half + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// (b) state passing
// ---------------------------------------------------------------------------

// Thread e owns state elements 4 e .. 4 e + 3 of [B * H][N][P].
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass(const float2* __restrict__ cd, const float* __restrict__ sc,
               bf16* __restrict__ sp, float* __restrict__ state, int S,
               int N, int chunk, long long quads) {
  const long long e = static_cast<long long>(blockIdx.x) * PASS_THREADS +
                      threadIdx.x;
  if (e >= quads) return;
  const int np = N * P;
  const long long bh = 4 * e / np;
  const int r = static_cast<int>(4 * e - bh * np);
  const int nc = S / chunk;
  const int lp = chunk_pitch(chunk);
  const float2* last = cd + bh * nc * lp + chunk - 1;   // cum_L of chunk 0
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const long long bhc = bh * nc + c;
    uint2 hi, lo;
    split_bf16(s.x, s.y, hi.x, lo.x);
    split_bf16(s.z, s.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(sp + 2 * bhc * np + r) = hi;
    *reinterpret_cast<uint2*>(sp + (2 * bhc + 1) * np + r) = lo;
    const float decay = ex2(last[c * lp].x);
    const float4 add = *reinterpret_cast<const float4*>(sc + bhc * np + r);
    s.x = s.x * decay + add.x;
    s.y = s.y * decay + add.y;
    s.z = s.z * decay + add.z;
    s.w = s.w * decay + add.w;
  }
  *reinterpret_cast<float4*>(state + 4 * e) = s;
}

// 4-D descriptor of a [B, S, H, W] bf16 tensor with element strides `st`
// (batch, seq, head), boxes of 64 values of W x `rows` positions of S.
bool make_tmap_bshw(CUtensorMap* map, const void* base, int W, int B, int S,
                    int H, const long long* st, uint32_t rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {BOX, 1, rows, 1};
  return make_tmap(map, base, 4, dims, strides, box);
}

// 3-D descriptor of a [2 bhc][N][P] bf16 hi/lo state array (S_prev, or
// the backward's g): boxes of [64 nb rows of N][64 P], rows past N
// zero-filled.
bool make_tmap_state(CUtensorMap* map, const void* base, long long bhc,
                     int N, int nb) {
  const uint64_t dims[3] = {P, static_cast<uint64_t>(N),
                            static_cast<uint64_t>(2 * bhc)};
  const uint64_t strides[2] = {P * 2, static_cast<uint64_t>(N) * P * 2};
  const uint32_t box[3] = {BOX, static_cast<uint32_t>(nb * BOX), 1};
  return make_tmap(map, base, 3, dims, strides, box);
}

bool admit(int S, int H, int G, int N, int p, int chunk) {
  return p == P && N > 0 && N % 8 == 0 && N <= MAX_N && G > 0 && H % G == 0 &&
         chunk > 0 && S % chunk == 0;
}

}  // namespace
