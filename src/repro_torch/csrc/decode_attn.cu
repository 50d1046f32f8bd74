// Decode attention for Hopper (sm_90a), bf16: in one launch per layer and
// decode step, RoPE on the new token's query and key, the new key and value
// written into the KV cache at `pos`, and GQA attention of the query over
// the cache's keys [0, pos]. `pos` is a 0-d int32 on the device that the
// kernel reads (a step captured in a CUDA graph advances it on the device
// between replays); no position crosses from the host.
//
// Replaces no Pallas kernel: the JAX reference's decode attention
// (src/repro/models/attention.py: decode_attention, gqa_decode_attend) is
// plain jnp. It was added because the port's torch version of that path
// (kernels/decode_attn/ref.py) spends ~50 small launches a layer, two
// host-to-device copies that each synchronise the stream, and an fp32
// copy of the whole K and V cache at every layer of every step.
//
// It computes what that torch version computes:
//   - q and k rotated by the split-halves RoPE with the fp32 cos/sin of
//     `rope_freqs` (a table [S_max, hd/2] built once per cache), each
//     product and the difference/sum rounded to fp32 one at a time
//     (no FMA contraction), then rounded to bf16, as `apply_rope` does on
//     its tensors: the key written to the cache is bitwise the torch one;
//   - q * scale rounded to bf16 (scale = bf16(1/sqrt(hd)), as the torch
//     path's bf16 scalar), scores q.k in fp32 over bf16 cache keys;
//   - softmax over keys [0, pos] and the P V sum in fp32; the output
//     rounded once to bf16. (The torch path rounds the normalised P to
//     bf16 before P V; here P stays fp32.)
// The slots past `pos` are never read: in the torch path their scores are
// -inf and add exactly zero.
//
// What bounds it on an H100: bytes. At olmo_1b's decode (B 32, KV 16,
// hd 128, pos 639) one call reads 168 MB of K/V for ~0.34 GFLOP, ~0.05 ms
// at 3.35 TB/s; the products are ~2 FLOP a byte, so CUDA cores suffice
// and wgmma would buy nothing. The design:
//   - one block per (split of the keys, KV head, batch row) handles the
//     KV head's G query heads together, so each K/V row is read from
//     device memory once for the group;
//   - four warps stride over tiles of 8 keys; each lane owns one 16-byte
//     chunk of a key row (hd/8 lanes a row, 32/(hd/8) rows a warp load),
//     and a ring of two stages a warp keeps the next tile's K and V in
//     flight with cp.async while the current one is used (each lane
//     reads back only the chunks it copied itself, so a warp needs no
//     barrier);
//   - each warp keeps its own online softmax (running max, sum, fp32
//     accumulator of its chunk); the warps merge in shared memory in a
//     fixed order, and with several key splits a second launch combines
//     the splits' partial sums in split order: bitwise deterministic;
//   - the block that owns `pos` (the split whose range holds it) rotates
//     the new key, writes key and value into the cache and lets them enter
//     its softmax from shared memory; no block reads a slot that another
//     block of the launch writes;
//   - head dims below 128 run on a padded tile of 64 or 128 lanes whose
//     chunks past hd load zeros (hd a multiple of 8): the cache is read
//     in place, never copied to a padded layout.
// The number of key splits comes from the caller (ops.split_plan: the
// grid's (row, head) pairs against the SM count, and the keys). The plan
// covers the cache's S slots, wherever `pos` is, so the host plans it
// without knowing the position; a split whose range starts past `pos`
// reads no key and writes the neutral partial
// (max -inf, sum 0, accumulator 0), which adds exactly zero to the
// combine.
//
// Layout: q [B, 1, H, hd], k/v [B, 1, KV, hd] (the new token, before
// RoPE), cache k/v [B, S, KV, hd], out [B, 1, H, hd]; element strides
// given by the caller, unit stride on hd, cache strides multiples of 8
// and 16-byte aligned cache pointers.

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 8;          // keys a warp takes per ring stage
constexpr int STAGES = 2;
constexpr int MAX_G = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* ck;
  bf16* cv;
  const float* cos;              // [S_max, hd/2], or null: no RoPE
  const float* sin;
  bf16* out;
  float* work;                   // the splits' partial sums (splits > 1)
  const int* pos_dev;            // the position, on the device
  int B, H, KV, hd, S, splits, chunk;        // S: the cache's slots
  float scale;
  long long q_b, q_h, k_b, k_h, v_b, v_h;
  long long ck_b, ck_s, ck_h, cv_b, cv_s, cv_h;
  long long o_b, o_h;
};

template <int HDP>
struct Geo {
  static constexpr int LPR = HDP / 8;        // lanes on one key row
  static constexpr int RPW = 32 / LPR;       // rows one warp load covers
  static constexpr int ROWS = TILE / RPW;    // rows a lane holds per tile
  static constexpr int ROW_BYTES = HDP * 2;
  static constexpr int TILE_BYTES = TILE * ROW_BYTES;   // K or V
  static constexpr int WARP_BYTES = STAGES * 2 * TILE_BYTES;
  static constexpr int RING_BYTES = WARPS * WARP_BYTES;
  static constexpr int NEW_BYTES = RPW * ROW_BYTES;      // the new key's rows
};

// shared memory: the warps' rings | new K rows | new V rows | q [G][HDP]
// fp32; the block merge reuses the ring for m, l [WARPS][G] and the
// accumulators [WARPS][G][HDP]
template <int HDP, int G>
struct Smem {
  using Gm = Geo<HDP>;
  static constexpr int NEW_K = Gm::RING_BYTES;
  static constexpr int NEW_V = NEW_K + Gm::NEW_BYTES;
  static constexpr int Q = NEW_V + Gm::NEW_BYTES;
  static constexpr int BYTES = Q + G * HDP * 4;
  static_assert(WARPS * G * (HDP + 2) * 4 <= Gm::RING_BYTES, "merge");
  static_assert(BYTES <= 48 * 1024, "static shared memory limit");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load8(const unsigned char* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element d of the head vector at `x` (hd values), rotated by RoPE with
// the table rows `cs`, `sn` (null: not rotated), as apply_rope computes
// it: each product and the difference or sum rounded to fp32 on its own,
// then the result to bf16.
__device__ __forceinline__ float rope_at(const bf16* x, int d, int hd,
                                         const float* cs, const float* sn) {
  const float xd = __bfloat162float(x[d]);
  if (cs == nullptr) return xd;
  const int half = hd / 2;
  if (d < half) {
    const float y = __bfloat162float(x[d + half]);
    return round_bf16(__fsub_rn(__fmul_rn(xd, cs[d]), __fmul_rn(y, sn[d])));
  }
  const int j = d - half;
  const float y = __bfloat162float(x[j]);
  return round_bf16(__fadd_rn(__fmul_rn(xd, cs[j]), __fmul_rn(y, sn[j])));
}

// One warp's online-softmax update with NR rows a lane of a tile in
// shared memory (`kt`, `vt`: rows of HDP bf16, row r + RPW * i of lane
// (r, c) holding key `key0 + r + RPW * i`); keys at or past `kend` are
// masked. Scores are kept in log2 units.
template <int HDP, int G, int NR>
__device__ __forceinline__ void attend_rows(
    const unsigned char* kt, const unsigned char* vt, int key0, int kend,
    int r, int c, const float (&qr)[G][8], float (&m)[G], float (&l)[G],
    float (&acc)[G][8]) {
  using Gm = Geo<HDP>;
  float s[NR][G];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float kf[8];
    load8(kt + (r + Gm::RPW * i) * Gm::ROW_BYTES + c * 16, kf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qr[g][e], kf[e], dot);
      s[i][g] = dot;
    }
  }
  // sum over the LPR lanes of a row (consecutive lanes)
#pragma unroll
  for (int off = Gm::LPR / 2; off >= 1; off >>= 1)
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
        s[i][g] += __shfl_xor_sync(FULL, s[i][g], off);
  float mt[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mt[g] = -INFINITY;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const bool ok = key0 + r + Gm::RPW * i < kend;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[i][g] = ok ? s[i][g] * LOG2E : -INFINITY;
      mt[g] = fmaxf(mt[g], s[i][g]);
    }
  }
  // the tile's max over the warp's rows
#pragma unroll
  for (int off = Gm::LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
      mt[g] = fmaxf(mt[g], __shfl_xor_sync(FULL, mt[g], off));
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mn = fmaxf(m[g], mt[g]);
    const float base = mn == -INFINITY ? 0.f : mn;
    const float corr = exp2f(m[g] - base);
    m[g] = mn;
    l[g] *= corr;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      s[i][g] = exp2f(s[i][g] - base);
      l[g] += s[i][g];
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float vf[8];
    load8(vt + (r + Gm::RPW * i) * Gm::ROW_BYTES + c * 16, vf);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[i][g], vf[e], acc[g][e]);
  }
}

template <int HDP, int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const __grid_constant__ Args a) {
  using Gm = Geo<HDP>;
  using Sm = Smem<HDP, G>;
  __shared__ __align__(16) unsigned char smem[Sm::BYTES];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = lane / Gm::LPR, c = lane % Gm::LPR;
  const int hd = a.hd;
  const int pos = *a.pos_dev;
  if (pos < 0 || pos >= a.S) __trap();       // past the cache: fail loudly
  const int k0 = split * a.chunk;
  const bool owner = k0 <= pos && pos < k0 + a.chunk;  // this split holds pos
  // cache keys read: [k0, kend), none in a split that starts past pos
  const int kend = owner ? pos : max(k0, min(k0 + a.chunk, pos + 1));
  const float* cs = a.cos ? a.cos + (long long)pos * (hd / 2) : nullptr;
  const float* sn = a.sin ? a.sin + (long long)pos * (hd / 2) : nullptr;

  // the G query heads, rotated and scaled as the torch path rounds them
  float* sq = reinterpret_cast<float*>(smem + Sm::Q);
  for (int idx = tid; idx < G * HDP; idx += THREADS) {
    const int g = idx / HDP, d = idx % HDP;
    float val = 0.f;
    if (d < hd) {
      const bf16* qp = a.q + b * a.q_b + (kvh * G + g) * a.q_h;
      val = round_bf16(__fmul_rn(rope_at(qp, d, hd, cs, sn), a.scale));
    }
    sq[idx] = val;
  }
  // the new key and value: into the cache, and as row 0 of a tile
  if (owner) {
    bf16* nk = reinterpret_cast<bf16*>(smem + Sm::NEW_K);
    bf16* nv = reinterpret_cast<bf16*>(smem + Sm::NEW_V);
    const bf16* kp = a.k + b * a.k_b + kvh * a.k_h;
    const bf16* vp = a.v + b * a.v_b + kvh * a.v_h;
    for (int idx = tid; idx < Gm::RPW * HDP; idx += THREADS) {
      const int d = idx % HDP;
      bf16 kk = __float2bfloat16_rn(0.f), vv = kk;
      if (idx < HDP && d < hd) {
        kk = __float2bfloat16_rn(rope_at(kp, d, hd, cs, sn));
        vv = vp[d];
        a.ck[b * a.ck_b + pos * a.ck_s + kvh * a.ck_h + d] = kk;
        a.cv[b * a.cv_b + pos * a.cv_s + kvh * a.cv_h + d] = vv;
      }
      nk[idx] = kk;
      nv[idx] = vv;
    }
  }
  __syncthreads();

  float qr[G][8], m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] = sq[g * HDP + c * 8 + e];
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  // the warp's tiles: t = warp, warp + WARPS, ... of the block's keys
  unsigned char* ring = smem + warp * Gm::WARP_BYTES;
  const int ntiles = (kend - k0 + TILE - 1) / TILE;
  const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;
  const bool lane_live = c * 8 < hd;
  const bf16* kbase = a.ck + b * a.ck_b + kvh * a.ck_h + c * 8;
  const bf16* vbase = a.cv + b * a.cv_b + kvh * a.cv_h + c * 8;
  auto load_tile = [&](int j) {
    unsigned char* st = ring + (j % STAGES) * 2 * Gm::TILE_BYTES;
    const int key0 = k0 + (warp + j * WARPS) * TILE;
#pragma unroll
    for (int i = 0; i < Gm::ROWS; ++i) {
      const int row = r + Gm::RPW * i, key = key0 + row;
      const bool ok = lane_live && key < kend;   // else zero-filled
      cp_async16(st + row * Gm::ROW_BYTES + c * 16,
                 ok ? kbase + key * a.ck_s : a.ck, ok ? 16 : 0);
      cp_async16(st + Gm::TILE_BYTES + row * Gm::ROW_BYTES + c * 16,
                 ok ? vbase + key * a.cv_s : a.cv, ok ? 16 : 0);
    }
  };
  if (mine > 0) load_tile(0);
  cp_async_commit();
  for (int j = 0; j < mine; ++j) {
    if (j + 1 < mine) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile j's copies (this lane's own) have landed
    const unsigned char* st = ring + (j % STAGES) * 2 * Gm::TILE_BYTES;
    attend_rows<HDP, G, Gm::ROWS>(st, st + Gm::TILE_BYTES,
                                  k0 + (warp + j * WARPS) * TILE, kend, r, c,
                                  qr, m, l, acc);
  }
  cp_async_wait<0>();
  if (owner && warp == WARPS - 1)
    attend_rows<HDP, G, 1>(smem + Sm::NEW_K, smem + Sm::NEW_V, pos, pos + 1,
                           r, c, qr, m, l, acc);

  // sum the warp's rows: afterwards every lane holds its chunk's totals
#pragma unroll
  for (int off = Gm::LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }

  __syncthreads();   // every warp is done with its ring
  float* sm_m = reinterpret_cast<float*>(smem);
  float* sm_l = sm_m + WARPS * G;
  float* sm_acc = sm_l + WARPS * G;
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
  if (r == 0)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sm_acc[(warp * G + g) * HDP + c * 8 + e] = acc[g][e];
  __syncthreads();

  // merge the warps in order; one split: the output, else its partials
  const int parts = a.B * a.KV * a.splits * G;
  for (int idx = tid; idx < G * HDP; idx += THREADS) {
    const int g = idx / HDP, d = idx % HDP;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    const float base = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(sm_m[w * G + g] - base);
      sum += sm_l[w * G + g] * f;
      o += sm_acc[(w * G + g) * HDP + d] * f;
    }
    if (a.splits == 1) {
      if (d < hd)
        a.out[b * a.o_b + (kvh * G + g) * a.o_h + d] =
            __float2bfloat16_rn(o / sum);
    } else {
      const int part = ((b * a.KV + kvh) * a.splits + split) * G + g;
      a.work[2 * parts + (long long)part * HDP + d] = o;
      if (d == 0) {
        a.work[2 * part] = mx;
        a.work[2 * part + 1] = sum;
      }
    }
  }
}

// The splits' partial (max, sum, accumulator) of each query head, combined
// in split order: grid (H, B), one thread a head dim lane.
__global__ void __launch_bounds__(128)
decode_attn_combine(const __grid_constant__ Args a, int G, int HDP) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= a.hd) return;
  const int kvh = h / G, g = h % G;
  const int parts = a.B * a.KV * a.splits * G;
  const int first = (b * a.KV + kvh) * a.splits * G + g;
  float mx = -INFINITY;
  for (int s = 0; s < a.splits; ++s)
    mx = fmaxf(mx, a.work[2 * (first + s * G)]);
  const float base = mx == -INFINITY ? 0.f : mx;
  float sum = 0.f, o = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const int part = first + s * G;
    const float f = exp2f(a.work[2 * part] - base);
    sum += a.work[2 * part + 1] * f;
    o += a.work[2 * parts + (long long)part * HDP + d] * f;
  }
  a.out[b * a.o_b + h * a.o_h + d] = __float2bfloat16_rn(o / sum);
}

template <int HDP, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  decode_attn_kernel<HDP, G>
      <<<dim3(a.splits, a.KV, a.B), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  decode_attn_combine<<<dim3(a.H, a.B), HDP, 0, stream>>>(a, G, HDP);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_g(const Args& a, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch<HDP, 1>(a, s);
    case 2: return launch<HDP, 2>(a, s);
    case 3: return launch<HDP, 3>(a, s);
    case 4: return launch<HDP, 4>(a, s);
    case 5: return launch<HDP, 5>(a, s);
    case 6: return launch<HDP, 6>(a, s);
    case 7: return launch<HDP, 7>(a, s);
    case 8: return launch<HDP, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: the new token, [B, 1, H | KV, hd]; ck, cv: the cache [B, S, KV,
// hd] of S slots, written at the position, the device int32 pos_dev points
// to (the kernel traps on a position outside [0, S)); cos, sin: fp32
// [S, hd / 2] RoPE tables (rows up to the position are read), or both null
// for no RoPE;
// out [B, 1, H, hd]; work: fp32 scratch of B * KV * splits * (H / KV) *
// (pad + 2) floats when splits > 1 (pad: 64 for hd <= 64, else 128), else
// null. The S slots are cut into `splits` ranges of `chunk` keys, each
// non-empty; those past the position add nothing. strides: 14
// element strides: (batch, head) of q, k, v; (batch, seq, head) of ck, cv;
// (batch, head) of out. Returns the launch's cudaGetLastError() (0 on
// success).
int decode_attn_bf16(const void* q, const void* k, const void* v, void* ck,
                     void* cv, const void* cos, const void* sin, void* out,
                     void* work, int B, int H, int KV, int hd, int S,
                     const void* pos_dev, int splits, int chunk, float scale,
                     const long long* strides, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > MAX_G || hd % 8 != 0 ||
      hd < 8 || hd > 128 || S < 1 || pos_dev == nullptr || splits < 1 ||
      chunk < 1 || (long long)splits * chunk < S ||
      (long long)(splits - 1) * chunk >= S ||
      (splits > 1 && work == nullptr) || ((cos == nullptr) != (sin == nullptr)))
    return cudaErrorInvalidValue;
  const long long* st = strides;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<bf16*>(ck),
         static_cast<bf16*>(cv), static_cast<const float*>(cos),
         static_cast<const float*>(sin), static_cast<bf16*>(out),
         static_cast<float*>(work), static_cast<const int*>(pos_dev), B, H,
         KV, hd, S, splits, chunk, scale,
         st[0], st[1], st[2], st[3], st[4], st[5],
         st[6], st[7], st[8], st[9], st[10], st[11],
         st[12], st[13]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd <= 64 ? launch_g<64>(a, H / KV, s) : launch_g<128>(a, H / KV, s);
}

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
