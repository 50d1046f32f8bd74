// Flash attention forward (causal or not, native GQA) for Hopper
// (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py:flash_attention (_kernel)
// and computes what it computes: softmax(Q K^T / sqrt(hd)) V with an fp32
// running max m, normaliser l and accumulator per query row, queries
// end-aligned to the keys (q_offset = skv - sq), masked scores set to
// -1e30, keys past the end to -inf, P rounded to bf16 before the P V
// product and l clamped at 1e-20 before the final division. Scores and
// probabilities never reach device memory.
//
// What bounds it on an H100: at granite_8b prefill (B = 4, S = 512,
// H = 32, KV = 8, hd = 128, causal) the two products do ~8.6 GFLOP
// against ~42 MB of q/k/v/o, so it sits near the card's memory/compute
// ridge; longer prompts are compute bound. The design follows
// FlashAttention-3:
//   - one block per (batch * head, 128-query tile): two consumer
//     warpgroups of 64 query rows and a producer warpgroup that gives
//     its registers to them (setmaxnreg);
//   - the producer loads the Q tile once and streams K/V tiles of 128
//     keys of the block's KV head (h // (H / KV), never repeated) through
//     a 2-stage TMA ring completed on mbarriers; boxes are 64 wide and
//     128B-swizzled, so hd 80 and 96 load as two boxes whose columns past
//     hd are zero-filled by TMA and skipped by the k loop;
//   - S = Q K^T by wgmma (both operands in shared memory) into registers;
//     the online softmax runs on the accumulator fragments, each row's
//     max and sum shared by the 4 threads that hold it; P is packed to
//     bf16 in registers and fed as wgmma's register A operand for O += P V;
//   - O, m and l stay in registers for the whole key sweep and are
//     written once; in training (a non-null `lse`) each row's
//     log-sum-exp m + log2(l) in log2 units too, one store a row, for
//     the backward kernels (csrc/flash_attn_bwd.cu);
//   - causal tiles above the diagonal are not visited, and the grid hands
//     out the longest (last) query tiles first.
//
// Layout: q [B, Sq, H, hd], k/v [B, Skv, KV, hd], o [B, Sq, H, hd], all
// given by element strides (multiples of 8) with a unit stride on hd, so
// both the model layout and the Pallas layout [BH, S, hd] (as B = 1,
// H = BH) run without a copy through the same 4-D TMA descriptors.
// Lengths need not divide the tiles: TMA zero-fills rows past the end,
// those keys are masked and those rows are not stored.

#include <math.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int TQ = 128;                 // query rows per block
constexpr int TK = 128;                 // keys per K/V stage
constexpr int THREADS = 384;            // WG0, WG1 consume; WG2 produces
constexpr int STAGES = 2;
constexpr float MASK_VALUE = -1e30f;    // the Pallas kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int NBOX = (HD + BOX - 1) / BOX;   // 64-wide boxes
  static constexpr int KSTEPS = HD / 16;              // k steps of Q K^T
  static constexpr int Q_BOX = TQ * BOX_ROW_BYTES;
  static constexpr int KV_BOX = TK * BOX_ROW_BYTES;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;      // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + 1024;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
};

struct Strides {
  long long b, s, h;                    // element strides of [B, S, H, hd]
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
          float* __restrict__ lse, int H, int KV, int sq, int skv,
          int causal, float scale_log2, Strides os) {
  using T = Tiles<HD>;
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ring_base = qs + T::Q_BYTES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);         // GQA: the KV head of query head h
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int q0 = qt * TQ;
  const int q_offset = skv - sq;        // queries sit at the last sq keys
  // keys past the causal bound of the tile's last real row are skipped
  int kv_end = skv;
  if (causal) kv_end = max(0, min(skv, min(q0 + TQ, sq) + q_offset));
  const int n_tiles = (kv_end + TK - 1) / TK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(&q_full, T::Q_BYTES);
#pragma unroll
      for (int j = 0; j < T::NBOX; ++j)
        tma_load_4d(qs + j * T::Q_BOX, &tq, &q_full, j * BOX, h, q0, b);
      Ring<STAGES> ring;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        uint8_t* st = ring_base + ring.stage * T::STAGE;
        uint64_t* bar = &full[ring.stage];
        mbar_expect_tx(bar, T::STAGE);
#pragma unroll
        for (int j = 0; j < T::NBOX; ++j) {
          tma_load_4d(st + j * T::KV_BOX, &tk, bar, j * BOX, kvh, t * TK, b);
          tma_load_4d(st + T::KV_BYTES + j * T::KV_BOX, &tv, bar, j * BOX,
                      kvh, t * TK, b);
        }
        ring.advance();
      }
    }
  } else {
    regs_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // (+ 8) this
    const int wg_first = q0 + wg * 64;                     // thread's rows
    const uint8_t* qa = qs + wg * 64 * BOX_ROW_BYTES;

    float acc_o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_o[i] = 0.f;
    float m_r[2] = {MASK_VALUE, MASK_VALUE}, l_r[2] = {0.f, 0.f};

    mbar_wait(&q_full, 0);
    Ring<STAGES> ring;
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * TK;
      mbar_wait(&full[ring.stage], ring.phase);
      const uint8_t* ks = ring_base + ring.stage * T::STAGE;
      const uint8_t* vs = ks + T::KV_BYTES;

      // S = Q K^T for this warpgroup's 64 rows and the tile's TK keys
      float s[TK / 2];
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        Wgmma<TK, 0, 0>::ss(s, desc_kmajor(qa, kk, T::Q_BOX),
                            desc_kmajor(ks, kk, T::KV_BOX), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scale into log2 units; mask where a tile crosses the diagonal or
      // the end of the keys
      const bool edge = j0 + TK > skv ||
                        (causal && j0 + TK - 1 > wg_first + q_offset);
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * i + e] * scale_log2;
          if (edge) {
            const int col = j0 + 8 * i + 2 * (lane % 4) + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (col >= skv) x = -INFINITY;                    // not a key
            else if (causal && col > row + q_offset) x = MASK_VALUE;
          }
          s[4 * i + e] = x;
        }
      }

      // online softmax on the fragments: rows row0 and row0 + 8, each
      // spread over the 4 lanes that share lane / 4
      float corr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < TK / 8; ++i)
          mx = fmaxf(mx, fmaxf(s[4 * i + 2 * half], s[4 * i + 2 * half + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[half], mx);
        corr[half] = exp2f(m_r[half] - m_new);
        m_r[half] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * i + 2 * half + e] - m_new);
            s[4 * i + 2 * half + e] = p;
            sum += p;
          }
        }
        l_r[half] = l_r[half] * corr[half] + sum;   // lane-partial sum
      }
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc_o[4 * i + 0] *= corr[0];
        acc_o[4 * i + 1] *= corr[0];
        acc_o[4 * i + 2] *= corr[1];
        acc_o[4 * i + 3] *= corr[1];
      }

      // P (bf16) as the register A operand: k step kk covers keys
      // 16 kk .. 16 kk + 15, i.e. accumulator columns blocks 2 kk, 2 kk + 1
      uint32_t pa[TK / 16][4];
      pack_a<TK / 16>(s, pa);
      fence_regs(acc_o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        Wgmma<HD, 0, 1>::rs(acc_o, pa[kk],
                            desc_mnmajor(vs, kk, T::KV_BOX), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      if (lane == 0) mbar_arrive(&empty[ring.stage]);
      ring.advance();
    }

    // O / l, written once
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = l_r[half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-20f);
      const int row = row0 + 8 * half;
      // the row's log-sum-exp in the log2 units of the scaled scores, for
      // the backward (csrc/flash_attn_bwd.cu): one store from m and l
      if (lse != nullptr && lane % 4 == 0 && row < sq)
        lse[(static_cast<long long>(b) * H + h) * sq + row] =
            m_r[half] + log2f(fmaxf(l, 1e-20f));
      if (row < sq) {
        bf16* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
          *reinterpret_cast<uint32_t*>(orow + 8 * i + c0) =
              pack_bf16(acc_o[4 * i + 2 * half] * inv,
                        acc_o[4 * i + 2 * half + 1] * inv);
      }
    }
  }
}

// 4-D descriptor of a [B, S, H, hd] tensor with element strides `st`,
// boxes of 64 values of hd x `rows` positions of S, one head, one batch.
bool make_tmap_bshd(CUtensorMap* map, const void* base, int hd, int B, int S,
                    int H, const long long* st, uint32_t rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {BOX, 1, rows, 1};
  return make_tmap(map, base, 4, dims, strides, box);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, bf16* o,
                   float* lse, int B, int H, int KV, int sq, int skv,
                   int causal, float scale, const long long* st,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_tmap_bshd(&tq, q, HD, B, sq, H, st, TQ) ||
      !make_tmap_bshd(&tk, k, HD, B, skv, KV, st + 3, TK) ||
      !make_tmap_bshd(&tv, v, HD, B, skv, KV, st + 6, TK))
    return cudaErrorInvalidValue;
  const int bytes = Tiles<HD>::SMEM;
  static unsigned long long devices = 0;
  cudaError_t err = allow_smem(flash_fwd<HD>, bytes, devices);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (sq + TQ - 1) / TQ);
  flash_fwd<HD><<<grid, THREADS, bytes, stream>>>(
      tq, tk, tv, o, lse, H, KV, sq, skv, causal, scale * LOG2E,
      Strides{st[9], st[10], st[11]});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn;
// all multiples of 8, hd has unit stride, pointers 16-byte aligned. lse:
// null, or a contiguous fp32 [B, H, sq] that gets each row's log-sum-exp
// of the scaled, masked scores in log2 units (training asks for it;
// serving passes null). Returns the launch's cudaGetLastError() (0 on
// success).
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int KV, int sq, int skv,
                        int hd, int causal, float scale,
                        const long long* strides, void* stream) {
  if (B < 1 || sq < 1 || skv < 1 || KV < 1 || H % KV != 0)
    return cudaErrorInvalidValue;
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, op, lp, B, H, KV, sq, skv, causal, scale, strides, s);
    case 80: return launch<80>(q, k, v, op, lp, B, H, KV, sq, skv, causal, scale, strides, s);
    case 96: return launch<96>(q, k, v, op, lp, B, H, KV, sq, skv, causal, scale, strides, s);
    case 128: return launch<128>(q, k, v, op, lp, B, H, KV, sq, skv, causal, scale, strides, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
