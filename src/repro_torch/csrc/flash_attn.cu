// Flash attention forward (causal or not, native GQA) for Hopper, bf16.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py:flash_attention (_kernel)
// and computes what it computes: softmax(Q K^T / sqrt(hd)) V with an fp32
// running max m, normaliser l and accumulator per query row, queries
// end-aligned to the keys (q_offset = skv - sq), masked scores set to
// -1e30 and l clamped at 1e-20 before the final division. Scores and
// probabilities never reach device memory.
//
// What bounds it on an H100: at prefill shapes (S = 512, hd = 128) the
// two products do ~8.6 GFLOP against ~42 MB of q/k/v/o, so the card's
// ratio (~295 flop/byte for bf16) puts it near the memory/compute ridge;
// at longer prompts it is compute bound. The design keeps the byte
// count at the minimum -- each block reads its Q tile once and streams
// K/V tiles of its own KV head (head h // g, never repeated to H heads)
// from L2/HBM -- and runs both products on the tensor cores (WMMA bf16,
// fp32 accumulation). Causal tiles wholly above the diagonal are not
// visited. It is a first, simple kernel: one block per (batch*head,
// 64-query tile), four warps of 16 query rows each, single-buffered
// tiles, no TMA/wgmma; those are for a later change.
//
// Layout: q [B, Sq, H, hd], k/v [B, Skv, KV, hd], o [B, Sq, H, hd], all
// given by element strides with a unit stride on hd, so both the model
// layout and the Pallas layout [BH, S, hd] (as B = 1, H = BH) run without
// a copy. Lengths need not divide the tile: ragged rows and keys are
// masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TQ = 64;                  // query rows per block
constexpr int TK = 64;                  // keys per K/V tile
constexpr int NWARPS = TQ / 16;         // one warp per 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASK_VALUE = -1e30f;    // the Pallas kernel's NEG_INF

// Shared-memory plan for one block. Row pitches are padded by 16 bytes
// to spread rows over banks; every region starts 128-byte aligned.
template <int HD>
struct Smem {
  static constexpr int LDQ = HD + 8;    // bf16 pitch of Q, K and V tiles
  static constexpr int LDS = TK + 4;    // fp32 pitch of the score tile
  static constexpr int LDP = TK + 8;    // bf16 pitch of the probability tile
  static constexpr int LDO = HD + 4;    // fp32 pitch of the output accumulator
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_K = OFF_Q + sizeof(bf16) * TQ * LDQ;
  static constexpr size_t OFF_V = OFF_K + sizeof(bf16) * TK * LDQ;
  static constexpr size_t OFF_S = OFF_V + sizeof(bf16) * TK * LDQ;
  static constexpr size_t OFF_P = OFF_S + sizeof(float) * TQ * LDS;
  static constexpr size_t OFF_O = OFF_P + sizeof(bf16) * TQ * LDP;
  static constexpr size_t OFF_M = OFF_O + sizeof(float) * TQ * LDO;
  static constexpr size_t OFF_L = OFF_M + sizeof(float) * TQ;
  static constexpr size_t BYTES = OFF_L + sizeof(float) * TQ;
};

struct Strides {
  long long b, s, h;                    // element strides of [B, S, H, hd]
};

// Copy rows [row0, row0 + rows) of one head (row stride rs) into a tile;
// rows at or past n are zero-filled. 16-byte vectors.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long rs, int row0, int n,
                                          int rows) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < rows * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int H, int KV,
          int sq, int skv, int causal, float scale, Strides qs, Strides ks,
          Strides vs, Strides os) {
  using SM = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::OFF_Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::OFF_K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::OFF_V);
  float* Ss = reinterpret_cast<float*>(smem + SM::OFF_S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::OFF_P);
  float* Os = reinterpret_cast<float*>(smem + SM::OFF_O);
  float* m_s = reinterpret_cast<float*>(smem + SM::OFF_M);
  float* l_s = reinterpret_cast<float*>(smem + SM::OFF_L);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);         // GQA: the KV head of query head h
  const int q0 = blockIdx.y * TQ;
  const int q_offset = skv - sq;        // queries sit at the last sq keys
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * 16;           // this warp's first tile row

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  load_rows<HD>(Qs, SM::LDQ, qb, qs.s, q0, sq, TQ);
  for (int i = lane; i < 16 * SM::LDO; i += 32) Os[wrow * SM::LDO + i] = 0.f;
  if (lane < 16) {
    m_s[wrow + lane] = MASK_VALUE;
    l_s[wrow + lane] = 0.f;
  }

  // keys past the causal bound of the tile's last real row are skipped
  int kv_end = skv;
  if (causal) kv_end = min(skv, min(q0 + TQ, sq) - 1 + q_offset + 1);

  for (int j0 = 0; j0 < kv_end; j0 += TK) {
    __syncthreads();                    // Q loaded / previous K,V consumed
    load_rows<HD>(Ks, SM::LDQ, kb, ks.s, j0, skv, TK);
    load_rows<HD>(Vs, SM::LDQ, vb, vs.s, j0, skv, TK);
    __syncthreads();

    // S[wrow:wrow+16, :] = Q K^T (K row-major is K^T column-major)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TK / 16];
#pragma unroll
      for (int n = 0; n < TK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + wrow * SM::LDQ + kk * 16, SM::LDQ);
#pragma unroll
        for (int n = 0; n < TK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, Ks + n * 16 * SM::LDQ + kk * 16, SM::LDQ);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < TK / 16; ++n)
        wmma::store_matrix_sync(Ss + wrow * SM::LDS + n * 16, acc[n], SM::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the warp's rows; lane owns columns lane + 32 t
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r;
      const int qpos = q0 + row + q_offset;
      float s[TK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < TK / 32; ++t) {
        const int c = lane + 32 * t, kj = j0 + c;
        float x = Ss[row * SM::LDS + c] * scale;
        if (kj >= skv) x = -INFINITY;                  // not a key at all
        else if (causal && kj > qpos) x = MASK_VALUE;  // above the diagonal
        s[t] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < TK / 32; ++t) {
        const float p = expf(s[t] - m_new);
        psum += p;
        Ps[row * SM::LDP + lane + 32 * t] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_prev - m_new);
      for (int c = lane; c < HD; c += 32) Os[row * SM::LDO + c] *= corr;
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + psum;
      }
    }
    __syncwarp();

    // O[wrow:wrow+16, :] += P V   (P rounded to bf16, as the Pallas kernel)
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + wrow * SM::LDO + n * 16, SM::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + wrow * SM::LDP + kk * 16, SM::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * SM::LDQ + n * 16, SM::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + wrow * SM::LDO + n * 16, acc, SM::LDO,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int r = 0; r < 16; ++r) {
    const int row = wrow + r, qi = q0 + row;
    if (qi >= sq) break;
    const float l = fmaxf(l_s[row], 1e-20f);
    for (int c = lane; c < HD; c += 32)
      ob[qi * os.s + c] = __float2bfloat16(Os[row * SM::LDO + c] / l);
  }
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int H, int KV, int sq, int skv, int causal,
                   float scale, const Strides* st, cudaStream_t stream) {
  const size_t bytes = Smem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (sq + TQ - 1) / TQ);
  flash_fwd<HD><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, o, H, KV, sq, skv, causal, scale, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
// Returns the launch's cudaGetLastError() (0 on success).
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int sq, int skv, int hd,
                        int causal, float scale, const long long* strides,
                        void* stream) {
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(qp, kp, vp, op, B, H, KV, sq, skv, causal, scale, st, s);
    case 80: return launch<80>(qp, kp, vp, op, B, H, KV, sq, skv, causal, scale, st, s);
    case 96: return launch<96>(qp, kp, vp, op, B, H, KV, sq, skv, causal, scale, st, s);
    case 128: return launch<128>(qp, kp, vp, op, B, H, KV, sq, skv, causal, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
