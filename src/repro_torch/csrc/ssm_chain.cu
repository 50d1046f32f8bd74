// The Mamba-2 chain around the SSD scan in prefill, for Hopper (sm_90a),
// bf16, in two launches a layer:
//
//   mamba2_conv_silu      before the scan: the causal depthwise conv of
//                         the x, B and C projections, each followed by
//                         SiLU, and softplus(dt + dt_bias), A = -exp(A_log);
//   mamba2_gated_rmsnorm  after it: the D skip, the SiLU gate and the
//                         gated RMSNorm, rmsnorm((y + D xc) silu(z)) scale.
//
// Replaces no Pallas kernel: the JAX reference runs this chain as plain
// jnp (src/repro/models/ssm.py: mamba2_block, _causal_dw_conv) and XLA
// fuses it. The port's torch version (kernels/ssm_chain/ref.py) spends
// ~48 launches a layer outside the scan and moves each [B*S, d_inner]
// tensor through device memory some 55 times (the conv's pad, shifted
// products and sums, the fp32 passes of the norm).
//
// What bounds it on an H100: bytes. Each kernel reads its inputs once and
// writes its outputs once: at mamba2_780m's prefill (B 4, S 2048, d_inner
// 3072, G*N 128, H 48) the pre-scan kernel moves ~111 MB (~33 us at 3.35
// TB/s), the post-scan one ~201 MB (~60 us), at a few FLOP a byte.
//
// mamba2_conv_silu: the x, B and C channels and the dt heads form one
// row of "vectors" of 8 (16 bytes of bf16); a thread owns one vector
// over a tile of CONV_ROWS rows of one sequence, and loads the tile's
// rows and the K-1 halo rows before it (zeros before the sequence's first
// row: no row reaches into the previous sequence) all at once into
// registers, with the conv's K weights: one memory round trip a thread,
// 7 x 16 bytes in flight. Neighbouring threads take neighbouring
// vectors, so a warp reads 512 contiguous bytes of a row. The conv sums
// in fp32 (weights in the order of the torch version's shifted products)
// and rounds once, after SiLU; softplus(dt + dt_bias) is fp32 (PyTorch's
// threshold 20); the first tile's dt threads also write A. Tiles of 4
// rows measured fastest on the H100 (16 rows: 30-35% of the bytes bound,
// 8: 55%, 4: 63%, 1: 55%): more threads in flight, fewer registers each.
//
// SiLU is x / (1 + exp(-x)) in fp32 with the fast intrinsics (__expf,
// __fdividef; a few ulp of fp32, far below the one bf16 rounding): with
// the accurate exp and division both kernels spend more time in
// arithmetic than the bytes take (the conv measured 43% of its bound).
//
// mamba2_gated_rmsnorm: a block of NORM_THREADS owns a row of W channels
// and holds its gated values, fp32, in registers (VPT vectors of 8 a
// thread), so the sum of squares is reduced in the block, in a fixed
// order (bitwise deterministic), and the row is written once in bf16.
// VPT is the least that holds the row, one instance each up to MAX_VPT:
// W <= 8192 (Granite 4.0-H's d_inner). A row of W <= 4096 runs the same
// instance, with the same threads and order, as before the wider ones
// were added (bitwise the same output).
//
// Layout: every tensor contiguous, rows [B*S] by channels; y [B,S,H,P]
// is [B*S, H*P] (channel c of head c / P); 16-byte aligned pointers, the
// widths multiples of 8.

#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CONV_THREADS = 128;
constexpr int CONV_ROWS = 4;     // rows of one sequence a thread computes
constexpr int K = 4;             // the conv width: every config's ssm_conv
constexpr int NORM_THREADS = 128;
constexpr int NORM_WARPS = NORM_THREADS / 32;
constexpr int MAX_VPT = 8;       // vectors a thread holds: W <= 8192
constexpr float SOFTPLUS_THRESHOLD = 20.f;   // torch.nn.functional.softplus

struct ConvArgs {
  const bf16* x;          // [rows, W]
  const bf16* bm;         // [rows, GN]
  const bf16* cm;         // [rows, GN]
  const bf16* wx;         // [K, W]
  const bf16* wb;         // [K, GN]
  const bf16* wc;         // [K, GN]
  const bf16* dt;         // [rows, H]
  const float* dt_bias;   // [H]
  const float* a_log;     // [H]
  bf16* xo;
  bf16* bo;
  bf16* co;
  float* dto;             // [rows, H]
  float* a;               // [H]
  int S, W, GN, H;
  int vx, vg, vh;         // vectors of 8 in W, GN, H (the last rounded up)
  int tiles_per_seq;
  unsigned threads;       // vectors a row x tiles (< 2^31)
};

struct NormArgs {
  const bf16* y;          // [rows, W], head c / P
  const bf16* xc;         // [rows, W]
  const bf16* z;          // [rows, W]
  const float* d;         // [H]
  const float* scale;     // [W]
  bf16* out;              // [rows, W]
  int W, P;
  float eps;
};

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return u;
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(bf16* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// x / (1 + exp(-x)), PyTorch's SiLU, in fp32 with the fast intrinsics: 0
// where exp(-x) overflows, as x / inf
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// softplus(dt + dt_bias) of heads [h0, h0 + 8) over the rows [s0, s1) of
// sequence row0; A of those heads when `first` (the first tile)
__device__ void dt_heads(const ConvArgs& a, int h0, long long row0, int s0,
                         int s1, bool first) {
  const int hn = min(8, a.H - h0);
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = j < hn ? a.dt_bias[h0 + j] : 0.f;
  if (first) {
    for (int j = 0; j < hn; ++j) a.a[h0 + j] = -expf(a.a_log[h0 + j]);
  }
  for (int s = s0; s < s1; ++s) {
    const long long r = (row0 + s) * a.H + h0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < hn) {
        const float v = __bfloat162float(a.dt[r + j]) + bias[j];
        a.dto[r + j] = v > SOFTPLUS_THRESHOLD ? v : log1pf(expf(v));
      }
    }
  }
}

__global__ void __launch_bounds__(CONV_THREADS)
    mamba2_conv_silu(const ConvArgs a) {
  const unsigned idx = blockIdx.x * CONV_THREADS + threadIdx.x;
  if (idx >= a.threads) return;
  const unsigned nvec = a.vx + 2 * a.vg + a.vh;
  const int v = static_cast<int>(idx % nvec);
  const int tile = static_cast<int>(idx / nvec);
  const int b = tile / a.tiles_per_seq;
  const int s0 = (tile % a.tiles_per_seq) * CONV_ROWS;
  const int s1 = min(s0 + CONV_ROWS, a.S);
  const long long row0 = static_cast<long long>(b) * a.S;
  if (v >= a.vx + 2 * a.vg) {
    dt_heads(a, (v - a.vx - 2 * a.vg) * 8, row0, s0, s1, tile == 0);
    return;
  }
  const bf16* src;
  const bf16* wt;
  bf16* dst;
  int width, col;
  if (v < a.vx) {
    src = a.x, wt = a.wx, dst = a.xo, width = a.W, col = v * 8;
  } else if (v < a.vx + a.vg) {
    src = a.bm, wt = a.wb, dst = a.bo, width = a.GN, col = (v - a.vx) * 8;
  } else {
    src = a.cm, wt = a.wc, dst = a.co, width = a.GN,
    col = (v - a.vx - a.vg) * 8;
  }
  // every row the tile needs, the K - 1 halo rows first (zeros before the
  // sequence's first row), loaded at once: one round trip a thread
  constexpr int R = CONV_ROWS + K - 1;
  uint4 raw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = s0 - (K - 1) + r;
    raw[r] = s >= 0 && s < s1 ? load16(src + (row0 + s) * width + col)
                              : make_uint4(0u, 0u, 0u, 0u);
  }
  float w[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) unpack(load16(wt + k * width + col), w[k]);
#pragma unroll
  for (int r = 0; r < CONV_ROWS; ++r) {
    if (s0 + r < s1) {
      // out[s] = sum_k w[k] x[s - (K - 1) + k], k in order
      float acc[8], in[8];
      unpack(raw[r], in);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = w[0][j] * in[j];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        unpack(raw[r + k], in);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(w[k][j], in[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = silu(acc[j]);
      store16(dst + (row0 + s0 + r) * width + col, pack(acc));
    }
  }
}

template <int VPT>
__global__ void __launch_bounds__(NORM_THREADS)
    mamba2_gated_rmsnorm(const NormArgs a) {
  __shared__ float part[NORM_WARPS];
  const long long base = static_cast<long long>(blockIdx.x) * a.W;
  const int nv = a.W / 8;
  float val[VPT][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * NORM_THREADS;
    if (v < nv) {
      const long long at = base + v * 8;
      float fy[8], fx[8], fz[8];
      unpack(load16(a.y + at), fy);
      unpack(load16(a.xc + at), fx);
      unpack(load16(a.z + at), fz);
      const float d = a.d[(v * 8) / a.P];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float g = fmaf(d, fx[j], fy[j]) * silu(fz[j]);
        val[i][j] = g;
        ss = fmaf(g, g, ss);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NORM_WARPS; ++w) total += part[w];
  const float r = rsqrtf(total / static_cast<float>(a.W) + a.eps);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * NORM_THREADS;
    if (v < nv) {
      const float4 s_lo = *reinterpret_cast<const float4*>(a.scale + v * 8);
      const float4 s_hi =
          *reinterpret_cast<const float4*>(a.scale + v * 8 + 4);
      const float sc[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w,
                           s_hi.x, s_hi.y, s_hi.z, s_hi.w};
      float out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = val[i][j] * r * sc[j];
      store16(a.out + base + v * 8, pack(out));
    }
  }
}

template <int VPT>
cudaError_t launch_norm(const NormArgs& a, int rows, cudaStream_t s) {
  mamba2_gated_rmsnorm<VPT><<<rows, NORM_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, W], bm/cm [rows, GN], dt [rows, H]: the prefill's projections,
// rows = B * S, sequences of S rows each; wx [k, W], wb/wc [k, GN]: the
// depthwise conv weights, k = K; dt_bias, a_log fp32 [H]. Writes xo, bo, co
// (SiLU of the causal conv, bf16, the inputs' shapes), dto = softplus(dt
// + dt_bias) fp32 [rows, H] and a = -exp(a_log) fp32 [H]. Returns the
// launch's cudaGetLastError() (0 on success).
int ssm_chain_conv_silu_bf16(const void* x, const void* bm, const void* cm,
                             const void* wx, const void* wb, const void* wc,
                             const void* dt, const void* dt_bias,
                             const void* a_log, void* xo, void* bo, void* co,
                             void* dto, void* a, int B, int S, int W, int GN,
                             int H, int k, void* stream) {
  if (B < 1 || S < 1 || W < 8 || W % 8 != 0 || GN < 8 || GN % 8 != 0 ||
      H < 1 || k != K)
    return cudaErrorInvalidValue;
  ConvArgs args{static_cast<const bf16*>(x), static_cast<const bf16*>(bm),
                static_cast<const bf16*>(cm), static_cast<const bf16*>(wx),
                static_cast<const bf16*>(wb), static_cast<const bf16*>(wc),
                static_cast<const bf16*>(dt),
                static_cast<const float*>(dt_bias),
                static_cast<const float*>(a_log), static_cast<bf16*>(xo),
                static_cast<bf16*>(bo), static_cast<bf16*>(co),
                static_cast<float*>(dto), static_cast<float*>(a),
                S, W, GN, H, W / 8, GN / 8, (H + 7) / 8,
                (S + CONV_ROWS - 1) / CONV_ROWS, 0u};
  const long long threads =
      static_cast<long long>(args.vx + 2 * args.vg + args.vh) * B *
      args.tiles_per_seq;
  if (threads >= (1ll << 31)) return cudaErrorInvalidValue;
  args.threads = static_cast<unsigned>(threads);
  const unsigned blocks = (args.threads + CONV_THREADS - 1) / CONV_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mamba2_conv_silu<<<blocks, CONV_THREADS, 0, s>>>(args);
  return cudaGetLastError();
}

// y [rows, W] (the scan's [B, S, H, P], channel c of head c / P), xc and z
// [rows, W] bf16; d fp32 [H], scale fp32 [W]. Writes out [rows, W] bf16 =
// rmsnorm((y + d xc) silu(z)) * scale, the norm in fp32 over each row with
// eps. Returns the launch's cudaGetLastError() (0 on success).
int ssm_chain_gated_rmsnorm_bf16(const void* y, const void* xc, const void* z,
                                 const void* d, const void* scale, void* out,
                                 int rows, int W, int P, float eps,
                                 void* stream) {
  const int vpt = (W / 8 + NORM_THREADS - 1) / NORM_THREADS;
  if (rows < 1 || W < 8 || W % 8 != 0 || P < 8 || P % 8 != 0 || W % P != 0 ||
      vpt > MAX_VPT)
    return cudaErrorInvalidValue;
  NormArgs args{static_cast<const bf16*>(y), static_cast<const bf16*>(xc),
                static_cast<const bf16*>(z), static_cast<const float*>(d),
                static_cast<const float*>(scale), static_cast<bf16*>(out),
                W, P, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vpt) {
    case 1: return launch_norm<1>(args, rows, s);
    case 2: return launch_norm<2>(args, rows, s);
    case 3: return launch_norm<3>(args, rows, s);
    case 4: return launch_norm<4>(args, rows, s);
    case 5: return launch_norm<5>(args, rows, s);
    case 6: return launch_norm<6>(args, rows, s);
    case 7: return launch_norm<7>(args, rows, s);
    default: return launch_norm<8>(args, rows, s);
  }
}

const char* ssm_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
