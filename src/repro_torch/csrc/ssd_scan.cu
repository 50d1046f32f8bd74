// Mamba-2 SSD chunk scan forward for Hopper: bf16 x, B, C; fp32 dt, A.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan (_kernel)
// and computes what it computes, in fp32: per chunk of L steps,
// cum = cumsum(dt * a); y = [(C B^T) * exp(cum_i - cum_j) * dt_j]_(i>=j) x
// + (C * exp(cum)) S_prev; S = S * exp(cum_L) + (B * exp(cum_L - cum) dt)^T x,
// with y rounded once to bf16. It also writes the final state S [N, P]
// (fp32), which the Pallas kernel keeps in VMEM and drops: prefill needs it
// for the decode cache (it is ``final`` of models/ssm.py::ssd_chunked).
//
// Differences from the TPU, and what the design does about them:
// - The TPU grid runs the chunk axis in order and carries S in VMEM
//   scratch; H100 blocks run in no order. One block per (batch, head)
//   loops over the chunks itself with S in shared memory (128 x 64 fp32 =
//   32 KB at mamba2_780m).
// - The Pallas body holds [L, L] fp32 scores/decay matrices (256 KB each
//   at L = 256, over a block's 227 KB). Here the chunk is walked in
//   64-row query tiles; for each, the 64 x 64 tiles of C B^T are formed
//   for key tiles j <= i only (tiles above the diagonal are skipped), the
//   decay and dt_j applied, and their product with x_j accumulated into
//   the tile's 64 x P output in registers.
// - Every decay is exp of a difference of cumsums, formed only where
//   i >= j (masked before exp: above the diagonal cum_i - cum_j > 0 can
//   overflow, and inf * 0 would give NaN). Never exp(cum_i) / exp(cum_j).
// - Layouts by element strides: x [B, S, H, P], dt [B, S, H], A [H],
//   B/C [B, S, G, N] read at group h / (H / G) without expanding groups,
//   y [B, S, H, P]; the Pallas layout [BH, S, *] runs as B = 1, H = G = BH.
//
// What bounds it on an H100: at mamba2_780m's prefill (B*H = 4*48,
// S = 2048, P = 64, N = 128, L = 256) the work is ~32 GFLOP against
// ~113 MB, so both bounds are ~0.033 ms at the data sheet's bf16 tensor
// rate and HBM bandwidth. This first kernel is far from that: it does its
// sums in fp32 on the CUDA cores (67 TFLOP/s peak, not the tensor cores),
// and its 192 blocks of 141 KB shared memory run one per SM, two waves on
// 132 SMs. Tensor cores (mma/wgmma for C B^T and M x), cp.async/TMA
// staging and a split over P are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int P = 64;           // head dim: columns of x, y and the state
constexpr int T = 64;           // rows of a query or key tile
constexpr int NTHREADS = 256;   // 16 x 16 threads, each owns a 4 x 4 sub-tile
constexpr int LDT = T + 4;      // fp32 pitch of the transposed tiles
constexpr int LDX = P + 4;      // fp32 pitch of x tiles and of the state
constexpr int MAX_NB = 2;       // state rows in 64-row blocks (N <= 128)

struct Strides {
  long long b, s, h;            // element strides of [B, S, H(or G), *]
};

__device__ __forceinline__ void outer(float (&acc)[4][4], float4 a,
                                      float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ void unpack8(uint4 raw, float (&v)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(h[k]);
}

// dst[w * LDT + r] = src[r * rs + w] for r < rows and w < W, else 0, for
// w < w_pad: a 64-row tile of B or C, transposed to [N][64] in fp32.
__device__ void load_tile_t(float* dst, const bf16* src, long long rs,
                            int rows, int W, int w_pad) {
  const int nv = w_pad / 8;
  for (int e = threadIdx.x; e < T * nv; e += NTHREADS) {
    const int r = e % T, v = e / T;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows && v * 8 < W)
      unpack8(*reinterpret_cast<const uint4*>(src + r * rs + v * 8), vals);
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(v * 8 + k) * LDT + r] = vals[k];
  }
}

// dst[r * LDX + p] = src[r * rs + p] * scale_r for r < rows, else 0: a
// 64-row tile of x in fp32. scale_r = 1, or exp(cl - cum[r]) * dts[r]
// when cum is given (the state update's weights).
__device__ void load_x(float* dst, const bf16* src, long long rs, int rows,
                       const float* cum, const float* dts, float cl) {
  for (int e = threadIdx.x; e < T * (P / 8); e += NTHREADS) {
    const int r = e / (P / 8), v = e % (P / 8);
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows) {
      unpack8(*reinterpret_cast<const uint4*>(src + r * rs + v * 8), vals);
      if (cum != nullptr) {
        const float w = expf(cl - cum[r]) * dts[r];
#pragma unroll
        for (int k = 0; k < 8; ++k) vals[k] *= w;
      }
    }
    float4* d = reinterpret_cast<float4*>(dst + r * LDX + v * 8);
    d[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    d[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(NTHREADS)
ssd_fwd(const bf16* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const bf16* __restrict__ Bm,
        const bf16* __restrict__ Cm, bf16* __restrict__ y,
        float* __restrict__ state, int S, int H, int G, int N, int n_pad,
        int chunk, Strides xs, Strides ds, long long as, Strides bs,
        Strides cs, Strides ys) {
  extern __shared__ __align__(16) float smem[];
  float* St = smem;                     // [n_pad][LDX] running state
  float* Ct = St + n_pad * LDX;         // [n_pad][LDT] query tile of C^T
  float* Bt = Ct + n_pad * LDT;         // [n_pad][LDT] key tile of B^T
  float* Xs = Bt + n_pad * LDT;         // [T][LDX] key tile of x
  float* Mt = Xs + T * LDX;             // [T][LDT] decayed scores, M^T
  float* cum = Mt + T * LDT;            // [chunk] cumsum(dt * a)
  float* dts = cum + chunk;             // [chunk] dt

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nbs = n_pad / T;
  const float a = A[h * as];
  const bf16* xb = x + b * xs.b + h * xs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const bf16* Bb = Bm + b * bs.b + g * bs.h;
  const bf16* Cb = Cm + b * cs.b + g * cs.h;
  bf16* yb = y + b * ys.b + h * ys.h;

  for (int i = threadIdx.x; i < n_pad * LDX; i += NTHREADS) St[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();                    // last chunk's state update done
    for (int i = threadIdx.x; i < chunk; i += NTHREADS)
      dts[i] = db[(c0 + i) * ds.s];
    __syncthreads();
    if (threadIdx.x == 0) {
      float run = 0.f;
      for (int i = 0; i < chunk; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
    }

    for (int i0 = 0; i0 < chunk; i0 += T) {
      const int rows_i = min(T, chunk - i0);
      __syncthreads();                  // cum ready / last tile's Ct read
      load_tile_t(Ct, Cb + (c0 + i0) * cs.s, cs.s, rows_i, N, n_pad);
      __syncthreads();

      // inter-chunk term: exp(cum_r) * sum_n C[r, n] S_prev[n, p]
      float acc[4][4] = {};
      for (int n = 0; n < n_pad; ++n)
        outer(acc, ld4(Ct + n * LDT + ty * 4), ld4(St + n * LDX + tx * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty * 4 + i;
        const float e = r < chunk ? expf(cum[r]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // intra-chunk term over key tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += T) {
        const int rows_j = min(T, chunk - j0);
        __syncthreads();                // last key tile's Bt, Xs, Mt read
        load_tile_t(Bt, Bb + (c0 + j0) * bs.s, bs.s, rows_j, N, n_pad);
        load_x(Xs, xb + (c0 + j0) * xs.s, xs.s, rows_j, nullptr, nullptr,
               0.f);
        __syncthreads();
        float sc[4][4] = {};
        for (int n = 0; n < n_pad; ++n)
          outer(sc, ld4(Ct + n * LDT + ty * 4), ld4(Bt + n * LDT + tx * 4));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = i0 + ty * 4 + i, c = j0 + tx * 4 + j;
            float m = 0.f;              // mask before exp (c <= r < chunk)
            if (r >= c && r < chunk)
              m = sc[i][j] * expf(cum[r] - cum[c]) * dts[c];
            Mt[(tx * 4 + j) * LDT + ty * 4 + i] = m;
          }
        __syncthreads();
        for (int c = 0; c < T; ++c)
          outer(acc, ld4(Mt + c * LDT + ty * 4), ld4(Xs + c * LDX + tx * 4));
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty * 4 + i;
        if (r < chunk) {
          __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
          uint2 packed;
          packed.x = *reinterpret_cast<unsigned int*>(&lo);
          packed.y = *reinterpret_cast<unsigned int*>(&hi);
          *reinterpret_cast<uint2*>(yb + (c0 + r) * ys.s + tx * 4) = packed;
        }
      }
    }

    // state: S = S * exp(cum_L) + sum_j B_j^T (exp(cum_L - cum_j) dt_j x_j)
    const float cl = cum[chunk - 1];
    float sacc[MAX_NB][4][4] = {};
    for (int j0 = 0; j0 < chunk; j0 += T) {
      const int rows_j = min(T, chunk - j0);
      __syncthreads();                  // query tiles' Bt, Xs reads done
      load_tile_t(Bt, Bb + (c0 + j0) * bs.s, bs.s, rows_j, N, n_pad);
      load_x(Xs, xb + (c0 + j0) * xs.s, xs.s, rows_j, cum + j0, dts + j0, cl);
      __syncthreads();
#pragma unroll
      for (int nb = 0; nb < MAX_NB; ++nb) {
        if (nb < nbs) {
          const float* brow = Bt + (nb * T + ty * 4) * LDT;
          for (int j = 0; j < T; ++j) {
            const float4 bv = make_float4(brow[j], brow[LDT + j],
                                          brow[2 * LDT + j],
                                          brow[3 * LDT + j]);
            outer(sacc[nb], bv, ld4(Xs + j * LDX + tx * 4));
          }
        }
      }
    }
    const float decay = expf(cl);
#pragma unroll
    for (int nb = 0; nb < MAX_NB; ++nb) {
      if (nb < nbs) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* s = St + (nb * T + ty * 4 + i) * LDX + tx * 4 + j;
            *s = *s * decay + sacc[nb][i][j];
          }
      }
    }
  }
  __syncthreads();

  float* sb = state + (static_cast<long long>(b) * H + h) * N * P;
  for (int i = threadIdx.x; i < N * P; i += NTHREADS)
    sb[i] = St[(i / P) * LDX + i % P];
}

}  // namespace

extern "C" {

// strides: 16 element strides: (batch, seq, head) of x, of dt, the head
// stride of A, (batch, seq, group) of B, of C, and (batch, seq, head) of
// y. state is a contiguous fp32 [batch, H, N, P]. Returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the kernel does not take.
int ssd_scan_fwd_bf16(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, void* y, void* state,
                      int batch, int S, int H, int G, int N, int p,
                      int chunk, const long long* strides, void* stream) {
  if (p != P || N <= 0 || N % 8 || N > MAX_NB * T || G <= 0 || H % G ||
      chunk <= 0 || S % chunk)
    return cudaErrorInvalidValue;
  const int n_pad = (N + T - 1) / T * T;
  const size_t bytes = sizeof(float) * (static_cast<size_t>(n_pad) *
                                            (LDX + 2 * LDT) +
                                        T * (LDX + LDT) + 2 * chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides ds{strides[3], strides[4], strides[5]};
  const long long as = strides[6];
  const Strides bs{strides[7], strides[8], strides[9]};
  const Strides cs{strides[10], strides[11], strides[12]};
  const Strides ys{strides[13], strides[14], strides[15]};
  ssd_fwd<<<batch * H, NTHREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<bf16*>(y),
      static_cast<float*>(state), S, H, G, N, n_pad, chunk, xs, ds, as, bs,
      cs, ys);
  return cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
