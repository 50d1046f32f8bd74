// Fused SwiGLU MLP forward for Hopper, bf16:
//   y = sum_j [silu(x W1[:, j]) * (x W3[:, j])] W2[j, :]
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_mlp/fused_mlp.py:fused_mlp (_kernel)
// and keeps its defining property: the [M, F] hidden activation never
// reaches device memory. As there, h is formed in fp32, rounded to the
// input type, and multiplied by W2 with fp32 accumulation.
//
// Why the decomposition differs: the TPU grid sweeps F in order on one
// core and keeps a [tm, K] fp32 accumulator in VMEM across the sweep.
// At K = 4096 and tm = 128 that is 2 MiB, ~9x the 227 KB of shared
// memory an H100 block may use, and H100 blocks run in no order. So the
// grid here is (M tiles x F tiles), every block independent:
//   1. h[64, 128] = silu(x W1[:, f]) * (x W3[:, f]) on the tensor cores
//      (WMMA bf16, fp32 accumulation), K swept in steps of 64;
//   2. h is rounded to bf16 and kept in shared memory;
//   3. h W2[f, :] is formed 128 output columns at a time and added into
//      an fp32 [M, K] workspace with 16-byte (float4) atomics;
//   4. a second, elementwise launch casts the workspace to y.
// Each weight is read once per M tile and nothing is recomputed. The
// price is M*K*(F/128) fp32 atomic additions, whose order varies from
// run to run, so results match a serial sum only to fp32 rounding.
//
// What bounds it on an H100: prefill (M = 2048 at granite_8b's K = 4096,
// F = 14336) does 721 GFLOP, compute bound at ~0.73 ms of bf16 tensor
// throughput; decode (M <= 16) streams 352 MB of weights, memory bound at
// ~0.1 ms. For decode the block grid (F / 128 = 112 blocks) spreads the
// weight stream over most SMs; rows past M are zero-filled and never
// written. This first kernel is simple: single-buffered tiles, no
// cp.async/TMA pipeline and no wgmma, which a later change can add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TM = 64;           // rows of x per block
constexpr int TF = 128;          // hidden (d_ff) columns per block
constexpr int KC = 64;           // depth of one x W1 / x W3 step
constexpr int NC = 128;          // output columns per h W2 step
constexpr int NTHREADS = 256;    // 8 warps: 4 row groups x 2 column halves

constexpr int LDX = KC + 8;      // bf16 pitch of the x tile
constexpr int LDW = TF + 8;      // bf16 pitch of W1/W3 tiles and of h
constexpr int LDW2 = NC + 8;     // bf16 pitch of the W2 tile
constexpr int LDF = 128 + 4;     // fp32 pitch of [64 x 128] scratch tiles

// Region 0 holds, in turn, the x/W1/W3 tiles, the fp32 x W3 product and
// the W2 tile; region 1 the fp32 x W1 product, then the output tile;
// region 2 the bf16 h tile.
constexpr size_t R0_PHASE1 = sizeof(bf16) * (TM * LDX + 2 * KC * LDW);
constexpr size_t R0_W2 = sizeof(bf16) * TF * LDW2;
constexpr size_t R0_F32 = sizeof(float) * TM * LDF;
constexpr size_t R0 = R0_PHASE1 > R0_W2
    ? (R0_PHASE1 > R0_F32 ? R0_PHASE1 : R0_F32)
    : (R0_W2 > R0_F32 ? R0_W2 : R0_F32);
constexpr size_t R1 = sizeof(float) * TM * LDF;
constexpr size_t R2 = sizeof(bf16) * TM * LDW;
constexpr size_t SMEM_BYTES = R0 + R1 + R2;
static_assert(R0 % 128 == 0 && R1 % 128 == 0, "regions stay aligned");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(NTHREADS)
fused_mlp_fwd(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const bf16* __restrict__ w3, const bf16* __restrict__ w2,
              float* __restrict__ ws, int M, int K, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = xs + TM * LDX;
  bf16* w3s = w1s + KC * LDW;
  float* h3 = reinterpret_cast<float*>(smem);
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  float* h1 = reinterpret_cast<float*>(smem + R0);   // later: output tile
  bf16* hs = reinterpret_cast<bf16*>(smem + R0 + R1);

  const int m0 = blockIdx.x * TM, f0 = blockIdx.y * TF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 2) * 16;       // this warp's rows [wr, wr + 16)
  const int wc = (warp % 2) * 64;       // and columns [wc, wc + 64)

  // 1. x W1 and x W3 for this block's 128 hidden columns
  FragC acc1[4], acc3[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(acc1[n], 0.f);
    wmma::fill_fragment(acc3[n], 0.f);
  }
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = threadIdx.x; i < TM * KC / 8; i += NTHREADS) {
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(
            x + static_cast<long long>(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * LDX + c) = val;
    }
    for (int i = threadIdx.x; i < KC * TF / 8; i += NTHREADS) {
      const int r = i / (TF / 8), c = (i % (TF / 8)) * 8;
      const long long off = static_cast<long long>(k0 + r) * F + f0 + c;
      *reinterpret_cast<uint4*>(w1s + r * LDW + c) =
          *reinterpret_cast<const uint4*>(w1 + off);
      *reinterpret_cast<uint4*>(w3s + r * LDW + c) =
          *reinterpret_cast<const uint4*>(w3 + off);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, xs + wr * LDX + kk * 16, LDX);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FragB b;
        wmma::load_matrix_sync(b, w1s + kk * 16 * LDW + wc + n * 16, LDW);
        wmma::mma_sync(acc1[n], a, b, acc1[n]);
        wmma::load_matrix_sync(b, w3s + kk * 16 * LDW + wc + n * 16, LDW);
        wmma::mma_sync(acc3[n], a, b, acc3[n]);
      }
    }
    __syncthreads();
  }

  // 2. h = silu(x W1) * (x W3) in fp32, rounded to bf16, kept on chip
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(h1 + wr * LDF + wc + n * 16, acc1[n], LDF,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(h3 + wr * LDF + wc + n * 16, acc3[n], LDF,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * 64; i += 32) {
    const int r = wr + i / 64, c = wc + i % 64;
    const float a = h1[r * LDF + c];
    const float g = h3[r * LDF + c];
    hs[r * LDW + c] = __float2bfloat16(a * (1.f / (1.f + expf(-a))) * g);
  }
  __syncthreads();                      // h complete; region 0 free for W2

  // 3. y[m0:m0+64, :] += h W2[f0:f0+128, :], 128 columns at a time
  float* out = h1;
  for (int n0 = 0; n0 < K; n0 += NC) {
    for (int i = threadIdx.x; i < TF * NC / 8; i += NTHREADS) {
      const int r = i / (NC / 8), c = (i % (NC / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + r * LDW2 + c) =
          *reinterpret_cast<const uint4*>(
              w2 + static_cast<long long>(f0 + r) * K + n0 + c);
    }
    __syncthreads();
    FragC acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < TF / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, hs + wr * LDW + kk * 16, LDW);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FragB b;
        wmma::load_matrix_sync(b, w2s + kk * 16 * LDW2 + wc + n * 16, LDW2);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(out + wr * LDF + wc + n * 16, acc[n], LDF,
                              wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * 16; i += 32) {   // 16 rows x 16 float4
      const int r = i / 16, c = wc + (i % 16) * 4;
      const int row = m0 + wr + r;
      if (row < M) {
        const float4 val =
            *reinterpret_cast<const float4*>(out + (wr + r) * LDF + c);
        atomicAdd(reinterpret_cast<float4*>(
                      ws + static_cast<long long>(row) * K + n0 + c),
                  val);
      }
    }
    __syncthreads();                    // W2 tile and output tile reused
  }
}

__global__ void cast_to_bf16(const float* __restrict__ ws,
                             bf16* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    y[i] = __float2bfloat16(ws[i]);
}

}  // namespace

extern "C" {

// x [M, K], w1/w3 [K, F], w2 [F, K], y [M, K] bf16, all contiguous;
// ws [M, K] fp32 zero-filled by the caller. K % 128 == 0, F % 128 == 0.
// Returns cudaGetLastError() after the launches (0 on success).
int fused_mlp_fwd_bf16(const void* x, const void* w1, const void* w3,
                       const void* w2, void* ws, void* y, int M, int K,
                       int F, void* stream) {
  if (K % NC != 0 || K % KC != 0 || F % TF != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  dim3 grid((M + TM - 1) / TM, F / TF);
  fused_mlp_fwd<<<grid, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
      static_cast<float*>(ws), M, K, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(M) * K;
  const long long blocks = (n + 255) / 256;
  cast_to_bf16<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256,
                 0, s>>>(static_cast<const float*>(ws),
                         static_cast<bf16*>(y), n);
  return cudaGetLastError();
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
