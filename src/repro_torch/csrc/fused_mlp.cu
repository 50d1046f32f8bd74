// SwiGLU MLP forward for Hopper (sm_90a), bf16:
//   y = (silu(x W1) * (x W3)).to(bf16) @ W2
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_mlp/fused_mlp.py:fused_mlp (_kernel)
// and computes what it computes: h is formed in fp32 and rounded to bf16
// once, the W2 product accumulates in fp32, y is rounded to bf16 once.
//
// One deliberate difference: h goes through device memory. The TPU kernel
// sweeps F in order on one core and keeps a [tm, K] fp32 accumulator in
// VMEM, so h never leaves the chip. H100 blocks run in no order and a
// block's 227 KB cannot hold that accumulator (2 MiB at K = 4096), so
// keeping h on chip costs a cross-block sum: M*K*F/128 fp32 atomics
// (~3.8 GB at granite_8b prefill), a zero-fill and a cast pass. Writing h
// in bf16 instead (58.7 MB at M = 2048, F = 14336: ~0.035 ms of HBM time
// against a 0.73 ms bound) turns the MLP into two plain GEMMs with fused
// epilogues, each written by hand here:
//   1. gate/up: h[M, F] = silu(x W1) * (x W3), both products in one block
//      over one x tile, the epilogue in fp32, h stored in bf16; under
//      grad the epilogue also stores g = x W1 and u = x W3 in bf16, which
//      the backward (csrc/fused_mlp_bwd.cu) reads instead of recomputing
//      two products (serving stores neither);
//   2. down: y[M, K] = h W2, stored in bf16.
// No atomics: the result does not depend on the run (bit-identical for the
// same inputs). The wrapper (kernels/fused_mlp/ops.py) picks the regime by
// M and bounds h by processing M in row chunks.
//
// What bounds it on an H100, and the two regimes:
//   prefill (M > 64; granite_8b M = 2048, K = 4096, F = 14336) does 721
//     GFLOP, compute bound at ~0.73 ms of bf16 tensor throughput. Kernel
//     `mlp_prefill`: persistent grid (one block per SM) walking 128 x 128
//     output tiles; a producer warpgroup keeps a 4-6 stage ring of TMA
//     loads (128B-swizzled 64-wide boxes, mbarrier completion) ahead of
//     two consumer warpgroups, each issuing wgmma m64n128k16 on its 64
//     rows with fp32 accumulators in registers; setmaxnreg moves registers
//     from the producer to the consumers; one k-block of wgmma stays in
//     flight while the previous stage is released.
//   decode (M <= 64; granite_8b batch 4) streams 352 MB of weights,
//     memory bound at ~0.1 ms. Kernel `mlp_decode` swaps A and B: the
//     weight is wgmma's 64-row A operand, read MN-major straight from its
//     row-major TMA box, and the few tokens are the N = 8..64 side, so no
//     zero rows go through the math. To spread the weight stream over
//     every SM, the reduction dim is split over a thread-block cluster of
//     1-8 blocks; the partial sums meet in distributed shared memory and
//     are added in rank order (deterministic), then the epilogue runs.
//     Each block keeps a 6-stage TMA ring (~100 KB) in flight.

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace sm90;

__device__ __forceinline__ float silu_mul(float a, float g) {
  return a * (1.f / (1.f + expf(-a))) * g;
}

// ---------------------------------------------------------------------------
// prefill: out[M, N] = epilogue(A[M, R] @ B[R, N]) for A = x (gate/up,
// B = W1 and W3) or A = h (down, B = W2)
// ---------------------------------------------------------------------------

constexpr int PM = 128;                   // rows per tile: 2 warpgroups x 64
constexpr int PN = 128;                   // output columns per tile
constexpr int PK = BOX;                   // reduction depth per stage
constexpr int P_THREADS = 384;            // WG0, WG1 consume; WG2 produces
constexpr int P_A_BYTES = PM * PK * 2;    // one [128 rows][64] box
constexpr int P_B_BOX = PK * BOX * 2;     // one [64 rows][64 cols] box
constexpr int P_B_BYTES = 2 * P_B_BOX;    // 128 output columns

template <bool GATED>
struct Prefill {
  static constexpr int NB = GATED ? 2 : 1;
  static constexpr int STAGE = P_A_BYTES + NB * P_B_BYTES;  // 48 / 32 KB
  static constexpr int STAGES = GATED ? 4 : 6;
  static constexpr int SMEM = STAGES * STAGE + 1024;        // + alignment
};

template <bool GATED>
__global__ void __launch_bounds__(P_THREADS, 1)
mlp_prefill(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb0,
            const __grid_constant__ CUtensorMap tb1, bf16* __restrict__ out,
            bf16* __restrict__ g_out, bf16* __restrict__ u_out, int M, int N,
            int R) {
  using C = Prefill<GATED>;
  __shared__ __align__(8) uint64_t full[C::STAGES];
  __shared__ __align__(8) uint64_t empty[C::STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int m_tiles = (M + PM - 1) / PM;
  const int tiles = m_tiles * (N / PN);
  const int kblocks = R / PK;

  if (wg == 2) {
    // producer: one thread issues every TMA load
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      Ring<C::STAGES> ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * PM, n0 = (t / m_tiles) * PN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
          uint8_t* st = smem + ring.stage * C::STAGE;
          uint64_t* bar = &full[ring.stage];
          mbar_expect_tx(bar, C::STAGE);
          tma_load_2d(st, &ta, bar, kb * PK, m0);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            tma_load_2d(st + P_A_BYTES + j * P_B_BOX, &tb0, bar, n0 + j * BOX,
                        kb * PK);
            if constexpr (GATED)
              tma_load_2d(st + P_A_BYTES + P_B_BYTES + j * P_B_BOX, &tb1, bar,
                          n0 + j * BOX, kb * PK);
          }
          ring.advance();
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    regs_alloc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc0[PN / 2], acc1[PN / 2];  // acc1: x W3, gate/up only
    Ring<C::STAGES> ring;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * PM, n0 = (t / m_tiles) * PN;
#pragma unroll
      for (int i = 0; i < PN / 2; ++i) acc0[i] = acc1[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[ring.stage], ring.phase);
        const uint8_t* st = smem + ring.stage * C::STAGE;
        const uint8_t* a = st + wg * 64 * BOX_ROW_BYTES;
        fence_regs(acc0);
        if constexpr (GATED) fence_regs(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < PK / 16; ++kk) {
          const uint64_t da = desc_kmajor(a, kk, P_A_BYTES);
          Wgmma<PN, 0, 1>::ss(acc0, da,
                              desc_mnmajor(st + P_A_BYTES, kk, P_B_BOX), 1);
          if constexpr (GATED)
            Wgmma<PN, 0, 1>::ss(
                acc1, da,
                desc_mnmajor(st + P_A_BYTES + P_B_BYTES, kk, P_B_BOX), 1);
        }
        wgmma_commit();
        fence_regs(acc0);
        if constexpr (GATED) fence_regs(acc1);
        // the previous k-block's products are done: release its stage
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = ring.stage;
        ring.advance();
      }
      wgmma_wait<0>();
      fence_regs(acc0);
      if constexpr (GATED) fence_regs(acc1);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // epilogue straight from the accumulator fragments
      const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int i = 0; i < PN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          const long long at = static_cast<long long>(row) * N + col;
          float v0 = acc0[4 * i + 2 * half], v1 = acc0[4 * i + 2 * half + 1];
          if constexpr (GATED) {
            const float u0 = acc1[4 * i + 2 * half];
            const float u1 = acc1[4 * i + 2 * half + 1];
            if (g_out != nullptr && row < M) {
              *reinterpret_cast<uint32_t*>(g_out + at) = pack_bf16(v0, v1);
              *reinterpret_cast<uint32_t*>(u_out + at) = pack_bf16(u0, u1);
            }
            v0 = silu_mul(v0, u0);
            v1 = silu_mul(v1, u1);
          }
          if (row < M)
            *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode: out[M, O] = epilogue(act[M, R] @ W[R, O]) computed transposed,
// out^T = W^T act^T, with the reduction dim R split over a cluster
// ---------------------------------------------------------------------------

constexpr int D_THREADS = 160;            // one consumer warpgroup + 1 warp
constexpr int D_STAGES = 6;
constexpr int D_A_BOX = BOX * BOX * 2;    // [64 reduction rows][64 outputs]

template <bool GATED, int NP>
struct Decode {
  static constexpr int NA = GATED ? 2 : 1;
  static constexpr int B_TILE = NP * BOX_ROW_BYTES;  // [NP tokens][64]
  static constexpr int STAGE = NA * D_A_BOX + B_TILE;
  static constexpr int SMEM = D_STAGES * STAGE + 1024;
  static_assert(B_TILE % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(NA * 64 * NP * 4 <= D_STAGES * STAGE, "partials fit");
};

template <bool GATED, int NP>
__global__ void __launch_bounds__(D_THREADS)
mlp_decode(const __grid_constant__ CUtensorMap ta0,
           const __grid_constant__ CUtensorMap ta1,
           const __grid_constant__ CUtensorMap tb, bf16* __restrict__ out,
           int M, int O, int R) {
  using C = Decode<GATED, NP>;
  __shared__ __align__(8) uint64_t full[D_STAGES];
  __shared__ __align__(8) uint64_t empty[D_STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int o0 = (blockIdx.x / cs) * 64;
  const int nb = R / BOX;
  const int kb0 = rank * nb / cs, kb1 = (rank + 1) * nb / cs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc0[NP / 2], acc1[NP / 2];  // acc1: W3^T x^T, gate/up only
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc0[i] = acc1[i] = 0.f;

  if (warp == 4) {
    if (lane == 0) {
      Ring<D_STAGES> ring;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        uint8_t* st = smem + ring.stage * C::STAGE;
        uint64_t* bar = &full[ring.stage];
        mbar_expect_tx(bar, C::STAGE);
        tma_load_2d(st, &ta0, bar, o0, kb * BOX);
        if constexpr (GATED) tma_load_2d(st + D_A_BOX, &ta1, bar, o0, kb * BOX);
        tma_load_2d(st + C::NA * D_A_BOX, &tb, bar, kb * BOX, 0);
        ring.advance();
      }
    }
  } else {
    Ring<D_STAGES> ring;
    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(&full[ring.stage], ring.phase);
      const uint8_t* st = smem + ring.stage * C::STAGE;
      fence_regs(acc0);
      if constexpr (GATED) fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk) {
        const uint64_t db = desc_kmajor(st + C::NA * D_A_BOX, kk, C::B_TILE);
        Wgmma<NP, 1, 0>::ss(acc0, desc_mnmajor(st, kk, D_A_BOX), db, 1);
        if constexpr (GATED)
          Wgmma<NP, 1, 0>::ss(acc1, desc_mnmajor(st + D_A_BOX, kk, D_A_BOX),
                              db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      if constexpr (GATED) fence_regs(acc1);
      if (lane == 0) mbar_arrive(&empty[ring.stage]);
      ring.advance();
    }
  }
  // Every load was consumed, so the ring's memory now holds this block's
  // fp32 partials: [NA][64 outputs][NP tokens].
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  if (warp < 4) {
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = r0 + 8 * (j / 2), c = col + (j % 2);
        part[row * NP + c] = acc0[4 * i + j];
        if constexpr (GATED) part[64 * NP + row * NP + c] = acc1[4 * i + j];
      }
    }
  }
  cluster.sync();
  // rank r finishes outputs [r * 64 / cs, (r + 1) * 64 / cs), adding the
  // cluster's partials in rank order
  const int rows = 64 / cs, row_lo = rank * rows;
  for (int idx = threadIdx.x; idx < rows * NP; idx += D_THREADS) {
    const int row = row_lo + idx % rows, m = idx / rows;
    if (m >= M) continue;
    float a = 0.f, g = 0.f;
    for (int q = 0; q < cs; ++q) {
      const float* p = cluster.map_shared_rank(part, q);
      a += p[row * NP + m];
      if constexpr (GATED) g += p[64 * NP + row * NP + m];
    }
    out[static_cast<long long>(m) * O + o0 + row] =
        __float2bfloat16(GATED ? silu_mul(a, g) : a);
  }
  cluster.sync();  // partials stay alive until every rank has read them
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <bool GATED>
cudaError_t launch_prefill(const CUtensorMap& ta, const CUtensorMap& tb0,
                           const CUtensorMap& tb1, bf16* out, bf16* g,
                           bf16* u, int M, int N, int R, int sms,
                           cudaStream_t s) {
  using C = Prefill<GATED>;
  static unsigned long long devices = 0;
  cudaError_t err = allow_smem(mlp_prefill<GATED>, C::SMEM, devices);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + PM - 1) / PM) * (N / PN);
  mlp_prefill<GATED><<<tiles < sms ? tiles : sms, P_THREADS, C::SMEM, s>>>(
      ta, tb0, tb1, out, g, u, M, N, R);
  return cudaGetLastError();
}

template <bool GATED, int NP>
cudaError_t launch_decode(const CUtensorMap& ta0, const CUtensorMap& ta1,
                          const CUtensorMap& tb, bf16* out, int M, int O,
                          int R, int split, cudaStream_t s) {
  using C = Decode<GATED, NP>;
  static unsigned long long devices = 0;
  cudaError_t err = allow_smem(mlp_decode<GATED, NP>, C::SMEM, devices);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O / 64) * split);
  cfg.blockDim = dim3(D_THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mlp_decode<GATED, NP>, ta0, ta1, tb, out, M,
                            O, R);
}

template <int NP>
cudaError_t decode(const bf16* x, const bf16* w1, const bf16* w3,
                   const bf16* w2, bf16* h, bf16* y, int M, int K, int F,
                   int split_up, int split_down, cudaStream_t s) {
  // the down kernel's descriptors are made while gate/up runs
  CUtensorMap t_w1, t_w3, t_x, t_w2, t_h;
  if (!make_tmap_2d(&t_w1, w1, K, F, F, BOX) ||
      !make_tmap_2d(&t_w3, w3, K, F, F, BOX) ||
      !make_tmap_2d(&t_x, x, M, K, K, NP))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_decode<true, NP>(t_w1, t_w3, t_x, h, M, F, K,
                                            split_up, s);
  if (err != cudaSuccess) return err;
  if (!make_tmap_2d(&t_w2, w2, F, K, K, BOX) ||
      !make_tmap_2d(&t_h, h, M, F, F, NP))
    return cudaErrorInvalidValue;
  return launch_decode<false, NP>(t_w2, t_w2, t_h, y, M, K, F, split_down, s);
}

}  // namespace

extern "C" {

// x [M, K], w1/w3 [K, F], w2 [F, K], h [M, F] (scratch), y [M, K]; bf16,
// contiguous, 16-byte aligned; K % 128 == 0, F % 128 == 0. g and u: null,
// or [M, F] outputs that receive x W1 and x W3 in bf16 (the backward's
// inputs; prefill kernels only).
// decode != 0 (M <= 64): the swap-AB cluster kernels, reduction split over
// split_up (gate/up, over K) and split_down (down, over F) blocks, each in
// {1, 2, 4, 8} and at most the reduction's 64-wide blocks. decode == 0:
// the persistent wgmma kernels on `sms` blocks at most.
// Returns the first CUDA error of the two launches (0 on success).
int fused_mlp_fwd_bf16(const void* x, const void* w1, const void* w3,
                       const void* w2, void* h, void* y, void* g, void* u,
                       int M, int K, int F, int decode_regime, int split_up,
                       int split_down, int sms, void* stream) {
  if (M < 1 || K % 128 != 0 || F % 128 != 0 ||
      (g == nullptr) != (u == nullptr) || (g != nullptr && decode_regime))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* w3p = static_cast<const bf16*>(w3);
  const bf16* w2p = static_cast<const bf16*>(w2);
  bf16* hp = static_cast<bf16*>(h);
  bf16* yp = static_cast<bf16*>(y);
  if (decode_regime) {
    auto ok = [](int sp, int red) {
      return (sp == 1 || sp == 2 || sp == 4 || sp == 8) && sp <= red / BOX;
    };
    if (M > 64 || !ok(split_up, K) || !ok(split_down, F))
      return cudaErrorInvalidValue;
    if (M <= 8)
      return decode<8>(xp, w1p, w3p, w2p, hp, yp, M, K, F, split_up,
                       split_down, s);
    if (M <= 16)
      return decode<16>(xp, w1p, w3p, w2p, hp, yp, M, K, F, split_up,
                        split_down, s);
    if (M <= 32)
      return decode<32>(xp, w1p, w3p, w2p, hp, yp, M, K, F, split_up,
                        split_down, s);
    return decode<64>(xp, w1p, w3p, w2p, hp, yp, M, K, F, split_up,
                      split_down, s);
  }
  CUtensorMap t_x, t_w1, t_w3, t_h, t_w2;
  if (!make_tmap_2d(&t_x, x, M, K, K, PM) ||
      !make_tmap_2d(&t_w1, w1, K, F, F, PK) ||
      !make_tmap_2d(&t_w3, w3, K, F, F, PK))
    return cudaErrorInvalidValue;
  cudaError_t err =
      launch_prefill<true>(t_x, t_w1, t_w3, hp, static_cast<bf16*>(g),
                           static_cast<bf16*>(u), M, F, K, sms, s);
  if (err != cudaSuccess) return err;
  if (!make_tmap_2d(&t_h, h, M, F, F, PM) ||
      !make_tmap_2d(&t_w2, w2, F, K, K, PK))
    return cudaErrorInvalidValue;
  return launch_prefill<false>(t_h, t_w2, t_w2, yp, nullptr, nullptr, M, K,
                               F, sms, s);
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
