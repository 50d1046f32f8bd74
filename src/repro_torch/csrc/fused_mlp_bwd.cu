// SwiGLU MLP backward for Hopper (sm_90a), bf16 in and out, fp32 inside:
// the gradients (dx, dW1, dW3, dW2) of
//   y = (silu(x W1) * (x W3)).to(bf16) @ W2
// for the output's gradient dy.
//
// Stands for the gradient of the Pallas TPU kernel
//   src/repro/kernels/fused_mlp/fused_mlp.py:fused_mlp (pallas_call at :61).
// That kernel is forward-only: the reference's gradients are XLA's autodiff
// of its einsums (src/repro/models/mlp.py), outside any Pallas kernel. This
// file computes that gradient as the port's plain version
// kernels/fused_mlp/ops.py:fused_mlp_bwd does, from g = x W1 and u = x W3
// as the forward kernel saved them under grad (bf16, csrc/fused_mlp.cu's
// gate/up epilogue; the reference's einsums give bf16 g and u too):
//   dh = dy W2^T                                   (fp32, never stored)
//   h  = silu(g) u,  dg = dh u sig(g) (1 + g (1 - sig(g))),  du = dh silu(g)
//   dx = dg W1^T + du W3^T     (one fp32 accumulator over both, rounded once)
//   dW1 = x^T dg,  dW3 = x^T du,  dW2 = h^T dy
// h, dg and du are rounded to bf16 once, in the first kernel's epilogue,
// before the products that read them; every product takes bf16 operands
// into fp32 accumulators.
//
// What bounds it on an H100: six products of 2 M K F (dh, dx's two, dW1,
// dW3, dW2), 1.65 TFLOP at olmo_1b's train shape (M = 8192, K = 2048,
// F = 8192): the tensor cores, 1.67 ms at 989 TFLOP/s. The bytes (x, dy,
// the weights and the gradients once, 0.2 GB) take 0.06 ms; the h, dg, du
// round trip and the g, u reads add 1.3 GB, ~0.4 ms of HBM time spread
// under the products. Recomputing g and u instead would cost two more
// products (a 2.22 ms bound), so the forward saves them.
//
// Four launches, each a persistent GEMM on the forward's skeleton (one
// block per SM walking output tiles; a producer warpgroup keeps a ring of
// TMA loads, 128B-swizzled 64-wide boxes completing on mbarriers, ahead of
// two consumer warpgroups that issue wgmma m64n128k16 on 64 rows each;
// setmaxnreg moves registers to the consumers; one k-block of wgmma in
// flight while the previous stage is released). wgmma reads bf16 operands
// from shared memory in either major, so no operand is transposed in
// memory:
//   mlp_bwd_dh   [M, F] over K: A = dy (K-major), B = W2 rows (K-major);
//                the epilogue reads the g and u tiles and writes h, dg, du.
//   mlp_bwd_dw2  [F, K] over M: A = h^T (MN-major), B = dy (MN-major).
//   mlp_bwd_dx   [M, K] over 2F: the reduction runs (dg, W1) and then
//                (du, W3) into the same accumulator (both K-major).
//   mlp_bwd_dw13 [K, F] over M: A = x^T (MN-major) shared by B = dg and
//                B = du (MN-major), two accumulators: the forward's gated
//                shape.
// Every kernel keeps two fp32 accumulators of 64 x 128 a warpgroup behind
// one A tile: dW1's and dW3's in mlp_bwd_dw13, the two 128-column halves
// of a 128 x 256 output tile in the others. A 128 x 128 tile with one
// accumulator moves 32 KB from L2 per 2 MFLOP, which asks ~15 TB/s of L2
// at the tensor cores' rate; 256 columns (or two outputs) bring that to
// ~11 TB/s (measured on an H100 at olmo_1b's shape: 48% of the bf16 peak
// for the 128-wide GEMMs, 77% for the two-accumulator one).
// Every epilogue writes its tile through shared memory: each consumer
// warpgroup fills [64 rows][64] boxes from its accumulators and one of
// its threads writes them back by TMA stores, which drain while the next
// tile's products run. mlp_bwd_dh's epilogue moves 5 bytes of g, u, h,
// dg, du per 2 bytes of dy W2^T: written with plain stores (each warp
// store 8 rows of 16 bytes, the products waiting behind them) it held
// that kernel at 26% of the bf16 peak. Its g and u come into a slot a
// warpgroup that the producer fills by TMA once it has issued the tile's
// k-blocks; that buffer leaves room for three ring stages (four for the
// others). Its sigmoid takes the fast exp and reciprocal (about 2 ulp of
// fp32, far below the bf16 rounding of what it feeds).
// Work split (kernels/fused_mlp/ops.py::bwd_plan picks it per launch from M, K,
// F and the SM count, and passes it as a bit mask): a launch either gives each
// block whole tiles (tile i to block i mod grid), or, when that would leave the
// last wave of tiles less than 85% full (dx and dh at llava_next_34b's M = 640:
// 140 and 400 tiles on 132 SMs), runs its full waves of whole tiles and splits
// the k-blocks of the tiles left over into one contiguous, equal range a block
// ("stream-K" for the last wave, with boundaries fixed by the shape and the
// grid). Splitting every tile's reduction instead set the blocks that share
// operands at different k offsets: dx at M = 640 took 1.24 ms against 0.79 with
// whole tiles on an H100, about what ~4 GB of operand reads from device memory
// would take (whole tiles, reading in step, need ~0.6 GB). The ranges go to
// blocks in the order the blocks start (a ticket from a counter), and a block
// walks its range backwards, so the piece that starts a tile is its first. A
// range starts inside a tile at most once, so a block holds at most one piece
// that stops short of its tile's end: that piece's fp32 accumulators go to the
// range's slot of a scratch and a flag says so. The piece that holds the tile's
// last k-block, which its block reaches at the end of its range, waits for the
// flags of the earlier pieces, adds their partials to its accumulators from
// the range before its own down to the tile's first, and runs the epilogue
// (dh's SwiGLU backward included), so the tile is rounded to bf16 once. A
// block waits only for ranges whose blocks took their tickets before it, so
// are running, and those finish their short pieces before they wait: the
// launch needs no dispatch order and no co-residency (other streams' kernels
// may hold SMs). Adding the partials to the registers the products left, in
// place, keeps the kernel free of spills: reloading the accumulators from the
// scratch, so that any block could finish a tile, spilled ~300 bytes a thread
// and cost dh and dx 6-9% at llava_next_34b's M = 640 on an H100.
// The flags and tickets are the only atomics, and they order waits, not sums:
// every output element is summed in an order the shape fixes, so two calls
// give the same bits. M may be any
// size >= 1: TMA zero-fills rows past M (so they add nothing to the M
// reductions) and rows past M are not stored; likewise an output tile's
// second half past the last column (F or K an odd number of 128s) is
// zero-filled and not stored. K and F are multiples of 128 (the wrapper
// pads the smoke configs' 64s with zeros).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TM = 128;                   // output rows per tile: 2 x 64
constexpr int HN = 128;                   // columns of one accumulator
constexpr int TK = BOX;                   // reduction depth per stage
constexpr int THREADS = 384;              // WG0, WG1 consume; WG2 produces
constexpr int OPERAND = TM * TK * 2;      // 16 KB: one operand tile a stage
constexpr int HALF_BOX = BOX * BOX * 2;   // 8 KB: a [64][64] box
constexpr int STAGE = 3 * OPERAND;        // A and the two B tiles: 48 KB
constexpr int EPI_SLOT = 2 * HALF_BOX;    // DH: [64 rows][64] of g and u
constexpr int DH_OUT = 3 * HALF_BOX;      // DH: boxes of h, dg, du
constexpr int GROUP = 16;                 // row tiles a group (tile_at)
// fp32 partial of one piece: both warpgroups' two 64 x 128 accumulators
constexpr int SLOT = 2 * 2 * (HN / 2) * 128;

enum Op { DH, DX, DW13, DW2 };

template <int OP>
struct Cfg {
  // DH and DX reduce along the rows of both operands (K-major, one
  // [128][64] box each); DW13 and DW2 reduce over M, down the columns of
  // both (MN-major, two [64 rows of M][64] boxes each)
  static constexpr bool KMAJOR = OP == DH || OP == DX;
  // output columns of a tile: DW13's two accumulators are two outputs
  static constexpr int TN = OP == DW13 ? HN : 2 * HN;
  // a consumer warpgroup's epilogue buffer: DH's g, u slot and h, dg, du
  // boxes; the others' two output boxes
  static constexpr int EPI = OP == DH ? EPI_SLOT + DH_OUT : 2 * HALF_BOX;
  static constexpr int STAGES = OP == DH ? 3 : 4;
  static constexpr int SMEM = STAGES * STAGE + 2 * EPI + 1024;  // + align
  static_assert(SMEM <= 232448, "fits one SM's shared memory");
};

// Tensor maps of one launch: (a0, b0) over the reduction, then (a1, b1)
// for DX's second segment; DW13's second B operand is b1; DH's g and u.
// The outputs, stored by TMA from [64][64] boxes: o0 (DH: h; DX: dx;
// DW13: dW1; DW2: dW2), o1 (DH: dg; DW13: dW3), o2 (DH: du).
struct Maps {
  CUtensorMap a0, b0, a1, b1, o0, o1, o2;
};

// Address of the bf16 pair at (row, col) (col even) of a [rows][64 cols]
// box as TMA lays it out with the 128-byte swizzle: 16-byte chunk j of
// row r sits at chunk j ^ (r % 8). A warp's fragment rows then fall on
// distinct banks.
__device__ __forceinline__ uint32_t* swizzled(uint8_t* box, int row,
                                              int col) {
  return reinterpret_cast<uint32_t*>(
      box + row * BOX_ROW_BYTES + ((((col * 2) >> 4) ^ (row & 7)) << 4) +
      (col * 2 & 15));
}

// Accumulator fragment columns [64 Q, 64 Q + 64) of `acc` in bf16 into a
// [64 rows][64] box; rt: the thread's first row in the warpgroup's 64.
template <int Q>
__device__ __forceinline__ void to_box(const float (&acc)[HN / 2],
                                       uint8_t* box, int rt, int lane) {
#pragma unroll
  for (int i = 0; i < BOX / 8; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int a = 4 * (BOX / 8 * Q + i) + 2 * hr;
      *swizzled(box, rt + 8 * hr, 8 * i + 2 * (lane % 4)) =
          pack_bf16(acc[a], acc[a + 1]);
    }
  }
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// mlp_bwd_dh's epilogue for 64 columns, accumulator fragment columns
// [64 Q, 64 Q + 64) of `acc`: h = silu(g) u,
// dg = dh u sig(g) (1 + g (1 - sig(g))), du = dh silu(g) from dh (fp32)
// and the slot's g and u boxes (the warpgroup's 64 rows), written in bf16
// to the warpgroup's h, dg and du boxes. rt: the thread's first row in the
// warpgroup's 64.
template <int Q>
__device__ __forceinline__ void swiglu_bwd(const float (&acc)[HN / 2],
                                           uint8_t* slot, uint8_t* out,
                                           int rt, int lane) {
#pragma unroll
  for (int i = 0; i < BOX / 8; ++i) {
    const int cl = 8 * i + 2 * (lane % 4);   // column in the box
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rt + 8 * hr;
      const float2 g = unpack(*swizzled(slot, r, cl));
      const float2 u = unpack(*swizzled(slot + HALF_BOX, r, cl));
      const int a = 4 * (BOX / 8 * Q + i) + 2 * hr;
      const float v0 = acc[a], v1 = acc[a + 1];
      const float s0 = __frcp_rn(1.f + __expf(-g.x));
      const float s1 = __frcp_rn(1.f + __expf(-g.y));
      const float sg0 = g.x * s0, sg1 = g.y * s1;   // silu(g)
      *swizzled(out, r, cl) = pack_bf16(sg0 * u.x, sg1 * u.y);
      *swizzled(out + HALF_BOX, r, cl) =
          pack_bf16(v0 * u.x * s0 * (1.f + g.x * (1.f - s0)),
                    v1 * u.y * s1 * (1.f + g.y * (1.f - s1)));
      *swizzled(out + 2 * HALF_BOX, r, cl) = pack_bf16(v0 * sg0, v1 * sg1);
    }
  }
}

// Row and column tile of the t-th tile: the row tiles are taken in groups
// of GROUP, and a group's tiles run down its rows column after column, so
// the 132 tiles in flight read the A strips of 16 row tiles and the B
// strips of ~8 column tiles. Walking all row tiles first (as the forward
// does) would read every A strip from device memory in each wave: all of
// dg and du for mlp_bwd_dx at olmo_1b's shape, 268 MB a wave.
__device__ __forceinline__ void tile_at(int t, int r_tiles, int c_tiles,
                                        int& r, int& c) {
  const int first = t / (GROUP * c_tiles) * GROUP;
  const int height = min(GROUP, r_tiles - first);
  const int rest = t - first * c_tiles;
  r = first + rest % height;
  c = rest / height;
}

// k-blocks [kb0, kb1) of output tile `tile`.
struct Piece {
  int tile, kb0, kb1;
};

// The pieces of this block, in order: whole tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... up to the last full wave of tiles (all
// tiles without stream-K), then, with stream-K, range `me` (the block's
// ticket) of the k-blocks of the tiles left over (tiles past the full
// waves x kblocks, cut in equal ranges of at least SK_MIN k-blocks), cut
// where tiles end and taken from its end back to its start. Blocks that
// share operands then read them in step: the whole tiles of a wave start
// together, and the leftover tiles are few.
constexpr int SK_MIN = 8;

template <bool SK>
struct Pieces;

template <>
struct Pieces<false> {
  int t, tiles, kblocks;
  __device__ Pieces(int n, int kb, int) : t(blockIdx.x), tiles(n),
                                          kblocks(kb) {}
  __device__ bool next(Piece& p) {
    if (t >= tiles) return false;
    p.tile = t;
    p.kb0 = 0;
    p.kb1 = kblocks;
    t += gridDim.x;
    return true;
  }
};

template <>
struct Pieces<true> {
  int t, whole, lo, hi, kblocks;
  __device__ Pieces(int tiles, int kb, int me) : kblocks(kb) {
    t = blockIdx.x;
    whole = tiles / gridDim.x * gridDim.x;
    lo = range_start(me, tiles, kb);
    hi = range_start(me + 1, tiles, kb);
  }
  // Ranges that share the leftover k-blocks.
  __device__ static int range_blocks(int tiles, int kb) {
    const int left = (tiles - tiles / gridDim.x * gridDim.x) * kb;
    const int b = left / SK_MIN;
    return b < 1 ? 1 : (b < static_cast<int>(gridDim.x) ? b : gridDim.x);
  }
  // Start of range b, in leftover k-blocks.
  __device__ static int range_start(int b, int tiles, int kb) {
    const int left = (tiles - tiles / gridDim.x * gridDim.x) * kb;
    const int n = range_blocks(tiles, kb);
    return b >= n ? left
                  : static_cast<int>(static_cast<long long>(left) * b / n);
  }
  // The range that holds the first k-block of leftover tile `rel`, found
  // from range `me`, which holds a later one.
  __device__ static int first_range(int me, int rel, int tiles, int kb) {
    int b = me;
    while (b > 0 && range_start(b, tiles, kb) > rel * kb) --b;
    return b;
  }
  __device__ bool next(Piece& p) {
    if (t < whole) {
      p.tile = t;
      p.kb0 = 0;
      p.kb1 = kblocks;
      t += gridDim.x;
      return true;
    }
    if (hi <= lo) return false;
    const int tile = (hi - 1) / kblocks, start = tile * kblocks;
    p.tile = whole + tile;
    p.kb0 = (lo > start ? lo : start) - start;
    p.kb1 = hi - start;
    hi = start + p.kb0;
    return true;
  }
};

__device__ __forceinline__ void flag_release(int* flag) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(flag), "r"(1)
               : "memory");
}

// Wait until another block has released `flag`; traps after 10 s, as
// mbar_wait does.
__device__ __forceinline__ void flag_acquire(const int* flag) {
  uint64_t t0 = 0;
  for (uint32_t tries = 1;; ++tries) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(flag)
                 : "memory");
    if (v != 0) return;
    if ((tries & 1023u) == 0) {
      const uint64_t now = globaltimer_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// This thread's accumulator fragments in a partial slot, laid out so that
// a warp's 32 threads touch 32 consecutive floats.
__device__ __forceinline__ float* slot_at(float* slot, int wg, int a, int i) {
  return slot + ((wg * 2 + a) * (HN / 2) + i) * 128 + threadIdx.x % 128;
}

// out[rows, cols] = sum over kblocks of A^T-or-A times B, one persistent
// block per SM. `seg` is the k-block where DX's reduction moves from
// (dg, W1) to (du, W3); the other ops pass kblocks. SK: stream-K for the
// last wave (the header), with `part` (a slot of SLOT floats a range) and
// `flags` (an int a range, then the ticket counter; zero at launch); a
// template argument, so that whole-tile launches carry none of its state.
template <int OP, bool SK>
__device__ __forceinline__ void gemm(const Maps& maps, int rows, int cols,
                                     int kblocks, int seg, float* part,
                                     int* flags) {
  using C = Cfg<OP>;
  __shared__ __align__(8) uint64_t full[C::STAGES];
  __shared__ __align__(8) uint64_t empty[C::STAGES];
  __shared__ __align__(8) uint64_t epi_full[2];   // DH's g, u slots
  __shared__ __align__(8) uint64_t epi_empty[2];
  __shared__ int ticket;       // SK: this block's range
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* epi = smem + C::STAGES * STAGE;   // the warpgroups' C::EPI

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&epi_full[s], 1);
      mbar_init(&epi_empty[s], 4);  // lane 0 of the owner's warps
    }
    mbar_fence_init();
    if constexpr (SK) ticket = atomicAdd(flags + gridDim.x, 1);
  }
  __syncthreads();
  const int me = SK ? ticket : 0;

  const int r_tiles = (rows + TM - 1) / TM;
  const int c_tiles = (cols + C::TN - 1) / C::TN;
  const int tiles = r_tiles * c_tiles;

  if (wg == 2) {
    // producer: one thread issues every TMA load
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      Ring<C::STAGES> ring;
      Pieces<SK> pieces(tiles, kblocks, me);
      for (Piece pc; pieces.next(pc);) {
        int r0, c0;
        tile_at(pc.tile, r_tiles, c_tiles, r0, c0);
        r0 *= TM;
        c0 *= C::TN;
        for (int kb = pc.kb0; kb < pc.kb1; ++kb) {
          mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
          uint8_t* st = smem + ring.stage * STAGE;
          uint64_t* bar = &full[ring.stage];
          mbar_expect_tx(bar, STAGE);
          if constexpr (C::KMAJOR) {
            const bool second = kb >= seg;
            const int k = (second ? kb - seg : kb) * TK;
            const CUtensorMap* b = second ? &maps.b1 : &maps.b0;
            tma_load_2d(st, second ? &maps.a1 : &maps.a0, bar, k, r0);
            tma_load_2d(st + OPERAND, b, bar, k, c0);
            tma_load_2d(st + 2 * OPERAND, b, bar, k, c0 + HN);
          } else {
            // DW13: the second B is du at the same columns; DW2: the next
            // 128 columns of dy
            const CUtensorMap* b1 = OP == DW13 ? &maps.b1 : &maps.b0;
            const int c1 = OP == DW13 ? c0 : c0 + HN;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              tma_load_2d(st + j * HALF_BOX, &maps.a0, bar, r0 + j * BOX,
                          kb * TK);
              tma_load_2d(st + OPERAND + j * HALF_BOX, &maps.b0, bar,
                          c0 + j * BOX, kb * TK);
              tma_load_2d(st + 2 * OPERAND + j * HALF_BOX, b1, bar,
                          c1 + j * BOX, kb * TK);
            }
          }
          ring.advance();
        }
        if constexpr (OP == DH) {
          // g and u of the tile, for the piece that runs its epilogue (the
          // one that holds its last k-block): for each 64 columns q,
          // warpgroup w's 64 rows into its slot; a slot is used four times
          // a tile, so use q waits for parity q % 2
          for (int n = 0; n < 8 && pc.kb1 == kblocks; ++n) {
            const int w = n % 2, q = n / 2;
            mbar_wait(&epi_empty[w], (q & 1) ^ 1u);
            uint8_t* slot = epi + w * C::EPI;
            mbar_expect_tx(&epi_full[w], EPI_SLOT);
            const int c = c0 + q * BOX, r = r0 + w * 64;
            tma_load_2d(slot, &maps.a1, &epi_full[w], c, r);
            tma_load_2d(slot + HALF_BOX, &maps.b1, &epi_full[w], c, r);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    regs_alloc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc0[HN / 2], acc1[HN / 2];
    Ring<C::STAGES> ring;
    Pieces<SK> pieces(tiles, kblocks, me);
    for (Piece pc; pieces.next(pc);) {
      int r0, c0;
      tile_at(pc.tile, r_tiles, c_tiles, r0, c0);
      r0 *= TM;
      c0 *= C::TN;
#pragma unroll
      for (int i = 0; i < HN / 2; ++i) acc0[i] = acc1[i] = 0.f;
      int prev = -1;
      for (int kb = pc.kb0; kb < pc.kb1; ++kb) {
        mbar_wait(&full[ring.stage], ring.phase);
        const uint8_t* st = smem + ring.stage * STAGE;
        fence_regs(acc0);
        fence_regs(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          if constexpr (C::KMAJOR) {
            const uint64_t da =
                desc_kmajor(st + wg * 64 * BOX_ROW_BYTES, kk, OPERAND);
            Wgmma<HN, 0, 0>::ss(acc0, da,
                                desc_kmajor(st + OPERAND, kk, OPERAND), 1);
            Wgmma<HN, 0, 0>::ss(acc1, da,
                                desc_kmajor(st + 2 * OPERAND, kk, OPERAND), 1);
          } else {
            const uint64_t da = desc_mnmajor(st + wg * HALF_BOX, kk, HALF_BOX);
            Wgmma<HN, 1, 1>::ss(acc0, da,
                                desc_mnmajor(st + OPERAND, kk, HALF_BOX), 1);
            Wgmma<HN, 1, 1>::ss(
                acc1, da, desc_mnmajor(st + 2 * OPERAND, kk, HALF_BOX), 1);
          }
        }
        wgmma_commit();
        fence_regs(acc0);
        fence_regs(acc1);
        // the previous k-block's products are done: release its stage
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = ring.stage;
        ring.advance();
      }
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      const bool leader = threadIdx.x % 128 == 0;
      if (SK && pc.kb1 < kblocks) {
        // a piece short of its tile's end: the partial to this range's
        // slot, and its flag says so
        float* slot = part + static_cast<long long>(me) * SLOT;
#pragma unroll
        for (int i = 0; i < HN / 2; ++i) {
          *slot_at(slot, wg, 0, i) = acc0[i];
          *slot_at(slot, wg, 1, i) = acc1[i];
        }
        __threadfence();
        named_sync(3, 256);
        if (threadIdx.x == 0) flag_release(flags + me);
        continue;
      }
      if (SK && pc.kb0 > 0) {
        // the tile's last piece: the earlier pieces' partials, from the
        // range before this one down to the tile's first (their blocks
        // took their tickets before this one, so are running)
        const int first = Pieces<true>::first_range(
            me, pc.tile - tiles / gridDim.x * gridDim.x, tiles, kblocks);
        for (int b = me - 1; b >= first; --b) {
          if (leader) flag_acquire(flags + b);
          named_sync(1 + wg, 128);
          const float* slot = part + static_cast<long long>(b) * SLOT;
#pragma unroll
          for (int i = 0; i < HN / 2; ++i) {
            acc0[i] += __ldcg(slot_at(const_cast<float*>(slot), wg, 0, i));
            acc1[i] += __ldcg(slot_at(const_cast<float*>(slot), wg, 1, i));
          }
        }
      }

      // epilogue: 64 columns at a time through the warpgroup's shared
      // boxes and TMA stores, which drain while the next tile's products
      // run (rows past M and columns past the last are not stored); one
      // thread of the warpgroup issues the stores, after the warpgroup's
      // writes are fenced to the async proxy, and waits until a box's
      // last store has read it before it is written again
      uint8_t* buf = epi + wg * C::EPI;
      const int rt = warp * 16 + lane / 4, rw = r0 + wg * 64;
      if constexpr (OP == DH) {
        // g and u from the warpgroup's slot, h, dg and du into its boxes
        uint8_t* out = buf + EPI_SLOT;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          mbar_wait(&epi_full[wg], q & 1);
          if (leader) bulk_wait_read<0>();
          named_sync(1 + wg, 128);
          if (q == 0) swiglu_bwd<0>(acc0, buf, out, rt, lane);
          if (q == 1) swiglu_bwd<1>(acc0, buf, out, rt, lane);
          if (q == 2) swiglu_bwd<0>(acc1, buf, out, rt, lane);
          if (q == 3) swiglu_bwd<1>(acc1, buf, out, rt, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(&epi_empty[wg]);
          fence_proxy_async();
          named_sync(1 + wg, 128);
          const int c = c0 + q * BOX;
          if (leader && c < cols) {
            tma_store_2d(&maps.o0, out, c, rw);
            tma_store_2d(&maps.o1, out + HALF_BOX, c, rw);
            tma_store_2d(&maps.o2, out + 2 * HALF_BOX, c, rw);
            bulk_commit();
          }
        }
      } else if constexpr (OP == DW13) {
        // dW1 and dW3 at the same 64 columns, one box each
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (leader) bulk_wait_read<0>();
          named_sync(1 + wg, 128);
          if (q == 0) {
            to_box<0>(acc0, buf, rt, lane);
            to_box<0>(acc1, buf + HALF_BOX, rt, lane);
          } else {
            to_box<1>(acc0, buf, rt, lane);
            to_box<1>(acc1, buf + HALF_BOX, rt, lane);
          }
          fence_proxy_async();
          named_sync(1 + wg, 128);
          if (leader) {
            tma_store_2d(&maps.o0, buf, c0 + q * BOX, rw);
            tma_store_2d(&maps.o1, buf + HALF_BOX, c0 + q * BOX, rw);
            bulk_commit();
          }
        }
      } else {
        // the 256 columns of one output, the two boxes in turn: a box is
        // written again two groups later (every quarter commits one)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint8_t* box = buf + (q % 2) * HALF_BOX;
          if (leader) bulk_wait_read<1>();
          named_sync(1 + wg, 128);
          if (q == 0) to_box<0>(acc0, box, rt, lane);
          if (q == 1) to_box<1>(acc0, box, rt, lane);
          if (q == 2) to_box<0>(acc1, box, rt, lane);
          if (q == 3) to_box<1>(acc1, box, rt, lane);
          fence_proxy_async();
          named_sync(1 + wg, 128);
          if (leader) {
            if (c0 + q * BOX < cols)
              tma_store_2d(&maps.o0, box, c0 + q * BOX, rw);
            bulk_commit();
          }
        }
      }
    }
    bulk_wait<0>();   // the stores have landed
  }
}

// One named kernel per product, so that a profile tells them apart.
template <bool SK>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_dh(const __grid_constant__ Maps maps, int rows, int cols,
           int kblocks, float* part, int* flags) {
  gemm<DH, SK>(maps, rows, cols, kblocks, kblocks, part, flags);
}

template <bool SK>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_dx(const __grid_constant__ Maps maps, int rows, int cols,
           int kblocks, float* part, int* flags) {
  gemm<DX, SK>(maps, rows, cols, kblocks, kblocks / 2, part, flags);
}

template <bool SK>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_dw13(const __grid_constant__ Maps maps, int rows, int cols,
             int kblocks, float* part, int* flags) {
  gemm<DW13, SK>(maps, rows, cols, kblocks, kblocks, part, flags);
}

template <bool SK>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_dw2(const __grid_constant__ Maps maps, int rows, int cols,
            int kblocks, float* part, int* flags) {
  gemm<DW2, SK>(maps, rows, cols, kblocks, kblocks, part, flags);
}

using Kernel = void(Maps, int, int, int, float*, int*);

// Whole tiles: a grid of min(tiles, sms). Stream-K: min(tiles x kblocks,
// sms) blocks, with the ranges' flags and the ticket counter zeroed
// first.
template <int OP>
cudaError_t launch(Kernel* whole, Kernel* split,
                   unsigned long long (&devices)[2], Maps maps, int rows,
                   int cols, int kblocks, int sk, float* part, int* flags,
                   int sms, cudaStream_t s) {
  Kernel* kernel = sk ? split : whole;
  cudaError_t err = allow_smem(kernel, Cfg<OP>::SMEM, devices[sk ? 1 : 0]);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((rows + TM - 1) / TM) *
      ((cols + Cfg<OP>::TN - 1) / Cfg<OP>::TN);
  const long long work = sk ? tiles * kblocks : tiles;
  const int grid = static_cast<int>(work < sms ? work : sms);
  if (sk) {
    err = cudaMemsetAsync(flags, 0, (grid + 1) * sizeof(int), s);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&maps, &rows, &cols, &kblocks, &part, &flags};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                          dim3(THREADS), args, Cfg<OP>::SMEM, s);
}

}  // namespace

extern "C" {

// Floats of fp32 partials fused_mlp_bwd_bf16 needs for `sms` blocks.
long long fused_mlp_bwd_partial_floats(int sms) {
  return static_cast<long long>(sms) * SLOT;
}

// Gradients of the fused MLP. x [M, K], w1/w3 [K, F], w2 [F, K], dy
// [M, K], g/u [M, F] (the forward's saved x W1 and x W3); scratch h, dg,
// du [M, F]; outputs dx [M, K], dw1/dw3 [K, F], dw2 [F, K]. All bf16,
// contiguous, 16-byte aligned; K % 128 == 0, F % 128 == 0, M >= 1.
// split: bit i set runs launch i (dh, dw2, dx, dw13) stream-K; then part
// holds fused_mlp_bwd_partial_floats(sms) fp32 and flags `sms + 1` ints
// (null when split is 0). Issues four launches on `stream`, each a persistent
// grid of at most `sms` blocks, and returns the first non-zero CUDA error
// (0 on success), or cudaErrorInvalidValue for shapes it does not take.
int fused_mlp_bwd_bf16(const void* x, const void* w1, const void* w3,
                       const void* w2, const void* dy, const void* g,
                       const void* u, void* h, void* dg, void* du, void* dx,
                       void* dw1, void* dw3, void* dw2, void* part,
                       void* flags, int M, int K, int F, int split, int sms,
                       void* stream) {
  if (M < 1 || K % 128 != 0 || F % 128 != 0 || K < 128 || F < 128 ||
      sms < 1 || (split != 0 && (part == nullptr || flags == nullptr)))
    return cudaErrorInvalidValue;
  float* pp = static_cast<float*>(part);
  int* fp = static_cast<int*>(flags);
  // cuTensorMapEncodeTiled needs a current context, which the thread
  // autograd runs a backward on may not have yet
  cudaError_t err = bind_device_of(x);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_kblocks = (M + TK - 1) / TK;
  static unsigned long long dev_dh[2] = {}, dev_dx[2] = {},
                            dev_dw13[2] = {}, dev_dw2[2] = {};

  // dh = dy W2^T, epilogue h, dg, du: [M, F] over K
  Maps m = {};
  if (!make_tmap_2d(&m.a0, dy, M, K, K, TM) ||
      !make_tmap_2d(&m.b0, w2, F, K, K, HN) ||
      !make_tmap_2d(&m.a1, g, M, F, F, BOX) ||
      !make_tmap_2d(&m.b1, u, M, F, F, BOX) ||
      !make_tmap_2d(&m.o0, h, M, F, F, BOX) ||
      !make_tmap_2d(&m.o1, dg, M, F, F, BOX) ||
      !make_tmap_2d(&m.o2, du, M, F, F, BOX))
    return cudaErrorInvalidValue;
  err = launch<DH>(mlp_bwd_dh<false>, mlp_bwd_dh<true>, dev_dh, m, M, F,
                   K / TK, split & 1, pp, fp, sms, s);
  if (err != cudaSuccess) return err;

  // dW2 = h^T dy: [F, K] over M
  m = {};
  if (!make_tmap_2d(&m.a0, h, M, F, F, BOX) ||
      !make_tmap_2d(&m.b0, dy, M, K, K, BOX) ||
      !make_tmap_2d(&m.o0, dw2, F, K, K, BOX))
    return cudaErrorInvalidValue;
  err = launch<DW2>(mlp_bwd_dw2<false>, mlp_bwd_dw2<true>, dev_dw2, m, F, K,
                    m_kblocks, (split >> 1) & 1, pp, fp, sms, s);
  if (err != cudaSuccess) return err;

  // dx = dg W1^T + du W3^T: [M, K] over 2F
  m = {};
  if (!make_tmap_2d(&m.a0, dg, M, F, F, TM) ||
      !make_tmap_2d(&m.b0, w1, K, F, F, HN) ||
      !make_tmap_2d(&m.a1, du, M, F, F, TM) ||
      !make_tmap_2d(&m.b1, w3, K, F, F, HN) ||
      !make_tmap_2d(&m.o0, dx, M, K, K, BOX))
    return cudaErrorInvalidValue;
  err = launch<DX>(mlp_bwd_dx<false>, mlp_bwd_dx<true>, dev_dx, m, M, K,
                   2 * (F / TK), (split >> 2) & 1, pp, fp, sms, s);
  if (err != cudaSuccess) return err;

  // dW1 = x^T dg, dW3 = x^T du: [K, F] over M
  m = {};
  if (!make_tmap_2d(&m.a0, x, M, K, K, BOX) ||
      !make_tmap_2d(&m.b0, dg, M, F, F, BOX) ||
      !make_tmap_2d(&m.b1, du, M, F, F, BOX) ||
      !make_tmap_2d(&m.o0, dw1, K, F, F, BOX) ||
      !make_tmap_2d(&m.o1, dw3, K, F, F, BOX))
    return cudaErrorInvalidValue;
  return launch<DW13>(mlp_bwd_dw13<false>, mlp_bwd_dw13<true>, dev_dw13, m,
                      K, F, m_kblocks, (split >> 3) & 1, pp, fp, sms, s);
}

const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
