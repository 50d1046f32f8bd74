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
// and keys past the end at -inf.
//
// What bounds it on an H100: five products over the kept (query, key)
// pairs (S, dP, dV, dK, dQ). At olmo_1b's train shape (B = 4, S = 2048,
// H = 16, hd = 128, causal) that is ~172 GFLOP against ~235 MB of q, k,
// v, dO and the three gradients: the tensor cores bound it (0.17 ms at
// 989 TFLOP/s; the bytes take 0.07 ms). Summing dQ across key tiles adds
// fp32 traffic at L2: one 64 x hd partial per (query tile, key tile)
// pair, 570 MB at olmo_1b.
//
// Three launches a call:
//   flash_bwd_delta: D = rowsum(dO o O) per query row, copied with the
//     forward's lse into [B, H, nq * tq] rows padded to the query tile
//     (lse = +inf, D = 0 past Sq, so the main kernel's bulk loads of a
//     tile's values stay aligned and rows past the end get P = 0); it
//     also zeroes the dQ semaphores and the ticket counter.
//   flash_bwd_main: the five products, each once (S and dP are not
//     recomputed for dQ). One work item is (batch, KV head, 128-key
//     tile); a block is two warpgroups of 64 keys each, persistent, one
//     a SM. K and V are loaded once an item; the item walks the query
//     tiles (tq = 64 rows, 128 at hd 64) that reach its keys and the G
//     query heads of its group inside each, Q, dO and their lse and D
//     streaming through a TMA / bulk-copy ring completed on mbarriers.
//     For each (query tile, head), a step:
//       S^T = K Q^T and dP^T = V dO^T (shared-memory operands) are issued
//       together and the exp of S^T into P^T runs while dP^T is still on
//       the tensor cores; then dS^T = P^T (dP^T - D), and dV += P^T dO
//       and dK += dS^T Q with P^T and dS^T as bf16 register A operands;
//       dS^T goes to shared memory as bf16, once, while they run, and
//       dQ_partial = dS K reads it (an MN-major A operand), split across
//       the two warpgroups so that each holds a 64 x 64 fp32 block (32
//       registers): the head-dim halves above hd 64, the query halves at
//       hd 64.
//     Registers at hd 128: dK and dV 128, S^T and dP^T 64, dQ 32. ptxas
//     caps a block of more than 8 warps at 168 registers a thread (warps
//     are allocated four at a time, and it does not raise the cap for
//     code after setmaxnreg), so there is no producer warpgroup: the
//     block is 256 threads (255 registers), its thread 0 issues the
//     loads and thread WRITER the dQ adds, each at a point where the two
//     barriers of a step have ordered what it needs. dK and dV leave once
//     an item through shared memory (the K and V tiles' space) and TMA
//     stores. With GQA and fewer (batch, KV head, key tile) items than
//     SMs (llava_next_34b: 40), an item takes one query head instead and
//     writes its dK and dV as fp32 partials.
//   flash_bwd_convert: dq = bf16(dq_acc * scale) into the caller's
//     strides; for split items also dk, dv: the partials summed over the
//     group's heads in head order.
//
// dQ is summed across key tiles deterministically. WRITER writes each
// (batch, head, query tile)'s partials into an fp32 scratch dq_acc by
// bulk copies from shared memory: the first key tile in the tile's order
// stores, the others add (cp.reduce.async.bulk .add.f32) only when the
// tile's int semaphore in global memory says the ones before them have,
// and count their own a step later, after the add has landed. The order
// is fixed by the shape (Item::turn), not by timing. Work items come from
// a global ticket counter in a persistent grid, and an item only ever
// waits on an item with a lower ticket, which a running block holds or
// has finished, so the kernel cannot deadlock whatever order the blocks
// are dispatched in. A block takes its next ticket a few steps before it
// can start it (a ticket held while its block finishes a long item would
// keep the items that wait on it waiting). Two orders (Item), chosen by
// the host from the shape: diagonal first for causal shapes whose
// longest item is short against a block's share (olmo_1b), where every
// add finds its turn already come and its tile in L2; else key tile 0
// first (whisper_base, granite_moe_1b_a400m, llava_next_34b).
// dq_acc keeps the accumulator fragments in their register order (a
// 64 x 64 block is [8][128 threads][4]), so the shared-memory writes and
// the bulk copies are contiguous; the convert pass stages a tile in
// shared memory and writes whole rows.
//
// Measured (scripts/profile_flash_attn_bwd.py, device time of the three
// launches, and chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): PERF.md
// section 6. Design steps, each timed against the one before on the card:
// a producer warpgroup with setmaxnreg spilled (the cap above); the two
// warpgroups run in lock step (a step's two barriers), and letting them
// drift half a step apart with mbarrier hand-offs and a lagged dQ was
// slower; at olmo_1b the dQ adds cost ~0.1 ms of L2 traffic and the
// semaphore waits ~0.05 ms until the diagonal order made both small
// (the main kernel's device time as that script measures it, on drafts
// with the waits or the adds taken out).
//
// Layout: q, o, dO, dq [B, Sq, H, hd], k, v, dk, dv [B, Skv, KV, hd] by
// element strides (multiples of 8, unit stride on hd), so the model layout
// and the Pallas layout [BH, S, hd] (as B = 1, H = BH) run without a copy;
// lse is fp32 [B, H, Sq]. Lengths need not divide the tiles: TMA
// zero-fills rows past the end, keys past the end are -inf, and rows past
// the end are not stored (the TMA stores clip them).

#include <math.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int TN = 128;                 // keys of a work item
constexpr int THREADS = 256;            // two warpgroups
constexpr int WRITER = 128;             // the thread that adds dQ partials
constexpr int RING = 8;                 // item ids announced ahead
constexpr int DELTA_THREADS = 256;      // 16 groups of 4 rows a block
constexpr int ROW_THREADS = 16;         // a row of hd <= 128: 16 x 8 values
constexpr int GROUP_ROWS = 4;           // heads a delta thread group sums
constexpr int CONVERT_THREADS = 256;
constexpr int REDUCE_PARTS = 8;         // blocks a split dK, dV tile
constexpr int FRAG = 4096;              // floats of a 64 x 64 fp32 fragment
constexpr int TILE_FLOATS = 2 * FRAG;   // a dQ tile: 64 x 128 or 128 x 64
constexpr float MASK_VALUE = -1e30f;    // the forward's masked score
constexpr float LOG2E = 1.4426950408889634f;

// Query rows of a step: 128 at hd 64, where a step's products are half
// as deep and 64 rows would leave the softmax and the two barriers of a
// step a larger share; 64 above. Either way a step's dQ partial is two
// 64 x 64 fp32 blocks, one a warpgroup (the two query halves at hd 64,
// the two head-dim halves above).
__host__ __device__ constexpr int query_rows(int hd) {
  return hd <= BOX ? 2 * BOX : BOX;
}

template <int HD>
struct Cfg {
  static constexpr int TQ = query_rows(HD);
  static constexpr int NBOX = (HD + BOX - 1) / BOX;   // 64-wide boxes
  static constexpr int KSTEPS = HD / 16;              // k steps over hd
  static constexpr int Q_BOX = TQ * BOX_ROW_BYTES;    // [TQ rows][64]
  static constexpr int KV_BOX = TN * BOX_ROW_BYTES;   // [128 rows][64]
  static constexpr int Q_TILE = NBOX * Q_BOX;
  static constexpr int KV_TILE = NBOX * KV_BOX;
  static constexpr int STAGES = 2;
  static constexpr int STAGE = 2 * Q_TILE;            // Q, dO
  // dS^T [128 keys][TQ queries] bf16, [128][64] boxes
  static constexpr int DS_BUF = TQ / BOX * KV_BOX;
  static constexpr int SMEM = 2 * KV_TILE + STAGES * STAGE + DS_BUF +
                              2 * TILE_FLOATS * 4 + STAGES * 2 * TQ * 4 +
                              1024;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  static_assert(TQ / BOX * NBOX == 2, "a dQ tile is two 64 x 64 blocks");
  static_assert(SMEM + 256 <= 232448, "fits one SM's shared memory");
};

struct Strides {
  long long b, s, h;                    // element strides of [B, S, H, hd]
};

// Scratch of one call, carved from the caller's workspace.
struct Work {
  float* dq_acc;   // [B, H, nq][TILE_FLOATS] fp32, fragment order
  float* dkv;      // split: [B, H, nt][2][128 keys x hd] fp32, fragment
                   // order, each item's dK (unscaled) and dV
  float* lse;      // [B, H, nq * TQ] the forward's lse, +inf past sq
  float* delta;    // [B, H, nq * TQ] rowsum(dO o O), 0 past sq
  int* sem;        // [B, H, nq] adds done per query tile, then the ticket
};

// The sizes every role of the main kernel decodes its work from. `diag`
// picks the order of the work (Item).
struct Shape {
  int B, H, KV, G, tq, nq, nt, q_offset, causal, diag;
  int split;    // an item takes one query head (gh 1), not a KV group
  int gh;       // query heads an item walks: 1 or G
  int groups;   // (batch, KV head) or, split, (batch, query head) pairs
};

// A work item: (batch, KV head, key tile n) and its steps over the query
// tiles that reach its keys, the G heads of the group inside each; or,
// split, (batch, query head, key tile n), one head, its dK and dV a
// partial that the convert pass sums over the group's heads. Two
// orders, each with the dQ adds into a query tile in an order fixed by
// the shape in which an item waits only on items with lower tickets:
//   diag (causal only): the key tiles of a (batch, KV head) group take
//     consecutive tickets, last key tile first, and walk the query tiles
//     up from the diagonal; the last key tile that reaches a query tile
//     adds first. Each key tile then reaches every query tile of its walk
//     two steps before the key tile below it, so the adds come in the
//     order the items arrive and land while the tile is in L2; but each
//     group's longest item comes last.
//   otherwise: tickets key tile major, the query tiles walked from the
//     last one down, key tile 0 adds first; items of one group that run
//     together reach a query tile in turn, one add apart.
struct Item {
  int b = 0, kvh = 0, h0 = 0, n = 0, qt0 = 0, steps = 0;
  Item() = default;
  __device__ Item(int t, const Shape& s) {
    int g;
    if (s.diag) {
      g = t / s.nt;
      n = s.nt - 1 - t % s.nt;
    } else {
      g = t % s.groups;
      n = t / s.groups;
    }
    if (s.split) {
      b = g / s.H;
      h0 = g % s.H;
      kvh = h0 / s.G;
    } else {
      b = g / s.KV;
      kvh = g % s.KV;
      h0 = kvh * s.G;
    }
    // query rows i reach key n * TN when i + q_offset >= n * TN (causal)
    qt0 = s.causal ? max(0, n * TN - s.q_offset) / s.tq : 0;
    steps = (s.nq - qt0) * s.gh;
  }
  // The query tile and head of step j.
  __device__ int qt(int j, const Shape& s) const {
    return s.diag ? qt0 + j / s.gh : s.nq - 1 - j / s.gh;
  }
  __device__ int head(int j, const Shape& s) const { return h0 + j % s.gh; }
  // This item's place in the order of the adds into query tile qt.
  __device__ int turn(int qt, const Shape& s) const {
    if (!s.diag) return n;
    return min(s.nt - 1, (qt * s.tq + s.tq - 1 + s.q_offset) / TN) - n;
  }
};

// Address of the bf16 pair at (row, col) (col even) of a [rows][64 cols]
// box as TMA lays it out with the 128-byte swizzle: 16-byte chunk j of
// row r sits at chunk j ^ (r % 8).
__device__ __forceinline__ uint32_t* swizzled(uint8_t* box, int row,
                                              int col) {
  return reinterpret_cast<uint32_t*>(
      box + row * BOX_ROW_BYTES + ((((col * 2) >> 4) ^ (row & 7)) << 4) +
      (col * 2 & 15));
}

// 2^x in one MUFU instruction (subnormal results flush to zero).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Orders this thread's async-proxy (bulk copy) accesses of device memory
// with its generic ones.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Wait until *sem == want. Ten seconds can only be a scheduling fault: it
// traps, so the launch fails instead of hanging the device.
__device__ __forceinline__ void wait_turn(const int* sem, int want) {
  uint32_t tries = 0;
  uint64_t t0 = 0;
  while (ld_acquire(sem) != want) {
    if ((++tries & 1023u) == 0) {
      const uint64_t now = globaltimer_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// Two bf16 pairs' dot product, packed as the 32-bit words of a 16-byte load.
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// D and the padded lse: rows (b, i, h) in the order o and dO keep them,
// so that a warp reads 2 KB of each contiguously (the outputs, a 16th of
// the bytes, are the scattered ones), four heads of a token to 16
// threads, 8 values of hd a thread and head, all loads issued before the
// sums; the outputs are [B, H, rows_per_head] rows padded to the query
// tile, rows past sq with lse = +inf, D = 0. D is summed in a fixed
// order (each thread's 8, then a shuffle tree). The first `n_sem`
// threads zero the semaphores and the ticket counter.
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, Work w, int H, int sq,
                int rows_per_head, int hd, Strides os, Strides ds,
                long long groups, int n_sem) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * DELTA_THREADS + threadIdx.x;
  if (gid < n_sem) w.sem[gid] = 0;
  const long long g = gid / ROW_THREADS;  // (b, i, heads h0 .. h0 + 3)
  if (g >= groups) return;                // a whole group's threads
  const int sub = threadIdx.x % ROW_THREADS;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  const int hg = (H + GROUP_ROWS - 1) / GROUP_ROWS;
  const int h0 = static_cast<int>(g % hg) * GROUP_ROWS;
  const long long bi = g / hg;
  const int i = static_cast<int>(bi % rows_per_head);
  const int b = static_cast<int>(bi / rows_per_head);
  uint4 a[GROUP_ROWS], d[GROUP_ROWS];
#pragma unroll
  for (int u = 0; u < GROUP_ROWS; ++u) {
    a[u] = d[u] = make_uint4(0, 0, 0, 0);
    if (i < sq && h0 + u < H && 8 * sub < hd) {
      a[u] = *reinterpret_cast<const uint4*>(o + b * os.b + i * os.s +
                                             (h0 + u) * os.h + 8 * sub);
      d[u] = *reinterpret_cast<const uint4*>(dout + b * ds.b + i * ds.s +
                                             (h0 + u) * ds.h + 8 * sub);
    }
  }
  float acc[GROUP_ROWS];
#pragma unroll
  for (int u = 0; u < GROUP_ROWS; ++u) {
    acc[u] = (dot2(a[u].x, d[u].x) + dot2(a[u].y, d[u].y)) +
             (dot2(a[u].z, d[u].z) + dot2(a[u].w, d[u].w));
#pragma unroll
    for (int off = ROW_THREADS / 2; off > 0; off >>= 1)
      acc[u] += __shfl_xor_sync(mask, acc[u], off);
  }
  if (sub < GROUP_ROWS && h0 + sub < H) {  // one row's outputs a thread
    float v = acc[0];
#pragma unroll
    for (int u = 1; u < GROUP_ROWS; ++u) v = sub == u ? acc[u] : v;
    const long long bh = static_cast<long long>(b) * H + h0 + sub;
    const bool in = i < sq;
    w.delta[bh * rows_per_head + i] = in ? v : 0.f;
    w.lse[bh * rows_per_head + i] = in ? lse[bh * sq + i] : INFINITY;
  }
}

struct Maps {
  CUtensorMap q, k, v, dout, dk, dv;
};

// The sequence of loads of one block, issued by its thread 0: each item's
// id is announced in the `items` ring (item_full), and each step's Q, dO,
// lse and D go to the next ring stage, which the caller knows to be free.
// The next ticket is taken when the current item's last step is loaded,
// a few steps before the block can start it (its latency hidden by those
// steps): a ticket held longer would keep the items that wait on it
// waiting.
template <int HD>
struct Loader {
  using C = Cfg<HD>;
  const Maps& maps;
  const Work& w;
  int* ticket;
  uint8_t* ring;
  float* stats;
  uint64_t* full;
  uint64_t* item_full;
  int* items;
  Shape shp;
  int n_items;
  int next = -1;                // the ticket taken for the next item
  int k = -1;                   // items announced so far, minus one
  Item it{};
  int j = 0;
  bool done = false;
  Ring<C::STAGES> rs;

  // The next step's loads, after announcing a new item if the current
  // one is used up; false once no step is left.
  __device__ bool advance() {
    while (j >= it.steps) {
      if (done) return false;
      const int t = next >= 0 ? next : atomicAdd(ticket, 1);
      next = -1;
      ++k;
      const int item = t < n_items ? t : -1;
      items[k % RING] = item;
      mbar_arrive(&item_full[k % RING]);
      if (item < 0) {
        done = true;
        return false;
      }
      it = Item(item, shp);
      j = 0;
    }
    const int b = it.b, qt = it.qt(j, shp), h = it.head(j, shp);
    uint8_t* st = ring + rs.stage * C::STAGE;
    uint64_t* bar = &full[rs.stage];
    constexpr int TQ = C::TQ;
    mbar_expect_tx(bar, C::STAGE + 2 * TQ * 4);
#pragma unroll
    for (int x = 0; x < C::NBOX; ++x) {
      tma_load_4d(st + x * C::Q_BOX, &maps.q, bar, x * BOX, h, qt * TQ, b);
      tma_load_4d(st + C::Q_TILE + x * C::Q_BOX, &maps.dout, bar, x * BOX, h,
                  qt * TQ, b);
    }
    const long long at =
        ((static_cast<long long>(b) * shp.H + h) * shp.nq + qt) * TQ;
    float* sv = stats + rs.stage * 2 * TQ;
    bulk_load(sv, w.lse + at, TQ * 4, bar);
    bulk_load(sv + TQ, w.delta + at, TQ * 4, bar);
    if (++j == it.steps) next = atomicAdd(ticket, 1);
    rs.advance();
    return true;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_main(const __grid_constant__ Maps maps, Work w, int B, int H,
               int KV, int sq, int skv, int causal, int diag, int split,
               float scale_log2, float scale) {
  using C = Cfg<HD>;
  constexpr int S = C::STAGES, TQ = C::TQ;
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t item_full[RING];
  __shared__ int items[RING];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + C::KV_TILE;
  uint8_t* ring = vs + C::KV_TILE;        // stage s: Q tile, dO tile
  uint8_t* dss = ring + S * C::STAGE;     // dS^T of the step
  float* dqs = reinterpret_cast<float*>(dss + C::DS_BUF);  // two dQ tiles
  float* stats = dqs + 2 * TILE_FLOATS;   // stage s: lse[TQ], D[TQ]

  const int G = H / KV;
  const int nq = (sq + TQ - 1) / TQ;
  const int q_offset = skv - sq;
  const Shape shp{B,      H,     KV, G, TQ, nq, (skv + TN - 1) / TN,
                  q_offset, causal, diag, split, split ? 1 : G,
                  B * (split ? H : KV)};
  const int n_items = shp.groups * shp.nt;
  int* ticket = w.sem + static_cast<long long>(B) * H * nq;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < RING; ++s) mbar_init(&item_full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // warpgroup wg owns keys [64 wg, 64 wg + 64) of the item; thread 0 also
  // issues every load, thread WRITER every dQ add
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int rt = 16 * warp + lane / 4;    // (+ 8) this thread's keys
  const uint8_t* ka = ks + wg * 64 * BOX_ROW_BYTES;   // this WG's K rows
  const uint8_t* va = vs + wg * 64 * BOX_ROW_BYTES;
  Loader<HD> ld{maps, w, ticket, ring, stats, full, item_full, items, shp,
                n_items};
  auto load_kv = [&](int item) {          // thread 0
    const Item it(item, shp);
    mbar_expect_tx(&kv_full, 2 * C::KV_TILE);
#pragma unroll
    for (int j = 0; j < C::NBOX; ++j) {
      tma_load_4d(ks + j * C::KV_BOX, &maps.k, &kv_full, j * BOX, it.kvh,
                  it.n * TN, it.b);
      tma_load_4d(vs + j * C::KV_BOX, &maps.v, &kv_full, j * BOX, it.kvh,
                  it.n * TN, it.b);
    }
  };
  if (threadIdx.x == 0) {
    ld.advance();
    if (items[0] >= 0) load_kv(items[0]);
    for (int s = 1; s < S; ++s) ld.advance();
  }
  __syncwarp();

  // The writer's add in flight: it is counted (the semaphore released)
  // once it has landed, a step after it was issued.
  int* held = nullptr;
  auto land = [&]() {                     // thread WRITER
    if (held == nullptr) return;
    bulk_wait<0>();
    fence_proxy_async_global();
    red_release_add(held, 1);
    held = nullptr;
  };

  Ring<S> rs;
  int c = 0;                              // steps so far, all items
  for (int k = 0;; ++k) {
    mbar_wait(&item_full[k % RING], (k / RING) & 1);
    const int item = items[k % RING];
    if (item < 0) break;
    const Item it(item, shp);
    const int kw = it.n * TN + 64 * wg;   // this WG's first key
    float acc_dk[HD / 2], acc_dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    mbar_wait(&kv_full, k & 1);

    for (int j = 0; j < it.steps; ++j, ++c) {
      // every warp is past the last step: refill its stage with the step
      // S - 1 ahead
      if (threadIdx.x == 0 && c > 0) ld.advance();
      __syncwarp();
      const int q0 = it.qt(j, shp) * TQ;
      mbar_wait(&full[rs.stage], rs.phase);
      const uint8_t* qs = ring + rs.stage * C::STAGE;
      const uint8_t* dos = qs + C::Q_TILE;
      const float* l2s = stats + rs.stage * 2 * TQ;
      const float* dls = l2s + TQ;
      rs.advance();

      // S^T = K Q^T and dP^T = V dO^T: [64 keys][TQ queries] each
      float st[TQ / 2], dpt[TQ / 2];
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        Wgmma<TQ, 0, 0>::ss(st, desc_kmajor(ka, kk, C::KV_BOX),
                            desc_kmajor(qs, kk, C::Q_BOX), 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        Wgmma<TQ, 0, 0>::ss(dpt, desc_kmajor(va, kk, C::KV_BOX),
                            desc_kmajor(dos, kk, C::Q_BOX), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T = 2^(s scale log2(e) - lse) per query column, masked above the
      // end-aligned diagonal and past the last key, while dP^T runs
      const bool edge = kw + 64 > skv || (causal && kw + 63 > q0 + q_offset);
#pragma unroll
      for (int i = 0; i < TQ / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(l2s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * i + e;
          float x = st[idx] * scale_log2;
          if (edge) {
            const int key = kw + rt + 8 * (e >> 1);
            if (key >= skv) x = -INFINITY;
            else if (causal && key > q0 + col + (e & 1) + q_offset)
              x = MASK_VALUE;
          }
          st[idx] = fast_exp2(x - ((e & 1) ? l2.y : l2.x));
        }
      }

      wgmma_wait<0>();
      fence_regs(dpt);

      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int i = 0; i < TQ / 8; ++i) {
        const float2 d =
            *reinterpret_cast<const float2*>(dls + 8 * i + 2 * (lane % 4));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * i + e] = st[4 * i + e] *
                           (dpt[4 * i + e] - ((e & 1) ? d.y : d.x));
      }
      uint32_t pa[TQ / 16][4], sa[TQ / 16][4];
      pack_a<TQ / 16>(st, pa);
      pack_a<TQ / 16>(dpt, sa);

      // dV += P^T dO, dK += dS^T Q (dO, Q read MN-major: hd contiguous)
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        Wgmma<HD, 0, 1>::rs(acc_dv, pa[kk],
                            desc_mnmajor(dos, kk, C::Q_BOX), 1);
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        Wgmma<HD, 0, 1>::rs(acc_dk, sa[kk], desc_mnmajor(qs, kk, C::Q_BOX),
                            1);
      wgmma_commit();

      // dS^T, bf16, into this WG's 64 rows of the step's [128 keys][TQ]
      // boxes (both WGs' dQ of the last step, which read them, are done):
      // the A operand of dQ, read MN-major (queries contiguous)
#pragma unroll
      for (int i = 0; i < TQ / 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *swizzled(dss + i / 8 * C::KV_BOX, 64 * wg + rt + 8 * half,
                    8 * (i % 8) + 2 * (lane % 4)) =
              sa[i / 2][2 * (i % 2) + half];
      fence_proxy_async();
      named_sync(1, THREADS);             // both halves of dS^T written
      if (threadIdx.x == WRITER) land();  // the last step's add

      // this WG's block of dQ_partial = dS K over the item's 128 keys:
      // query rows [64 wg, 64 wg + 64) at hd 64, else hd columns
      // [64 wg, 64 wg + 64)
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      fence_regs(dq);
      wgmma_fence();
      {
        const uint8_t* da = dss + (TQ > BOX ? wg : 0) * C::KV_BOX;
        const uint8_t* kb = ks + (C::NBOX > 1 ? wg : 0) * C::KV_BOX;
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk)
          Wgmma<64, 1, 1>::ss(dq, desc_mnmajor(da, kk, C::KV_BOX),
                              desc_mnmajor(kb, kk, C::KV_BOX), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(dq);

      // the partial into the step's buffer, in fragment order (the add two
      // steps back, from this buffer, has landed)
      const int buf = c & 1;
      {
        float4* out = reinterpret_cast<float4*>(dqs + buf * TILE_FLOATS) +
                      wg * (FRAG / 4) + threadIdx.x % 128;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          out[i * 128] =
              make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2],
                          dq[4 * i + 3]);
        fence_proxy_async();
      }
      named_sync(1, THREADS);             // the partial written, stage read
      if (threadIdx.x == WRITER) {
        // the first in the tile's order copies, the others add once the
        // tile's semaphore says the ones before them have
        const long long tile =
            (static_cast<long long>(it.b) * H + it.head(j, shp)) * nq +
            q0 / TQ;
        int* sem = w.sem + tile;
        const int turn = it.turn(q0 / TQ, shp);
        if (turn > 0) wait_turn(sem, turn);
        fence_proxy_async_global();
        float* dst = w.dq_acc + tile * TILE_FLOATS;
        const float* src = dqs + buf * TILE_FLOATS;
        if (turn == 0) bulk_store(dst, src, TILE_FLOATS * 4);
        else bulk_reduce_add_f32(dst, src, TILE_FLOATS * 4);
        bulk_commit();
        held = sem;
      }
    }

    // after this barrier both WGs' products, which read all of K, are
    // done
    named_sync(1, THREADS);
    if (split) {
      // the partials, in fragment order (contiguous 16-byte stores); K
      // and V may be reloaded at once
      float4* out = reinterpret_cast<float4*>(w.dkv) +
                    ((static_cast<long long>(it.b) * H + it.h0) * shp.nt +
                     it.n) * (TN * HD / 2) +
                    wg * (HD / 8) * 128 + threadIdx.x % 128;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        out[i * 128] = make_float4(acc_dk[4 * i], acc_dk[4 * i + 1],
                                   acc_dk[4 * i + 2], acc_dk[4 * i + 3]);
        out[TN * HD / 4 + i * 128] =
            make_float4(acc_dv[4 * i], acc_dv[4 * i + 1], acc_dv[4 * i + 2],
                        acc_dv[4 * i + 3]);
      }
      if (threadIdx.x == WRITER) land();
      if (threadIdx.x == 0) {
        const int nxt = items[(k + 1) % RING];
        if (nxt >= 0) load_kv(nxt);
      }
      __syncwarp();
      continue;
    }
    // dK (scaled) and dV leave through the K and V tiles' space
#pragma unroll
    for (int cb = 0; cb < HD / 8; ++cb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int a = 4 * cb + 2 * half, row = 64 * wg + rt + 8 * half;
        const int col = 8 * (cb % 8) + 2 * (lane % 4);
        *swizzled(ks + (cb / 8) * C::KV_BOX, row, col) =
            pack_bf16(acc_dk[a] * scale, acc_dk[a + 1] * scale);
        *swizzled(vs + (cb / 8) * C::KV_BOX, row, col) =
            pack_bf16(acc_dv[a], acc_dv[a + 1]);
      }
    fence_proxy_async();
    named_sync(1, THREADS);
    if (threadIdx.x == WRITER) land();    // while K, V are reloaded
    if (threadIdx.x == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int j = 0; j < C::NBOX; ++j) {
          const int off = j * C::KV_BOX + x * 64 * BOX_ROW_BYTES;
          const int row = it.n * TN + 64 * x;
          tma_store_4d(&maps.dk, ks + off, j * BOX, it.kvh, row, it.b);
          tma_store_4d(&maps.dv, vs + off, j * BOX, it.kvh, row, it.b);
        }
      bulk_commit();
      bulk_wait_read<0>();
      // the loader has announced the next item: its first step is loaded
      const int nxt = items[(k + 1) % RING];
      if (nxt >= 0) load_kv(nxt);
    }
    __syncwarp();
  }
  if (threadIdx.x == WRITER) land();
  if (threadIdx.x == 0) bulk_wait<0>();   // the stores have landed
}

// dk, dv of (b, kvh, key tile n) from the split items' partials, one
// REDUCE_PARTS-th of a tile a block: the G query heads' fp32 partials
// summed in head order (dK then scaled) and rounded once, one float4 of
// fragment order a thread: rows r, r + 8 and columns c, c + 1 of a
// warpgroup's 64 keys.
__device__ void reduce_dkv(const float* __restrict__ dkv, bf16* dk, bf16* dv,
                           long long block, int H, int KV, int nt, int skv,
                           int hd, float scale, Strides ks, Strides vs) {
  const long long tile = block / REDUCE_PARTS;
  const int G = H / KV, n = static_cast<int>(tile % nt);
  const int kvh = static_cast<int>(tile / nt % KV);
  const int b = static_cast<int>(tile / nt / KV);
  const int per = TN * hd / 4;            // float4s of one tensor's tile
  const int part = 2 * per / REDUCE_PARTS;
  const float4* src =
      reinterpret_cast<const float4*>(dkv) +
      ((static_cast<long long>(b) * H + kvh * G) * nt + n) * 2 * per;
  const int f0 = static_cast<int>(block % REDUCE_PARTS) * part;
  for (int f = f0 + threadIdx.x; f < f0 + part; f += CONVERT_THREADS) {
    float4 a = src[f];
    for (int g = 1; g < G; ++g) {
      const float4 v = src[g * nt * 2 * per + f];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    const bool key = f < per;             // dK, else dV
    const int rem = key ? f : f - per;
    const int wg = rem / (hd / 8 * 128), i = rem / 128 % (hd / 8);
    const int t = rem % 128;
    const int r = n * TN + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
    const long long sb = key ? ks.b : vs.b, ss = key ? ks.s : vs.s;
    const long long sh = key ? ks.h : vs.h;
    const float sc = key ? scale : 1.f;
    bf16* base = (key ? dk : dv) + b * sb + kvh * sh + 8 * i + 2 * (t % 4);
    if (r < skv)
      *reinterpret_cast<uint32_t*>(base + r * ss) =
          pack_bf16(a.x * sc, a.y * sc);
    if (r + 8 < skv)
      *reinterpret_cast<uint32_t*>(base + (r + 8) * ss) =
          pack_bf16(a.z * sc, a.w * sc);
  }
}

// dq[b, i, h, :] = bf16(scale * dq_acc), one block per (b, h, query
// tile): the tile's two fragments are read in order (16-byte loads) and
// scaled and rounded into its [tq][hd] rows in shared memory (rows padded
// by 16 bytes, so a warp's pair stores fall on distinct banks), which
// then leave as 16-byte chunks, each row's contiguous. When the main
// kernel split the groups, the blocks past the dq tiles sum dk and dv
// (reduce_dkv).
__global__ void __launch_bounds__(CONVERT_THREADS)
flash_bwd_convert(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                  int H, int sq, int nq, int tq, int hd, float scale,
                  Strides s, long long dq_tiles,
                  const float* __restrict__ dkv, bf16* dk, bf16* dv, int KV,
                  int nt, int skv, Strides ks, Strides vs) {
  if (blockIdx.x >= dq_tiles) {
    reduce_dkv(dkv, dk, dv, blockIdx.x - dq_tiles, H, KV, nt, skv, hd, scale,
               ks, vs);
    return;
  }
  __shared__ __align__(16) bf16 rows[TILE_FLOATS + 8 * 2 * BOX];
  const int pitch = TILE_FLOATS / tq + 8;   // bf16 a staged row
  const long long tile = blockIdx.x;
  const float4* src =
      reinterpret_cast<const float4*>(dq_acc) + tile * (TILE_FLOATS / 4);
  for (int f = threadIdx.x; f < TILE_FLOATS / 4; f += CONVERT_THREADS) {
    const float4 v = src[f];
    // fragment blk is query rows [64 blk, +64) at tq 128, else hd columns
    const int blk = f / (FRAG / 4), i = (f / 128) % 8, t = f % 128;
    const int r = 16 * (t / 32) + (t % 32) / 4 + (tq > BOX ? BOX * blk : 0);
    bf16* at = rows + r * pitch + (tq > BOX ? 0 : BOX * blk) + 8 * i +
               2 * (t % 4);
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(v.x * scale, v.y * scale);
    *reinterpret_cast<uint32_t*>(at + 8 * pitch) =
        pack_bf16(v.z * scale, v.w * scale);
  }
  __syncthreads();
  const int qt = static_cast<int>(tile % nq);
  const long long bh = tile / nq;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const int chunks = hd / 8;
  for (int x = threadIdx.x; x < tq * chunks; x += CONVERT_THREADS) {
    const int r = x / chunks, ch = x % chunks, row = qt * tq + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(dq + b * s.b + h * s.h + row * s.s +
                                8 * ch) =
          *reinterpret_cast<const uint4*>(rows + r * pitch + 8 * ch);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// 4-D descriptor of a [B, S, H, hd] tensor with element strides `st`
// (batch, seq, head), boxes of 64 values of hd x `rows` positions of S.
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

inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

inline long long query_tiles(int sq, int hd) {
  return (sq + query_rows(hd) - 1) / query_rows(hd);
}

// Byte offsets of the workspace's parts; the last is its size.
// Whether the items take one query head each (Item): with GQA, when the
// (batch, KV head, key tile) items are fewer than the SMs.
inline bool split_items(int B, int H, int KV, int skv, int sms) {
  return H > KV && static_cast<long long>(B) * KV * ((skv + TN - 1) / TN) <
                       sms;
}

// Byte offsets of the workspace's parts; the last is its size.
struct Layout {
  long long lse, delta, sem, dkv, bytes;
  Layout(int B, int H, int KV, int sq, int skv, int hd, int sms) {
    const long long tiles =
        static_cast<long long>(B) * H * query_tiles(sq, hd);
    lse = tiles * TILE_FLOATS * 4;
    delta = lse + tiles * query_rows(hd) * 4;
    sem = delta + tiles * query_rows(hd) * 4;
    dkv = (sem + (tiles + 1) * 4 + 255) / 256 * 256;
    bytes = dkv;
    if (split_items(B, H, KV, skv, sms))
      bytes += static_cast<long long>(B) * H * ((skv + TN - 1) / TN) * 2 *
               TN * hd * 4;
  }
};

template <int HD>
cudaError_t launch_main(const void* q, const void* k, const void* v,
                        const void* dout, void* dk, void* dv, Work w, int B,
                        int H, int KV, int sq, int skv, int causal,
                        int split, float scale, const long long* st,
                        int sms, cudaStream_t stream) {
  Maps maps;
  constexpr int TQ = Cfg<HD>::TQ;
  if (!make_tmap_bshd(&maps.q, q, HD, B, sq, H, st, TQ) ||
      !make_tmap_bshd(&maps.k, k, HD, B, skv, KV, st + 3, TN) ||
      !make_tmap_bshd(&maps.v, v, HD, B, skv, KV, st + 6, TN) ||
      !make_tmap_bshd(&maps.dout, dout, HD, B, sq, H, st + 12, TQ) ||
      !make_tmap_bshd(&maps.dk, dk, HD, B, skv, KV, st + 18, 64) ||
      !make_tmap_bshd(&maps.dv, dv, HD, B, skv, KV, st + 21, 64))
    return cudaErrorInvalidValue;
  static unsigned long long devices = 0;
  cudaError_t err = allow_smem(flash_bwd_main<HD>, Cfg<HD>::SMEM, devices);
  if (err != cudaSuccess) return err;
  const int nt = (skv + TN - 1) / TN, items = B * (split ? H : KV) * nt;
  const int blocks = items < sms ? items : sms;
  // The diagonal-first order (Item) saves the semaphore waits of the
  // other, but ends on a group's longest item (nq gh steps): take it when
  // that item is at most a third of a block's share of the steps.
  int diag = 0;
  if (causal) {
    const long long nq = query_tiles(sq, HD), gh = split ? 1 : H / KV;
    long long steps = 0;
    for (int n = 0; n < nt; ++n)
      steps += nq - (n * TN > skv - sq ? (n * TN - (skv - sq)) / TQ : 0);
    steps *= static_cast<long long>(B) * H;
    diag = 3 * nq * gh * blocks <= steps;
  }
  flash_bwd_main<HD><<<blocks, THREADS, Cfg<HD>::SMEM, stream>>>(
      maps, w, B, H, KV, sq, skv, causal, diag, split, scale * LOG2E,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace flash_attn_bwd_bf16 needs for these sizes and
// `sms` SMs: the fp32 dQ accumulator (two 64 x 64 blocks a query tile of
// each (batch, head)), the padded lse and D rows, the semaphores and,
// when the items are split by query head, their fp32 dK and dV.
long long flash_attn_bwd_workspace_bytes(int B, int H, int KV, int sq,
                                         int skv, int hd, int sms) {
  return Layout(B, H, KV, sq, skv, hd, sms).bytes;
}

// Gradients of flash attention. strides: 24 element strides, (batch, seq,
// head) for q, k, v, o, dout, dq, dk, dv in turn; all multiples of 8, hd
// has unit stride, pointers 16-byte aligned. lse: the forward's fp32
// [B, H, sq] row log-sum-exp (log2 units); work: a 256-byte aligned
// scratch of flash_attn_bwd_workspace_bytes. Causal needs sq <= skv. The
// main kernel runs a persistent grid of at most `sms` blocks. Issues three
// launches on `stream` (delta, main, convert) and returns the first
// non-zero CUDA error (0 on success), or cudaErrorInvalidValue for shapes
// the kernels do not take.
int flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, void* dk, void* dv, void* work, int B,
                        int H, int KV, int sq, int skv, int hd, int causal,
                        float scale, const long long* strides, int sms,
                        void* stream) {
  if (B < 1 || sq < 1 || skv < 1 || KV < 1 || H % KV != 0 || sms < 1 ||
      (causal && sq > skv))
    return cudaErrorInvalidValue;
  if (hd != 64 && hd != 80 && hd != 96 && hd != 128)
    return cudaErrorInvalidValue;
  // cuTensorMapEncodeTiled needs a current context, which the thread
  // autograd runs a backward on may not have yet
  cudaError_t err = bind_device_of(q);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay(B, H, KV, sq, skv, hd, sms);
  const int split = split_items(B, H, KV, skv, sms);
  uint8_t* base = static_cast<uint8_t*>(work);
  const Work w{reinterpret_cast<float*>(base),
               reinterpret_cast<float*>(base + lay.dkv),
               reinterpret_cast<float*>(base + lay.lse),
               reinterpret_cast<float*>(base + lay.delta),
               reinterpret_cast<int*>(base + lay.sem)};
  const long long nq = query_tiles(sq, hd), tq = query_rows(hd);
  const long long groups =
      B * nq * tq * ((H + GROUP_ROWS - 1) / GROUP_ROWS);
  const int n_sem = static_cast<int>(B * H * nq + 1);
  constexpr int GROUPS_PER_BLOCK = DELTA_THREADS / ROW_THREADS;
  flash_bwd_delta<<<static_cast<unsigned>((groups + GROUPS_PER_BLOCK - 1) /
                                          GROUPS_PER_BLOCK),
                    DELTA_THREADS, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), w, H, sq, static_cast<int>(nq * tq),
      hd, strides_at(strides, 3), strides_at(strides, 4), groups, n_sem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (hd) {
    case 64: err = launch_main<64>(q, k, v, dout, dk, dv, w, B, H, KV, sq, skv, causal, split, scale, strides, sms, s); break;
    case 80: err = launch_main<80>(q, k, v, dout, dk, dv, w, B, H, KV, sq, skv, causal, split, scale, strides, sms, s); break;
    case 96: err = launch_main<96>(q, k, v, dout, dk, dv, w, B, H, KV, sq, skv, causal, split, scale, strides, sms, s); break;
    default: err = launch_main<128>(q, k, v, dout, dk, dv, w, B, H, KV, sq, skv, causal, split, scale, strides, sms, s); break;
  }
  if (err != cudaSuccess) return err;
  // dq, and with split items dk and dv too: one block a tile
  const long long dq_tiles = B * H * nq;
  const int nt = (skv + TN - 1) / TN;
  const long long blocks =
      dq_tiles + (split ? B * KV * nt * REDUCE_PARTS : 0);
  flash_bwd_convert<<<static_cast<unsigned>(blocks), CONVERT_THREADS, 0,
                      s>>>(w.dq_acc, static_cast<bf16*>(dq), H, sq,
                           static_cast<int>(nq), static_cast<int>(tq), hd,
                           scale, strides_at(strides, 5), dq_tiles, w.dkv,
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                           KV, nt, skv, strides_at(strides, 6),
                           strides_at(strides, 7));
  return cudaGetLastError();
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
