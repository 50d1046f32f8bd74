// AdamW with the global-norm clip, for Hopper (sm_90a), in two passes over
// the parameters:
//
//   adamw_sumsq           pass 1, one launch a leaf: the leaf's gradient
//                         read once, its squares summed in fp32, one
//                         partial a block into the block's fixed slot of
//                         one workspace;
//   adamw_sumsq_finalize  one block: the partials summed in a fixed order,
//                         norm = sqrt(sum) and scale = min(clip / max(norm,
//                         1e-9), 1), both left on the card;
//   adamw_step            pass 2, one launch a leaf: p, g, m and v read
//                         once, m, v and p written once, in place.
//
// Replaces no Pallas kernel: the JAX reference's AdamW is plain jnp
// (src/repro/train/optimizer.py: adamw_update, global_norm) and XLA fuses
// it. The port's torch version (kernels/adamw/ref.py) runs some 18 ops a
// leaf, each of which reads and writes full-size fp32 tensors, and a
// full-size square before the norm: ~170-180 bytes a parameter.
//
// What bounds it on an H100: bytes. Parameters, gradients and moments are
// fp32 in training: pass 1 reads g (4 bytes a parameter), pass 2 reads p,
// g, m and v (16) and writes p, m and v (12): 32 bytes a parameter at
// under one FLOP a byte; at olmo_1b's 1.281 B parameters 41.0 GB, 12.2 ms
// at 3.35 TB/s. The design streams every array exactly once: 16-byte
// loads and stores (4 fp32 elements; 8 bytes for a bf16 p or g), a
// thread of pass 2 holding STEP_UNROLL groups of 4 elements of all four
// arrays in flight, over a grid-stride loop on a grid that fills the SMs;
// nothing is staged in shared memory, and nothing but the partials
// (one float per 16384 elements) is written besides p, m and v.
//
// Numbers: pass 2 does the torch version's arithmetic in its order, each
// op rounded once to nearest (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction, no approximate division), with the
// float constants the torch ops use (b1, 1 - b1, b2, 1 - b2, eps and the
// decay, each a double on the host rounded to float, as PyTorch rounds a
// Python scalar for an fp32 tensor), and scale, lr and the two bias
// corrections read from the 0-d fp32 tensors the step computed: p, m and
// v come out bitwise equal to the torch version's given the same four
// scalars. Pass 1 sums in another order than torch.sum but in a fixed
// one: no atomics, so the norm is bitwise the same from run to run.
//
// Layout: each leaf contiguous, n elements; p and g fp32 or bf16, m and v
// fp32. A leaf whose pointers are all aligned to a group of 4 elements
// takes the vector loads; any other is read element by element. The
// ragged tail of a leaf (n not a multiple of 4) is masked either way.

#include <stdint.h>
#include <string.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int SUMSQ_GROUPS = 16;     // groups of 4 a thread of pass 1 sums
constexpr long long SUMSQ_CHUNK = THREADS * SUMSQ_GROUPS * 4;  // a block's
constexpr int FINAL_THREADS = 1024;
constexpr int STEP_UNROLL = 2;       // groups of 4 a thread of pass 2 holds
constexpr int STEP_BLOCKS_PER_SM = 8;  // 8 x 256 threads: a full SM

enum Dtype { F32 = 0, BF16 = 1 };

struct StepArgs {
  void* p;                // [n], P
  const void* g;          // [n], G
  float* m;               // [n]
  float* v;               // [n]
  const float* scale;     // 0-d: the clip's factor
  const float* lr;        // 0-d
  const float* bc1;       // 0-d: 1 - b1^t
  const float* bc2;       // 0-d: 1 - b2^t
  float b1, c1, b2, c2;   // c1 = 1 - b1, c2 = 1 - b2, rounded from double
  float eps, wd;
  long long n;
};

template <typename T> struct Group;   // 4 elements in one load
template <> struct Group<float> { using type = float4; };
template <> struct Group<bf16> { using type = uint2; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void unpack(const float4& u, float* f) {
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void unpack(const uint2& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

template <typename T> __device__ __forceinline__ typename Group<T>::type
pack(const float* f);
template <> __device__ __forceinline__ float4 pack<float>(const float* f) {
  return make_float4(f[0], f[1], f[2], f[3]);
}
template <> __device__ __forceinline__ uint2 pack<bf16>(const float* f) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f[0], f[1]),
                         __floats2bfloat162_rn(f[2], f[3])};
  uint2 u;
  memcpy(&u, h, sizeof(u));
  return u;
}

// elements [i, i + 4) of p as fp32, those at or past n read as 0: one
// load when VEC and the group is whole, else element by element
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, long long i,
                                      long long n, float* f) {
  if (VEC && i + 4 <= n) {
    unpack(*reinterpret_cast<const typename Group<T>::type*>(p + i), f);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = i + j < n ? to_float(p[i + j]) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* __restrict__ p, long long i,
                                       long long n, const float* f) {
  if (VEC && i + 4 <= n) {
    *reinterpret_cast<typename Group<T>::type*>(p + i) = pack<T>(f);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) p[i + j] = from_float<T>(f[j]);
  }
}

// the block's sum, in a fixed order (shuffles, then the warps' sums in
// warp 0); valid in thread 0
template <int NT>
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warp_sums[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[w] = s;
  __syncthreads();
  if (w == 0) {
    s = lane < NT / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  return s;
}

// pass 1: block b sums the squares of elements [b, b + 1) * SUMSQ_CHUNK of
// one leaf into partial[b]; a thread keeps one sum per lane of its groups
template <typename G, bool VEC>
__global__ void __launch_bounds__(THREADS)
    adamw_sumsq(const G* __restrict__ g, long long n,
                float* __restrict__ partial) {
  const long long base = blockIdx.x * SUMSQ_CHUNK + threadIdx.x * 4ll;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < SUMSQ_GROUPS; ++k) {
    float f[4];
    load4<G, VEC>(g, base + k * (THREADS * 4ll), n, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = __fmaf_rn(f[j], f[j], acc[j]);
  }
  const float s = block_sum<THREADS>((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// the partials' sum (thread t over slots t, t + 1024, ... in order, then
// the block's sum), its sqrt and the clip's scale; a NaN norm gives a NaN
// scale, as torch.clamp propagates it
__global__ void __launch_bounds__(FINAL_THREADS)
    adamw_sumsq_finalize(const float* __restrict__ partial, long long count,
                         float clip, float* __restrict__ out) {
  float s = 0.f;
  for (long long i = threadIdx.x; i < count; i += FINAL_THREADS)
    s += partial[i];
  s = block_sum<FINAL_THREADS>(s);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(s);
    const float scale = __fdiv_rn(clip, norm < 1e-9f ? 1e-9f : norm);
    out[0] = norm;
    out[1] = scale > 1.f ? 1.f : scale;
  }
}

// one element of kernels/adamw/ref.py's adamw_step_ref, op for op
__device__ __forceinline__ void update(const StepArgs& a, float scale,
                                       float lr, float bc1, float bc2,
                                       float& p, float g, float& m,
                                       float& v) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(a.c1, g));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(a.c2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
  u = __fadd_rn(u, __fmul_rn(a.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

// pass 2: groups of 4 elements over a grid-stride loop, STEP_UNROLL groups
// a thread at a time, each group's four arrays loaded before any is used
template <typename P, typename G, bool VEC>
__global__ void __launch_bounds__(THREADS) adamw_step(const StepArgs a) {
  P* __restrict__ p = static_cast<P*>(a.p);
  const G* __restrict__ g = static_cast<const G*>(a.g);
  float* __restrict__ m = a.m;
  float* __restrict__ v = a.v;
  const float scale = *a.scale, lr = *a.lr, bc1 = *a.bc1, bc2 = *a.bc2;
  const long long n = a.n;
  const long long groups = (n + 3) / 4;
  const long long stride =
      static_cast<long long>(gridDim.x) * THREADS * STEP_UNROLL;
  for (long long q = blockIdx.x * (THREADS * STEP_UNROLL * 1ll) + threadIdx.x;
       q < groups; q += stride) {
    float pf[STEP_UNROLL][4], gf[STEP_UNROLL][4], mf[STEP_UNROLL][4],
        vf[STEP_UNROLL][4];
#pragma unroll
    for (int u = 0; u < STEP_UNROLL; ++u) {
      const long long i = (q + u * THREADS) * 4;
      if (i < n) {
        load4<P, VEC>(p, i, n, pf[u]);
        load4<G, VEC>(g, i, n, gf[u]);
        load4<float, VEC>(m, i, n, mf[u]);
        load4<float, VEC>(v, i, n, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < STEP_UNROLL; ++u) {
      const long long i = (q + u * THREADS) * 4;
      if (i < n) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          update(a, scale, lr, bc1, bc2, pf[u][j], gf[u][j], mf[u][j],
                 vf[u][j]);
        store4<P, VEC>(p, i, n, pf[u]);
        store4<float, VEC>(m, i, n, mf[u]);
        store4<float, VEC>(v, i, n, vf[u]);
      }
    }
  }
}

inline bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename G>
int launch_sumsq(const void* g, long long n, float* partial,
                 unsigned blocks, cudaStream_t s) {
  if (aligned(g, 4 * sizeof(G)))
    adamw_sumsq<G, true><<<blocks, THREADS, 0, s>>>(
        static_cast<const G*>(g), n, partial);
  else
    adamw_sumsq<G, false><<<blocks, THREADS, 0, s>>>(
        static_cast<const G*>(g), n, partial);
  return cudaGetLastError();
}

template <typename P, typename G>
int launch_step(const StepArgs& a, unsigned blocks, cudaStream_t s) {
  if (aligned(a.p, 4 * sizeof(P)) && aligned(a.g, 4 * sizeof(G)) &&
      aligned(a.m, 16) && aligned(a.v, 16))
    adamw_step<P, G, true><<<blocks, THREADS, 0, s>>>(a);
  else
    adamw_step<P, G, false><<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pass 1 over one leaf: g [n] (g_dtype 0 fp32, 1 bf16), n >= 1; writes
// partial[0, slots), slots = ceil(n / 16384), the sums of squares of
// consecutive chunks of 16384 elements. Returns the launch's
// cudaGetLastError() (0 on success).
int adamw_sumsq_launch(const void* g, int g_dtype, long long n,
                       void* partial, long long slots, void* stream) {
  if (n < 1 || slots != (n + SUMSQ_CHUNK - 1) / SUMSQ_CHUNK ||
      slots >= (1ll << 31) || (g_dtype != F32 && g_dtype != BF16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partial);
  const unsigned blocks = static_cast<unsigned>(slots);
  return g_dtype == F32 ? launch_sumsq<float>(g, n, out, blocks, s)
                        : launch_sumsq<bf16>(g, n, out, blocks, s);
}

// The partials [count] (count >= 0) summed; writes out[0] = the norm, the
// sum's sqrt, and out[1] = min(clip / max(norm, 1e-9), 1). Returns the
// launch's cudaGetLastError().
int adamw_finalize_launch(const void* partial, long long count, float clip,
                          void* out, void* stream) {
  if (count < 0) return cudaErrorInvalidValue;
  adamw_sumsq_finalize<<<1, FINAL_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), count, clip,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// Pass 2 over one leaf, in place: p [n] (p_dtype), g [n] (g_dtype), m and v
// fp32 [n]; scale, lr, bc1, bc2 point to fp32 scalars on the card; b1, c1
// = 1 - b1, b2, c2 = 1 - b2, eps, wd the hyperparameters; sms the card's
// multiprocessors. Returns the launch's cudaGetLastError().
int adamw_step_launch(void* p, int p_dtype, const void* g, int g_dtype,
                      void* m, void* v, const void* scale, const void* lr,
                      const void* bc1, const void* bc2, float b1, float c1,
                      float b2, float c2, float eps, float wd, long long n,
                      int sms, void* stream) {
  if (n < 1 || sms < 1 || (p_dtype != F32 && p_dtype != BF16) ||
      (g_dtype != F32 && g_dtype != BF16))
    return cudaErrorInvalidValue;
  StepArgs a{p, g, static_cast<float*>(m), static_cast<float*>(v),
             static_cast<const float*>(scale), static_cast<const float*>(lr),
             static_cast<const float*>(bc1), static_cast<const float*>(bc2),
             b1, c1, b2, c2, eps, wd, n};
  const long long per_block = THREADS * STEP_UNROLL;
  const long long want = ((n + 3) / 4 + per_block - 1) / per_block;
  const long long most = static_cast<long long>(sms) * STEP_BLOCKS_PER_SM;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == F32)
    return g_dtype == F32 ? launch_step<float, float>(a, blocks, s)
                          : launch_step<float, bf16>(a, blocks, s);
  return g_dtype == F32 ? launch_step<bf16, float>(a, blocks, s)
                        : launch_step<bf16, bf16>(a, blocks, s);
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
