// jax.random.normal for Hopper (sm_90a), bit for bit: the initial weights of
// the LMs.  Plain C interface, loaded with ctypes by
// repro_torch/kernels/normal.py.
//
// Replaces no TPU kernel: the reference draws its weights with XLA's
// threefry and erf_inv (repro/models/common.py dense_init,
// jax.random.normal).  It was added so that one seed gives the reference's
// LM on the card: every random leaf of `init_params` is drawn here.
//
// What it computes, for the entries i in [offset, offset + n) of a draw
// (the flat index of `jax.random.normal(key, shape, float32)` in its
// partitionable threefry form):
//   * threefry2x32, 20 rounds, of the counter (i >> 32, i & 0xffffffff)
//     under the key words (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), the two output
//     words xor'ed;
//   * the top 23 bits as a float in [1, 2), minus 1, mapped onto
//     [nextafter(-1, 0), 1): f * 2 + lo, then max(lo, .);
//   * sqrt(2) * erf_inv(u), with XLA's f32 erf_inv (Giles), log1p and log
//     (Cephes) as repro_torch/core/prng.py spells them;
//   * times the leaf's f32 scale, then rounded to the leaf's dtype in
//     registers (f32, or bf16 to nearest even) and stored.
// Rounding: __fmaf_rn exactly where XLA's CPU backend emits a fused
// multiply-add, every other operation an IEEE intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), and the file is built with
// -fmad=false, so nvcc contracts nothing on its own.  The constants are hex
// literals of the reference's f32 values.
//
// What bounds it on an H100: operations.  An entry costs about 86 integer
// operations (20 rounds of an add, a funnel-shift rotate and a xor, and the
// key injections) and about 45 float ones (erf_inv's and log1p's or log's
// polynomials), and writes 2 or 4 bytes: at 3.35 TB/s the store takes
// 0.6-1.2 ps an entry, the integer work about 5 ps at the int32 rate.  The
// kernel is a grid-stride loop, one entry a thread an iteration, one
// launch per leaf (or per stacked repetition, or per expert matrix): no
// shared memory, no f32 temporary for a bf16 leaf, 64-bit indices (a
// deepseek-v3 MoE stack of one layer holds 3.76e9 entries).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// XLA's f32 log of a positive normal v (Cephes' logf)
__device__ __forceinline__ float xla_log(float v) {
  const uint32_t b = __float_as_uint(v);
  float m = __uint_as_float((b & 0x7FFFFFu) | 0x3F000000u);  // frexp: v = m 2^e, m in [0.5, 1)
  float e = static_cast<float>(static_cast<int>(b >> 23) - 126);
  const bool low = m < 0x1.6a09e6p-1f;
  float x = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a370p-4f), x, 0x1.de4a34p-4f);
  const float y1 = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x, -0x1.555ca0p-3f);
  const float y2 = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x, 0x1.555554p-2f);
  y = __fmaf_rn(__fmaf_rn(y, x3, y1), x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(-0x1.bd0106p-13f, e));
  x = __fadd_rn(__fmaf_rn(-0.5f, x2, x), y);
  return __fmaf_rn(0x1.63p-1f, e, x);
}

// XLA's f32 log1p of x in (-1, 0]
__device__ __forceinline__ float xla_log1p(float x) {
  if (fabsf(x) >= 0x1.a8279ap-2f) return xla_log(__fadd_rn(1.0f, x));
  constexpr float kNum[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,
                             0x1.e798ecp+5f,  0x1.c8e75ap+5f, 0x1.40a202p+4f};
  constexpr float kDen[7] = {0x1.0p+0f,      0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                             0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
  const float x2 = __fmul_rn(x, x);
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    num = __fmaf_rn(num, x, kNum[i]);
    den = __fmaf_rn(den, x, kDen[i]);
  }
  return __fadd_rn(x, __fmaf_rn(-0.5f, x2, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
}

// XLA's f32 erf_inv of x in (-1, 1) (Giles)
__device__ __forceinline__ float xla_erf_inv(float x) {
  constexpr float kLt5[9] = {0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                             -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a810p-10f,
                             -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
  constexpr float kGe5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                             -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                             0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
  float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? kLt5[i] : kGe5[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, 0x1.fffffep+127f) : __fmul_rn(p, x);
}

__device__ __forceinline__ float normal_entry(uint32_t k0, uint32_t k1, uint64_t i, float scale) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  constexpr float lo = -0x1.fffffep-1f;  // nextafter(-1, 0); f32(1 - lo) = 2
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
  return __fmul_rn(__fmul_rn(0x1.6a09e6p+0f, xla_erf_inv(u)), scale);
}

__device__ __forceinline__ void store(float* out, uint64_t j, float v) { out[j] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, uint64_t j, float v) {
  out[j] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
normal_fill_kernel(T* __restrict__ out, uint32_t k0, uint32_t k1, uint64_t offset, uint64_t n,
                   float scale) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kThreads;
  for (uint64_t j = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x; j < n;
       j += stride)
    store(out, j, normal_entry(k0, k1, offset + j, scale));
}

template <typename T>
int launch(T* out, uint32_t k0, uint32_t k1, uint64_t offset, uint64_t n, float scale,
           cudaStream_t st) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, normal_fill_kernel<T>, kThreads, 0);
  const uint64_t want = (n + kThreads - 1) / kThreads;
  const uint64_t full = static_cast<uint64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(want < full ? want : full);
  normal_fill_kernel<T><<<grid, kThreads, 0, st>>>(out, k0, k1, offset, n, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: n entries of dtype f32 (bf16 = 0) or bf16 (bf16 = 1); entry j is
// entry offset + j of the draw under key (k0, k1), times scale.
extern "C" int normal_fill(void* out, int bf16, uint32_t k0, uint32_t k1,
                           unsigned long long offset, unsigned long long n, float scale,
                           void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<__nv_bfloat16*>(out), k0, k1, offset, n, scale, st);
  return launch(static_cast<float*>(out), k0, k1, offset, n, scale, st);
}
