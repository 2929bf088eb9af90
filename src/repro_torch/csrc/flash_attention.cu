// Causal / sliding-window GQA flash-attention forward for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel of the reference package:
//   flash_attention_fwd <- repro/kernels/flash_attention.py  flash_attention
//                          (_flash_kernel)
//
// What it computes, as the Pallas kernel does: scores (q in f32 * 1/sqrt(hd))
// . k over every key, masked where k >= S, where causal and k > q, and where
// windowed and k <= q - window (positions counted from 0 for q and k alike),
// with the finite NEG_INF = -1e30 of the reference; softmax in f32; output
// (sum p v) / max(l, 1e-30) in q's dtype.  GQA: query head h reads kv head
// h / (H / Hkv).  Inputs are f32 or bf16, read through their (batch, seq,
// head) strides with the head dim contiguous, so no transposed or padded
// copy is made; the ragged T and S edges are masked here.
//
// What bounds it on an H100: operations.  At the LM path's shape (B 4,
// T = S = 512, H 16, Hkv 8, hd 128) the causal work is about 4.3 GFLOP
// against about 50 MB moved, some 85 operations per byte.  This first
// design runs them in f32 on the CUDA cores (no tensor cores, as the
// reference's f32 numerics ask), so its ceiling is the 67 TFLOP/s of f32
// FMA, and its effort goes into feeding the FMAs from shared memory:
//   * one CTA per (batch*head, 64-query tile) keeps its Q tile in shared
//     memory and loops over 64-key K/V tiles with an online softmax in f32
//     (the numerics of the reference's blockwise_attention, which the Pallas
//     kernel's docstring says it mirrors); tiles wholly above the diagonal
//     or wholly before the window are skipped, so causal work is about half
//     of the dense work;
//   * 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3 for
//     both products, key columns tx + 16j of the score tile and head columns
//     tx + 16j of the output, so the row max, row sum and rescale stay in
//     registers and need only shuffles within a half warp;
//   * Q and K rows are padded by one float in shared memory, so the 16 key
//     columns a half warp reads fall in 16 banks; P rows by four.
// Tensor cores (mma / wgmma in bf16 or TF32), TMA loads and pipelining are
// the next steps; they change the rounding and are a later change's work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kCols = kBlockK / 16;  // key columns per thread
constexpr int kPStride = kBlockK + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// max / sum over the 16 lanes of a half warp (the threads of one row group)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, t, h;  // element strides of the batch, sequence and head dims
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ) * (HD + 1) + static_cast<size_t>(kBlockK) * (HD + 1) +
          static_cast<size_t>(kBlockK) * HD + static_cast<size_t>(kBlockQ) * kPStride);
}

// grid (B * H, ceil(Tq / 64)); q (B, Tq, H, HD), k / v (B, S, Hkv, HD),
// o (B, Tq, H, HD).  window <= 0: no window.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int Hkv, int Tq, int S, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, int window, float scale) {
  constexpr int kOut = HD / 16;  // head columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kBlockQ][HD + 1]
  float* Ks = Qs + kBlockQ * (HD + 1);  // [kBlockK][HD + 1]
  float* Vs = Ks + kBlockK * (HD + 1);  // [kBlockK][HD]
  float* Ps = Vs + kBlockK * HD;        // [kBlockQ][kPStride]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qb = q + b * qs.b + h * qs.h;
  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, t = q0 + r;
    Qs[r * (HD + 1) + d] = t < Tq ? to_f32(qb[t * qs.t + d]) * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;
  }

  // keys no row of this tile can see: past the diagonal, before the window
  const int q_last = min(q0 + kBlockQ, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int k0 = (k_first / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the last tile's readers are done (and Qs is written)
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < S;
      Ks[r * (HD + 1) + d] = in ? to_f32(kb[s * ks.t + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f32(vb[s * vs.t + d]) : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool keep = kp < S;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        if (!keep) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty * kRows + i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty * kRows + i;
    if (t < Tq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kOut; ++j) store(ob + t * os.t + tx + 16 * j, acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Tq,
           int S, Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Tq, S, qs, ks, vs, os, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
                int Hkv, int Tq, int S, Strides qs, Strides ks, Strides vs, Strides os,
                int causal, int window, float scale, cudaStream_t stream) {
#define FLASH_HD(N)                                                                         \
  case N:                                                                                   \
    return launch<T, N>(q, k, v, o, B, H, Hkv, Tq, S, qs, ks, vs, os, causal, window, scale, \
                        stream);
  switch (hd) {
    FLASH_HD(32)
    FLASH_HD(64)
    FLASH_HD(96)
    FLASH_HD(128)
    FLASH_HD(160)
    FLASH_HD(192)
    FLASH_HD(224)
    FLASH_HD(256)
    default:
      return -1;
  }
#undef FLASH_HD
}

}  // namespace

// dtype: 0 f32, 1 bf16.  Strides are in elements; the head dim is contiguous.
// Returns 0, a cudaError_t, or -1 for an unsupported dtype or head dim.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int Hkv, int Tq, int S, int hd,
                                   long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   long long o_sb, long long o_st, long long o_sh, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      os{o_sb, o_st, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, Hkv, Tq, S, qs, ks, vs, os, causal, window,
                              scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Hkv, Tq, S, qs, ks, vs, os, causal,
                                      window, scale, st);
  return -1;
}
