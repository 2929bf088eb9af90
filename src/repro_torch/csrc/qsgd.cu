// QSGD kernels for Hopper (sm_90a): the packed wire (fused quantize -> bit-pack
// and unpack -> dequantize) and the dense codes (quantize to signed int8,
// dequantize).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/qsgd.py.
//
// Replaces the Pallas TPU kernels of the reference package:
//   qsgd_quantize_pack     <- repro/kernels/qsgd.py  qsgd_quantize_pack_blocks
//                             (_quantize_pack_kernel)
//   qsgd_unpack_dequantize <- repro/kernels/qsgd.py  qsgd_unpack_dequantize_blocks
//                             (_unpack_dequantize_kernel)
//   qsgd_quantize          <- repro/kernels/qsgd.py  qsgd_quantize_blocks
//                             (_quantize_kernel)
//   qsgd_dequantize        <- repro/kernels/qsgd.py  qsgd_dequantize_blocks
//                             (_dequantize_kernel)
//
// What bounds them on an H100: bytes.  Quantize -> pack reads 4 B of f32 per
// entry and writes b/8 B of payload (0.75 B at s = 16) plus 4 B of norm per
// block; unpack -> dequantize is the reverse.  The dense-code pair moves 4 B
// of f32 and 1 B of int8 code per entry.  Each entry costs a few dozen
// integer and float operations, far below the card's rate per byte, so the
// designs spend their effort on moving each byte once:
//   * the stochastic-rounding dither is computed in the kernel from the
//     sender's key words and the entry's flat index within the leaf (the
//     keyed murmur3-fmix hash of the reference's ops._cheap_uniform), so the
//     uniform tensor the TPU kernel reads never touches device memory;
//   * one CTA owns one block row: float4 loads, a warp-shuffle plus shared
//     memory reduction for the norm, codes staged in a [32][W+1] shared tile
//     (the +1 pad spreads the stride-W column reads over the banks), and one
//     __ballot_sync per bit plane builds a payload word: lane k of the warp
//     for word w holds code k*W + w, exactly the reference's bit layout;
//   * payload words and dequantized values are staged in shared memory and
//     written with coalesced stores.
// The packing quantizer runs over every sender of one leaf in one launch
// (grid.y).  The dense-code quantizer is the same row pass without the
// pack: it stores each thread's four codes as one char4, and its dither
// index is the flat index of the whole padded message (one key per call, as
// the reference's ops.qsgd_quantize draws it).
//
// Rounding: every float operation is an explicit round-to-nearest intrinsic
// in the reference's order ((|v| / norm) * s, then + u; (c - s) * (norm / s)),
// so no FMA contraction changes a code.  Never build with fast math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 4096;
constexpr int kMaxW = kMaxBlock / 32;
constexpr int kVecPerThread = kMaxBlock / 4 / kThreads;
constexpr int kMaxBits = 8;  // s <= 127: codes in [0, 254]

__device__ __forceinline__ uint32_t dither_word(uint32_t i, uint32_t k0, uint32_t k1) {
  uint32_t x = i ^ k0;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16) ^ k1;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// Sum of one float per thread over the CTA; every thread gets the total.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float t = lane < kWarps ? scratch[lane] : 0.f;
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, o));
  return __shfl_sync(0xffffffffu, t, 0);
}

__device__ __forceinline__ uint32_t quantize_one(float x, uint32_t half, float norm,
                                                 float safe, int s) {
  const float sf = static_cast<float>(s);
  const float u = __fmul_rn(static_cast<float>(half), 1.0f / 65536.0f);
  const float p = __fmul_rn(__fdiv_rn(fabsf(x), safe), sf);
  float q = fminf(fmaxf(floorf(__fadd_rn(p, u)), 0.0f), sf);
  if (!(norm > 0.0f)) q = 0.0f;
  const int qi = static_cast<int>(q);
  return static_cast<uint32_t>(s + (x > 0.0f ? qi : (x < 0.0f ? -qi : 0)));
}

// Loads one block row into registers (a float4 per thread and step) and
// returns its L2 norm, correctly rounded, to every thread.
__device__ __forceinline__ float load_row_norm(const float4* __restrict__ vrow, int nvec,
                                               float4 (&r)[kVecPerThread], float* scratch) {
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < kVecPerThread; ++t) {
    const int i = threadIdx.x + t * kThreads;
    if (i < nvec) {
      r[t] = vrow[i];
      acc = __fadd_rn(acc, __fmul_rn(r[t].x, r[t].x));
      acc = __fadd_rn(acc, __fmul_rn(r[t].y, r[t].y));
      acc = __fadd_rn(acc, __fmul_rn(r[t].z, r[t].z));
      acc = __fadd_rn(acc, __fmul_rn(r[t].w, r[t].w));
    }
  }
  return __fsqrt_rn(block_sum(acc, scratch));
}

// Sign-folded codes of four entries whose first has the even flat index g:
// they take the two halves of dither words g/2 and g/2 + 1.
__device__ __forceinline__ void quantize4(const float4& x, uint32_t g, uint32_t k0,
                                          uint32_t k1, float norm, float safe, int s,
                                          uint32_t (&codes)[4]) {
  const uint32_t h0 = dither_word(g >> 1, k0, k1);
  const uint32_t h1 = dither_word((g >> 1) + 1u, k0, k1);
  codes[0] = quantize_one(x.x, h0 & 0xFFFFu, norm, safe, s);
  codes[1] = quantize_one(x.y, h0 >> 16, norm, safe, s);
  codes[2] = quantize_one(x.z, h1 & 0xFFFFu, norm, safe, s);
  codes[3] = quantize_one(x.w, h1 >> 16, norm, safe, s);
}

// grid (nb, senders); v (senders, nb, block) f32; keys (senders, 2) words;
// payload (senders, nb, bits*W) words; norms (senders, nb).
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ v, const uint32_t* __restrict__ keys,
                     uint32_t* __restrict__ payload, float* __restrict__ norms,
                     int nb, int block, int s, int bits) {
  __shared__ uint32_t tile[32 * (kMaxW + 1)];
  __shared__ uint32_t words[kMaxBits * kMaxW];
  __shared__ float scratch[kWarps];
  const int row = blockIdx.x, sender = blockIdx.y;
  const size_t row_id = static_cast<size_t>(sender) * nb + row;
  const int nvec = block >> 2, W = block >> 5;
  const float4* vrow = reinterpret_cast<const float4*>(v + row_id * block);

  float4 r[kVecPerThread];
  const float norm = load_row_norm(vrow, nvec, r, scratch);
  const float safe = norm > 0.0f ? norm : 1.0f;
  const uint32_t k0 = keys[2 * sender], k1 = keys[2 * sender + 1];
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(block);

#pragma unroll
  for (int t = 0; t < kVecPerThread; ++t) {
    const int i = threadIdx.x + t * kThreads;
    if (i < nvec) {
      // entries 4i..4i+3 of the row, at flat leaf index base + 4i
      uint32_t codes[4];
      quantize4(r[t], base + 4u * static_cast<uint32_t>(i), k0, k1, norm, safe, s, codes);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * i + c;
        tile[(e / W) * (W + 1) + e % W] = codes[c];
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < W; w += kWarps) {
    const uint32_t code = tile[lane * (W + 1) + w];
    for (int j = 0; j < bits; ++j) {
      const uint32_t word = __ballot_sync(0xffffffffu, (code >> j) & 1u);
      if (lane == 0) words[j * W + w] = word;
    }
  }
  __syncthreads();

  uint32_t* out = payload + row_id * static_cast<size_t>(bits * W);
  for (int i = threadIdx.x; i < bits * W; i += kThreads) out[i] = words[i];
  if (threadIdx.x == 0) norms[row_id] = norm;
}

// grid (rows); payload (rows, bits*W) words; norms (rows,); out (rows, block).
__global__ void __launch_bounds__(kThreads)
unpack_dequantize_kernel(const uint32_t* __restrict__ payload,
                         const float* __restrict__ norms, float* __restrict__ out,
                         int block, int s, int bits) {
  __shared__ uint32_t words[kMaxBits * kMaxW];
  __shared__ float tile[32 * (kMaxW + 1)];
  const size_t row = blockIdx.x;
  const int W = block >> 5, nw = bits * W;
  const uint32_t* in = payload + row * static_cast<size_t>(nw);
  for (int i = threadIdx.x; i < nw; i += kThreads) words[i] = in[i];
  const float scale = __fdiv_rn(norms[row], static_cast<float>(s));
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < W; w += kWarps) {
    uint32_t code = 0;
    for (int j = 0; j < bits; ++j) code |= ((words[j * W + w] >> lane) & 1u) << j;
    tile[lane * (W + 1) + w] =
        __fmul_rn(static_cast<float>(static_cast<int>(code) - s), scale);
  }
  __syncthreads();

  float4* orow = reinterpret_cast<float4*>(out + row * static_cast<size_t>(block));
  for (int i = threadIdx.x; i < (block >> 2); i += kThreads) {
    float vals[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = 4 * i + c;
      vals[c] = tile[(e / W) * (W + 1) + e % W];
    }
    orow[i] = make_float4(vals[0], vals[1], vals[2], vals[3]);
  }
}

// grid (nb); v (nb, block) f32; key (2) words; q (nb, block) int8 signed
// codes; norms (nb).
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ v, const uint32_t* __restrict__ key,
                int8_t* __restrict__ q, float* __restrict__ norms, int block, int s) {
  __shared__ float scratch[kWarps];
  const size_t row = blockIdx.x;
  const int nvec = block >> 2;
  const float4* vrow = reinterpret_cast<const float4*>(v + row * block);

  float4 r[kVecPerThread];
  const float norm = load_row_norm(vrow, nvec, r, scratch);
  const float safe = norm > 0.0f ? norm : 1.0f;
  const uint32_t k0 = key[0], k1 = key[1];
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(block);
  char4* qrow = reinterpret_cast<char4*>(q + row * block);

#pragma unroll
  for (int t = 0; t < kVecPerThread; ++t) {
    const int i = threadIdx.x + t * kThreads;
    if (i < nvec) {
      uint32_t codes[4];
      quantize4(r[t], base + 4u * static_cast<uint32_t>(i), k0, k1, norm, safe, s, codes);
      qrow[i] = make_char4(static_cast<signed char>(static_cast<int>(codes[0]) - s),
                           static_cast<signed char>(static_cast<int>(codes[1]) - s),
                           static_cast<signed char>(static_cast<int>(codes[2]) - s),
                           static_cast<signed char>(static_cast<int>(codes[3]) - s));
    }
  }
  if (threadIdx.x == 0) norms[row] = norm;
}

// grid (rows); q (rows, block) int8; norms (rows,); out (rows, block) f32:
// q * (norm / s), in that order.
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ norms,
                  float* __restrict__ out, int block, int s) {
  const size_t row = blockIdx.x;
  const float scale = __fdiv_rn(norms[row], static_cast<float>(s));
  const char4* qrow = reinterpret_cast<const char4*>(q + row * block);
  float4* orow = reinterpret_cast<float4*>(out + row * block);
  for (int i = threadIdx.x; i < (block >> 2); i += kThreads) {
    const char4 c = qrow[i];
    orow[i] = make_float4(__fmul_rn(static_cast<float>(c.x), scale),
                          __fmul_rn(static_cast<float>(c.y), scale),
                          __fmul_rn(static_cast<float>(c.z), scale),
                          __fmul_rn(static_cast<float>(c.w), scale));
  }
}

}  // namespace

extern "C" int qsgd_quantize_pack(const float* v, const uint32_t* keys, uint32_t* payload,
                                  float* norms, int senders, int nb, int block, int s,
                                  int bits, void* stream) {
  if (senders > 0 && nb > 0) {
    quantize_pack_kernel<<<dim3(nb, senders), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(v, keys, payload, norms,
                                                                nb, block, s, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_unpack_dequantize(const uint32_t* payload, const float* norms, float* out,
                                      int rows, int block, int s, int bits, void* stream) {
  if (rows > 0) {
    unpack_dequantize_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        payload, norms, out, block, s, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_quantize(const float* v, const uint32_t* key, int8_t* q, float* norms,
                             int nb, int block, int s, void* stream) {
  if (nb > 0) {
    quantize_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(v, key, q, norms,
                                                                          block, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_dequantize(const int8_t* q, const float* norms, float* out, int rows,
                               int block, int s, void* stream) {
  if (rows > 0) {
    dequantize_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q, norms, out,
                                                                               block, s);
  }
  return static_cast<int>(cudaGetLastError());
}
