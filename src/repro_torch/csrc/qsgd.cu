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
//   * quantize -> pack: one warp owns a block row, and a persistent grid of
//     warps walks over the rows of every sender of the leaf (one launch).
//     Lane k holds the W = block/32 contiguous entries k*W .. k*W + W - 1 in
//     registers (float4 loads), so register w of lane k is code k*W + w and
//     one __ballot_sync over register w is word w of a bit plane: exactly
//     the reference's bit layout, with no shared memory and no
//     __syncthreads (the norm is a warp-shuffle sum).  Each warp loads the
//     next row before it quantizes and packs this one, so a row's bytes
//     stay in flight while it computes; lane w keeps word w of each plane
//     and the warp stores the plane with one coalesced store.  The kernel
//     is built for each code width at W = 32 (block 1024, the channels'
//     default and the only block the model paths use); every other block
//     takes a two-pass warp-per-row kernel, which handles any W;
//   * unpack -> dequantize: the same persistent grid of a warp per row, the
//     other way round.  At W = 32 lane l writes the float4s l + 32t, whose
//     codes are bits 4t + l/8 of words 4(l%8) .. 4(l%8) + 3 of each plane:
//     one 16-byte load a plane (the warp reads the row's payload once), the
//     planes' bits gathered into a nibble per code by rotates and masks,
//     each value made from its code's byte without a conversion, and each
//     float4 stored coalesced (512 B a warp instruction).  No shared memory,
//     no __syncthreads.  It is built for each code width at block 1024;
//     every other block takes a kernel in which lane k decodes the W
//     entries k*W .. k*W + W - 1 from broadcast loads of the words.
// The dense-code quantizer is one CTA per row, a row pass without the pack:
// it stores each thread's four codes as one char4, and its dither index is
// the flat index of the whole padded message (one key per call, as the
// reference's ops.qsgd_quantize draws it).
//
// Rounding: every float operation of a code is an explicit round-to-nearest
// intrinsic in the reference's order ((|v| / norm) * s, then + u;
// (c - s) * (norm / s)), so no FMA contraction changes a code.  Never build
// with fast math.  The norm's sum of squares is the exception: its order is
// not the reference's, and the two packing kernels sum differently (the
// register kernel with four fused partial sums per lane, the two-pass kernel
// with a multiply and an add per entry), so on inputs whose squares do not
// add exactly their norms differ from the reference's, and from each other,
// by rounding (held at rtol 1e-6); on dyadic inputs every sum is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 4096;
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

// The code c = s + sign(x) * q, q = clip(floor(|x| / norm * s + u), 0, s)
// (0 where the norm is not positive), with u = half / 65536.  Every float
// operation rounds as the reference's does; the steps around them use the
// full-rate pipes instead of conversions (I2F, FRND, F2I run at a quarter
// of the rate, and one entry needed three):
//   * u: the float with bits 1.0f | half << 7 is 1 + half/65536 exactly, and
//     subtracting 1 is exact;
//   * floor: t lies in [0, s + 1) (fmaxf also sends NaN to 0, as the
//     reference's clip does), so t + 2^23 rounded down is 2^23 + floor(t),
//     whose low mantissa bits are the integer;
//   * hi = s where the norm is positive and 0 where it is not: one clamp;
//   * sign: m = -1 for a set sign bit, and (q ^ m) - m is -q (q is 0 for
//     -0.0 and NaN, as the reference's 0).
__device__ __forceinline__ uint32_t quantize_one(float x, uint32_t half, float safe, int s,
                                                 int hi) {
  const float u = __fadd_rn(__uint_as_float(0x3F800000u | (half << 7)), -1.0f);
  const float p = __fmul_rn(__fdiv_rn(fabsf(x), safe), static_cast<float>(s));
  const float t = fmaxf(__fadd_rn(p, u), 0.0f);
  const int q = min(static_cast<int>(__float_as_uint(__fadd_rd(t, 8388608.0f)) - 0x4B000000u),
                    hi);
  const int m = static_cast<int>(__float_as_uint(x)) >> 31;
  return static_cast<uint32_t>(s + ((q ^ m) - m));
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
                                          uint32_t k1, float safe, int s, int hi,
                                          uint32_t (&codes)[4]) {
  const uint32_t h0 = dither_word(g >> 1, k0, k1);
  const uint32_t h1 = dither_word((g >> 1) + 1u, k0, k1);
  codes[0] = quantize_one(x.x, h0 & 0xFFFFu, safe, s, hi);
  codes[1] = quantize_one(x.y, h0 >> 16, safe, s, hi);
  codes[2] = quantize_one(x.z, h1 & 0xFFFFu, safe, s, hi);
  codes[3] = quantize_one(x.w, h1 >> 16, safe, s, hi);
}

// ---------------------------------------------------------------------------
// quantize -> pack: one warp owns a row, and a persistent grid of warps walks
// over the rows of every sender.  Lane k holds the W = block / 32 contiguous
// entries k*W .. k*W + W - 1, so register w of lane k is code k*W + w, and
// one __ballot_sync over register w gives word w of a bit plane in the
// reference's layout: no shared memory, no __syncthreads.
// ---------------------------------------------------------------------------

constexpr int kPackWarps = 4;  // warps per CTA of the packing kernels

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// __ballot_sync of (x & bit) != 0, written so that the predicate is one
// and-test of the register (the compiler's own form shifts, masks, compares)
__device__ __forceinline__ uint32_t ballot_bit(uint32_t x, uint32_t bit) {
  uint32_t r;
  asm volatile("{\n.reg .pred p;\n.reg .b32 t;\nand.b32 t, %1, %2;\nsetp.ne.b32 p, t, 0;\n"
      "vote.sync.ballot.b32 %0, p, 0xffffffff;\n}\n"
      : "=r"(r)
      : "r"(x), "r"(bit));
  return r;
}

template <int NV>
__device__ __forceinline__ void load_lane(const float4* __restrict__ src, float4 (&r)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) r[i] = __ldg(src + i);
}

// W = 4 NV words per plane (block 128 NV; launched at NV = 8).  The next row's
// float4s are loaded before this row is quantized and packed, so each warp
// keeps a row's bytes in flight while it computes.
template <int NV, int BITS>
__global__ void __launch_bounds__(32 * kPackWarps)
quantize_pack_regs_kernel(const float* __restrict__ v, const uint32_t* __restrict__ keys,
                          uint32_t* __restrict__ payload, float* __restrict__ norms,
                          int nb, int senders, int s) {
  constexpr int W = 4 * NV, block = 32 * W;
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(nb) * senders;
  const long long step = static_cast<long long>(gridDim.x) * kPackWarps;
  long long row_id = static_cast<long long>(blockIdx.x) * kPackWarps + (threadIdx.x >> 5);
  const float4* lane_src = reinterpret_cast<const float4*>(v) + lane * NV;
  float4 r[NV];
  if (row_id < rows) load_lane<NV>(lane_src + row_id * (block / 4), r);
  for (; row_id < rows; row_id += step) {
    float4 x[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) x[i] = r[i];
    if (row_id + step < rows) load_lane<NV>(lane_src + (row_id + step) * (block / 4), r);

    // four partial sums (one per float4 lane) shorten the dependent chain;
    // fused multiply-adds (the norm's order is not the reference's anyway,
    // and on dyadic entries every square and sum is exact)
    float ax = 0.0f, ay = 0.0f, az = 0.0f, aw = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      ax = __fmaf_rn(x[i].x, x[i].x, ax);
      ay = __fmaf_rn(x[i].y, x[i].y, ay);
      az = __fmaf_rn(x[i].z, x[i].z, az);
      aw = __fmaf_rn(x[i].w, x[i].w, aw);
    }
    const float norm = __fsqrt_rn(warp_sum(__fadd_rn(__fadd_rn(ax, ay), __fadd_rn(az, aw))));
    const float safe = norm > 0.0f ? norm : 1.0f;
    const int hi = norm > 0.0f ? s : 0;  // codes' top level: none without a norm
    const uint32_t sender = static_cast<uint32_t>(row_id) / static_cast<uint32_t>(nb);
    const uint32_t row = static_cast<uint32_t>(row_id) - sender * static_cast<uint32_t>(nb);
    const uint32_t k0 = keys[2 * sender], k1 = keys[2 * sender + 1];
    // flat leaf index of this lane's first entry (even: W is a multiple of 4)
    const uint32_t base = row * static_cast<uint32_t>(block) + static_cast<uint32_t>(lane * W);

    // The codes first, four to a register (8 bits each), then the ballots.
    // The division's rare slow path is a branch, and the compiler wraps a
    // __ballot_sync that may follow divergence in a warp-sync sequence of a
    // dozen instructions; after __syncwarp the inline vote is one VOTE.
    uint32_t packed[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      uint32_t c4[4];
      quantize4(x[i], base + 4u * i, k0, k1, safe, s, hi, c4);
      packed[i] = c4[0] | (c4[1] << 8) | (c4[2] << 16) | (c4[3] << 24);
    }
    __syncwarp();

    // word w of plane j = ballot of bit j of code w; lane w keeps it, and the
    // warp stores each plane's W words with one coalesced store
    uint32_t mine[BITS];
#pragma unroll
    for (int j = 0; j < BITS; ++j) mine[j] = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const bool keep = lane == w;
#pragma unroll
      for (int j = 0; j < BITS; ++j) {
        const uint32_t word = ballot_bit(packed[w >> 2], 1u << (8 * (w & 3) + j));
        mine[j] = keep ? word : mine[j];
      }
    }
    uint32_t* out = payload + row_id * static_cast<long long>(BITS * W);
#pragma unroll
    for (int j = 0; j < BITS; ++j)
      if (lane < W) out[j * W + lane] = mine[j];
    if (lane == 0) norms[row_id] = norm;
  }
}

// Any W in [1, 128] (block 32 .. 4096): the same warp per row in two passes
// over the row, the norm from coalesced loads, then one entry per lane and
// word, its dither half picked from the entry's own word.
__global__ void __launch_bounds__(32 * kPackWarps)
quantize_pack_any_kernel(const float* __restrict__ v, const uint32_t* __restrict__ keys,
                         uint32_t* __restrict__ payload, float* __restrict__ norms, int nb,
                         int senders, int block, int s, int bits) {
  const int lane = threadIdx.x & 31, W = block >> 5;
  const long long rows = static_cast<long long>(nb) * senders;
  const long long step = static_cast<long long>(gridDim.x) * kPackWarps;
  for (long long row_id = static_cast<long long>(blockIdx.x) * kPackWarps + (threadIdx.x >> 5);
       row_id < rows; row_id += step) {
    const float* vrow = v + row_id * block;
    float acc = 0.0f;
    for (int e = lane; e < block; e += 32) acc = __fadd_rn(acc, __fmul_rn(vrow[e], vrow[e]));
    const float norm = __fsqrt_rn(warp_sum(acc));
    const float safe = norm > 0.0f ? norm : 1.0f;
    const int hi = norm > 0.0f ? s : 0;  // codes' top level: none without a norm
    const int sender = static_cast<int>(row_id / nb), row = static_cast<int>(row_id % nb);
    const uint32_t k0 = keys[2 * sender], k1 = keys[2 * sender + 1];
    uint32_t* out = payload + row_id * static_cast<long long>(bits * W);
    for (int w = 0; w < W; ++w) {
      const int e = lane * W + w;
      const uint32_t g = static_cast<uint32_t>(row) * static_cast<uint32_t>(block) +
                         static_cast<uint32_t>(e);
      const uint32_t h = dither_word(g >> 1, k0, k1);
      uint32_t code = quantize_one(vrow[e], (g & 1u) ? h >> 16 : h & 0xFFFFu, safe, s, hi);
      for (int j = 0; j < bits; ++j) {
        const uint32_t word = __ballot_sync(0xffffffffu, code & 1u);
        code >>= 1;
        if (lane == ((j * W + w) & 31)) out[j * W + w] = word;
      }
    }
    if (lane == 0) norms[row_id] = norm;
  }
}

// ---------------------------------------------------------------------------
// unpack -> dequantize: the packing kernels' shape, inverted.  One warp owns a
// row, a persistent grid of warps walks over the rows of every sender, and a
// row needs no shared memory and no __syncthreads.
// ---------------------------------------------------------------------------

// (c - s) * scale from the code's bits, without I2F: the float with bits
// 0x4B000000 | c is 2^23 + c, and subtracting offset = 2^23 + s is exact for
// codes below 2^23, so the product is the reference's (c - s) * (norm / s).
__device__ __forceinline__ float dequantize_bits(uint32_t float_bits, float offset,
                                                 float scale) {
  return __fmul_rn(__fsub_rn(__uint_as_float(float_bits), offset), scale);
}

// Block 1024 (W = 32).  Lane l writes the float4s l + 32t (t = 0..7), the
// entries 128t + 4l + c: codes k = 4t + l/8 of words w = 4(l%8) + c (c = 0..3).
// So the lane needs words 4(l%8) .. 4(l%8) + 3 of each plane, one 16-byte
// load a plane (8 distinct chunks a warp, each row's payload read once), and
// bit 4t + l/8 of each.  (Loading the next row's words before decoding this
// one measured no faster and held more registers.)
template <int BITS>
__device__ __forceinline__ void load_planes(const uint4* __restrict__ src, uint4 (&r)[BITS]) {
#pragma unroll
  for (int j = 0; j < BITS; ++j) r[j] = __ldg(src + 8 * j);
}

__device__ __forceinline__ uint32_t word_of(const uint4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

template <int BITS>
__global__ void __launch_bounds__(32 * kPackWarps)
unpack_dequantize_regs_kernel(const uint32_t* __restrict__ payload,
                              const float* __restrict__ norms, float* __restrict__ out,
                              long long rows, int s) {
  constexpr int kRowVec = BITS * 8;  // uint4s of payload per row
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kPackWarps;
  const uint4* lane_src = reinterpret_cast<const uint4*>(payload) + (lane & 7);
  // rotating word w right by (l/8 - j) & 31 brings bit 4t + l/8 to 4t + j:
  // bit j of code t sits in nibble t
  const uint32_t sh = static_cast<uint32_t>(lane >> 3);
  const float offset = __fadd_rn(8388608.0f, static_cast<float>(s));
  const float fs = static_cast<float>(s);
  for (long long row_id = static_cast<long long>(blockIdx.x) * kPackWarps + (threadIdx.x >> 5);
       row_id < rows; row_id += step) {
    uint4 x[BITS];
    load_planes<BITS>(lane_src + row_id * kRowVec, x);
    const float scale = __fdiv_rn(__ldg(norms + row_id), fs);
    float4* orow = reinterpret_cast<float4*>(out + row_id * 1024) + lane;
    // per word column c: lo holds bits 0..3 and hi bits 4..7 of code t in
    // nibble t; then byte b of even (odd) is code t = 2b (2b + 1)
    uint32_t even[4], odd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < BITS; ++j) {
        const uint32_t w = word_of(x[j], c);
        const uint32_t bit = __funnelshift_r(w, w, (sh - (j & 3)) & 31u) & (0x11111111u << (j & 3));
        if (j < 4) lo |= bit; else hi |= bit;
      }
      even[c] = (lo & 0x0F0F0F0Fu) | ((hi << 4) & 0xF0F0F0F0u);
      odd[c] = ((lo >> 4) & 0x0F0F0F0Fu) | (hi & 0xF0F0F0F0u);
    }
    // byte b of a word, over the bytes 0x00, 0x00, 0x4B: the bits of 2^23 + c
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t z = (t & 1) ? odd[c] : even[c];
        v[c] = dequantize_bits(__byte_perm(z, 0x4B000000u, 0x7540u | (t >> 1)), offset, scale);
      }
      orow[32 * t] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Any W in [1, 128] (block 32 .. 4096): the same warp per row.  Lane k decodes
// the entries k*W .. k*W + W - 1, codes k*W + w: bit k of word w of each plane,
// each word a broadcast load.
__global__ void __launch_bounds__(32 * kPackWarps)
unpack_dequantize_any_kernel(const uint32_t* __restrict__ payload,
                             const float* __restrict__ norms, float* __restrict__ out,
                             long long rows, int block, int s, int bits) {
  const int lane = threadIdx.x & 31, W = block >> 5;
  const float offset = __fadd_rn(8388608.0f, static_cast<float>(s));
  const float fs = static_cast<float>(s);
  const long long step = static_cast<long long>(gridDim.x) * kPackWarps;
  for (long long row_id = static_cast<long long>(blockIdx.x) * kPackWarps + (threadIdx.x >> 5);
       row_id < rows; row_id += step) {
    const uint32_t* in = payload + row_id * static_cast<long long>(bits * W);
    const float scale = __fdiv_rn(__ldg(norms + row_id), fs);
    float* orow = out + row_id * static_cast<long long>(block) + lane * W;
    for (int w = 0; w < W; ++w) {
      uint32_t code = 0;
      for (int j = 0; j < bits; ++j) code |= ((__ldg(in + j * W + w) >> lane) & 1u) << j;
      orow[w] = dequantize_bits(0x4B000000u | code, offset, scale);
    }
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
  const int hi = norm > 0.0f ? s : 0;  // codes' top level: none without a norm
  const uint32_t k0 = key[0], k1 = key[1];
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(block);
  char4* qrow = reinterpret_cast<char4*>(q + row * block);

#pragma unroll
  for (int t = 0; t < kVecPerThread; ++t) {
    const int i = threadIdx.x + t * kThreads;
    if (i < nvec) {
      uint32_t codes[4];
      quantize4(r[t], base + 4u * static_cast<uint32_t>(i), k0, k1, safe, s, hi, codes);
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

// A persistent grid: as many CTAs as fit on the card at once, or fewer when
// the rows run out.
template <typename Kernel>
int pack_grid(Kernel kernel, long long rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kPackWarps, 0);
  const long long want = (rows + kPackWarps - 1) / kPackWarps;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(want < fit ? want : fit);
}

extern "C" int qsgd_quantize_pack(const float* v, const uint32_t* keys, uint32_t* payload,
                                  float* norms, int senders, int nb, int block, int s,
                                  int bits, void* stream) {
  if (senders <= 0 || nb <= 0) return static_cast<int>(cudaGetLastError());
  const long long rows = static_cast<long long>(senders) * nb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kT = 32 * kPackWarps;
  if (bits < 2 || bits > kMaxBits) return static_cast<int>(cudaErrorInvalidValue);
  // the register kernel at block 1024 (the channels' default) for each code
  // width; every other block goes to the two-pass kernel
  if (block == 1024) {
    switch (bits) {
#define QSGD_PACK(BITS)                                                                    \
  case BITS: {                                                                             \
    auto* k = quantize_pack_regs_kernel<8, BITS>;                                          \
    k<<<pack_grid(k, rows), kT, 0, st>>>(v, keys, payload, norms, nb, senders, s);         \
    break;                                                                                 \
  }
      QSGD_PACK(2) QSGD_PACK(3) QSGD_PACK(4) QSGD_PACK(5) QSGD_PACK(6) QSGD_PACK(7) QSGD_PACK(8)
#undef QSGD_PACK
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    auto* k = quantize_pack_any_kernel;
    k<<<pack_grid(k, rows), kT, 0, st>>>(v, keys, payload, norms, nb, senders, block, s,
                                         bits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_unpack_dequantize(const uint32_t* payload, const float* norms, float* out,
                                      int rows, int block, int s, int bits, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (bits < 2 || bits > kMaxBits) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kT = 32 * kPackWarps;
  // the register kernel at block 1024 for each code width (its rows are read
  // and written in 16-byte pieces); every other block goes to the any-W kernel
  if (block == 1024) {
    if (reinterpret_cast<uintptr_t>(payload) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    switch (bits) {
#define QSGD_UNPACK(BITS)                                                                  \
  case BITS: {                                                                             \
    auto* k = unpack_dequantize_regs_kernel<BITS>;                                         \
    k<<<pack_grid(k, rows), kT, 0, st>>>(payload, norms, out, rows, s);                    \
    break;                                                                                 \
  }
      QSGD_UNPACK(2) QSGD_UNPACK(3) QSGD_UNPACK(4) QSGD_UNPACK(5) QSGD_UNPACK(6)
      QSGD_UNPACK(7) QSGD_UNPACK(8)
#undef QSGD_UNPACK
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    auto* k = unpack_dequantize_any_kernel;
    k<<<pack_grid(k, rows), kT, 0, st>>>(payload, norms, out, rows, block, s, bits);
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
