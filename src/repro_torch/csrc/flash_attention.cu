// Causal / sliding-window GQA flash-attention forward for Hopper (sm_90a),
// on the tensor cores.  Plain C interface, loaded with ctypes by
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
// head) strides with the head dim contiguous; every row must start on 16
// bytes (the wrapper copies a view that does not); the ragged T and S edges
// are masked here.
//
// What bounds it on an H100: operations.  At the LM path's shape (B 4,
// T = S = 512, H 16, Hkv 8, hd 128) the causal work is about 4.3 GFLOP
// against about 50 MB in f32.  Both products run on the tensor cores:
//   * bf16: wgmma.  One warpgroup owns 64 query rows.  S = Q.K^T is an
//     m64n64k16 wgmma with both operands in shared memory, K-major (hd
//     contiguous).  P is rounded to bf16 in registers and is the register A
//     operand of O += P.V, whose B operand is the V tile read MN-major (the
//     transpose flag that 16-bit types allow), so P never touches shared
//     memory.  Tiles sit in shared memory in the 128-byte swizzle the
//     descriptors name: rows of 64 head columns, 16-byte chunk i of row r at
//     chunk i ^ (r % 8).
//   * f32: split TF32 ("3xTF32") with mma.sync.m16n8k8.  Each operand is
//     split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (rounded as
//     cvt.rna.tf32.f32 rounds, with an integer add and mask), and
//     every product accumulates lo.hi + hi.lo, then hi.hi, into f32: the
//     error stays at f32 level (plain TF32 keeps about three digits).  Why
//     mma.sync and not wgmma here: wgmma reads B from shared memory, so hi
//     and lo of every K and V tile would need copies there (and V a
//     transposed one, since tf32 wgmma takes K-major operands only), more
//     than 227 KB at hd 128 with a two-stage ring.  mma.sync takes its
//     fragments from registers, so the split happens as they are loaded.
//     The k order of both products is permuted (fragment position c holds
//     column 2c, position c + 4 column 2c + 1, in A and B alike), so that Q
//     and K fragments load as float2 and the S accumulator is already P's A
//     fragment.  Q is scaled in f32 before the split, in the reference's
//     order.  8 warps own 128 query rows at hd <= 128; 4 warps own 64 rows,
//     with 32-key tiles, above it.
//   * K and V tiles stream through a two-stage ring in shared memory with
//     16-byte cp.async copies (zero-filled past S), so the next tile loads
//     while this one computes.  f32 rows are padded (Q and K by 8 floats, V
//     by 4) so the fragment loads hit distinct banks.
//   * The online softmax runs on the accumulator fragments: a thread holds
//     rows g and g + 8 of its warp's 16, and the row max and sum need only
//     shuffles among the four lanes of a row.  Masks are evaluated only on
//     tiles that cross an edge, the diagonal or the window.
//   * Tiles wholly above the diagonal or before the window are skipped, and
//     query tiles are issued longest first (reverse causal order), so the
//     last wave is short.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>


namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, t, h;  // element strides of the batch, sequence and head dims
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, Tq, S, causal, window;
  float scale;
  Strides qs, ks, vs, os;
};

// ---------------------------------------------------------------------------
// tile shapes and shared-memory layouts
// ---------------------------------------------------------------------------

template <typename T, int HD>
struct Cfg;

template <int HD>
struct Cfg<float, HD> {
  static constexpr int BQ = HD <= 128 ? 128 : 64;
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int kThreads = BQ * 2;  // a warp per 16 query rows
  static constexpr int QLD = HD + 8, KLD = HD + 8, VLD = HD + 4;
  static constexpr int kQ = BQ * QLD, kK = BK * KLD, kV = BK * VLD;  // floats
  static constexpr size_t kSmem = sizeof(float) * (kQ + 2 * kK + 2 * kV);
};

template <int HD>
struct Cfg<__nv_bfloat16, HD> {
  static constexpr int BQ = 64, BK = 64, kThreads = 128;  // one warpgroup
  static constexpr int kPanels = (HD + 63) / 64;           // 64 head columns each
  static constexpr int kQ = BQ * 128 * kPanels, kK = BK * 128 * kPanels;  // bytes
  static constexpr size_t kSmem = 1024 + kQ + 4 * static_cast<size_t>(kK);
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to TF32 (10 stored mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds, but with an integer add and mask on the
// full-rate pipes: with the cvt the f32 kernel took 0.148 ms at the LM
// path's shape, with this 0.128 ms (H100 80GB HBM3, 700 W)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (a_hi + a_lo)(b_hi + b_lo) without the lo.lo term, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split(b0, b0h, b0l);
  split(b1, b1h, b1l);
  mma_tf32(d, alo, b0h, b1h);
  mma_tf32(d, ahi, b0l, b1l);
  mma_tf32(d, ahi, b0h, b1h);
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_F8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d(64x64) (+)= A(smem, K-major) . B(smem, K-major), bf16 in, f32 out
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "l"(da), "l"(db), "r"(accum));
}

// d(64x64) += A(registers) . B(smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d(64x32) += A(registers) . B(smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : WG_F8(d, 0), WG_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef WG_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// tile loads: rows [r0, r0 + ROWS) of a (seq, HD) slice, zero past `limit`
// ---------------------------------------------------------------------------

// f32: row-major with a padded stride of LD floats
template <int ROWS, int HD, int LD, int NTHREADS>
__device__ __forceinline__ void load_f32(float* dst, const float* src, long long st, int r0,
                                         int limit) {
  constexpr int kChunks = HD / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool in = r0 + r < limit;
    const float* s = in ? src + (r0 + r) * st + 4 * ch : src;
    cp_async16(smem_u32(dst + r * LD + 4 * ch), s, in);
  }
}

// bf16: panels of 64 head columns, each row 128 bytes, 16-byte chunks swizzled
template <int ROWS, int HD, int NTHREADS>
__device__ __forceinline__ void load_bf16(unsigned char* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int limit) {
  constexpr int kChunks = HD / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool in = r0 + r < limit;
    const __nv_bfloat16* s = in ? src + (r0 + r) * st + 8 * ch : src;
    const int off = (ch >> 3) * ROWS * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
    cp_async16(smem_u32(dst + off), s, in);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// grid (B * H, ceil(Tq / BQ)); q (B, Tq, H, HD), k / v (B, S, Hkv, HD),
// o (B, Tq, H, HD).  window <= 0: no window.
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ Params p) {
  using C = Cfg<T, HD>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = BK / 8, NO = HD / 8;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ unsigned char smem_raw[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int q0w = q0 + 16 * warp;                     // this warp's first row
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h;

  // keys no row of this tile can see: past the diagonal, before the window
  const int q_last = min(q0 + BQ, p.Tq) - 1;
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_first / BK, t_end = (k_end + BK - 1) / BK;

  // shared memory
  float *Qf = nullptr, *Kf[2] = {nullptr, nullptr}, *Vf[2] = {nullptr, nullptr};
  unsigned char *Qb = nullptr, *Kb[2] = {nullptr, nullptr}, *Vb[2] = {nullptr, nullptr};
  if constexpr (kF32) {
    float* base = reinterpret_cast<float*>(smem_raw);
    Qf = base;
    Kf[0] = Qf + C::kQ;
    Kf[1] = Kf[0] + C::kK;
    Vf[0] = Kf[1] + C::kK;
    Vf[1] = Vf[0] + C::kV;
  } else {
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    Qb = base;
    Kb[0] = Qb + C::kQ;
    Kb[1] = Kb[0] + C::kK;
    Vb[0] = Kb[1] + C::kK;
    Vb[1] = Vb[0] + C::kK;
  }

  auto load_kv = [&](int stage, int t) {
    if constexpr (kF32) {
      load_f32<BK, HD, C::KLD, C::kThreads>(Kf[stage], kb, p.ks.t, t * BK, p.S);
      load_f32<BK, HD, C::VLD, C::kThreads>(Vf[stage], vb, p.vs.t, t * BK, p.S);
    } else {
      load_bf16<BK, HD, C::kThreads>(Kb[stage], kb, p.ks.t, t * BK, p.S);
      load_bf16<BK, HD, C::kThreads>(Vb[stage], vb, p.vs.t, t * BK, p.S);
    }
    cp_async_commit();
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  if (t_begin < t_end) {
    if constexpr (kF32)
      load_f32<BQ, HD, C::QLD, C::kThreads>(Qf, qb, p.qs.t, q0, p.Tq);
    else
      load_bf16<BQ, HD, C::kThreads>(Qb, qb, p.qs.t, q0, p.Tq);
    load_kv(0, t_begin);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1, k0 = t * BK;
    if (t + 1 < t_end) {
      load_kv(stage ^ 1, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (!kF32) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // f32: a warp whose 16 rows see no key of this tile (above the diagonal,
    // before the window, past Tq) skips it; such a tile would add exp(-1e30 -
    // m) = 0 to every row that has seen a key.  bf16's wgmma is issued by
    // the whole warpgroup, which always has work here.
    if constexpr (kF32) {
      if ((p.causal && k0 > q0w + 15) || (p.window > 0 && k0 + BK - 1 <= q0w - p.window) ||
          q0w >= p.Tq) {
        __syncthreads();
        continue;
      }
    }

    // ---- S = Q K^T (scaled) ----
    float s[NT][4];
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* qw = Qf + 16 * warp * C::QLD;
      const float* ks = Kf[stage];
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float2 top = *reinterpret_cast<const float2*>(qw + g * C::QLD + 8 * kk + 2 * c);
        const float2 bot =
            *reinterpret_cast<const float2*>(qw + (g + 8) * C::QLD + 8 * kk + 2 * c);
        uint32_t ahi[4], alo[4];
        split(top.x * p.scale, ahi[0], alo[0]);
        split(bot.x * p.scale, ahi[1], alo[1]);
        split(top.y * p.scale, ahi[2], alo[2]);
        split(bot.y * p.scale, ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 kv =
              *reinterpret_cast<const float2*>(ks + (8 * j + g) * C::KLD + 8 * kk + 2 * c);
          mma_3xtf32(s[j], ahi, alo, kv.x, kv.y);
        }
      }
    } else {
      const uint32_t qa = smem_u32(Qb), ka = smem_u32(Kb[stage]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
        wgmma_ss_n64(&s[0][0], desc_sw128(qa + off, 16, 1024),
                     desc_sw128(ka + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<NT * 4>(&s[0][0]);
      // bf16 works in base 2: scores times scale * log2(e), then exp2 (one
      // multiply fewer per exponential than expf)
      const float scale2 = p.scale * 1.4426950408889634f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }

    // ---- masks, only where the tile crosses an edge, the diagonal or the window ----
    const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > q0w) ||
                      (p.window > 0 && k0 <= q0w + 15 - p.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0w + g + (e >> 1) * 8, kp = k0 + 8 * j + 2 * c + (e & 1);
          bool keep = kp < p.S;
          if (p.causal) keep = keep && kp <= qp;
          if (p.window > 0) keep = keep && kp > qp - p.window;
          if (!keep) s[j][e] = kNegInf;
        }
    }

    // ---- online softmax on the fragments: rows g (e 0, 1) and g + 8 (e 2, 3) ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = kF32 ? expf(m[i] - m_new) : exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * i] = kF32 ? expf(s[j][2 * i] - m_new) : exp2f(s[j][2 * i] - m_new);
        s[j][2 * i + 1] = kF32 ? expf(s[j][2 * i + 1] - m_new) : exp2f(s[j][2 * i + 1] - m_new);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * i] *= corr;
        o[j][2 * i + 1] *= corr;
      }
    }

    // ---- O += P V ----
    if constexpr (kF32) {
      const float* vs = Vf[stage];
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        // A position c is key 2c, position c + 4 key 2c + 1 (see the note)
        uint32_t ahi[4], alo[4];
        split(s[kt][0], ahi[0], alo[0]);
        split(s[kt][2], ahi[1], alo[1]);
        split(s[kt][1], ahi[2], alo[2]);
        split(s[kt][3], ahi[3], alo[3]);
        const float* v0 = vs + (8 * kt + 2 * c) * C::VLD + g;
#pragma unroll
        for (int jn = 0; jn < NO; ++jn)
          mma_3xtf32(o[jn], ahi, alo, v0[8 * jn], v0[C::VLD + 8 * jn]);
      }
    } else {
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int kt = 0; kt < NT / 2; ++kt) {
        pa[kt][0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        pa[kt][1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        pa[kt][2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        pa[kt][3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      }
      const uint32_t va = smem_u32(Vb[stage]);
      fence_regs<NO * 4>(&o[0][0]);
      wgmma_fence();
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn) {
#pragma unroll
        for (int kt = 0; kt < NT / 2; ++kt) {
          // MN-major: 8-key groups 1024 bytes apart (SBO); 64-column panels
          // (LBO) are never crossed by one n64 or n32 product
          const uint64_t dv = desc_sw128(va + pn * (BK * 128) + kt * 16 * 128, BK * 128, 1024);
          if (64 * pn + 64 <= HD)
            wgmma_rs_n64(&o[8 * pn][0], pa[kt], dv);
          else
            wgmma_rs_n32(&o[8 * pn][0], pa[kt], dv);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<NO * 4>(&o[0][0]);
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  T* ob = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0w + g + 8 * i;
    if (row < p.Tq) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = ob + row * p.os.t + 2 * c;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const float x = o[j][2 * i] / denom, y = o[j][2 * i + 1] / denom;
        if constexpr (kF32)
          *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(x, y);
      }
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * p.H, (p.Tq + C::BQ - 1) / C::BQ);
  flash_fwd_kernel<T, HD><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const Params& p, int B, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 96: return launch<T, 96>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 160: return launch<T, 160>(p, B, stream);
    case 192: return launch<T, 192>(p, B, stream);
    case 224: return launch<T, 224>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16.  Strides are in elements; the head dim is contiguous
// and every row starts on 16 bytes.  Returns 0, a cudaError_t, or -1 for an
// unsupported dtype or head dim.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int Hkv, int Tq, int S, int hd,
                                   long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   long long o_sb, long long o_st, long long o_sh, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const Params p{q, k, v, o, H, Hkv, Tq, S, causal, window, scale,
                 Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                 Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, p, B, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, p, B, st);
  return -1;
}
