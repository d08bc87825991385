// Montgomery arithmetic on W x 32-bit words (R = 2^(32W)), as templates
// over W, instantiated at W = 8 (bn254 Fr/Fp, the stark curve), W = 10
// (bls24-315 Fp, bls24-317 Fp, bw6-633 Fr), W = 12 (bls12-381 Fp,
// bls12-377 Fp, bw6-761 Fr), W = 20 (bw6-633 Fp) and W = 24 (bw6-761 Fp).
// Every op here is exact for any odd q < R = 2^(32W): reduce_once takes the
// top word of a sum below 2q < 2R, the CIOS keeps its sum below 2q in W + 1
// words, the column product below 2q in its carry words, and at W = 8 that
// takes the 256-bit secp256k1/r1 moduli (2^255 <= q < 2^256). Which kernel
// admits which q the wrappers decide (field/kernels.py check_width): the
// field, exponent and G1 point kernels take q < 2^256 at 8 words, every
// other kernel and width q < 2^(32W-1).
//
// Shared by every kernel of this directory. Elements are canonical (< q),
// little-endian words, 4W bytes each, in (N, W) rows: one element is W/4
// 16-byte loads when W is a multiple of 4, else W/2 8-byte loads (a 40-byte
// 10-word row is only 8-byte aligned every second row). The product is a
// word-serial CIOS with 64-bit partial products: 2W^2 + W 32x32->64
// multiply-adds per product (W^2 for a*b, W^2 for m*q, W for m): 136 at
// W = 8, 210 at W = 10, 300 at W = 12, 820 at W = 20, 1,176 at W = 24.
// The CIOS is unrolled whole, except from the width GCT_ROLLED_CIOS_FROM
// up, where its outer loop over a's words stays rolled. A source whose
// kernels inline many products defines it before its includes
// (point_add.cu and affine_level.cu: 20). Unrolled at 20 and 24 words,
// their kernels spilled up to twice as much and ran up to 2.2x slower,
// while mont_mul.cu and vm.cu, one product in a kernel or a loop body,
// ran 1.4-1.5x faster unrolled (PERF.md).
#pragma once

#include <cstdint>
#include <type_traits>
#include <utility>
#include <cuda_runtime.h>

namespace gct {

template <int W>
struct FieldConstT {
  uint32_t q[W];
  uint32_t qinv;  // -q^-1 mod 2^32
};

// Host: q words followed by qinv, as the Python wrappers pass them.
template <int W>
inline FieldConstT<W> field_const(const uint32_t* words) {
  FieldConstT<W> fc;
  for (int i = 0; i < W; ++i) fc.q[i] = words[i];
  fc.qinv = words[W];
  return fc;
}

template <int W>
struct ElemT {
  static_assert(W % 2 == 0, "an element is whole 8-byte loads");
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ ElemT<W> load_elem(const uint32_t* p) {
  ElemT<W> e;
  if constexpr (W % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 a = __ldg(v + k);
      e.w[4 * k] = a.x;
      e.w[4 * k + 1] = a.y;
      e.w[4 * k + 2] = a.z;
      e.w[4 * k + 3] = a.w;
    }
  } else {
    const uint2* v = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const uint2 a = __ldg(v + k);
      e.w[2 * k] = a.x;
      e.w[2 * k + 1] = a.y;
    }
  }
  return e;
}

template <int W>
__device__ __forceinline__ void store_elem(uint32_t* p, const ElemT<W>& e) {
  if constexpr (W % 4 == 0) {
    uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
      v[k] = make_uint4(e.w[4 * k], e.w[4 * k + 1], e.w[4 * k + 2],
                        e.w[4 * k + 3]);
  } else {
    uint2* v = reinterpret_cast<uint2*>(p);
#pragma unroll
    for (int k = 0; k < W / 2; ++k)
      v[k] = make_uint2(e.w[2 * k], e.w[2 * k + 1]);
  }
}

// a + top*2^(32W) - q if that is >= 0, else a. Needs a + top*2^(32W) < 2q,
// so top is 0 or 1 for any q < 2^(32W); where top is 1 the value exceeds q
// and a - q wraps to a + 2^(32W) - q.
template <int W>
__device__ __forceinline__ ElemT<W> reduce_once(const ElemT<W>& a,
                                                uint32_t top,
                                                const FieldConstT<W>& fc) {
  ElemT<W> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - fc.q[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  return (top || !borrow) ? d : a;
}

template <int W>
__device__ __forceinline__ ElemT<W> add_mod(const ElemT<W>& a,
                                            const ElemT<W>& b,
                                            const FieldConstT<W>& fc) {
  ElemT<W> s;
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t t = (uint64_t)a.w[i] + b.w[i] + carry;
    s.w[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return reduce_once(s, carry, fc);
}

template <int W>
__device__ __forceinline__ ElemT<W> sub_mod(const ElemT<W>& a,
                                            const ElemT<W>& b,
                                            const FieldConstT<W>& fc) {
  ElemT<W> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  if (borrow) {
    uint32_t carry = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t t = (uint64_t)d.w[i] + fc.q[i] + carry;
      d.w[i] = (uint32_t)t;
      carry = (uint32_t)(t >> 32);
    }
  }
  return d;
}

// a / 2 mod q (q odd): (a + q) / 2 for odd a, a / 2 for even a, with the
// carry out of a + q shifted back in. Input < q; output canonical.
template <int W>
__device__ __forceinline__ ElemT<W> halve_mod(const ElemT<W>& a,
                                              const FieldConstT<W>& fc) {
  const uint32_t odd = a.w[0] & 1u;
  ElemT<W> t;
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t s = (uint64_t)a.w[i] + (odd ? fc.q[i] : 0u) + carry;
    t.w[i] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  ElemT<W> r;
#pragma unroll
  for (int i = 0; i < W - 1; ++i) r.w[i] = (t.w[i] >> 1) | (t.w[i + 1] << 31);
  r.w[W - 1] = (t.w[W - 1] >> 1) | (carry << 31);
  return r;
}

// The width from which the CIOS keeps its outer loop rolled (see the top).
#ifndef GCT_ROLLED_CIOS_FROM
#define GCT_ROLLED_CIOS_FROM 0x7fffffff
#endif

// One outer step of the CIOS: t = (t + ai * b + m * q) / 2^32 with
// m = (t + ai * b) * qinv mod 2^32; t has W + 2 words, the top two the
// carries.
template <int W>
__device__ __forceinline__ void cios_step(uint32_t ai, const ElemT<W>& b,
                                          const FieldConstT<W>& fc,
                                          uint32_t (&t)[W + 2]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t p = (uint64_t)ai * b.w[j] + t[j] + c;
    t[j] = (uint32_t)p;
    c = p >> 32;
  }
  uint64_t s = (uint64_t)t[W] + c;
  t[W] = (uint32_t)s;
  t[W + 1] = (uint32_t)(s >> 32);
  const uint32_t m = t[0] * fc.qinv;
  uint64_t p = (uint64_t)m * fc.q[0] + t[0];
  c = p >> 32;
#pragma unroll
  for (int j = 1; j < W; ++j) {
    p = (uint64_t)m * fc.q[j] + t[j] + c;
    t[j - 1] = (uint32_t)p;
    c = p >> 32;
  }
  s = (uint64_t)t[W] + c;
  t[W - 1] = (uint32_t)s;
  t[W] = t[W + 1] + (uint32_t)(s >> 32);
}

// a * b * 2^(-32W) mod q (CIOS). Inputs < q; output canonical.
template <int W>
__device__ __forceinline__ ElemT<W> mont_mul(const ElemT<W>& a,
                                             const ElemT<W>& b,
                                             const FieldConstT<W>& fc) {
  uint32_t t[W + 2];
#pragma unroll
  for (int i = 0; i < W + 2; ++i) t[i] = 0;
  if constexpr (W >= GCT_ROLLED_CIOS_FROM) {
    // a's words shift down one a step, so every index stays a constant and
    // a, b and t stay in registers
    ElemT<W> x = a;
#pragma unroll 1
    for (int i = 0; i < W; ++i) {
      const uint32_t ai = x.w[0];
#pragma unroll
      for (int k = 0; k + 1 < W; ++k) x.w[k] = x.w[k + 1];
      cios_step<W>(ai, b, fc, t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) cios_step<W>(a.w[i], b, fc, t);
  }
  ElemT<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = t[j];
  return reduce_once(r, t[W], fc);
}

template <int W>
__device__ __forceinline__ ElemT<W> sqr(const ElemT<W>& a,
                                        const FieldConstT<W>& fc) {
  return mont_mul(a, a, fc);
}

// The latency-short product, for the kernels that wait on one element's
// chain of products. mont_mul above threads one 64-bit carry through all
// 2W^2 multiply-adds, ~2 dependent instructions and ~9 cycles a
// multiply-add on the H100, ~3.5 instructions a multiply-add in all. Here
// the product is scanned by columns (Montgomery's FIPS order) into a fresh
// three-word accumulator a column, each multiply-add one PTX carry chain
// (mad.lo.cc, madc.hi.cc, addc): ~2 SASS instructions a multiply-add. ptxas
// keeps every instruction that touches the carry flag in program order, so
// the columns do not overlap and a multiply-add still costs ~8 cycles of
// latency (the same sums in plain C overlap but issue twice the
// instructions, and measured slower; PERF.md). Only the column's carry-in,
// the newest m's term and the next m = low word * qinv depend on the column
// before. The same canonical result as mont_mul, bit for bit.

// (c2:c1:c0) += x * y
__device__ __forceinline__ void mac3(uint32_t& c0, uint32_t& c1,
                                     uint32_t& c2, uint32_t x, uint32_t y) {
#ifdef __CUDA_ARCH__
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c0), "+r"(c1), "+r"(c2)
      : "r"(x), "r"(y));
#else
  const uint64_t p = (uint64_t)x * y + c0;
  const uint64_t s = (uint64_t)c1 + (p >> 32);
  c0 = (uint32_t)p;
  c1 = (uint32_t)s;
  c2 += (uint32_t)(s >> 32);
#endif
}

// (c2:c1:c0) += (y1:y0)
__device__ __forceinline__ void add3(uint32_t& c0, uint32_t& c1,
                                     uint32_t& c2, uint32_t y0,
                                     uint32_t y1) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c0), "+r"(c1), "+r"(c2)
      : "r"(y0), "r"(y1));
#else
  const uint64_t s0 = (uint64_t)c0 + y0;
  const uint64_t s1 = (uint64_t)c1 + y1 + (s0 >> 32);
  c0 = (uint32_t)s0;
  c1 = (uint32_t)s1;
  c2 += (uint32_t)(s1 >> 32);
#endif
}

// Column C of mont_mul_ilp: its bounds are constants of the template, so
// every loop unrolls and m stays in registers.
template <int W, int C>
__device__ __forceinline__ void ilp_column(const ElemT<W>& a,
                                           const ElemT<W>& b,
                                           const FieldConstT<W>& fc,
                                           uint32_t (&m)[W], ElemT<W>& r,
                                           uint32_t& cl, uint32_t& ch) {
  constexpr int lo = C < W ? 0 : C - W + 1;
  constexpr int hi = C < W ? C : W - 1;
  // every m's term but the newest (m_(C-1) q_1), which ends the chain
  constexpr int m_end = C < W ? C - 1 : W;
  uint32_t d0 = 0, d1 = 0, d2 = 0;
#pragma unroll
  for (int k = lo; k <= hi; ++k) mac3(d0, d1, d2, a.w[k], b.w[C - k]);
#pragma unroll
  for (int k = lo; k < m_end; ++k) mac3(d0, d1, d2, m[k], fc.q[C - k]);
  add3(d0, d1, d2, cl, ch);
  if constexpr (C < W) {
    if constexpr (C >= 1) mac3(d0, d1, d2, m[C - 1], fc.q[1]);
    m[C] = d0 * fc.qinv;
    mac3(d0, d1, d2, m[C], fc.q[0]);  // the low word becomes 0
  } else {
    r.w[C - W] = d0;
  }
  cl = d1;
  ch = d2;
}

template <int W, int... C>
__device__ __forceinline__ void ilp_columns(const ElemT<W>& a,
                                            const ElemT<W>& b,
                                            const FieldConstT<W>& fc,
                                            uint32_t (&m)[W], ElemT<W>& r,
                                            uint32_t& cl, uint32_t& ch,
                                            std::integer_sequence<int, C...>) {
  (ilp_column<W, C>(a, b, fc, m, r, cl, ch), ...);
}

// a * b * 2^(-32W) mod q by columns. Inputs < q; output canonical. A
// column sums at most 2W products below 2^64 and a two-word carry, so three
// words hold it.
template <int W>
__device__ __forceinline__ ElemT<W> mont_mul_ilp(const ElemT<W>& a,
                                                 const ElemT<W>& b,
                                                 const FieldConstT<W>& fc) {
  uint32_t m[W];
  ElemT<W> r;
  uint32_t cl = 0, ch = 0;  // carry into the column: (ch:cl)
  ilp_columns<W>(a, b, fc, m, r, cl, ch,
                 std::make_integer_sequence<int, 2 * W - 1>{});
  r.w[W - 1] = cl;
  return reduce_once(r, ch, fc);
}

// Field constants that select mont_mul_ilp: a kernel whose cores take them
// runs every product of those cores by columns; the other ops take them as
// FieldConstT<W>.
template <int W>
struct IlpFieldConstT : FieldConstT<W> {};

template <int W>
inline IlpFieldConstT<W> ilp_field_const(const uint32_t* words) {
  return {field_const<W>(words)};
}

template <int W>
__device__ __forceinline__ ElemT<W> mont_mul(const ElemT<W>& a,
                                             const ElemT<W>& b,
                                             const IlpFieldConstT<W>& fc) {
  return mont_mul_ilp(a, b, fc);
}

template <int W>
__device__ __forceinline__ ElemT<W> sqr(const ElemT<W>& a,
                                        const IlpFieldConstT<W>& fc) {
  return mont_mul_ilp(a, a, fc);
}

// Host: f(std::integral_constant<int, W>{}) for the width n_words, one of
// the instantiated widths; any other width returns cudaErrorInvalidValue,
// and the wrapper raises on it.
template <class F>
inline int for_width(int n_words, F&& f) {
  switch (n_words) {
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 10:
      return f(std::integral_constant<int, 10>{});
    case 12:
      return f(std::integral_constant<int, 12>{});
    case 20:
      return f(std::integral_constant<int, 20>{});
    case 24:
      return f(std::integral_constant<int, 24>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gct
