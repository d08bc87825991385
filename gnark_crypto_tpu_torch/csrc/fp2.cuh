// Fp2 = Fp[u] / (u^2 - NR) on W-word Montgomery coefficients: the fields of
// the G2 twists (reference internal/fptower e2.go), as templates over
// (W, NR), instantiated at (8, -1) (bn254), (12, -1) (bls12-381) and
// (12, -5) (bls12-377).
//
// Counterpart of `_fp2_ops` in gnark_crypto_tpu/field/pallas/point_add2.py.
// An element is (re, im), two canonical ElemT<W>, laid out as the port's
// int32[N, 2, W] tensors: 8W bytes, re first (64 at 8 words, 96 at 12).
// The ops overload those of field.cuh and point.cuh, so the point cores of
// point.cuh run over either type unchanged.
#pragma once

#include "field.cuh"

namespace gct {

template <int W, int NR>
struct Elem2T {
  static_assert(NR != 0 && NR >= -16 && NR <= 16,
                "a small-int non-residue, as the wrappers admit");
  ElemT<W> c0, c1;  // re, im
};

template <int W, int NR>
__device__ __forceinline__ Elem2T<W, NR> load_elem2(const uint32_t* p) {
  return {load_elem<W>(p), load_elem<W>(p + W)};
}

template <int W, int NR>
__device__ __forceinline__ void store_elem(uint32_t* p,
                                           const Elem2T<W, NR>& e) {
  store_elem(p, e.c0);
  store_elem(p + W, e.c1);
}

template <int W, int NR>
__device__ __forceinline__ bool is_zero(const Elem2T<W, NR>& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) o |= a.c0.w[i] | a.c1.w[i];
  return o == 0;
}

template <int W, int NR>
__device__ __forceinline__ bool equal(const Elem2T<W, NR>& a,
                                      const Elem2T<W, NR>& b) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) o |= (a.c0.w[i] ^ b.c0.w[i]) |
                                   (a.c1.w[i] ^ b.c1.w[i]);
  return o == 0;
}

template <int W, int NR>
__device__ __forceinline__ Elem2T<W, NR> add_mod(const Elem2T<W, NR>& a,
                                                 const Elem2T<W, NR>& b,
                                                 const FieldConstT<W>& fc) {
  return {add_mod(a.c0, b.c0, fc), add_mod(a.c1, b.c1, fc)};
}

template <int W, int NR>
__device__ __forceinline__ Elem2T<W, NR> sub_mod(const Elem2T<W, NR>& a,
                                                 const Elem2T<W, NR>& b,
                                                 const FieldConstT<W>& fc) {
  return {sub_mod(a.c0, b.c0, fc), sub_mod(a.c1, b.c1, fc)};
}

// K * x for 1 <= K <= 16 by double-and-add on modular adds, from the top
// bit down, as the JAX package's `small_mul` (5x: 2x, 4x, 4x + x).
template <int K, int W>
__device__ __forceinline__ ElemT<W> small_mul(const ElemT<W>& x,
                                              const FieldConstT<W>& fc) {
  ElemT<W> acc = x;
#pragma unroll
  for (int bit = 3; bit >= 0; --bit) {
    if ((K >> bit) == 0 || (K >> bit) == 1) continue;  // at or above the top
    acc = add_mod(acc, acc, fc);
    if ((K >> bit) & 1) acc = add_mod(acc, x, fc);
  }
  return acc;
}

// Karatsuba, 3 base products (e2_fallback.go): with v0 = a0 b0 and
// v1 = a1 b1, re = v0 + NR v1, im = (a0 + a1)(b0 + b1) - v0 - v1. At
// NR = -1 re is one subtraction; otherwise NR v1 is formed by small_mul and
// subtracted (NR < 0) or added. Every op is canonical, so the result is the
// unique residue and equals the plain version bit for bit. FC is
// FieldConstT<W> or IlpFieldConstT<W> (field.cuh), which picks the base
// product.
template <int W, int NR, class FC>
__device__ __forceinline__ Elem2T<W, NR> mont_mul(const Elem2T<W, NR>& a,
                                                  const Elem2T<W, NR>& b,
                                                  const FC& fc) {
  const ElemT<W> v0 = mont_mul(a.c0, b.c0, fc);
  const ElemT<W> v1 = mont_mul(a.c1, b.c1, fc);
  const ElemT<W> t = mont_mul(add_mod(a.c0, a.c1, fc),
                              add_mod(b.c0, b.c1, fc), fc);
  constexpr int K = NR < 0 ? -NR : NR;
  const ElemT<W> nv1 = small_mul<K>(v1, fc);
  return {NR < 0 ? sub_mod(v0, nv1, fc) : add_mod(v0, nv1, fc),
          sub_mod(sub_mod(t, v0, fc), v1, fc)};
}

// a0 + NR a1 and the correction (1 + NR) v of the square's real part:
// re = (a0 + a1)(a0 + NR a1) - (1 + NR) a0 a1 = a0^2 + NR a1^2.
template <int W, int NR, class FC>
__device__ __forceinline__ ElemT<W> plus_nr(const ElemT<W>& a0,
                                            const ElemT<W>& a1,
                                            const FC& fc) {
  constexpr int K = NR < 0 ? -NR : NR;
  const ElemT<W> k1 = small_mul<K>(a1, fc);
  return NR < 0 ? sub_mod(a0, k1, fc) : add_mod(a0, k1, fc);
}

// u - (1 + NR) v: at NR = -1 just u; below, u + (-1 - NR) v.
template <int W, int NR, class FC>
__device__ __forceinline__ ElemT<W> minus_1nr(const ElemT<W>& u,
                                              const ElemT<W>& v,
                                              const FC& fc) {
  static_assert(NR >= -16 && NR <= 14, "1 + NR in small_mul's range");
  constexpr int K = NR < -1 ? -1 - NR : 1 + NR;
  if constexpr (NR == -1) {
    return u;
  } else {
    const ElemT<W> kv = small_mul<K>(v, fc);
    return NR < -1 ? add_mod(u, kv, fc) : sub_mod(u, kv, fc);
  }
}

// The square in 2 base products: with v = a0 a1, im = 2v and
// re = (a0 + a1)(a0 + NR a1) - (1 + NR) v; at NR = -1 re is
// (a0 + a1)(a0 - a1), at NR = -5 (a0 + a1)(a0 - 5 a1) + 4v. Canonical, so
// it equals mont_mul(a, a) bit for bit.
template <int W, int NR, class FC>
__device__ __forceinline__ Elem2T<W, NR> sqr(const Elem2T<W, NR>& a,
                                             const FC& fc) {
  const ElemT<W> v = mont_mul(a.c0, a.c1, fc);
  const ElemT<W> u = mont_mul(add_mod(a.c0, a.c1, fc),
                              plus_nr<W, NR>(a.c0, a.c1, fc), fc);
  return {minus_1nr<W, NR>(u, v, fc), add_mod(v, v, fc)};
}

// One thread's half of an Fp2 element, for kernels that give each element
// a pair of neighbouring threads: the even lane holds re, the odd lane im,
// and the partner's half comes by one __shfl_xor_sync(..., 1) a word. A
// product is schoolbook, 2 base products a lane (re: a0 b0 + NR a1 b1;
// im: a1 b0 + a0 b1); a square 1 (re: (a0 + a1)(a0 + NR a1), corrected
// by (1 + NR) a0 a1 from the im lane where NR != -1; im: a0 a1, doubled).
// Both lanes run the same instructions and pick by parity, so a warp never
// diverges; every lane of the warp must run them (no early exit).
template <int W, int NR>
struct Half2T {
  ElemT<W> c;  // re on the even lane, im on the odd one
};

__device__ __forceinline__ bool odd_lane() { return threadIdx.x & 1u; }

template <int W>
__device__ __forceinline__ ElemT<W> partner(const ElemT<W>& a) {
  ElemT<W> p;
#pragma unroll
  for (int i = 0; i < W; ++i) p.w[i] = __shfl_xor_sync(0xffffffffu, a.w[i], 1);
  return p;
}

template <int W>
__device__ __forceinline__ ElemT<W> pick(bool c, const ElemT<W>& a,
                                         const ElemT<W>& b) {
  ElemT<W> r;
#pragma unroll
  for (int i = 0; i < W; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

template <int W, int NR, class FC>
__device__ __forceinline__ Half2T<W, NR> add_mod(const Half2T<W, NR>& a,
                                                 const Half2T<W, NR>& b,
                                                 const FC& fc) {
  return {add_mod(a.c, b.c, fc)};
}

template <int W, int NR, class FC>
__device__ __forceinline__ Half2T<W, NR> sub_mod(const Half2T<W, NR>& a,
                                                 const Half2T<W, NR>& b,
                                                 const FC& fc) {
  return {sub_mod(a.c, b.c, fc)};
}

template <int W, int NR, class FC>
__device__ __forceinline__ Half2T<W, NR> mont_mul(const Half2T<W, NR>& a,
                                                  const Half2T<W, NR>& b,
                                                  const FC& fc) {
  const bool im = odd_lane();
  const ElemT<W> pa = partner(a.c), pb = partner(b.c);
  const ElemT<W> p1 = mont_mul(a.c, pick(im, pb, b.c), fc);
  const ElemT<W> p2 = mont_mul(pa, pick(im, b.c, pb), fc);
  constexpr int K = NR < 0 ? -NR : NR;
  const ElemT<W> t = pick(im, p2, small_mul<K>(p2, fc));
  if constexpr (NR < 0) {
    return {pick(im, add_mod(p1, t, fc), sub_mod(p1, t, fc))};
  } else {
    return {add_mod(p1, t, fc)};
  }
}

template <int W, int NR, class FC>
__device__ __forceinline__ Half2T<W, NR> sqr(const Half2T<W, NR>& a,
                                             const FC& fc) {
  const bool im = odd_lane();
  const ElemT<W> pa = partner(a.c);
  const ElemT<W> a0 = pick(im, pa, a.c), a1 = pick(im, a.c, pa);
  const ElemT<W> p = mont_mul(pick(im, a1, add_mod(a0, a1, fc)),
                              pick(im, a0, plus_nr<W, NR>(a0, a1, fc)), fc);
  const ElemT<W> twice = add_mod(p, p, fc);
  if constexpr (NR == -1) {
    return {pick(im, twice, p)};
  } else {
    return {pick(im, twice, minus_1nr<W, NR>(p, partner(p), fc))};
  }
}

// Host: f(std::integral_constant<int, W>{}, std::integral_constant<int,
// NR>{}) for one of the built (W, NR) pairs; any other pair returns
// cudaErrorInvalidValue, and the wrapper raises on it (it refuses such a
// pair before it gets here: field/point_add2.py PAIRS).
template <class F>
inline int for_fp2(int n_words, int nr, F&& f) {
  using I8 = std::integral_constant<int, 8>;
  using I12 = std::integral_constant<int, 12>;
  using M1 = std::integral_constant<int, -1>;
  using M5 = std::integral_constant<int, -5>;
  if (n_words == 8 && nr == -1) return f(I8{}, M1{});
  if (n_words == 12 && nr == -1) return f(I12{}, M1{});
  if (n_words == 12 && nr == -5) return f(I12{}, M5{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace gct
