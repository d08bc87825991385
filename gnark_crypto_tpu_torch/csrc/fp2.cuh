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
// unique residue and equals the plain version bit for bit.
template <int W, int NR>
__device__ __forceinline__ Elem2T<W, NR> mont_mul(const Elem2T<W, NR>& a,
                                                  const Elem2T<W, NR>& b,
                                                  const FieldConstT<W>& fc) {
  const ElemT<W> v0 = mont_mul(a.c0, b.c0, fc);
  const ElemT<W> v1 = mont_mul(a.c1, b.c1, fc);
  const ElemT<W> t = mont_mul(add_mod(a.c0, a.c1, fc),
                              add_mod(b.c0, b.c1, fc), fc);
  constexpr int K = NR < 0 ? -NR : NR;
  const ElemT<W> nv1 = small_mul<K>(v1, fc);
  return {NR < 0 ? sub_mod(v0, nv1, fc) : add_mod(v0, nv1, fc),
          sub_mod(sub_mod(t, v0, fc), v1, fc)};
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
