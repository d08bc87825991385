// Short-Weierstrass point arithmetic on W-word Montgomery elements (W = 8,
// 10, 12, 20 and 24; at 8 also the 256-bit secp256k1/r1 Fp, since every
// core here is built of the canonical field ops, exact for any q < R, and
// takes any a: 0 for secp256k1, -3 for secp256r1): the device cores of
// csrc/point_add.cu and csrc/affine_level.cu, and over Fp2 (csrc/fp2.cuh,
// 8 and 12 words) of csrc/point_add2.cu and csrc/affine_level2.cu. Each
// core is a template over the element type E
// (ElemT<W> or Elem2T<W, NR>) and its field constants FC, and calls the
// field ops by overload, as the JAX package's cores take an ops tuple.
//
// Counterparts of the Pallas cores in gnark_crypto_tpu/field/pallas/
// point_add.py (`_dbl_core`, `_add_core_ops`, `_prep_kernel`,
// `_finish_kernel`). The formulas and their operation order are the JAX
// package's (`curve/jacobian.py`), so with canonical arithmetic every
// coordinate comes out as the same integer: Jacobian coordinates are not
// unique, and a different order would give another representative.
// Infinity is (0, 0, 0) in Jacobian and (0, 0) in affine coordinates.
//
// The TPU computes both branches of every mask and selects; a thread here
// branches on its own lane's mask instead (the doubling fallback of the add
// is rare and gives the same values).
#pragma once

#include "field.cuh"

namespace gct {

// The curve's a in Montgomery form, and Montgomery one.
template <class E>
struct CurveConstT {
  E a;
  E one;
};

// Host: a's W words, then one's W words, as the Python wrappers pass them.
template <int W>
inline CurveConstT<ElemT<W>> curve_const(const uint32_t* words) {
  CurveConstT<ElemT<W>> cc;
  for (int i = 0; i < W; ++i) {
    cc.a.w[i] = words[i];
    cc.one.w[i] = words[W + i];
  }
  return cc;
}

template <class E>
struct JacT {
  E x, y, z;
};

template <int W>
__device__ __forceinline__ bool is_zero(const ElemT<W>& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) o |= a.w[i];
  return o == 0;
}

template <int W>
__device__ __forceinline__ bool equal(const ElemT<W>& a, const ElemT<W>& b) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) o |= a.w[i] ^ b.w[i];
  return o == 0;
}

template <class E, class FC>
__device__ __forceinline__ E dbl_mod(const E& a, const FC& fc) {
  return add_mod(a, a, fc);
}

// dbl-2009-l (a = 0) / dbl-2007-bl (reference g1.go:397 DoubleAssign), as
// `_dbl_core`. Infinity needs no mask: Z3 = 2*Y1*Z1 = 0 when Z1 = 0.
// 7 products, 10 when a != 0; of them 5 (7) squares, which `sqr` runs in 2
// base products over Fp2 (fp2.cuh) and as one product over Fp. No branch,
// so a pair of threads sharing a point (Half2T) never diverges.
template <bool A_ZERO, class E, class FC>
__device__ __forceinline__ JacT<E> jac_double(const JacT<E>& p, const FC& fc,
                                              const CurveConstT<E>& cc) {
  const E A = sqr(p.x, fc);
  const E B = sqr(p.y, fc);
  const E C = sqr(B, fc);
  const E t = sqr(add_mod(p.x, B, fc), fc);
  const E D = dbl_mod(sub_mod(sub_mod(t, A, fc), C, fc), fc);
  E e = add_mod(dbl_mod(A, fc), A, fc);
  if constexpr (!A_ZERO) {
    const E z2 = sqr(p.z, fc);
    e = add_mod(e, mont_mul(sqr(z2, fc), cc.a, fc), fc);
  }
  const E F = sqr(e, fc);
  JacT<E> r;
  r.x = sub_mod(F, dbl_mod(D, fc), fc);
  r.y = sub_mod(mont_mul(e, sub_mod(D, r.x, fc), fc),
                dbl_mod(dbl_mod(dbl_mod(C, fc), fc), fc), fc);
  r.z = dbl_mod(mont_mul(p.y, p.z, fc), fc);
  return r;
}

// Complete masked add-2007-bl (reference g1.go:332 AddAssign) with the
// doubling fallback and the masks of `_add_core_ops`, in the same order of
// precedence: P == Q doubles, P == -Q gives infinity, then an infinite P
// returns Q and an infinite Q returns P. 16 products, plus the doubling's
// where a lane doubles.
template <bool A_ZERO, class E, class FC>
__device__ __forceinline__ JacT<E> jac_add(const JacT<E>& p, const JacT<E>& q,
                                           const FC& fc,
                                           const CurveConstT<E>& cc) {
  const bool q_inf = is_zero(q.z);
  if (q_inf) return p;
  const bool p_inf = is_zero(p.z);
  if (p_inf) return q;
  const E z1z1 = mont_mul(p.z, p.z, fc);
  const E z2z2 = mont_mul(q.z, q.z, fc);
  const E u1 = mont_mul(p.x, z2z2, fc);
  const E u2 = mont_mul(q.x, z1z1, fc);
  const E s1 = mont_mul(mont_mul(p.y, q.z, fc), z2z2, fc);
  const E s2 = mont_mul(mont_mul(q.y, p.z, fc), z1z1, fc);
  const E h = sub_mod(u2, u1, fc);
  const E rr = dbl_mod(sub_mod(s2, s1, fc), fc);
  const bool h0 = is_zero(h);
  if (h0) {
    if (is_zero(rr)) return jac_double<A_ZERO>(p, fc, cc);  // P == Q
    return JacT<E>{};                                        // P == -Q
  }
  E i = dbl_mod(h, fc);
  i = mont_mul(i, i, fc);
  const E j = mont_mul(h, i, fc);
  const E v = mont_mul(u1, i, fc);
  JacT<E> r;
  r.x = sub_mod(sub_mod(mont_mul(rr, rr, fc), j, fc), dbl_mod(v, fc), fc);
  r.y = sub_mod(mont_mul(rr, sub_mod(v, r.x, fc), fc),
                dbl_mod(mont_mul(s1, j, fc), fc), fc);
  const E z12 = add_mod(p.z, q.z, fc);
  r.z = mont_mul(sub_mod(sub_mod(mont_mul(z12, z12, fc), z1z1, fc), z2z2, fc),
                 h, fc);
  return r;
}

// Mask bits of one complete affine add (`_MB_*` of point_add.py).
constexpr int MB_DBL = 1, MB_INFOUT = 2, MB_PINF = 4, MB_QINF = 8;

// Tree-level prep (`_prep_kernel`): the shared denominator (2y when P == Q,
// else qx - px; 1 where that is 0), the numerator (3x^2 + a when P == Q,
// else qy - py) and the mask bits. 1 product, on doubling lanes only.
template <bool A_ZERO, class E, class FC>
__device__ __forceinline__ int affine_prep(const E& px, const E& py,
                                           const E& qx, const E& qy,
                                           E& den, E& num, const FC& fc,
                                           const CurveConstT<E>& cc) {
  const bool p_inf = is_zero(px) && is_zero(py);
  const bool q_inf = is_zero(qx) && is_zero(qy);
  const bool both = !p_inf && !q_inf;
  const bool x_eq = equal(px, qx);
  const bool y_eq = equal(py, qy);
  const bool is_dbl = x_eq && y_eq && both;
  const bool inf_out = (x_eq && !y_eq && both) || (is_dbl && is_zero(py));
  if (is_dbl) {
    den = dbl_mod(py, fc);
    const E x2 = mont_mul(px, px, fc);
    num = add_mod(dbl_mod(x2, fc), x2, fc);
    if (!A_ZERO) num = add_mod(num, cc.a, fc);
  } else {
    den = sub_mod(qx, px, fc);
    num = sub_mod(qy, py, fc);
  }
  if (is_zero(den)) den = cc.one;
  return (is_dbl ? MB_DBL : 0) | (inf_out ? MB_INFOUT : 0) |
         (p_inf ? MB_PINF : 0) | (q_inf ? MB_QINF : 0);
}

// The complete affine sum P + Q from the inverted denominator
// (`_finish_kernel`'s mid): 3 products.
template <class E, class FC>
__device__ __forceinline__ void affine_sum(const E& px, const E& py,
                                           const E& qx, const E& qy,
                                           const E& num, const E& dinv,
                                           int bits, E& mx, E& my,
                                           const FC& fc) {
  if (bits & MB_QINF) {
    mx = px;
    my = py;
  } else if (bits & MB_PINF) {
    mx = qx;
    my = qy;
  } else if (bits & MB_INFOUT) {
    mx = my = E{};
  } else {
    const E s = mont_mul(num, dinv, fc);
    mx = sub_mod(sub_mod(mont_mul(s, s, fc), px, fc), qx, fc);
    my = sub_mod(mont_mul(s, sub_mod(px, mx, fc), fc), py, fc);
  }
}

}  // namespace gct
