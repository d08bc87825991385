// Fp2 = Fp[u] / (u^2 + 1) on 8-word Montgomery coefficients: the field of
// bn254's G2 (reference internal/fptower e2.go).
//
// Counterpart of `_fp2_ops` in gnark_crypto_tpu/field/pallas/point_add2.py
// for the non-residue -1. An element is (re, im), two canonical Elem, laid
// out as the port's int32[N, 2, 8] tensors: 64 bytes, re first. The ops
// overload those of field.cuh and point.cuh, so the point cores of
// point.cuh run over either type unchanged.
#pragma once

#include "field.cuh"

namespace gct {

struct Elem2 {
  Elem c0, c1;  // re, im
};

__device__ __forceinline__ Elem2 load_elem2(const uint32_t* p) {
  return {load_elem(p), load_elem(p + W)};
}

__device__ __forceinline__ void store_elem(uint32_t* p, const Elem2& e) {
  store_elem(p, e.c0);
  store_elem(p + W, e.c1);
}

__device__ __forceinline__ bool is_zero(const Elem2& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) o |= a.c0.w[i] | a.c1.w[i];
  return o == 0;
}

__device__ __forceinline__ bool equal(const Elem2& a, const Elem2& b) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) o |= (a.c0.w[i] ^ b.c0.w[i]) |
                                   (a.c1.w[i] ^ b.c1.w[i]);
  return o == 0;
}

__device__ __forceinline__ Elem2 add_mod(const Elem2& a, const Elem2& b,
                                         const FieldConst& fc) {
  return {add_mod(a.c0, b.c0, fc), add_mod(a.c1, b.c1, fc)};
}

__device__ __forceinline__ Elem2 sub_mod(const Elem2& a, const Elem2& b,
                                         const FieldConst& fc) {
  return {sub_mod(a.c0, b.c0, fc), sub_mod(a.c1, b.c1, fc)};
}

// Karatsuba, 3 base products (e2_fallback.go): with v0 = a0 b0 and
// v1 = a1 b1, re = v0 - v1 (u^2 = -1), im = (a0 + a1)(b0 + b1) - v0 - v1.
__device__ __forceinline__ Elem2 mont_mul(const Elem2& a, const Elem2& b,
                                          const FieldConst& fc) {
  const Elem v0 = mont_mul(a.c0, b.c0, fc);
  const Elem v1 = mont_mul(a.c1, b.c1, fc);
  const Elem t = mont_mul(add_mod(a.c0, a.c1, fc), add_mod(b.c0, b.c1, fc),
                          fc);
  return {sub_mod(v0, v1, fc), sub_mod(sub_mod(t, v0, fc), v1, fc)};
}

}  // namespace gct
