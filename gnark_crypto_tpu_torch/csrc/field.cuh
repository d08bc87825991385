// Montgomery arithmetic on 8 x 32-bit words (bn254 Fr/Fp, R = 2^256).
// The wrappers admit fields with q < 2^255 only (field/kernels.py).
//
// Shared by every kernel of this directory. Elements are canonical (< q),
// little-endian words, 32 bytes each, so one element is two 16-byte loads.
// The product is a word-serial CIOS with 64-bit partial products: 136
// 32x32->64 multiply-adds per product (64 for a*b, 64 for m*q, 8 for m).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gct {

constexpr int W = 8;  // words per element

struct FieldConst {
  uint32_t q[W];
  uint32_t qinv;  // -q^-1 mod 2^32
};

// Host: q words followed by qinv, as the Python wrappers pass them.
inline FieldConst field_const(const uint32_t* words) {
  FieldConst fc;
  for (int i = 0; i < W; ++i) fc.q[i] = words[i];
  fc.qinv = words[W];
  return fc;
}

struct Elem {
  uint32_t w[W];
};

__device__ __forceinline__ Elem load_elem(const uint32_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(v);
  const uint4 b = __ldg(v + 1);
  Elem e;
  e.w[0] = a.x; e.w[1] = a.y; e.w[2] = a.z; e.w[3] = a.w;
  e.w[4] = b.x; e.w[5] = b.y; e.w[6] = b.z; e.w[7] = b.w;
  return e;
}

__device__ __forceinline__ void store_elem(uint32_t* p, const Elem& e) {
  uint4* v = reinterpret_cast<uint4*>(p);
  v[0] = make_uint4(e.w[0], e.w[1], e.w[2], e.w[3]);
  v[1] = make_uint4(e.w[4], e.w[5], e.w[6], e.w[7]);
}

// a + top*2^256 - q if that is >= 0, else a. Needs a + top*2^256 < 2q.
__device__ __forceinline__ Elem reduce_once(const Elem& a, uint32_t top,
                                            const FieldConst& fc) {
  Elem d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - fc.q[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  return (top || !borrow) ? d : a;
}

__device__ __forceinline__ Elem add_mod(const Elem& a, const Elem& b,
                                        const FieldConst& fc) {
  Elem s;
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t t = (uint64_t)a.w[i] + b.w[i] + carry;
    s.w[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return reduce_once(s, carry, fc);
}

__device__ __forceinline__ Elem sub_mod(const Elem& a, const Elem& b,
                                        const FieldConst& fc) {
  Elem d;
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
__device__ __forceinline__ Elem halve_mod(const Elem& a,
                                          const FieldConst& fc) {
  const uint32_t odd = a.w[0] & 1u;
  Elem t;
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t s = (uint64_t)a.w[i] + (odd ? fc.q[i] : 0u) + carry;
    t.w[i] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  Elem r;
#pragma unroll
  for (int i = 0; i < W - 1; ++i) r.w[i] = (t.w[i] >> 1) | (t.w[i + 1] << 31);
  r.w[W - 1] = (t.w[W - 1] >> 1) | (carry << 31);
  return r;
}

// a * b * 2^-256 mod q (CIOS). Inputs < q; output canonical.
__device__ __forceinline__ Elem mont_mul(const Elem& a, const Elem& b,
                                         const FieldConst& fc) {
  uint32_t t[W + 2];
#pragma unroll
  for (int i = 0; i < W + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t p = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
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
  Elem r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = t[j];
  return reduce_once(r, t[W], fc);
}

}  // namespace gct
