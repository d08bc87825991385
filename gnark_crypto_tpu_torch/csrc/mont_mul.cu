// Batched Montgomery product out[i] = x[i] * y[i] * 2^(-32W) mod q, at
// W = 8, 10, 12, 20 and 24 words; at 8 for any q < 2^256, so the 256-bit
// secp256k1/r1 moduli too (csrc/field.cuh).
//
// Replaces the Pallas kernel gnark_crypto_tpu/field/pallas/mont_mul.py
// `mont_mul` (tile body `_mm_tile`): there lazy-carry 11-13-bit limbs in
// int32 lanes, because the TPU's vector unit has no wide multiply; here one
// thread per element runs a W-word CIOS with 64-bit partial products.
//
// Bound on the H100: 12W bytes of device memory per product (two inputs,
// one output of 4W bytes) against 2W^2 + W multiply-adds. At W = 8 (96
// bytes, 136) a pass at 2^20 is memory-bound (3.35 TB/s) by about 3x over
// the INT32 rate; at W = 12 (144 bytes, 300) by about 2x; at W = 20 (240
// bytes, 820) by about 1.5x and at W = 24 (288 bytes, 1,176) by about
// 1.2x, where the ~3.4 instructions a multiply-add of this CIOS make issue
// the likelier limit. The design keeps the traffic at that minimum: each
// thread reads its two operands as W/4 16-byte loads (W/2 8-byte ones at
// W = 10), neighbouring threads on neighbouring elements, and writes its
// result once; the product lives in registers.
#include "field.cuh"

namespace {

template <int W>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                uint32_t* __restrict__ out, long long n,
                                gct::FieldConstT<W> fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::ElemT<W> a = gct::load_elem<W>(x + i * W);
  const gct::ElemT<W> b = gct::load_elem<W>(y + i * W);
  gct::store_elem(out + i * W, gct::mont_mul(a, b, fc));
}

}  // namespace

// n_words: 8, 10, 12, 20 or 24; field_words: q's n_words words, then
// -q^-1 mod 2^32.
extern "C" int gct_mont_mul(const void* x, const void* y, void* out,
                            long long n, int n_words,
                            const uint32_t* field_words, void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    mont_mul_kernel<W><<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n,
        gct::field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}
