// Batched Montgomery product out[i] = x[i] * y[i] * 2^-256 mod q.
//
// Replaces the Pallas kernel gnark_crypto_tpu/field/pallas/mont_mul.py
// `mont_mul` (tile body `_mm_tile`): there 22 lazy-carry 12-bit limbs in
// int32 lanes, because the TPU's vector unit has no wide multiply; here one
// thread per element runs an 8-word CIOS with 64-bit partial products.
//
// Bound on the H100: 96 bytes of device memory per product (two 32-byte
// inputs, one output) against 136 multiply-adds, so a pass at 2^20 is
// memory-bound (3.35 TB/s) by about 3x over the INT32 rate. The design
// keeps the traffic at that minimum: each thread reads its two operands as
// four 16-byte loads, neighbouring threads on neighbouring elements, and
// writes its result once; the product lives in registers.
#include "field.cuh"

namespace {

__global__ void mont_mul_kernel(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                uint32_t* __restrict__ out, long long n,
                                gct::FieldConst fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::Elem a = gct::load_elem(x + i * gct::W);
  const gct::Elem b = gct::load_elem(y + i * gct::W);
  gct::store_elem(out + i * gct::W, gct::mont_mul(a, b, fc));
}

}  // namespace

extern "C" int gct_mont_mul(const void* x, const void* y, void* out,
                            long long n, const uint32_t* field_words,
                            void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n,
      gct::field_const(field_words));
  return (int)cudaGetLastError();
}
