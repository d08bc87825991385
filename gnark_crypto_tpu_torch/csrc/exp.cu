// Fixed-exponent power out[i] = x[i]^e (Montgomery in and out), at W = 8
// and W = 12 words.
//
// Replaces the Pallas kernel gnark_crypto_tpu/field/pallas/exp.py
// `exp_const_pallas` and its Fermat form `inverse_small` (x^(q-2), 0 -> 0):
// there one 128-lane tile walks the exponent bits from SMEM so that the
// ladder is not ~254 separate dispatches. Here one thread per element runs
// the MSB-first square-and-multiply in registers; the exponent's W words
// come by value, as FieldConstT does, so every thread of a warp reads the
// same bit and the branch on it never diverges.
//
// Bound on the H100: latency. The ladder is nbits + popcount(e) dependent
// products per element (about 380 for a bn254 inverse, about 570 for a
// bls12-381 one at 300 multiply-adds each), so a batch of up to a few
// thousand elements takes the time of one thread's chain; memory traffic
// (8W bytes per element) does not matter. Any batch size runs, so the
// Fermat seed of every MSM tree level is one launch.
#include "field.cuh"

namespace {

template <int W>
struct ExpConst {
  uint32_t e[W];  // exponent words, little-endian
  int nbits;      // bit length of e
};

template <int W>
__global__ void exp_const_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ out, long long n,
                                 gct::FieldConstT<W> fc, gct::ElemT<W> one,
                                 ExpConst<W> ec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::ElemT<W> a = gct::load_elem<W>(x + i * W);
  gct::ElemT<W> acc = one;
  for (int b = ec.nbits - 1; b >= 0; --b) {
    acc = gct::mont_mul(acc, acc, fc);
    if ((ec.e[b >> 5] >> (b & 31)) & 1u) acc = gct::mont_mul(acc, a, fc);
  }
  gct::store_elem(out + i * W, acc);
}

}  // namespace

// n_words: 8 or 12; one_words: Montgomery one (R mod q); exp_words: e's
// n_words words, e < 2^(32 n_words).
extern "C" int gct_exp_const(const void* x, void* out, long long n,
                             int n_words, const uint32_t* field_words,
                             const uint32_t* one_words,
                             const uint32_t* exp_words, int nbits,
                             void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    gct::ElemT<W> one;
    ExpConst<W> ec;
    for (int i = 0; i < W; ++i) {
      one.w[i] = one_words[i];
      ec.e[i] = exp_words[i];
    }
    ec.nbits = nbits;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    exp_const_kernel<W><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n,
        gct::field_const<W>(field_words), one, ec);
    return (int)cudaGetLastError();
  });
}
