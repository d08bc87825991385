// Batched Jacobian point add and double over Fp2, and the MSM's Horner
// window fold over Fp2: the G2 twists (a = 0) of bn254 (8 words,
// u^2 = -1), bls12-381 (12 words, u^2 = -1) and bls12-377 (12 words,
// u^2 = -5), one instantiation each (gct::for_fp2).
//
// Replaces the Pallas kernels of gnark_crypto_tpu/field/pallas/
// point_add2.py: `jac_add2` (`_jac_add2_kernel`), `jac_double2`
// (`_jac_dbl2_kernel`) and `jac_fold_windows2` (`_fold2_kernel`). On the
// TPU an Fp2 coordinate is a stacked (2*l_pad, 128) limb tile; here one
// thread owns one point of int32[N, 2, W] coordinates and runs the cores of
// csrc/point.cuh over Elem2T (csrc/fp2.cuh), and the fold is one thread.
//
// Bounds on the H100 (an Fp2 product is 3 base products: 408 multiply-adds
// at 8 words, 900 at 12; an Fp2 element 8W bytes):
// * jac_add2: 48W bytes in, 24W out, 16 Fp2 products: bound by operations.
// * jac_double2: 24W bytes in and out, 7 Fp2 products.
// * jac_fold_windows2: latency. c*(nwin-1) doublings and nwin-1 adds in one
//   dependent chain, about 6,000 serial base products for an MSM at 2^20.
// An Fp2 point is three times a G1 point's state: the cores spill (at 12
// words two points are 144 words), which `-Xptxas -v` reports per
// instantiation in lib<name>.log of the build.
#include "fp2.cuh"
#include "point.cuh"

namespace {

template <int W, int NR>
using Pt = gct::JacT<gct::Elem2T<W, NR>>;

template <int W, int NR>
__device__ __forceinline__ Pt<W, NR> load_pt(const uint32_t* x,
                                             const uint32_t* y,
                                             const uint32_t* z, long long i) {
  Pt<W, NR> p;
  p.x = gct::load_elem2<W, NR>(x + i * 2 * W);
  p.y = gct::load_elem2<W, NR>(y + i * 2 * W);
  p.z = gct::load_elem2<W, NR>(z + i * 2 * W);
  return p;
}

template <int W, int NR>
__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, long long i,
                                         const Pt<W, NR>& p) {
  gct::store_elem(x + i * 2 * W, p.x);
  gct::store_elem(y + i * 2 * W, p.y);
  gct::store_elem(z + i * 2 * W, p.z);
}

template <int W, int NR>
__global__ void jac_add2_kernel(const uint32_t* __restrict__ x1,
                                const uint32_t* __restrict__ y1,
                                const uint32_t* __restrict__ z1,
                                const uint32_t* __restrict__ x2,
                                const uint32_t* __restrict__ y2,
                                const uint32_t* __restrict__ z2,
                                uint32_t* __restrict__ x3,
                                uint32_t* __restrict__ y3,
                                uint32_t* __restrict__ z3, long long n,
                                gct::FieldConstT<W> fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::CurveConstT<gct::Elem2T<W, NR>> cc{};  // a = 0; one unused
  store_pt<W, NR>(x3, y3, z3, i,
                  gct::jac_add<true>(load_pt<W, NR>(x1, y1, z1, i),
                                     load_pt<W, NR>(x2, y2, z2, i), fc, cc));
}

template <int W, int NR>
__global__ void jac_double2_kernel(const uint32_t* __restrict__ x1,
                                   const uint32_t* __restrict__ y1,
                                   const uint32_t* __restrict__ z1,
                                   uint32_t* __restrict__ x3,
                                   uint32_t* __restrict__ y3,
                                   uint32_t* __restrict__ z3, long long n,
                                   gct::FieldConstT<W> fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::CurveConstT<gct::Elem2T<W, NR>> cc{};
  store_pt<W, NR>(x3, y3, z3, i,
                  gct::jac_double<true>(load_pt<W, NR>(x1, y1, z1, i), fc,
                                        cc));
}

// acc = T[nwin-1]; then for w = nwin-2 .. 0: acc = 2^c acc + T[w], as
// `_fold2_kernel`.
template <int W, int NR>
__global__ void jac_fold2_kernel(const uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ z,
                                 uint32_t* __restrict__ ox,
                                 uint32_t* __restrict__ oy,
                                 uint32_t* __restrict__ oz, int nwin, int c,
                                 gct::FieldConstT<W> fc) {
  const gct::CurveConstT<gct::Elem2T<W, NR>> cc{};
  Pt<W, NR> acc = load_pt<W, NR>(x, y, z, nwin - 1);
  for (int w = nwin - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = gct::jac_double<true>(acc, fc, cc);
    acc = gct::jac_add<true>(acc, load_pt<W, NR>(x, y, z, w), fc, cc);
  }
  store_pt<W, NR>(ox, oy, oz, 0, acc);
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// n_words, nr: the base field's words and the non-residue, one of the pairs
// of gct::for_fp2; field_words: q's n_words words, then -q^-1 mod 2^32.
extern "C" int gct_jac_add2(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* x3, void* y3, void* z3, long long n,
                            int n_words, int nr, const uint32_t* field_words,
                            void* stream) {
  return gct::for_fp2(n_words, nr, [&](auto width, auto nonres) {
    constexpr int W = decltype(width)::value, NR = decltype(nonres)::value;
    if (n <= 0) return 0;
    jac_add2_kernel<W, NR><<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
        gct::field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}

extern "C" int gct_jac_double2(const void* x1, const void* y1, const void* z1,
                               void* x3, void* y3, void* z3, long long n,
                               int n_words, int nr,
                               const uint32_t* field_words, void* stream) {
  return gct::for_fp2(n_words, nr, [&](auto width, auto nonres) {
    constexpr int W = decltype(width)::value, NR = decltype(nonres)::value;
    if (n <= 0) return 0;
    jac_double2_kernel<W, NR><<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
        gct::field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}

extern "C" int gct_jac_fold_windows2(const void* x, const void* y,
                                     const void* z, void* ox, void* oy,
                                     void* oz, int nwin, int c, int n_words,
                                     int nr, const uint32_t* field_words,
                                     void* stream) {
  return gct::for_fp2(n_words, nr, [&](auto width, auto nonres) {
    constexpr int W = decltype(width)::value, NR = decltype(nonres)::value;
    if (nwin <= 0) return 0;
    jac_fold2_kernel<W, NR><<<1, 1, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, nwin, c,
        gct::field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}
