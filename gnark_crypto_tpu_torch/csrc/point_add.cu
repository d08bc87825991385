// Batched Jacobian point add and double, and the MSM's Horner window fold,
// at W = 8, 10, 12, 20 and 24 words (at 8 for any q < 2^256: secp256k1/r1
// too).
//
// Replaces the Pallas kernels of gnark_crypto_tpu/field/pallas/point_add.py:
// `jac_add` (`_kernel`, `_add_core_ops`), `jac_double` (`_dbl_kernel`,
// `_dbl_core`) and `jac_fold_windows` (`_fold_kernel`). On the TPU each
// works on (l_pad, 128) limb tiles and computes every branch of the
// complete add; the fold broadcasts one window's lane across the tile.
// Here one thread owns one point and branches on its own masks
// (csrc/point.cuh), and the fold is one thread.
//
// Bounds on the H100 (a product is 2W^2 + W multiply-adds: 136 at W = 8,
// 300 at W = 12, 1,176 at W = 24):
// * jac_add: 24W bytes in, 12W out, 16 products, so about 7x (W = 8) and
//   10x (W = 12) over the memory time: bound by operations. The point lives
//   in registers; spills, if any, show in lib<name>.log of the build (at
//   W = 12 two points and the temporaries outgrow the 255 registers; at
//   W = 20 and 24 the two points alone are 120 and 144 registers, and
//   what does not fit spills to the thread's local memory, which L1 keeps
//   near).
// * jac_double: 12W bytes in and out, 7 products (10 when a != 0): about
//   even between bytes and operations.
// * jac_fold_windows: latency. c*(nwin-1) doublings and nwin-1 adds in one
//   dependent chain, about 2,000 serial products for a bn254 or bls12 MSM
//   at 2^20; there is no parallel work to spread, and the chain replaces
//   that many width-1 launches.
//
// Many products a kernel: the CIOS keeps its outer loop rolled at 20 and 24
// words (csrc/field.cuh).
#define GCT_ROLLED_CIOS_FROM 20
#include "point.cuh"

namespace {

template <int W>
using Pt = gct::JacT<gct::ElemT<W>>;

template <int W>
__device__ __forceinline__ Pt<W> load_pt(const uint32_t* x,
                                         const uint32_t* y,
                                         const uint32_t* z, long long i) {
  Pt<W> p;
  p.x = gct::load_elem<W>(x + i * W);
  p.y = gct::load_elem<W>(y + i * W);
  p.z = gct::load_elem<W>(z + i * W);
  return p;
}

template <int W>
__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, long long i,
                                         const Pt<W>& p) {
  gct::store_elem(x + i * W, p.x);
  gct::store_elem(y + i * W, p.y);
  gct::store_elem(z + i * W, p.z);
}

template <int W, bool A_ZERO>
__global__ void jac_add_kernel(const uint32_t* __restrict__ x1,
                               const uint32_t* __restrict__ y1,
                               const uint32_t* __restrict__ z1,
                               const uint32_t* __restrict__ x2,
                               const uint32_t* __restrict__ y2,
                               const uint32_t* __restrict__ z2,
                               uint32_t* __restrict__ x3,
                               uint32_t* __restrict__ y3,
                               uint32_t* __restrict__ z3, long long n,
                               gct::FieldConstT<W> fc,
                               gct::CurveConstT<gct::ElemT<W>> cc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt<W> p = load_pt<W>(x1, y1, z1, i);
  const Pt<W> q = load_pt<W>(x2, y2, z2, i);
  store_pt<W>(x3, y3, z3, i, gct::jac_add<A_ZERO>(p, q, fc, cc));
}

template <int W, bool A_ZERO>
__global__ void jac_double_kernel(const uint32_t* __restrict__ x1,
                                  const uint32_t* __restrict__ y1,
                                  const uint32_t* __restrict__ z1,
                                  uint32_t* __restrict__ x3,
                                  uint32_t* __restrict__ y3,
                                  uint32_t* __restrict__ z3, long long n,
                                  gct::FieldConstT<W> fc,
                                  gct::CurveConstT<gct::ElemT<W>> cc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_pt<W>(x3, y3, z3, i,
              gct::jac_double<A_ZERO>(load_pt<W>(x1, y1, z1, i), fc, cc));
}

// acc = T[nwin-1]; then for w = nwin-2 .. 0: acc = 2^c acc + T[w]
// (msmReduceChunkG1Affine, multiexp.go:303), as `_fold_kernel`.
template <int W, bool A_ZERO>
__global__ void jac_fold_kernel(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                const uint32_t* __restrict__ z,
                                uint32_t* __restrict__ ox,
                                uint32_t* __restrict__ oy,
                                uint32_t* __restrict__ oz, int nwin, int c,
                                gct::FieldConstT<W> fc,
                                gct::CurveConstT<gct::ElemT<W>> cc) {
  Pt<W> acc = load_pt<W>(x, y, z, nwin - 1);
  for (int w = nwin - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = gct::jac_double<A_ZERO>(acc, fc, cc);
    acc = gct::jac_add<A_ZERO>(acc, load_pt<W>(x, y, z, w), fc, cc);
  }
  store_pt<W>(ox, oy, oz, 0, acc);
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// n_words: 8, 10, 12, 20 or 24; curve_words: a in Montgomery form
// (n_words words), then Montgomery one (n_words).
extern "C" int gct_jac_add(const void* x1, const void* y1, const void* z1,
                           const void* x2, const void* y2, const void* z2,
                           void* x3, void* y3, void* z3, long long n,
                           int n_words, const uint32_t* field_words,
                           const uint32_t* curve_words, int a_is_zero,
                           void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    auto k = a_is_zero ? jac_add_kernel<W, true> : jac_add_kernel<W, false>;
    k<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
        gct::field_const<W>(field_words), gct::curve_const<W>(curve_words));
    return (int)cudaGetLastError();
  });
}

extern "C" int gct_jac_double(const void* x1, const void* y1, const void* z1,
                              void* x3, void* y3, void* z3, long long n,
                              int n_words, const uint32_t* field_words,
                              const uint32_t* curve_words, int a_is_zero,
                              void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    auto k = a_is_zero ? jac_double_kernel<W, true>
                       : jac_double_kernel<W, false>;
    k<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
        gct::field_const<W>(field_words), gct::curve_const<W>(curve_words));
    return (int)cudaGetLastError();
  });
}

extern "C" int gct_jac_fold_windows(const void* x, const void* y,
                                    const void* z, void* ox, void* oy,
                                    void* oz, int nwin, int c, int n_words,
                                    const uint32_t* field_words,
                                    const uint32_t* curve_words,
                                    int a_is_zero, void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (nwin <= 0) return 0;
    auto k = a_is_zero ? jac_fold_kernel<W, true> : jac_fold_kernel<W, false>;
    k<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, nwin, c,
        gct::field_const<W>(field_words), gct::curve_const<W>(curve_words));
    return (int)cudaGetLastError();
  });
}
