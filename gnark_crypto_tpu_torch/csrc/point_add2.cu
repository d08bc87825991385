// Batched Jacobian point add and double over Fp2, and the MSM's Horner
// window fold over Fp2: bn254's G2 (a = 0, u^2 = -1).
//
// Replaces the Pallas kernels of gnark_crypto_tpu/field/pallas/
// point_add2.py: `jac_add2` (`_jac_add2_kernel`), `jac_double2`
// (`_jac_dbl2_kernel`) and `jac_fold_windows2` (`_fold2_kernel`). On the
// TPU an Fp2 coordinate is a stacked (2*l_pad, 128) limb tile; here one
// thread owns one point of int32[N, 2, 8] coordinates and runs the cores of
// csrc/point.cuh over Elem2 (csrc/fp2.cuh), and the fold is one thread.
//
// Bounds on the H100:
// * jac_add2: 384 bytes in, 192 out, 16 Fp2 products = 48 base products
//   (136 multiply-adds each): bound by operations.
// * jac_double2: 192 bytes in and out, 7 Fp2 products = 21 base products.
// * jac_fold_windows2: latency. c*(nwin-1) doublings and nwin-1 adds in one
//   dependent chain, about 6,000 serial base products for an MSM at 2^20.
// An Fp2 point is three times a G1 point's state: the cores spill, which
// `-Xptxas -v` reports in lib<name>.log of the build.
#include "fp2.cuh"
#include "point.cuh"

namespace {

using gct::Elem2;
using Pt = gct::JacT<Elem2>;
constexpr int W2 = 2 * gct::W;  // words per Fp2 element

__device__ __forceinline__ Pt load_pt(const uint32_t* x, const uint32_t* y,
                                      const uint32_t* z, long long i) {
  Pt p;
  p.x = gct::load_elem2(x + i * W2);
  p.y = gct::load_elem2(y + i * W2);
  p.z = gct::load_elem2(z + i * W2);
  return p;
}

__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, long long i,
                                         const Pt& p) {
  gct::store_elem(x + i * W2, p.x);
  gct::store_elem(y + i * W2, p.y);
  gct::store_elem(z + i * W2, p.z);
}

__global__ void jac_add2_kernel(const uint32_t* __restrict__ x1,
                                const uint32_t* __restrict__ y1,
                                const uint32_t* __restrict__ z1,
                                const uint32_t* __restrict__ x2,
                                const uint32_t* __restrict__ y2,
                                const uint32_t* __restrict__ z2,
                                uint32_t* __restrict__ x3,
                                uint32_t* __restrict__ y3,
                                uint32_t* __restrict__ z3, long long n,
                                gct::FieldConst fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::CurveConstT<Elem2> cc{};  // a = 0; one unused
  store_pt(x3, y3, z3, i,
           gct::jac_add<true>(load_pt(x1, y1, z1, i),
                              load_pt(x2, y2, z2, i), fc, cc));
}

__global__ void jac_double2_kernel(const uint32_t* __restrict__ x1,
                                   const uint32_t* __restrict__ y1,
                                   const uint32_t* __restrict__ z1,
                                   uint32_t* __restrict__ x3,
                                   uint32_t* __restrict__ y3,
                                   uint32_t* __restrict__ z3, long long n,
                                   gct::FieldConst fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::CurveConstT<Elem2> cc{};
  store_pt(x3, y3, z3, i,
           gct::jac_double<true>(load_pt(x1, y1, z1, i), fc, cc));
}

// acc = T[nwin-1]; then for w = nwin-2 .. 0: acc = 2^c acc + T[w], as
// `_fold2_kernel`.
__global__ void jac_fold2_kernel(const uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ z,
                                 uint32_t* __restrict__ ox,
                                 uint32_t* __restrict__ oy,
                                 uint32_t* __restrict__ oz, int nwin, int c,
                                 gct::FieldConst fc) {
  const gct::CurveConstT<Elem2> cc{};
  Pt acc = load_pt(x, y, z, nwin - 1);
  for (int w = nwin - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = gct::jac_double<true>(acc, fc, cc);
    acc = gct::jac_add<true>(acc, load_pt(x, y, z, w), fc, cc);
  }
  store_pt(ox, oy, oz, 0, acc);
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int gct_jac_add2(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* x3, void* y3, void* z3, long long n,
                            const uint32_t* field_words, void* stream) {
  if (n <= 0) return 0;
  jac_add2_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
      gct::field_const(field_words));
  return (int)cudaGetLastError();
}

extern "C" int gct_jac_double2(const void* x1, const void* y1, const void* z1,
                               void* x3, void* y3, void* z3, long long n,
                               const uint32_t* field_words, void* stream) {
  if (n <= 0) return 0;
  jac_double2_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
      gct::field_const(field_words));
  return (int)cudaGetLastError();
}

extern "C" int gct_jac_fold_windows2(const void* x, const void* y,
                                     const void* z, void* ox, void* oy,
                                     void* oz, int nwin, int c,
                                     const uint32_t* field_words,
                                     void* stream) {
  if (nwin <= 0) return 0;
  jac_fold2_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, nwin, c,
      gct::field_const(field_words));
  return (int)cudaGetLastError();
}
