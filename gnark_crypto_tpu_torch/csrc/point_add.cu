// Batched Jacobian point add and double, and the MSM's Horner window fold.
//
// Replaces the Pallas kernels of gnark_crypto_tpu/field/pallas/point_add.py:
// `jac_add` (`_kernel`, `_add_core_ops`), `jac_double` (`_dbl_kernel`,
// `_dbl_core`) and `jac_fold_windows` (`_fold_kernel`). On the TPU each
// works on (l_pad, 128) limb tiles and computes every branch of the
// complete add; the fold broadcasts one window's lane across the tile.
// Here one thread owns one point and branches on its own masks
// (csrc/point.cuh), and the fold is one thread.
//
// Bounds on the H100:
// * jac_add: 192 bytes in, 96 out, 16 products (136 multiply-adds each),
//   so about 7x over the memory time: bound by operations. The point lives
//   in registers; spills, if any, show in lib<name>.log of the build.
// * jac_double: 96 bytes in and out, 7 products (10 when a != 0): about
//   even between bytes and operations.
// * jac_fold_windows: latency. c*(nwin-1) doublings and nwin-1 adds in one
//   dependent chain, about 2,000 serial products for a bn254 MSM at 2^20;
//   there is no parallel work to spread, and the chain replaces that many
//   width-1 launches.
#include "point.cuh"

namespace {

using gct::Elem;
using gct::JacPt;

__device__ __forceinline__ JacPt load_pt(const uint32_t* x, const uint32_t* y,
                                         const uint32_t* z, long long i) {
  JacPt p;
  p.x = gct::load_elem(x + i * gct::W);
  p.y = gct::load_elem(y + i * gct::W);
  p.z = gct::load_elem(z + i * gct::W);
  return p;
}

__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, long long i,
                                         const JacPt& p) {
  gct::store_elem(x + i * gct::W, p.x);
  gct::store_elem(y + i * gct::W, p.y);
  gct::store_elem(z + i * gct::W, p.z);
}

template <bool A_ZERO>
__global__ void jac_add_kernel(const uint32_t* __restrict__ x1,
                               const uint32_t* __restrict__ y1,
                               const uint32_t* __restrict__ z1,
                               const uint32_t* __restrict__ x2,
                               const uint32_t* __restrict__ y2,
                               const uint32_t* __restrict__ z2,
                               uint32_t* __restrict__ x3,
                               uint32_t* __restrict__ y3,
                               uint32_t* __restrict__ z3, long long n,
                               gct::FieldConst fc, gct::CurveConst cc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const JacPt p = load_pt(x1, y1, z1, i);
  const JacPt q = load_pt(x2, y2, z2, i);
  store_pt(x3, y3, z3, i, gct::jac_add<A_ZERO>(p, q, fc, cc));
}

template <bool A_ZERO>
__global__ void jac_double_kernel(const uint32_t* __restrict__ x1,
                                  const uint32_t* __restrict__ y1,
                                  const uint32_t* __restrict__ z1,
                                  uint32_t* __restrict__ x3,
                                  uint32_t* __restrict__ y3,
                                  uint32_t* __restrict__ z3, long long n,
                                  gct::FieldConst fc, gct::CurveConst cc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_pt(x3, y3, z3, i,
           gct::jac_double<A_ZERO>(load_pt(x1, y1, z1, i), fc, cc));
}

// acc = T[nwin-1]; then for w = nwin-2 .. 0: acc = 2^c acc + T[w]
// (msmReduceChunkG1Affine, multiexp.go:303), as `_fold_kernel`.
template <bool A_ZERO>
__global__ void jac_fold_kernel(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                const uint32_t* __restrict__ z,
                                uint32_t* __restrict__ ox,
                                uint32_t* __restrict__ oy,
                                uint32_t* __restrict__ oz, int nwin, int c,
                                gct::FieldConst fc, gct::CurveConst cc) {
  JacPt acc = load_pt(x, y, z, nwin - 1);
  for (int w = nwin - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = gct::jac_double<A_ZERO>(acc, fc, cc);
    acc = gct::jac_add<A_ZERO>(acc, load_pt(x, y, z, w), fc, cc);
  }
  store_pt(ox, oy, oz, 0, acc);
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// curve_words: a in Montgomery form (8 words), then Montgomery one (8).
extern "C" int gct_jac_add(const void* x1, const void* y1, const void* z1,
                           const void* x2, const void* y2, const void* z2,
                           void* x3, void* y3, void* z3, long long n,
                           const uint32_t* field_words,
                           const uint32_t* curve_words, int a_is_zero,
                           void* stream) {
  if (n <= 0) return 0;
  const gct::FieldConst fc = gct::field_const(field_words);
  const gct::CurveConst cc = gct::curve_const(curve_words);
  auto k = a_is_zero ? jac_add_kernel<true> : jac_add_kernel<false>;
  k<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n, fc, cc);
  return (int)cudaGetLastError();
}

extern "C" int gct_jac_double(const void* x1, const void* y1, const void* z1,
                              void* x3, void* y3, void* z3, long long n,
                              const uint32_t* field_words,
                              const uint32_t* curve_words, int a_is_zero,
                              void* stream) {
  if (n <= 0) return 0;
  const gct::FieldConst fc = gct::field_const(field_words);
  const gct::CurveConst cc = gct::curve_const(curve_words);
  auto k = a_is_zero ? jac_double_kernel<true> : jac_double_kernel<false>;
  k<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n, fc, cc);
  return (int)cudaGetLastError();
}

extern "C" int gct_jac_fold_windows(const void* x, const void* y,
                                    const void* z, void* ox, void* oy,
                                    void* oz, int nwin, int c,
                                    const uint32_t* field_words,
                                    const uint32_t* curve_words,
                                    int a_is_zero, void* stream) {
  if (nwin <= 0) return 0;
  const gct::FieldConst fc = gct::field_const(field_words);
  const gct::CurveConst cc = gct::curve_const(curve_words);
  auto k = a_is_zero ? jac_fold_kernel<true> : jac_fold_kernel<false>;
  k<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, nwin, c, fc, cc);
  return (int)cudaGetLastError();
}
