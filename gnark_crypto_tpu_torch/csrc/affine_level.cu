// One level of the MSM's batch-affine bucket tree, in two kernels around
// the batched inversion of the denominators, at W = 8, 10, 12, 20 and 24
// words (at 8 for any q < 2^256: secp256k1/r1 too).
//
// Replaces the Pallas kernels gnark_crypto_tpu/field/pallas/point_add.py
// `affine_prep` (`_prep_kernel`) and `affine_finish` (`_finish_kernel`).
// There the per-lane mask bits travel as (8, N) int32 tiles; here as one
// int32 per lane. One thread per lane of the level (csrc/point.cuh cores).
//
// Bounds on the H100: both move far more bytes than they compute (an
// element is 4W bytes: 32 at W = 8, 40 at W = 10, 48 at W = 12, 80 at
// W = 20, 96 at W = 24).
// * affine_prep: reads l_suf and r_pre (4 elements), writes den, num and
//   the mask bits (2 elements and 4 bytes); 1 product on doubling lanes
//   only.
// * affine_finish: reads the four partials, num, 1/den and two bit words
//   (10 elements and 8 bytes), writes pre, suf, the emitted point and its z
//   (7 elements); 3 products.
// So a level is two passes over device memory at 3.35 TB/s, and the design
// keeps each to one read of its inputs and one write of its outputs.
//
// maskbits: MB_DBL | MB_INFOUT | MB_PINF | MB_QINF of l_suf + r_pre;
// treebits: bit 0 eq (l_suf and r_pre are one digit-run), bit 1 l_single,
// bit 2 r_single (the node spans one run).
//
// Many products a kernel: the CIOS keeps its outer loop rolled at 20 and 24
// words (csrc/field.cuh).
#define GCT_ROLLED_CIOS_FROM 20
#include "point.cuh"

namespace {

template <int W, bool A_ZERO>
__global__ void affine_prep_kernel(const uint32_t* __restrict__ px,
                                   const uint32_t* __restrict__ py,
                                   const uint32_t* __restrict__ qx,
                                   const uint32_t* __restrict__ qy,
                                   uint32_t* __restrict__ den,
                                   uint32_t* __restrict__ num,
                                   int* __restrict__ maskbits, long long n,
                                   gct::FieldConstT<W> fc,
                                   gct::CurveConstT<gct::ElemT<W>> cc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W;
  gct::ElemT<W> d, u;
  maskbits[i] = gct::affine_prep<A_ZERO>(
      gct::load_elem<W>(px + o), gct::load_elem<W>(py + o),
      gct::load_elem<W>(qx + o), gct::load_elem<W>(qy + o), d, u, fc, cc);
  gct::store_elem(den + o, d);
  gct::store_elem(num + o, u);
}

template <int W>
__global__ void affine_finish_kernel(
    const uint32_t* __restrict__ lpx, const uint32_t* __restrict__ lpy,
    const uint32_t* __restrict__ lsx, const uint32_t* __restrict__ lsy,
    const uint32_t* __restrict__ rpx, const uint32_t* __restrict__ rpy,
    const uint32_t* __restrict__ rsx, const uint32_t* __restrict__ rsy,
    const uint32_t* __restrict__ num, const uint32_t* __restrict__ dinv,
    const int* __restrict__ maskbits, const int* __restrict__ treebits,
    uint32_t* __restrict__ prex, uint32_t* __restrict__ prey,
    uint32_t* __restrict__ sufx, uint32_t* __restrict__ sufy,
    uint32_t* __restrict__ ptax, uint32_t* __restrict__ ptay,
    uint32_t* __restrict__ za, long long n, gct::FieldConstT<W> fc,
    gct::CurveConstT<gct::ElemT<W>> cc) {
  using Elem = gct::ElemT<W>;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W;
  const Elem px = gct::load_elem<W>(lsx + o), py = gct::load_elem<W>(lsy + o);
  const int tb = treebits[i];
  const bool eq = tb & 1, l_single = tb & 2, r_single = tb & 4;
  Elem mx, my;
  if (eq) {  // mid = l_suf + r_pre is read only where the runs meet
    gct::affine_sum(px, py, gct::load_elem<W>(rpx + o),
                    gct::load_elem<W>(rpy + o), gct::load_elem<W>(num + o),
                    gct::load_elem<W>(dinv + o), maskbits[i], mx, my, fc);
  } else {
    mx = px;
    my = py;
  }
  // pt_a = eq ? mid : l_suf; z_a = 0 where pt_a is infinity, else one
  gct::store_elem(ptax + o, mx);
  gct::store_elem(ptay + o, my);
  gct::store_elem(za + o, (gct::is_zero(mx) && gct::is_zero(my))
                              ? Elem{} : cc.one);
  const bool to_pre = l_single && eq, to_suf = r_single && eq;
  gct::store_elem(prex + o, to_pre ? mx : gct::load_elem<W>(lpx + o));
  gct::store_elem(prey + o, to_pre ? my : gct::load_elem<W>(lpy + o));
  gct::store_elem(sufx + o, to_suf ? mx : gct::load_elem<W>(rsx + o));
  gct::store_elem(sufy + o, to_suf ? my : gct::load_elem<W>(rsy + o));
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// n_words: 8, 10, 12, 20 or 24; curve_words: a in Montgomery form
// (n_words words), then Montgomery one (n_words).
extern "C" int gct_affine_prep(const void* px, const void* py, const void* qx,
                               const void* qy, void* den, void* num,
                               void* maskbits, long long n, int n_words,
                               const uint32_t* field_words,
                               const uint32_t* curve_words, int a_is_zero,
                               void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    auto k = a_is_zero ? affine_prep_kernel<W, true>
                       : affine_prep_kernel<W, false>;
    k<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)qx,
        (const uint32_t*)qy, (uint32_t*)den, (uint32_t*)num, (int*)maskbits,
        n, gct::field_const<W>(field_words), gct::curve_const<W>(curve_words));
    return (int)cudaGetLastError();
  });
}

// in: the ten (n, n_words) inputs l_pre.x, l_pre.y, l_suf.x, l_suf.y,
// r_pre.x, r_pre.y, r_suf.x, r_suf.y, num, dinv; out: the seven
// (n, n_words) outputs pre.x, pre.y, suf.x, suf.y, pt_a.x, pt_a.y, z_a.
extern "C" int gct_affine_finish(const void* const* in, const void* maskbits,
                                 const void* treebits, void* const* out,
                                 long long n, int n_words,
                                 const uint32_t* field_words,
                                 const uint32_t* curve_words, void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    const uint32_t* const* i = (const uint32_t* const*)in;
    uint32_t* const* o = (uint32_t* const*)out;
    affine_finish_kernel<W><<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7], i[8], i[9],
        (const int*)maskbits, (const int*)treebits, o[0], o[1], o[2], o[3],
        o[4], o[5], o[6], n, gct::field_const<W>(field_words),
        gct::curve_const<W>(curve_words));
    return (int)cudaGetLastError();
  });
}
