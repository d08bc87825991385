// One level of the G2 MSM's batch-affine bucket tree over Fp2, in two
// kernels around the batched inversion of the denominators: the G2 twists
// (a = 0) of bn254 (8 words, u^2 = -1), bls12-381 (12 words, u^2 = -1) and
// bls12-377 (12 words, u^2 = -5), one instantiation each (gct::for_fp2).
//
// Replaces the Pallas kernels gnark_crypto_tpu/field/pallas/point_add2.py
// `affine_prep2` (`_prep2_kernel`) and `affine_finish2` (`_finish2_kernel`).
// The level logic is csrc/affine_level.cu's, over Elem2T (csrc/fp2.cuh):
// the same cores of csrc/point.cuh, the same one-int32-per-lane mask and
// tree bits. One thread per lane of the level.
//
// Bounds on the H100: both move far more bytes than they compute (an Fp2
// element is 8W bytes: 64 at 8 words, 96 at 12).
// * affine_prep2: reads l_suf and r_pre (4 elements), writes den, num and
//   the mask bits (2 elements and 4 bytes); 1 Fp2 product on doubling
//   lanes only.
// * affine_finish2: reads the four partials, num, 1/den and two bit words
//   (up to 10 elements and 8 bytes), writes pre, suf, the emitted point and
//   its z (7 elements); 3 Fp2 products.
#include "fp2.cuh"
#include "point.cuh"

namespace {

template <int W, int NR>
using E2 = gct::Elem2T<W, NR>;

// a = 0; one = (Montgomery one, 0)
template <int W, int NR>
__device__ __forceinline__ gct::CurveConstT<E2<W, NR>> curve2(
    const gct::ElemT<W>& one) {
  gct::CurveConstT<E2<W, NR>> cc{};
  cc.one.c0 = one;
  return cc;
}

template <int W, int NR>
__global__ void affine_prep2_kernel(const uint32_t* __restrict__ px,
                                    const uint32_t* __restrict__ py,
                                    const uint32_t* __restrict__ qx,
                                    const uint32_t* __restrict__ qy,
                                    uint32_t* __restrict__ den,
                                    uint32_t* __restrict__ num,
                                    int* __restrict__ maskbits, long long n,
                                    gct::FieldConstT<W> fc,
                                    gct::ElemT<W> one) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * 2 * W;
  E2<W, NR> d, u;
  maskbits[i] = gct::affine_prep<true>(
      gct::load_elem2<W, NR>(px + o), gct::load_elem2<W, NR>(py + o),
      gct::load_elem2<W, NR>(qx + o), gct::load_elem2<W, NR>(qy + o), d, u,
      fc, curve2<W, NR>(one));
  gct::store_elem(den + o, d);
  gct::store_elem(num + o, u);
}

template <int W, int NR>
__global__ void affine_finish2_kernel(
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
    gct::ElemT<W> one) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * 2 * W;
  const E2<W, NR> px = gct::load_elem2<W, NR>(lsx + o),
                  py = gct::load_elem2<W, NR>(lsy + o);
  const int tb = treebits[i];
  const bool eq = tb & 1, l_single = tb & 2, r_single = tb & 4;
  E2<W, NR> mx, my;
  if (eq) {  // mid = l_suf + r_pre is read only where the runs meet
    gct::affine_sum(px, py, gct::load_elem2<W, NR>(rpx + o),
                    gct::load_elem2<W, NR>(rpy + o),
                    gct::load_elem2<W, NR>(num + o),
                    gct::load_elem2<W, NR>(dinv + o), maskbits[i], mx, my,
                    fc);
  } else {
    mx = px;
    my = py;
  }
  // pt_a = eq ? mid : l_suf; z_a = 0 where pt_a is infinity, else one
  gct::store_elem(ptax + o, mx);
  gct::store_elem(ptay + o, my);
  gct::store_elem(za + o, (gct::is_zero(mx) && gct::is_zero(my))
                              ? E2<W, NR>{} : curve2<W, NR>(one).one);
  const bool to_pre = l_single && eq, to_suf = r_single && eq;
  gct::store_elem(prex + o, to_pre ? mx : gct::load_elem2<W, NR>(lpx + o));
  gct::store_elem(prey + o, to_pre ? my : gct::load_elem2<W, NR>(lpy + o));
  gct::store_elem(sufx + o, to_suf ? mx : gct::load_elem2<W, NR>(rsx + o));
  gct::store_elem(sufy + o, to_suf ? my : gct::load_elem2<W, NR>(rsy + o));
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int W>
gct::ElemT<W> host_elem(const uint32_t* words) {
  gct::ElemT<W> e;
  for (int i = 0; i < W; ++i) e.w[i] = words[i];
  return e;
}

}  // namespace

// n_words, nr: one of the pairs of gct::for_fp2; one_words: Montgomery one
// of the base field (n_words words).
extern "C" int gct_affine_prep2(const void* px, const void* py,
                                const void* qx, const void* qy, void* den,
                                void* num, void* maskbits, long long n,
                                int n_words, int nr,
                                const uint32_t* field_words,
                                const uint32_t* one_words, void* stream) {
  return gct::for_fp2(n_words, nr, [&](auto width, auto nonres) {
    constexpr int W = decltype(width)::value, NR = decltype(nonres)::value;
    if (n <= 0) return 0;
    affine_prep2_kernel<W, NR><<<blocks_for(n), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)qx,
        (const uint32_t*)qy, (uint32_t*)den, (uint32_t*)num, (int*)maskbits,
        n, gct::field_const<W>(field_words), host_elem<W>(one_words));
    return (int)cudaGetLastError();
  });
}

// in: the ten (n, 2, n_words) inputs l_pre.x, l_pre.y, l_suf.x, l_suf.y,
// r_pre.x, r_pre.y, r_suf.x, r_suf.y, num, dinv; out: the seven
// (n, 2, n_words) outputs pre.x, pre.y, suf.x, suf.y, pt_a.x, pt_a.y, z_a.
extern "C" int gct_affine_finish2(const void* const* in, const void* maskbits,
                                  const void* treebits, void* const* out,
                                  long long n, int n_words, int nr,
                                  const uint32_t* field_words,
                                  const uint32_t* one_words, void* stream) {
  return gct::for_fp2(n_words, nr, [&](auto width, auto nonres) {
    constexpr int W = decltype(width)::value, NR = decltype(nonres)::value;
    if (n <= 0) return 0;
    const uint32_t* const* i = (const uint32_t* const*)in;
    uint32_t* const* o = (uint32_t* const*)out;
    affine_finish2_kernel<W, NR><<<blocks_for(n), kThreads, 0,
                                   (cudaStream_t)stream>>>(
        i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7], i[8], i[9],
        (const int*)maskbits, (const int*)treebits, o[0], o[1], o[2], o[3],
        o[4], o[5], o[6], n, gct::field_const<W>(field_words),
        host_elem<W>(one_words));
    return (int)cudaGetLastError();
  });
}
