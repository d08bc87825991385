// One level of the G2 MSM's batch-affine bucket tree over Fp2, in two
// kernels around the batched inversion of the denominators: bn254's G2
// (a = 0, u^2 = -1).
//
// Replaces the Pallas kernels gnark_crypto_tpu/field/pallas/point_add2.py
// `affine_prep2` (`_prep2_kernel`) and `affine_finish2` (`_finish2_kernel`).
// The level logic is csrc/affine_level.cu's, over Elem2 (csrc/fp2.cuh):
// the same cores of csrc/point.cuh, the same one-int32-per-lane mask and
// tree bits. One thread per lane of the level.
//
// Bounds on the H100: both move far more bytes than they compute.
// * affine_prep2: reads l_suf and r_pre (256 bytes), writes den, num and
//   the mask bits (132 bytes); 1 Fp2 product on doubling lanes only.
// * affine_finish2: reads the four partials, num, 1/den and two bit words
//   (648 bytes), writes pre, suf, the emitted point and its z (448 bytes);
//   3 Fp2 products.
#include "fp2.cuh"
#include "point.cuh"

namespace {

using gct::Elem2;
constexpr int W2 = 2 * gct::W;  // words per Fp2 element

// a = 0; one = (Montgomery one, 0)
__device__ __forceinline__ gct::CurveConstT<Elem2> curve2(
    const gct::Elem& one) {
  gct::CurveConstT<Elem2> cc{};
  cc.one.c0 = one;
  return cc;
}

__global__ void affine_prep2_kernel(const uint32_t* __restrict__ px,
                                    const uint32_t* __restrict__ py,
                                    const uint32_t* __restrict__ qx,
                                    const uint32_t* __restrict__ qy,
                                    uint32_t* __restrict__ den,
                                    uint32_t* __restrict__ num,
                                    int* __restrict__ maskbits, long long n,
                                    gct::FieldConst fc, gct::Elem one) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W2;
  Elem2 d, u;
  maskbits[i] = gct::affine_prep<true>(
      gct::load_elem2(px + o), gct::load_elem2(py + o),
      gct::load_elem2(qx + o), gct::load_elem2(qy + o), d, u, fc,
      curve2(one));
  gct::store_elem(den + o, d);
  gct::store_elem(num + o, u);
}

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
    uint32_t* __restrict__ za, long long n, gct::FieldConst fc,
    gct::Elem one) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W2;
  const Elem2 px = gct::load_elem2(lsx + o), py = gct::load_elem2(lsy + o);
  const int tb = treebits[i];
  const bool eq = tb & 1, l_single = tb & 2, r_single = tb & 4;
  Elem2 mx, my;
  if (eq) {  // mid = l_suf + r_pre is read only where the runs meet
    gct::affine_sum(px, py, gct::load_elem2(rpx + o),
                    gct::load_elem2(rpy + o), gct::load_elem2(num + o),
                    gct::load_elem2(dinv + o), maskbits[i], mx, my, fc);
  } else {
    mx = px;
    my = py;
  }
  // pt_a = eq ? mid : l_suf; z_a = 0 where pt_a is infinity, else one
  gct::store_elem(ptax + o, mx);
  gct::store_elem(ptay + o, my);
  gct::store_elem(za + o, (gct::is_zero(mx) && gct::is_zero(my))
                              ? Elem2{} : curve2(one).one);
  const bool to_pre = l_single && eq, to_suf = r_single && eq;
  gct::store_elem(prex + o, to_pre ? mx : gct::load_elem2(lpx + o));
  gct::store_elem(prey + o, to_pre ? my : gct::load_elem2(lpy + o));
  gct::store_elem(sufx + o, to_suf ? mx : gct::load_elem2(rsx + o));
  gct::store_elem(sufy + o, to_suf ? my : gct::load_elem2(rsy + o));
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

gct::Elem host_elem(const uint32_t* words) {
  gct::Elem e;
  for (int i = 0; i < gct::W; ++i) e.w[i] = words[i];
  return e;
}

}  // namespace

// one_words: Montgomery one of the base field (8 words).
extern "C" int gct_affine_prep2(const void* px, const void* py,
                                const void* qx, const void* qy, void* den,
                                void* num, void* maskbits, long long n,
                                const uint32_t* field_words,
                                const uint32_t* one_words, void* stream) {
  if (n <= 0) return 0;
  affine_prep2_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)qx,
      (const uint32_t*)qy, (uint32_t*)den, (uint32_t*)num, (int*)maskbits, n,
      gct::field_const(field_words), host_elem(one_words));
  return (int)cudaGetLastError();
}

// in: the ten (n, 2, 8) inputs l_pre.x, l_pre.y, l_suf.x, l_suf.y, r_pre.x,
// r_pre.y, r_suf.x, r_suf.y, num, dinv; out: the seven (n, 2, 8) outputs
// pre.x, pre.y, suf.x, suf.y, pt_a.x, pt_a.y, z_a.
extern "C" int gct_affine_finish2(const void* const* in, const void* maskbits,
                                  const void* treebits, void* const* out,
                                  long long n, const uint32_t* field_words,
                                  const uint32_t* one_words, void* stream) {
  if (n <= 0) return 0;
  const uint32_t* const* i = (const uint32_t* const*)in;
  uint32_t* const* o = (uint32_t* const*)out;
  affine_finish2_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7], i[8], i[9],
      (const int*)maskbits, (const int*)treebits, o[0], o[1], o[2], o[3],
      o[4], o[5], o[6], n, gct::field_const(field_words),
      host_elem(one_words));
  return (int)cudaGetLastError();
}
