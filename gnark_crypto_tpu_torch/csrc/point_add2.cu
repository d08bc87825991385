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
// The double also runs over Half2T, a pair of threads a point.
//
// Bounds on the H100 (an Fp2 product is 3 base products, an Fp2 square 2:
// 136 multiply-adds a base product at 8 words, 300 at 12; an Fp2 element
// 8W bytes):
// * jac_add2: 48W bytes in, 24W out, 16 Fp2 products: bound by operations.
// * jac_double2: 24W bytes in and out, 2 Fp2 products and 5 squares (16
//   base products), bound by operations and by registers: a thread holds
//   the point's 6W words and the products' temporaries (255 registers and
//   spills at 12 words with gct::mont_mul). Every product is the column
//   product gct::mont_mul_ilp (IlpFieldConstT); a pair of threads a point
//   (3W words a thread, 2 base products a lane for a product and 1 for a
//   square, partner halves by shuffle) at (12, -1), one thread elsewhere
//   (kDbl2Pair): the fastest of the sweep of tools/exp_dbl2_sweep.py on
//   the H100 (PERF.md), which builds the other designs in a library of
//   its own.
// * jac_fold_windows2: latency. c*(nwin-1) doublings and nwin-1 adds in one
//   dependent chain, about 4,900 serial base products for an MSM at 2^20.
// An Fp2 point is three times a G1 point's state: the add and fold cores
// spill (at 12 words two points are 144 words), which `-Xptxas -v` reports
// per instantiation in lib<name>.log of the build.
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

// One thread a point (Elem2T), the squares in 2 base products each.
template <int W, int NR, class FC>
__global__ void jac_double2_kernel(const uint32_t* __restrict__ x1,
                                   const uint32_t* __restrict__ y1,
                                   const uint32_t* __restrict__ z1,
                                   uint32_t* __restrict__ x3,
                                   uint32_t* __restrict__ y3,
                                   uint32_t* __restrict__ z3, long long n,
                                   FC fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const gct::CurveConstT<gct::Elem2T<W, NR>> cc{};
  store_pt<W, NR>(x3, y3, z3, i,
                  gct::jac_double<true>(load_pt<W, NR>(x1, y1, z1, i), fc,
                                        cc));
}

// A pair of neighbouring threads a point (Half2T): lane 2i + k holds
// component k of every coordinate of point i, 3W words a thread. Lanes
// past n run on zeros and store nothing, so every shuffle sees its
// partner.
template <int W, int NR, class FC>
__global__ void jac_double2_pair_kernel(const uint32_t* __restrict__ x1,
                                        const uint32_t* __restrict__ y1,
                                        const uint32_t* __restrict__ z1,
                                        uint32_t* __restrict__ x3,
                                        uint32_t* __restrict__ y3,
                                        uint32_t* __restrict__ z3,
                                        long long n, FC fc) {
  using H = gct::Half2T<W, NR>;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = g >> 1;
  const long long off = i * 2 * W + (g & 1) * W;
  const bool valid = i < n;
  gct::JacT<H> p{};
  if (valid) {
    p.x.c = gct::load_elem<W>(x1 + off);
    p.y.c = gct::load_elem<W>(y1 + off);
    p.z.c = gct::load_elem<W>(z1 + off);
  }
  const gct::CurveConstT<H> cc{};
  const gct::JacT<H> r = gct::jac_double<true>(p, fc, cc);
  if (valid) {
    gct::store_elem(x3 + off, r.x.c);
    gct::store_elem(y3 + off, r.y.c);
    gct::store_elem(z3 + off, r.z.c);
  }
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

// a pair of threads a point for jac_double2 at (W, NR), else one thread
template <int W, int NR>
constexpr bool kDbl2Pair = W == 12 && NR == -1;

template <int W, int NR, bool PAIR, class FC>
int launch_double2(const void* x1, const void* y1, const void* z1, void* x3,
                   void* y3, void* z3, long long n, const FC& fc,
                   int threads, cudaStream_t stream) {
  const long long lanes = PAIR ? 2 * n : n;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  auto go = [&](auto kernel) {
    kernel<<<blocks, threads, 0, stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n, fc);
  };
  if constexpr (PAIR)
    go(jac_double2_pair_kernel<W, NR, FC>);
  else
    go(jac_double2_kernel<W, NR, FC>);
  return (int)cudaGetLastError();
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
    return launch_double2<W, NR, kDbl2Pair<W, NR>>(
        x1, y1, z1, x3, y3, z3, n, gct::ilp_field_const<W>(field_words),
        kThreads, (cudaStream_t)stream);
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
