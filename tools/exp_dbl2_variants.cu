// The designs of csrc/exp.cu and csrc/point_add2.cu that the package does
// not build, for tools/exp_dbl2_sweep.py: the same kernel templates, with
// the design a run-time argument. Built by that tool into a library of its
// own (nvcc with the package's flags and -I csrc); the package's kernels
// fix the fastest design at compile time.
#include "exp.cu"
#include "point_add2.cu"

// exp_const with a team of `team` lanes an element (1, 2, 4 or 8) and
// `lanes` lanes a role (a multiple of 32 up to 128); else as gct_exp_const.
extern "C" int gct_exp_const_variant(const void* x, void* out, long long n,
                                     int n_words, const uint32_t* field_words,
                                     const uint32_t* one_words,
                                     const uint32_t* exp_words, int nbits,
                                     int team, int lanes, void* stream) {
  if (lanes <= 0 || lanes % 32 || lanes > 128)
    return (int)cudaErrorInvalidValue;
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    gct::ElemT<W> one;
    ExpConst<W> ec;
    exp_args<W>(one_words, exp_words, nbits, one, ec);
    const gct::FieldConstT<W> fc = gct::field_const<W>(field_words);
    const cudaStream_t s = (cudaStream_t)stream;
    switch (team) {
      case 1:
        return launch<W, 1>(x, out, n, fc, ec, one, lanes, s);
      case 2:
        return launch<W, 2>(x, out, n, fc, ec, one, lanes, s);
      case 4:
        return launch<W, 4>(x, out, n, fc, ec, one, lanes, s);
      case 8:
        return launch<W, 8>(x, out, n, fc, ec, one, lanes, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}

// jac_double2 with a pair of threads a point or one (pair), the column
// product or gct::mont_mul (ilp), and `threads` a block (a multiple of 32
// up to 1024); else as gct_jac_double2.
extern "C" int gct_jac_double2_variant(const void* x1, const void* y1,
                                       const void* z1, void* x3, void* y3,
                                       void* z3, long long n, int n_words,
                                       int nr, const uint32_t* field_words,
                                       int pair, int ilp, int threads,
                                       void* stream) {
  if (threads <= 0 || threads % 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  return gct::for_fp2(n_words, nr, [&](auto width, auto nonres) {
    constexpr int W = decltype(width)::value, NR = decltype(nonres)::value;
    if (n <= 0) return 0;
    const gct::FieldConstT<W> fc = gct::field_const<W>(field_words);
    const gct::IlpFieldConstT<W> ilp_fc = gct::ilp_field_const<W>(field_words);
    const cudaStream_t s = (cudaStream_t)stream;
    if (pair && ilp)
      return launch_double2<W, NR, true>(x1, y1, z1, x3, y3, z3, n, ilp_fc,
                                         threads, s);
    if (pair)
      return launch_double2<W, NR, true>(x1, y1, z1, x3, y3, z3, n, fc,
                                         threads, s);
    if (ilp)
      return launch_double2<W, NR, false>(x1, y1, z1, x3, y3, z3, n, ilp_fc,
                                          threads, s);
    return launch_double2<W, NR, false>(x1, y1, z1, x3, y3, z3, n, fc,
                                        threads, s);
  });
}
