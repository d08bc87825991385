// Shared-memory sub-NTT: every block runs all log_s butterfly stages of one
// row of S = 2^log_s elements in shared memory, with one pass over device
// memory for the row (read once, written once).
//
// Elements are W words (8, 10 or 12: bn254 Fr, bw6-633 Fr, bw6-761 Fr).
// Row r, element j lives at x[(r * row_stride + j * elem_stride) * W]:
// contiguous rows (elem_stride 1) serve the fused tail of the radix-2
// transform and the row step of the four-step transform; strided rows
// (elem_stride = number of rows) serve the four-step column step without a
// transpose. Stage s (local) pairs lo and lo + half, half = S >> (s + 1),
// with twiddle tw[(off << s) << tw_shift], off = lo mod half:
//   DIF (Gentleman-Sande): (a + b, (a - b) w), stages s = 0 .. log_s - 1;
//   DIT (Cooley-Tukey):    (a + w b, a - w b), stages s = log_s - 1 .. 0.
// After the stages each element is optionally multiplied by
// twist[same position] (the four-step twist, fused into this pass).
//
// Shared memory holds the row word-major (word w of element j at
// sm[w * S + j]), so neighbouring threads touch neighbouring banks.
#pragma once

#include "field.cuh"

namespace gct {

// Host: f(std::integral_constant<int, W>{}) for the NTT widths 8, 10 and
// 12, the Fr of every NTT field; any other width (for_width's 20 and 24
// included: no NTT field has them) returns cudaErrorInvalidValue, and the
// wrapper has raised before that.
template <class F>
inline int for_ntt_width(int n_words, F&& f) {
  switch (n_words) {
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 10:
      return f(std::integral_constant<int, 10>{});
    case 12:
      return f(std::integral_constant<int, 12>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

constexpr int kBlockThreads = 512;
// 4W << 12 bytes of shared memory: 128 KB at 8 words, 160 KB at 10 and
// 192 KB at 12, all within the H100's 227 KB for one block
constexpr int kMaxLogS = 12;

template <int W, bool DIT>
__global__ void __launch_bounds__(kBlockThreads)
ntt_block_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ tw, int tw_shift, int log_s,
                 long long row_stride, long long elem_stride,
                 const uint32_t* __restrict__ twist, FieldConstT<W> fc) {
  using Elem = ElemT<W>;
  extern __shared__ uint32_t sm[];
  const int S = 1 << log_s;
  const long long row = (long long)blockIdx.x * row_stride;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const Elem e = load_elem<W>(x + (row + (long long)j * elem_stride) * W);
#pragma unroll
    for (int w = 0; w < W; ++w) sm[w * S + j] = e.w[w];
  }
  __syncthreads();
  for (int st = 0; st < log_s; ++st) {
    const int s = DIT ? log_s - 1 - st : st;
    const int hlog = log_s - 1 - s;  // log2(half)
    const int half = 1 << hlog;
    for (int b = threadIdx.x; b < (S >> 1); b += blockDim.x) {
      const int off = b & (half - 1);
      const int lo = ((b >> hlog) << (hlog + 1)) | off;
      const int hi = lo + half;
      Elem u, v;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        u.w[w] = sm[w * S + lo];
        v.w[w] = sm[w * S + hi];
      }
      const Elem t =
          load_elem<W>(tw + ((long long)off << (s + tw_shift)) * W);
      Elem o0, o1;
      if (DIT) {
        v = mont_mul(v, t, fc);
        o0 = add_mod(u, v, fc);
        o1 = sub_mod(u, v, fc);
      } else {
        o0 = add_mod(u, v, fc);
        o1 = mont_mul(sub_mod(u, v, fc), t, fc);
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        sm[w * S + lo] = o0.w[w];
        sm[w * S + hi] = o1.w[w];
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const long long pos = row + (long long)j * elem_stride;
    Elem e;
#pragma unroll
    for (int w = 0; w < W; ++w) e.w[w] = sm[w * S + j];
    if (twist != nullptr) e = mont_mul(e, load_elem<W>(twist + pos * W), fc);
    store_elem(y + pos * W, e);
  }
}

// Launches `rows` blocks on `stream` at the width n_words (8, 10 or 12);
// returns the CUDA error code (0 = ok).
inline int launch_ntt_block(int n_words, const void* x, void* y, const void* tw,
                            int tw_shift, int log_s, long long rows,
                            long long row_stride, long long elem_stride,
                            const void* twist, int dit,
                            const uint32_t* field_words, void* stream) {
  if (log_s < 0 || log_s > kMaxLogS) return (int)cudaErrorInvalidValue;
  return for_ntt_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (rows <= 0) return 0;
    const size_t smem = (size_t)W * sizeof(uint32_t) << log_s;
    const int half = (1 << log_s) >> 1;
    const int threads =
        half < 1 ? 1 : (half < kBlockThreads ? half : kBlockThreads);
    auto kernel =
        dit ? ntt_block_kernel<W, true> : ntt_block_kernel<W, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, tw_shift,
        log_s, row_stride, elem_stride, (const uint32_t*)twist,
        field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}

}  // namespace gct
