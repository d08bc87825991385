// Radix-2 NTT over (n, W) word elements, W = 8, 10 or 12 (bn254 Fr,
// bw6-633 Fr, bw6-761 Fr): one kernel per wide stage plus one shared-memory
// kernel for all the remaining stages.
//
// Replaces the Pallas kernels of gnark_crypto_tpu/ntt/pallas_ntt.py
// `run_stages_pallas`: `_big_stage` (one pass per stage whose half-block
// spans whole lane tiles) and `_tail_pass` / `_tail_stage_transposed` (the
// fused tail). Here `ntt_stage_kernel` runs one stage with one thread per
// butterfly, for the stages whose half-block exceeds a shared-memory row,
// and `ntt_block_kernel` (ntt_block.cuh) runs the last t stages (DIF) or
// the first t stages (DIT) of each contiguous 2^t block in one pass.
//
// Bound on the H100: each butterfly stage moves 8W bytes of elements plus
// its twiddle per butterfly against one Montgomery product (2W^2 + W
// multiply-adds: 136 at 8 words, 210 at 10, 300 at 12), so every pass is
// memory-bound; the transform's cost is its number of passes over the
// array. The design cuts the passes from k to k - t + 1 by fusing the t
// innermost stages in shared memory (t = 10: rows of 32, 40 and 48 KB at
// 8, 10 and 12 words, several blocks per SM).
#include "ntt_block.cuh"

namespace {

template <int W, bool DIT>
__global__ void ntt_stage_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ tw0, int k,
                                 int s, gct::FieldConstT<W> fc) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (1LL << (k - 1))) return;
  const int hlog = k - 1 - s;  // log2(half)
  const long long off = b & ((1LL << hlog) - 1);
  const long long lo = ((b >> hlog) << (hlog + 1)) | off;
  const long long hi = lo + (1LL << hlog);
  gct::ElemT<W> u = gct::load_elem<W>(x + lo * W);
  gct::ElemT<W> v = gct::load_elem<W>(x + hi * W);
  const gct::ElemT<W> t = gct::load_elem<W>(tw0 + (off << s) * W);
  gct::ElemT<W> o0, o1;
  if (DIT) {
    v = gct::mont_mul(v, t, fc);
    o0 = gct::add_mod(u, v, fc);
    o1 = gct::sub_mod(u, v, fc);
  } else {
    o0 = gct::add_mod(u, v, fc);
    o1 = gct::mont_mul(gct::sub_mod(u, v, fc), t, fc);
  }
  gct::store_elem(y + lo * W, o0);
  gct::store_elem(y + hi * W, o1);
}

}  // namespace

// One butterfly stage s of a size-2^k transform; tw0[j] = w^j, j < 2^(k-1).
// n_words: 8, 10 or 12; field_words: q's n_words words, then -q^-1 mod 2^32.
extern "C" int gct_ntt_radix2_stage(const void* x, void* y, const void* tw0,
                                    int k, int s, int dit, int n_words,
                                    const uint32_t* field_words,
                                    void* stream) {
  if (k < 1 || s < 0 || s >= k) return (int)cudaErrorInvalidValue;
  return gct::for_ntt_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    const int threads = 256;
    const long long nb = 1LL << (k - 1);
    const long long blocks = (nb + threads - 1) / threads;
    auto kernel = dit ? ntt_stage_kernel<W, true> : ntt_stage_kernel<W, false>;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw0, k, s,
        gct::field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}

// The fused stages of every contiguous 2^log_s block (`rows` blocks):
// twiddle of local stage s is tw0[(off << s) << tw_shift].
extern "C" int gct_ntt_radix2_block(const void* x, void* y, const void* tw0,
                                    int tw_shift, int log_s, long long rows,
                                    int dit, int n_words,
                                    const uint32_t* field_words,
                                    void* stream) {
  return gct::launch_ntt_block(n_words, x, y, tw0, tw_shift, log_s, rows,
                               1LL << log_s, 1, nullptr, dit, field_words,
                               stream);
}
