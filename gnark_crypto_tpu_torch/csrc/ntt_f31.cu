// Radix-2 NTT over the 31-bit fields (koalabear, babybear): one uint32 per
// element, canonical Montgomery values with R = 2^32.
//
// Replaces the Pallas kernels of gnark_crypto_tpu/ntt/pallas_ntt_f31.py:
//   * `_big_stage` (one radix-2 stage per pass) and `_big_stage_r4` (two
//     consecutive stages fused, radix 4) -> `ntt_f31_stage<DIT, R>`, R = 1
//     or 2 stages, one thread per butterfly or per 4-point group;
//   * `_tail_pass` (every stage whose half-block fits a tile) and
//     `run_batch_small_f31` (B independent transforms of n <= tile) ->
//     `ntt_f31_block<DIT>`: each block loads a chunk of 2^kTileLog elements
//     into shared memory, runs every stage of the size-2^log_n transforms
//     the chunk holds, and writes the chunk back. A chunk holds one row of
//     the fused tail or several rows of the batch form.
// The TPU's (8, W) column-major tiles do not carry over: both kernels work
// on the flat array. Stage s pairs lo and lo + half (half = n >> (s + 1))
// with twiddle tw0[(lo mod half) << s]; DIF runs the stages in ascending
// order, (a + b, (a - b) w), DIT in descending order, (a + w b, a - w b),
// as gnark_crypto_tpu/ntt/fft.py `_run_stages`, so the outputs are the
// same canonical values.
//
// The product is one 32x32->64 multiply, m = (u32)t * qinv, (t + m q) >> 32
// and one conditional subtraction: 3 multiply-adds. A butterfly moves 12-16
// bytes for those 3 multiply-adds, so every pass is memory-bound on the
// H100 and the transform's cost is its number of passes over the array:
// the radix-4 form halves the wide stages' passes, and the block kernel
// runs the last kTileLog stages (DIF) or the first (DIT) in one pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 13;  // 2^13 x 4 B = 32 KB of shared memory
constexpr int kBlockThreads = 512;

struct F31 {
  uint32_t q;
  uint32_t qinv;  // -q^-1 mod 2^32
};

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            const F31& f) {
  const uint32_t s = a + b;  // < 2q < 2^32
  return s >= f.q ? s - f.q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            const F31& f) {
  const uint32_t d = a - b;
  return a < b ? d + f.q : d;
}

// a * b * 2^-32 mod q, canonical; t + m q < 2^62 + 2^63 fits in 64 bits.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             const F31& f) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * f.qinv;
  const uint32_t r = (uint32_t)((t + (uint64_t)m * f.q) >> 32);
  return r >= f.q ? r - f.q : r;
}

template <bool DIT>
__device__ __forceinline__ void butterfly(uint32_t& u, uint32_t& v,
                                          uint32_t w, const F31& f) {
  if (DIT) {
    const uint32_t t = mont_mul(v, w, f);
    v = sub_mod(u, t, f);
    u = add_mod(u, t, f);
  } else {
    const uint32_t d = sub_mod(u, v, f);
    u = add_mod(u, v, f);
    v = mont_mul(d, w, f);
  }
}

// R = 1: stage s, one thread per butterfly. R = 2: stages s and s + 1, one
// thread per group {j, j + h, j + 2h, j + 3h}, h = n >> (s + 2).
template <bool DIT, int R>
__global__ void ntt_f31_stage(const uint32_t* __restrict__ x,
                              uint32_t* __restrict__ y,
                              const uint32_t* __restrict__ tw0, int k, int s,
                              F31 f) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (1LL << (k - R))) return;
  const int hlog = k - R - s;  // log2 of the last fused stage's half
  const long long h = 1LL << hlog;
  const long long off = g & (h - 1);
  const long long j = ((g >> hlog) << (hlog + R)) | off;
  if (R == 1) {
    uint32_t u = x[j], v = x[j + h];
    butterfly<DIT>(u, v, __ldg(tw0 + (off << s)), f);
    y[j] = u;
    y[j + h] = v;
    return;
  }
  uint32_t a = x[j], b = x[j + h], c = x[j + 2 * h], d = x[j + 3 * h];
  const uint32_t w0 = __ldg(tw0 + (off << s));        // stage s, (a, c)
  const uint32_t w1 = __ldg(tw0 + ((off + h) << s));  // stage s, (b, d)
  const uint32_t w2 = __ldg(tw0 + (off << (s + 1)));  // stage s + 1
  if (DIT) {
    butterfly<true>(a, b, w2, f);
    butterfly<true>(c, d, w2, f);
    butterfly<true>(a, c, w0, f);
    butterfly<true>(b, d, w1, f);
  } else {
    butterfly<false>(a, c, w0, f);
    butterfly<false>(b, d, w1, f);
    butterfly<false>(a, b, w2, f);
    butterfly<false>(c, d, w2, f);
  }
  y[j] = a;
  y[j + h] = b;
  y[j + 2 * h] = c;
  y[j + 3 * h] = d;
}

// Every stage of the size-2^log_n transforms held by one chunk of
// 2^kTileLog elements (the last chunk may be shorter; `total` is a multiple
// of 2^log_n). Local stage s uses twiddle tw[(off << s) << tw_shift].
template <bool DIT>
__global__ void __launch_bounds__(kBlockThreads)
ntt_f31_block(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
              const uint32_t* __restrict__ tw, int tw_shift, int log_n,
              long long total, F31 f) {
  __shared__ uint32_t sm[1 << kTileLog];
  const long long base = (long long)blockIdx.x << kTileLog;
  const long long left = total - base;
  const int c = left < (1LL << kTileLog) ? (int)left : 1 << kTileLog;
  for (int i = threadIdx.x; i < c; i += blockDim.x) sm[i] = x[base + i];
  __syncthreads();
  for (int st = 0; st < log_n; ++st) {
    const int s = DIT ? log_n - 1 - st : st;
    const int hlog = log_n - 1 - s;
    const int half = 1 << hlog;
    for (int b = threadIdx.x; b < (c >> 1); b += blockDim.x) {
      const int off = b & (half - 1);
      const int lo = ((b >> hlog) << (hlog + 1)) | off;
      uint32_t u = sm[lo], v = sm[lo + half];
      butterfly<DIT>(u, v, __ldg(tw + ((long long)off << (s + tw_shift))), f);
      sm[lo] = u;
      sm[lo + half] = v;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < c; i += blockDim.x) y[base + i] = sm[i];
}

template <int R>
int launch_stage(const void* x, void* y, const void* tw0, int k, int s,
                 int dit, F31 f, cudaStream_t stream) {
  const int threads = 256;
  const long long groups = 1LL << (k - R);
  const unsigned blocks = (unsigned)((groups + threads - 1) / threads);
  if (dit) {
    ntt_f31_stage<true, R><<<blocks, threads, 0, stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw0, k, s, f);
  } else {
    ntt_f31_stage<false, R><<<blocks, threads, 0, stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw0, k, s, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Stage s (stages = 1) or stages s, s + 1 (stages = 2) of a size-2^k
// transform; tw0[j] = w^j, j < 2^(k-1).
extern "C" int gct_ntt_f31_stage(const void* x, void* y, const void* tw0,
                                 int k, int s, int stages, int dit,
                                 uint32_t q, uint32_t qinv, void* stream) {
  if (stages < 1 || stages > 2 || s < 0 || s + stages > k || k > 40)
    return (int)cudaErrorInvalidValue;
  const F31 f{q, qinv};
  return stages == 1
             ? launch_stage<1>(x, y, tw0, k, s, dit, f, (cudaStream_t)stream)
             : launch_stage<2>(x, y, tw0, k, s, dit, f, (cudaStream_t)stream);
}

// Every stage of each contiguous 2^log_n block of `total` elements.
extern "C" int gct_ntt_f31_block(const void* x, void* y, const void* tw,
                                 int tw_shift, int log_n, long long total,
                                 int dit, uint32_t q, uint32_t qinv,
                                 void* stream) {
  if (log_n < 0 || log_n > kTileLog || total <= 0 ||
      total % (1LL << log_n) != 0)
    return (int)cudaErrorInvalidValue;
  const F31 f{q, qinv};
  const long long chunk = total < (1LL << kTileLog) ? total : 1LL << kTileLog;
  const int threads = chunk / 2 < kBlockThreads
                          ? (chunk / 2 < 32 ? 32 : (int)(chunk / 2))
                          : kBlockThreads;
  const unsigned blocks =
      (unsigned)((total + (1LL << kTileLog) - 1) >> kTileLog);
  if (dit) {
    ntt_f31_block<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, tw_shift,
        log_n, total, f);
  } else {
    ntt_f31_block<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, tw_shift,
        log_n, total, f);
  }
  return (int)cudaGetLastError();
}
