// Radix-2 NTT over goldilocks (q = 2^64 - 2^32 + 1): each element is the
// pair of 32-bit words [lo, hi] of its canonical Montgomery value (R =
// 2^64), read here as one little-endian uint64.
//
// Replaces the Pallas kernels of gnark_crypto_tpu/ntt/pallas_ntt_f64.py:
//   * `_big_stage` (one radix-2 stage per pass) -> `ntt_f64_stage<DIT>`,
//     one thread per butterfly;
//   * `_tail_pass` (every stage whose half-block fits a tile) and
//     `run_batch_small_f64` (B independent transforms of n <= tile) ->
//     `ntt_f64_block<DIT>`: each block loads a chunk of 2^kTileLog elements
//     into shared memory, runs every stage of the size-2^log_n transforms
//     the chunk holds, and writes the chunk back.
// Stage order and twiddle indexing are those of gnark_crypto_tpu/ntt/
// fft.py `_run_stages` (DIF ascending, (a + b, (a - b) w); DIT descending,
// (a + w b, a - w b), twiddle tw0[(lo mod half) << s]), on the flat array.
//
// The product is a 64-bit Montgomery REDC: t = a b (64x64->128), m = t_lo
// qinv mod 2^64, (t + m q) / 2^64 by __umul64hi, one conditional
// subtraction (the sum can pass 2^64; it is below 2q). Any exact REDC gives
// the canonical value of the JAX kernel's multiplier-free rounds. In 32-bit
// multiply-adds: 4 for a b, 3 for m, 4 for m q = 11. A butterfly moves
// 24-32 bytes for those, so every pass is memory-bound on the H100; the
// block kernel runs the last kTileLog stages (DIF) or the first (DIT) in
// one pass over the array.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 12;  // 2^12 x 8 B = 32 KB of shared memory
constexpr int kBlockThreads = 512;

struct F64 {
  uint64_t q;
  uint64_t qinv;  // -q^-1 mod 2^64
};

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b,
                                            const F64& f) {
  const uint64_t s = a + b;
  // a + b - q < q whether or not the sum passed 2^64 (then s < a)
  return (s < a || s >= f.q) ? s - f.q : s;
}

__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b,
                                            const F64& f) {
  const uint64_t d = a - b;
  return a < b ? d + f.q : d;
}

// a * b * 2^-64 mod q, canonical. t_lo + (m q mod 2^64) is 0 or 2^64, so
// its carry is (t_lo != 0); hi <= (q-1)^2 / 2^64 < q - 1, so hi + carry
// does not wrap, and the final sum is below 2q.
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b,
                                             const F64& f) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t m = lo * f.qinv;
  const uint64_t u = hi + (lo != 0);
  const uint64_t r = u + __umul64hi(m, f.q);
  return (r < u || r >= f.q) ? r - f.q : r;
}

template <bool DIT>
__device__ __forceinline__ void butterfly(uint64_t& u, uint64_t& v,
                                          uint64_t w, const F64& f) {
  if (DIT) {
    const uint64_t t = mont_mul(v, w, f);
    v = sub_mod(u, t, f);
    u = add_mod(u, t, f);
  } else {
    const uint64_t d = sub_mod(u, v, f);
    u = add_mod(u, v, f);
    v = mont_mul(d, w, f);
  }
}

template <bool DIT>
__global__ void ntt_f64_stage(const uint64_t* __restrict__ x,
                              uint64_t* __restrict__ y,
                              const uint64_t* __restrict__ tw0, int k, int s,
                              F64 f) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (1LL << (k - 1))) return;
  const int hlog = k - 1 - s;
  const long long h = 1LL << hlog;
  const long long off = b & (h - 1);
  const long long lo = ((b >> hlog) << (hlog + 1)) | off;
  uint64_t u = x[lo], v = x[lo + h];
  butterfly<DIT>(u, v, __ldg(tw0 + (off << s)), f);
  y[lo] = u;
  y[lo + h] = v;
}

// Every stage of the size-2^log_n transforms held by one chunk of
// 2^kTileLog elements (the last chunk may be shorter; `total` is a multiple
// of 2^log_n). Local stage s uses twiddle tw[(off << s) << tw_shift].
template <bool DIT>
__global__ void __launch_bounds__(kBlockThreads)
ntt_f64_block(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
              const uint64_t* __restrict__ tw, int tw_shift, int log_n,
              long long total, F64 f) {
  __shared__ uint64_t sm[1 << kTileLog];
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
      uint64_t u = sm[lo], v = sm[lo + half];
      butterfly<DIT>(u, v, __ldg(tw + ((long long)off << (s + tw_shift))), f);
      sm[lo] = u;
      sm[lo + half] = v;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < c; i += blockDim.x) y[base + i] = sm[i];
}

}  // namespace

// Stage s of a size-2^k transform; tw0[j] = w^j, j < 2^(k-1).
extern "C" int gct_ntt_f64_stage(const void* x, void* y, const void* tw0,
                                 int k, int s, int dit, uint64_t q,
                                 uint64_t qinv, void* stream) {
  if (s < 0 || s >= k || k > 40) return (int)cudaErrorInvalidValue;
  const F64 f{q, qinv};
  const int threads = 256;
  const unsigned blocks =
      (unsigned)(((1LL << (k - 1)) + threads - 1) / threads);
  if (dit) {
    ntt_f64_stage<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw0, k, s, f);
  } else {
    ntt_f64_stage<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw0, k, s, f);
  }
  return (int)cudaGetLastError();
}

// Every stage of each contiguous 2^log_n block of `total` elements.
extern "C" int gct_ntt_f64_block(const void* x, void* y, const void* tw,
                                 int tw_shift, int log_n, long long total,
                                 int dit, uint64_t q, uint64_t qinv,
                                 void* stream) {
  if (log_n < 0 || log_n > kTileLog || total <= 0 ||
      total % (1LL << log_n) != 0)
    return (int)cudaErrorInvalidValue;
  const F64 f{q, qinv};
  const long long chunk = total < (1LL << kTileLog) ? total : 1LL << kTileLog;
  const int threads = chunk / 2 < kBlockThreads
                          ? (chunk / 2 < 32 ? 32 : (int)(chunk / 2))
                          : kBlockThreads;
  const unsigned blocks =
      (unsigned)((total + (1LL << kTileLog) - 1) >> kTileLog);
  if (dit) {
    ntt_f64_block<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw, tw_shift,
        log_n, total, f);
  } else {
    ntt_f64_block<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw, tw_shift,
        log_n, total, f);
  }
  return (int)cudaGetLastError();
}
