// Fixed-exponent power out[i] = x[i]^e (Montgomery in and out), at W = 8,
// 10, 12, 20 and 24 words.
//
// Replaces the Pallas kernel gnark_crypto_tpu/field/pallas/exp.py
// `exp_const_pallas` and its Fermat form `inverse_small` (x^(q-2), 0 -> 0):
// there one 128-lane tile walks the exponent bits from SMEM so that the
// ladder is not ~254 separate dispatches. Its main caller here is the
// Fermat seed of every MSM tree level: 128 lanes, e = q - 2.
//
// Bound on the H100: latency. A 128-lane seed fills 4 warps of 132 SMs, so
// the time is one element's chain of dependent products, and the design
// shortens that chain three ways:
// * Right to left: base runs through x^(2^b), and acc takes base in where
//   bit b of e is set. The squares form the only dependent chain, nbits - 1
//   long (253 for bn254's q - 2, 380 for bls12-381's); the multiplies into
//   acc trail it on a second group of warps of the block: the squaring
//   warps hand each square on through shared memory, kChunk squares a
//   barrier, so a multiply never stalls a square.
// * A short product: with T = 1 a thread runs gct::mont_mul_ilp, whose
//   columns are independent but for a chain of ~8 operations a column
//   (field.cuh); with T > 1 a team of T neighbouring lanes shares one
//   element, K = ceil(W / T) words of each operand a lane: a lane issues
//   1/T of the multiply-adds, and each of the W reduction steps broadcasts
//   m from lane 0 and shifts the sum down a word by shuffles.
// * 32-lane blocks spread a small batch over SMs (kLanes a role).
// The design (kTeam by width, kLanes) is the fastest of the sweep of
// tools/exp_dbl2_sweep.py on the H100 (PERF.md), which builds the other
// team sizes and block shapes in a library of its own. The exponent's W
// words come by value and every lane reads the same bit, so no branch
// diverges; every lane runs the whole ladder (lanes past n on zeros,
// storing nothing), so the shuffles and barriers see the whole block.
#include "field.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 4;  // squares handed over at one barrier
// lanes an element at W words (10 words: K = 3 words a lane, the twelfth
// slot zero; 20 and 24 words: K = 5 and 6, T dividing W), and lanes a role
// in a block
template <int W>
constexpr int kTeam = W == 8 ? 1 : 4;
constexpr int kLanes = 32;

template <int W>
struct ExpConst {
  uint32_t e[W];  // exponent words, little-endian
  int nbits;      // bit length of e
};

// T = 2, 4, 8: lane j of the team (j = lane mod T) holds words
// [jK, jK + K) of each value, words at or above W being 0.
template <int W, int T>
struct Team {
  static constexpr int K = (W + T - 1) / T;
  struct E {
    uint32_t w[K];
  };
  struct Consts {
    E q;
    uint32_t qinv;
  };

  __device__ static int lane() { return threadIdx.x & (T - 1); }

  __device__ static E slice(const uint32_t (&w)[W]) {
    const int base = lane() * K;
    E r;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r.w[k] = 0;
#pragma unroll
      for (int s = 0; s < W; ++s)
        if (s == base + k) r.w[k] = w[s];
    }
    return r;
  }
  __device__ static Consts consts(const gct::FieldConstT<W>& fc) {
    return {slice(fc.q), fc.qinv};
  }
  __device__ static E load(const uint32_t* p) {
    const int base = lane() * K;
    E r;
#pragma unroll
    for (int k = 0; k < K; ++k) r.w[k] = base + k < W ? __ldg(p + base + k) : 0;
    return r;
  }
  __device__ static void store(uint32_t* p, const E& a) {
    const int base = lane() * K;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (base + k < W) p[base + k] = a.w[k];
  }

  // CIOS over the team. Lane j's sum is s (K words) plus h at word K: the
  // carry into lane j + 1's lowest word, added when that word shifts into
  // lane j. Then the carries and the final subtraction of q ripple up the
  // team, one shuffle a lane. Inputs < q; output canonical, as mont_mul.
  __device__ static E mul(const E& a, const E& b, const Consts& c) {
    const int j = lane();
    uint32_t s[K], h = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t ai = __shfl_sync(kFull, a.w[i % K], i / K, T);
      uint64_t c1 = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint64_t p = (uint64_t)ai * b.w[k] + s[k] + c1;
        s[k] = (uint32_t)p;
        c1 = p >> 32;
      }
      const uint32_t m = __shfl_sync(kFull, s[0] * c.qinv, 0, T);
      uint64_t c2 = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint64_t p = (uint64_t)m * c.q.w[k] + s[k] + c2;
        s[k] = (uint32_t)p;
        c2 = p >> 32;
      }
      // shift down a word: lane j + 1's lowest word comes in at the top
      const uint32_t next = __shfl_down_sync(kFull, s[0], 1, T);
      const uint64_t top =
          c1 + c2 + h + (j == T - 1 ? 0u : next);
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) s[k] = s[k + 1];
      s[K - 1] = (uint32_t)top;
      h = (uint32_t)(top >> 32);
    }
    // carries: lane j adds h and the carry out of lane j - 1
    E r;
    uint32_t out = 0;
#pragma unroll
    for (int round = 0; round < T; ++round) {
      const uint32_t in = __shfl_up_sync(kFull, h + out, 1, T);
      uint64_t t = j == 0 ? 0u : in;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        t += s[k];
        r.w[k] = (uint32_t)t;
        t >>= 32;
      }
      out = (uint32_t)t;
    }
    // the sum is < 2q, which is < 2^(32W) only for q < 2^(32W-1): the
    // carry out of the team's top lane (out of lane T - 1) is dropped here,
    // so a team product is wrong for a q that fills all 32W bits, and
    // gct_exp_const refuses one. At 8 words (secp256k1/r1) T = 1: the
    // column product, whose top carry word reduce_once takes.
    // Subtract q unless that borrows.
    E d;
    uint32_t borrow = 0;
#pragma unroll
    for (int round = 0; round < T; ++round) {
      const uint32_t in = __shfl_up_sync(kFull, borrow, 1, T);
      uint32_t bb = j == 0 ? 0u : in;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint64_t t = (uint64_t)r.w[k] - c.q.w[k] - bb;
        d.w[k] = (uint32_t)t;
        bb = (uint32_t)(t >> 32) & 1u;
      }
      borrow = bb;
    }
    const bool below_q = __shfl_sync(kFull, borrow, T - 1, T);
#pragma unroll
    for (int k = 0; k < K; ++k) d.w[k] = below_q ? r.w[k] : d.w[k];
    return d;
  }
};

// T = 1: the whole element a lane, and the column product.
template <int W>
struct Team<W, 1> {
  static constexpr int K = W;  // words a lane
  using E = gct::ElemT<W>;
  struct Consts {
    gct::FieldConstT<W> fc;
  };

  __device__ static Consts consts(const gct::FieldConstT<W>& fc) {
    return {fc};
  }
  // the words [0, W) of a W-word value given by value
  __device__ static E slice(const uint32_t (&w)[W]) {
    E r;
#pragma unroll
    for (int k = 0; k < W; ++k) r.w[k] = w[k];
    return r;
  }
  __device__ static E load(const uint32_t* p) { return gct::load_elem<W>(p); }
  __device__ static void store(uint32_t* p, const E& a) {
    gct::store_elem(p, a);
  }
  __device__ static E mul(const E& a, const E& b, const Consts& c) {
    return gct::mont_mul_ilp(a, b, c.fc);
  }
};

// bit b of the exponent, reading a word of it every 32 bits
struct BitReader {
  uint32_t cur = 0;
  template <int W>
  __device__ bool next(const ExpConst<W>& ec, int b) {
    if ((b & 31) == 0) cur = ec.e[b >> 5];
    const bool bit = cur & 1u;
    cur >>= 1;
    return bit;
  }
};

template <int W, int T>
__global__ void exp_const_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ out, long long n,
                                 gct::FieldConstT<W> fc, ExpConst<W> ec,
                                 gct::ElemT<W> one) {
  using Ops = Team<W, T>;
  using E = typename Ops::E;
  constexpr int K = Ops::K;
  const int lanes = blockDim.x / 2;  // a role
  const int role = threadIdx.x / lanes;  // 0 squares, 1 multiplies
  const int tid = threadIdx.x - role * lanes;
  const long long i = (long long)blockIdx.x * (lanes / T) + tid / T;
  const bool valid = i < n;
  const typename Ops::Consts c = Ops::consts(fc);
  const int nb = ec.nbits;
  E acc = Ops::slice(one.w);
  bool first = true;
  BitReader bits;
  // squares of chunk ch in buf[ch & 1][u][word][tid]; the multiplying
  // warps take chunk ch - 1 while the squaring warps fill chunk ch
  extern __shared__ uint32_t buf[];
  auto slot = [&](int ch, int u, int k) -> uint32_t& {
    return buf[(((ch & 1) * kChunk + u) * K + k) * lanes + tid];
  };
  E base{};
  if (valid && role == 0) base = Ops::load(x + i * W);
  const int chunks = (nb + kChunk - 1) / kChunk;
  for (int ch = 0; ch <= chunks; ++ch) {
    if (role == 0) {
      for (int u = 0; u < kChunk && ch < chunks; ++u) {
        const int b = ch * kChunk + u;
        if (b >= nb) break;
#pragma unroll
        for (int k = 0; k < K; ++k) slot(ch, u, k) = base.w[k];
        if (b + 1 < nb) base = Ops::mul(base, base, c);
      }
    } else if (ch > 0) {
      for (int u = 0; u < kChunk; ++u) {
        const int b = (ch - 1) * kChunk + u;
        if (b >= nb) break;
        if (bits.next(ec, b)) {
          E v;
#pragma unroll
          for (int k = 0; k < K; ++k) v.w[k] = slot(ch - 1, u, k);
          acc = first ? v : Ops::mul(acc, v, c);
          first = false;
        }
      }
    }
    __syncthreads();
  }
  if (role == 1 && valid) Ops::store(out + i * W, acc);
}

// lanes: a role in a block, a multiple of 32 up to 128 (at most 48 KB of
// squares)
template <int W, int T>
int launch(const void* x, void* out, long long n,
           const gct::FieldConstT<W>& fc, const ExpConst<W>& ec,
           const gct::ElemT<W>& one, int lanes, cudaStream_t stream) {
  const long long per_block = lanes / T;
  const long long blocks = (n + per_block - 1) / per_block;
  const size_t smem = sizeof(uint32_t) * 2 * kChunk * Team<W, T>::K * lanes;
  exp_const_kernel<W, T><<<(unsigned)blocks, 2 * lanes, smem, stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, fc, ec, one);
  return (int)cudaGetLastError();
}

// The kernel's arguments from the C entry's: Montgomery one, the exponent
template <int W>
void exp_args(const uint32_t* one_words, const uint32_t* exp_words,
              int nbits, gct::ElemT<W>& one, ExpConst<W>& ec) {
  for (int i = 0; i < W; ++i) {
    one.w[i] = one_words[i];
    ec.e[i] = exp_words[i];
  }
  ec.nbits = nbits;
}

}  // namespace

// n_words: 8, 10, 12, 20 or 24 (at 8 any q < 2^256, else q < 2^(32W-1));
// one_words: Montgomery one (R mod q);
// exp_words: e's n_words words, e < 2^(32 n_words); nbits: e's bit length.
extern "C" int gct_exp_const(const void* x, void* out, long long n,
                             int n_words, const uint32_t* field_words,
                             const uint32_t* one_words,
                             const uint32_t* exp_words, int nbits,
                             void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n <= 0) return 0;
    // the team product needs q < 2^(32W-1) (Team<W, T>::mul)
    if (kTeam<W> > 1 && (field_words[W - 1] >> 31))
      return (int)cudaErrorInvalidValue;
    gct::ElemT<W> one;
    ExpConst<W> ec;
    exp_args<W>(one_words, exp_words, nbits, one, ec);
    return launch<W, kTeam<W>>(x, out, n, gct::field_const<W>(field_words),
                               ec, one, kLanes, (cudaStream_t)stream);
  });
}
