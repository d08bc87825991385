// Four-step NTT sub-transforms, n = S1 * S2, element i = h * S2 + l, over
// (n, W) word elements, W = 8, 10 or 12 (bn254 Fr, bw6-633 Fr, bw6-761 Fr).
//
// Replaces the Pallas kernels of gnark_crypto_tpu/ntt/pallas_ntt4.py
// `run_stages_four_step` (`_stage4`, `_stage4_r4`, `_twist`,
// `_canonicalize`). The TPU version keeps limbs in sublanes so that every
// 128-lane tile multiplies by one constant twiddle, and carries lazy
// [0, 4.5q) values between passes. Here each sub-NTT is one block of
// `ntt_block_kernel` (ntt_block.cuh) holding its whole row in shared
// memory, values stay canonical, and the twist is fused into the first
// step's write-back, so a transform makes two passes over device memory:
//   columns: S2 sub-NTTs of size S1 over h (stride S2), no transpose;
//   rows:    S1 sub-NTTs of size S2 over l (contiguous).
//
// Bound on the H100: each pass reads and writes 4W bytes per element (plus
// the twist table in the first pass) against (log2 S / 2) Montgomery
// products of 2W^2 + W multiply-adds per element. At 8 words and 2^20 the
// sub-NTT is within 2x of either bound; at 12 words a product is 2.2x the
// multiply-adds of an 8-word one for 1.5x the bytes, so the operations
// bound the pass. Two passes instead of the radix-2 path's k - 9 is what
// the design buys; S up to 2^12 fits the 227 KB of shared memory (128, 160
// and 192 KB at 8, 10 and 12 words), which covers n up to 2^24.
#include "ntt_block.cuh"

// One four-step sub-transform step over the (S1, S2) view of x.
//   columns = 1: S2 sub-NTTs of size 2^log_s = S1, element stride S2;
//   columns = 0: S1 sub-NTTs of size 2^log_s = S2, contiguous rows.
// tw[j] = root^j (j < 2^(log_s - 1)) for the sub-transform's root;
// twist (may be null) multiplies each output at its own position.
// n_words: 8, 10 or 12.
extern "C" int gct_ntt_four_step(const void* x, void* y, const void* tw,
                                 int log_s, long long other, int columns,
                                 const void* twist, int dit, int n_words,
                                 const uint32_t* field_words, void* stream) {
  const long long row_stride = columns ? 1 : (1LL << log_s);
  const long long elem_stride = columns ? other : 1;
  return gct::launch_ntt_block(n_words, x, y, tw, 0, log_s, other,
                               row_stride, elem_stride, twist, dit,
                               field_words, stream);
}
