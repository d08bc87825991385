// Straight-line program executor: one thread per lane, one block per tile,
// at W = 8 and W = 12 words.
//
// Replaces the Pallas kernel gnark_crypto_tpu/field/pallas/vm.py `execute`
// (`_vm_call`, `_vm_kernel`). There a grid walks 512-instruction chunks of
// the program from SMEM, in order, over a VMEM register file of
// (K, limbs, 256-lane) tiles, so that a whole pairing is one dispatch and
// one Mosaic compile. Here each block holds its tile's register file in
// shared memory, laid out [register][word][lane]: a warp's access to one
// register is 32 consecutive words, free of bank conflicts. The
// instruction stream is uniform across the block (no divergence) and is
// read from device memory through the caches, one 16-byte row per
// instruction, the next row fetched while the current one runs.
//
// Ops: MUL (Montgomery product), ADD, SUB, HALVE (all canonical), ROT (lane
// i receives lane (i + s) mod tile of register a) and NOP. Asm.build lets a
// destination reuse an operand's register: within a lane every op reads
// its operands before it writes. ROT crosses lanes, so it passes a barrier
// before its read (earlier writes of the other lanes are visible) and
// another before its write (every lane has read its source).
//
// Bound on the H100: latency. A pairing program is a serial chain per lane
// (bn254 `full`: 17,909 dependent Montgomery products and about 100k
// additions, each a few hundred cycles of dependent 32-bit instructions),
// so a launch takes about the time of one thread's chain, whatever the
// batch, as long as there are at most 132 blocks. At W = 12 (bls12-381 and
// bls12-377 Fp) a MUL row is a 300-multiply-add product against 136, and
// the chains are 15-22k MUL rows. The register file (K x 4W bytes a lane;
// K = 123 for bn254 `full`, 84 for bls12-381 `full`: 126 KB at 32 lanes)
// limits a 32-lane tile to one block per SM; bytes (entry rows in, 12 rows
// out) do not matter.
#include "field.cuh"

namespace {

enum { OP_MUL = 0, OP_ADD, OP_SUB, OP_HALVE, OP_ROT, OP_NOP };

template <int W>
__device__ __forceinline__ gct::ElemT<W> reg_load(const uint32_t* regs, int r,
                                                  int lane, int tile) {
  const uint32_t* p = regs + (size_t)r * W * tile + lane;
  gct::ElemT<W> e;
#pragma unroll
  for (int w = 0; w < W; ++w) e.w[w] = p[w * tile];
  return e;
}

template <int W>
__device__ __forceinline__ void reg_store(uint32_t* regs, int r, int lane,
                                          int tile, const gct::ElemT<W>& e) {
  uint32_t* p = regs + (size_t)r * W * tile + lane;
#pragma unroll
  for (int w = 0; w < W; ++w) p[w * tile] = e.w[w];
}

// state: (n_entry, n_pad, W) entry rows; out: (n_out, n_pad, W).
template <int W>
__global__ void vm_kernel(const int4* __restrict__ code, int n_instrs,
                          const int* __restrict__ omap, int n_out,
                          const uint32_t* __restrict__ state, int n_entry,
                          uint32_t* __restrict__ out,
                          gct::FieldConstT<W> fc) {
  extern __shared__ uint32_t regs[];
  const int tile = blockDim.x;
  const int lane = threadIdx.x;
  const long long n_pad = (long long)gridDim.x * tile;
  const long long g = (long long)blockIdx.x * tile + lane;

  for (int r = 0; r < n_entry; ++r)
    reg_store(regs, r, lane, tile,
              gct::load_elem<W>(state + (r * n_pad + g) * W));

  int4 next = n_instrs > 0 ? __ldg(code) : make_int4(OP_NOP, 0, 0, 0);
  for (int pc = 0; pc < n_instrs; ++pc) {
    const int4 ins = next;
    if (pc + 1 < n_instrs) next = __ldg(code + pc + 1);
    const int op = ins.x, d = ins.y, a = ins.z, b = ins.w;
    if (op == OP_ROT) {
      __syncthreads();
      const int src = lane + b < tile ? lane + b : lane + b - tile;
      const gct::ElemT<W> v = reg_load<W>(regs, a, src, tile);
      __syncthreads();
      reg_store(regs, d, lane, tile, v);
      continue;
    }
    if (op == OP_NOP) continue;
    const gct::ElemT<W> x = reg_load<W>(regs, a, lane, tile);
    gct::ElemT<W> r;
    if (op == OP_MUL) {
      r = gct::mont_mul(x, reg_load<W>(regs, b, lane, tile), fc);
    } else if (op == OP_ADD) {
      r = gct::add_mod(x, reg_load<W>(regs, b, lane, tile), fc);
    } else if (op == OP_SUB) {
      r = gct::sub_mod(x, reg_load<W>(regs, b, lane, tile), fc);
    } else {
      r = gct::halve_mod(x, fc);
    }
    reg_store(regs, d, lane, tile, r);
  }

  for (int i = 0; i < n_out; ++i)
    gct::store_elem(out + (i * n_pad + g) * W,
                    reg_load<W>(regs, omap[i], lane, tile));
}

}  // namespace

// code: (n_instrs, 4) int32 rows (op, d, a, b); omap: the n_out registers
// copied out; n_words: 8 or 12. One block of `tile` threads per tile,
// K x n_words x tile words of dynamic shared memory each.
extern "C" int gct_vm_execute(const void* code, int n_instrs,
                              const void* omap, int n_out, const void* state,
                              int n_entry, void* out, long long n_pad,
                              int tile, int K, int n_words,
                              const uint32_t* field_words, void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n_pad <= 0) return 0;
    const size_t smem = (size_t)K * W * tile * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        vm_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    vm_kernel<W><<<(unsigned)(n_pad / tile), tile, smem,
                   (cudaStream_t)stream>>>(
        (const int4*)code, n_instrs, (const int*)omap, n_out,
        (const uint32_t*)state, n_entry, (uint32_t*)out,
        gct::field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}
