// Straight-line program executor in waves: one block of `warps` warps per
// 32-lane tile, at W = 8, 10, 12, 20 and 24 words.
//
// Replaces the Pallas kernel gnark_crypto_tpu/field/pallas/vm.py `execute`
// (`_vm_call`, `_vm_kernel`). There a grid walks 512-instruction chunks of
// the program from SMEM, in order, over a VMEM register file of
// (K, limbs, 256-lane) tiles, so that a whole pairing is one dispatch and
// one Mosaic compile: the TPU's answer to its compile limits.
//
// Bound on the H100: first the chain of dependent rows, then issue. A
// pairing program is 50-150k rows (bn254 `full`: 117,029, of them 17,747
// Montgomery products), but its longest chain of dependent rows is 6,358
// rows, 905 of them products: in order, one warp would wait on about 18 of
// every 19 rows for nothing but the walk. So the host (field/vm.py
// `schedule`) packs the rows into waves of at most `warps` mutually
// independent rows, laid out [wave][slot] with NOP fill, and allocates the
// registers again in wave order so that no register is written by one row
// of a wave and read or written by another (a row other than ROT may write
// one of its own operands: each lane reads before it writes). Here warp w
// runs slot w of every wave for all 32 lanes, and the block meets at one
// barrier at the end of each wave: the products of a wave run side by side
// on the SM's four schedulers, which a single warp leaves idle while each
// dependent multiply-add waits. At 16 warps (pairing/vm_pairing.py WARPS)
// the schedulers are issue-bound instead: a wave of 16 products costs
// about 3x one of 1 to 4 (tools/vm_waves.py), so what is left is
// instructions per row, and a tile of 32 lanes uses one SM.
//
// The register file stays in dynamic shared memory, laid out
// [register][word][lane]: a warp's access to one word of one register is
// 32 consecutive words, free of bank conflicts (ROT's permuted read too).
// K x W x 128 bytes: K <= 227 at 8 words, 181 at 10, 151 at 12, 90 at 20
// and 75 at 24, which the scheduler keeps to (field/vm.py reg_cap). Rows
// are 16-byte int4s read through the read-only cache: lane l of a warp
// holds its slot's row of wave base + l and hands it out by shuffle, and
// the next 32 waves' rows are fetched while these run, so a read from L2
// does not stall a wave.
//
// Ops: MUL (Montgomery product), ADD, SUB, HALVE (all canonical), ROT (lane
// i receives lane (i + s) mod 32 of register a) and NOP. A ROT reads other
// lanes of a register that no row of its wave writes (the scheduler never
// lets a ROT write its own source), so it needs no barrier of its own.
#include "field.cuh"

namespace {

enum { OP_MUL = 0, OP_ADD, OP_SUB, OP_HALVE, OP_ROT, OP_NOP };

constexpr int TILE = 32;       // lanes per tile: one warp
constexpr int MAX_WARPS = 16;  // field/vm.py MAX_WARPS

template <int W>
__device__ __forceinline__ gct::ElemT<W> reg_load(const uint32_t* regs, int r,
                                                  int lane) {
  const uint32_t* p = regs + r * W * TILE + lane;
  gct::ElemT<W> e;
#pragma unroll
  for (int w = 0; w < W; ++w) e.w[w] = p[w * TILE];
  return e;
}

template <int W>
__device__ __forceinline__ void reg_store(uint32_t* regs, int r, int lane,
                                          const gct::ElemT<W>& e) {
  uint32_t* p = regs + r * W * TILE + lane;
#pragma unroll
  for (int w = 0; w < W; ++w) p[w * TILE] = e.w[w];
}

// One row of a wave, for the 32 lanes of the calling warp.
template <int W>
__device__ __forceinline__ void run_row(uint32_t* regs, int op, int d, int a,
                                        int b, int lane,
                                        const gct::FieldConstT<W>& fc) {
  if (op == OP_ROT) {
    reg_store(regs, d, lane, reg_load<W>(regs, a, (lane + b) % TILE));
    return;
  }
  const gct::ElemT<W> x = reg_load<W>(regs, a, lane);
  gct::ElemT<W> r;
  if (op == OP_MUL) {
    r = gct::mont_mul(x, reg_load<W>(regs, b, lane), fc);
  } else if (op == OP_ADD) {
    r = gct::add_mod(x, reg_load<W>(regs, b, lane), fc);
  } else if (op == OP_SUB) {
    r = gct::sub_mod(x, reg_load<W>(regs, b, lane), fc);
  } else {
    r = gct::halve_mod(x, fc);
  }
  reg_store(regs, d, lane, r);
}

// code: (n_waves, warps) rows; state: (n_entry, n_pad, W) entry rows;
// out: (n_out, n_pad, W).
template <int W>
__global__ void __launch_bounds__(MAX_WARPS * TILE)
    vm_kernel(const int4* __restrict__ code, int n_waves,
              const int* __restrict__ omap, int n_out,
              const uint32_t* __restrict__ state, int n_entry,
              uint32_t* __restrict__ out, gct::FieldConstT<W> fc) {
  extern __shared__ uint32_t regs[];
  const int warps = blockDim.x / TILE;
  const int lane = threadIdx.x % TILE;
  const int slot = threadIdx.x / TILE;
  const long long n_pad = (long long)gridDim.x * TILE;
  const long long g = (long long)blockIdx.x * TILE + lane;

  for (int r = slot; r < n_entry; r += warps)
    reg_store(regs, r, lane, gct::load_elem<W>(state + (r * n_pad + g) * W));
  __syncthreads();

  const int4 nop = make_int4(OP_NOP, 0, 0, 0);
  int4 rows = lane < n_waves ? __ldg(code + (size_t)lane * warps + slot) : nop;
  for (int base = 0; base < n_waves; base += TILE) {
    const int ahead = base + TILE + lane;
    const int4 next =
        ahead < n_waves ? __ldg(code + (size_t)ahead * warps + slot) : nop;
    const int n = min(TILE, n_waves - base);
    for (int i = 0; i < n; ++i) {
      // i is uniform, so every lane of the warp takes the same branch
      const int op = __shfl_sync(0xffffffffu, rows.x, i);
      if (op != OP_NOP)
        run_row<W>(regs, op, __shfl_sync(0xffffffffu, rows.y, i),
                   __shfl_sync(0xffffffffu, rows.z, i),
                   __shfl_sync(0xffffffffu, rows.w, i), lane, fc);
      __syncthreads();
    }
    rows = next;
  }

  for (int i = slot; i < n_out; i += warps)
    gct::store_elem(out + (i * n_pad + g) * W,
                    reg_load<W>(regs, omap[i], lane));
}

}  // namespace

// code: (n_waves * warps, 4) int32 rows (op, d, a, b) laid out [wave][slot];
// omap: the n_out registers copied out; n_words: 8, 10, 12, 20 or 24.
// One block of `warps` warps per 32-lane tile, K x n_words x 32 words of
// dynamic shared memory each.
extern "C" int gct_vm_execute(const void* code, int n_waves, int warps,
                              const void* omap, int n_out, const void* state,
                              int n_entry, void* out, long long n_pad, int K,
                              int n_words, const uint32_t* field_words,
                              void* stream) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (n_pad <= 0) return 0;
    if (warps < 1 || warps > MAX_WARPS || n_pad % TILE)
      return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)K * W * TILE * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        vm_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    vm_kernel<W><<<(unsigned)(n_pad / TILE), warps * TILE, smem,
                   (cudaStream_t)stream>>>(
        (const int4*)code, n_waves, (const int*)omap, n_out,
        (const uint32_t*)state, n_entry, (uint32_t*)out,
        gct::field_const<W>(field_words));
    return (int)cudaGetLastError();
  });
}
