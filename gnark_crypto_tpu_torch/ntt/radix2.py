"""Kernel 2: the radix-2 NTT, and its plain PyTorch version.

A size-2^k transform over ``(n, W)`` word tensors runs as k butterfly
stages; stage s pairs ``lo`` and ``lo + half`` (half = n >> (s + 1)) with
twiddle ``tw0[off << s]``, off = lo mod half, ``tw0[j] = w^j``:

* DIF (Gentleman-Sande): (a + b, (a - b) w), stages 0 .. k-1, natural
  order in, bit-reversed out;
* DIT (Cooley-Tukey): (a + w b, a - w b), stages k-1 .. 0, bit-reversed in,
  natural order out.

On the card the stages whose half-block exceeds a shared-memory row run one
launch each (:func:`stage`, ``ntt_stage_kernel``), and the remaining
``t = min(k, TILE_LOG)`` stages of every contiguous 2^t block run in one
launch (:func:`block`, ``ntt_block_kernel``): k - t + 1 launches in all.
On the CPU the same two wrappers run their plain versions, so both devices
take the same sequence of steps. :func:`run_plain` is the plain transform
stage by stage, the counterpart of the JAX ``fft._dif_stages`` and
``fft._dit_stages``.

Replaces the Pallas kernels of ``gnark_crypto_tpu/ntt/pallas_ntt.py``
``run_stages_pallas``; see ``csrc/ntt_radix2.cu`` for the bound.
"""

from __future__ import annotations

import ctypes

import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.kernels import (
    check_kernel_args, count_launch, mont_mul_plain)
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.utils import build

DIF = "DIF"
DIT = "DIT"
# 2^10 elements a block: 4W KB of shared memory (32, 40 and 48 KB at 8,
# 10 and 12 words)
TILE_LOG = 10
# the widths the NTT kernels are built for (csrc/ntt_block.cuh
# ``for_ntt_width``): bn254 Fr at 8 words, bw6-633 Fr at 10 and bw6-761 Fr
# at 12
WIDTHS = (8, 10, 12)
# the H100's shared memory for one block (227 KB), which a fused tile or a
# four-step sub-NTT must fit
SMEM_PER_BLOCK = 227 * 1024
BLOCK_THREADS = 512  # csrc/ntt_block.cuh kBlockThreads
MAX_LOG_S = 12       # csrc/ntt_block.cuh kMaxLogS


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def butterfly_plain(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor,
                    tw: torch.Tensor, dit: bool):
    if dit:
        hi = mont_mul_plain(spec, hi, tw)
        return mont.add(spec, lo, hi), mont.sub(spec, lo, hi)
    return (mont.add(spec, lo, hi),
            mont_mul_plain(spec, mont.sub(spec, lo, hi), tw))


def rows_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
               tw_shift: int, dit: bool) -> torch.Tensor:
    """All stages of R independent size-S transforms, x: (R, S, W); local
    stage s uses twiddle tw[(off << s) << tw_shift]."""
    R, S, W = x.shape
    log_s = S.bit_length() - 1
    for s in (range(log_s - 1, -1, -1) if dit else range(log_s)):
        half = S >> (s + 1)
        v = x.reshape(R, 1 << s, 2, half, W)
        idx = torch.arange(half, device=x.device) << (s + tw_shift)
        lo, hi = butterfly_plain(spec, v[:, :, 0], v[:, :, 1], tw[idx], dit)
        x = torch.stack([lo, hi], dim=2).reshape(R, S, W)
    return x


def stage_plain(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor, k: int,
                s: int, dit: bool) -> torch.Tensor:
    """Butterfly stage s of a size-2^k transform."""
    half = (1 << k) >> (s + 1)
    v = x.reshape(1 << s, 2, half, spec.n_words)
    tw = tw0[:: 1 << s][:half]
    lo, hi = butterfly_plain(spec, v[:, 0], v[:, 1], tw, dit)
    return torch.stack([lo, hi], dim=1).reshape(x.shape)


def block_plain(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor,
                tw_shift: int, log_s: int, dit: bool) -> torch.Tensor:
    """All stages of every contiguous 2^log_s block."""
    rows = x.reshape(-1, 1 << log_s, spec.n_words)
    return rows_plain(spec, rows, tw0, tw_shift, dit).reshape(x.shape)


def run_plain(domain, a: torch.Tensor, decimation: str, inverse: bool
              ) -> torch.Tensor:
    """The whole transform stage by stage with plain tensor code (no kernel
    on any device): the reference the kernels are held against."""
    tw0 = domain.twiddles0_inv if inverse else domain.twiddles0
    k = domain.k
    dit = decimation == DIT
    for s in (range(k - 1, -1, -1) if dit else range(k)):
        a = stage_plain(domain.spec, a, tw0, k, s, dit)
    return a


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def block_geometry(n_words: int, log_s: int) -> tuple[int, int]:
    """(threads, shared-memory bytes) of one ``ntt_block_kernel`` block
    over rows of 2^log_s elements of n_words words, as
    ``csrc/ntt_block.cuh`` ``launch_ntt_block`` sets them: the row
    word-major in 4W << log_s bytes, one thread a butterfly up to 512."""
    if not 0 <= log_s <= MAX_LOG_S:
        raise ValueError(f"a block row holds at most 2^{MAX_LOG_S} "
                         f"elements, not 2^{log_s}")
    smem = 4 * n_words << log_s
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"2^{log_s} elements of {n_words} words need "
                         f"{smem} bytes of shared memory")
    return max(1, min((1 << log_s) >> 1, BLOCK_THREADS)), smem


def stage(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor, k: int,
          s: int, dit: bool) -> torch.Tensor:
    """One butterfly stage of a size-2^k transform (``ntt_stage_kernel``)."""
    if not x.is_cuda:
        return stage_plain(spec, x, tw0, k, s, dit)
    check_kernel_args(spec, "ntt_radix2 stage", x, tw0, widths=WIDTHS)
    if x.shape[0] != 1 << k or tw0.shape[0] < max(1, (1 << k) >> 1):
        raise ValueError(f"stage: expected 2^{k} elements and 2^{k - 1} "
                         "twiddles")
    out = torch.empty_like(x)
    fn = build.function("ntt_radix2", "gct_ntt_radix2_stage", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    count_launch(stage, spec)
    build.check(fn(x.data_ptr(), out.data_ptr(), tw0.data_ptr(), k, s,
                   int(dit), spec.n_words, build.field_words(spec),
                   build.stream_ptr(x)),
                "ntt_radix2 stage launch")
    return out


def block(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor,
          tw_shift: int, log_s: int, dit: bool) -> torch.Tensor:
    """All stages of every contiguous 2^log_s block (``ntt_block_kernel``)."""
    if not x.is_cuda:
        return block_plain(spec, x, tw0, tw_shift, log_s, dit)
    check_kernel_args(spec, "ntt_radix2 block", x, tw0, widths=WIDTHS)
    n = x.shape[0]
    if n % (1 << log_s) or log_s > TILE_LOG:
        raise ValueError(f"block: n={n} is not a multiple of 2^{log_s} "
                         f"or 2^{log_s} exceeds the tile")
    if tw0.shape[0] < max(1, (1 << (log_s + tw_shift)) >> 1):
        raise ValueError("block: twiddle table too short")
    block_geometry(spec.n_words, log_s)
    out = torch.empty_like(x)
    fn = build.function("ntt_radix2", "gct_ntt_radix2_block", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    count_launch(block, spec)
    build.check(fn(x.data_ptr(), out.data_ptr(), tw0.data_ptr(), tw_shift,
                   log_s, n >> log_s, int(dit), spec.n_words,
                   build.field_words(spec), build.stream_ptr(x)),
                "ntt_radix2 block launch")
    return out


for _w in (stage, block):
    _w.launches = 0
    _w.launches_by_width = {}


def run(domain, a: torch.Tensor, decimation: str, inverse: bool
        ) -> torch.Tensor:
    """The radix-2 transform: wide stages one launch each, then (DIF) or
    first (DIT) the fused tail of t = min(k, TILE_LOG) stages."""
    spec, k = domain.spec, domain.k
    if k == 0:
        return a
    tw0 = domain.twiddles0_inv if inverse else domain.twiddles0
    t = min(k, TILE_LOG)
    s0 = k - t
    if decimation == DIF:
        for s in range(s0):
            a = stage(spec, a, tw0, k, s, dit=False)
        return block(spec, a, tw0, s0, t, dit=False)
    a = block(spec, a, tw0, s0, t, dit=True)
    for s in range(s0 - 1, -1, -1):
        a = stage(spec, a, tw0, k, s, dit=True)
    return a
