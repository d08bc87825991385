"""Kernel: the fixed-exponent power x^e, and its plain PyTorch version.

``exp_const(spec, x, e)`` on an ``(N, W)`` int32 word tensor returns x^e
(Montgomery in and out) for a Python-int exponent e >= 0; 0^e = 0 for
e > 0, so e = q - 2 is the Fermat inverse with 0 -> 0. A CUDA tensor goes
to ``csrc/exp.cu`` (W = 8, 10, 12, 20 or 24 words; at 8 also the 256-bit
secp256k1/r1 moduli, whose lone-lane column product is exact for any
q < 2^256), a CPU tensor to :func:`exp_const_plain`, the MSB-first ladder
on :func:`mont_mul_plain`.
Both return canonical residues, so they agree bit for bit. There is no size
threshold: the kernel serves any batch, in one launch.

The kernel runs the ladder right to left, so that its only dependent chain
is the squares (nbits - 1 of them), and its multiplies trail on warps of
their own; ``csrc/exp.cu`` fixes the product (one lane and the column
product at 8 words, a team of 4 lanes at 10, 12, 20 and 24) from the sweep
of ``tools/exp_dbl2_sweep.py`` on the H100.

Replaces the Pallas kernels ``gnark_crypto_tpu/field/pallas/exp.py``
``exp_const_pallas`` and ``inverse_small``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnark_crypto_tpu_torch.field.kernels import (
    FIELD_WIDTHS, FULL_WIDTHS, check_kernel_args, const_words, count_launch,
    mont_mul_plain, to_i32)
from gnark_crypto_tpu_torch.specs.field import FieldSpec, int_to_words
from gnark_crypto_tpu_torch.utils import build


def _one(spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    return to_i32(const_words(spec.one_words, str(like.device))).expand_as(
        like).clone()


def exp_const_plain(spec: FieldSpec, x: torch.Tensor, e: int
                    ) -> torch.Tensor:
    """x^e by MSB-first square-and-multiply on plain products."""
    res = _one(spec, x)
    for i in range(e.bit_length() - 1, -1, -1):
        res = mont_mul_plain(spec, res, res)
        if (e >> i) & 1:
            res = mont_mul_plain(spec, res, x)
    return res


@functools.lru_cache(maxsize=256)
def exponent_words(spec: FieldSpec, e: int) -> tuple[tuple[int, ...], int]:
    """(W words, bit length) of the exponent the kernel runs for x^e, e >= 0,
    cached per (spec, e).

    The kernel takes W-word exponents: for e >= 2^(32W), x^e = x^e' with
    e' in [1, q-1], e' = e mod (q-1), for x != 0, and 0 = 0^e' for x = 0.
    It reads bit b of the words at step b of its right-to-left ladder."""
    if e >> (32 * spec.n_words):
        e = (e - 1) % (spec.modulus - 1) + 1
    return tuple(int_to_words(e, spec.n_words)), e.bit_length()


def exp_const(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for an (N, W) int32 tensor and a Python-int exponent e >= 0."""
    if e < 0:
        raise ValueError("negative exponent: combine with inverse()")
    if not x.is_cuda:
        return exp_const_plain(spec, x, e)
    check_kernel_args(spec, "exp_const", x, widths=FIELD_WIDTHS,
                      full_widths=FULL_WIDTHS)
    words, nbits = exponent_words(spec, e)
    out = torch.empty_like(x)
    word_t = ctypes.c_uint32 * spec.n_words
    fn = build.function("exp", "gct_exp_const", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p])
    count_launch(exp_const, spec)
    build.check(fn(x.data_ptr(), out.data_ptr(), x.shape[0], spec.n_words,
                   build.field_words(spec), word_t(*spec.one_words),
                   word_t(*words), nbits, build.stream_ptr(x)),
                "exp_const launch")
    return out


exp_const.launches = 0
exp_const.launches_by_width = {}
