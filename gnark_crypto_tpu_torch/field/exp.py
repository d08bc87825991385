"""Kernel: the fixed-exponent power x^e, and its plain PyTorch version.

``exp_const(spec, x, e)`` on an ``(N, W)`` int32 word tensor returns x^e
(Montgomery in and out) for a Python-int exponent e >= 0; 0^e = 0 for
e > 0, so e = q - 2 is the Fermat inverse with 0 -> 0. A CUDA tensor goes
to ``csrc/exp.cu`` (one thread per element runs the whole MSB-first
square-and-multiply ladder), a CPU tensor to :func:`exp_const_plain`, the
same ladder on :func:`mont_mul_plain`. Both return canonical residues, so
they agree bit for bit. There is no size threshold: the kernel serves any
batch.

Replaces the Pallas kernels ``gnark_crypto_tpu/field/pallas/exp.py``
``exp_const_pallas`` and ``inverse_small``.
"""

from __future__ import annotations

import ctypes

import torch

from gnark_crypto_tpu_torch.field.kernels import (
    check_kernel_args, const_words, mont_mul_plain, to_i32)
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


def exp_const(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for an (N, W) int32 tensor and a Python-int exponent e >= 0."""
    if e < 0:
        raise ValueError("negative exponent: combine with inverse()")
    if not x.is_cuda:
        return exp_const_plain(spec, x, e)
    check_kernel_args(spec, "exp_const", x)
    if e >> (32 * spec.n_words):
        # the kernel takes W-word exponents: x^e = x^e' with e' in
        # [1, q-1], e' = e mod (q-1), for x != 0, and 0 = 0^e' for x = 0
        e = (e - 1) % (spec.modulus - 1) + 1
    out = torch.empty_like(x)
    word_t = ctypes.c_uint32 * spec.n_words
    fn = build.function("exp", "gct_exp_const", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    exp_const.launches += 1
    build.check(fn(x.data_ptr(), out.data_ptr(), x.shape[0],
                   build.field_words(spec), word_t(*spec.one_words),
                   word_t(*int_to_words(e, spec.n_words)), e.bit_length(),
                   build.stream_ptr(x)), "exp_const launch")
    return out


exp_const.launches = 0
