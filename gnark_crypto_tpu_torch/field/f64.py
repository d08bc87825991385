"""Goldilocks (q = 2^64 - 2^32 + 1): two 32-bit words per element.

Counterpart of ``gnark_crypto_tpu/field/f64.py`` (reference
``field/goldilocks/element.go``). An element is an ``int32[..., 2]`` tensor
of the words ``[lo, hi]`` of ``x * 2^64 mod q``, canonical (< q): the
layout of the JAX pair engine, and of this package's word engine
(``field/mont.py``) for a 64-bit modulus, so the words equal
``mont.from_int(GOLDILOCKS, ...)``'s.

Every op is plain tensor code on the device of its inputs, as the JAX
engine runs these ops in XLA outside any kernel; only the NTT has kernels
(``ntt/radix2_f64.py``). No int64 product of two 32-bit words fits, so the
arithmetic runs on 16-bit halves in int64: additions through the word
engine's carry helpers, the Montgomery product through its CIOS on 16-bit
halves (``field/kernels.py`` ``mont_mul_plain``, which gives the canonical
residue ``x * y * 2^-64 mod q`` that the reference's REDC gives).
"""

from __future__ import annotations

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import ladder
from gnark_crypto_tpu_torch.field import mont as words
from gnark_crypto_tpu_torch.field.kernels import mont_mul_plain
from gnark_crypto_tpu_torch.specs.field import FieldSpec, int_to_words

DEFAULT_DEVICE = "cuda"


def eshape(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(x.shape[:-1])


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def from_int(spec: FieldSpec, values, mont: bool = True, reduce: bool = True,
             device=DEFAULT_DEVICE) -> torch.Tensor:
    """Python int(s) -> (2,) for an int, (N, 2) for a list.

    ``reduce=False`` keeps raw 64-bit scalars (>= q allowed) and needs
    ``mont=False``, as the JAX engine's."""
    single = isinstance(values, int)
    vals = [values] if single else list(values)
    q = spec.modulus
    if reduce:
        vals = [v % q * spec.r % q if mont else v % q for v in vals]
    elif mont or any(not 0 <= v < 1 << 64 for v in vals):
        raise ValueError("reduce=False takes raw 64-bit values, mont=False")
    arr = np.asarray(vals, dtype=np.uint64).view("<u4").view(np.int32)
    out = torch.from_numpy(arr.reshape(len(vals), 2).copy()).to(device)
    return out[0] if single else out


def to_int(spec: FieldSpec, x: torch.Tensor, mont: bool = True):
    """(2,) -> Python int; (..., 2) -> flat list of ints."""
    arr = np.ascontiguousarray(x.detach().to("cpu").numpy().astype(np.int32))
    vals = [int(v) for v in arr.reshape(-1, 2).view("<u8").reshape(-1)]
    f = spec.r_inv if mont else 1
    vals = [v * f % spec.modulus for v in vals]
    return vals[0] if x.dim() == 1 else vals


def zeros(spec: FieldSpec, shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.zeros((*shape, 2), dtype=torch.int32, device=device)


def ones(spec: FieldSpec, shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return from_int(spec, 1, device=device).expand(*shape, 2).clone()


def _const(spec: FieldSpec, v: int, like: torch.Tensor) -> torch.Tensor:
    """The words of v (already in the form wanted) on like's device."""
    w = int_to_words(v, 2)
    return torch.tensor([x - (1 << 32) if x >> 31 else x for x in w],
                        dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# ring ops (the word engine's carry code is generic in the word count)
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return words.add(spec, x, y)


def sub(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return words.sub(spec, x, y)


def neg(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return words.sub(spec, torch.zeros_like(x), x)


def double(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return words.add(spec, x, x)


def halve(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return words.halve(spec, x)


def mul(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Montgomery product x * y * 2^-64 mod q (broadcasting)."""
    return mont_mul_plain(spec, x, y)


def square(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mul(spec, x, x)


def to_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mul(spec, x, _const(spec, spec.r2, x))


def from_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mul(spec, x, _const(spec, 1, x))


def mul_const(spec: FieldSpec, x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c for a plain-int constant c."""
    return mul(spec, x, _const(spec, c % spec.modulus * spec.r % spec.modulus,
                               x))


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def is_zero(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return torch.all(x == 0, dim=-1)


def equal(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.all(x == y, dim=-1)


def select(spec: FieldSpec, cond: torch.Tensor, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None], x, y)


# ---------------------------------------------------------------------------
# exponentiation / inversion / sqrt / sums
# ---------------------------------------------------------------------------

def _ops():
    import sys

    return sys.modules[__name__]


def exp_const(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    return ladder.exp_const(_ops(), spec, x, e)


def inverse(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """x^-1 via Fermat; 0 -> 0."""
    return exp_const(spec, x, spec.modulus - 2)


def batch_inverse(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inverse of every element, 0 -> 0 (the canonical values of the
    reference's batch inversion), as one elementwise Fermat ladder."""
    return inverse(spec, x)


def legendre(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return exp_const(spec, x, (spec.modulus - 1) // 2)


def sqrt(spec: FieldSpec, x: torch.Tensor):
    return ladder.sqrt(_ops(), spec, x)


def sum_reduce(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return ladder.sum_reduce(_ops(), spec, x)


def inner_product(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    return sum_reduce(spec, mul(spec, x, y))


# ---------------------------------------------------------------------------
# bytes (gnark: 8-byte big-endian canonical)
# ---------------------------------------------------------------------------

def to_bytes_host(spec: FieldSpec, x: torch.Tensor, mont: bool = True
                  ) -> list[bytes]:
    return [v.to_bytes(8, "big") for v in to_int(spec, x.reshape(-1, 2),
                                                 mont=mont)]


def from_bytes_host(spec: FieldSpec, bs, mont: bool = True,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Strict canonical decode to (N, 2); raises on a value >= q."""
    if any(len(b) != spec.n_bytes for b in bs):
        raise ValueError(f"field element encoding must be {spec.n_bytes} "
                         "bytes")
    vals = [int.from_bytes(b, "big") for b in bs]
    if any(v >= spec.modulus for v in vals):
        raise ValueError("non-canonical field element encoding")
    return from_int(spec, vals, mont=mont, device=device)
