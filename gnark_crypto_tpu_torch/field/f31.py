"""31-bit Montgomery fields (koalabear, babybear): one int32 per element.

Counterpart of ``gnark_crypto_tpu/field/f31.py`` (reference
``field/{koalabear,babybear}/element.go``). An element is an ``int32[...]``
tensor with no word axis (elem_dims = 0) holding the canonical Montgomery
value ``x * 2^32 mod q``; it is below q < 2^31, so it is non-negative, and
its bits are those of the JAX engine's ``uint32`` lane (the same R).

Every op is plain tensor code on the device of its inputs, as the JAX
engine runs these ops in XLA outside any kernel; only the NTT has kernels
(``ntt/radix2_f31.py``). Sums and products are taken in int64, where a
product of two canonical values (< 2^62) is exact. The Montgomery product
is the canonical residue ``x * y * 2^-32 mod q``, computed as
``(x * y mod q) * 2^-32 mod q``: any exact reduction gives the same value
as the reference's REDC.
"""

from __future__ import annotations

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import ladder
from gnark_crypto_tpu_torch.specs.field import FieldSpec

DEFAULT_DEVICE = "cuda"
M32 = 0xFFFFFFFF


def _i64(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 in [0, 2^32) (raw values >= 2^31 keep their bits)."""
    return x.to(torch.int64) & M32


def eshape(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(x.shape)


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def from_int(spec: FieldSpec, values, mont: bool = True, reduce: bool = True,
             device=DEFAULT_DEVICE) -> torch.Tensor:
    """Python int(s) -> () for an int, (N,) for a list.

    ``reduce=False`` keeps raw 32-bit scalars (>= q allowed, stored as
    their bits) and needs ``mont=False``, as the JAX engine's."""
    single = isinstance(values, int)
    vals = [values] if single else list(values)
    q = spec.modulus
    if reduce:
        vals = [v % q * spec.r % q if mont else v % q for v in vals]
    elif mont or any(not 0 <= v < 1 << 32 for v in vals):
        raise ValueError("reduce=False takes raw 32-bit values, mont=False")
    arr = np.asarray(vals, dtype=np.uint32).view(np.int32)
    out = torch.from_numpy(arr.copy()).to(device)
    return out[0] if single else out


def to_int(spec: FieldSpec, x: torch.Tensor, mont: bool = True):
    """Tensor -> Python int (0-d input) or flat list of ints."""
    vals = (x.detach().to("cpu").reshape(-1).to(torch.int64) & M32).tolist()
    if mont:
        vals = [v * spec.r_inv % spec.modulus for v in vals]
    else:
        vals = [v % spec.modulus for v in vals]
    return vals[0] if x.dim() == 0 else vals


def zeros(spec: FieldSpec, shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.int32, device=device)


def ones(spec: FieldSpec, shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.full(tuple(shape), spec.r, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# ring ops
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    s = _i64(x) + _i64(y)
    return torch.where(s >= spec.modulus, s - spec.modulus, s).to(torch.int32)


def sub(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = _i64(x) - _i64(y)
    return torch.where(d < 0, d + spec.modulus, d).to(torch.int32)


def neg(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(x), x)


def double(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return add(spec, x, x)


def halve(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """x/2 mod q: x/2, or (x + q)/2 for odd x."""
    v = _i64(x)
    return torch.where((v & 1) == 1, (v + spec.modulus) >> 1,
                       v >> 1).to(torch.int32)


def mul(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Montgomery product x * y * 2^-32 mod q (broadcasting)."""
    q = spec.modulus
    return (_i64(x) * _i64(y) % q * spec.r_inv % q).to(torch.int32)


def square(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mul(spec, x, x)


def to_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Plain canonical values -> Montgomery form (x * 2^32 mod q)."""
    return (_i64(x) * spec.r % spec.modulus).to(torch.int32)


def from_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return (_i64(x) * spec.r_inv % spec.modulus).to(torch.int32)


def mul_const(spec: FieldSpec, x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c for a plain-int constant c."""
    return (_i64(x) * (c % spec.modulus) % spec.modulus).to(torch.int32)


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def is_zero(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return x == 0


def equal(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x == y


def select(spec: FieldSpec, cond: torch.Tensor, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, x, y)


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
    """Inverse of every element, 0 -> 0: the reference's batch inversion
    along the leading axis gives the same canonical values, and here one
    elementwise Fermat ladder over the whole batch is the cheaper form."""
    return inverse(spec, x)


def legendre(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return exp_const(spec, x, (spec.modulus - 1) // 2)


def sqrt(spec: FieldSpec, x: torch.Tensor):
    return ladder.sqrt(_ops(), spec, x)


def sum_reduce(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Modular sum along the leading axis: one int64 sum (exact for fewer
    than 2^32 terms below 2^31) and one reduction."""
    return (_i64(x).sum(0) % spec.modulus).to(torch.int32)


def inner_product(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    return sum_reduce(spec, mul(spec, x, y))


# ---------------------------------------------------------------------------
# bytes (gnark: 4-byte big-endian canonical)
# ---------------------------------------------------------------------------

def to_bytes_host(spec: FieldSpec, x: torch.Tensor, mont: bool = True
                  ) -> list[bytes]:
    v = x.detach().to("cpu").reshape(-1)
    if mont:
        v = from_mont(spec, v)
    be = v.numpy().astype(np.uint32).astype(">u4").tobytes()
    return [be[4 * i:4 * i + 4] for i in range(v.shape[0])]


def from_bytes_host(spec: FieldSpec, bs, mont: bool = True,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Strict canonical decode to (N,); raises on a value >= q."""
    if any(len(b) != spec.n_bytes for b in bs):
        raise ValueError(f"field element encoding must be {spec.n_bytes} "
                         "bytes")
    vals = np.frombuffer(b"".join(bs), ">u4").astype(np.int64)
    if (vals >= spec.modulus).any():
        raise ValueError("non-canonical field element encoding")
    out = torch.from_numpy(vals).to(device)
    return to_mont(spec, out) if mont else out.to(torch.int32)
