"""Uniform field-engine facade over the port's three engines.

Counterpart of ``gnark_crypto_tpu/field/api.py``: one :class:`FieldEngine`
object per spec exposes the same op set with the spec bound, whatever the
representation:

  * multi-word fields: ``int32[..., W]`` words (``field/mont.py``),
    elem_dims = 1;
  * 31-bit fields (koalabear, babybear): ``int32[...]`` (``field/f31.py``),
    elem_dims = 0;
  * goldilocks: ``int32[..., 2]`` words (``field/f64.py``), elem_dims = 1.

Engines are created once per spec (identity-cached).
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.field import f31, f64, mont
from gnark_crypto_tpu_torch.specs.field import FieldSpec, get_field

_DELEGATED = [
    "from_int", "to_int", "zeros", "ones", "add", "sub", "neg", "double",
    "halve", "mul", "square", "to_mont", "from_mont", "mul_const", "is_zero",
    "equal", "select", "exp_const", "inverse", "batch_inverse", "legendre",
    "sqrt", "sum_reduce", "inner_product", "to_bytes_host", "from_bytes_host",
]


class FieldEngine:
    def __init__(self, spec: FieldSpec, impl=mont):
        self.spec = spec
        self.impl = impl
        # trailing element dims: the word axis (mont, f64), none for f31
        self.elem_dims = 0 if impl is f31 else 1
        for name in _DELEGATED:
            setattr(self, name, functools.partial(getattr(impl, name), spec))

    # --- shape helpers: "element shape" = tensor shape minus element dims ---
    def eshape(self, x: torch.Tensor) -> tuple[int, ...]:
        return tuple(x.shape[:x.dim() - self.elem_dims])

    def reshape(self, x: torch.Tensor, shape) -> torch.Tensor:
        return x.reshape(*shape, *x.shape[x.dim() - self.elem_dims:])

    def broadcast_to(self, x: torch.Tensor, shape) -> torch.Tensor:
        return x.expand(*shape, *x.shape[x.dim() - self.elem_dims:])

    def tile_lead(self, x: torch.Tensor, reps: int) -> torch.Tensor:
        """Tile along the leading element axis."""
        return x.repeat(reps, *([1] * (x.dim() - 1)))

    def where(self, cond: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
        """Select with cond shaped like the element shape."""
        if self.elem_dims:
            cond = cond[..., None]
        return torch.where(cond, x, y)

    def is_square(self, x: torch.Tensor) -> torch.Tensor:
        """QR mask via Euler's criterion (legendre in {0, 1, q-1})."""
        leg = self.legendre(x)
        one = self.broadcast_to(self.ones(device=x.device), self.eshape(x))
        return self.equal(leg, one) | self.is_zero(x)

    def sgn0(self, x: torch.Tensor) -> torch.Tensor:
        """RFC 9380 sgn0: parity of the canonical value."""
        plain = self.from_mont(x)
        return (plain[..., 0] if self.elem_dims else plain) & 1

    def __repr__(self):
        return f"FieldEngine({self.spec.name})"

    def __hash__(self):
        return hash(("FieldEngine", self.spec))

    def __eq__(self, other):
        return isinstance(other, FieldEngine) and other.spec == self.spec


@functools.lru_cache(maxsize=None)
def for_spec(spec: FieldSpec) -> FieldEngine:
    if spec.limb_bits == 32 and spec.n_limbs == 1:
        return FieldEngine(spec, f31)
    if spec.limb_bits == 32 and spec.n_limbs == 2:
        return FieldEngine(spec, f64)
    return FieldEngine(spec, mont)


def for_field(name: str) -> FieldEngine:
    return for_spec(get_field(name))
