"""Uniform field-engine facade over the word engine (``field/mont.py``).

Counterpart of ``gnark_crypto_tpu/field/api.py``: one :class:`FieldEngine`
object per spec exposes the op set with the spec bound. Multi-word fields
only: ``int32[..., W]`` word tensors, elem_dims = 1. The 31-bit and
goldilocks engines are not ported yet (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.specs.field import FieldSpec, get_field

_DELEGATED = [
    "from_int", "to_int", "zeros", "ones", "add", "sub", "neg", "double",
    "halve", "mul", "square", "to_mont", "from_mont", "mul_const", "is_zero",
    "equal", "select", "exp_const", "inverse", "batch_inverse", "legendre",
    "sqrt", "sum_reduce", "inner_product", "to_bytes_host", "from_bytes_host",
]


class FieldEngine:
    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.elem_dims = 1  # the word axis
        for name in _DELEGATED:
            setattr(self, name, functools.partial(getattr(mont, name), spec))

    # --- shape helpers: "element shape" = tensor shape minus the word axis --
    def eshape(self, x: torch.Tensor) -> tuple[int, ...]:
        return tuple(x.shape[:-1])

    def reshape(self, x: torch.Tensor, shape) -> torch.Tensor:
        return x.reshape(*shape, x.shape[-1])

    def broadcast_to(self, x: torch.Tensor, shape) -> torch.Tensor:
        return x.expand(*shape, x.shape[-1])

    def tile_lead(self, x: torch.Tensor, reps: int) -> torch.Tensor:
        """Tile along the leading element axis."""
        return x.repeat(reps, *([1] * (x.dim() - 1)))

    def where(self, cond: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
        """Select with cond shaped like the element shape."""
        return torch.where(cond[..., None], x, y)

    def is_square(self, x: torch.Tensor) -> torch.Tensor:
        """QR mask via Euler's criterion (legendre in {0, 1, q-1})."""
        leg = self.legendre(x)
        one = self.broadcast_to(self.ones(device=x.device), self.eshape(x))
        return self.equal(leg, one) | self.is_zero(x)

    def sgn0(self, x: torch.Tensor) -> torch.Tensor:
        """RFC 9380 sgn0: parity of the canonical value."""
        return self.from_mont(x)[..., 0] & 1

    def __repr__(self):
        return f"FieldEngine({self.spec.name})"

    def __hash__(self):
        return hash(("FieldEngine", self.spec))

    def __eq__(self, other):
        return isinstance(other, FieldEngine) and other.spec == self.spec


@functools.lru_cache(maxsize=None)
def for_spec(spec: FieldSpec) -> FieldEngine:
    if spec.limb_bits == 32:
        raise NotImplementedError(
            f"{spec.name}: the 31-bit and goldilocks engines are not ported "
            "yet (ROADMAP.md queue 1, item 8: small fields)")
    return FieldEngine(spec)


def for_field(name: str) -> FieldEngine:
    return for_spec(get_field(name))
