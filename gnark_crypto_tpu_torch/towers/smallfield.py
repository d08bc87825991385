"""Small-field extension towers (FRI-style soundness amplification).

Counterpart of ``gnark_crypto_tpu/towers/smallfield.py`` (reference
``field/{koalabear,babybear,goldilocks}/extensions``):

  koalabear:  E2 = F[u]/(u^2-3),  E4 = E2[v]/(v^2-u), E6 = E2[w]/(w^3-(1+u))
  babybear:   E2 = F[u]/(u^2-11), E4 = E2[v]/(v^2-u), E6 = E2[w]/(w^3-(1+u))
  goldilocks: E2 = F[u]/(u^2-7)

built from the generic engines of ``towers/engine.py`` over the f31 and f64
engines (elem_dims 0 and 1). Each engine is bound to a device (default:
the card) and cached per (field, device).
"""

from __future__ import annotations

import functools

from gnark_crypto_tpu_torch.field.api import for_field
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.towers.engine import CubicExtEngine, QuadExtEngine

_BETA = {"koalabear": 3, "babybear": 11, "goldilocks": 7}


@functools.lru_cache(maxsize=None)
def e2(field: str, device=DEFAULT_DEVICE) -> QuadExtEngine:
    return QuadExtEngine(for_field(field), _BETA[field], tag=f"{field}_e2",
                         device=device)


@functools.lru_cache(maxsize=None)
def e4(field: str, device=DEFAULT_DEVICE) -> QuadExtEngine:
    """E4 = E2[v]/(v^2 - u): the non-residue is u = (0, 1) in E2."""
    base = e2(field, device)

    def mul_by_u(a):
        # (a0 + a1 u) * u = beta a1 + a0 u
        return base.build([base.mul_by_nr(base.coeff(a, 1)),
                           base.coeff(a, 0)])

    return QuadExtEngine(base, (0, 1), mul_by_nr=mul_by_u,
                         tag=f"{field}_e4", device=device)


@functools.lru_cache(maxsize=None)
def e6(field: str, device=DEFAULT_DEVICE) -> CubicExtEngine:
    """E6 = E2[w]/(w^3 - (1+u))."""
    return CubicExtEngine(e2(field, device), (1, 1), tag=f"{field}_e6",
                          device=device)
