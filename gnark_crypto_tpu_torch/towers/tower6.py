"""Direct sextic tower Fp6 = Fp3[v]/(v^2 - u), u^3 = nr: the BW6 GT.

Counterpart of ``gnark_crypto_tpu/towers/tower6.py`` (the reference's
``ecc/bw6-761/internal/fptower`` E3/E6): a quadratic extension over a
cubic one, both directly over the base field (761 bits for bw6-761, 633
for bw6-633). Built from the generic engines of ``towers/engine.py``; the
Frobenius is a host-precomputed linear map over the Fp basis
(1, u, u^2, v, uv, u^2 v).

bw6-761: u^3 = -4 (fp/bw6_utils.go); bw6-633: u^3 = 2. E6 layout: tensor
(..., 2, 3, W) = [v][u][word]; flat coefficients B0.A0 .. B1.A2.

A tower is bound to a device (``get_tower6(name, device)``): its constants
live there. An E6 product over word tensors is one batched ``mont_mul``
launch of 18 products a lane (``towers/engine.py``). The same formulas run
over the symbolic engines of ``towers/symbolic.py`` to assemble the bw6 VM
pairing programs.
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.towers.engine import CubicExtEngine, QuadExtEngine
from gnark_crypto_tpu_torch.towers.tower12 import _scale_ext_by_fp


# ---------------------------------------------------------------------------
# host-side exact Fp3/Fp6 arithmetic
# ---------------------------------------------------------------------------

def _h3_mul(a, b, p, nr):
    a0, a1, a2 = a
    b0, b1, b2 = b
    c0 = (a0 * b0 + nr * (a1 * b2 + a2 * b1)) % p
    c1 = (a0 * b1 + a1 * b0 + nr * a2 * b2) % p
    c2 = (a0 * b2 + a1 * b1 + a2 * b0) % p
    return (c0, c1, c2)


def _h3_mul_u(a, p, nr):
    return ((nr * a[2]) % p, a[0], a[1])


def _h6_mul(x, y, p, nr):
    x0, x1 = x
    y0, y1 = y
    c0 = tuple((s + t) % p for s, t in
               zip(_h3_mul(x0, y0, p, nr),
                   _h3_mul_u(_h3_mul(x1, y1, p, nr), p, nr)))
    c1 = tuple((s + t) % p for s, t in
               zip(_h3_mul(x0, y1, p, nr), _h3_mul(x1, y0, p, nr)))
    return (c0, c1)


def _h6_pow(a, e, p, nr):
    r = ((1, 0, 0), (0, 0, 0))
    while e:
        if e & 1:
            r = _h6_mul(r, a, p, nr)
        a = _h6_mul(a, a, p, nr)
        e >>= 1
    return r


class Tower6:
    """Fp6 tower with Frobenius and conjugation for the BW6 pairings."""

    def __init__(self, name: str, fp_spec: FieldSpec, nr: int, *, fp=None,
                 quad_cls=None, cubic_cls=None, device=DEFAULT_DEVICE):
        """``fp``, ``quad_cls``, ``cubic_cls``: the symbolic engines of
        ``towers/symbolic.py`` in place of the word-tensor ones."""
        self.name = name
        self.fp_spec = fp_spec
        self.p = fp_spec.modulus
        self.nr = nr
        self.fp: FieldEngine = fp if fp is not None else for_spec(fp_spec)
        quad_cls = quad_cls or QuadExtEngine
        cubic_cls = cubic_cls or CubicExtEngine
        e3 = cubic_cls(self.fp, nr, tag=f"{name}_e3", device=device)
        e6 = quad_cls(e3, None, mul_by_nr=e3.mul_by_v, tag=f"{name}_e6",
                      device=device)
        self.e3 = e3
        self.e6 = e6
        self._precompute_frobenius()

    # -- coefficient helpers (flat order B0.A0 .. B1.A2) ---------------------
    def coeffs6(self, x):
        e6, e3 = self.e6, self.e3
        b0, b1 = e6.coeff(x, 0), e6.coeff(x, 1)
        return tuple(e3.coeff(b0, j) for j in range(3)) + \
            tuple(e3.coeff(b1, j) for j in range(3))

    def from_coeffs6(self, cs):
        e6, e3 = self.e6, self.e3
        return e6.build([e3.build(cs[:3]), e3.build(cs[3:])])

    # -- frobenius -----------------------------------------------------------
    def _precompute_frobenius(self):
        p, nr = self.p, self.nr
        basis = [
            ((1, 0, 0), (0, 0, 0)),   # 1
            ((0, 1, 0), (0, 0, 0)),   # u
            ((0, 0, 1), (0, 0, 0)),   # u^2
            ((0, 0, 0), (1, 0, 0)),   # v
            ((0, 0, 0), (0, 1, 0)),   # uv
            ((0, 0, 0), (0, 0, 1)),   # u^2 v
        ]
        self.frob_imgs = [_h6_pow(b, p, p, nr) for b in basis]

    @functools.lru_cache(maxsize=None)
    def _img_dev(self, b: int):
        return self.e6.from_int(self.frob_imgs[b])

    def frobenius(self, x):
        """x^p as a linear map over the Fp coordinates."""
        e6 = self.e6
        coords = self.coeffs6(x)
        sh = self.fp.eshape(coords[0])
        acc = None
        for b, coord in enumerate(coords):
            img = e6.broadcast_to(self._img_dev(b), sh)
            term = _scale_ext_by_fp(self, img, coord)
            acc = term if acc is None else e6.add(acc, term)
        return acc

    def conjugate(self, x):
        """x^(p^3): v -> -v (v^2 = u is a non-square in Fp3)."""
        e6 = self.e6
        return e6.build([e6.coeff(x, 0), self.e3.neg(e6.coeff(x, 1))])

    # -- cyclotomic ops (the plain ops, as the reference) --------------------
    def cyclotomic_square(self, x):
        return self.e6.square(x)

    def inverse_cyclotomic(self, x):
        return self.conjugate(x)

    def exp_cyclotomic(self, x, e: int):
        """x^e for static e >= 0: the engine's MSB-first ladder, whose
        squarings are the cyclotomic ones here."""
        return self.e6.exp_const(x, e)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

TOWER6_PARAMS = {
    # fp/bw6_utils.go: u^3 = -4
    "bw6_761": (fs.BW6_761_FP, -4),
    # fp/bw6_utils.go (bw6-633): u^3 = 2
    "bw6_633": (fs.BW6_633_FP, 2),
}


@functools.lru_cache(maxsize=None)
def _tower6(name: str, device: str) -> Tower6:
    spec, nr = TOWER6_PARAMS[name]
    return Tower6(name, spec, nr, device=device)


def get_tower6(name: str, device=DEFAULT_DEVICE) -> Tower6:
    """The word-tensor tower of a BW6 curve, its constants on device."""
    return _tower6(name, str(torch.device(device)))
