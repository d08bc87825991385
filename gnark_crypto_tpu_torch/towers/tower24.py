"""Degree-24 pairing tower (Fp2 -> Fp4 -> Fp12 -> Fp24) for BLS24 curves.

Counterpart of ``gnark_crypto_tpu/towers/tower24.py`` (the reference's
``ecc/bls24-315/internal/fptower``). E24 has the sextic-over-quadratic
shape of E12, E24 = L[theta]/(theta^6 - xi) with L = Fp4 and xi = v (the
Fp4 generator over Fp2), so the 6-coefficient Frobenius, cyclotomic,
GT-exponentiation and sparse-line code of ``towers/tower12.py`` carries
over with:

* the coefficient level L = E4 (engine-wise Quad(Quad(fp)));
* the p-power maps on L as host-precomputed images of its Fp basis
  (L's own Frobenius, in place of E2 conjugation);
* gamma tables gamma_j[e] = v^(e (p^j - 1) / 6) in E4.

E24 layout: tensor (..., 2, 3, 2, 2, W) = [z][w][v][u][word]; flat
coefficients x0..x5 = D0.C0, D0.C1, D0.C2, D1.C0, D1.C1, D1.C2 (E4 each).

A tower is bound to a device (``get_tower24(name, device)``): its constants
live there. The same formulas run over the symbolic engines of
``towers/symbolic.py`` to assemble the bls24 VM pairing programs.
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.towers.engine import CubicExtEngine, QuadExtEngine
from gnark_crypto_tpu_torch.towers.tower12 import (
    GtExpMixin, SparseLineMixin, _h2_mul, _scale_ext_by_fp)


# ---------------------------------------------------------------------------
# host-side exact Fp4 arithmetic (E2 pairs; v^2 = vsq, u^2 = beta)
# ---------------------------------------------------------------------------

def _h4_mul(a, b, p, beta, vsq=(0, 1)):
    a0, a1 = a
    b0, b1 = b
    t0 = _h2_mul(a0, b0, p, beta)
    t1 = _h2_mul(_h2_mul(a1, b1, p, beta), vsq, p, beta)  # v^2 * a1 b1
    c0 = tuple((x + y) % p for x, y in zip(t0, t1))
    c1 = tuple((x + y) % p for x, y in
               zip(_h2_mul(a0, b1, p, beta), _h2_mul(a1, b0, p, beta)))
    return (c0, c1)


def _h4_pow(a, e, p, beta, vsq=(0, 1)):
    r = ((1, 0), (0, 0))
    while e:
        if e & 1:
            r = _h4_mul(r, a, p, beta, vsq)
        a = _h4_mul(a, a, p, beta, vsq)
        e >>= 1
    return r


class Tower24(GtExpMixin, SparseLineMixin):
    """Engines + constants for one Fp24 tower. The level names follow
    Tower12, so the pairing code serves both: ``.e2`` is the coefficient
    level (E4), ``.e6`` the cubic level (E12), ``.e12`` the top (E24);
    ``.e2_fp`` is the Fp2 level."""

    def __init__(self, name: str, fp_spec: FieldSpec, beta: int,
                 v_sq=(0, 1), *, fp=None, quad_cls=None, cubic_cls=None,
                 device=DEFAULT_DEVICE):
        """``beta``: E2 non-residue (u^2 = beta); ``v_sq``: E4 non-residue as
        an E2 pair (v^2 = v_sq). bls24-315: beta = 13, v^2 = u (e2.go:201);
        bls24-317: beta = -1, v^2 = 1 + u (e2_bls317.go:35). ``fp``,
        ``quad_cls``, ``cubic_cls``: the symbolic engines of
        ``towers/symbolic.py`` in place of the word-tensor ones."""
        self.name = name
        self.fp_spec = fp_spec
        self.p = fp_spec.modulus
        self.beta = beta
        self.v_sq = v_sq
        self.fp: FieldEngine = fp if fp is not None else for_spec(fp_spec)
        quad_cls = quad_cls or QuadExtEngine
        cubic_cls = cubic_cls or CubicExtEngine
        e2 = quad_cls(self.fp, beta, tag=f"{name}_e2", device=device)

        if v_sq == (0, 1):
            def mul_by_vsq(a, _b=e2):
                # (a0 + a1 u) * u = beta a1 + a0 u
                a0, a1 = _b.coeff(a, 0), _b.coeff(a, 1)
                return _b.build([_b.mul_by_nr(a1), a0])
        elif v_sq == (1, 1):
            _beta = beta

            def mul_by_vsq(a, _b=e2):
                # (a0 + a1 u) * (1 + u) = (a0 + beta a1) + (a0 + a1) u
                f = _b.base
                a0, a1 = _b.coeff(a, 0), _b.coeff(a, 1)
                b_a1 = f.neg(a1) if _beta == -1 else f.mul_const(a1, _beta)
                return _b.build([f.add(a0, b_a1), f.add(a0, a1)])
        else:
            def mul_by_vsq(a, _b=e2):
                c = _b.from_int(v_sq, device=_b.device)
                return _b.mul(a, _b.broadcast_to(c, _b.eshape(a)))

        e4 = quad_cls(e2, v_sq, mul_by_nr=mul_by_vsq, tag=f"{name}_e4",
                      device=device)

        def mul_by_v(a, _b=e4):
            # (A0 + A1 v) * v = v_sq A1 + A0 v  (A_i in E2)
            a0, a1 = _b.coeff(a, 0), _b.coeff(a, 1)
            return _b.build([mul_by_vsq(a1), a0])

        e12 = cubic_cls(e4, ((0, 0), (1, 0)), mul_by_nr=mul_by_v,
                        tag=f"{name}_e12", device=device)
        e24 = quad_cls(e12, None, mul_by_nr=e12.mul_by_v, tag=f"{name}_e24",
                       device=device)
        self.e2_fp = e2
        self.e2 = e4
        self.e6 = e12
        self.e12 = e24
        self._mul_by_vsq = mul_by_vsq
        self._mul_by_v = mul_by_v
        self._precompute_frobenius()

    # xi = v: mul-by-xi on the coefficient level (E4)
    def _mul_by_xi(self, a):
        return self._mul_by_v(a)

    def _precompute_frobenius(self):
        p, beta, vsq = self.p, self.beta, self.v_sq
        v = ((0, 0), (1, 0))  # v as an E4 element
        u = ((0, 1), (0, 0))
        uv = ((0, 0), (0, 1))
        self.g = {}
        self.basis_imgs = {}
        for j in (1, 2, 3, 4):
            pj = p ** j
            self.g[j] = [_h4_pow(v, e * (pj - 1) // 6, p, beta, vsq)
                         for e in range(6)]
            # p^j-power images of the E4 basis (1, u, v, uv)
            self.basis_imgs[j] = [
                ((1, 0), (0, 0)),
                _h4_pow(u, pj, p, beta, vsq),
                _h4_pow(v, pj, p, beta, vsq),
                _h4_pow(uv, pj, p, beta, vsq),
            ]

    @functools.lru_cache(maxsize=None)
    def _gdev(self, j: int, e: int):
        return self.e2.from_int(self.g[j][e])

    @functools.lru_cache(maxsize=None)
    def _img_dev(self, j: int, b: int):
        return self.e2.from_int(self.basis_imgs[j][b])

    # -- coefficient helpers -------------------------------------------------
    def coeffs6(self, x):
        """E24 -> tuple of 6 E4 coefficients x0..x5 (D0.C0 .. D1.C2)."""
        e24, e12 = self.e12, self.e6
        c0, c1 = e24.coeff(x, 0), e24.coeff(x, 1)
        return tuple(e12.coeff(c0, j) for j in range(3)) + \
            tuple(e12.coeff(c1, j) for j in range(3))

    def from_coeffs6(self, cs):
        e24, e12 = self.e12, self.e6
        return e24.build([e12.build(cs[:3]), e12.build(cs[3:])])

    # -- p^j-power map on the coefficient level (E4) -------------------------
    def _phi(self, c, j: int):
        """c^(p^j) for c in E4: a linear map over the Fp basis
        (1, u, v, uv)."""
        e4, e2 = self.e2, self.e2_fp
        b0 = e4.coeff(c, 0)  # E2: the (1, u) coordinates
        b1 = e4.coeff(c, 1)  # E2: the (v, uv) coordinates
        coords = [e2.coeff(b0, 0), e2.coeff(b0, 1),
                  e2.coeff(b1, 0), e2.coeff(b1, 1)]
        sh = self.fp.eshape(coords[0])
        acc = None
        for b, coord in enumerate(coords):
            img = e4.broadcast_to(self._img_dev(j, b), sh)
            term = _scale_ext_by_fp(self, img, coord)
            acc = term if acc is None else e4.add(acc, term)
        return acc

    # -- frobenius maps ------------------------------------------------------
    def conjugate(self, x):
        """z -> -z (= x^(p^12), the E24 conjugation)."""
        return self.e12.conjugate(x)

    def _frob_apply(self, x, j: int):
        e4 = self.e2
        cs = self.coeffs6(x)
        exps = (0, 2, 4, 1, 3, 5)
        out = []
        for c, e in zip(cs, exps):
            v = self._phi(c, j)
            if e:
                g = e4.broadcast_to(self._gdev(j, e), e4.eshape(v))
                v = e4.mul(v, g)
            out.append(v)
        return self.from_coeffs6(out)

    def frobenius(self, x):
        """x^p (reference e24.go Frobenius)."""
        return self._frob_apply(x, 1)

    def frobenius_square(self, x):
        """x^(p^2)."""
        return self._frob_apply(x, 2)

    def frobenius_cube(self, x):
        """x^(p^3)."""
        return self._frob_apply(x, 3)

    def frobenius_quad(self, x):
        """x^(p^4): the easy part's and the subgroup check's map."""
        return self._frob_apply(x, 4)

    # -- cyclotomic ops (Tower12's Granger-Scott shape, E4 coefficients) -----
    def cyclotomic_square(self, x):
        """Granger-Scott squaring in the cyclotomic subgroup (reference
        e24.go CyclotomicSquare; Tower12's op sequence)."""
        e4 = self.e2
        x0, x1, x2, x3, x4, x5 = self.coeffs6(x)
        t0 = e4.square(x4)
        t1 = e4.square(x0)
        t6 = e4.sub(e4.sub(e4.square(e4.add(x4, x0)), t0), t1)
        t2 = e4.square(x2)
        t3 = e4.square(x3)
        t7 = e4.sub(e4.sub(e4.square(e4.add(x2, x3)), t2), t3)
        t4 = e4.square(x5)
        t5 = e4.square(x1)
        t8 = self._mul_by_xi(
            e4.sub(e4.sub(e4.square(e4.add(x5, x1)), t4), t5))
        t0 = e4.add(self._mul_by_xi(t0), t1)
        t2 = e4.add(self._mul_by_xi(t2), t3)
        t4 = e4.add(self._mul_by_xi(t4), t5)
        z0 = e4.add(e4.double(e4.sub(t0, x0)), t0)
        z1 = e4.add(e4.double(e4.sub(t2, x1)), t2)
        z2 = e4.add(e4.double(e4.sub(t4, x2)), t4)
        z3 = e4.add(e4.double(e4.add(t8, x3)), t8)
        z4 = e4.add(e4.double(e4.add(t6, x4)), t6)
        z5 = e4.add(e4.double(e4.add(t7, x5)), t7)
        return self.from_coeffs6([z0, z1, z2, z3, z4, z5])

    def exp_cyclotomic(self, x, e: int):
        """x^e for cyclotomic x with static e >= 0: MSB-first
        square-multiply from x with cyclotomic squarings."""
        e24 = self.e12
        if e == 0:
            return e24.broadcast_to(e24.ones(), e24.eshape(x))
        res = x
        for bit in bin(e)[3:]:  # MSB consumed by res = x
            res = self.cyclotomic_square(res)
            if bit == "1":
                res = e24.mul(res, x)
        return res

    def inverse_cyclotomic(self, x):
        """In the cyclotomic subgroup, x^-1 == conjugate(x)."""
        return self.conjugate(x)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

TOWER24_PARAMS = {
    # fptower e2.go:201: u^2 = 13; v^2 = u
    "bls24_315": (fs.BLS24_315_FP, 13, (0, 1)),
    # fptower e2_bls317.go: u^2 = -1; e2_bls317.go:35 v^2 = 1 + u
    "bls24_317": (fs.BLS24_317_FP, -1, (1, 1)),
}


@functools.lru_cache(maxsize=None)
def _tower24(name: str, device: str) -> Tower24:
    spec, beta, v_sq = TOWER24_PARAMS[name]
    return Tower24(name, spec, beta, v_sq, device=device)


def get_tower24(name: str, device=DEFAULT_DEVICE) -> Tower24:
    """The word-tensor tower of a BLS24 curve, its constants on device."""
    return _tower24(name, str(torch.device(device)))
