"""Degree-12 pairing towers (Fp2 -> Fp6 -> Fp12) for BN / BLS12 curves.

Counterpart of ``gnark_crypto_tpu/towers/tower12.py`` (the reference's
``ecc/<curve>/internal/fptower``): one generic :class:`Tower12`
parameterized by (fp, beta, xi) assembles the engines and precomputes
(host-side, exact ints) every Frobenius / twist constant the reference
hardcodes in generated Go.

E12 layout: tensor (..., 2, 3, 2, W) = [w][v][u][word]; in gnark terms
coefficient (i, j) is C{i}.B{j} and the flat ordering used in the
cyclotomic formulas is x0..x5 = C0B0, C0B1, C0B2, C1B0, C1B1, C1B2.

A tower is bound to a device (``get_tower(name, device)``): its constants
live there. The same formulas run over the symbolic engines of
``towers/symbolic.py`` to assemble the VM's pairing programs.
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.curve.glv import split_scalar
from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.specs.curve import _lattice_2d, get_curve
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.towers.engine import CubicExtEngine, QuadExtEngine


# ---------------------------------------------------------------------------
# host-side exact Fp2 arithmetic (for precomputing constants)
# ---------------------------------------------------------------------------

def _h2_mul(a, b, p, beta):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 + beta * a1 * b1) % p, (a0 * b1 + a1 * b0) % p)


def _h2_pow(a, e, p, beta):
    r = (1, 0)
    while e:
        if e & 1:
            r = _h2_mul(r, a, p, beta)
        a = _h2_mul(a, a, p, beta)
        e >>= 1
    return r


def _h2_inv(a, p, beta):
    a0, a1 = a
    norm = (a0 * a0 - beta * a1 * a1) % p
    ninv = pow(norm, -1, p)
    return (a0 * ninv % p, (-a1 * ninv) % p)


def _naf(e: int) -> list[int]:
    """Non-adjacent form digits of e > 0, LSB first."""
    digits = []
    while e:
        if e & 1:
            d = 2 - (e & 3)  # 1 or -1
            digits.append(d)
            e -= d
        else:
            digits.append(0)
        e >>= 1
    return digits


def _scale_ext_by_fp(tw, ext_elem, fp_scalar):
    """Scale an extension element by an fp scalar (componentwise): insert
    broadcast axes for the extension dims before the word axis (the
    reference keeps this helper in ``towers/tower24.py``)."""
    f = tw.fp
    extra = ext_elem.ndim - fp_scalar.ndim
    s = fp_scalar
    for _ in range(extra):
        s = s[..., None, :] if f.elem_dims else s[..., None]
    # f.mul broadcasts over the inserted extension axes (word tensors and
    # the symbolic program-emitting engine alike)
    return f.mul(ext_elem, s)


class GtExpMixin:
    """GT exponentiation ladders (reference e12.go:512 CyclotomicExp and
    :552 ExpGLV), written against ``.e12``, ``conjugate``,
    ``cyclotomic_square`` and ``frobenius``. The reference's jitted
    square/multiply kernels are plain calls here."""

    def gt_exp(self, x, e: int):
        """x^e for cyclotomic x, NAF digits with free inversion (conjugate).
        e may be negative."""
        e12 = self.e12
        if e == 0:
            return e12.broadcast_to(e12.ones(device=x.device), e12.eshape(x))
        if e < 0:
            x = self.conjugate(x)
            e = -e
        digits = _naf(e)  # LSB first
        xinv = self.conjugate(x)
        res = None
        for d in reversed(digits):
            if res is not None:
                res = self.cyclotomic_square(res)
            if d == 1:
                res = x if res is None else e12.mul(res, x)
            elif d == -1:
                res = xinv if res is None else e12.mul(res, xinv)
        return res

    def gt_exp_glv(self, x, e: int):
        """x^e via 2-dim GLV over the Frobenius endomorphism (z^p ==
        z^lambda on GT, lambda = p mod r): a joint 1-bit ladder with half
        the squarings of gt_exp. Valid for order-r elements only."""
        e12 = self.e12
        try:
            r = get_curve(f"{self.name}_g1").fr.modulus
        except KeyError:
            return self.gt_exp(x, e)
        if e == 0:
            return e12.broadcast_to(e12.ones(device=x.device), e12.eshape(x))
        if e < 0:
            x = self.conjugate(x)
            e = -e
        lam = self.p % r
        k1, k2 = split_scalar(e % r, lam, _lattice_2d(r, lam), r)
        t1 = x if k1 >= 0 else self.conjugate(x)
        fx = self.frobenius(x)
        t2 = fx if k2 >= 0 else self.conjugate(fx)
        k1, k2 = abs(k1), abs(k2)
        table = {1: t1, 2: t2, 3: e12.mul(t1, t2)}
        res = None
        for i in range(max(k1.bit_length(), k2.bit_length()) - 1, -1, -1):
            if res is not None:
                res = self.cyclotomic_square(res)
            s = ((k2 >> i) & 1) << 1 | ((k1 >> i) & 1)
            if s:
                res = table[s] if res is None else e12.mul(res, table[s])
        if res is None:
            res = e12.broadcast_to(e12.ones(device=x.device), e12.eshape(x))
        return res


class SparseLineMixin:
    """Sparse Miller-line products (reference
    ``ecc/bn254/internal/fptower/e12_pairing.go:70-220``), written against
    the ``.e2/.e6/.e12`` aliases and ``._mul_by_xi``. Bit-identical to the
    dense products."""

    # -- sparse E6 helpers (Miller-line products) ---------------------------
    def _e6_mul_by_01(self, z, c0, c1):
        """E6 z * (c0 + c1 v) (reference e6.go:156 MulBy01)."""
        e2, e6 = self.e2, self.e6
        b0, b1, b2 = (e6.coeff(z, j) for j in range(3))
        a = e2.mul(b0, c0)
        b = e2.mul(b1, c1)
        t0 = e2.add(self._mul_by_xi(
            e2.sub(e2.mul(c1, e2.add(b1, b2)), b)), a)
        t2 = e2.add(e2.sub(e2.mul(c0, e2.add(b0, b2)), a), b)
        t1 = e2.sub(e2.sub(e2.mul(e2.add(c0, c1), e2.add(b0, b1)), a), b)
        return e6.build([t0, t1, t2])

    def _e6_mul_by_1(self, z, c1):
        """E6 z * (c1 v) (reference e6.go:188 MulBy1)."""
        e2, e6 = self.e2, self.e6
        b0, b1, b2 = (e6.coeff(z, j) for j in range(3))
        b = e2.mul(b1, c1)
        t0 = self._mul_by_xi(e2.sub(e2.mul(c1, e2.add(b1, b2)), b))
        t1 = e2.sub(e2.mul(c1, e2.add(b0, b1)), b)
        return e6.build([t0, t1, b])

    def _e6_mul_by_12(self, z, c1, c2):
        """E6 z * (c1 v + c2 v^2) (reference e6.go:128 MulBy12)."""
        e2, e6 = self.e2, self.e6
        b0, b1, b2 = (e6.coeff(z, j) for j in range(3))
        t1 = e2.mul(b1, c1)
        t2 = e2.mul(b2, c2)
        o0 = self._mul_by_xi(e2.sub(e2.sub(
            e2.mul(e2.add(b1, b2), e2.add(c1, c2)), t1), t2))
        o1 = e2.add(e2.sub(e2.mul(e2.add(b0, b1), c1), t1),
                    self._mul_by_xi(t2))
        o2 = e2.add(e2.sub(e2.mul(c2, e2.add(b0, b2)), t2), t1)
        return e6.build([o0, o1, o2])

    # -- sparse E12 muls for Miller-line accumulation -----------------------
    # D-twist (bn254/bls12-377): lines are (1, 0, 0, c3, c4, 0) elements.
    def mul_by_34(self, z, c3, c4):
        """z * (1 + c3 w + c4 v w) (reference e12_pairing.go:112 MulBy34)."""
        e2, e6, e12 = self.e2, self.e6, self.e12
        z0, z1 = e12.coeff(z, 0), e12.coeff(z, 1)
        a = z0
        b = self._e6_mul_by_01(z1, c3, c4)
        one = e2.broadcast_to(e2.ones(), e2.eshape(c3))
        d0 = e2.add(one, c3)
        d = self._e6_mul_by_01(e6.add(z0, z1), d0, c4)
        o1 = e6.add(e6.neg(e6.add(a, b)), d)
        o0 = e6.add(e6.mul_by_v(b), a)
        return e12.build([o0, o1])

    def mul_34_by_34(self, d3, d4, c3, c4):
        """(1,0,0,d3,d4,0)*(1,0,0,c3,c4,0) -> 01234 coeffs [x0..x4]
        (reference e12_pairing.go:161 Mul34By34)."""
        e2 = self.e2
        x3 = e2.mul(c3, d3)
        x4 = e2.mul(c4, d4)
        x04 = e2.add(c4, d4)
        x03 = e2.add(c3, d3)
        x34 = e2.sub(e2.sub(e2.mul(e2.add(d3, d4), e2.add(c3, c4)), x3), x4)
        one = e2.broadcast_to(e2.ones(), e2.eshape(x3))
        z00 = e2.add(self._mul_by_xi(x4), one)
        return (z00, x3, x34, x03, x04)

    def mul_by_01234(self, z, xs):
        """z * (x0, x1, x2, x3, x4, 0) (reference MulBy01234)."""
        e6, e12 = self.e6, self.e12
        x0, x1, x2, x3, x4 = xs
        zero2 = self.e2.zeros(self.e2.eshape(x0))
        c0 = e6.build([x0, x1, x2])
        c1 = e6.build([x3, x4, zero2])
        z0, z1 = e12.coeff(z, 0), e12.coeff(z, 1)
        a = e6.mul(e6.add(z0, z1), e6.add(c0, c1))
        b = e6.mul(z0, c0)
        c = self._e6_mul_by_01(z1, x3, x4)
        o1 = e6.sub(e6.sub(a, b), c)
        o0 = e6.add(e6.mul_by_v(c), b)
        return e12.build([o0, o1])

    def _e6_mul_by_e2(self, z, c):
        """E6 z scaled coefficientwise by an E2 element (e6.go MulByE2)."""
        e2, e6 = self.e2, self.e6
        return e6.build([e2.mul(e6.coeff(z, j), c) for j in range(3)])

    def mul_by_034(self, z, c0, c3, c4):
        """z * (c0, 0, 0, c3, c4, 0) — the D-twist Miller line product
        (reference e12_pairing.go MulBy034; 13 E2 muls vs 18 for a full
        E12 mul)."""
        e2, e6, e12 = self.e2, self.e6, self.e12
        z0, z1 = e12.coeff(z, 0), e12.coeff(z, 1)
        a = self._e6_mul_by_e2(z0, c0)
        b = self._e6_mul_by_01(z1, c3, c4)
        d = self._e6_mul_by_01(e6.add(z0, z1), e2.add(c0, c3), c4)
        o1 = e6.sub(e6.sub(d, a), b)
        o0 = e6.add(e6.mul_by_v(b), a)
        return e12.build([o0, o1])

    def mul_by_014(self, z, c0, c1, c4):
        """z * (c0, c1, 0, 0, c4, 0) — the M-twist Miller line product
        (bls12-381 e12_pairing.go MulBy014; 13 E2 muls)."""
        e2, e6, e12 = self.e2, self.e6, self.e12
        z0, z1 = e12.coeff(z, 0), e12.coeff(z, 1)
        a = self._e6_mul_by_01(z0, c0, c1)
        b = self._e6_mul_by_1(z1, c4)
        d = self._e6_mul_by_01(e6.add(z0, z1), c0, e2.add(c1, c4))
        o1 = e6.sub(e6.sub(d, a), b)
        o0 = e6.add(e6.mul_by_v(b), a)
        return e12.build([o0, o1])

    # M-twist (bls12-381): lines are (c0, c1, 0, 0, 1, 0) elements.
    def mul_by_01(self, z, c0, c1):
        """z * (c0, c1, 0, 0, 1, 0) (bls12-381 e12_pairing.go:70 MulBy01)."""
        e2, e6, e12 = self.e2, self.e6, self.e12
        z0, z1 = e12.coeff(z, 0), e12.coeff(z, 1)
        a = self._e6_mul_by_01(z0, c0, c1)
        b = e6.mul_by_v(z1)
        one = e2.broadcast_to(e2.ones(), e2.eshape(c1))
        d = e2.add(c1, one)
        o1 = self._e6_mul_by_01(e6.add(z1, z0), c0, d)
        o1 = e6.sub(e6.sub(o1, a), b)
        o0 = e6.add(e6.mul_by_v(b), a)
        return e12.build([o0, o1])

    def mul_01_by_01(self, d0, d1, c0, c1):
        """(c0,c1,0,0,1,0)*(d0,d1,0,0,1,0) -> 01245 coeffs [x0..x4]
        (bls12-381 e12_pairing.go:120 Mul01By01)."""
        e2 = self.e2
        x0 = e2.mul(c0, d0)
        x1 = e2.mul(c1, d1)
        x04 = e2.add(d0, c0)
        x01 = e2.sub(e2.sub(e2.mul(e2.add(d0, d1), e2.add(c0, c1)), x0), x1)
        x14 = e2.add(d1, c1)
        one = e2.broadcast_to(e2.ones(), e2.eshape(x0))
        z00 = e2.add(self._mul_by_xi(one), x0)
        return (z00, x01, x1, x04, x14)

    def mul_by_01245(self, z, xs):
        """z * (x0, x1, x2, 0, x4, x5) (bls12-381 MulBy01245)."""
        e6, e12 = self.e6, self.e12
        x0, x1, x2, x4, x5 = xs
        zero2 = self.e2.zeros(self.e2.eshape(x0))
        c0 = e6.build([x0, x1, x2])
        c1 = e6.build([zero2, x4, x5])
        z0, z1 = e12.coeff(z, 0), e12.coeff(z, 1)
        a = e6.mul(e6.add(z0, z1), e6.add(c0, c1))
        b = e6.mul(z0, c0)
        c = self._e6_mul_by_12(z1, x4, x5)
        o1 = e6.sub(e6.sub(a, b), c)
        o0 = e6.add(e6.mul_by_v(c), b)
        return e12.build([o0, o1])


class Tower12(GtExpMixin, SparseLineMixin):
    """Engines + constants for one Fp12 tower.

    Args mirror the reference's per-curve choices:
      beta: E2 non-residue (u^2 = beta), e.g. -1 (bn254/bls12-381)
      xi:   E6 non-residue in E2 (v^3 = xi), e.g. (9, 1) for bn254
    """

    def __init__(self, name: str, fp_spec: FieldSpec, beta: int, xi: tuple,
                 *, fp=None, quad_cls=None, cubic_cls=None,
                 device=DEFAULT_DEVICE):
        """``fp``/``quad_cls``/``cubic_cls`` inject alternative engine
        implementations (the symbolic program-emitting engines of
        ``towers/symbolic.py``); defaults are the word-tensor engines."""
        self.name = name
        self.fp_spec = fp_spec
        self.p = fp_spec.modulus
        self.beta = beta % self.p if beta > 0 else beta
        self.xi = tuple(c % self.p for c in xi)
        self.fp: FieldEngine = fp if fp is not None else for_spec(fp_spec)
        quad_cls = quad_cls or QuadExtEngine
        cubic_cls = cubic_cls or CubicExtEngine
        self.e2 = quad_cls(self.fp, beta, tag=f"{name}_e2", device=device)

        def mul_by_xi(a, _self=self):
            return _self._mul_by_xi(a)

        self.e6 = cubic_cls(self.e2, self.xi, mul_by_nr=mul_by_xi,
                            tag=f"{name}_e6", device=device)
        self.e12 = quad_cls(self.e6, None, mul_by_nr=self.e6.mul_by_v,
                            tag=f"{name}_e12", device=device)
        self._precompute_frobenius()

    # -- xi multiplication (specialized small-int forms) --------------------
    def _mul_by_xi(self, a):
        """a * xi for a in E2 (reference E2.MulByNonResidue)."""
        e2, f = self.e2, self.fp
        x0, x1 = self.xi
        a0, a1 = e2.coeff(a, 0), e2.coeff(a, 1)
        small = x0 <= 16 and (x1 <= 16)
        if small and self.beta == -1:
            # (x0 + x1 u)(a0 + a1 u) = (x0 a0 - x1 a1) + (x0 a1 + x1 a0) u
            c0 = f.sub(f.mul_const(a0, x0), f.mul_const(a1, x1))
            c1 = f.add(f.mul_const(a1, x0), f.mul_const(a0, x1))
            return e2.build([c0, c1])
        const = e2.broadcast_to(e2.from_int(self.xi), e2.eshape(a))
        return e2.mul(a, const)

    # -- frobenius constants ------------------------------------------------
    def _precompute_frobenius(self):
        p, beta, xi = self.p, self.beta, self.xi
        # gamma1[i] = xi^(i*(p-1)/6), i=1..5 (E2 constants)
        self.g1 = [_h2_pow(xi, i * (p - 1) // 6, p, beta) for i in range(6)]
        p2 = p * p
        # gamma2[i] = xi^(i*(p^2-1)/6) — lie in Fp (real)
        self.g2 = [_h2_pow(xi, i * (p2 - 1) // 6, p, beta) for i in range(6)]
        p3 = p2 * p
        self.g3 = [_h2_pow(xi, i * (p3 - 1) // 6, p, beta) for i in range(6)]

    @functools.lru_cache(maxsize=None)
    def _gdev(self, which: int, i: int):
        tbl = {1: self.g1, 2: self.g2, 3: self.g3}[which]
        return self.e2.from_int(tbl[i])

    # -- coefficient helpers -------------------------------------------------
    def coeffs6(self, x):
        """E12 -> tuple of 6 E2 coefficients x0..x5 (C0B0..C1B2)."""
        e12, e6 = self.e12, self.e6
        c0, c1 = e12.coeff(x, 0), e12.coeff(x, 1)
        return tuple(e6.coeff(c0, j) for j in range(3)) + \
            tuple(e6.coeff(c1, j) for j in range(3))

    def from_coeffs6(self, cs):
        e12, e6 = self.e12, self.e6
        return e12.build([e6.build(cs[:3]), e6.build(cs[3:])])

    # -- frobenius maps ------------------------------------------------------
    def conjugate(self, x):
        """x -> x0 - x1 w (= x^(p^6), the E12 conjugation)."""
        return self.e12.conjugate(x)

    def _frob_apply(self, x, which: int, conj: bool):
        e2 = self.e2
        cs = self.coeffs6(x)
        # exponents of gamma for coefficients (C0B0,C0B1,C0B2,C1B0,C1B1,C1B2)
        exps = (0, 2, 4, 1, 3, 5)
        out = []
        for c, e in zip(cs, exps):
            v = e2.conjugate(c) if conj else c
            if e:
                g = e2.broadcast_to(self._gdev(which, e), e2.eshape(v))
                v = e2.mul(v, g)
            out.append(v)
        return self.from_coeffs6(out)

    def frobenius(self, x):
        """x^p (reference e12.go Frobenius)."""
        return self._frob_apply(x, 1, conj=True)

    def frobenius_square(self, x):
        """x^(p^2) — gamma2 are real, no conjugation."""
        return self._frob_apply(x, 2, conj=False)

    def frobenius_cube(self, x):
        """x^(p^3)."""
        return self._frob_apply(x, 3, conj=True)

    # -- cyclotomic ops ------------------------------------------------------
    def cyclotomic_square(self, x):
        """Granger-Scott squaring in the cyclotomic subgroup
        (reference e12.go:371 CyclotomicSquare; same op sequence)."""
        e2 = self.e2
        x0, x1, x2, x3, x4, x5 = self.coeffs6(x)
        t0 = e2.square(x4)
        t1 = e2.square(x0)
        t6 = e2.sub(e2.sub(e2.square(e2.add(x4, x0)), t0), t1)   # 2*x4*x0
        t2 = e2.square(x2)
        t3 = e2.square(x3)
        t7 = e2.sub(e2.sub(e2.square(e2.add(x2, x3)), t2), t3)   # 2*x2*x3
        t4 = e2.square(x5)
        t5 = e2.square(x1)
        t8 = self._mul_by_xi(
            e2.sub(e2.sub(e2.square(e2.add(x5, x1)), t4), t5))   # 2*x5*x1*xi
        t0 = e2.add(self._mul_by_xi(t0), t1)   # x4^2 xi + x0^2
        t2 = e2.add(self._mul_by_xi(t2), t3)   # x2^2 xi + x3^2
        t4 = e2.add(self._mul_by_xi(t4), t5)   # x5^2 xi + x1^2
        z0 = e2.add(e2.double(e2.sub(t0, x0)), t0)
        z1 = e2.add(e2.double(e2.sub(t2, x1)), t2)
        z2 = e2.add(e2.double(e2.sub(t4, x2)), t4)
        z3 = e2.add(e2.double(e2.add(t8, x3)), t8)
        z4 = e2.add(e2.double(e2.add(t6, x4)), t6)
        z5 = e2.add(e2.double(e2.add(t7, x5)), t7)
        return self.from_coeffs6([z0, z1, z2, z3, z4, z5])

    def exp_cyclotomic(self, x, e: int):
        """x^e for cyclotomic x with static e >= 0 (reference Expt ladder):
        MSB-first square-multiply from x with cyclotomic squarings."""
        e12 = self.e12
        if e == 0:
            return e12.broadcast_to(e12.ones(), e12.eshape(x))
        res = x
        for bit in bin(e)[3:]:  # MSB consumed by res = x
            res = self.cyclotomic_square(res)
            if bit == "1":
                res = e12.mul(res, x)
        return res

    def inverse_cyclotomic(self, x):
        """In the cyclotomic subgroup, x^-1 == conjugate(x)."""
        return self.conjugate(x)

    # -- Karabina compressed cyclotomic squaring -----------------------------
    # (reference e12.go:142 CyclotomicSquareCompressed / :226
    # DecompressKarabina / :296 BatchDecompressKarabina)

    def cyclotomic_square_compressed(self, x):
        """Karabina 2345 squaring: updates g1,g2,g3,g5 only (g0,g4 pass
        through unused). Th. 3.2 of eprint 2010/542 (e12.go:142)."""
        e2 = self.e2
        g0, g1, g2, g3, g4, g5 = self.coeffs6(x)
        t0 = e2.square(g1)
        t1 = e2.square(g5)
        t5 = e2.add(g1, g5)
        t2 = e2.square(t5)
        t3 = e2.add(t0, t1)
        t5 = e2.sub(t2, t3)                     # 2 g1 g5
        t6 = e2.add(g3, g2)
        t3 = e2.square(t6)                      # (g3+g2)^2
        t2 = e2.square(g3)
        t6 = self._mul_by_xi(t5)                # 2 nr g1 g5
        t5 = e2.double(e2.add(t6, g3))
        z3 = e2.add(t5, t6)                     # 6 nr g1 g5 + 2 g3
        t4 = self._mul_by_xi(t1)
        t5 = e2.add(t0, t4)                     # nr g5^2 + g1^2
        t6 = e2.sub(t5, g2)
        t1 = e2.square(g2)
        t6 = e2.double(t6)
        z2 = e2.add(t6, t5)                     # 3 nr g5^2 + 3 g1^2 - 2 g2
        t4 = self._mul_by_xi(t1)
        t5 = e2.add(t2, t4)                     # g3^2 + nr g2^2
        t6 = e2.sub(t5, g1)
        t6 = e2.double(t6)
        z1 = e2.add(t6, t5)                     # 3 g3^2 + 3 nr g2^2 - 2 g1
        t0 = e2.add(t2, t1)
        t5 = e2.sub(t3, t0)                     # 2 g3 g2
        t6 = e2.add(t5, g5)
        t6 = e2.double(t6)
        z5 = e2.add(t5, t6)                     # 6 g3 g2 + 2 g5
        return self.from_coeffs6([g0, z1, z2, z3, g4, z5])

    def decompress_karabina(self, x):
        """Recover (g0, g4) from a compressed (g1,g2,g3,g5) element, fully
        masked/batched (the reference's data-dependent branches become
        selects; division is batched — e12.go:226/:296)."""
        e2 = self.e2
        _, g1, g2, g3, _, g5 = self.coeffs6(x)
        g3_zero = e2.is_zero(g3)
        both_zero = g3_zero & e2.is_zero(g2)

        # branch g3 == 0: t0 = 2 g1 g5, t1 = g2
        a0 = e2.double(e2.mul(g1, g5))
        # branch g3 != 0: t0 = nr g5^2 + 3 g1^2 - 2 g2, t1 = 4 g3
        sq1 = e2.square(g1)
        b0 = e2.add(self._mul_by_xi(e2.square(g5)),
                    e2.add(sq1, e2.double(e2.sub(sq1, g2))))
        t0 = e2.where(g3_zero, a0, b0)
        t1 = e2.where(g3_zero, g2, e2.double(e2.double(g3)))
        one = e2.broadcast_to(e2.ones(), e2.eshape(g1))
        # guard the x == 1 lanes (t1 would be 0) before the batched inverse
        t1 = e2.where(both_zero, one, t1)
        g4 = e2.mul(t0, e2.inverse(t1))

        # g0 = nr (2 g4^2 + g3 g5 - 3 g2 g1) + 1
        t1b = e2.mul(g2, g1)
        t2 = e2.sub(e2.double(e2.sub(e2.square(g4), t1b)), t1b)
        t2 = e2.add(t2, e2.mul(g3, g5))
        g0 = e2.add(self._mul_by_xi(t2), one)

        zero = e2.zeros(e2.eshape(g1))
        g0 = e2.where(both_zero, one, g0)
        g1 = e2.where(both_zero, zero, g1)
        g2 = e2.where(both_zero, zero, g2)
        g3 = e2.where(both_zero, zero, g3)
        g4 = e2.where(both_zero, zero, g4)
        g5 = e2.where(both_zero, zero, g5)
        return self.from_coeffs6([g0, g1, g2, g3, g4, g5])

    # -- torus (T2) compression ---------------------------------------------

    def compress_torus(self, x):
        """GT element -> E6 torus representative g = (1 + c0)/c1
        (e12.go:748 CompressTorus; batched division == BatchCompressTorus).
        Undefined for c1 == 0 (x == ±1) — reference returns an error."""
        e6, e12 = self.e6, self.e12
        c0, c1 = e12.coeff(x, 0), e12.coeff(x, 1)
        one = e6.broadcast_to(e6.ones(), e6.eshape(c0))
        return e6.mul(e6.add(c0, one), e6.inverse(c1))

    def decompress_torus(self, g):
        """E6 torus representative -> GT: (g + w)/(g - w)
        (e12.go:798 DecompressTorus)."""
        e6, e12 = self.e6, self.e12
        one = e6.broadcast_to(e6.ones(), e6.eshape(g))
        num = e12.build([g, one])
        den = e12.build([g, e6.neg(one)])
        return e12.mul(num, e12.inverse(den))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

TOWER12_PARAMS = {
    # ecc/bn254/internal/fptower: u^2=-1, v^3 = 9+u (e2.go, e6.go)
    "bn254": (fs.BN254_FP, -1, (9, 1)),
    # bls12-381 tower: u^2=-1, v^3 = 1+u
    "bls12_381": (fs.BLS12_381_FP, -1, (1, 1)),
    # bls12-377 tower: u^2=-5, v^3 = u
    "bls12_377": (fs.BLS12_377_FP, -5, (0, 1)),
}


@functools.lru_cache(maxsize=None)
def _tower(name: str, device: str) -> Tower12:
    spec, beta, xi = TOWER12_PARAMS[name]
    return Tower12(name, spec, beta, xi, device=device)


def get_tower(name: str, device=DEFAULT_DEVICE) -> Tower12:
    """The word-tensor tower of a BN/BLS12 curve, its constants on device."""
    return _tower(name, str(torch.device(device)))
