"""Optimal ate pairings for BN254 / BLS12 / BLS24 curves, batched over pairs.

Counterpart of ``gnark_crypto_tpu/pairing/pairing12.py`` (reference
``ecc/bn254/pairing.go``, ``ecc/bls12-381/pairing.go``,
``ecc/bls24-315/pairing.go``): the per-curve pairing context (seed, loop
counter, twist constants), the homogeneous projective double/add steps with
their lines (eprint 2013/722 §4.3; pairing.go:292,333,377), the final
exponentiation and the hard parts. The BLS24 family runs the same code one
level up: its G2 coordinates and line coefficients are E4 elements and its
GT is E24 (``towers/tower24.py``, whose level names follow Tower12's).

:func:`pair` runs the whole pairing as VM programs
(``pairing/vm_pairing.py``): the formulas here are run over the symbolic
tower to assemble the programs, and the programs run on the VM kernel
(``field/vm.py``). The VM is the port's one pairing tier on every device;
the reference's eager step ladder (``miller_loop``) is not ported.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.towers.tower12 import (
    _h2_inv, _h2_mul, _scale_ext_by_fp, get_tower)
from gnark_crypto_tpu_torch.towers.tower24 import get_tower24


def naf(n: int) -> list[int]:
    """2-NAF digits little-endian (ecc.NafDecomposition)."""
    out = []
    while n:
        if n & 1:
            d = 2 - (n % 4)
            out.append(d)
            n -= d
        else:
            out.append(0)
        n >>= 1
    return out


class G2Proj(NamedTuple):
    x: object
    y: object
    z: object


class PairingCtx:
    """Per-curve pairing context (seed, loop counter, twist constants)."""

    def __init__(self, name: str, tower=None, device=DEFAULT_DEVICE):
        """``tower``: inject an alternative tower implementation (the
        symbolic program-emitting SymTower12 or SymTower24) in place of the
        word-tensor one on ``device``."""
        self.name = name
        if name == "bn254":
            self.tower = tower or get_tower("bn254", device)
            self.family = "bn"
            self.seed = 4965661367192848881          # x0 (bn254.go:155)
            self.seed_neg = False
            self.loop = naf(6 * self.seed + 2)        # 66 digits (bn254.go:152)
            # b' = b/xi (D-twist; bn254.go:118)
            p = self.tower.p
            self.b_twist = _h2_mul(_h2_inv(self.tower.xi, p, self.tower.beta),
                                   (3, 0), p, self.tower.beta)
            self.twist_type = "D"
        elif name in ("bls12_381", "bls12_377"):
            self.tower = tower or get_tower(name, device)
            self.family = "bls12"
            if name == "bls12_381":
                self.seed = 15132376222941642752      # |x0|, x0 < 0
                self.seed_neg = True
                b = 4
            else:
                self.seed = 9586122913090633729       # bls12-377 x0 > 0
                self.seed_neg = False
                b = 1
            self.loop = [int(bit) for bit in bin(self.seed)[2:]][::-1]
            p = self.tower.p
            if name == "bls12_381":
                # M-twist: b' = b * xi (bls12-381.go:113)
                self.b_twist = _h2_mul((b, 0), self.tower.xi, p,
                                       self.tower.beta)
                self.twist_type = "M"
            else:
                # bls12-377 D-twist: b' = b / xi = 1/u (bls12-377.go)
                self.b_twist = _h2_inv(self.tower.xi, p, self.tower.beta)
                self.twist_type = "D"
        elif name == "bls24_315":
            self.tower = tower or get_tower24(name, device)
            self.family = "bls24"
            self.seed = 3218079743        # |x0|, x0 < 0 (bls24-315.go:161;
            self.seed_neg = True          # Expt chain = x^(1+3*2^20-3*2^30))
            self.loop = naf(self.seed)    # NafDecomposition (bls24-315.go:158)
            p = self.tower.p
            # D-twist: b' = b / v = v^-1 = u v / 13 (bls24-315.go:113-115)
            self.b_twist = ((0, 0), (0, pow(13, -1, p)))
            self.twist_type = "D"
        elif name == "bls24_317":
            self.tower = tower or get_tower24(name, device)
            self.family = "bls24"
            self.seed = 3640754176        # x0 > 0 (bls24-317.go:149)
            self.seed_neg = False
            self.loop = naf(self.seed)
            # M-twist: b' = b v = 4 v (bls24-317.go:99-101), as nested
            # (B0, B1) E4 coordinates over E2
            self.b_twist = ((0, 0), (4, 0))
            self.twist_type = "M"
        else:
            raise KeyError(name)
        e2 = self.tower.e2
        self._b_twist_dev = e2.from_int(self.b_twist)

    # -- coefficient-level helpers ------------------------------------------
    def _scale_e2(self, a, s):
        """Coefficient-level element (E2, or E4 for BLS24) scaled
        componentwise by an fp element (E2/E4.MulByElement)."""
        return _scale_ext_by_fp(self.tower, a, s)

    def _mul_b_twist(self, a):
        e2 = self.tower.e2
        return e2.mul(a, e2.broadcast_to(self._b_twist_dev, e2.eshape(a)))

    # -- projective steps (pairing.go:292 doubleStep, :333 addMixedStep) ----
    def double_step(self, q: G2Proj):
        e2 = self.tower.e2
        A = e2.halve(e2.mul(q.x, q.y))
        B = e2.square(q.y)
        C = e2.square(q.z)
        D = e2.add(e2.double(C), C)
        E = self._mul_b_twist(D)
        F = e2.add(e2.double(E), E)
        G = e2.halve(e2.add(B, F))
        H = e2.sub(e2.square(e2.add(q.y, q.z)), e2.add(B, C))
        I = e2.sub(E, B)
        J = e2.square(q.x)
        EE = e2.square(E)
        K = e2.add(e2.double(EE), EE)
        x3 = e2.mul(e2.sub(B, F), A)
        y3 = e2.sub(e2.square(G), K)
        z3 = e2.mul(B, H)
        # line: r0 = -H, r1 = 3J, r2 = I
        return G2Proj(x3, y3, z3), (e2.neg(H), e2.add(e2.double(J), J), I)

    def add_mixed_step(self, q: G2Proj, a_x, a_y):
        e2 = self.tower.e2
        O = e2.sub(q.y, e2.mul(a_y, q.z))
        L = e2.sub(q.x, e2.mul(a_x, q.z))
        C = e2.square(O)
        D = e2.square(L)
        E = e2.mul(L, D)
        F = e2.mul(q.z, C)
        G = e2.mul(q.x, D)
        H = e2.sub(e2.add(E, F), e2.double(G))
        x3 = e2.mul(L, H)
        y3 = e2.sub(e2.mul(e2.sub(G, H), O), e2.mul(q.y, E))
        z3 = e2.mul(E, q.z)
        J = e2.sub(e2.mul(a_x, O), e2.mul(L, a_y))
        # line: r0 = L, r1 = -O, r2 = J
        return G2Proj(x3, y3, z3), (L, e2.neg(O), J)

    def line_compute(self, q: G2Proj, a_x, a_y):
        e2 = self.tower.e2
        O = e2.sub(q.y, e2.mul(a_y, q.z))
        L = e2.sub(q.x, e2.mul(a_x, q.z))
        J = e2.sub(e2.mul(a_x, O), e2.mul(L, a_y))
        return (L, e2.neg(O), J)

    def line_prod(self, facc, line, px, py):
        """facc * line(P): the sparse MulBy034 (D-twist) / MulBy014
        (M-twist) of ``towers/tower12.py`` SparseLineMixin, at the E2 level
        for Tower12 and the E4 level for Tower24 (e24_pairing.go:35),
        bit-identical to the dense product. D-twist coefficients land at
        (0, 3, 4) as
        (r0*Py, r1*Px, r2); the M-twist swaps the roles of r0 and r2 and
        lands at (0, 1, 4) as (r2, r1*Px, r0*Py) (pairing.go:146-156)."""
        tw = self.tower
        r0, r1, r2 = line
        if self.twist_type == "D":
            return tw.mul_by_034(facc, self._scale_e2(r0, py),
                                 self._scale_e2(r1, px), r2)
        return tw.mul_by_014(facc, r2, self._scale_e2(r1, px),
                             self._scale_e2(r0, py))

    # -- psi (untwist-Frobenius) endomorphism constants ---------------------
    @functools.lru_cache(maxsize=None)
    def _psi_dev(self, i: int):
        """Constant for psi: gamma1[i] for a D-twist, gamma1[i]^-1 for an
        M-twist (reference endo.u/v, bls12-381.go:141-144 — the untwist map
        direction flips the sign of the xi exponent)."""
        tw = self.tower
        g = tw.g1[i]
        if self.twist_type == "M":
            g = _h2_inv(g, tw.p, tw.beta)
        return tw.e2.from_int(g)

    def psi_coords(self, qx, qy):
        """Q1 = pi(Q) coordinates (pairing.go:259-261; g2.go psi)."""
        e2 = self.tower.e2
        g12 = e2.broadcast_to(self._psi_dev(2), e2.eshape(qx))
        g13 = e2.broadcast_to(self._psi_dev(3), e2.eshape(qx))
        return (e2.mul(e2.conjugate(qx), g12),
                e2.mul(e2.conjugate(qy), g13))

    def psi2_coords(self, qx, qy):
        """-pi^2(Q) coordinates (pairing.go:263-265)."""
        tw, e2 = self.tower, self.tower.e2
        g22 = e2.broadcast_to(tw._gdev(2, 2), e2.eshape(qx))
        g23 = e2.broadcast_to(tw._gdev(2, 3), e2.eshape(qx))
        return (e2.mul(qx, g22), e2.neg(e2.mul(qy, g23)))


@functools.lru_cache(maxsize=None)
def _ctx(name: str, device: str) -> PairingCtx:
    return PairingCtx(name, device=device)


def get_ctx(name: str, device=DEFAULT_DEVICE) -> PairingCtx:
    """The pairing context of a BN/BLS12/BLS24 curve, its constants on
    device."""
    return _ctx(name, str(torch.device(device)))


def final_exponentiation(ctx: PairingCtx, z):
    """Full-group exponentiation to the unique r-th power residue class
    ((p^k-1)/r; pairing.go:52 FinalExponentiation)."""
    tw = ctx.tower
    e12 = tw.e12
    # easy part: (p^6 - 1)(p^2 + 1), for BLS24 (p^12 - 1)(p^4 + 1)
    # (bls24 pairing.go:64-69)
    t0 = tw.conjugate(z)
    zi = e12.inverse(z)
    t0 = e12.mul(t0, zi)
    if ctx.family == "bls24":
        r = e12.mul(tw.frobenius_quad(t0), t0)
        return _hard_part_bls24(ctx, r)
    r = e12.mul(tw.frobenius_square(t0), t0)
    if ctx.family == "bn":
        return _hard_part_bn(ctx, r)
    return _hard_part_bls12(ctx, r)


def _expt(ctx: PairingCtx, x):
    """x^|seed| in the cyclotomic subgroup (e12_pairing.go Expt)."""
    return ctx.tower.exp_cyclotomic(x, ctx.seed)


def _hard_part_bn(ctx: PairingCtx, result):
    """Fuentes et al. alg. 6 — exact sequence of pairing.go:79-105."""
    tw = ctx.tower
    e12 = tw.e12
    t0 = tw.conjugate(_expt(ctx, result))
    t0 = tw.cyclotomic_square(t0)
    t1 = tw.cyclotomic_square(t0)
    t1 = e12.mul(t0, t1)
    t2 = tw.conjugate(_expt(ctx, t1))
    t3 = tw.conjugate(t1)
    t1 = e12.mul(t2, t3)
    t3 = tw.cyclotomic_square(t2)
    t4 = _expt(ctx, t3)
    t4 = e12.mul(t1, t4)
    t3 = e12.mul(t0, t4)
    t0 = e12.mul(t2, t4)
    t0 = e12.mul(result, t0)
    t2 = tw.frobenius(t3)
    t0 = e12.mul(t2, t0)
    t2 = tw.frobenius_square(t4)
    t0 = e12.mul(t2, t0)
    t2 = tw.conjugate(result)
    t2 = e12.mul(t2, t3)
    t2 = tw.frobenius_cube(t2)
    return e12.mul(t2, t0)


def _hard_part_bls12(ctx: PairingCtx, result):
    """BLS12 hard part — Hayashida-Hayasaka-Teruya (eprint 2020/875);
    exact op sequence of bls12-381/pairing.go:76-96 (the reference's
    t1 = ExptHalf(result^2) there equals Expt(result), used uniformly here
    so odd seeds like bls12-377's work too)."""
    tw = ctx.tower
    e12 = tw.e12

    def expt_signed(x):
        # x^x0 including the seed sign (gnark Expt conjugates internally for
        # negative seeds, e12_pairing.go:36-38)
        y = _expt(ctx, x)
        return tw.conjugate(y) if ctx.seed_neg else y

    t0 = tw.cyclotomic_square(result)
    t1 = expt_signed(result)
    t2 = tw.conjugate(result)
    t1 = e12.mul(t1, t2)
    t2 = expt_signed(t1)
    t1 = tw.conjugate(t1)
    t1 = e12.mul(t1, t2)
    t2 = expt_signed(t1)
    t1 = tw.frobenius(t1)
    t1 = e12.mul(t1, t2)
    result = e12.mul(result, t0)
    t0 = expt_signed(t1)
    t2 = expt_signed(t0)
    t0 = tw.frobenius_square(t1)
    t1 = tw.conjugate(t1)
    t1 = e12.mul(t1, t2)
    t1 = e12.mul(t1, t0)
    return e12.mul(result, t1)


def _hard_part_bls24(ctx: PairingCtx, result):
    """BLS24 hard part, Hayashida-Hayasaka-Teruya (eprint 2020/875):
    3(p^8-p^4+1)/r = (x-1)^2 (x+p)(x^2+p^2)(x^4+p^4-1) + 3 (exact op
    sequence of bls24-315 pairing.go:77-105)."""
    tw = ctx.tower
    e24 = tw.e12

    def expt_signed(x):
        y = _expt(ctx, x)
        return tw.conjugate(y) if ctx.seed_neg else y

    t0 = tw.cyclotomic_square(result)
    t1 = expt_signed(result)
    t2 = tw.conjugate(result)
    t1 = e24.mul(t1, t2)
    t2 = expt_signed(t1)
    t1 = tw.conjugate(t1)
    t1 = e24.mul(t1, t2)
    t2 = expt_signed(t1)
    t1 = tw.frobenius(t1)
    t1 = e24.mul(t1, t2)
    result = e24.mul(result, t0)
    t0 = expt_signed(t1)
    t2 = expt_signed(t0)
    t0 = tw.frobenius_square(t1)
    t2 = e24.mul(t0, t2)
    t1 = expt_signed(t2)
    t1 = expt_signed(t1)
    t1 = expt_signed(t1)
    t1 = expt_signed(t1)
    t0 = tw.frobenius_quad(t2)
    t0 = e24.mul(t0, t1)
    t2 = tw.conjugate(t2)
    t0 = e24.mul(t0, t2)
    return e24.mul(result, t0)


def pair(name: str, P, QX, QY):
    """Reduced pairing prod_i e(P_i, Q_i) (reference Pair, pairing.go:26),
    as VM programs on the device of the inputs."""
    from gnark_crypto_tpu_torch.pairing.vm_pairing import pair_vm

    return pair_vm(name, P, QX, QY)


def pairing_check(name: str, P, QX, QY):
    """prod e(P_i, Q_i) == 1 (reference PairingCheck, pairing.go:38); a
    0-dim bool tensor."""
    e12 = get_ctx(name, P.x.device).tower.e12
    g = pair(name, P, QX, QY)
    return e12.equal(g, e12.ones())
