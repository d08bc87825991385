"""BW6 optimal ate pairing (Fp6 target group, G2 over Fp), batched over pairs.

Counterpart of ``gnark_crypto_tpu/pairing/pairing6.py`` (reference
``ecc/bw6-761/pairing.go``, ``ecc/bw6-633/pairing.go``): the single Miller
loop of eprint 2021/1359 Alg. 2, f_{x+1 + lambda(x^3-x^2-x), Q}(P), driven
by two joint NAF digit rows, with the third-root-of-unity endomorphism
giving the lambda component (q1 = (w X, -Y)); the final exponentiation by
Algorithm 4.4 (bw6-761) or 4.5 (bw6-633) of El Housni's thesis
(pairing.go:62-130). BW6's twist is over Fp itself, so the steps run on
the fp engine and the lines are sparse E6 elements.

:func:`pair` runs the whole pairing as VM programs
(``pairing/vm_pairing.py``): the formulas here are run over the symbolic
tower to assemble the programs, and the programs run on the VM kernel
(``field/vm.py``), at 24 words for bw6-761 and 20 for bw6-633. The VM is
the port's one pairing tier on every device; the reference's eager step
ladder (``miller_loop``) is not ported, and its fixed-Q functions
(``precompute_lines6`` and the rest) wait for ``pairing/lines.py``
(ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.pairing.pairing12 import naf
from gnark_crypto_tpu_torch.towers.tower6 import get_tower6


class G2ProjFp(NamedTuple):
    x: object
    y: object
    z: object


_W633 = 4098895725012429242072311240482566844345873033931481129362557724405008256668293241245050359832461015092695507587185678086043587575438449040313411246717257958467499181450742260777082884928318

_PARAMS = {
    "bw6_761": dict(
        x0=9586122913090633729,  # bw6-761.go:136 xGen
        third_root=1968985824090209297278610739700577151397666382303825728450741611566800370218827257750865013421937292370006175842381275743914023380727582819905021229583192207421122272650305267822868639090213645505120388400344940985710520836292650,
        b_twist=4,  # bw6-761.go:101
        # joint digits: a0 = x0+1 (row scaled by 1), a1 = x0^3-x0^2-x0
        # (row scaled by 3); start from q1, last step j=-3 -> q1Neg
        a0=9586122913090633730, a1=880904806456922042166256752416502360955572640081583800319,
        a1_scaled=True, start_q1=True, i0=("q1n",), conj_end=False,
        # hard-part exponents (Algorithm 4.4; x0 > 0)
        exps=dict(m1=9586122913090633728, m1sq=9586122913090633728 ** 2,
                  p1=9586122913090633730, div3=3195374304363544576,
                  c1=11, c2=103, alg="4.4"),
    ),
    "bw6_633": dict(
        x0=-3218079743,  # bw6-633.go:127 xGen ("negative")
        third_root=(_W633 * _W633),  # thirdRootOneG2 = w^2 (bw6-633.go:119)
        b_twist=8,  # bw6-633.go:90 (M-twist)
        # |x0+1| row scaled by 3, |x0^5-x0^4-x0| row scaled by 1; start
        # from q0, final conjugation (negative seed), last step j=1 -> q0
        a0=3218079742, a1=345131030376204096837580131803633448876874137601,
        a1_scaled=False, start_q1=False, i0=("q0",), conj_end=True,
        exps=dict(m1=-3218079744, m1sq=3218079744 ** 2,
                  p1=-3218079742, div3=-1072693248,
                  sq_p1=3218079743 ** 2 + 1,
                  c1=-3, c2=13, alg="4.5"),
    ),
}


class PairingCtx6:
    """Per-curve BW6 pairing context: loop digits, twist constant, steps."""

    def __init__(self, name: str, tower=None, device=DEFAULT_DEVICE):
        """``tower``: inject an alternative Tower6 (the symbolic
        program-emitting SymTower6) in place of the word-tensor one on
        ``device``."""
        par = _PARAMS[name]
        self.name = name
        self.tower = tower or get_tower6(name, device)
        self.fp = self.tower.fp
        self.x0 = par["x0"]
        self.third_root = par["third_root"]
        self._w_dev = self.fp.from_int(self.third_root, device=device)
        self._b_twist = par["b_twist"]
        self._b_twist_dev = self.fp.from_int(self._b_twist, device=device)
        self.par = par
        # digit rows, LSB-first NAF of the two loop scalars (bw6-761.go:102,
        # 118 / bw6-633.go:106,110); the MSB of the longer row is consumed
        # by the starting point (q1 for bw6-761, q0 for bw6-633)
        self.l0 = naf(par["a0"])
        self.l1 = naf(par["a1"])
        self.nbits = len(self.l1) - 1  # iterate i = nbits-1 .. 0

    def _dig(self, i: int) -> int:
        d0 = self.l0[i] if i < len(self.l0) else 0
        d1 = self.l1[i]
        # bw6-761: j = 3*L1 + L0 (pairing.go:216); bw6-633: j = 3*L0 + L1
        # (pairing.go:210)
        return (3 * d1 + d0) if self.par["a1_scaled"] else (3 * d0 + d1)

    # -- projective steps over fp (pairing.go:277,318,355) ------------------
    def double_step(self, q: G2ProjFp):
        f = self.fp
        A = f.halve(f.mul(q.x, q.y))
        B = f.square(q.y)
        C = f.square(q.z)
        D = f.add(f.double(C), C)
        E = f.mul(D, f.broadcast_to(self._b_twist_dev, f.eshape(D)))
        F = f.add(f.double(E), E)
        G = f.halve(f.add(B, F))
        H = f.sub(f.square(f.add(q.y, q.z)), f.add(B, C))
        I = f.sub(E, B)
        J = f.square(q.x)
        EE = f.square(E)
        K = f.add(f.double(EE), EE)
        x3 = f.mul(f.sub(B, F), A)
        y3 = f.sub(f.square(G), K)
        z3 = f.mul(B, H)
        # line (r0, r1, r2) = (I, 3J, -H)  [pairing.go:310-313]
        return G2ProjFp(x3, y3, z3), (I, f.add(f.double(J), J), f.neg(H))

    def add_mixed_step(self, q: G2ProjFp, a_x, a_y):
        f = self.fp
        O = f.sub(q.y, f.mul(a_y, q.z))
        L = f.sub(q.x, f.mul(a_x, q.z))
        C = f.square(O)
        D = f.square(L)
        E = f.mul(L, D)
        F = f.mul(q.z, C)
        G = f.mul(q.x, D)
        H = f.sub(f.add(E, F), f.double(G))
        x3 = f.mul(L, H)
        y3 = f.sub(f.mul(f.sub(G, H), O), f.mul(q.y, E))
        z3 = f.mul(E, q.z)
        J = f.sub(f.mul(a_x, O), f.mul(L, a_y))
        # line (r0, r1, r2) = (J, -O, L)  [pairing.go:348-350]
        return G2ProjFp(x3, y3, z3), (J, f.neg(O), L)

    def line_compute(self, q: G2ProjFp, a_x, a_y):
        f = self.fp
        O = f.sub(q.y, f.mul(a_y, q.z))
        L = f.sub(q.x, f.mul(a_x, q.z))
        J = f.sub(f.mul(a_x, O), f.mul(L, a_y))
        return (J, f.neg(O), L)

    # -- line -> E6 (positions 0, 1, 4: pairing.go:182-184 MulBy014) --------
    def line_value(self, line, px, py):
        """The sparse E6 element (r0, r1 px, 0, 0, r2 py, 0). The
        reference's eager form also selects 1 on infinite lanes; the VM
        programs mask whole lanes instead (``vm_pairing._mask_gt``)."""
        f = self.fp
        r0, r1, r2 = line
        zero = f.zeros(f.eshape(r0))
        return self.tower.from_coeffs6([r0, f.mul(r1, px), zero,
                                        zero, f.mul(r2, py), zero])


@functools.lru_cache(maxsize=None)
def _ctx6(name: str, device: str) -> PairingCtx6:
    return PairingCtx6(name, device=device)


def get_ctx6(name: str, device=DEFAULT_DEVICE) -> PairingCtx6:
    """The pairing context of a BW6 curve, its constants on device."""
    return _ctx6(name, str(torch.device(device)))


def final_exponentiation(ctx: PairingCtx6, z):
    """(p^6-1)/r via the easy part and the hard part: Algorithm 4.4
    (bw6-761, pairing.go:62-122) or 4.5 (bw6-633) of El Housni's thesis.
    Signed exponents use conjugation (the cyclotomic inverse)."""
    tw, e6 = ctx.tower, ctx.tower.e6
    E = ctx.par["exps"]

    def exp(x, e):
        if e < 0:
            return tw.conjugate(tw.exp_cyclotomic(x, -e))
        return tw.exp_cyclotomic(x, e)

    # easy part: (p^3 - 1)(p + 1)
    buf = tw.conjugate(z)
    res = e6.inverse(z)
    buf = e6.mul(buf, res)
    res = e6.mul(tw.frobenius(buf), buf)

    if E["alg"] == "4.4":
        a = e6.mul(exp(res, E["m1sq"]), tw.frobenius(res))
        b = e6.mul(exp(a, E["p1"]), tw.conjugate(res))
        a = e6.mul(a, tw.cyclotomic_square(a))            # a^3
        c = exp(b, E["div3"])
        d = exp(c, E["m1"])
        e = e6.mul(exp(d, E["m1sq"]), d)
        d = tw.conjugate(d)
        f_ = e6.mul(d, b)
        g = e6.mul(exp(e, E["p1"]), f_)
        h = e6.mul(g, c)
        i = exp(e6.mul(g, d), E["p1"])
        i = e6.mul(i, tw.conjugate(f_))
        j = e6.mul(exp(h, E["c1"]), e)
        k = e6.mul(e6.mul(tw.cyclotomic_square(j), j), b)
        k = e6.mul(k, exp(i, E["c2"]))
        return e6.mul(a, k)

    # Algorithm 4.5 (bw6-633 pairing.go:62-130)
    mp = tw.frobenius(res)
    a = exp(exp(mp, E["m1sq"]), E["sq_p1"])
    a = e6.mul(res, a)
    b = e6.mul(exp(a, E["p1"]), tw.conjugate(mp))
    t = e6.mul(tw.cyclotomic_square(a), a)
    a = tw.conjugate(t)                                   # (a^3)^-1
    c = exp(b, E["div3"])
    d = exp(exp(c, E["m1"]), E["sq_p1"])
    e = e6.mul(exp(exp(d, E["m1sq"]), E["sq_p1"]), d)
    f_ = e6.mul(tw.conjugate(e6.mul(exp(e, E["p1"]), c)), d)
    g = tw.conjugate(e6.mul(f_, d))
    h = e6.mul(e6.mul(exp(g, E["p1"]), c), b)
    i = e6.mul(exp(f_, E["c1"]), e)
    t = e6.mul(e6.mul(tw.cyclotomic_square(i), i), b)
    i = e6.mul(exp(h, E["c2"]), t)
    return e6.mul(a, i)


def pair(name: str, P, QX, QY):
    """Reduced pairing prod_i e(P_i, Q_i) (reference Pair, pairing.go:32),
    as VM programs on the device of the inputs. P: G1 ``Affine`` of (n, W);
    QX, QY: (n, W) G2 coordinates over Fp; returns the GT element
    (2, 3, W)."""
    from gnark_crypto_tpu_torch.pairing.vm_pairing import pair_vm

    return pair_vm(name, P, QX, QY)


def pairing_check(name: str, P, QX, QY):
    """prod e(P_i, Q_i) == 1 (reference PairingCheck); a 0-dim bool
    tensor."""
    e6 = get_ctx6(name, P.x.device).tower.e6
    g = pair(name, P, QX, QY)
    return e6.equal(g, e6.ones())
