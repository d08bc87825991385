"""bls12-381 and bls12-377 KZG in the port, at n = 16, on the CPU.

The card runs these paths on the 12-word G1 and Fp2 kernels; here every
wrapper runs its plain version. Each piece is held against Python-int
oracles for a known secret alpha, and against the JAX package on the same
inputs:

* ``new_srs``: [alpha^i]G1 and [alpha]G2 (the G2 ladder over Fp2 with
  u^2 = -1 on bls12-381 and -5 on bls12-377) against the oracles;
* ``commit`` and ``open_poly`` on an SRS made from the oracle points: the
  port against [p(alpha)]G1, [q(alpha)]G1 and p(a), and the JAX package on
  the same SRS (carried across by ``convert``) against the same oracle
  points, so that the two packages agree as integers. A port MSM costs
  ~15 s here (the plain width-1 window fold) and a JAX bls12 MSM ~20 s of
  compile, so each package has its own test;
* ``_derive_gamma`` (the Fiat-Shamir challenge over compressed G1
  digests) and the point encoder (``PointCodec.to_bytes``, G1 and G2,
  raw and compressed) against the JAX package's;
* ``verify``: the two G1 inputs it hands to ``pairing_check`` (captured,
  as in ``tests/test_torch_kzg.py``) against ([p(a) - a q(alpha) -
  p(alpha)]G1, [q(alpha)]G1) from the oracle, and its verdicts. The full
  pairing runs on the card (``chip_smoke.py``); on the plain executor a
  bls12 pairing costs 86-117 s here.

Values cross as canonical integers; the tolerance is 0.
"""

import random

import pytest
import torch

from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, curve_ops
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.protocols import kzg
from gnark_crypto_tpu_torch.specs import curve as tcs
from tests.test_curve_g1 import oracle_mul
from tests.test_torch_g2_msm import oracle_mul as oracle_mul2

CPU = "cpu"
CURVES = ["bls12_381", "bls12_377"]
SIZE = 16
# a 64-bit secret: the [alpha]G2 ladder runs over alpha's own bits
ALPHA = random.Random(20261018).randrange(1 << 63, 1 << 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_bls12.py: the plain point
    versions are thousands of small tensor ops, and several test workers
    share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case:
    """One curve's oracle SRS, polynomial and opening point, as Python
    ints and as port tensors."""

    def __init__(self, name: str):
        self.name = name
        self.g1 = curve_ops(tcs.get_curve(f"{name}_g1"))
        self.g2 = g2_curve(name, CPU)
        spec = self.g1.spec
        self.p, self.r = spec.fp.modulus, spec.fr.modulus
        self.gen = (spec.gx, spec.gy)
        self.gen2 = (self.g2.spec.gx, self.g2.spec.gy)
        self.nr = self.g2.fp.nr
        rng = random.Random(name)
        self.coeffs = [rng.randrange(self.r) for _ in range(SIZE)]
        self.a = rng.randrange(self.r)
        self.srs_pts = [self.mul(pow(ALPHA, i, self.r)) for i in range(SIZE)]
        self.alpha_g2 = oracle_mul2(self.gen2, ALPHA, self.p, self.nr)
        self.p_alpha = horner(self.coeffs, ALPHA, self.r)
        self.y = horner(self.coeffs, self.a, self.r)
        self.q_alpha = ((self.p_alpha - self.y)
                        * pow(ALPHA - self.a, -1, self.r) % self.r)

    def mul(self, k: int):
        return oracle_mul(self.gen, k % self.r, self.p, 0)

    def fr(self, ks) -> torch.Tensor:
        return self.g1.fr.from_int([k % self.r for k in ks], mont=False,
                                   device=CPU)

    def g1_pts(self, pts) -> Affine:
        f = self.g1.fp
        return Affine(f.from_int([t[0] for t in pts], device=CPU),
                      f.from_int([t[1] for t in pts], device=CPU))

    def g1_ints(self, p: Affine):
        xs, ys = (tmont.to_int(self.g1.spec.fp, c) for c in p)
        return [None if x == 0 and y == 0 else (x, y)
                for x, y in zip(xs, ys)]

    def srs(self) -> kzg.SRS:
        """The SRS of the oracle points, as the port's types."""
        f2 = self.g2.fp
        g2 = Affine(f2.from_int([self.gen2[0]], device=CPU),
                    f2.from_int([self.gen2[1]], device=CPU))
        ag2 = Affine(f2.from_int([self.alpha_g2[0]], device=CPU),
                     f2.from_int([self.alpha_g2[1]], device=CPU))
        return kzg.SRS(kzg.ProvingKey(self.g1_pts(self.srs_pts)),
                       kzg.VerifyingKey(g2, ag2, self.g1_pts([self.gen])))

    def jax_pk(self):
        from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
        from gnark_crypto_tpu.protocols import kzg as jkzg

        return jkzg.ProvingKey(JAffine(*convert.point_to_jax(
            self.g1.spec.fp, self.g1_pts(self.srs_pts))))

    def jfr(self, ks):
        from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
        from gnark_crypto_tpu.specs import curve as jcs

        return jcurve_ops(jcs.get_curve(f"{self.name}_g1")).fr.from_int(
            [k % self.r for k in ks], mont=False)

    def jax_g1_ints(self, p):
        return self.g1_ints(convert.point_from_jax(self.g1.spec.fp, p,
                                                   device=CPU))


def horner(coeffs, x, r):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % r
    return acc


@pytest.fixture(scope="module", params=CURVES)
def case(request):
    return Case(request.param)


def test_bls12_new_srs_equals_alpha_oracle(case):
    srs = kzg.new_srs(case.name, SIZE, ALPHA, device=CPU)
    assert case.g1_ints(srs.pk.g1) == case.srs_pts
    got = [tuple(zip(*case.g2.fp.to_int(c)))[0] for c in srs.vk.alpha_g2]
    assert tuple(got) == case.alpha_g2
    got = [tuple(zip(*case.g2.fp.to_int(c)))[0] for c in srs.vk.g2]
    assert tuple(got) == case.gen2
    assert case.g1_ints(srs.vk.g1) == [case.gen]


def test_bls12_commit_equals_oracle(case):
    C = kzg.commit(case.name, case.srs().pk, case.fr(case.coeffs))
    assert case.g1_ints(C) == [case.mul(case.p_alpha)]


def test_bls12_open_poly_equals_oracle(case):
    proof = kzg.open_poly(case.name, case.srs().pk, case.fr(case.coeffs),
                          case.fr([case.a]))
    assert case.g1_ints(proof.h) == [case.mul(case.q_alpha)]
    assert tmont.to_int(case.g1.spec.fr, proof.claimed_value,
                        mont=False) == [case.y]


def test_bls12_jax_commit_equals_oracle(case):
    """The JAX package's commit on the same SRS gives the oracle's point,
    as the port's does."""
    from gnark_crypto_tpu.protocols import kzg as jkzg

    C = jkzg.commit(case.name, case.jax_pk(), case.jfr(case.coeffs))
    assert case.jax_g1_ints(C) == [case.mul(case.p_alpha)]


def test_bls12_jax_open_poly_equals_oracle(case):
    import numpy as np

    from gnark_crypto_tpu.field import mont as jmont
    from gnark_crypto_tpu.protocols import kzg as jkzg
    from gnark_crypto_tpu.specs import field as jfs

    proof = jkzg.open_poly(case.name, case.jax_pk(), case.jfr(case.coeffs),
                           case.jfr([case.a]))
    assert case.jax_g1_ints(proof.h) == [case.mul(case.q_alpha)]
    v = jmont.to_int(jfs.get_field(case.g1.spec.fr.name),
                     np.asarray(proof.claimed_value), mont=False)
    assert ([v] if isinstance(v, int) else v) == [case.y]


def test_bls12_derive_gamma_matches_jax(case):
    """The Fiat-Shamir challenge over three compressed G1 digests (one of
    them infinity) and three claimed values."""
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu.protocols import kzg as jkzg

    pts = case.srs_pts[:2] + [(0, 0)]
    digests = [case.g1_pts([t]) for t in pts]
    claimed = [5, case.r - 1, 0]
    got = kzg._derive_gamma(case.name, case.fr([case.a]), digests,
                            [case.fr([c]) for c in claimed], b"data")
    want = jkzg._derive_gamma(
        case.name, case.jfr([case.a]),
        [JAffine(*convert.point_to_jax(case.g1.spec.fp, d))
         for d in digests], [case.jfr([c]) for c in claimed], b"data")
    assert got == want
    assert got != kzg._derive_gamma(case.name, case.fr([case.a]),
                                    digests[:2], [case.fr([c])
                                                  for c in claimed])


def test_bls12_point_bytes_match_jax(case):
    """The compressed and raw encodings of bls12 G1 and G2 points (both
    lex flags, infinity) equal the JAX codec's byte for byte: bn254's
    2-bit flag layout, which the JAX package writes for every curve
    (ROADMAP.md queue 3). KZG's batch forms hash G1 digests this way."""
    from gnark_crypto_tpu.curve.g2 import g2_curve as jg2_curve
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
    from gnark_crypto_tpu.io.marshal import PointCodec as JCodec
    from gnark_crypto_tpu.specs import curve as jcs
    from gnark_crypto_tpu_torch.io.marshal import PointCodec

    p = case.p
    pts1 = [case.mul(k) for k in (1, 2, 3)]
    pts1 += [(pts1[0][0], -pts1[0][1] % p), (0, 0)]
    pts2 = [oracle_mul2(case.gen2, k, p, case.nr) for k in (1, 2)]
    pts2 += [(pts2[0][0], tuple(-c % p for c in pts2[0][1])),
             ((0, 0), (0, 0))]
    f2 = case.g2.fp
    P2 = Affine(f2.from_int([t[0] for t in pts2], device=CPU),
                f2.from_int([t[1] for t in pts2], device=CPU))
    flags = set()
    for curve, jcurve, P in (
            (case.g1, jcurve_ops(jcs.get_curve(f"{case.name}_g1")),
             case.g1_pts(pts1)),
            (case.g2, jg2_curve(case.name), P2)):
        jP = JAffine(*convert.point_to_jax(curve.spec.fp, P))
        for raw in (False, True):
            got = PointCodec(curve).to_bytes(P, raw=raw)
            assert got == JCodec(jcurve).to_bytes(jP, raw=raw)
            assert {len(b) for b in got} == {48 * (1 + raw) * (
                1 + (curve is case.g2))}
            flags |= {b[0] >> 6 for b in got}
    assert flags == {0b00, 0b01, 0b10, 0b11}


@pytest.mark.parametrize("tampered", [False, True],
                         ids=["honest", "claimed_plus_1"])
def test_bls12_verify_pairing_inputs_equal_oracle(case, tampered,
                                                  monkeypatch):
    """verify hands pairing_check the G1 pair ([y]G1 - [a]H - C, H) and
    the G2 pair (G2, [alpha]G2): for the honest opening T == [-alpha]H,
    which the captured check answers True; with the claimed value + 1,
    False. One verify per test: its width-1 ladder costs ~20 s here."""
    seen = []
    r = case.r

    def check(name, P, qx, qy):
        T, H = case.g1_ints(P)
        seen.append((T, H))
        got_q = [tuple(zip(*case.g2.fp.to_int(c))) for c in (qx, qy)]
        assert list(zip(*got_q)) == [case.gen2, case.alpha_g2]
        return torch.tensor(T == oracle_mul(H, (-ALPHA) % r, case.p, 0))

    monkeypatch.setattr(kzg.pairing_api, "pairing_check", check)
    y = case.y + int(tampered)
    C = case.g1_pts([case.mul(case.p_alpha)])
    H_int = case.mul(case.q_alpha)
    ok = kzg.verify(case.name, C, kzg.OpeningProof(
        case.g1_pts([H_int]), case.fr([y])), case.fr([case.a]),
        case.srs().vk)
    assert bool(ok) is not tampered
    assert seen == [(case.mul(y - case.a * case.q_alpha - case.p_alpha),
                     H_int)]
