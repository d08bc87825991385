"""The port's bn254 KZG slice on the CPU, against the JAX package and the
alpha oracle.

An SRS of 16 from a known secret alpha is made once for the module. The
pieces are held against the JAX package on the same seeded inputs, as
canonical integers or gnark bytes (tolerance 0): ``eval_poly``, the
division core ``_open_div_fn``, ``commit``, the compressed and raw point
codec for G1 and G2, and the Fiat-Shamir ``_derive_gamma``. The SRS
points are held against [alpha^i]G1 and [alpha]G2 from Python-int
oracles.

Two checks run a pairing on the plain VM executor (about a minute each
on a CPU): ``verify`` and ``batch_verify_multi_points``, both True. The other
verdicts are held without a pairing: alpha is known, so the check
e(T, G2) e(H, [alpha]G2) == 1 that ``pairing_check`` receives as the G1
pair (T, H) holds exactly when T == [-alpha]H in G1. The pair is captured
by replacing ``pairing_check``.
"""

import random

import pytest
import torch

from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, curve_ops
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.io.marshal import PointCodec
from gnark_crypto_tpu_torch.protocols import kzg
from gnark_crypto_tpu_torch.specs import curve as tcs
from tests.test_curve_g1 import oracle_mul
from tests.test_torch_g2_msm import oracle_mul as oracle_mul2

NAME = "bn254"
CPU = "cpu"
SIZE = 16
G1 = curve_ops(tcs.get_curve(f"{NAME}_g1"))
P_MOD, R_MOD = G1.spec.fp.modulus, G1.spec.fr.modulus
GEN = (G1.spec.gx, G1.spec.gy)
ALPHA = random.Random(20261017).randrange(1 << 64)


def fr(ks) -> torch.Tensor:
    return G1.fr.from_int([k % R_MOD for k in ks], mont=False, device=CPU)


def fr_ints(t) -> list[int]:
    return tmont.to_int(G1.spec.fr, t, mont=False)


def g1_ints(p: Affine):
    xs, ys = (tmont.to_int(G1.spec.fp, c) for c in p)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R_MOD
    return acc


@pytest.fixture(scope="module")
def setup():
    rng = random.Random(3)
    srs = kzg.new_srs(NAME, SIZE, ALPHA, device=CPU)
    coeffs = [rng.randrange(R_MOD) for _ in range(SIZE)]
    a = rng.randrange(R_MOD)
    poly, point = fr(coeffs), fr([a])
    C = kzg.commit(NAME, srs.pk, poly)
    proof = kzg.open_poly(NAME, srs.pk, poly, point)
    return dict(srs=srs, coeffs=coeffs, a=a, poly=poly, point=point, C=C,
                proof=proof)


def to_jax_g1(p: Affine):
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu_torch import convert

    return JAffine(*convert.point_to_jax(G1.spec.fp, p))


def jfr(ks):
    from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
    from gnark_crypto_tpu.specs import curve as jcs

    return jcurve_ops(jcs.get_curve(f"{NAME}_g1")).fr.from_int(
        [k % R_MOD for k in ks], mont=False)


def jfr_ints(a) -> list[int]:
    import numpy as np

    from gnark_crypto_tpu.field import mont as jmont
    from gnark_crypto_tpu.specs import field as jfs

    v = jmont.to_int(jfs.get_field(G1.spec.fr.name), np.asarray(a),
                     mont=False)
    return [v] if isinstance(v, int) else v


def captured_check(monkeypatch):
    """Replace pairing_check: record the G1 pair (T, H) and answer
    T == [-alpha]H, which is the pairing check's verdict for a known
    alpha."""
    seen = []

    def check(name, P, qx, qy):
        T, H = g1_ints(P)
        seen.append((T, H))
        return torch.tensor(T == oracle_mul(H, (-ALPHA) % R_MOD, P_MOD, 0))

    monkeypatch.setattr(kzg.pairing_api, "pairing_check", check)
    return seen


# -- the SRS and the division, against the oracles and JAX ------------------

def test_srs_points_equal_alpha_powers(setup):
    srs = setup["srs"]
    assert g1_ints(srs.pk.g1) == [
        oracle_mul(GEN, pow(ALPHA, i, R_MOD), P_MOD, 0) for i in range(SIZE)]
    g2 = g2_curve(NAME, CPU)
    want = oracle_mul2((g2.spec.gx, g2.spec.gy), ALPHA, P_MOD, -1)
    got = [tuple(zip(*g2.fp.to_int(c))) for c in srs.vk.alpha_g2]
    assert (got[0][0], got[1][0]) == want
    assert g1_ints(srs.vk.g1) == [GEN]


def test_eval_and_open_division_match_jax(setup):
    from gnark_crypto_tpu.protocols import kzg as jkzg

    coeffs, a = setup["coeffs"], setup["a"]
    y = horner(coeffs, a)
    assert fr_ints(kzg.eval_poly(NAME, setup["poly"], setup["point"])) == [y]
    assert jfr_ints(jkzg.eval_poly(NAME, jfr(coeffs), jfr([a]))) == [y]
    for pt in (a, 0):     # a = 0 takes the shift path
        q, claimed = kzg._open_div_fn(NAME)(setup["poly"], fr([pt]))
        jq, jclaimed = jkzg._open_div_fn(NAME)(jfr(coeffs), jfr([pt]))
        assert fr_ints(q) == jfr_ints(jq)
        assert fr_ints(claimed) == jfr_ints(jclaimed) == [horner(coeffs,
                                                                  pt)]
    assert fr_ints(setup["proof"].claimed_value) == [y]


def test_commit_and_open_match_jax_and_oracle(setup):
    from gnark_crypto_tpu.protocols import kzg as jkzg
    from gnark_crypto_tpu_torch import convert

    coeffs, a = setup["coeffs"], setup["a"]
    p_alpha, y = horner(coeffs, ALPHA), horner(coeffs, a)
    assert g1_ints(setup["C"]) == [oracle_mul(GEN, p_alpha, P_MOD, 0)]
    q_alpha = (p_alpha - y) * pow(ALPHA - a, -1, R_MOD) % R_MOD
    assert g1_ints(setup["proof"].h) == [oracle_mul(GEN, q_alpha, P_MOD, 0)]
    jpk = jkzg.ProvingKey(to_jax_g1(setup["srs"].pk.g1))
    want = jkzg.commit(NAME, jpk, jfr(coeffs))
    assert all(torch.equal(u, convert.from_jax_limbs(G1.spec.fp, w,
                                                     device=CPU))
               for u, w in zip(setup["C"], want))


# -- bytes and the Fiat-Shamir challenge -----------------------------------

def test_point_bytes_match_jax():
    """Compressed and raw encodings of G1 and G2 points (both lex flags,
    infinity) equal the JAX codec's byte for byte."""
    from gnark_crypto_tpu.curve.g2 import g2_curve as jg2_curve
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
    from gnark_crypto_tpu.io.marshal import PointCodec as JCodec
    from gnark_crypto_tpu.specs import curve as jcs
    from gnark_crypto_tpu_torch import convert

    g2 = g2_curve(NAME, CPU)
    pts1 = [oracle_mul(GEN, k, P_MOD, 0) for k in (1, 2, 3, 5)]
    pts1.append((pts1[0][0], -pts1[0][1] % P_MOD))
    P1 = Affine(G1.fp.from_int([t[0] for t in pts1] + [0], device=CPU),
                G1.fp.from_int([t[1] for t in pts1] + [0], device=CPU))
    g2gen = (g2.spec.gx, g2.spec.gy)
    pts2 = [oracle_mul2(g2gen, k, P_MOD, -1) for k in (1, 2, 3)]
    pts2.append((pts2[0][0], tuple(-c % P_MOD for c in pts2[0][1])))
    P2 = Affine(g2.fp.from_int([t[0] for t in pts2] + [(0, 0)], device=CPU),
                g2.fp.from_int([t[1] for t in pts2] + [(0, 0)], device=CPU))
    flags = set()
    for curve, jcurve, P in (
            (G1, jcurve_ops(jcs.get_curve(f"{NAME}_g1")), P1),
            (g2, jg2_curve(NAME), P2)):
        jP = JAffine(*convert.point_to_jax(curve.spec.fp, P))
        for raw in (False, True):
            got = PointCodec(curve).to_bytes(P, raw=raw)
            assert got == JCodec(jcurve).to_bytes(jP, raw=raw)
            flags |= {b[0] >> 6 for b in got}
    assert flags == {0b00, 0b01, 0b10, 0b11}
    with pytest.raises(NotImplementedError):
        PointCodec(G1).from_bytes(PointCodec(G1).to_bytes(P1))


def test_derive_gamma_matches_jax(setup):
    from gnark_crypto_tpu.protocols import kzg as jkzg

    digests = [setup["C"], setup["proof"].h, setup["srs"].vk.g1]
    claimed = [fr([5]), fr([R_MOD - 1]), fr([0])]
    point = setup["point"]
    got = kzg._derive_gamma(NAME, point, digests, claimed, b"data")
    want = jkzg._derive_gamma(NAME, jfr([setup["a"]]),
                              [to_jax_g1(d) for d in digests],
                              [jfr(fr_ints(c)) for c in claimed], b"data")
    assert got == want
    assert got != kzg._derive_gamma(NAME, point, digests[:2], claimed)


# -- the slice as a whole -------------------------------------------------------

def test_open_verify_round_trip(setup):
    """One plain-executor pairing: the honest opening verifies."""
    assert bool(kzg.verify(NAME, setup["C"], setup["proof"], setup["point"],
                           setup["srs"].vk))


def test_verify_rejects_tampered_opening(setup, monkeypatch):
    seen = captured_check(monkeypatch)
    srs, proof, point = setup["srs"], setup["proof"], setup["point"]
    assert bool(kzg.verify(NAME, setup["C"], proof, point, srs.vk))
    bad_value = kzg.OpeningProof(proof.h, fr([fr_ints(
        proof.claimed_value)[0] + 1]))
    assert not bool(kzg.verify(NAME, setup["C"], bad_value, point, srs.vk))
    assert len(seen) == 2
    with pytest.raises(NotImplementedError):
        srs.vk.with_lines(NAME)


def test_batch_open_single_point_and_verify(setup, monkeypatch):
    seen = captured_check(monkeypatch)
    srs, point = setup["srs"], setup["point"]
    rng = random.Random(4)
    coeffs = [setup["coeffs"]] + [[rng.randrange(R_MOD) for _ in range(SIZE)]
                                  for _ in range(2)]
    polys = torch.stack([fr(c) for c in coeffs])
    digests = [setup["C"]] + [kzg.commit(NAME, srs.pk, polys[i])
                              for i in (1, 2)]
    bp = kzg.batch_open_single_point(NAME, srs.pk, polys, point, digests)
    assert fr_ints(bp.claimed_values) == [horner(c, setup["a"])
                                          for c in coeffs]
    assert bool(kzg.batch_verify_single_point(NAME, digests, bp, point,
                                              srs.vk))
    swapped = [digests[1], digests[0], digests[2]]
    assert not bool(kzg.batch_verify_single_point(NAME, swapped, bp, point,
                                                  srs.vk))
    assert len(seen) == 2


@pytest.fixture(scope="module")
def multi(setup):
    """Three openings at distinct points: the module's, and two more."""
    srs = setup["srs"]
    rng = random.Random(5)
    polys = [setup["poly"]] + [fr([rng.randrange(R_MOD) for _ in range(SIZE)])
                               for _ in range(2)]
    points = [setup["point"], fr([rng.randrange(R_MOD)]), 7]
    digests = [setup["C"]] + [kzg.commit(NAME, srs.pk, p) for p in polys[1:]]
    proofs = [setup["proof"]] + [
        kzg.open_poly(NAME, srs.pk, p, x if not isinstance(x, int)
                      else fr([x])) for p, x in zip(polys[1:], points[1:])]
    return digests, proofs, points, [1, 0x1234567, R_MOD - 2]


def test_batch_verify_multi_points_round_trip(setup, multi):
    """The second plain-executor pairing: honest openings verify."""
    digests, proofs, points, lambdas = multi
    assert bool(kzg.batch_verify_multi_points(NAME, digests, proofs, points,
                                              setup["srs"].vk, lambdas))


def test_batch_verify_multi_points_rejects(setup, multi, monkeypatch):
    seen = captured_check(monkeypatch)
    vk = setup["srs"].vk
    digests, proofs, points, lambdas = multi
    tampered = list(proofs)
    tampered[2] = kzg.OpeningProof(proofs[1].h, proofs[2].claimed_value)
    assert not bool(kzg.batch_verify_multi_points(
        NAME, digests, tampered, points, vk, lambdas))
    assert bool(kzg.batch_verify_multi_points(
        NAME, digests[:1], proofs[:1], [setup["a"]], vk))
    with pytest.raises(ValueError):
        kzg.batch_verify_multi_points(NAME, digests, proofs[:2], points, vk)
    assert len(seen) == 2
