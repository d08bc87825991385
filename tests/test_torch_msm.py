"""The port's G1 MSM against the JAX package and Python-int oracles.

Seeded points and scalars go to both packages through
``gnark_crypto_tpu_torch.convert`` (scalars as plain Fr words). MSM
results are compared as affine integers; at n = 16 and 64 the stable key
sort makes the port take the JAX package's lanes in the same order, so its
Jacobian result is also asked to equal JAX's coordinate by coordinate. At
n = 256 with c = 5 the 13,056 lanes exceed ``BOT_W``, so phase 1 (the
batch-affine levels) runs; smaller inputs go straight to phase 2. The
tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.msm import pippenger as jpp
from gnark_crypto_tpu.specs import curve as jcs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.field import point_add
from gnark_crypto_tpu_torch.msm import pippenger as tpp
from gnark_crypto_tpu_torch.specs import curve as tcs
from tests.test_curve_g1 import oracle_add, oracle_mul, rand_points

CPU = "cpu"
NAME = "bn254_g1"
TSPEC, JSPEC = tcs.get_curve(NAME), jcs.get_curve(NAME)
TC, JC = curve_ops(TSPEC), jcurve_ops(JSPEC)
P_MOD, R_MOD = TSPEC.fp.modulus, TSPEC.fr.modulus


def to_port(pts) -> Affine:
    f = TC.fp
    return Affine(
        f.from_int([0 if p is None else p[0] for p in pts], device=CPU),
        f.from_int([0 if p is None else p[1] for p in pts], device=CPU))


def scalars(ks) -> torch.Tensor:
    return TC.fr.from_int(ks, mont=False, device=CPU)


def affine_of(curve, p: Jac):
    """A port Jacobian point (any batch shape) -> list of affine ints."""
    a = curve.to_affine(Jac(*(c.reshape(-1, c.shape[-1]) for c in p)))
    xs = tmont.to_int(curve.spec.fp, a.x)
    ys = tmont.to_int(curve.spec.fp, a.y)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def oracle_msm(pts, ks, p=P_MOD, a=0):
    acc = None
    for pt, k in zip(pts, ks):
        if pt is not None:
            acc = oracle_add(acc, oracle_mul(pt, k, p, a), p, a)
    return acc


def msm_case(n, seed):
    """n random points and scalars with a zero scalar and an infinite
    point (tests/test_msm.py:34-45)."""
    pts = rand_points(TC, n, seed=n)
    rng = random.Random(seed)
    ks = [rng.randrange(R_MOD) for _ in range(n)]
    ks[0] = 0
    pts[1] = None
    return pts, ks


@pytest.mark.parametrize("c", [3, 8, 11, 13, 16])
def test_signed_digits_match_jax(c):
    rng = random.Random(5)
    vals = [0, 1, R_MOD - 1] + [rng.randrange(R_MOD) for _ in range(13)]
    mags, negs = tpp.signed_digits(TC, scalars(vals), c)
    jm, jn = jpp.signed_digits(JC, JC.fr.from_int(vals, mont=False), c)
    assert mags.dtype == torch.int32
    assert mags.tolist() == np.asarray(jm).tolist()
    assert negs.tolist() == np.asarray(jn).tolist()
    assert mags.shape[0] == tpp.n_windows(R_MOD.bit_length(), c)
    for i, v in enumerate(vals):
        acc = sum((-int(mags[w, i]) if negs[w, i] else int(mags[w, i]))
                  << (c * w) for w in range(mags.shape[0]))
        assert acc == v


@pytest.mark.parametrize("n,c", [(16, 3), (64, None)])
def test_msm_matches_jax(n, c):
    pts, ks = msm_case(n, n + 1)
    P = to_port(pts)
    got = tpp.msm(TSPEC, P, scalars(ks), c=c)
    jP = JAffine(*convert.point_to_jax(TSPEC.fp, P))
    want = jpp.msm(JSPEC, jP, JC.fr.from_int(ks, mont=False), c=c)
    jfp = JSPEC.fp
    for gc, wc in zip(got, want):
        assert tmont.to_int(TSPEC.fp, gc) == jmont.to_int(jfp, wc)
    assert affine_of(TC, got) == [oracle_msm(pts, ks)]


def test_msm_phase1_vs_oracle(monkeypatch):
    """n = 256, c = 5: 51 windows x 256 points = 13,056 lanes, two
    batch-affine levels before phase 2; a duplicate point forces doubling
    lanes inside runs."""
    calls = []
    prep = point_add.affine_prep

    def counting_prep(*args):
        calls.append(args[2].shape[0])
        return prep(*args)

    monkeypatch.setattr(point_add, "affine_prep", counting_prep)
    wrappers = (point_add.jac_add, point_add.jac_double, prep,
                point_add.affine_finish, point_add.jac_fold_windows)
    before = [w.launches for w in wrappers]
    pts, ks = msm_case(256, 78)
    pts[5] = pts[6]
    ks[7] = ks[9] = 12345       # equal digits in every window
    got = tpp.msm(TSPEC, to_port(pts), scalars(ks), c=5)
    assert calls == [6528, 3264]
    assert affine_of(TC, got) == [oracle_msm(pts, ks)]
    # CPU tensors take the plain versions: no kernel launch is counted
    assert [w.launches for w in wrappers] == before


def test_batch_scalar_mul_vs_oracle():
    g = (TSPEC.gx, TSPEC.gy)
    rng = random.Random(9)
    ks = [0, 1, 2, R_MOD - 1] + [rng.randrange(R_MOD) for _ in range(4)]
    base = Affine(*(c[0] for c in to_port([g])))
    got = tpp.batch_scalar_mul(TSPEC, base, scalars(ks))
    assert affine_of(TC, got) == [oracle_mul(g, k, P_MOD, 0) for k in ks]


def test_fold_and_naive_vs_oracle():
    pts = rand_points(TC, 4, seed=4)
    coeff = 7 ** 40 % R_MOD
    ks = [pow(coeff, i, R_MOD) for i in range(4)]
    want = [oracle_msm(pts, ks)]
    assert affine_of(TC, tpp.fold(TSPEC, to_port(pts), coeff)) == want
    small = [3, 5, 0, 11]
    assert affine_of(TC, tpp.msm_naive(TSPEC, to_port(pts[:2] + [None] * 2),
                                       scalars(small))) == \
        [oracle_msm(pts[:2], small[:2])]


def test_log_batch_inverse_and_windows():
    f = TC.fp
    rng = random.Random(1)
    vals = [1, P_MOD - 1] + [rng.randrange(1, P_MOD) for _ in range(300)]
    x = f.from_int(vals, device=CPU)
    assert f.to_int(tpp._log_batch_inverse(f, x)) == [
        pow(v, -1, P_MOD) for v in vals]
    assert [tpp.best_c(1 << k) for k in (5, 8, 12, 16, 20, 24)] == [
        jpp.best_c(1 << k) for k in (5, 8, 12, 16, 20, 24)]
    for c in range(2, 17):
        assert tpp.n_windows(254, c) == jpp.n_windows(254, c)


def test_strided_scan_and_window_totals_vs_oracle():
    """_strided_scan_add (tree and suffix) and _window_totals against
    per-window sums of Python-int points (tests/test_msm_internals.py)."""
    nwin, S = 3, 8
    pts = rand_points(TC, nwin * S - 2, 34) + [None, None]
    random.Random(4).shuffle(pts)
    P = TC.from_affine(to_port(pts))
    tree = affine_of(TC, tpp._strided_scan_add(TC, P, S, suffix=False))
    suf = affine_of(TC, tpp._strided_scan_add(TC, P, S, suffix=True))
    for w in range(nwin):
        assert tree[w * S] == oracle_msm(pts[w * S:(w + 1) * S], [1] * S)
        for k in (0, 3, S - 1):
            assert suf[w * S + k] == oracle_msm(pts[w * S + k:(w + 1) * S],
                                                [1] * (S - k))

    n, c, nwin = 13, 4, 2
    half = 1 << (c - 1)
    pts = rand_points(TC, n, 35)
    rng = np.random.default_rng(6)
    mags = rng.integers(0, half + 1, size=(nwin, n)).astype(np.int32)
    negs = rng.integers(0, 2, size=(nwin, n)).astype(bool)
    totals = tpp._window_totals(TC, to_port(pts), torch.from_numpy(mags),
                                torch.from_numpy(negs), c)
    got = affine_of(TC, totals)
    for w in range(nwin):
        ks = [int(m) * (-1 if s else 1) % R_MOD
              for m, s in zip(mags[w], negs[w])]
        assert got[w] == oracle_msm(pts, ks)
