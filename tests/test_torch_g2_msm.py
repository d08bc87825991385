"""The port's G2 (Fp2) point kernels, group law and MSM on the CPU.

* Each plain Fp2 kernel version (``field/point_add2.py``) against the JAX
  Pallas kernel of ``gnark_crypto_tpu/field/pallas/point_add2.py`` in
  interpret mode, with P = Q, P = -Q and infinity lanes: all five on
  bn254 (u^2 = -1), and the tree level on bls12-381 (12 words, u^2 = -1)
  and bls12-377 (12 words, u^2 = -5, the small-multiple path of the Fp2
  product). Outputs are compared as
  canonical integers: both packages run the same formulas in the same
  order, so Jacobian coordinates are compared as they are. One interpret
  call costs minutes on a CPU (XLA compiles the unrolled limb products),
  so each test makes one or two.
* G2 ``add``/``double`` (now on ``jac_add2``/``jac_double2``) against the
  composed Fp2 group law, coordinate by coordinate.
* G2 ``msm`` (straight to phase 2, and with phase 1 running) and
  ``batch_scalar_mul`` against a Python-int Fp2 oracle.
* At 12 words, the bls12 G2 the 12-word Fp2 kernels carry on the card:
  the plain ``jac_add2``/``jac_double2`` and a G2 ``msm`` of 2^4 points
  (phase 1 running) against the Python-int Fp2 oracle, on both curves.

Inputs are made from a seed; the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.field import point_add2
from gnark_crypto_tpu_torch.msm import pippenger as tpp

CPU = "cpu"
NR = {"bn254": -1, "bls12_381": -1, "bls12_377": -5}


# -- a Python-int oracle over Fp2 = Fp[u]/(u^2 - nr) -------------------------

def f2_mul(a, b, p, nr):
    return ((a[0] * b[0] + nr * a[1] * b[1]) % p,
            (a[0] * b[1] + a[1] * b[0]) % p)


def f2_inv(a, p, nr):
    ni = pow((a[0] * a[0] - nr * a[1] * a[1]) % p, -1, p)
    return a[0] * ni % p, -a[1] * ni % p


def oracle_add(P, Q, p, nr):
    """Affine G2 addition (a = 0); None is infinity."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2:
        if ((y1[0] + y2[0]) % p, (y1[1] + y2[1]) % p) == (0, 0):
            return None
        x1s = f2_mul(x1, x1, p, nr)
        num = (3 * x1s[0] % p, 3 * x1s[1] % p)
        den = (2 * y1[0] % p, 2 * y1[1] % p)
    else:
        num = ((y2[0] - y1[0]) % p, (y2[1] - y1[1]) % p)
        den = ((x2[0] - x1[0]) % p, (x2[1] - x1[1]) % p)
    lam = f2_mul(num, f2_inv(den, p, nr), p, nr)
    l2 = f2_mul(lam, lam, p, nr)
    x3 = ((l2[0] - x1[0] - x2[0]) % p, (l2[1] - x1[1] - x2[1]) % p)
    t = f2_mul(lam, ((x1[0] - x3[0]) % p, (x1[1] - x3[1]) % p), p, nr)
    return x3, ((t[0] - y1[0]) % p, (t[1] - y1[1]) % p)


def oracle_mul(P, k, p, nr):
    acc = None
    while k:
        if k & 1:
            acc = oracle_add(acc, P, p, nr)
        P = oracle_add(P, P, p, nr)
        k >>= 1
    return acc


def oracle_msm(pts, ks, p, nr):
    acc = None
    for pt, k in zip(pts, ks):
        acc = oracle_add(acc, oracle_mul(pt, k, p, nr), p, nr)
    return acc


# -- helpers -----------------------------------------------------------------

def setup(name):
    g2 = g2_curve(name, CPU)
    return g2, g2.spec.fp.modulus, g2.spec.fr.modulus, NR[name]


def gen(g2):
    return g2.spec.gx, g2.spec.gy


def to_port(g2, pts) -> Affine:
    zero = (0, 0)
    f = g2.fp
    return Affine(f.from_int([zero if t is None else t[0] for t in pts],
                             device=CPU),
                  f.from_int([zero if t is None else t[1] for t in pts],
                             device=CPU))


def ints2(spec, t: torch.Tensor):
    """(..., 2, W) port words -> list of (re, im) canonical ints."""
    v = tmont.to_int(spec, t.reshape(-1, spec.n_words))
    return list(zip(v[0::2], v[1::2]))


def jints2(spec, a):
    """(..., 2, L) JAX limbs -> list of (re, im) canonical ints."""
    from gnark_crypto_tpu.field import mont as jmont
    from gnark_crypto_tpu.specs import field as jfs

    arr = np.asarray(a)
    v = jmont.to_int(jfs.get_field(spec.name), arr.reshape(-1, arr.shape[-1]))
    v = [v] if isinstance(v, int) else v
    return list(zip(v[0::2], v[1::2]))


def affine_of(g2, p: Jac):
    a = g2.to_affine(Jac(*(c.reshape(-1, *c.shape[-2:]) for c in p)))
    xs, ys = ints2(g2.spec.fp, a.x), ints2(g2.spec.fp, a.y)
    return [None if x == (0, 0) and y == (0, 0) else (x, y)
            for x, y in zip(xs, ys)]


def edge_pairs(g2, p, nr, seed):
    """(P, Q) lists with P + Q, P + P, P + (-P), P + inf, inf + Q and
    inf + inf lanes; random small multiples of the generator."""
    rng = random.Random(seed)
    base = [oracle_mul(gen(g2), rng.randrange(2, 1 << 16), p, nr)
            for _ in range(5)]
    neg = (base[1][0], tuple(-c % p for c in base[1][1]))
    ps = [base[0], base[1], base[1], base[2], None, None, base[4]]
    qs = [base[3], base[1], neg, None, base[2], None, base[0]]
    return ps, qs


def jac(g2, pts) -> Jac:
    """The oracle points as Jacobian port points with z != 1 where finite:
    (x, y, 1) scaled by z = 2 + lane."""
    A = to_port(g2, pts)
    f = g2.fp
    z = f.from_int([(2 + i, 1) for i in range(len(pts))], device=CPU)
    z2 = f.square(z)
    inf = g2.is_inf_affine(A)
    zero = torch.zeros_like(z)
    return Jac(f.mul(A.x, z2), f.mul(A.y, f.mul(z2, z)),
               f.where(inf, zero, z))


# -- plain Fp2 kernels against the Pallas kernels in interpret mode ---------

def jax_jac_case(seed):
    """bn254 edge batches in both packages: (g2, fp, JAX base spec, P, Q,
    JAX P, JAX Q, the oracle lists)."""
    from gnark_crypto_tpu.specs import field as jfs

    g2, p, _, nr = setup("bn254")
    fp = g2.spec.fp
    ps, qs = edge_pairs(g2, p, nr, seed)
    P, Q = jac(g2, ps), jac(g2, qs)
    return (g2, fp, jfs.get_field(fp.name), P, Q,
            convert.point_to_jax(fp, P), convert.point_to_jax(fp, Q), ps, qs)


def test_plain_fp2_jac_add_matches_pallas():
    """jac_add2 with its doubling fallback (a JAX interpret call costs
    minutes on a CPU: the Fp2 add body is ~70 limb products unrolled)."""
    from gnark_crypto_tpu.field.pallas import point_add2 as jpa2

    g2, fp, jfp, P, Q, jP, jQ, ps, qs = jax_jac_case(7)
    want = jpa2.jac_add2(jfp, -1, *jP, *jQ, interpret=True)
    got = point_add2.jac_add2(fp, -1, *P, *Q)
    for g, w in zip(got, want):
        assert ints2(fp, g) == jints2(fp, w)
    p = fp.modulus
    assert affine_of(g2, Jac(*got)) == [oracle_add(u, v, p, -1)
                                        for u, v in zip(ps, qs)]


def test_plain_fp2_jac_double_matches_pallas():
    from gnark_crypto_tpu.field.pallas import point_add2 as jpa2

    g2, fp, jfp, P, _, jP, _, ps, _ = jax_jac_case(8)
    want = jpa2.jac_double2(jfp, -1, *jP, interpret=True)
    got = point_add2.jac_double2(fp, -1, *P)
    for g, w in zip(got, want):
        assert ints2(fp, g) == jints2(fp, w)
    p = fp.modulus
    assert affine_of(g2, Jac(*got)) == [oracle_add(u, u, p, -1) for u in ps]


@pytest.mark.parametrize("name", ["bn254", "bls12_381", "bls12_377"])
def test_plain_fp2_affine_level_matches_pallas(name):
    """affine_prep2, the port's log-depth inverse, affine_finish2 with all
    eight tree-bit patterns."""
    import jax.numpy as jnp

    from gnark_crypto_tpu.field.pallas import point_add2 as jpa2
    from gnark_crypto_tpu.specs import field as jfs

    g2, p, _, nr = setup(name)
    fp = g2.spec.fp
    jfp = jfs.get_field(fp.name)
    ps, qs = edge_pairs(g2, p, nr, 8)
    n = len(ps)
    rng = random.Random(9)
    extra = [oracle_mul(gen(g2), rng.randrange(2, 1 << 16), p, nr)
             for _ in range(2 * n)]
    l_pre, l_suf, r_pre, r_suf = (to_port(g2, pts) for pts in
                                  (extra[:n], ps, qs, extra[n:]))
    tb = torch.tensor([i % 8 for i in range(n)], dtype=torch.int32)
    den, num, bits = point_add2.affine_prep2(fp, nr, *l_suf, *r_pre)
    jden, jnum, jbits = jpa2.affine_prep2(
        jfp, nr, *convert.point_to_jax(fp, l_suf),
        *convert.point_to_jax(fp, r_pre), interpret=True)
    assert ints2(fp, den) == jints2(fp, jden)
    assert ints2(fp, num) == jints2(fp, jnum)
    assert bits.tolist() == np.asarray(jbits).tolist()
    dinv = tpp._log_batch_inverse(g2.fp, den)
    got = point_add2.affine_finish2(fp, nr, *l_pre, *l_suf, *r_pre, *r_suf,
                                    num, dinv, bits, tb)
    want = jpa2.affine_finish2(
        jfp, nr, *(c for pt in (l_pre, l_suf, r_pre, r_suf)
                   for c in convert.point_to_jax(fp, pt)),
        convert.to_jax_limbs(fp, num), convert.to_jax_limbs(fp, dinv),
        jnp.asarray(bits.numpy()), jnp.asarray(tb.numpy()), interpret=True)
    for g, w in zip(got, want):
        assert ints2(fp, g) == jints2(fp, w)


def test_plain_fp2_fold_matches_pallas():
    """Horner fold of 5 window totals, one of them infinity."""
    from gnark_crypto_tpu.field.pallas import point_add2 as jpa2
    from gnark_crypto_tpu.specs import field as jfs

    g2, p, _, nr = setup("bn254")
    fp = g2.spec.fp
    rng = random.Random(10)
    pts = [oracle_mul(gen(g2), rng.randrange(2, 1 << 16), p, nr)
           for _ in range(4)]
    pts.insert(2, None)
    T = jac(g2, pts)
    c = 3
    want = jpa2.jac_fold_windows2(jfs.get_field(fp.name), nr,
                                  *convert.point_to_jax(fp, T), c,
                                  interpret=True)
    got = point_add2.jac_fold_windows2(fp, nr, *T, c)
    for g, w in zip(got, want):
        assert ints2(fp, g) == jints2(fp, w)
    total = oracle_msm(pts, [1 << (c * w) for w in range(len(pts))], p, nr)
    assert affine_of(g2, Jac(*got)) == [total]


# -- the group law ------------------------------------------------------------

@pytest.mark.parametrize("name", ["bn254", "bls12_377"])
def test_g2_add_double_equal_composed(name):
    """The kernel-routed G2 add/double equal the composed Fp2 group law
    coordinate by coordinate, edge lanes and broadcasting included."""
    g2, p, _, nr = setup(name)
    ps, qs = edge_pairs(g2, p, nr, 11)
    P, Q = jac(g2, ps), jac(g2, qs)
    assert g2._kernels2
    before = (point_add2.jac_add2.launches, point_add2.jac_double2.launches)
    pairs = ((g2.add(P, Q), g2._add_composed(P, Q)),
             (g2.double(P), g2._double_composed(P)),
             (g2.add(P, Jac(*(c[0] for c in Q))),
              g2._add_composed(P, Jac(*(c[0] for c in Q)))))
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert torch.equal(g, w)
    assert affine_of(g2, g2.add(P, Q)) == [oracle_add(u, v, p, nr)
                                           for u, v in zip(ps, qs)]
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (point_add2.jac_add2.launches,
            point_add2.jac_double2.launches) == before


def test_g2_plain_ops_reject_large_nr():
    g2, _, _, _ = setup("bn254")
    x = g2.fp.zeros((1,), device=CPU)
    with pytest.raises(ValueError):
        point_add2.jac_double2(g2.spec.fp, -17, x, x, x)


# -- the MSM ------------------------------------------------------------------

def msm_inputs(g2, p, nr, r, n, seed):
    rng = random.Random(seed)
    pts = [oracle_mul(gen(g2), rng.randrange(1, 1 << 20), p, nr)
           for _ in range(n)]
    ks = [rng.randrange(r) for _ in range(n)]
    return pts, ks


def test_g2_msm_small_vs_oracle():
    """n = 8: phase 2 only; a zero scalar and an infinite point."""
    g2, p, r, nr = setup("bn254")
    pts, ks = msm_inputs(g2, p, nr, r, 8, 12)
    ks[0] = 0
    pts[1] = None
    got = tpp.msm(g2, to_port(g2, pts),
                  g2.fr.from_int(ks, mont=False, device=CPU))
    assert got.x.shape == (2, 8)
    assert affine_of(g2, got) == [oracle_msm(pts, ks, p, nr)]


def test_g2_msm_phase1_vs_oracle(monkeypatch):
    """n = 12, c = 3: 85 windows x 12 points = 1,020 lanes. With the
    phase-1 width cut from 4,096 to 64 (at the real width phase 2 alone
    costs minutes of plain Fp2 adds on a CPU), four batch-affine levels
    (affine_prep2) run before phase 2; a duplicate point and equal scalars
    force doubling lanes inside runs."""
    calls = []
    prep = point_add2.affine_prep2

    def counting_prep(*args):
        calls.append(args[2].shape[0])
        return prep(*args)

    monkeypatch.setattr(point_add2, "affine_prep2", counting_prep)
    monkeypatch.setattr(tpp, "BOT_W", 64)
    g2, p, r, nr = setup("bn254")
    pts, ks = msm_inputs(g2, p, nr, r, 12, 13)
    pts[5] = pts[6]
    ks[7] = ks[9] = 12345
    got = tpp.msm(g2, to_port(g2, pts),
                  g2.fr.from_int(ks, mont=False, device=CPU), c=3)
    assert calls == [512, 256, 128, 64]
    assert affine_of(g2, got) == [oracle_msm(pts, ks, p, nr)]


def test_g2_batch_scalar_mul_vs_oracle():
    g2, p, r, nr = setup("bn254")
    rng = random.Random(14)
    ks = [0, 1, 2, r - 1, rng.randrange(r), rng.randrange(r)]
    got = tpp.batch_scalar_mul(g2, g2.generator_affine(device=CPU),
                               g2.fr.from_int(ks, mont=False, device=CPU))
    assert affine_of(g2, got) == [oracle_mul(gen(g2), k, p, nr) for k in ks]


# -- bls12 G2 at 12 words -----------------------------------------------------

@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the plain 12-word point versions are thousands
    of small tensor ops, and several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["bls12_381", "bls12_377"])
def test_plain_fp2_jac_12_words_vs_oracle(name, one_torch_thread):
    """jac_add2 (with its doubling fallback) and jac_double2 at 12 words,
    u^2 = -1 and -5, on the edge lanes: affine results == the oracle."""
    g2, p, _, nr = setup(name)
    assert g2.fp.nr == nr
    fp = g2.spec.fp
    ps, qs = edge_pairs(g2, p, nr, 15)
    P, Q = jac(g2, ps), jac(g2, qs)
    assert P.x.shape == (len(ps), 2, 12)
    got = point_add2.jac_add2(fp, nr, *P, *Q)
    assert affine_of(g2, Jac(*got)) == [oracle_add(u, v, p, nr)
                                        for u, v in zip(ps, qs)]
    got = point_add2.jac_double2(fp, nr, *P)
    assert affine_of(g2, Jac(*got)) == [oracle_add(u, u, p, nr) for u in ps]


@pytest.mark.parametrize("name", ["bls12_381", "bls12_377"])
def test_bls12_g2_msm_2e4_vs_oracle(name, monkeypatch, one_torch_thread):
    """n = 16, c = 4: 64 windows x 16 points = 1,024 lanes; with the
    phase-1 width cut to 128, three batch-affine levels (affine_prep2 at
    12 words) run before phase 2. A zero scalar, an infinite point and a
    duplicate point."""
    calls = []
    prep = point_add2.affine_prep2

    def counting_prep(*args):
        calls.append(args[2].shape)
        return prep(*args)

    monkeypatch.setattr(point_add2, "affine_prep2", counting_prep)
    monkeypatch.setattr(tpp, "BOT_W", 128)
    g2, p, r, nr = setup(name)
    pts, ks = msm_inputs(g2, p, nr, r, 16, 16)
    ks[0] = 0
    pts[1] = None
    pts[5] = pts[6]
    got = tpp.msm(g2, to_port(g2, pts),
                  g2.fr.from_int(ks, mont=False, device=CPU), c=4)
    assert [s[0] for s in calls] == [512, 256, 128]
    assert all(s[1:] == (2, 12) for s in calls)
    assert affine_of(g2, got) == [oracle_msm(pts, ks, p, nr)]
