"""The port's G1 group law and point kernels against the JAX package.

Seeded points (multiples of the generator, by the Python-int oracle of
``tests/test_curve_g1.py``) go to both packages, JAX limbs carried into
port words through ``gnark_crypto_tpu_torch.convert``. Outputs must be
equal as canonical integers: the tolerance is exact equality, and since
both packages run the same formulas in the same order with canonical
arithmetic, Jacobian coordinates are compared as they are, not only up to
projective equivalence.

Each plain kernel version is held against the JAX Pallas kernel in
interpret mode (one interpret call per test: they cost tens of seconds on
the CPU), on the edge cases of ``tests/test_pallas_kernels.py`` and
``tests/test_msm_internals.py``: P = Q, P = -Q, infinities, and a != 0
through ``stark_g1``. ``tests/test_torch_cuda.py`` holds the CUDA kernels
against the plain versions on the card.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
from gnark_crypto_tpu.curve.jacobian import Jac as JJac
from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.specs import curve as jcs
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.field import point_add
from gnark_crypto_tpu_torch.specs import curve as tcs
from tests.test_curve_g1 import oracle_add, oracle_mul, rand_points

CPU = "cpu"
CURVES = ["bn254_g1", "stark_g1"]


def curves(name):
    return jcurve_ops(jcs.get_curve(name)), curve_ops(tcs.get_curve(name))


def to_port(curve, pts) -> Affine:
    f = curve.fp
    return Affine(
        f.from_int([0 if p is None else p[0] for p in pts], device=CPU),
        f.from_int([0 if p is None else p[1] for p in pts], device=CPU))


def ints(spec, t):
    """Canonical integers of a port coordinate tensor."""
    v = tmont.to_int(spec, t)
    return [v] if isinstance(v, int) else v


def jints(spec, a):
    """Canonical integers of a JAX limb array over the port spec's field."""
    v = jmont.to_int(jfs.get_field(spec.name), a)
    return [v] if isinstance(v, int) else v


def same_point(spec, jax_pt, port_pt):
    """Equal coordinate by coordinate as canonical integers."""
    return all(jints(spec, jc) == ints(spec, tc)
               for jc, tc in zip(jax_pt, port_pt))


def affine_ints(curve, p: Affine):
    xs, ys = ints(curve.spec.fp, p.x), ints(curve.spec.fp, p.y)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def edge_pairs(curve, seed):
    """Point pairs with P + Q, P + P, P + (-P), P + inf, inf + Q, inf + inf
    (tests/test_curve_g1.py:71-73)."""
    p = curve.spec.fp.modulus
    pts1 = rand_points(curve, 4, seed)
    pts2 = rand_points(curve, 4, seed + 1)
    pts1 += [pts1[0], pts1[1], pts1[2], None, None]
    pts2 += [pts1[0], (pts1[1][0], (-pts1[1][1]) % p), None, pts2[2], None]
    return pts1, pts2


def jac_inputs(name, seed):
    """The same Jacobian batches in both packages."""
    jc, tc = curves(name)
    pts1, pts2 = edge_pairs(tc, seed)
    P, Q = (tc.from_affine(to_port(tc, pts)) for pts in (pts1, pts2))
    jP, jQ = (JJac(*convert.point_to_jax(tc.spec.fp, pt)) for pt in (P, Q))
    return jc, tc, pts1, pts2, P, Q, jP, jQ


# -- each plain kernel version against the Pallas kernel (interpret) --------

@pytest.mark.parametrize("name", CURVES)
def test_jac_add_plain_matches_pallas(name):
    """Includes the doubling fallback: a != 0 for stark_g1."""
    from gnark_crypto_tpu.field.pallas.point_add import jac_add

    jc, tc, _, _, P, Q, jP, jQ = jac_inputs(name, 11)
    want = jac_add(jc.spec.fp, jc.spec.a, *jP, *jQ, interpret=True)
    got = point_add.jac_add(tc.spec.fp, tc.spec.a, *P, *Q)
    assert same_point(tc.spec.fp, want, got)
    # infinity stays all-zero
    inf = tc.is_inf_jac(Jac(*got))
    assert inf.sum() == 2 and not got[0][inf].any() and not got[1][inf].any()


def test_jac_double_plain_matches_pallas():
    from gnark_crypto_tpu.field.pallas.point_add import jac_double

    jc, tc, _, _, P, _, jP, _ = jac_inputs("bn254_g1", 13)
    want = jac_double(jc.spec.fp, jc.spec.a, *jP, interpret=True)
    assert same_point(tc.spec.fp, want,
                      point_add.jac_double(tc.spec.fp, tc.spec.a, *P))


@pytest.mark.parametrize("name", CURVES)
def test_affine_level_plain_matches_pallas(name):
    """affine_prep + affine_finish (tests/test_msm_internals.py:143), with
    the JAX package's own log-depth inversion between them."""
    import jax.numpy as jnp

    from gnark_crypto_tpu.field.pallas.point_add import (affine_finish,
                                                         affine_prep)
    from gnark_crypto_tpu.msm import pippenger as jpp
    from gnark_crypto_tpu_torch.msm import pippenger as tpp

    jc, tc = curves(name)
    jf, fp = jc.fp, tc.spec.fp
    p = fp.modulus
    base = rand_points(tc, 6, 41)
    ls_pts = base[:4] + [base[0], base[1], None, base[2], None, base[3]]
    rp_pts = base[2:6] + [base[0], (base[1][0], (-base[1][1]) % p),
                          base[4], None, None, base[3]]
    n = len(ls_pts)
    parts = [to_port(tc, pts) for pts in (rand_points(tc, n, 42), ls_pts,
                                          rp_pts, rand_points(tc, n, 43))]
    l_pre, l_suf, r_pre, r_suf = parts
    jparts = [JAffine(*convert.point_to_jax(fp, pt)) for pt in parts]
    rng = np.random.default_rng(44)
    tb = (rng.integers(0, 8, size=(n,))).astype(np.int32)

    jden, jnum, jbits = affine_prep(jc.spec.fp, jc.spec.a, *jparts[1],
                                    *jparts[2], interpret=True)
    jdinv = jpp._log_batch_inverse(jf, jden)
    jout = affine_finish(jc.spec.fp, jc.spec.a, *jparts[0], *jparts[1],
                         *jparts[2], *jparts[3], jnum, jdinv, jbits,
                         jnp.asarray(tb), interpret=True)

    den, num, bits = point_add.affine_prep(fp, tc.spec.a, *l_suf, *r_pre)
    assert ints(fp, den) == jints(fp, jden)
    assert ints(fp, num) == jints(fp, jnum)
    assert bits.tolist() == np.asarray(jbits).tolist()
    dinv = tpp._log_batch_inverse(tc.fp, den)
    assert ints(fp, dinv) == jints(fp, jdinv)
    out = point_add.affine_finish(fp, tc.spec.a, *l_pre, *l_suf, *r_pre,
                                  *r_suf, num, dinv, bits,
                                  torch.from_numpy(tb))
    for got, want in zip(out, jout):
        assert ints(fp, got) == jints(fp, want)


def test_fold_windows_plain_matches_pallas():
    """Horner fold of 8 window totals, two of them infinity."""
    from gnark_crypto_tpu.field.pallas.point_add import jac_fold_windows

    jc, tc = curves("bn254_g1")
    pts = rand_points(tc, 6, 21) + [None, None]
    random.Random(3).shuffle(pts)
    T = tc.from_affine(to_port(tc, pts))
    jT = JJac(*convert.point_to_jax(tc.spec.fp, T))
    want = jac_fold_windows(jc.spec.fp, jc.spec.a, *jT, 4, interpret=True)
    got = point_add.jac_fold_windows(tc.spec.fp, tc.spec.a, *T, 4)
    assert same_point(tc.spec.fp, want, got)


# -- the group law against JAX curve_ops and the Python oracle --------------

@pytest.mark.parametrize("name", CURVES)
def test_group_law_matches_jax_and_oracle(name):
    jc, tc, pts1, pts2, P, Q, jP, jQ = jac_inputs(name, 1)
    p = tc.spec.fp.modulus
    a = tc.spec.a % p
    fp = tc.spec.fp
    jA2 = JAffine(*convert.point_to_jax(fp, to_port(tc, pts2)))
    for got, want in ((tc.add(P, Q), jc.add(jP, jQ)),
                      (tc.double(P), jc.double(jP)),
                      (tc.add_mixed(P, to_port(tc, pts2)),
                       jc.add_mixed(jP, jA2))):
        assert same_point(fp, want, got)
    add = [oracle_add(u, v, p, a) for u, v in zip(pts1, pts2)]
    assert affine_ints(tc, tc.to_affine(tc.add(P, Q))) == add
    assert affine_ints(tc, tc.to_affine(
        tc.add_mixed(P, to_port(tc, pts2)))) == add
    assert affine_ints(tc, tc.to_affine(tc.double(P))) == [
        oracle_add(u, u, p, a) for u in pts1]
    assert same_point(fp, jc.to_affine(jP), tc.to_affine(P))
    # broadcasting a single point against a batch
    one = Jac(*(c[0] for c in Q))
    assert same_point(fp, jc.add(jP, JJac(*(c[0] for c in jQ))),
                      tc.add(P, one))


@pytest.mark.parametrize("name", CURVES)
def test_scalar_mul_and_joint_vs_oracle(name):
    tc = curve_ops(tcs.get_curve(name))
    p = tc.spec.fp.modulus
    a = tc.spec.a % p
    g = (tc.spec.gx % p, tc.spec.gy % p)
    h = oracle_mul(g, 12345, p, a)
    rng = random.Random(3)
    nbits = 24
    ks = [0, 1, 2, rng.randrange(1 << nbits), (1 << nbits) - 1]
    ls = [rng.randrange(1 << nbits) for _ in ks[:-1]] + [0]
    G = tc.from_affine(to_port(tc, [g] * len(ks)))
    H = tc.from_affine(to_port(tc, [h] * len(ks)))
    fr = tc.fr
    kd = fr.from_int(ks, mont=False, device=CPU)
    ld = fr.from_int(ls, mont=False, device=CPU)
    got = affine_ints(tc, tc.to_affine(tc.scalar_mul(G, kd, nbits)))
    assert got == [oracle_mul(g, k, p, a) for k in ks]
    got = affine_ints(tc, tc.to_affine(
        tc.joint_scalar_mul(G, H, kd, ld, nbits)))
    assert got == [oracle_add(oracle_mul(g, k, p, a), oracle_mul(h, m, p, a),
                              p, a) for k, m in zip(ks, ls)]


def test_predicates_and_generator():
    for name in CURVES:
        tc = curve_ops(tcs.get_curve(name))
        g = tc.generator_affine(device=CPU)
        assert bool(tc.on_curve_affine(g))
        bad = Affine(g.x, tc.fp.add(g.y, tc.fp.ones(device=CPU)))
        assert not bool(tc.on_curve_affine(bad))
        assert bool(tc.on_curve_affine(tc.inf_affine(device=CPU)))
        G = tc.generator_jac(device=CPU)
        assert bool(tc.eq_jac(tc.double(G), tc.add(G, G)))
        assert not bool(tc.eq_jac(G, tc.neg_jac(G)))
        assert bool(tc.is_inf_jac(tc.add(G, tc.neg_jac(G))))
        assert bool(tc.eq_jac(tc.inf_jac(device=CPU), tc.inf_jac(device=CPU)))
        assert affine_ints(tc, tc.neg_affine(Affine(g.x[None], g.y[None]))) \
            == [(tc.spec.gx % tc.spec.fp.modulus,
                 -tc.spec.gy % tc.spec.fp.modulus)]


def test_specs_match_jax():
    assert set(tcs.all_curves()) == set(jcs.all_curves())
    for name, t in tcs.all_curves().items():
        j = jcs.get_curve(name)
        assert (t.fp.name, t.fr.name, t.a, t.b, t.gx, t.gy, t.cofactor,
                t.glv_lambda, t.glv_third_root, t.glv_basis) == (
            j.fp.name, j.fr.name, j.a, j.b, j.gx, j.gy, j.cofactor,
            j.glv_lambda, j.glv_third_root, j.glv_basis)


def test_point_convert_roundtrip():
    tc = curve_ops(tcs.get_curve("bn254_g1"))
    P = tc.from_affine(to_port(tc, rand_points(tc, 3, 5) + [None]))
    back = convert.point_from_jax(tc.spec.fp,
                                  JJac(*convert.point_to_jax(tc.spec.fp, P)),
                                  device=CPU)
    assert isinstance(back, Jac)
    assert all(torch.equal(u, v) for u, v in zip(back, P))


def test_cpu_points_never_launch():
    tc = curve_ops(tcs.get_curve("bn254_g1"))
    wrappers = (point_add.jac_add, point_add.jac_double)
    before = [w.launches for w in wrappers]
    G = tc.generator_jac(device=CPU)
    tc.add(tc.double(G), G)
    assert [w.launches for w in wrappers] == before
