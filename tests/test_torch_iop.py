"""The port's IOP toolkit on the CPU against the JAX package: ``iop``,
``multilin``, ``permutation`` and ``pedersen``.

Inputs are made from a seed; outputs are compared as canonical integers
(tolerance 0), never as limb arrays.

* ``iop`` and ``multilin`` on bn254 Fr and bw6-761 Fr (8 and 12 words) at
  n = 16-32: every basis and layout step and round trip, ``evaluate``,
  ``to_lagrange_batch``, ``evaluate_expression``, ``divide_by_x_minus_one``
  and ``build_ratio_copy_constraint``, each against the JAX function on the
  same inputs (the checks of ``tests/test_iop_pedersen.py``, mirrored);
  ``fold``, ``evaluate`` and ``eval_eq`` against the JAX ``multilin``.
* ``permutation`` on bn254 at n = 16 (the case of
  ``tests/test_shplonk_fflonk.py::test_permutation_proof``): the port's
  proof equals the JAX proof point for point, through ``convert``;
  ``verify`` runs with ``pairing_check`` replaced by the T == [-alpha]H
  test on the captured G1 pair (alpha is known), as
  ``tests/test_torch_kzg.py`` does; a non-permutation is refused by the
  relation at eta.
* ``pedersen`` on bn254 at n = 8: ``setup`` against Python-int ladders,
  ``commit``, ``prove_knowledge``, ``fold_commitments`` and
  ``batch_prove`` against the JAX outputs on the same keys (carried across
  by ``convert``), ``verify`` and ``batch_verify_multi_vk`` with the
  pairing replaced by the scalar relation it decides (sigma is known), and
  one real pairing check (``verify`` on the honest proof, about a minute
  on the plain VM executor).
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.jacobian import Affine, curve_ops
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.protocols import iop, kzg, multilin, pedersen
from gnark_crypto_tpu_torch.protocols import permutation
from gnark_crypto_tpu_torch.specs import curve as tcs
from gnark_crypto_tpu_torch.specs import field as tfs
from tests.test_curve_g1 import oracle_add, oracle_mul
from tests.test_torch_g2_msm import oracle_mul as oracle_mul2

CPU = "cpu"
FIELDS = ["bn254_fr", "bw6_761_fr"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain versions are many small tensor ops,
    and several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_iop():
    from gnark_crypto_tpu.protocols import iop as jiop

    return jiop


def jspec_of(name):
    from gnark_crypto_tpu.specs import field as jfs

    return jfs.get_field(name)


def rand_ints(q, n, seed):
    rng = random.Random(seed)
    return [rng.randrange(q) for _ in range(n)]


def t_ints(spec, x, mont=False):
    return tmont.to_int(spec, x, mont=mont)


def j_ints(spec, x, mont=False):
    from gnark_crypto_tpu.field import mont as jmont

    v = jmont.to_int(spec, np.asarray(x), mont=mont)
    return [v] if isinstance(v, int) else v


def both_polys(name, n, seed):
    """The same canonical polynomial in both packages."""
    jiop = jax_iop()
    jspec, tspec = jspec_of(name), tfs.get_field(name)
    vals = rand_ints(tspec.modulus, n, seed)
    jp = jiop.from_canonical(jspec, jiop.for_spec(jspec).from_int(
        vals, mont=False))
    tp = iop.from_canonical(tspec, tmont.from_int(tspec, vals, mont=False,
                                                  device=CPU))
    return jp, tp, vals


def same_poly(jp, tp):
    assert tp.basis.name == jp.basis.name
    assert tp.layout.name == jp.layout.name
    assert t_ints(tp.spec, tp.values) == j_ints(jp.spec, jp.values)


# -- iop ---------------------------------------------------------------------

@pytest.mark.parametrize("name", FIELDS)
def test_iop_basis_layout_steps_match_jax(name):
    """Every conversion, from every basis and layout, equals the JAX one;
    the round trips give the input back."""
    jp, tp, vals = both_polys(name, 32, 1)
    for step in (lambda p: p.to_lagrange(),
                 lambda p: p.to_lagrange_coset(),
                 lambda p: p.to_bit_reverse().to_lagrange(),
                 lambda p: p.to_bit_reverse().to_lagrange_coset(),
                 lambda p: p.to_lagrange().to_canonical(),
                 lambda p: p.to_lagrange().to_regular().to_canonical(),
                 lambda p: p.to_lagrange_coset().to_canonical(),
                 lambda p: p.to_lagrange_coset().to_regular().to_canonical(),
                 lambda p: p.to_lagrange().to_lagrange_coset(),
                 lambda p: p.to_lagrange_coset().to_lagrange()):
        same_poly(step(jp), step(tp))
    for back in (tp.to_lagrange().to_canonical().to_regular(),
                 tp.to_lagrange_coset().to_canonical().to_regular()):
        assert t_ints(tp.spec, back.values) == vals


@pytest.mark.parametrize("name", FIELDS)
def test_iop_evaluate_matches_jax_and_horner(name):
    jp, tp, vals = both_polys(name, 16, 2)
    q = tp.spec.modulus
    a = 12345
    got = t_ints(tp.spec, tp.evaluate(tmont.from_int(
        tp.spec, [a], mont=False, device=CPU)))
    want = 0
    for c in reversed(vals):
        want = (want * a + c) % q
    assert got == [want]
    jv = jp.evaluate(jp.eng.from_int([a], mont=False))
    assert j_ints(jp.spec, jv) == [want]
    # from Lagrange, bit-reversed: the same value
    lag = tp.to_lagrange()
    assert t_ints(tp.spec, lag.evaluate(tmont.from_int(
        tp.spec, [a], mont=False, device=CPU))) == [want]


@pytest.mark.parametrize("name", FIELDS)
def test_iop_to_lagrange_batch_matches_jax(name):
    jiop = jax_iop()
    pairs = [both_polys(name, 32, 31 + i)[:2] for i in range(5)]
    pairs[3] = (pairs[3][0].to_bit_reverse(), pairs[3][1].to_bit_reverse())
    pairs[4] = (pairs[4][0].to_lagrange(), pairs[4][1].to_lagrange())
    for coset in (False, True):
        jout = jiop.to_lagrange_batch([p[0] for p in pairs], coset=coset)
        tout = iop.to_lagrange_batch([p[1] for p in pairs], coset=coset)
        for jp, tp, (_, src) in zip(jout, tout, pairs):
            same_poly(jp, tp)
            single = src.to_lagrange(coset).to_regular()
            assert torch.equal(tp.values, single.values)


@pytest.mark.parametrize("name", FIELDS)
def test_iop_evaluate_expression_matches_jax(name):
    jiop = jax_iop()
    j1, t1, _ = both_polys(name, 16, 21)
    j2, t2, _ = both_polys(name, 16, 22)
    j3, t3, _ = both_polys(name, 16, 23)
    jargs = (j1, j2.to_lagrange(), j3.to_canonical().to_bit_reverse())
    targs = (t1, t2.to_lagrange(), t3.to_canonical().to_bit_reverse())
    jout = jiop.evaluate_expression(
        j1.spec, lambda e, a, b, c: e.add(e.mul(a, b), c), *jargs)
    tout = iop.evaluate_expression(
        t1.spec, lambda e, a, b, c: e.add(e.mul(a, b), c), *targs)
    assert tout.basis == iop.Basis.LAGRANGE
    assert tout.layout == iop.Layout.REGULAR
    same_poly(jout, tout)


@pytest.mark.parametrize("vanish", [None, 4])
@pytest.mark.parametrize("name", FIELDS)
def test_iop_divide_by_x_minus_one_matches_jax(name, vanish):
    """p = (X^m - 1) h + 0: the quotient is h, in both packages; m = N/2
    (period 2) and m = 4 (period 8 over N = 32)."""
    jiop = jax_iop()
    jspec, tspec = jspec_of(name), tfs.get_field(name)
    q = tspec.modulus
    big_n = 32
    m = vanish or big_n // 2
    h = rand_ints(q, big_n - m, 4)
    p_coeffs = [0] * big_n
    for i, c in enumerate(h):   # (X^m - 1) h
        p_coeffs[i] = (p_coeffs[i] - c) % q
        p_coeffs[i + m] = (p_coeffs[i + m] + c) % q
    jp = jiop.Polynomial(jspec, jiop.for_spec(jspec).from_int(
        p_coeffs, mont=False), jiop.Basis.CANONICAL, jiop.Layout.REGULAR)
    tp = iop.from_canonical(tspec, tmont.from_int(tspec, p_coeffs,
                                                  mont=False, device=CPU))
    jq = jiop.divide_by_x_minus_one(jp, vanish)
    tq = iop.divide_by_x_minus_one(tp, vanish)
    same_poly(jq, tq)
    assert t_ints(tspec, tq.values) == h + [0] * m
    # a remainder breaks the identity: the quotient of p + 1 differs
    p1 = iop.from_canonical(tspec, tmont.from_int(
        tspec, [(p_coeffs[0] + 1) % q] + p_coeffs[1:], mont=False,
        device=CPU))
    assert t_ints(tspec, iop.divide_by_x_minus_one(p1, vanish).values) \
        != h + [0] * m


@pytest.mark.parametrize("name", FIELDS)
def test_iop_ratio_copy_constraint_matches_jax(name):
    """Three columns of 16 under a random permutation: Z equals the JAX
    accumulator; under the identity permutation every ratio is 1; and
    for a sigma that the columns respect, Z wraps to 1 (the product of the
    ratios is 1)."""
    jiop = jax_iop()
    jspec, tspec = jspec_of(name), tfs.get_field(name)
    q = tspec.modulus
    n, k = 16, 3
    rng = random.Random(9)
    sigma = list(range(k * n))
    rng.shuffle(sigma)
    beta, gamma = rng.randrange(q), rng.randrange(q)
    cols = [both_polys(name, n, 50 + j)[:2] for j in range(k)]
    jz = jiop.build_ratio_copy_constraint(jspec, [c[0] for c in cols],
                                          sigma, beta, gamma)
    tz = iop.build_ratio_copy_constraint(tspec, [c[1] for c in cols],
                                         sigma, beta, gamma)
    same_poly(jz, tz)
    tid = iop.build_ratio_copy_constraint(tspec, [c[1] for c in cols],
                                          list(range(k * n)), beta, gamma)
    assert t_ints(tspec, tid.values) == [1] * n
    # values constant along each cycle of sigma: the grand product is 1
    vals = [0] * (k * n)
    seen = [False] * (k * n)
    for start in range(k * n):
        if not seen[start]:
            v, t = rng.randrange(q), start
            while not seen[t]:
                seen[t], vals[t] = True, v
                t = sigma[t]
    lag = [iop.Polynomial(tspec, tmont.from_int(
        tspec, vals[j * n:(j + 1) * n], mont=False, device=CPU),
        iop.Basis.LAGRANGE, iop.Layout.REGULAR) for j in range(k)]
    z = t_ints(tspec, iop.build_ratio_copy_constraint(
        tspec, lag, sigma, beta, gamma).values)
    ratios = [z[i + 1] * pow(z[i], -1, q) % q for i in range(n - 1)]
    last = 1
    for j in range(k):   # the last row's ratio, from the definition
        f = vals[j * n + n - 1]
        last = last * (f + beta * pow(tspec.generator, j, q)
                       * pow(iop.domain(tspec, n, CPU).generator_int,
                             n - 1, q) + gamma) % q
        last = last * pow((f + beta * _sigma_id(tspec, n, sigma[
            j * n + n - 1]) + gamma) % q, -1, q) % q
    assert z[0] == 1 and all(r != 0 for r in ratios)
    assert z[n - 1] * last % q == 1


def _sigma_id(spec, n, t):
    q = spec.modulus
    g = iop.domain(spec, n, CPU).generator_int
    return pow(spec.generator, t // n, q) * pow(g, t % n, q) % q


def test_convert_carries_polynomials_both_ways():
    """A JAX polynomial in each basis and layout crosses to the port and
    back with its values, basis and layout."""
    jiop = jax_iop()
    jp, tp, vals = both_polys("bw6_761_fr", 16, 3)
    for j in (jp, jp.to_lagrange(), jp.to_lagrange_coset().to_regular()):
        t = convert.poly_from_jax(j, device=CPU)
        same_poly(j, t)
        back = convert.poly_to_jax(t)
        assert (back["basis"], back["layout"]) == (j.basis.name,
                                                   j.layout.name)
        assert j_ints(j.spec, back["values"]) == j_ints(j.spec, j.values)
        assert isinstance(t.basis, iop.Basis) and back["spec"] == \
            jiop.for_spec(j.spec).spec.name


# -- multilin ----------------------------------------------------------------

@pytest.mark.parametrize("name", FIELDS)
def test_multilin_fold_evaluate_eq_match_jax(name):
    from gnark_crypto_tpu.protocols import multilin as jml

    jspec, tspec = jspec_of(name), tfs.get_field(name)
    q = tspec.modulus
    from gnark_crypto_tpu.field.api import for_spec as jfor

    jeng = jfor(jspec)
    k = 5
    table = rand_ints(q, 1 << k, 7)
    coords = rand_ints(q, k, 8)
    jt, tt = jeng.from_int(table), tmont.from_int(tspec, table, device=CPU)
    jc, tc = jeng.from_int(coords), tmont.from_int(tspec, coords, device=CPU)
    f1 = multilin.fold(tspec, tt, tc[0])
    assert t_ints(tspec, f1, mont=True) == j_ints(
        jspec, jml.fold(jspec, jt, jc[0]), mont=True)
    got = t_ints(tspec, multilin.evaluate(tspec, tt, tc), mont=True)
    assert [got] == j_ints(jspec, jml.evaluate(jspec, jt, jc), mont=True)
    # against the multilinear extension on host integers: variable i
    # selects the top bit of the remaining table
    want = table
    for r in coords:
        mid = len(want) // 2
        want = [(want[i] + r * (want[i + mid] - want[i])) % q
                for i in range(mid)]
    assert got == want[0]
    h = rand_ints(q, k, 9)
    jh, th = jeng.from_int(h), tmont.from_int(tspec, h, device=CPU)
    eq = t_ints(tspec, multilin.eval_eq(tspec, tc, th), mont=True)
    assert [eq] == j_ints(jspec, jml.eval_eq(jspec, jc, jh), mont=True)
    want = 1
    for a, b in zip(coords, h):
        want = want * (1 + 2 * a * b - a - b) % q
    assert eq == want


# -- permutation (bn254, n = 16) ----------------------------------------------

NAME = "bn254"
SIZE = 16
G1 = curve_ops(tcs.get_curve(f"{NAME}_g1"))
P_MOD, R_MOD = G1.spec.fp.modulus, G1.spec.fr.modulus
ALPHA = random.Random(20261018).randrange(1 << 64)


def g1_ints(p: Affine):
    xs, ys = (tmont.to_int(G1.spec.fp, c) for c in p)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def perm_inputs(bad: bool = False):
    rng = random.Random(7)
    vals = [rng.randrange(R_MOD) for _ in range(SIZE)]
    perm = list(range(SIZE))
    rng.shuffle(perm)
    t2 = [vals[p] for p in perm]
    if bad:
        t2[0] = (t2[0] + 1) % R_MOD
    return vals, t2


def oracle_srs() -> kzg.SRS:
    """The SRS of ALPHA from Python-int ladders ([alpha^i]G1, [alpha]G2):
    ``new_srs``'s own ladders are held in ``tests/test_torch_kzg.py``."""
    from gnark_crypto_tpu_torch.curve.g2 import g2_curve

    pts = [oracle_mul(GEN1, pow(ALPHA, i, R_MOD), P_MOD, 0)
           for i in range(SIZE)]
    fp = G1.spec.fp
    g1 = Affine(tmont.from_int(fp, [p[0] for p in pts], device=CPU),
                tmont.from_int(fp, [p[1] for p in pts], device=CPU))
    g2 = g2_curve(NAME, CPU)
    gen2 = (tuple(g2.spec.gx), tuple(g2.spec.gy))
    a2 = oracle_mul2(gen2, ALPHA, P_MOD, g2.fp.nr)

    def aff2(p):
        return Affine(g2.fp.from_int([p[0]], device=CPU),
                      g2.fp.from_int([p[1]], device=CPU))

    return kzg.SRS(kzg.ProvingKey(g1), kzg.VerifyingKey(
        aff2(gen2), aff2(a2), Affine(g1.x[:1], g1.y[:1])))


@pytest.fixture(scope="module")
def perm_case():
    """The port's proof on the oracle SRS (about a minute on a CPU: six
    MSMs of 16 points on the plain versions)."""
    vals, t2 = perm_inputs()
    srs = oracle_srs()
    fr = G1.fr
    proof = permutation.prove(NAME, srs.pk,
                              fr.from_int(vals, mont=False, device=CPU),
                              fr.from_int(t2, mont=False, device=CPU))
    return dict(srs=srs, proof=proof)


def test_permutation_proof_equals_jax_point_for_point(perm_case):
    """The JAX proof on the same proving key (the port's SRS points
    carried across: the JAX ``new_srs`` spends minutes compiling its G2
    ladder on a CPU; its ``prove`` about 40 s) equals the port's."""
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu.protocols import kzg as jkzg
    from gnark_crypto_tpu.protocols import permutation as jperm

    vals, t2 = perm_inputs()
    jpk = jkzg.ProvingKey(JAffine(*convert.point_to_jax(
        G1.spec.fp, perm_case["srs"].pk.g1)))
    jfr = jax_iop().for_spec(jspec_of(f"{NAME}_fr"))
    jproof = jperm.prove(NAME, jpk, jfr.from_int(vals, mont=False),
                         jfr.from_int(t2, mont=False))
    proof = perm_case["proof"]
    want = convert.perm_proof_from_jax(NAME, jproof, device=CPU)
    assert proof.size == want.size == SIZE
    for field in ("t1", "t2", "z", "q"):
        assert g1_ints(getattr(proof, field)) == g1_ints(getattr(want,
                                                                 field)), field
    assert g1_ints(proof.batched.h) == g1_ints(want.batched.h)
    assert g1_ints(proof.shifted.h) == g1_ints(want.shifted.h)
    fr = G1.spec.fr
    assert t_ints(fr, proof.batched.claimed_values) == t_ints(
        fr, want.batched.claimed_values)
    assert t_ints(fr, proof.shifted.claimed_value) == t_ints(
        fr, want.shifted.claimed_value)
    # and back: the port's proof as JAX limbs equals the JAX proof's
    back = convert.perm_proof_to_jax(NAME, proof)
    assert j_ints(jspec_of("bn254_fp"), back["z"][0], mont=True) == \
        j_ints(jspec_of("bn254_fp"), jproof.z.x, mont=True)


def captured_check(monkeypatch):
    """Replace pairing_check: record each G1 pair (T, H) and answer
    T == [-alpha]H, the KZG check's verdict for a known alpha."""
    seen = []

    def check(name, P, qx, qy):
        T, H = g1_ints(P)
        seen.append((T, H))
        return torch.tensor(T == oracle_mul(H, (-ALPHA) % R_MOD, P_MOD, 0))

    monkeypatch.setattr(kzg.pairing_api, "pairing_check", check)
    return seen


def test_permutation_verify_with_captured_pairs(perm_case, monkeypatch):
    seen = captured_check(monkeypatch)
    srs, proof = perm_case["srs"], perm_case["proof"]
    assert permutation.verify(NAME, srs.vk, proof) is True
    assert len(seen) == 2          # the batched opening and the shifted one
    # a tampered claimed value of Z at g*eta breaks the relation at eta
    bad = permutation.Proof(**{**proof.__dict__, "shifted": kzg.OpeningProof(
        proof.shifted.h, G1.fr.from_int(
            [t_ints(G1.spec.fr, proof.shifted.claimed_value)[0] + 1],
            mont=False, device=CPU))})
    assert permutation.verify(NAME, srs.vk, bad) is False
    assert len(seen) == 2   # refused by the relation at eta


def test_permutation_verify_refuses_a_bad_opening(perm_case, monkeypatch):
    """A batched opening whose quotient commitment H is another point: the
    relation at eta holds (it reads only the claimed values), the KZG
    check of the batched opening does not."""
    seen = captured_check(monkeypatch)
    srs, proof = perm_case["srs"], perm_case["proof"]
    bad = permutation.Proof(**{**proof.__dict__, "batched":
                               kzg.BatchOpeningProof(
                                   proof.shifted.h,
                                   proof.batched.claimed_values)})
    assert permutation.verify(NAME, srs.vk, bad) is False
    assert len(seen) == 2
    T, H = seen[0]
    assert T != oracle_mul(H, (-ALPHA) % R_MOD, P_MOD, 0)


def test_permutation_refuses_a_non_permutation(perm_case, monkeypatch):
    seen = captured_check(monkeypatch)
    vals, t2 = perm_inputs(bad=True)
    fr = G1.fr
    bad = permutation.prove(NAME, perm_case["srs"].pk,
                            fr.from_int(vals, mont=False, device=CPU),
                            fr.from_int(t2, mont=False, device=CPU))
    assert permutation.verify(NAME, perm_case["srs"].vk, bad) is False
    assert seen == []   # refused by the relation at eta, before any pairing


# -- pedersen (bn254, n = 8) ------------------------------------------------

# -sigma is small: setup's G2 ladder runs over its bits (the G1 ladders
# over sigma's 254 bits, on 8 lanes, cost less on a CPU)
SIGMA = R_MOD - 0xABCDEF
G2_SCALAR = 3
NB = 8
GEN1 = (G1.spec.gx, G1.spec.gy)


def rand_basis(n, seed):
    """[k_i]G for random small k_i, affine on the CPU."""
    rng = random.Random(seed)
    pts = [oracle_mul(GEN1, rng.randrange(1, 1 << 20), P_MOD, 0)
           for _ in range(n)]
    fp = G1.spec.fp
    return Affine(tmont.from_int(fp, [p[0] for p in pts], device=CPU),
                  tmont.from_int(fp, [p[1] for p in pts], device=CPU)), pts


def fr_plain(ks):
    return G1.fr.from_int([k % R_MOD for k in ks], mont=False, device=CPU)


@pytest.fixture(scope="module")
def ped_case():
    rng = random.Random(5)
    bases, pts = zip(*(rand_basis(NB, 31 + i) for i in range(2)))
    keys = [pedersen.setup(NAME, [b], sigma=SIGMA + i, g2_scalar=G2_SCALAR)
            for i, b in enumerate(bases)]
    values = [[rng.randrange(R_MOD) for _ in range(NB)] for _ in range(2)]
    coms = [pedersen.commit(NAME, k[0][0], fr_plain(v))
            for k, v in zip(keys, values)]
    poks = [pedersen.prove_knowledge(NAME, k[0][0], fr_plain(v))
            for k, v in zip(keys, values)]
    # a 20-bit combination coefficient: batch_verify_multi_vk's ladder
    # runs over its bits (chip_smoke.py takes a random one below r)
    return dict(pts=pts, keys=keys, values=values, coms=coms, poks=poks,
                coeff=rng.randrange(1, 1 << 20))


def test_pedersen_setup_matches_oracles(ped_case):
    from gnark_crypto_tpu_torch.curve.g2 import g2_curve

    g2 = g2_curve(NAME, CPU)
    spec2 = g2.spec
    fp = G1.spec.fp

    def g2_ints(p):
        x, y = (tmont.to_int(fp, c.reshape(-1, fp.n_words)) for c in p)
        return (tuple(x), tuple(y))

    for i, (pks, vk) in enumerate(ped_case["keys"]):
        sig = SIGMA + i
        assert g1_ints(pks[0].basis_exp_sigma) == [
            oracle_mul(p, sig, P_MOD, 0) for p in ped_case["pts"][i]]
        g = oracle_mul2((tuple(spec2.gx), tuple(spec2.gy)), G2_SCALAR,
                        P_MOD, g2.fp.nr)
        assert g2_ints(vk.g) == g
        assert g2_ints(vk.g_sigma_neg) == oracle_mul2(
            g, (-sig) % R_MOD, P_MOD, g2.fp.nr)


def jax_keys(ped_case, i):
    """The port's keys of ceremony i as the JAX package's types."""
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu.protocols import pedersen as jped

    pks, vk = ped_case["keys"][i]
    d = convert.pedersen_keys_to_jax(NAME, pks, vk)
    jpks = [jped.ProvingKey(JAffine(*k["basis"]),
                            JAffine(*k["basis_exp_sigma"])) for k in d["pks"]]
    return jpks, jped.VerifyingKey(JAffine(*d["vk"]["g"]),
                                   JAffine(*d["vk"]["g_sigma_neg"]))


def j_affine_ints(p):
    fp = jspec_of("bn254_fp")
    xs, ys = j_ints(fp, p.x, mont=True), j_ints(fp, p.y, mont=True)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def test_pedersen_commit_and_pok_match_jax(ped_case):
    from gnark_crypto_tpu.protocols import pedersen as jped

    jpks, jvk = jax_keys(ped_case, 0)
    # the keys cross both ways unchanged
    pks, vk = convert.pedersen_keys_from_jax(NAME, jpks, jvk, device=CPU)
    mine = ped_case["keys"][0]
    assert g1_ints(pks[0].basis_exp_sigma) == g1_ints(
        mine[0][0].basis_exp_sigma)
    assert torch.equal(vk.g_sigma_neg.x, mine[1].g_sigma_neg.x)
    jfr = jax_iop().for_spec(jspec_of(f"{NAME}_fr"))
    jv = jfr.from_int(ped_case["values"][0], mont=False)
    assert g1_ints(ped_case["coms"][0]) == j_affine_ints(
        jped.commit(NAME, jpks[0], jv))
    assert g1_ints(ped_case["poks"][0]) == j_affine_ints(
        jped.prove_knowledge(NAME, jpks[0], jv))


def test_pedersen_folds_match_jax(ped_case):
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu.protocols import pedersen as jped

    coeff = ped_case["coeff"]
    poks = ped_case["poks"]
    folded = pedersen.fold_commitments(NAME, poks, coeff)
    jpoks = [JAffine(*convert.point_to_jax(G1.spec.fp, p)) for p in poks]
    assert g1_ints(folded) == j_affine_ints(
        jped.fold_commitments(NAME, jpoks, coeff))
    # fold == sum coeff^i pok_i on host integers
    want = None
    for i, p in enumerate(poks):
        want = oracle_add(want, oracle_mul(g1_ints(p)[0],
                                           pow(coeff, i, R_MOD), P_MOD, 0),
                          P_MOD, 0)
    assert g1_ints(folded) == [want]
    pks = [k[0][0] for k in ped_case["keys"]]
    vals = [fr_plain(v) for v in ped_case["values"]]
    bp = pedersen.batch_prove(NAME, pks, vals, coeff)
    jpks = [jax_keys(ped_case, i)[0][0] for i in range(2)]
    jfr = jax_iop().for_spec(jspec_of(f"{NAME}_fr"))
    jvals = [jfr.from_int(v, mont=False) for v in ped_case["values"]]
    assert g1_ints(bp) == j_affine_ints(jped.batch_prove(NAME, jpks, jvals,
                                                         coeff))


def pairing_relation(monkeypatch, sigmas_of_q):
    """Replace pairing_check: for pairs (P_i, Q_i) where each Q_i is
    [-sigma_i]G or G (G = [3]G2), the product of e(P_i, Q_i) is 1 exactly
    when sum_i c_i P_i is infinity, c_i = -sigma_i or 1. ``sigmas_of_q``
    maps the pairs to their c_i."""
    seen = []

    def check(name, P, qx, qy):
        pts = g1_ints(P)
        cs = sigmas_of_q(len(pts))
        acc = None
        for p, c in zip(pts, cs):
            acc = oracle_add(acc, oracle_mul(p, c % R_MOD, P_MOD, 0),
                             P_MOD, 0)
        seen.append(pts)
        return torch.tensor(acc is None)

    monkeypatch.setattr(pedersen.pairing_api, "pairing_check", check)
    return seen


def test_pedersen_verify_with_captured_pairs(ped_case, monkeypatch):
    pairing_relation(monkeypatch, lambda n: [-SIGMA, 1])
    vk = ped_case["keys"][0][1]
    com, pok = ped_case["coms"][0], ped_case["poks"][0]
    assert bool(pedersen.verify(NAME, vk, com, pok))
    bad = Affine(pok.x, G1.fp.neg(pok.y))
    assert not bool(pedersen.verify(NAME, vk, com, bad))


def test_pedersen_batch_verify_multi_vk_with_captured_pairs(ped_case,
                                                            monkeypatch):
    seen = pairing_relation(monkeypatch,
                            lambda n: [-SIGMA, -(SIGMA + 1), 1])
    vks = [k[1] for k in ped_case["keys"]]
    coms, poks, coeff = (ped_case["coms"], ped_case["poks"],
                         ped_case["coeff"])
    assert bool(pedersen.batch_verify_multi_vk(NAME, vks, coms, poks, coeff))
    # the check's first G1 points: C_0 and [coeff]C_1
    assert seen[0][0] == g1_ints(coms[0])[0]
    assert seen[0][1] == oracle_mul(g1_ints(coms[1])[0], coeff, P_MOD, 0)
    folded = pedersen.fold_commitments(NAME, poks, coeff)
    assert bool(pedersen.batch_verify_multi_vk(NAME, vks, coms, [folded],
                                               coeff))
    bad = [poks[0], Affine(poks[1].x, G1.fp.neg(poks[1].y))]
    assert not bool(pedersen.batch_verify_multi_vk(NAME, vks, coms, bad,
                                                   coeff))
    with pytest.raises(ValueError):
        pedersen.batch_verify_multi_vk(NAME, vks, coms[:1], poks, coeff)


def test_pedersen_verify_real_pairing(ped_case):
    """The one real pairing check of this file (the plain VM executor,
    about a minute on a CPU): the honest proof of knowledge verifies."""
    vk = ped_case["keys"][0][1]
    assert bool(pedersen.verify(NAME, vk, ped_case["coms"][0],
                                ped_case["poks"][0]))
