"""The PyTorch port's field engine against the JAX engine (bn254 Fr and Fp).

Both packages take the same seeded inputs (JAX limbs carried into port words
through ``gnark_crypto_tpu_torch.convert``) and must return the same
canonical integers and the same gnark bytes: the tolerance is exact
equality. The port runs its plain versions here (CPU tensors);
``tests/test_torch_cuda.py`` holds the kernels against them on the card.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.field import api, f31, f64, kernels
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.specs import field as tfs

NAMES = ["bn254_fr", "bn254_fp"]
CPU = "cpu"


def rand_vals(q, n, seed):
    rng = random.Random(seed)
    edge = [0, 1, 2, q - 1, q - 2, (q - 1) // 2, (q + 1) // 2]
    return edge + [rng.randrange(q) for _ in range(n - len(edge))]


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """Per field: the specs of both packages, inputs as ints, as JAX limb
    arrays and as port word tensors (carried through convert)."""
    name = request.param
    jspec, tspec = jfs.get_field(name), tfs.get_field(name)
    a = rand_vals(jspec.modulus, 24, 1)
    b = rand_vals(jspec.modulus, 24, 2)[::-1]
    ja, jb = jmont.from_int(jspec, a), jmont.from_int(jspec, b)
    ta = convert.from_jax_limbs(tspec, np.asarray(ja), device=CPU)
    tb = convert.from_jax_limbs(tspec, np.asarray(jb), device=CPU)
    return dict(jspec=jspec, tspec=tspec, a=a, b=b, ja=ja, jb=jb, ta=ta,
                tb=tb)


def same(case, jax_out, port_out):
    """Equal as canonical integers (never as limb arrays)."""
    return (jmont.to_int(case["jspec"], jax_out)
            == tmont.to_int(case["tspec"], port_out))


BINARY = ["add", "sub", "mul", "inner_product"]
UNARY = ["neg", "double", "halve", "square", "inverse", "batch_inverse",
         "legendre", "sum_reduce"]


@pytest.mark.parametrize("op", BINARY)
def test_binary_ops_match_jax(case, op):
    got = getattr(tmont, op)(case["tspec"], case["ta"], case["tb"])
    want = getattr(jmont, op)(case["jspec"], case["ja"], case["jb"])
    assert same(case, want, got)


@pytest.mark.parametrize("op", UNARY)
def test_unary_ops_match_jax(case, op):
    got = getattr(tmont, op)(case["tspec"], case["ta"])
    want = getattr(jmont, op)(case["jspec"], case["ja"])
    assert same(case, want, got)


def test_to_from_mont_match_jax(case):
    """to_mont of plain values and from_mont of Montgomery values give the
    same integers in both packages (whatever their radix)."""
    t, j = case["tspec"], case["jspec"]
    tp = tmont.from_int(t, case["a"], mont=False, device=CPU)
    jp = jmont.from_int(j, case["a"], mont=False)
    assert same(case, jmont.to_mont(j, jp), tmont.to_mont(t, tp))
    assert (jmont.to_int(j, jmont.from_mont(j, case["ja"]), mont=False)
            == tmont.to_int(t, tmont.from_mont(t, case["ta"]), mont=False)
            == case["a"])


@pytest.mark.parametrize("c", [0, 1, 3, 13])
def test_mul_const_matches_jax(case, c):
    got = tmont.mul_const(case["tspec"], case["ta"], c)
    want = jmont.mul_const(case["jspec"], case["ja"], c)
    assert same(case, want, got)


def test_exp_const_matches_jax(case):
    e = (1 << 200) + 12345678901234567
    got = tmont.exp_const(case["tspec"], case["ta"], e)
    want = jmont.exp_const(case["jspec"], case["ja"], e)
    assert same(case, want, got)


def test_sqrt_matches_jax(case):
    root, ok = tmont.sqrt(case["tspec"], case["ta"])
    jroot, jok = jmont.sqrt(case["jspec"], case["ja"])
    assert ok.tolist() == np.asarray(jok).tolist()
    assert same(case, jroot, root)
    q = case["tspec"].modulus
    for v, r, o in zip(case["a"], tmont.to_int(case["tspec"], root),
                       ok.tolist()):
        assert (r * r % q == v) if o else r == 0


def test_predicates_zeros_ones(case):
    t, ta, tb = case["tspec"], case["ta"], case["tb"]
    assert tmont.is_zero(t, ta).tolist() == [v == 0 for v in case["a"]]
    assert tmont.equal(t, ta, tb).tolist() == [
        u == v for u, v in zip(case["a"], case["b"])]
    sel = tmont.select(t, tmont.is_zero(t, ta), tb, ta)
    assert tmont.to_int(t, sel) == [v if u == 0 else u
                                    for u, v in zip(case["a"], case["b"])]
    assert tmont.to_int(t, tmont.ones(t, (3,), device=CPU)) == [1, 1, 1]
    assert tmont.to_int(t, tmont.zeros(t, (2,), device=CPU)) == [0, 0]
    assert tmont.to_int(t, tmont.ones(t, device=CPU)) == 1


def test_int_roundtrip_and_convert(case):
    t = case["tspec"]
    x = tmont.from_int(t, case["a"], device=CPU)
    assert tmont.to_int(t, x) == case["a"]
    assert torch.equal(x, case["ta"])
    # port words -> JAX limbs -> same integers in the JAX engine
    back = convert.to_jax_limbs(t, x)
    assert jmont.to_int(case["jspec"], back) == case["a"]
    # non-canonical JAX limbs (every 12-bit limb full) reduce mod q
    q = t.modulus
    wide = np.full((1, t.n_limbs), (1 << t.limb_bits) - 1, np.int32)
    jax_vals = jmont.to_int(case["jspec"], wide)
    assert tmont.to_int(t, convert.from_jax_limbs(t, wide, device=CPU)) \
        == [v % q for v in jax_vals]
    plain = convert.from_jax_limbs(t, wide, mont_form=False, device=CPU)
    assert tmont.to_int(t, plain, mont=False) == [
        ((1 << (t.limb_bits * t.n_limbs)) - 1) % q]


def test_bytes_codec_matches_jax(case):
    t, j = case["tspec"], case["jspec"]
    bs = tmont.to_bytes_host(t, case["ta"])
    assert bs == jmont.to_bytes_host(j, case["ja"])
    assert bs == [v.to_bytes(t.n_bytes, "big") for v in case["a"]]
    back = tmont.from_bytes_host(t, bs, device=CPU)
    assert torch.equal(back, case["ta"])
    plain = tmont.from_bytes_host(t, bs, mont=False, device=CPU)
    assert tmont.to_bytes_host(t, plain, mont=False) == bs
    q = t.modulus
    for bad in (q, q + 1, (1 << (8 * t.n_bytes)) - 1):
        with pytest.raises(ValueError):
            tmont.from_bytes_host(t, bs[:2] + [bad.to_bytes(t.n_bytes, "big")],
                                  device=CPU)
        with pytest.raises(ValueError):
            jmont.from_bytes_host(j, [bad.to_bytes(j.n_bytes, "big")])


def test_mont_mul_matches_jax_pallas_interpret():
    """The plain CIOS against the TPU kernel itself, in interpret mode."""
    from gnark_crypto_tpu.field.pallas.mont_mul import mont_mul

    j, t = jfs.BN254_FR, tfs.BN254_FR
    a = rand_vals(j.modulus, 16, 3)
    b = rand_vals(j.modulus, 16, 4)
    ja, jb = jmont.from_int(j, a), jmont.from_int(j, b)
    want = mont_mul(j, ja, jb, interpret=True)
    got = kernels.mont_mul(
        t, convert.from_jax_limbs(t, np.asarray(ja), device=CPU),
        convert.from_jax_limbs(t, np.asarray(jb), device=CPU))
    assert jmont.to_int(j, want) == tmont.to_int(t, got)
    assert tmont.to_int(t, got) == [u * v % j.modulus for u, v in zip(a, b)]


@pytest.mark.parametrize("which", ["inverse", "cube", "legendre"])
def test_exp_const_matches_jax_pallas_interpret(which):
    """The plain ladder of field/exp.py against the TPU kernel in interpret
    mode (tests/test_pallas_kernels.py:46), 0 -> 0 included."""
    from gnark_crypto_tpu.field.pallas.exp import exp_const_pallas
    from gnark_crypto_tpu_torch.field import exp

    j, t = jfs.BN254_FR, tfs.BN254_FR
    q = j.modulus
    e = {"inverse": q - 2, "cube": 3, "legendre": (q - 1) // 2}[which]
    vals = rand_vals(q, 8, 7)
    jx = jmont.from_int(j, vals)
    want = exp_const_pallas(j, jx, e, interpret=True)
    got = exp.exp_const(t, convert.from_jax_limbs(t, np.asarray(jx),
                                                  device=CPU), e)
    assert jmont.to_int(j, want) == tmont.to_int(t, got)
    assert tmont.to_int(t, got) == [pow(v, e, q) for v in vals]


def test_exp_const_entry_points():
    """mont.exp_const keeps the batch shape; e = 0 gives one, as in the JAX
    engine; inverse maps 0 -> 0."""
    t = tfs.BN254_FP
    q = t.modulus
    x = tmont.from_int(t, [0, 2, q - 1, 5], device=CPU).reshape(2, 2, 8)
    assert tmont.exp_const(t, x, 0).shape == (2, 2, 8)
    assert tmont.to_int(t, tmont.exp_const(t, x, 0).reshape(-1, 8)) == [1] * 4
    assert tmont.to_int(t, tmont.inverse(t, x).reshape(-1, 8)) == [
        0, pow(2, -1, q), q - 1, pow(5, -1, q)]
    assert tmont.to_int(t, tmont.exp_const(t, x[1, 0], 1 << 300)) == pow(
        q - 1, 1 << 300, q)
    with pytest.raises(ValueError):
        tmont.exp_const(t, x, -1)


def test_spec_word_constants():
    for name in NAMES:
        t, j = tfs.get_field(name), jfs.get_field(name)
        assert (t.modulus, t.limb_bits, t.n_limbs, t.n_bytes,
                t.two_adicity, t.generator, t.two_adic_root) == (
            j.modulus, j.limb_bits, j.n_limbs, j.n_bytes, j.two_adicity,
            j.generator, j.two_adic_root)
        assert t.n_words == 8 and t.r == (1 << 256) % t.modulus
        assert (t.modulus * t.qinv32) % (1 << 32) == (1 << 32) - 1
        assert (t.modulus * t.qinv16) % (1 << 16) == (1 << 16) - 1
        assert t.r * t.r_inv % t.modulus == 1
    assert set(tfs.all_fields()) == set(jfs.all_fields())


def test_plain_mul_other_word_counts():
    """The plain CIOS is generic in W: 12 words for bls12-381 Fp, 24 for
    bw6-761 Fp, and secp256k1 Fp fills all 256 bits of its 8 words."""
    for spec in (tfs.BLS12_381_FP, tfs.SECP256K1_FP, tfs.BW6_761_FP):
        q = spec.modulus
        a, b = rand_vals(q, 12, 5), rand_vals(q, 12, 6)
        x = tmont.from_int(spec, a, device=CPU)
        y = tmont.from_int(spec, b, device=CPU)
        assert tmont.to_int(spec, tmont.mul(spec, x, y)) == [
            u * v % q for u, v in zip(a, b)]


def test_field_engine_facade():
    eng = api.for_field("bn254_fr")
    assert eng is api.for_spec(tfs.BN254_FR)
    q = eng.spec.modulus
    x = eng.from_int([4, 5, q - 1], device=CPU)  # 5 generates Fr^*
    assert eng.eshape(x) == (3,)
    assert eng.to_int(eng.mul(x, x)) == [16, 25, 1]
    assert eng.is_square(x).tolist() == [True, False,
                                         pow(q - 1, (q - 1) // 2, q) == 1]
    assert eng.sgn0(x).tolist() == [0, 1, (q - 1) & 1]
    assert eng.to_int(eng.tile_lead(x[:1], 2)) == [4, 4]
    # the small fields have engines of their own: f31 (no word axis) for
    # koalabear and babybear, f64 (two words) for goldilocks
    for name, impl, dims in (("koalabear", f31, 0), ("babybear", f31, 0),
                             ("goldilocks", f64, 1)):
        small = api.for_field(name)
        assert small is api.for_spec(tfs.get_field(name))
        assert (small.impl, small.elem_dims) == (impl, dims)
        v = small.from_int([2, 3], device=CPU)
        assert small.eshape(v) == (2,)
        assert small.to_int(small.mul(v, v)) == [4, 9]


def test_cpu_tensors_never_launch():
    before = kernels.mont_mul.launches
    t = tfs.BN254_FR
    x = tmont.from_int(t, [3, 4], device=CPU)
    tmont.mul(t, x, x)
    assert kernels.mont_mul.launches == before
