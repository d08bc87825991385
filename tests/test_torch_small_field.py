"""The port's small-field engines against the JAX package (CPU).

koalabear and babybear (``field/f31.py``: one int32 per element) and
goldilocks (``field/f64.py``: two int32 words) against
``gnark_crypto_tpu/field/f31.py`` and ``f64.py`` on the same seeded inputs,
the edge values 0, 1, 2, q-1, q-2 and (q+-1)/2 among them. Results are
compared as canonical integers or gnark bytes; the tolerance is exact
equality (a field has no rounding). Also: the spec repair (R = 2^32 for
the 31-bit fields), the bit-view conversion of ``convert.py``, and the
extension towers of ``towers/smallfield.py`` against the JAX towers.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import api as japi
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu.towers import smallfield as jsf
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.field import api as tapi
from gnark_crypto_tpu_torch.field import f64 as tf64
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.specs import field as tfs
from gnark_crypto_tpu_torch.towers import smallfield as tsf

CPU = "cpu"
FIELDS = ["koalabear", "babybear", "goldilocks"]


def values(q, n, seed):
    rng = random.Random(seed)
    edge = [0, 1, 2, q - 1, q - 2, (q - 1) // 2, (q + 1) // 2]
    return edge + [rng.randrange(q) for _ in range(n - len(edge))]


@pytest.fixture(scope="module", params=FIELDS)
def pair(request):
    """(JAX engine, port engine, x values, y values) of one field."""
    je, te = japi.for_field(request.param), tapi.for_field(request.param)
    q = je.spec.modulus
    xs = values(q, 24, 1)
    ys = values(q, 24, 2)[::-1]
    return je, te, xs, ys


def both(je, te, vals, mont=True):
    return je.from_int(vals, mont=mont), te.from_int(vals, mont=mont,
                                                     device=CPU)


def test_ring_ops_match_jax(pair):
    je, te, xs, ys = pair
    (jx, tx), (jy, ty) = both(je, te, xs), both(je, te, ys)
    for op in ("add", "sub", "mul"):
        assert te.to_int(getattr(te, op)(tx, ty)) == je.to_int(
            getattr(je, op)(jx, jy)), op
    for op in ("neg", "double", "halve", "square", "to_mont", "from_mont"):
        assert te.to_int(getattr(te, op)(tx)) == je.to_int(
            getattr(je, op)(jx)), op
    for c in (0, 1, 3, 11, te.spec.modulus - 1):
        assert te.to_int(te.mul_const(tx, c)) == je.to_int(
            je.mul_const(jx, c)), c
    assert te.to_int(tx) == xs and te.to_int(tx, mont=False) == je.to_int(
        jx, mont=False)
    assert te.to_int(te.ones((3,), device=CPU)) == [1, 1, 1]
    assert te.to_int(te.zeros((2,), device=CPU)) == [0, 0]
    # one element keeps the engine's element shape
    assert te.eshape(te.from_int(5, device=CPU)) == ()
    assert te.to_int(te.from_int(5, device=CPU)) == 5


def test_exp_inverse_sqrt_match_jax(pair):
    je, te, xs, _ = pair
    jx, tx = both(je, te, xs)
    for op in ("inverse", "batch_inverse", "legendre"):
        assert te.to_int(getattr(te, op)(tx)) == je.to_int(
            getattr(je, op)(jx)), op
    for e in (0, 1, 2, 12345, te.spec.modulus - 2):
        assert te.to_int(te.exp_const(tx, e)) == je.to_int(
            je.exp_const(jx, e)), e
    jr, jok = je.sqrt(jx)
    tr, tok = te.sqrt(tx)
    assert te.to_int(tr) == je.to_int(jr)
    assert tok.tolist() == np.asarray(jok).tolist()
    assert te.is_square(tx).tolist() == np.asarray(je.is_square(jx)).tolist()
    assert te.sgn0(tx).tolist() == np.asarray(je.sgn0(jx)).tolist()


def test_predicates_and_reductions_match_jax(pair):
    je, te, xs, ys = pair
    (jx, tx), (jy, ty) = both(je, te, xs), both(je, te, ys)
    assert te.is_zero(tx).tolist() == np.asarray(je.is_zero(jx)).tolist()
    assert te.equal(tx, ty).tolist() == np.asarray(je.equal(jx, jy)).tolist()
    cond = [i % 3 == 0 for i in range(len(xs))]
    assert te.to_int(te.select(torch.tensor(cond), tx, ty)) == je.to_int(
        je.select(jnp.asarray(cond), jx, jy))
    assert te.to_int(te.sum_reduce(tx)) == je.to_int(je.sum_reduce(jx))
    assert te.to_int(te.inner_product(tx, ty)) == je.to_int(
        je.inner_product(jx, jy))
    # batched leading dims
    t2 = te.reshape(tx, (4, 6))
    assert te.eshape(t2) == (4, 6)
    assert te.to_int(te.sum_reduce(t2)) == je.to_int(
        je.sum_reduce(je.reshape(jx, (4, 6))))


def test_byte_codec_matches_jax(pair):
    je, te, xs, _ = pair
    q = te.spec.modulus
    for n in (len(xs), 80):  # 80 takes the JAX bulk tier of the 31-bit codec
        vals = values(q, n, 7)
        jx, tx = both(je, te, vals)
        bs = je.to_bytes_host(jx)
        assert te.to_bytes_host(tx) == bs
        assert te.to_bytes_host(tx, mont=False) == je.to_bytes_host(
            jx, mont=False)
        assert torch.equal(te.from_bytes_host(bs, device=CPU), tx)
        assert te.to_int(te.from_bytes_host(bs, mont=False, device=CPU),
                         mont=False) == vals
    with pytest.raises(ValueError):
        te.from_bytes_host([q.to_bytes(te.spec.n_bytes, "big")], device=CPU)
    with pytest.raises(ValueError):
        te.from_bytes_host([b"\x01"], device=CPU)


def test_raw_values_match_jax(pair):
    """reduce=False keeps raw scalars >= q, as the JAX engines do."""
    je, te, _, _ = pair
    bits = 32 if te.elem_dims == 0 else 64
    raw = [0, 1, te.spec.modulus, (1 << bits) - 1]
    jx = je.from_int(raw, mont=False, reduce=False)
    tx = te.from_int(raw, mont=False, reduce=False, device=CPU)
    assert te.to_int(tx, mont=False) == je.to_int(jx, mont=False)
    with pytest.raises(ValueError):
        te.from_int([1], mont=True, reduce=False, device=CPU)


def test_spec_repair_matches_jax():
    """R = 2^32 for the 31-bit fields (one word), 2^64 for goldilocks (two
    words), as the JAX spec and gnark have it; every multi-word spec keeps
    R = 2^(64 * ceil(bits / 64))."""
    for name in FIELDS:
        t, j = tfs.get_field(name), jfs.get_field(name)
        assert (t.r, t.r2, t.r_inv) == (j.r, j.r2, j.r_inv)
        assert t.n_words == j.n_limbs == (1 if name != "goldilocks" else 2)
        assert t.qinv32 == j.qinv_neg
    for t in tfs.all_fields().values():
        if t.bit_length > 64:
            W = 2 * -(-t.bit_length // 64)
            assert t.n_words == W and t.r == (1 << (32 * W)) % t.modulus


def test_engine_facade_dispatch():
    kb, gl = tapi.for_field("koalabear"), tapi.for_field("goldilocks")
    assert kb.elem_dims == 0 and gl.elem_dims == 1
    assert tapi.for_field("bn254_fr").elem_dims == 1
    x = kb.from_int([3, 4], device=CPU)
    assert x.dtype == torch.int32 and tuple(x.shape) == (2,)
    assert kb.to_int(kb.where(torch.tensor([True, False]), x,
                              kb.tile_lead(x[:1], 2))) == [3, 3]
    y = gl.from_int([3, 4], device=CPU)
    assert tuple(y.shape) == (2, 2)
    assert gl.to_int(gl.broadcast_to(y[0], (3,))) == [3, 3, 3]


def test_f64_words_equal_word_engine():
    """goldilocks elements are the word engine's (n, 2) words."""
    vals = values(tfs.GOLDILOCKS.modulus, 16, 3)
    for mont_form in (True, False):
        assert torch.equal(
            tf64.from_int(tfs.GOLDILOCKS, vals, mont=mont_form, device=CPU),
            tmont.from_int(tfs.GOLDILOCKS, vals, mont=mont_form, device=CPU))


def test_convert_round_trips(pair):
    je, te, xs, _ = pair
    spec = te.spec
    jx = je.from_int(xs)
    got = convert.from_jax_small(spec, np.asarray(jx), device=CPU)
    assert te.to_int(got) == xs
    assert torch.equal(convert.from_jax_limbs(spec, np.asarray(jx),
                                              device=CPU), got)
    back = convert.to_jax_small(spec, got)
    assert back.dtype == np.uint32 and np.array_equal(back, np.asarray(jx))
    assert np.array_equal(convert.to_jax_limbs(spec, got), back)
    with pytest.raises(ValueError):
        convert.from_jax_small(tfs.BN254_FR, back)


TOWERS = [("koalabear", "e2"), ("koalabear", "e4"), ("koalabear", "e6"),
          ("babybear", "e2"), ("babybear", "e4"), ("babybear", "e6"),
          ("goldilocks", "e2")]


@pytest.mark.parametrize("field,tower", TOWERS)
def test_ext_engines_match_jax(field, tower):
    """mul, square, inverse, add, sub of E2/E4/E6 against the JAX towers,
    and the field laws the JAX tests check."""
    je, te = getattr(jsf, tower)(field), getattr(tsf, tower)(field, CPU)
    q = tfs.get_field(field).modulus
    rng = random.Random(TOWERS.index((field, tower)))

    def rand_elem(eng):
        if hasattr(eng, "degree"):
            return tuple(rand_elem(eng.base) for _ in range(eng.degree))
        return rng.randrange(q)

    xs = [rand_elem(te) for _ in range(3)]
    ys = [rand_elem(te) for _ in range(3)]
    jx = jnp.stack([je.from_int(v) for v in xs])
    jy = jnp.stack([je.from_int(v) for v in ys])
    tx, ty = te.from_int(xs), te.from_int(ys)

    def tints(eng, x):
        return [eng.to_int(x[i]) for i in range(3)]

    for op in ("mul", "add", "sub"):
        assert tints(te, getattr(te, op)(tx, ty)) == tints(
            je, getattr(je, op)(jx, jy)), op
    for op in ("square", "inverse", "neg"):
        assert tints(te, getattr(te, op)(tx)) == tints(
            je, getattr(je, op)(jx)), op
    one = te.broadcast_to(te.ones(), (3,))
    assert torch.equal(te.mul(tx, te.inverse(tx)), one)
    assert torch.equal(te.mul(tx, te.add(ty, tx)),
                       te.add(te.mul(tx, ty), te.square(tx)))
