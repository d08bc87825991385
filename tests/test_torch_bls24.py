"""bls24-315 and bls24-317 in the port, at 10-word Fp, on the CPU.

* Which kernels take which fields: the field, exponent, G1 point and VM
  kernels are built at 8, 10, 12, 20 and 24 words, so they take bls24 Fp
  (and bw6-633 Fr, bls24-315's Fp); the Fp2 and NTT kernels take no
  10-word field, and only the field, exponent and G1 point kernels take
  secp256k1/r1. What the 10-word
  kernels receive from the host, against Python integers.
* The field at bls24 Fp against Python integers and the JAX engine.
* ``towers/tower24.py`` against the JAX ``Tower24`` on the same seeded
  inputs, and the GT codec, the subgroup check and ``gt_exp`` from the
  golden gnark bytes (``tests/fixtures/gt_golden.json``).
* G1 (``msm``, ``batch_scalar_mul``) on the plain point versions and G2
  over E4 (``scalar_mul``) against Python-int oracles and the JAX package.
* KZG over bls24-317 at n = 8 without a pairing (``commit``,
  ``open_poly``); ``verify`` and a pairing against the golden bytes run on
  the plain VM executor in the tests marked ``slow``.

The VM programs are held in ``tests/test_torch_bls24_vm.py``. Values cross
as canonical integers or gnark bytes; the tolerance is 0.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.msm import pippenger as jpp
from gnark_crypto_tpu.specs import curve as jcs
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.field import exp, kernels, mont, point_add
from gnark_crypto_tpu_torch.field import point_add2, vm
from gnark_crypto_tpu_torch.io import gt_bytes
from gnark_crypto_tpu_torch.msm import pippenger as tpp
from gnark_crypto_tpu_torch.ntt import radix2
from gnark_crypto_tpu_torch.pairing import api, vm_pairing
from gnark_crypto_tpu_torch.specs import curve as tcs
from gnark_crypto_tpu_torch.specs import field as tfs
from gnark_crypto_tpu_torch.towers.tower24 import get_tower24
from gnark_crypto_tpu_torch.utils import build
from tests.test_curve_g1 import oracle_add, oracle_mul, rand_points

CPU = "cpu"
CURVES = ["bls24_315", "bls24_317"]
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "gt_golden.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the plain versions are
    thousands of small tensor ops, and with several test workers PyTorch's
    thread pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words_int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


# -- the width check ---------------------------------------------------------

TEN_WORDS = ["bls24_315_fp", "bls24_317_fp", "bw6_633_fr"]
# bw6 Fp: admitted by the field kernels since their 20- and 24-word
# instantiations, refused by the NTT and Fp2 ones; secp256k1/r1 refused by
# every kernel but the field, exponent and G1 point ones
STILL_REFUSED = [("bw6_633_fp", 20), ("bw6_761_fp", 24),
                 ("secp256k1_fp", 8), ("secp256k1_fr", 8),
                 ("secp256r1_fp", 8), ("secp256r1_fr", 8)]


@pytest.mark.parametrize("name", TEN_WORDS)
def test_field_kernels_take_10_words(name):
    """The field, exponent, G1 point, VM and NTT wrappers take the 10-word
    fields (q < 2^(32W-1)); the Fp2 kernels were not built at 10."""
    spec = tfs.get_field(name)
    assert spec.n_words == 10
    assert kernels.FIELD_WIDTHS == (8, 10, 12, 20, 24)
    assert spec.modulus < 1 << (32 * 10 - 1)
    kernels.check_width(spec, "mont_mul", kernels.FIELD_WIDTHS)
    kernels.check_width(spec, "ntt_four_step", radix2.WIDTHS)
    with pytest.raises(NotImplementedError):
        kernels.check_width(spec, "10-word kernel", point_add2.WIDTHS)


@pytest.mark.parametrize("name,words", STILL_REFUSED)
def test_kernels_still_refuse_bw6_and_secp(name, words):
    """secp256k1/r1 (8 words, q >= 2^255) are refused by the VM, NTT and
    Fp2 kernels, and taken by the field kernels at their full width; bw6 Fp
    (20 and 24 words) by the NTT and Fp2 kernels only, which no field of
    that width needs, and the field kernels take it. No message names a
    ROADMAP width still to build: none is left."""
    spec = tfs.get_field(name)
    assert spec.n_words == words
    refused = (radix2.WIDTHS, point_add2.WIDTHS)
    if words == 8:
        refused += (kernels.FIELD_WIDTHS,)  # the VM's check
    kernels.check_width(spec, "mont_mul", kernels.FIELD_WIDTHS,
                        kernels.FULL_WIDTHS)
    for widths in refused:
        with pytest.raises(NotImplementedError) as info:
            kernels.check_width(spec, "kernel", widths)
        assert "ROADMAP" not in str(info.value)
        assert ("q < 2^(32W-1)" in str(info.value))


@pytest.mark.parametrize("nr", [-1, 13, -5])
@pytest.mark.parametrize("name", ["bls24_315_fp", "bls24_317_fp"])
def test_fp2_kernels_refuse_10_words(name, nr):
    """bls24's G2 is over Fp4: no Fp2 kernel is built at 10 words, and the
    check refuses before any launch."""
    spec = tfs.get_field(name)
    coords = [torch.zeros((3, 2, 10), dtype=torch.int32) for _ in range(3)]
    with pytest.raises(NotImplementedError):
        point_add2._check(spec, nr, "jac_double2", *coords)


def test_kernel_args_align_to_8_bytes_at_10_words():
    """A 10-word row is 40 bytes: the kernels load 8 bytes at a time, so
    an (N, 10) slice from an odd row passes the check; a 4-byte offset
    does not, nor does a 4-byte offset at 8 words."""
    assert kernels.load_align(10) == 8 and kernels.load_align(8) == 16
    assert kernels.load_align(12) == 16
    spec = tfs.BLS24_315_FP
    x = torch.zeros((5, 10), dtype=torch.int32)
    kernels.check_kernel_args(spec, "mont_mul", x[1:], x[1:],
                              widths=kernels.FIELD_WIDTHS)
    assert x[1:].data_ptr() % 16 == (x.data_ptr() + 40) % 16
    bad = torch.zeros(41, dtype=torch.int32)[1:].view(4, 10)
    with pytest.raises(ValueError):
        kernels.check_kernel_args(spec, "mont_mul", bad,
                                  widths=kernels.FIELD_WIDTHS)
    bad8 = torch.zeros(33, dtype=torch.int32)[1:].view(4, 8)
    with pytest.raises(ValueError):
        kernels.check_kernel_args(tfs.BN254_FP, "mont_mul", bad8,
                                  widths=kernels.FIELD_WIDTHS)


@pytest.mark.parametrize("name", ["bls24_315_fp", "bls24_317_fp"])
def test_launch_args_at_10_words(name):
    spec = tfs.get_field(name)
    q, W = spec.modulus, 10
    assert spec.n_words == W and q < 1 << (32 * W - 1)
    fw = list(build.field_words(spec))
    assert len(fw) == W + 1 and words_int(fw[:W]) == q
    assert q * fw[W] % (1 << 32) == (1 << 32) - 1        # -q^-1 mod 2^32
    assert words_int(spec.one_words) == (1 << (32 * W)) % q
    words, nbits = exp.exponent_words(spec, q - 2)
    assert len(words) == W and words_int(words) == q - 2
    assert nbits == q.bit_length()
    big = (q - 2) + 5 * (q - 1) + (1 << 330)  # past 2^320: reduced mod q-1
    words, nbits = exp.exponent_words(spec, big)
    e = words_int(words)
    assert 1 <= e < q and (e - big) % (q - 1) == 0 and nbits == e.bit_length()
    cw, a_is_zero = point_add._curve_args(spec, 0)
    assert list(cw) == [0] * W + list(spec.one_words) and a_is_zero == 1
    cw, a_is_zero = point_add._curve_args(spec, 3)
    assert words_int(list(cw)[:W]) == 3 * (1 << (32 * W)) % q
    assert a_is_zero == 0


@pytest.mark.parametrize("name", CURVES)
def test_vm_entry_constants_at_10_words(name):
    """The entry rows of a bls24 pairing program: each constant in
    Montgomery form (R = 2^320) at its register, inputs zero."""
    prog = vm_pairing.build_program(name, "miller")
    spec = prog.spec
    assert spec.n_words == 10
    rows = vm._entry_consts(prog, CPU).numpy().view(np.uint32)
    assert rows.shape == (prog.n_entry, 10)
    consts = dict(prog.entry_consts)
    assert consts and len(consts) + len(prog.entry_inputs) == prog.n_entry
    for reg in range(prog.n_entry):
        want = consts.get(reg, 0) * (1 << 320) % spec.modulus
        assert words_int(rows[reg]) == want
    assert vm.reg_cap(spec) == 181


# -- the field ---------------------------------------------------------------

def field_values(q, seed):
    rng = random.Random(seed)
    return [0, 1, q - 1, (q - 1) // 2, (q + 1) // 2, 2] + [
        rng.randrange(q) for _ in range(10)]


@pytest.mark.parametrize("name", ["bls24_315_fp", "bls24_317_fp"])
def test_field_ops_match_ints_and_jax(name):
    """mont_mul_plain, add, sub, inverse and exp_const on 16 values, against
    Python integers and the JAX field engine."""
    spec, jspec = tfs.get_field(name), jfs.get_field(name)
    q = spec.modulus
    a = field_values(q, 1)
    b = field_values(q, 2)[::-1]
    x, y = (mont.from_int(spec, v, device=CPU) for v in (a, b))
    jx, jy = (jmont.from_int(jspec, v) for v in (a, b))
    e = (q - 1) // 2 + 12345
    got = {
        "mul": mont.to_int(spec, kernels.mont_mul_plain(spec, x, y)),
        "add": mont.to_int(spec, mont.add(spec, x, y)),
        "sub": mont.to_int(spec, mont.sub(spec, x, y)),
        "inverse": mont.to_int(spec, mont.inverse(spec, x)),
        "exp": mont.to_int(spec, exp.exp_const(spec, x, e)),
    }
    want = {
        "mul": [u * v % q for u, v in zip(a, b)],
        "add": [(u + v) % q for u, v in zip(a, b)],
        "sub": [(u - v) % q for u, v in zip(a, b)],
        "inverse": [pow(u, q - 2, q) for u in a],
        "exp": [pow(u, e, q) for u in a],
    }
    jgot = {
        "mul": jmont.to_int(jspec, jmont.mul(jspec, jx, jy)),
        "add": jmont.to_int(jspec, jmont.add(jspec, jx, jy)),
        "sub": jmont.to_int(jspec, jmont.sub(jspec, jx, jy)),
        "inverse": jmont.to_int(jspec, jmont.inverse(jspec, jx)),
    }
    assert got == want
    assert jgot == {k: want[k] for k in jgot}


MULTI_WORD = [name for name, spec in tfs.all_fields().items()
              if spec.limb_bits != 32]


@pytest.mark.parametrize("name", MULTI_WORD)
def test_field_add_sub_carry_lookahead(name):
    """``mont.add`` and ``mont.sub`` run their carry and borrow chains by
    lookahead (one integer addition over the packed generate and propagate
    bits): held against Python integers at every multi-word width, on values
    whose words are all ones or all zeros in runs (the long propagate
    chains), and broadcast over leading dims."""
    spec = tfs.get_field(name)
    q, W = spec.modulus, spec.n_words
    runs = [v for k in range(W + 1) for v in (
        (1 << (32 * k)) - 1, q - (1 << (32 * k)), (q - 1) >> (32 * k),
        q - 1 - ((1 << (32 * k)) - 1)) if 0 <= v < q]
    rng = random.Random(W)
    vals = [0, 1, 2, q - 1, q - 2, (q - 1) // 2, (q + 1) // 2] + runs
    a = vals + [rng.choice(vals) for _ in range(200)]
    b = vals[::-1] + [rng.choice(vals) for _ in range(200)]
    x, y = (mont.from_int(spec, v, mont=False, device=CPU) for v in (a, b))
    assert mont.to_int(spec, mont.add(spec, x, y), mont=False) == [
        (u + v) % q for u, v in zip(a, b)]
    assert mont.to_int(spec, mont.sub(spec, x, y), mont=False) == [
        (u - v) % q for u, v in zip(a, b)]
    assert mont.to_int(spec, mont.neg(spec, x), mont=False) == [
        -u % q for u in a]
    grid = mont.add(spec, x[:6, None], y[None, :5])
    assert mont.to_int(spec, grid.reshape(-1, W), mont=False) == [
        (u + v) % q for u in a[:6] for v in b[:5]]


# -- Tower24 against the JAX Tower24 -----------------------------------------

def rand_e24_ints(p, n, seed):
    rng = random.Random(seed)

    def e4():
        return ((rng.randrange(p), rng.randrange(p)),
                (rng.randrange(p), rng.randrange(p)))

    return [tuple(tuple(e4() for _ in range(3)) for _ in range(2))
            for _ in range(n)]


def towers(name):
    from gnark_crypto_tpu.towers.tower24 import get_tower24 as jget_tower24

    return get_tower24(name, CPU), jget_tower24(name)


def e24_pair(tw, jtw, vals):
    """The same E24 values in both packages."""
    x = tw.e12.from_int(vals, device=CPU)
    jx = np.stack([np.asarray(jtw.e12.from_int(v)) for v in vals])
    return x, jx


def same(tw, got, jgot) -> bool:
    """Equal as canonical integers (the word and limb radices differ)."""
    spec = tw.fp_spec
    want = convert.from_jax_limbs(spec, np.asarray(jgot), device=CPU)
    return bool(torch.equal(got, want))


def cyclotomic(tw, x):
    """x^((p^12 - 1)(p^4 + 1)): into the cyclotomic subgroup."""
    e24 = tw.e12
    y = e24.mul(tw.conjugate(x), e24.inverse(x))
    return e24.mul(tw.frobenius_quad(y), y)


@pytest.mark.parametrize("name", CURVES)
def test_tower24_field_ops_match_jax(name):
    """E24 mul, square and inverse, and the four Frobenius maps, equal the
    JAX Tower24's on the same inputs; x * x^-1 == 1."""
    tw, jtw = towers(name)
    x, jx = e24_pair(tw, jtw, rand_e24_ints(tw.p, 2, 1))
    y, jy = e24_pair(tw, jtw, rand_e24_ints(tw.p, 2, 2))
    e24, je24 = tw.e12, jtw.e12
    assert same(tw, e24.mul(x, y), je24.mul(jx, jy))
    assert same(tw, e24.square(x), je24.square(jx))
    inv = e24.inverse(x)
    assert same(tw, inv, je24.inverse(jx))
    assert bool(e24.equal(e24.mul(x, inv), e24.ones(device=CPU)).all())
    for fn in ("frobenius", "frobenius_square", "frobenius_cube",
               "frobenius_quad"):
        assert same(tw, getattr(tw, fn)(x), getattr(jtw, fn)(jx)), fn
    assert torch.equal(tw.frobenius_square(x),
                       tw.frobenius(tw.frobenius(x)))


def jax_exp_cyclotomic(jtw, x, e):
    """The JAX Tower24's ``exp_cyclotomic`` ladder (MSB first, cyclotomic
    squares), run eagerly: its own method compiles the ladder's steps,
    minutes on the CPU at E24."""
    res = x
    for bit in bin(e)[3:]:
        res = jtw.cyclotomic_square(res)
        if bit == "1":
            res = jtw.e12.mul(res, x)
    return res


def test_e24_product_is_one_batched_base_product(monkeypatch):
    """On word tensors the tower stacks a product's base products: an E24
    product over bls24-317 (u^2 = -1, v^2 = 1 + u: no product in its
    non-residues) is one ``mont_mul`` call of 162 products a lane, where
    the per-coefficient order would make 162 calls; the same values."""
    tw = get_tower24("bls24_317", CPU)
    x = tw.e12.from_int(rand_e24_ints(tw.p, 2, 7), device=CPU)
    y = tw.e12.from_int(rand_e24_ints(tw.p, 2, 8), device=CPU)
    calls = []

    def counted(spec, a, b):
        calls.append(a.shape[0])
        return kernels.mont_mul_plain(spec, a, b)

    monkeypatch.setattr(mont, "mont_mul", counted)
    got = tw.e12.mul(x, y)
    assert calls == [162 * 2]
    # the per-coefficient order of the symbolic engines, on the same tensors
    for eng in (tw.e2_fp, tw.e2, tw.e6, tw.e12):
        monkeypatch.setitem(eng.__dict__, "_flat", None)
    calls.clear()
    assert torch.equal(tw.e12.mul(x, y), got)
    assert len(calls) == 162


@pytest.mark.parametrize("name", CURVES)
def test_tower24_cyclotomic_ops_match_jax(name):
    """cyclotomic_square == square on the cyclotomic subgroup and equals
    the JAX Tower24's; exp_cyclotomic equals the JAX ladder (the seed's
    ladder runs in the GT tests' subgroup check)."""
    tw, jtw = towers(name)
    x, jx = e24_pair(tw, jtw, rand_e24_ints(tw.p, 1, 3))
    y, jy = cyclotomic(tw, x), cyclotomic(jtw, jx)
    assert same(tw, y, jy)
    sq = tw.cyclotomic_square(y)
    assert torch.equal(sq, tw.e12.square(y))
    assert same(tw, sq, jtw.cyclotomic_square(jy))
    e = 0xB5
    assert same(tw, tw.exp_cyclotomic(y, e), jax_exp_cyclotomic(jtw, jy, e))
    one = tw.e12.ones(device=CPU)
    assert bool(tw.e12.equal(tw.e12.mul(y, tw.inverse_cyclotomic(y)), one))


@pytest.mark.parametrize("name", CURVES)
def test_tower24_sparse_line_products_match_jax(name):
    """The Miller-line products at the E4 level (mul_by_34 for the D-twist,
    mul_by_014 for the M-twist, and mul_by_034 beside them) equal the JAX
    Tower24's and the dense E24 products (tests/test_tower24.py:104-165)."""
    tw, jtw = towers(name)
    e4, je4 = tw.e2, jtw.e2
    rng = random.Random(11)
    p = tw.p

    def e4_pair():
        v = [((rng.randrange(p), rng.randrange(p)),
              (rng.randrange(p), rng.randrange(p))) for _ in range(2)]
        return e4.from_int(v, device=CPU), je4.from_int(v)

    z, jz = e24_pair(tw, jtw, rand_e24_ints(p, 2, 13))
    (a, ja), (b, jb), (c, jc) = e4_pair(), e4_pair(), e4_pair()
    zero = e4.zeros((2,), device=CPU)
    one = e4.broadcast_to(e4.ones(device=CPU), (2,))
    got = tw.mul_by_34(z, a, b)
    assert same(tw, got, jtw.mul_by_34(jz, ja, jb))
    assert torch.equal(got, tw.e12.mul(z, tw.from_coeffs6(
        [one, zero, zero, a, b, zero])))
    got = tw.mul_by_014(z, c, a, b)
    assert same(tw, got, jtw.mul_by_014(jz, jc, ja, jb))
    assert torch.equal(got, tw.e12.mul(z, tw.from_coeffs6(
        [c, a, zero, zero, b, zero])))
    assert same(tw, tw.mul_by_034(z, c, a, b), jtw.mul_by_034(jz, jc, ja, jb))


# -- GT from the golden bytes ------------------------------------------------

def golden_gt(name):
    with open(GOLDEN) as f:
        golden = json.load(f)[name]
    data = bytes.fromhex(golden["generator"])
    return golden, data, gt_bytes.gt_from_bytes(name, data, device=CPU)


@pytest.mark.parametrize("name", CURVES)
def test_bls24_gt_codec_and_exp(name):
    """The golden e(G1, G2) decodes to (2, 3, 2, 2, 10) words and
    re-encodes byte for byte; its 35th power is e([5]G1, [7]G2)'s golden
    bytes."""
    golden, data, z = golden_gt(name)
    assert z.shape == (2, 3, 2, 2, 10)
    assert gt_bytes.gt_to_bytes(name, z)[0] == data
    z35 = api.gt_exp(name, z, 35)   # e(G1, G2)^35 = e([5]G1, [7]G2)
    assert gt_bytes.gt_to_bytes(name, z35)[0].hex() == golden["p5_q7"]


@pytest.mark.parametrize("name", CURVES)
def test_bls24_gt_subgroup_check(name):
    """The golden e(G1, G2) is in the order-r subgroup (FrobeniusQuad and
    the seed's ladder), and the same element with one coefficient plus one
    is not: both in one batch of two."""
    _, _, z = golden_gt(name)
    fp = tcs.get_curve(f"{name}_g1").fp
    bad = z.clone()
    bad[0, 1, 0, 1] = mont.add(fp, bad[0, 1, 0, 1],
                               mont.from_int(fp, [1], device=CPU)[0])
    got = api.gt_is_in_subgroup(name, torch.stack([z, bad]))
    assert got.tolist() == [True, False]


def test_bw6_pairings_still_refused():
    """BW6 is ported since its slice (``tests/test_torch_bw6.py``): the
    facade gives the E6 engine of ``towers/tower6.py`` (GT (2, 3, W)), and
    the VM pairing programs take one fp coordinate a G2 coordinate and give
    6 GT coefficients, at 20 (bw6-633) and 24 (bw6-761) words."""
    from gnark_crypto_tpu_torch.towers.tower6 import get_tower6

    for name, W in (("bw6_761", 24), ("bw6_633", 20)):
        e6 = api.gt_engine(name, CPU)
        assert e6 is get_tower6(name, CPU).e6
        assert e6.ones(device=CPU).shape == (2, 3, W)
        prog = vm_pairing.build_program(name, "product")
        assert prog.spec.n_words == W and len(prog.out_regs) == 6
        names = {n for _, n in vm_pairing.build_program(
            name, "miller").entry_inputs}
        assert names == {"px", "py", "qx0", "qy0", "m", "mc"}


# -- G1 on the plain point versions ------------------------------------------

def g1_case(name):
    """12 points with an infinity and a repeated point, 12 scalars with a
    zero and r - 1."""
    spec = tcs.get_curve(f"{name}_g1")
    curve = curve_ops(spec)
    pts = rand_points(curve, 12, seed=24)
    rng = random.Random(24)
    r = spec.fr.modulus
    ks = [rng.randrange(r) for _ in range(12)]
    ks[0], ks[5] = 0, r - 1
    pts[1] = None
    pts[7] = pts[3]
    return spec, curve, pts, ks


def to_port(curve, pts) -> Affine:
    f = curve.fp
    return Affine(
        f.from_int([0 if p is None else p[0] for p in pts], device=CPU),
        f.from_int([0 if p is None else p[1] for p in pts], device=CPU))


def affine_ints(curve, p: Jac):
    a = curve.to_affine(Jac(*(c.reshape(-1, c.shape[-1]) for c in p)))
    xs, ys = (mont.to_int(curve.spec.fp, c) for c in a)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def msm_oracle(spec, pts, ks):
    p = spec.fp.modulus
    acc = None
    for pt, k in zip(pts, ks):
        if pt is not None:
            acc = oracle_add(acc, oracle_mul(pt, k, p, 0), p, 0)
    return acc


@pytest.mark.parametrize("name", CURVES)
def test_bls24_g1_msm_plain_matches_oracle(name):
    """A 12-point MSM (c = 4) on the plain point versions against the
    Python-int oracle."""
    spec, curve, pts, ks = g1_case(name)
    got = tpp.msm(spec, to_port(curve, pts),
                  curve.fr.from_int(ks, mont=False, device=CPU), c=4)
    assert affine_ints(curve, got) == [msm_oracle(spec, pts, ks)]


@pytest.mark.parametrize("name", CURVES)
def test_bls24_g1_msm_jax_matches_oracle(name):
    """The JAX MSM on the same inputs, carried across by ``convert``."""
    spec, curve, pts, ks = g1_case(name)
    jspec = jcs.get_curve(spec.name)
    jc = jcurve_ops(jspec)
    jP = JAffine(*convert.point_to_jax(spec.fp, to_port(curve, pts)))
    want = jc.to_affine(jpp.msm(jspec, jP, jc.fr.from_int(ks, mont=False),
                                c=4))
    x, y = (jmont.to_int(jspec.fp, np.asarray(c).reshape(1, -1))[0]
            for c in want)
    assert (x, y) == msm_oracle(spec, pts, ks)


def bsm_case(name):
    spec = tcs.get_curve(f"{name}_g1")
    r = spec.fr.modulus
    ks = [0, 1, r - 1, random.Random(9).randrange(r)]
    want = [oracle_mul((spec.gx, spec.gy), k, spec.fp.modulus, 0)
            for k in ks]
    return spec, ks, want


@pytest.mark.parametrize("name", CURVES)
def test_bls24_batch_scalar_mul_plain_matches_oracle(name):
    """[k]G1 for k = 0, 1, r - 1 and a random k, by the port."""
    spec, ks, want = bsm_case(name)
    curve = curve_ops(spec)
    got = tpp.batch_scalar_mul(spec, curve.generator_affine(device=CPU),
                               curve.fr.from_int(ks, mont=False, device=CPU))
    assert affine_ints(curve, got) == want


@pytest.mark.parametrize("name", CURVES)
def test_bls24_batch_scalar_mul_jax_matches_oracle(name):
    """The same lanes by the JAX package, from the port's generator carried
    across by ``convert``."""
    spec, ks, want = bsm_case(name)
    g = curve_ops(spec).generator_affine(device=CPU)
    jspec = jcs.get_curve(spec.name)
    jc = jcurve_ops(jspec)
    jg = JAffine(*convert.point_to_jax(spec.fp, Affine(g.x[None],
                                                         g.y[None])))
    got = jc.to_affine(jpp.batch_scalar_mul(
        jspec, JAffine(jg.x[0], jg.y[0]), jc.fr.from_int(ks, mont=False)))
    jx, jy = (jmont.to_int(jspec.fp, c) for c in got)
    assert [None if x == 0 and y == 0 else (x, y)
            for x, y in zip(jx, jy)] == want


# -- G2 over E4 ---------------------------------------------------------------

def fp4_ops(name):
    """Python-int Fp4 = Fp2[v]/(v^2 - v_sq) over Fp2 = Fp[u]/(u^2 - beta),
    with the tower's parameters; elements nested ((a, b), (c, d))."""
    from gnark_crypto_tpu_torch.towers.tower24 import TOWER24_PARAMS

    spec, beta, v_sq = TOWER24_PARAMS[name]
    p = spec.modulus

    def m2(x, y):
        return ((x[0] * y[0] + beta * x[1] * y[1]) % p,
                (x[0] * y[1] + x[1] * y[0]) % p)

    def a2(x, y):
        return ((x[0] + y[0]) % p, (x[1] + y[1]) % p)

    def s2(x, y):
        return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)

    def i2(x):
        d = pow((x[0] * x[0] - beta * x[1] * x[1]) % p, -1, p)
        return (x[0] * d % p, -x[1] * d % p)

    def mul(x, y):
        return (a2(m2(x[0], y[0]), m2(v_sq, m2(x[1], y[1]))),
                a2(m2(x[0], y[1]), m2(x[1], y[0])))

    def add(x, y):
        return (a2(x[0], y[0]), a2(x[1], y[1]))

    def sub(x, y):
        return (s2(x[0], y[0]), s2(x[1], y[1]))

    def inv(x):
        n = i2(s2(m2(x[0], x[0]), m2(v_sq, m2(x[1], x[1]))))
        return (m2(x[0], n), s2((0, 0), m2(x[1], n)))

    def small(k):
        return ((k % p, 0), (0, 0))

    return mul, add, sub, inv, small


def g2_oracle_mul(name, k):
    """[k]G2 by a Python-int affine double-and-add over Fp4 (a = 0)."""
    from gnark_crypto_tpu_torch.curve.g2 import _G2

    mul, add, sub, inv, small = fp4_ops(name)
    zero = small(0)

    def pt_add(P, Q):
        if P is None or Q is None:
            return Q if P is None else P
        (x1, y1), (x2, y2) = P, Q
        if x1 == x2 and add(y1, y2) == zero:
            return None
        if P == Q:
            lam = mul(mul(small(3), mul(x1, x1)), inv(mul(small(2), y1)))
        else:
            lam = mul(sub(y2, y1), inv(sub(x2, x1)))
        x3 = sub(sub(mul(lam, lam), x1), x2)
        return x3, sub(mul(lam, sub(x1, x3)), y1)

    P, acc = (_G2[name]["gx"], _G2[name]["gy"]), None
    while k:
        if k & 1:
            acc = pt_add(acc, P)
        P = pt_add(P, P)
        k >>= 1
    return acc


def g2_ints(g2, pt):
    """Affine E4 points -> [xs, ys], each coordinate ((a, b), (c, d)) of
    nested ints per point."""
    out = []
    for c in pt:
        halves = [list(zip(*g2.fp.base.to_int(g2.fp.coeff(c, i))))
                  for i in range(2)]
        out.append(list(zip(*halves)))
    return out


def g2_port_mul(name, ks, nbits=None):
    """[k]G2 for each k by the port's composed E4 ladder, affine."""
    from gnark_crypto_tpu_torch.curve.g2 import g2_curve

    g2 = g2_curve(name, CPU)
    G = g2.from_affine(g2.generator_affine(device=CPU))
    n = len(ks)
    P = g2.scalar_mul(Jac(*(c.expand(n, *c.shape) for c in G)),
                      g2.fr.from_int(ks, mont=False, device=CPU), nbits=nbits)
    return g2, g2.to_affine(P)


def jax_g2_mul(name, jG, k):
    """[k]G2 by the JAX ``g2_curve``'s group law (``double`` and ``add``),
    double-and-add run eagerly: its ``scalar_mul`` compiles its E4 ladder
    step for minutes on the CPU."""
    from gnark_crypto_tpu.curve.g2 import g2_curve as jg2_curve

    jg2 = jg2_curve(name)
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = jg2.double(acc)
        if bit == "1":
            acc = jG if acc is None else jg2.add(acc, jG)
    return jg2.to_affine(acc)


# three scalars below 2^16: the port's plain E4 ladder costs ~0.3 s a bit
# here; the card's paths run full-width scalars
G2_SCALARS = [3, 1234, 51234]


@pytest.mark.parametrize("name", CURVES)
def test_bls24_g2_scalar_mul_matches_jax(name):
    """G2 over E4: [k]G2 for three scalars equals the JAX ``g2_curve``'s
    group law, carried through ``convert`` as E4 coordinates, and a
    Python-int Fp4 oracle."""
    from gnark_crypto_tpu.curve.g2 import g2_curve as jg2_curve

    g2, got = g2_port_mul(name, G2_SCALARS, nbits=16)
    assert got.x.shape == (3, 2, 2, 10)
    x_ints, y_ints = g2_ints(g2, got)
    assert list(zip(x_ints, y_ints)) == [g2_oracle_mul(name, k)
                                         for k in G2_SCALARS]
    jg2 = jg2_curve(name)
    jG = jg2.from_affine(JAffine(*convert.point_to_jax(
        g2.spec.fp, g2.generator_affine(device=CPU))))
    for i, k in enumerate(G2_SCALARS):
        want = convert.point_from_jax(
            g2.spec.fp, [np.asarray(c) for c in jax_g2_mul(name, jG, k)],
            device=CPU)
        assert all(torch.equal(u[i], v) for u, v in zip(got, want)), k


# -- KZG over bls24-317 at n = 8 ---------------------------------------------

KZG_CURVE = "bls24_317"


def kzg_case():
    """A seeded polynomial of 8 coefficients, a point a and a secret alpha
    below 2^20 (``new_srs`` ladders [alpha]G2 over alpha's bits, ~0.3 s a
    bit on the plain E4 group law here), and the SRS's G1 part as Python
    ints."""
    spec = tcs.get_curve(f"{KZG_CURVE}_g1")
    r = spec.fr.modulus
    rng = random.Random(317)
    alpha, a = rng.randrange(2, 1 << 20), rng.randrange(r)
    coeffs = [rng.randrange(r) for _ in range(8)]
    srs_g1 = [g1_oracle(spec, pow(alpha, i, r)) for i in range(8)]
    return spec, alpha, a, coeffs, srs_g1


def port_kzg_inputs(spec, a, coeffs, srs_g1):
    from gnark_crypto_tpu_torch.protocols import kzg

    curve = curve_ops(spec)
    pk = kzg.ProvingKey(to_port(curve, srs_g1))
    poly = curve.fr.from_int(coeffs, mont=False, device=CPU)
    point = curve.fr.from_int([a], mont=False, device=CPU)
    return kzg, curve, pk, poly, point


def g1_oracle(spec, k):
    return oracle_mul((spec.gx, spec.gy), k % spec.fr.modulus,
                      spec.fp.modulus, 0)


def point_ints(curve, p):
    xs, ys = (mont.to_int(curve.spec.fp, c) for c in p)
    return list(zip(xs, ys))


def kzg_oracle(spec, alpha, a, coeffs):
    """[p(alpha)]G1, p(a) and [(p(alpha) - p(a)) / (alpha - a)]G1."""
    r = spec.fr.modulus
    p_alpha = sum(c * pow(alpha, i, r) for i, c in enumerate(coeffs)) % r
    p_a = sum(c * pow(a, i, r) for i, c in enumerate(coeffs)) % r
    q_alpha = (p_alpha - p_a) * pow(alpha - a, -1, r) % r
    return g1_oracle(spec, p_alpha), p_a, g1_oracle(spec, q_alpha)


def test_bls24_kzg_new_srs_matches_oracle():
    """bls24-317 ``new_srs`` at n = 8: [alpha^i]G1 and [alpha]G2 against
    Python-int G1 and Fp4 ladders, [1]G2 the generator."""
    from gnark_crypto_tpu_torch.curve.g2 import g2_curve
    from gnark_crypto_tpu_torch.protocols import kzg

    spec, alpha, _, _, srs_g1 = kzg_case()
    srs = kzg.new_srs(KZG_CURVE, 8, alpha, device=CPU)
    assert point_ints(curve_ops(spec), srs.pk.g1) == srs_g1
    g2 = g2_curve(KZG_CURVE, CPU)
    assert srs.vk.alpha_g2.x.shape == (1, 2, 2, 10)
    x_ints, y_ints = g2_ints(g2, srs.vk.alpha_g2)
    assert list(zip(x_ints, y_ints)) == [g2_oracle_mul(KZG_CURVE, alpha)]
    x_ints, y_ints = g2_ints(g2, srs.vk.g2)
    assert list(zip(x_ints, y_ints)) == [g2_oracle_mul(KZG_CURVE, 1)]


def test_bls24_kzg_commit_open_match_oracle():
    """``commit`` is [p(alpha)]G1 and ``open_poly`` gives p(a) and
    [(p(alpha) - p(a)) / (alpha - a)]G1, in Python integers."""
    spec, alpha, a, coeffs, srs_g1 = kzg_case()
    kzg, curve, pk, poly, point = port_kzg_inputs(spec, a, coeffs, srs_g1)
    c_want, p_a, h_want = kzg_oracle(spec, alpha, a, coeffs)
    assert point_ints(curve, kzg.commit(KZG_CURVE, pk, poly)) == [c_want]
    proof = kzg.open_poly(KZG_CURVE, pk, poly, point)
    assert curve.fr.to_int(proof.claimed_value, mont=False) == [p_a]
    assert point_ints(curve, proof.h) == [h_want]


def jax_kzg_inputs(spec, a, coeffs, srs_g1):
    from gnark_crypto_tpu.protocols import kzg as jkzg

    jc = jcurve_ops(jcs.get_curve(spec.name))
    jpk = jkzg.ProvingKey(JAffine(*convert.point_to_jax(
        spec.fp, to_port(curve_ops(spec), srs_g1))))
    return (jkzg, jc, jpk, jc.fr.from_int(coeffs, mont=False),
            jc.fr.from_int([a], mont=False))


# The JAX KZG is held against the same oracle as the port, in tests of its
# own, so that port == JAX in gnark bytes: a JAX MSM's compile (~17 s) and
# the port's plain MSM (~10 s) would pass 30 s in one test.

def oracle_bytes(spec, pt):
    """The port's gnark encoding of an oracle point."""
    from gnark_crypto_tpu_torch.io.marshal import PointCodec

    curve = curve_ops(spec)
    return PointCodec(curve).to_bytes(to_port(curve, [pt]))


def test_bls24_kzg_commit_jax_matches_oracle_bytes():
    """The JAX KZG's ``commit`` over the same SRS (carried across by
    ``convert``) encodes to the oracle's [p(alpha)]G1 bytes, the port's
    ``commit`` in the test above."""
    from gnark_crypto_tpu.io.marshal import PointCodec as JPointCodec

    spec, alpha, a, coeffs, srs_g1 = kzg_case()
    jkzg, jc, jpk, jpoly, _ = jax_kzg_inputs(spec, a, coeffs, srs_g1)
    c_want, _, _ = kzg_oracle(spec, alpha, a, coeffs)
    assert JPointCodec(jc).to_bytes(jkzg.commit(KZG_CURVE, jpk, jpoly)) == \
        oracle_bytes(spec, c_want)


def test_bls24_kzg_open_jax_matches_oracle_bytes():
    """The JAX KZG's ``open_poly`` over the same SRS: the oracle's quotient
    commitment bytes and claimed value."""
    from gnark_crypto_tpu.io.marshal import PointCodec as JPointCodec

    spec, alpha, a, coeffs, srs_g1 = kzg_case()
    jkzg, jc, jpk, jpoly, jpoint = jax_kzg_inputs(spec, a, coeffs, srs_g1)
    _, p_a, h_want = kzg_oracle(spec, alpha, a, coeffs)
    jproof = jkzg.open_poly(KZG_CURVE, jpk, jpoly, jpoint)
    assert JPointCodec(jc).to_bytes(jproof.h) == oracle_bytes(spec, h_want)
    assert jc.fr.to_int(jproof.claimed_value, mont=False) == [p_a]


@pytest.mark.slow
def test_bls24_kzg_verify_on_plain_executor():
    """``verify`` over bls24-317: True on the honest opening and False with
    the claimed value changed (two pairings on the plain VM executor)."""
    from gnark_crypto_tpu_torch.protocols import kzg

    spec, alpha, a, coeffs, _ = kzg_case()
    srs = kzg.new_srs(KZG_CURVE, 8, alpha, device=CPU)
    fr = curve_ops(spec).fr
    poly = fr.from_int(coeffs, mont=False, device=CPU)
    point = fr.from_int([a], mont=False, device=CPU)
    C = kzg.commit(KZG_CURVE, srs.pk, poly)
    proof = kzg.open_poly(KZG_CURVE, srs.pk, poly, point)
    assert bool(kzg.verify(KZG_CURVE, C, proof, point, srs.vk))
    y = fr.to_int(proof.claimed_value, mont=False)[0]
    bad = kzg.OpeningProof(proof.h, fr.from_int([y + 1], mont=False,
                                                device=CPU))
    assert not bool(kzg.verify(KZG_CURVE, C, bad, point, srs.vk))


@pytest.mark.slow
def test_bls24_317_pair_p5_q7_on_plain_executor():
    """e([5]G1, [7]G2) over bls24-317 by ``pair`` (the scheduled ``full``
    program on the plain VM executor) equals the golden gnark bytes."""
    with open(GOLDEN) as f:
        want = json.load(f)["bls24_317"]["p5_q7"]
    spec = tcs.get_curve("bls24_317_g1")
    curve = curve_ops(spec)
    p5 = g1_oracle(spec, 5)
    P = Affine(curve.fp.from_int([p5[0]], device=CPU),
               curve.fp.from_int([p5[1]], device=CPU))
    _, Q = g2_port_mul("bls24_317", [7], nbits=3)
    z = api.pair("bls24_317", P, Q.x, Q.y)
    assert gt_bytes.gt_to_bytes("bls24_317", z)[0].hex() == want
