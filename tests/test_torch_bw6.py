"""bw6-761 and bw6-633 in the port, at 24- and 20-word Fp, on the CPU.

* Which kernels take which fields: the field, exponent, G1 point and VM
  kernels are built at 8, 10, 12, 20 and 24 words, so they take bw6-633 Fp
  (20 words) and bw6-761 Fp (24); the Fp2 and NTT kernels do not. What the
  20- and 24-word kernels receive from the host, against Python integers.
* The field at bw6 Fp against Python integers and the JAX engine.
* ``towers/tower6.py`` against the JAX ``Tower6`` and its host helpers on
  the same seeded inputs; the GT codec, ``gt_exp`` and the subgroup check
  from the golden gnark bytes (``tests/fixtures/gt_golden.json``); GT
  elements and points carried to the JAX package and back (``convert``).
* The eight bw6 VM programs against the JAX ``build_program`` row for row
  at the reference's tile of 128, and each program ``pair_vm`` runs,
  scheduled into waves, by value numbering, with legal waves and K within
  ``vm.reg_cap``.
* G1 and G2 (both over Fp) ``msm`` (c = 4) and ``batch_scalar_mul`` on the
  plain point versions against Python-int oracles.
* KZG at n = 8 without a pairing: ``new_srs``, ``commit``, ``open_poly``
  against the alpha oracle, and ``verify`` with ``pairing_check`` replaced
  by the exact test T == [-alpha]H for a known alpha.

A bw6 pairing on the plain VM executor takes minutes here: the pairing of
the golden inputs runs in the tests marked ``slow``, and on the card.
Values cross as canonical integers or gnark bytes; the tolerance is 0. No
test name here holds ``test_bw6``, ``test_pairing``, ``test_kzg`` or
``test_towers``: ``tests/conftest.py`` runs such tests first.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.field import exp, kernels, mont, point_add
from gnark_crypto_tpu_torch.field import point_add2, vm
from gnark_crypto_tpu_torch.io import gt_bytes
from gnark_crypto_tpu_torch.io.marshal import PointCodec
from gnark_crypto_tpu_torch.msm import pippenger as tpp
from gnark_crypto_tpu_torch.ntt import radix2
from gnark_crypto_tpu_torch.pairing import api, vm_pairing
from gnark_crypto_tpu_torch.specs import curve as tcs
from gnark_crypto_tpu_torch.specs import field as tfs
from gnark_crypto_tpu_torch.towers.tower6 import get_tower6
from gnark_crypto_tpu_torch.utils import build
from tests.test_curve_g1 import oracle_add, oracle_mul, rand_points
from tests.test_torch_vm_waves import check_waves, value_numbers

CPU = "cpu"
CURVES = ["bw6_633", "bw6_761"]
VARIANTS = ["full", "miller", "product", "reduce"]
WORDS = {"bw6_633": 20, "bw6_761": 24}
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "gt_golden.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain point and tower versions are
    thousands of small tensor ops, and with several test workers PyTorch's
    thread pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words_int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


# -- the width check and the launch arguments --------------------------------

@pytest.mark.parametrize("name", CURVES)
def test_field_kernels_take_20_and_24_words(name):
    """The field, exponent, G1 point and VM wrappers take bw6 Fp
    (q < 2^(32W-1), 16-byte rows); the NTT and Fp2 kernels were not built
    at 20 or 24 words and refuse it before any launch."""
    spec = tfs.get_field(f"{name}_fp")
    W = WORDS[name]
    assert spec.n_words == W and spec.modulus < 1 << (32 * W - 1)
    assert kernels.FIELD_WIDTHS == (8, 10, 12, 20, 24)
    assert kernels.load_align(W) == 16
    kernels.check_width(spec, "mont_mul", kernels.FIELD_WIDTHS)
    x = torch.zeros((3, W), dtype=torch.int32)
    kernels.check_kernel_args(spec, "mont_mul", x[1:], x[1:],
                              widths=kernels.FIELD_WIDTHS)
    for widths in (radix2.WIDTHS, point_add2.WIDTHS):
        with pytest.raises(NotImplementedError):
            kernels.check_width(spec, "kernel", widths)


@pytest.mark.parametrize("name", CURVES)
def test_launch_args_at_20_and_24_words(name):
    spec = tfs.get_field(f"{name}_fp")
    q, W = spec.modulus, WORDS[name]
    fw = list(build.field_words(spec))
    assert len(fw) == W + 1 and words_int(fw[:W]) == q
    assert q * fw[W] % (1 << 32) == (1 << 32) - 1        # -q^-1 mod 2^32
    assert words_int(spec.one_words) == (1 << (32 * W)) % q
    words, nbits = exp.exponent_words(spec, q - 2)
    assert len(words) == W and words_int(words) == q - 2
    assert nbits == q.bit_length()
    big = (q - 2) + 5 * (q - 1) + (1 << (32 * W + 10))  # reduced mod q-1
    words, nbits = exp.exponent_words(spec, big)
    e = words_int(words)
    assert 1 <= e < q and (e - big) % (q - 1) == 0 and nbits == e.bit_length()
    cw, a_is_zero = point_add._curve_args(spec, 0)
    assert list(cw) == [0] * W + list(spec.one_words) and a_is_zero == 1
    cw, a_is_zero = point_add._curve_args(spec, 3)
    assert words_int(list(cw)[:W]) == 3 * (1 << (32 * W)) % q
    assert a_is_zero == 0


@pytest.mark.parametrize("name", CURVES)
def test_vm_entry_constants_at_20_and_24_words(name):
    """The entry rows of a bw6 pairing program: each constant in Montgomery
    form (R = 2^(32W)) at its register, inputs zero; the register cap."""
    prog = vm_pairing.build_program(name, "miller")
    spec = prog.spec
    W = WORDS[name]
    assert spec.n_words == W
    rows = vm._entry_consts(prog, CPU).numpy().view(np.uint32)
    assert rows.shape == (prog.n_entry, W)
    consts = dict(prog.entry_consts)
    assert consts and len(consts) + len(prog.entry_inputs) == prog.n_entry
    for reg in range(prog.n_entry):
        want = consts.get(reg, 0) * (1 << (32 * W)) % spec.modulus
        assert words_int(rows[reg]) == want
    assert vm.reg_cap(spec) == {20: 90, 24: 75}[W]


# -- the field ---------------------------------------------------------------

def field_values(q, seed):
    rng = random.Random(seed)
    return [0, 1, q - 1, (q - 1) // 2, (q + 1) // 2, 2] + [
        rng.randrange(q) for _ in range(10)]


@pytest.mark.parametrize("name", CURVES)
def test_wide_field_ops_match_ints_and_jax(name):
    """mont_mul_plain, add, sub, inverse and exp_const on 16 values, against
    Python integers and the JAX field engine."""
    spec, jspec = (m.get_field(f"{name}_fp") for m in (tfs, jfs))
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


# -- Tower6 against the JAX Tower6 and the host helpers ----------------------

def rand_e6_ints(p, n, seed):
    rng = random.Random(seed)
    return [tuple(tuple(rng.randrange(p) for _ in range(3))
                  for _ in range(2)) for _ in range(n)]


def towers(name):
    from gnark_crypto_tpu.towers.tower6 import get_tower6 as jget_tower6

    return get_tower6(name, CPU), jget_tower6(name)


def e6_pair(tw, jtw, vals):
    """The same E6 values in both packages."""
    x = tw.e6.from_int(vals, device=CPU)
    jx = np.stack([np.asarray(jtw.e6.from_int(v)) for v in vals])
    return x, jx


def same(tw, got, jgot) -> bool:
    """Equal as canonical integers (the word and limb radices differ)."""
    want = convert.from_jax_limbs(tw.fp_spec, np.asarray(jgot), device=CPU)
    return bool(torch.equal(got, want))


def e6_ints(tw, x) -> list:
    """(n, 2, 3, W) -> n nested ((a0, a1, a2), (b0, b1, b2)) ints."""
    flat = mont.to_int(tw.fp_spec, x.reshape(-1, tw.fp_spec.n_words))
    return [(tuple(flat[i:i + 3]), tuple(flat[i + 3:i + 6]))
            for i in range(0, len(flat), 6)]


def cyclotomic(tw, x):
    """x^((p^3 - 1)(p + 1)): into the cyclotomic subgroup."""
    e6 = tw.e6
    y = e6.mul(tw.conjugate(x), e6.inverse(x))
    return e6.mul(tw.frobenius(y), y)


@pytest.mark.parametrize("name", CURVES)
def test_tower6_field_ops_match_jax(name):
    """E6 mul, square, inverse, Frobenius and conjugate equal the JAX
    Tower6's on the same inputs; the Frobenius is x^p and the conjugate
    x^(p^3) by the host helpers; x * x^-1 == 1."""
    from gnark_crypto_tpu.towers.tower6 import _h6_mul, _h6_pow

    tw, jtw = towers(name)
    vals = rand_e6_ints(tw.p, 2, 1)
    x, jx = e6_pair(tw, jtw, vals)
    y, jy = e6_pair(tw, jtw, rand_e6_ints(tw.p, 2, 2))
    e6, je6 = tw.e6, jtw.e6
    prod = e6.mul(x, y)
    assert same(tw, prod, je6.mul(jx, jy))
    assert e6_ints(tw, prod) == [
        _h6_mul(u, v, tw.p, tw.nr)
        for u, v in zip(vals, rand_e6_ints(tw.p, 2, 2))]
    assert same(tw, e6.square(x), je6.square(jx))
    inv = e6.inverse(x)
    assert same(tw, inv, je6.inverse(jx))
    assert bool(e6.equal(e6.mul(x, inv), e6.ones(device=CPU)).all())
    frob = tw.frobenius(x)
    assert same(tw, frob, jtw.frobenius(jx))
    assert e6_ints(tw, frob) == [_h6_pow(u, tw.p, tw.p, tw.nr) for u in vals]
    conj = tw.conjugate(x)
    assert same(tw, conj, jtw.conjugate(jx))
    assert e6_ints(tw, conj) == [_h6_pow(u, tw.p ** 3, tw.p, tw.nr)
                                 for u in vals]


@pytest.mark.parametrize("name", CURVES)
def test_tower6_cyclotomic_ops_match_jax(name):
    """On cyclotomic elements: ``cyclotomic_square`` equals the JAX one,
    ``inverse_cyclotomic`` the inverse, and ``exp_cyclotomic`` and the
    engine's ``exp_const`` the host helper's power."""
    from gnark_crypto_tpu.towers.tower6 import _h6_pow

    tw, jtw = towers(name)
    x, jx = e6_pair(tw, jtw, rand_e6_ints(tw.p, 2, 3))
    c = cyclotomic(tw, x)
    jc = np.asarray(jtw.e6.mul(jtw.conjugate(jx), jtw.e6.inverse(jx)))
    jc = jtw.e6.mul(jtw.frobenius(jc), jc)
    assert same(tw, c, jc)
    assert same(tw, tw.cyclotomic_square(c), jtw.cyclotomic_square(jc))
    assert torch.equal(tw.inverse_cyclotomic(c), tw.e6.inverse(c))
    e = 0xB5A3_0F27_91C4
    want = [_h6_pow(u, e, tw.p, tw.nr) for u in e6_ints(tw, c)]
    assert e6_ints(tw, tw.exp_cyclotomic(c, e)) == want
    assert e6_ints(tw, tw.e6.exp_const(c, e)) == want
    assert torch.equal(tw.exp_cyclotomic(c, 0)[0], tw.e6.ones(device=CPU))


def test_tower6_product_batches_its_base_products(monkeypatch):
    """On word tensors an E6 product over bw6-761 is one ``mont_mul`` call
    of 18 products a lane and three for the non-residue u^3 = -4 (two over
    the three stacked E3 products, one for v^2 = u), where the
    per-coefficient order of the symbolic engines makes 25; the same
    values."""
    tw = get_tower6("bw6_761", CPU)
    x = tw.e6.from_int(rand_e6_ints(tw.p, 2, 7), device=CPU)
    y = tw.e6.from_int(rand_e6_ints(tw.p, 2, 8), device=CPU)
    calls = []

    def counted(spec, a, b):
        calls.append(a.shape[0])
        return kernels.mont_mul_plain(spec, a, b)

    monkeypatch.setattr(mont, "mont_mul", counted)
    got = tw.e6.mul(x, y)
    assert calls == [18 * 2, 3 * 2, 3 * 2, 2]
    for eng in (tw.e3, tw.e6):
        monkeypatch.setitem(eng.__dict__, "_flat", None)
    calls.clear()
    assert torch.equal(tw.e6.mul(x, y), got)
    assert len(calls) == 25


# -- GT from the golden bytes ------------------------------------------------

def golden_gt(name):
    with open(GOLDEN) as f:
        golden = json.load(f)[name]
    data = bytes.fromhex(golden["generator"])
    return golden, data, gt_bytes.gt_from_bytes(name, data, device=CPU)


@pytest.mark.parametrize("name", CURVES)
def test_gt6_codec_and_exp(name):
    """The golden e(G1, G2) decodes to (2, 3, W) words and re-encodes byte
    for byte; its 35th power is e([5]G1, [7]G2)'s golden bytes, and its
    -35th power the inverse of that."""
    golden, data, z = golden_gt(name)
    assert z.shape == (2, 3, WORDS[name])
    assert api.gt_engine(name, CPU) is get_tower6(name, CPU).e6
    assert gt_bytes.gt_to_bytes(name, z)[0] == data
    z35 = api.gt_exp(name, z, 35)   # e(G1, G2)^35 = e([5]G1, [7]G2)
    assert gt_bytes.gt_to_bytes(name, z35)[0].hex() == golden["p5_q7"]
    e6 = api.gt_engine(name, CPU)
    assert bool(e6.equal(e6.mul(api.gt_exp(name, z, -35), z35),
                         e6.ones(device=CPU)))
    assert torch.equal(api.gt_exp(name, z, 0), e6.ones(device=CPU))


@pytest.mark.parametrize("name", CURVES)
def test_gt6_subgroup_check(name):
    """The golden e(G1, G2) is in the order-r subgroup (z^r == 1), and the
    same element with one coefficient plus one is not: both in one batch
    of two."""
    _, _, z = golden_gt(name)
    fp = tcs.get_curve(f"{name}_g1").fp
    bad = z.clone()
    bad[1, 2] = mont.add(fp, bad[1, 2], mont.from_int(fp, [1], device=CPU)[0])
    got = api.gt_is_in_subgroup(name, torch.stack([z, bad]))
    assert got.tolist() == [True, False]


@pytest.mark.parametrize("name", CURVES)
def test_gt6_and_points_cross_to_jax(name):
    """``convert`` carries the golden GT element and G1 and G2 points to the
    JAX package and back: the JAX GT codec writes the golden bytes, the JAX
    point codec the port's bytes, and the round trips are exact."""
    from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
    from gnark_crypto_tpu.curve.jacobian import curve_ops as jcurve_ops
    from gnark_crypto_tpu.io import gt_bytes as jgt_bytes
    from gnark_crypto_tpu.io.marshal import PointCodec as JPointCodec
    from gnark_crypto_tpu.specs import curve as jcs

    _, data, z = golden_gt(name)
    fp = tcs.get_curve(f"{name}_g1").fp
    jz = convert.to_jax_limbs(fp, z)
    assert jz.shape[:2] == (2, 3)
    assert jgt_bytes.gt_to_bytes(name, jz)[0] == data
    assert torch.equal(convert.from_jax_limbs(fp, jz, device=CPU), z)
    for group in ("g1", "g2"):
        spec = tcs.get_curve(f"{name}_{group}")
        curve = curve_ops(spec)
        pts = rand_points(curve, 3, seed=6) + [None]
        P = to_port(curve, pts)
        jP = JAffine(*convert.point_to_jax(spec.fp, P))
        jcurve = jcurve_ops(jcs.get_curve(spec.name))
        assert JPointCodec(jcurve).to_bytes(jP) == PointCodec(
            curve).to_bytes(P)
        back = convert.point_from_jax(spec.fp, jP, device=CPU)
        assert all(torch.equal(u, v) for u, v in zip(back, P))


# -- the VM programs ---------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("curve", CURVES)
def test_program6_equals_reference(curve, variant):
    """The port's ``build_program`` at the reference's tile of 128 is the
    JAX package's program row for row (registers, entry rows, outputs):
    Tower6, its symbolic twin, the joint Miller loop, the final
    exponentiation and the allocator at once."""
    from gnark_crypto_tpu.pairing import vm_pairing as jvp

    got = vm_pairing.build_program(curve, variant, tile=128)
    want = jvp.build_program(curve, variant)
    assert got.tile == want.tile == 128
    assert got.spec.n_words == WORDS[curve]
    assert got.n_instrs == want.n_instrs
    assert np.array_equal(got.code, want.code)
    assert (got.n_regs, got.n_entry) == (want.n_regs, want.n_entry)
    assert got.entry_consts == want.entry_consts
    assert got.entry_inputs == want.entry_inputs
    assert got.out_regs == want.out_regs


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("curve", CURVES)
def test_program6_schedule_fits_and_computes_the_same(curve, variant):
    """The program ``pair_vm`` runs: waves of 16 legal rows, K within the
    cap (90 registers at 20 words, 75 at 24) from the widest look-ahead
    window that fits, and the same function as the built program (value
    numbering)."""
    built = vm_pairing.build_program(curve, variant)
    sched = vm_pairing.program(curve, variant)
    assert sched.spec.n_words == WORDS[curve]
    assert sched.warps == vm_pairing.WARPS and sched.tile == vm.TILE
    assert sched.window in vm.WINDOWS
    assert sched.n_regs <= vm.reg_cap(sched.spec)
    check_waves(sched)
    assert (sched.entry_consts, sched.entry_inputs, sched.n_entry) == (
        built.entry_consts, built.entry_inputs, built.n_entry)
    assert sched.op_counts()["MUL"] == built.op_counts()["MUL"]
    table = {}
    want = value_numbers(built, table)
    assert value_numbers(sched, table) == want


def test_program6_product_plain_matches_e6_products():
    """The scheduled bw6-633 ``product`` program over one 32-lane tile of
    E6 values: every lane ends with the product of the tile, the port's E6
    product tree of the same values."""
    name = "bw6_633"
    tw = get_tower6(name, CPU)
    vals = rand_e6_ints(tw.p, vm.TILE, 6)
    vals[3] = ((1, 0, 0), (0, 0, 0))
    x = tw.e6.from_int(vals, device=CPU)              # (32, 2, 3, 20)
    coeffs = x.reshape(vm.TILE, 6, 20)
    prog = vm_pairing.program(name, "product")
    out = vm.execute(prog, {f"f{i}": coeffs[:, i] for i in range(6)},
                     vm.TILE)
    got = torch.stack([out[f"g{i}"] for i in range(6)], 1).reshape(x.shape)
    acc = x
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = tw.e6.mul(acc[:h], acc[h:])
    assert torch.equal(got, acc.expand_as(x))


# -- G1 and G2 (both over Fp) on the plain point versions --------------------

GROUPS = [f"{c}_{g}" for c in CURVES for g in ("g1", "g2")]


def to_port(curve, pts) -> Affine:
    f = curve.fp
    return Affine(
        f.from_int([0 if p is None else p[0] for p in pts], device=CPU),
        f.from_int([0 if p is None else p[1] for p in pts], device=CPU))


def affine_ints(curve, p: Jac):
    a = curve.to_affine(Jac(*(c.reshape(-1, c.shape[-1]) for c in p)))
    xs, ys = (mont.to_int(curve.spec.fp, c) for c in a)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("group", GROUPS)
def test_msm6_plain_matches_oracle(group):
    """A 12-point MSM (c = 4) with an infinity, a repeated point, a zero
    scalar and r - 1, on the plain point versions, against the Python-int
    oracle. bw6's G2 is a curve over Fp: the same kernels."""
    spec = tcs.get_curve(group)
    curve = curve_ops(spec) if group.endswith("g1") else g2_curve(
        group[:-3], CPU)
    assert curve.elem_tail == (spec.fp.n_words,)
    pts = rand_points(curve, 12, seed=6)
    rng = random.Random(6)
    r, p = spec.fr.modulus, spec.fp.modulus
    ks = [rng.randrange(r) for _ in range(12)]
    ks[0], ks[5] = 0, r - 1
    pts[1] = None
    pts[7] = pts[3]
    got = tpp.msm(curve, to_port(curve, pts),
                  curve.fr.from_int(ks, mont=False, device=CPU), c=4)
    want = None
    for pt, k in zip(pts, ks):
        if pt is not None:
            want = oracle_add(want, oracle_mul(pt, k, p, 0), p, 0)
    assert affine_ints(curve, got) == [want]


@pytest.mark.parametrize("group", GROUPS)
def test_batch_scalar_mul6_plain_matches_oracle(group):
    """[k]G for k = 0, 1, r - 1 and a random k, by the port."""
    spec = tcs.get_curve(group)
    curve = curve_ops(spec)
    r, p = spec.fr.modulus, spec.fp.modulus
    ks = [0, 1, r - 1, random.Random(9).randrange(r)]
    got = tpp.batch_scalar_mul(spec, curve.generator_affine(device=CPU),
                               curve.fr.from_int(ks, mont=False, device=CPU))
    assert affine_ints(curve, got) == [oracle_mul((spec.gx, spec.gy), k, p,
                                                  0) for k in ks]


# -- KZG at n = 8, without a pairing -----------------------------------------

def commitment_case(name):
    """A seeded polynomial of 8 coefficients, a point a, a secret alpha
    below 2^20 (``new_srs`` ladders [alpha]G2 over alpha's bits on the
    plain point versions here), the SRS's G1 part from the Python-int
    oracle, and the alpha oracle's [p(alpha)]G1, p(a) and
    [(p(alpha) - p(a)) / (alpha - a)]G1."""
    spec = tcs.get_curve(f"{name}_g1")
    r = spec.fr.modulus
    rng = random.Random(WORDS[name])
    alpha, a = rng.randrange(2, 1 << 20), rng.randrange(r)
    coeffs = [rng.randrange(r) for _ in range(8)]
    srs_g1 = [g1_oracle(spec, pow(alpha, i, r)) for i in range(8)]
    p_alpha = sum(c * pow(alpha, i, r) for i, c in enumerate(coeffs)) % r
    p_a = sum(c * pow(a, i, r) for i, c in enumerate(coeffs)) % r
    q_alpha = (p_alpha - p_a) * pow(alpha - a, -1, r) % r
    want = (g1_oracle(spec, p_alpha), p_a, g1_oracle(spec, q_alpha))
    return spec, alpha, a, coeffs, srs_g1, want


def g1_oracle(spec, k):
    return oracle_mul((spec.gx, spec.gy), k % spec.fr.modulus,
                      spec.fp.modulus, 0)


def port_commitment_inputs(name):
    """The oracle SRS's G1 part, the polynomial and the point as the
    port's tensors."""
    from gnark_crypto_tpu_torch.protocols import kzg

    spec, alpha, a, coeffs, srs_g1, want = commitment_case(name)
    curve = curve_ops(spec)
    pk = kzg.ProvingKey(to_port(curve, srs_g1))
    poly = curve.fr.from_int(coeffs, mont=False, device=CPU)
    point = curve.fr.from_int([a], mont=False, device=CPU)
    return kzg, curve, pk, poly, point, alpha, want


@pytest.mark.parametrize("name", CURVES)
def test_srs6_matches_alpha_oracle(name):
    """``new_srs`` at n = 8: [alpha^i]G1 and [alpha]G2 (G2 over Fp: (1, W)
    coordinates) against Python-int ladders, [1]G1 and [1]G2 the
    generators."""
    from gnark_crypto_tpu_torch.protocols import kzg

    spec, alpha, _, _, srs_g1, _ = commitment_case(name)
    curve = curve_ops(spec)
    srs = kzg.new_srs(name, 8, alpha, device=CPU)
    assert affine_ints(curve, curve.from_affine(srs.pk.g1)) == srs_g1
    g2 = curve_ops(tcs.get_curve(f"{name}_g2"))
    assert srs.vk.alpha_g2.x.shape == (1, WORDS[name])
    p = spec.fp.modulus
    for pt, k in ((srs.vk.alpha_g2, alpha), (srs.vk.g2, 1)):
        assert affine_ints(g2, g2.from_affine(pt)) == [
            oracle_mul((g2.spec.gx, g2.spec.gy), k, p, 0)]
    assert affine_ints(curve, curve.from_affine(srs.vk.g1)) == [
        g1_oracle(spec, 1)]


@pytest.mark.parametrize("name", CURVES)
def test_commit6_open_match_alpha_oracle(name):
    """``commit`` is [p(alpha)]G1 and ``open_poly`` gives p(a) and
    [(p(alpha) - p(a)) / (alpha - a)]G1, in Python integers."""
    kzg, curve, pk, poly, point, _, (c_want, p_a, h_want) = \
        port_commitment_inputs(name)
    C = kzg.commit(name, pk, poly)
    assert affine_ints(curve, curve.from_affine(C)) == [c_want]
    proof = kzg.open_poly(name, pk, poly, point)
    assert curve.fr.to_int(proof.claimed_value, mont=False) == [p_a]
    assert affine_ints(curve, curve.from_affine(proof.h)) == [h_want]


@pytest.mark.parametrize("name", CURVES)
def test_verify6_verdicts_without_a_pairing(name, monkeypatch):
    """``verify`` of the oracle's opening with ``pairing_check`` replaced
    by the test T == [-alpha]H on the G1 pair it receives, which is its
    verdict for a known alpha: True on the honest opening, False with the
    claimed value plus one."""
    kzg, curve, pk, poly, point, alpha, (c_want, p_a, h_want) = \
        port_commitment_inputs(name)
    spec = curve.spec
    r, p = spec.fr.modulus, spec.fp.modulus
    g2 = curve_ops(tcs.get_curve(f"{name}_g2"))
    vk = kzg.VerifyingKey(
        g2=to_port(g2, [(g2.spec.gx, g2.spec.gy)]),
        alpha_g2=to_port(g2, [oracle_mul((g2.spec.gx, g2.spec.gy), alpha,
                                         p, 0)]),
        g1=to_port(curve, [g1_oracle(spec, 1)]))
    C = to_port(curve, [c_want])
    fr = curve.fr

    def check(curve_name, P, qx, qy):
        T, H = affine_ints(curve, curve.from_affine(P))
        assert curve_name == name and qx.shape == (2, WORDS[name])
        return torch.tensor(T == oracle_mul(H, -alpha % r, p, 0))

    monkeypatch.setattr(kzg.pairing_api, "pairing_check", check)
    for y, verdict in ((p_a, True), (p_a + 1, False)):
        proof = kzg.OpeningProof(to_port(curve, [h_want]), fr.from_int(
            [y], mont=False, device=CPU))
        assert bool(kzg.verify(name, C, proof, point, vk)) is verdict


# -- pairings on the plain VM executor (minutes) ------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", CURVES)
def test_pair6_golden_on_plain_executor(name):
    """e(G1, G2) by ``pair`` (the scheduled ``full`` program on the plain
    VM executor) equals the golden gnark bytes, and the 2-pair check
    e(P, Q) e(-P, Q) == 1 (the ``full`` program again) is True."""
    golden, data, _ = golden_gt(name)
    g1 = curve_ops(tcs.get_curve(f"{name}_g1")).generator_affine(device=CPU)
    g2 = g2_curve(name, CPU).generator_affine(device=CPU)
    P = Affine(g1.x[None], g1.y[None])
    z = api.pair(name, P, g2.x[None], g2.y[None])
    assert gt_bytes.gt_to_bytes(name, z)[0] == data
    fp = tcs.get_curve(f"{name}_g1").fp
    P2 = Affine(torch.cat([P.x, P.x]), torch.cat([P.y, mont.neg(fp, P.y)]))
    QX, QY = (torch.stack([c, c]) for c in g2)
    assert bool(api.pairing_check(name, P2, QX, QY))
