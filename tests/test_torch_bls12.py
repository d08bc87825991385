"""bls12-381 and bls12-377 in the port, at 12-word Fp, on the CPU.

* Which kernels take which fields: the width check of every CUDA wrapper
  (``field/kernels.py`` ``check_width``), called directly since it needs
  no card: the field, exponent, point and VM kernels are built at 8, 10,
  12, 20 and 24 words, the Fp2 point kernels at 8 and 12, the NTT kernels
  at 8, 10 and 12; of them only the field, exponent and G1 point kernels
  take an 8-word q >= 2^255 (secp256k1/r1). The Fp2 kernels take only the
  (words, nr) pairs they were built for: (8, -1), (12, -1) and (12, -5).
* What the 12-word kernels receive from the host, against Python integers:
  the field words and -q^-1 mod 2^32, Montgomery one, the exponent words of
  q - 2 (and of an exponent past 2^384), the curve words, the Fp2 kernels'
  words and non-residues, and the VM's entry constants. A fault there
  would only show on the card.
* The G1 paths the 12-word point kernels carry on the card, here on their
  plain versions: ``msm`` at 2^6 points and ``batch_scalar_mul`` lanes
  against the JAX package and a Python-int oracle, on the same seeded
  inputs.
* The GT codec, the subgroup check and ``gt_exp`` from the golden gnark
  bytes (``tests/fixtures/gt_golden.json``).

Values cross as canonical integers or gnark bytes; the tolerance is 0.
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
from gnark_crypto_tpu_torch.utils import build
from tests.test_curve_g1 import oracle_add, oracle_mul, rand_points

CPU = "cpu"
CURVES = ["bls12_381", "bls12_377"]
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "gt_golden.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the plain point versions
    are thousands of small tensor ops, and with several test workers on the
    CPU PyTorch's thread pools oversubscribe it (on 8 cores, three
    concurrent 2^6 MSMs took 965 s each with the default 8 threads, 21 s
    with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words_int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


# -- the width check ---------------------------------------------------------

# (field, words): the fields every wrapper sees, by width
ADMITTED_BY_FIELD_KERNELS = [
    ("bn254_fr", 8), ("bn254_fp", 8), ("stark_fp", 8), ("bls12_381_fr", 8),
    ("bls24_315_fp", 10), ("bls24_317_fp", 10), ("bw6_633_fr", 10),
    ("bls12_381_fp", 12), ("bls12_377_fp", 12), ("bw6_761_fr", 12),
    ("bw6_633_fp", 20), ("bw6_761_fp", 24)]
# the 256-bit 8-word fields: taken by the field, exponent and G1 point
# kernels only
FULL_WIDTH = [
    ("secp256k1_fp", 8), ("secp256k1_fr", 8), ("secp256r1_fp", 8),
    ("secp256r1_fr", 8)]
# the widths each wrapper passes to check_kernel_args / check_width, and
# the widths at which it takes a q that fills all 32W bits
WRAPPER_WIDTHS = {
    "mont_mul, exp_const, the G1 point kernels":
        (kernels.FIELD_WIDTHS, kernels.FULL_WIDTHS),
    "vm_execute": (kernels.FIELD_WIDTHS, ()),
    "ntt_radix2, ntt_four_step": (radix2.WIDTHS, ()),
    "the Fp2 point kernels": (point_add2.WIDTHS, ())}


def test_wrapper_widths():
    assert kernels.FIELD_WIDTHS == (8, 10, 12, 20, 24)
    assert radix2.WIDTHS == (8, 10, 12) and point_add2.WIDTHS == (8, 12)
    assert point_add2.PAIRS == ((8, -1), (12, -1), (12, -5))


@pytest.mark.parametrize("name,words", ADMITTED_BY_FIELD_KERNELS)
def test_width_check_admits(name, words):
    spec = tfs.get_field(name)
    assert spec.n_words == words
    kernels.check_width(spec, "mont_mul", kernels.FIELD_WIDTHS)
    if words in point_add2.WIDTHS:
        kernels.check_width(spec, "jac_add2", point_add2.WIDTHS)
    else:  # no Fp2 kernel at 10, 20 or 24 words: bls24's G2 is over
        # Fp4, bw6's over Fp
        with pytest.raises(NotImplementedError):
            kernels.check_width(spec, "jac_add2", point_add2.WIDTHS)
    if words in radix2.WIDTHS:  # bn254 Fr, bw6-633 Fr, bw6-761 Fr
        kernels.check_width(spec, "ntt_radix2 stage", radix2.WIDTHS)
    else:  # no NTT field has 20 or 24 words
        with pytest.raises(NotImplementedError):
            kernels.check_width(spec, "NTT kernel", radix2.WIDTHS)


@pytest.mark.parametrize("name,words", FULL_WIDTH)
def test_width_check_refuses(name, words):
    """Every wrapper but the field, exponent and G1 point kernels refuses
    the 256-bit 8-word fields; those take them."""
    spec = tfs.get_field(name)
    assert spec.n_words == words and kernels.FULL_WIDTHS == (8,)
    for what, (widths, full) in WRAPPER_WIDTHS.items():
        if full:
            kernels.check_width(spec, what, widths, full)
        else:
            with pytest.raises(NotImplementedError):
                kernels.check_width(spec, what, widths, full)


# (field, nr): the Fp2 pairs the kernels admit, and pairs they refuse
FP2_ADMITTED = [("bn254_fp", -1), ("bls12_381_fp", -1), ("bls12_377_fp", -5),
                ("bls12_377_fp", -1), ("bls12_381_fp", -5)]
FP2_REFUSED = [("bn254_fp", -5), ("bn254_fp", 3), ("bls12_381_fp", -7),
               ("bls12_377_fp", 5), ("bls24_315_fp", -1),
               ("bw6_761_fp", -1), ("secp256k1_fp", -1)]


def fp2_coords(spec, n=3):
    return [torch.zeros((n, 2, spec.n_words), dtype=torch.int32)
            for _ in range(3)]


@pytest.mark.parametrize("name,nr", FP2_ADMITTED)
def test_fp2_check_admits_built_pairs(name, nr):
    spec = tfs.get_field(name)
    assert point_add2._check(spec, nr, "jac_double2",
                             *fp2_coords(spec)) == 3


@pytest.mark.parametrize("name,nr", FP2_REFUSED)
def test_fp2_check_refuses_other_pairs(name, nr):
    """Refused before any launch: the check runs before the build."""
    spec = tfs.get_field(name)
    with pytest.raises(NotImplementedError):
        point_add2._check(spec, nr, "jac_double2", *fp2_coords(spec))


def test_fp2_check_refuses_bad_tensors():
    spec = tfs.get_field("bls12_381_fp")
    x, y, z = fp2_coords(spec, 4)
    for bad in (x[:, :, :8].contiguous(), x.to(torch.int64), x[::2],
                x.transpose(0, 1)):
        with pytest.raises(ValueError):
            point_add2._check(spec, -1, "jac_double2", bad, y, z)


# -- what the 12-word kernels receive ----------------------------------------

@pytest.mark.parametrize("name", ["bls12_381_fp", "bls12_377_fp"])
def test_launch_args_at_12_words(name):
    spec = tfs.get_field(name)
    q, W = spec.modulus, 12
    assert spec.n_words == W and q < 1 << (32 * W - 1)
    fw = list(build.field_words(spec))
    assert len(fw) == W + 1 and words_int(fw[:W]) == q
    assert q * fw[W] % (1 << 32) == (1 << 32) - 1        # -q^-1 mod 2^32
    assert words_int(spec.one_words) == (1 << (32 * W)) % q
    words, nbits = exp.exponent_words(spec, q - 2)
    assert len(words) == W and words_int(words) == q - 2
    assert nbits == q.bit_length()
    big = (q - 2) + 5 * (q - 1) + (1 << 400)  # past 2^384: reduced mod q-1
    words, nbits = exp.exponent_words(spec, big)
    e = words_int(words)
    assert 1 <= e < q and (e - big) % (q - 1) == 0 and nbits == e.bit_length()
    cw, a_is_zero = point_add._curve_args(spec, 0)
    assert list(cw) == [0] * W + list(spec.one_words) and a_is_zero == 1
    cw, a_is_zero = point_add._curve_args(spec, 3)
    assert words_int(list(cw)[:W]) == 3 * (1 << (32 * W)) % q
    assert a_is_zero == 0


@pytest.mark.parametrize("name", CURVES)
def test_fp2_launch_args_at_12_words(name):
    """The arguments every Fp2 entry takes after its tensors (n_words, nr,
    q's words and -q^-1 mod 2^32) and the tree level's Montgomery one,
    against Python ints, with the non-residue of the curve's G2 tower."""
    from gnark_crypto_tpu_torch.curve.g2 import g2_curve

    g2 = g2_curve(name, CPU)
    spec, nr = g2.spec.fp, g2.fp.nr
    assert nr == {"bls12_381": -1, "bls12_377": -5}[name]
    q, W = spec.modulus, 12
    n_words, got_nr, fw = point_add2._field_args(spec, nr)
    assert (n_words, got_nr) == (W, nr) and (W, nr) in point_add2.PAIRS
    fw = list(fw)
    assert len(fw) == W + 1 and words_int(fw[:W]) == q
    assert q * fw[W] % (1 << 32) == (1 << 32) - 1
    one = list(point_add2._one_words(spec))
    assert len(one) == W and words_int(one) == (1 << (32 * W)) % q
    # u^2 = nr in the tower: (0, 1)^2 == (nr, 0)
    u = g2.fp.from_int([(0, 1)], device=CPU)
    assert [c[0] for c in g2.fp.to_int(g2.fp.mul(u, u))] == [nr % q, 0]


@pytest.mark.parametrize("name", CURVES)
def test_vm_entry_constants_at_12_words(name):
    """The entry rows of a bls12 pairing program: each constant in
    Montgomery form (R = 2^384) at its register, inputs zero."""
    prog = vm_pairing.build_program(name, "product")
    spec = prog.spec
    assert spec.n_words == 12
    rows = vm._entry_consts(prog, CPU).numpy().view(np.uint32)
    assert rows.shape == (prog.n_entry, 12)
    consts = dict(prog.entry_consts)
    assert consts and len(consts) + len(prog.entry_inputs) == prog.n_entry
    for reg in range(prog.n_entry):
        want = consts.get(reg, 0) * (1 << 384) % spec.modulus
        assert words_int(rows[reg]) == want
    # the register file of every bls12 program fits one block at 32 lanes
    for variant in ("full", "miller", "product", "reduce"):
        p = vm_pairing.build_program(name, variant)
        assert p.n_regs * 12 * 4 * p.tile <= vm.SMEM_BYTES


# -- the G1 paths on their plain versions ------------------------------------

def g1_case(name, n, seed):
    spec = tcs.get_curve(f"{name}_g1")
    curve = curve_ops(spec)
    pts = rand_points(curve, n, seed=seed)
    rng = random.Random(seed)
    ks = [rng.randrange(spec.fr.modulus) for _ in range(n)]
    ks[0] = 0
    pts[1] = None
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


# Each seeded case is held in two tests against one Python-int oracle, so
# that port == JAX as integers: the port's MSM costs ~17 s here (the plain
# width-1 window fold) and the JAX MSM's compile ~19 s, and one test of
# both would pass 30 s; so would one test of both batch_scalar_mul runs.

@pytest.mark.parametrize("name", CURVES)
def test_bls12_g1_msm_plain_matches_oracle(name):
    """2^6 points (one infinite, one zero scalar): the port's MSM on the
    plain point versions against the Python-int oracle."""
    spec, curve, pts, ks = g1_case(name, 64, 61)
    got = tpp.msm(spec, to_port(curve, pts),
                  curve.fr.from_int(ks, mont=False, device=CPU))
    assert affine_ints(curve, got) == [msm_oracle(spec, pts, ks)]


@pytest.mark.parametrize("name", CURVES)
def test_bls12_g1_msm_jax_matches_oracle(name):
    """The JAX MSM on the same inputs, carried across by ``convert``, gives
    the oracle's point too."""
    spec, curve, pts, ks = g1_case(name, 64, 61)
    jspec = jcs.get_curve(spec.name)
    jc = jcurve_ops(jspec)
    jP = JAffine(*convert.point_to_jax(spec.fp, to_port(curve, pts)))
    want = jc.to_affine(jpp.msm(jspec, jP, jc.fr.from_int(ks, mont=False)))
    x, y = (jmont.to_int(jspec.fp, np.asarray(c).reshape(1, -1))[0]
            for c in want)
    assert (x, y) == msm_oracle(spec, pts, ks)


def bsm_case(name):
    spec = tcs.get_curve(f"{name}_g1")
    r = spec.fr.modulus
    rng = random.Random(9)
    ks = [0, 1, 2, r - 1] + [rng.randrange(r) for _ in range(4)]
    want = [oracle_mul((spec.gx, spec.gy), k, spec.fp.modulus, 0)
            for k in ks]
    return spec, ks, want


@pytest.mark.parametrize("name", CURVES)
def test_bls12_batch_scalar_mul_plain_matches_oracle(name):
    """[k]G1 for 8 lanes (0, 1, 2, r - 1 and random) by the port."""
    spec, ks, want = bsm_case(name)
    curve = curve_ops(spec)
    got = tpp.batch_scalar_mul(spec, curve.generator_affine(device=CPU),
                               curve.fr.from_int(ks, mont=False, device=CPU))
    assert affine_ints(curve, got) == want


@pytest.mark.parametrize("name", CURVES)
def test_bls12_batch_scalar_mul_jax_matches_oracle(name):
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


# -- GT from the golden bytes ------------------------------------------------

@pytest.mark.parametrize("name", CURVES)
def test_bls12_gt_codec_subgroup_and_exp(name):
    with open(GOLDEN) as f:
        golden = json.load(f)[name]
    data = bytes.fromhex(golden["generator"])
    z = gt_bytes.gt_from_bytes(name, data, device=CPU)
    assert gt_bytes.gt_to_bytes(name, z)[0] == data
    assert bool(api.gt_is_in_subgroup(name, z))
    z35 = api.gt_exp(name, z, 35)   # e(G1, G2)^35 = e([5]G1, [7]G2)
    assert gt_bytes.gt_to_bytes(name, z35)[0].hex() == golden["p5_q7"]
