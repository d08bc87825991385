"""The port's bn254 pairing slice against the JAX package and the golden GT
bytes, on the CPU.

* Towers on word tensors: GT exponentiation (NAF and Frobenius-GLV), the
  subgroup check and the gnark GT codec, starting from the golden
  e(G1, G2) bytes (``tests/fixtures/gt_golden.json``, written by the
  independent oracle ``tests/gt_oracle.py``), so no pairing runs.
* G2 over Fp2 and ``convert`` round trips against the JAX package.
* The slice as a whole: ``pair`` and ``pairing_check`` through the VM
  programs on the plain executor, once at one tile (the ``full`` program)
  and once with the tile cut to 2 lanes so that the multi-tile chain
  (``miller``, ``product``, ``reduce``) runs. A program costs about a
  minute on the plain executor here, so each case runs one pairing.

Values cross as canonical integers or gnark bytes; the tolerance is 0.
"""

import json
import os

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.curve.g2 import g2_curve as jax_g2_curve
from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
from gnark_crypto_tpu.towers.tower12 import get_tower as jax_get_tower
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, curve_ops
from gnark_crypto_tpu_torch.io import gt_bytes
from gnark_crypto_tpu_torch.pairing import api, vm_pairing
from gnark_crypto_tpu_torch.specs import curve as cs

NAME = "bn254"
DEV = "cpu"
_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "gt_golden.json")


def golden(key):
    with open(_FIX) as f:
        return json.load(f)[NAME][key]


def gt_golden(key):
    return gt_bytes.gt_from_bytes(NAME, bytes.fromhex(golden(key)),
                                  device=DEV)


def g1_points(ks):
    """[k]G1 for each signed k, affine (n, 8); k = 0 gives infinity."""
    g1 = curve_ops(cs.get_curve(f"{NAME}_g1"))
    r = g1.spec.fr.modulus
    G = g1.generator_jac(device=DEV)
    n = len(ks)
    s = g1.fr.from_int([k % r for k in ks], mont=False, device=DEV)
    return g1.to_affine(g1.scalar_mul(
        type(G)(*(c.expand(n, -1) for c in G)), s))


def g2_points(ks):
    """[k]G2 for each k > 0, affine (n, 2, 8)."""
    g2 = g2_curve(NAME, DEV)
    Q = g2.generator_jac(device=DEV)
    n = len(ks)
    s = g2.fr.from_int(ks, mont=False, device=DEV)
    return g2.to_affine(g2.scalar_mul(
        type(Q)(*(c.expand(n, -1, -1) for c in Q)), s,
        nbits=max(ks).bit_length()))


# ---------------------------------------------------------------------------
# towers on word tensors, GT codec
# ---------------------------------------------------------------------------

def test_gt_bytes_round_trip_and_rejects():
    data = bytes.fromhex(golden("generator"))
    z = gt_bytes.gt_from_bytes(NAME, data, device=DEV)
    assert z.shape == (2, 3, 2, 8)
    assert gt_bytes.gt_to_bytes(NAME, z) == [data]
    two = torch.stack([z, gt_golden("p5_q7")])
    assert gt_bytes.gt_to_bytes(NAME, two) == [data, bytes.fromhex(
        golden("p5_q7"))]
    assert gt_bytes.gt_size(NAME) == len(data) == 384
    with pytest.raises(ValueError):
        gt_bytes.gt_from_bytes(NAME, data[:-1], device=DEV)
    with pytest.raises(ValueError):
        gt_bytes.gt_from_bytes(NAME, b"\xff" * 384, device=DEV)


def test_gt_exp_golden_generator_to_p5_q7():
    """e(G1, G2)^35 == e([5]G1, [7]G2), as gnark bytes."""
    z = api.gt_exp(NAME, gt_golden("generator"), 35)
    assert gt_bytes.gt_to_bytes(NAME, z)[0].hex() == golden("p5_q7")
    inv = api.gt_exp(NAME, z, -1)
    e12 = api.gt_engine(NAME, DEV)
    assert bool(e12.equal(e12.mul(z, inv), e12.ones()))


def test_gt_is_in_subgroup():
    e12 = api.gt_engine(NAME, DEV)
    rng = np.random.default_rng(11)
    p = cs.get_curve(f"{NAME}_g1").fp.modulus
    rand = e12.from_int(tuple(tuple(tuple(
        int.from_bytes(rng.bytes(32), "big") % p for _ in range(2))
        for _ in range(3)) for _ in range(2)))
    z = torch.stack([gt_golden("generator"), rand])
    assert api.gt_is_in_subgroup(NAME, z).tolist() == [True, False]


def test_gt_exp_glv_matches_naf():
    """|e| >= 2^129 takes the Frobenius-GLV ladder; on an order-r element
    it equals the NAF ladder."""
    z = gt_golden("generator")
    e = (1 << 129) + 0x5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A
    tw = vm_pairing.get_ctx(NAME, DEV).tower
    assert torch.equal(api.gt_exp(NAME, z, e), tw.gt_exp(z, e))


def test_tower12_sparse_compressed_and_torus_forms():
    """The sparse line products equal the dense E12 product, Karabina's
    compressed square decompresses to the cyclotomic square, and the torus
    map round-trips, on the golden GT element and random E2 coefficients
    (the forms the pairing programs do not all use)."""
    tw = vm_pairing.get_ctx(NAME, DEV).tower
    e2, e12 = tw.e2, tw.e12
    rng = np.random.default_rng(5)
    p = tw.p
    c = [e2.from_int((int.from_bytes(rng.bytes(32), "big") % p,
                      int.from_bytes(rng.bytes(32), "big") % p))
         for _ in range(5)]
    one, zero = e2.ones(), e2.zeros()
    z = gt_golden("generator")
    for got, coeffs in (
            (tw.mul_by_034(z, c[0], c[1], c[2]),
             [c[0], zero, zero, c[1], c[2], zero]),
            (tw.mul_by_014(z, c[0], c[1], c[2]),
             [c[0], c[1], zero, zero, c[2], zero]),
            (tw.mul_by_34(z, c[0], c[1]), [one, zero, zero, c[0], c[1], zero]),
            (tw.mul_by_01(z, c[0], c[1]), [c[0], c[1], zero, zero, one, zero]),
            (tw.mul_by_01234(z, c), c + [zero]),
            (tw.mul_by_01245(z, c), c[:3] + [zero] + c[3:])):
        assert torch.equal(got, e12.mul(z, tw.from_coeffs6(coeffs)))
    d0, d1, c0, c1 = c[:4]
    for fn, fill, slots in (
            (tw.mul_34_by_34, lambda a, b: [one, zero, zero, a, b, zero],
             (0, 1, 2, 3, 4)),
            (tw.mul_01_by_01, lambda a, b: [a, b, zero, zero, one, zero],
             (0, 1, 2, 4, 5))):
        dense = tw.coeffs6(e12.mul(tw.from_coeffs6(fill(d0, d1)),
                                   tw.from_coeffs6(fill(c0, c1))))
        assert all(torch.equal(x, dense[i])
                   for x, i in zip(fn(d0, d1, c0, c1), slots))
    sq = tw.cyclotomic_square(z)
    assert torch.equal(
        tw.decompress_karabina(tw.cyclotomic_square_compressed(z)), sq)
    assert torch.equal(tw.decompress_torus(tw.compress_torus(z)), z)
    assert torch.equal(tw.frobenius_cube(z),
                       tw.frobenius(tw.frobenius_square(z)))


def test_other_families_raise():
    """Every pairing family is ported (BLS24 and BW6 since their slices:
    tests/test_torch_bls24.py, tests/test_torch_bw6.py): the BW6 facade
    gives the E6 engine, and a curve with no pairing raises."""
    P = Affine(torch.zeros(1, 8, dtype=torch.int32),
               torch.zeros(1, 8, dtype=torch.int32))
    for name, W in (("bw6_633", 20), ("bw6_761", 24)):
        assert api.gt_engine(name, "cpu").ones(device="cpu").shape == (
            2, 3, W)
    with pytest.raises(KeyError):
        api.pair("secp256k1", P, P.x, P.y)


# ---------------------------------------------------------------------------
# G2 and conversion against the JAX package
# ---------------------------------------------------------------------------

def test_g2_generator_and_scalar_mul_match_jax():
    g2 = g2_curve(NAME, DEV)
    fp = g2.spec.fp
    assert bool(g2.on_curve_affine(g2.generator_affine(device=DEV)))
    got = g2_points([7, 5])
    assert g2.on_curve_affine(got).all()

    jg2 = jax_g2_curve(NAME)
    gq = jg2.generator_affine()
    QJ = jg2.from_affine(JAffine(jg2.fp.broadcast_to(gq.x, (2,)),
                                 jg2.fp.broadcast_to(gq.y, (2,))))
    want = jg2.to_affine(jg2.scalar_mul(
        QJ, jg2.fr.from_int([7, 5], mont=False), nbits=3))
    for c, w in zip(got, want):
        assert torch.equal(c, convert.from_jax_limbs(fp, np.asarray(w),
                                                     device=DEV))


def test_convert_round_trips_e2_e12_g2():
    jtw = jax_get_tower(NAME)
    tw = vm_pairing.get_ctx(NAME, DEV).tower
    fp = tw.fp_spec
    rng = np.random.default_rng(3)

    def rnd():
        return int.from_bytes(rng.bytes(32), "big") % fp.modulus

    e12 = [tuple(tuple(tuple(rnd() for _ in range(2)) for _ in range(3))
                 for _ in range(2)) for _ in range(3)]
    e2 = [(rnd(), rnd()) for _ in range(4)]
    for jeng, eng, vals in ((jtw.e12, tw.e12, e12), (jtw.e2, tw.e2, e2)):
        limbs = np.asarray(jeng.from_int(vals))
        words = convert.from_jax_limbs(fp, limbs, device=DEV)
        assert torch.equal(words, eng.from_int(vals, device=DEV))
        back = convert.to_jax_limbs(fp, words)
        assert back.shape == limbs.shape
        assert [eng.to_int(w) for w in words] == vals
        assert [jeng.to_int(b) for b in back] == vals
    Q = g2_points([3, 4])
    jQ = convert.point_to_jax(fp, Q)
    assert all(torch.equal(a, b) for a, b in
               zip(convert.point_from_jax(fp, jQ, device=DEV), Q))


# ---------------------------------------------------------------------------
# the slice as a whole: pair and pairing_check on the plain executor
# ---------------------------------------------------------------------------

def test_pair_one_tile_equals_golden_p5_q7():
    """([5]G1, [7]G2) and (inf, G2) in one tile: the ``full`` program, with
    the infinite lane masked out."""
    P = g1_points([5, 0])
    Q7 = g2_points([7])
    gq = g2_curve(NAME, DEV).generator_affine(device=DEV)
    QX, QY = torch.stack([Q7.x[0], gq.x]), torch.stack([Q7.y[0], gq.y])
    z = api.pair(NAME, P, QX, QY)
    assert gt_bytes.gt_to_bytes(NAME, z)[0].hex() == golden("p5_q7")


@pytest.mark.parametrize("tamper", [False, True])
def test_multi_tile_chain_pairing_check(monkeypatch, tamper):
    """Five pairs at a tile of 2 lanes: ``miller`` over three tiles, one
    ``product`` fold, then ``reduce``. The exponents sum to 0 (True); with
    one G1 point changed they do not (False)."""
    monkeypatch.setitem(vm_pairing._TILE, NAME, 2)
    ks = [5, -35, 0, 3, -2 if tamper else -3]
    P = g1_points(ks)
    Q = g2_points([7, 1, 1, 1, 1])
    calls = []
    execute = vm_pairing.vm.execute

    def spy(prog, inputs, n):
        calls.append(prog.n_instrs)
        return execute(prog, inputs, n)

    monkeypatch.setattr(vm_pairing.vm, "execute", spy)
    ok = api.pairing_check(NAME, P, Q.x, Q.y)
    assert bool(ok) is (not tamper)
    assert calls == [vm_pairing.program(NAME, v).n_instrs
                     for v in ("miller", "product", "reduce")]
