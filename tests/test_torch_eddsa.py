"""The port's twisted Edwards curves, EdDSA, MiMC and the stark Pedersen hash
against the JAX package's, on the CPU.

* ``curve/twistededwards.py``: on all 8 registered curves, the generator
  on the curve, [k]G, G + G == 2G, [order]G == identity and the point codec
  equal the JAX ``ted_curve``'s as canonical integers and bytes; the
  bandersnatch GLV ladder equals the plain ladder and the JAX one.
* ``signature/eddsa.py``: ``EdDSA("bn254")`` (Baby Jubjub) and
  ``EdDSA("bls12_381")``: the same key, the same signature bytes, verify
  True, tampered False, s + order, s = 0 and an identity R rejected, and
  the codecs, with keys and signatures crossing through ``convert``.
* ``hashes/mimc.py``: ``hash_elements`` on small batches, ``write`` /
  ``sum`` bytes, ``set_state`` / ``state`` and the canonical checks, on the
  8 MiMC fields.
* ``hashes/pedersen_hash.py``: the Starkware vector pedersen(1, 2), a batch
  of random pairs against the JAX package, and ``pedersen_array`` against
  a Python-int curve.

The tolerance is 0. The port runs its plain versions here.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.curve import twistededwards as jted
from gnark_crypto_tpu.hashes import mimc as jmimc
from gnark_crypto_tpu.hashes import pedersen_hash as jped
from gnark_crypto_tpu.signature import eddsa as jeddsa
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve import twistededwards as ted
from gnark_crypto_tpu_torch.hashes import mimc, pedersen_hash
from gnark_crypto_tpu_torch.signature import eddsa
from gnark_crypto_tpu_torch.specs import field as tfs
from tests.test_curve_g1 import oracle_add, oracle_mul

CPU = "cpu"
TEDS = ["bn254", "bls12_377", "bls12_381", "bandersnatch", "bls24_315",
        "bls24_317", "bw6_761", "bw6_633"]
MSG = (123).to_bytes(32, "big")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the CPU; the plain versions are many small tensor ops)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def aff_ints(c, p) -> list:
    xs, ys = c.f.to_int(p.x), c.f.to_int(p.y)
    if not isinstance(xs, list):
        xs, ys = [xs], [ys]
    return list(zip(xs, ys))


# -- twisted Edwards ----------------------------------------------------------

@pytest.mark.parametrize("name", TEDS)
def test_ted_curve_matches_jax(name):
    """Spec, generator, [k]G for three k (one of them the order), G + G and
    2G, and the codec both ways equal the JAX curve's."""
    pc, jc = ted.ted_curve(name, CPU), jted.ted_curve(name)
    s, js = pc.spec, jc.spec
    assert (s.a, s.d, s.cofactor, s.order, s.gx, s.gy, s.endo,
            s.glv_lambda, s.base.name) == (
        js.a, js.d, js.cofactor, js.order, js.gx, js.gy, js.endo,
        js.glv_lambda, js.base.name)
    g = pc.generator_affine((1,))
    assert bool(pc.on_curve_affine(g)[0])
    ge = pc.from_affine(g)
    assert (aff_ints(pc, pc.to_affine(pc.add(ge, ge)))
            == aff_ints(pc, pc.to_affine(pc.double(ge))))
    rng = random.Random(name)
    ks = [rng.randrange(s.order), 5, s.order]
    got = pc.to_affine(pc.scalar_mul_int(
        pc.from_affine(pc.generator_affine((3,))), ks))
    jg = jc.from_affine(jc.generator_affine((3,)))
    want = jc.to_affine(jc.scalar_mul_int(jg, ks))
    assert aff_ints(pc, got) == aff_ints(jc, want)
    assert aff_ints(pc, got)[2] == (0, 1)            # [order]G
    bufs = pc.point_to_bytes(got)
    assert bufs == jc.point_to_bytes(want)
    back = pc.point_from_bytes(bufs[:2], device=CPU)
    assert aff_ints(pc, back) == aff_ints(pc, got)[:2]
    with pytest.raises(ValueError):
        pc.point_from_bytes([b"\xff" * s.base.n_bytes])


def test_bandersnatch_glv_matches_ladder_and_jax():
    """scalar_mul_glv (the phi endomorphism and the split scalar) equals
    the plain double-and-add and the JAX GLV ladder."""
    pc, jc = ted.ted_curve("bandersnatch", CPU), jted.ted_curve("bandersnatch")
    r = pc.spec.order
    ks = [r - 1, 7, random.Random(3).randrange(r)]
    p = pc.from_affine(pc.generator_affine((3,)))
    glv = pc.to_affine(pc.scalar_mul_glv(p, ks))
    plain = pc.to_affine(pc.scalar_mul_int(p, ks))
    assert aff_ints(pc, glv) == aff_ints(pc, plain)
    jp = jc.from_affine(jc.generator_affine((3,)))
    assert aff_ints(pc, glv) == aff_ints(
        jc, jc.to_affine(jc.scalar_mul_glv(jp, ks)))
    lam = pc.spec.glv_lambda
    assert aff_ints(pc, pc.to_affine(pc.phi(p))) == aff_ints(
        pc, pc.to_affine(pc.scalar_mul_int(p, [lam] * 3)))


def test_tonelli_matches_jax():
    rng = random.Random(5)
    for spec in (tfs.BN254_FR, tfs.BLS12_381_FR, tfs.STARK_FP):
        q = spec.modulus
        for _ in range(4):
            v = rng.randrange(q) ** 2 % q
            got = ted._tonelli_int(v, q)
            assert got == jted._tonelli_int(v, q) and got * got % q == v


# -- EdDSA --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_eddsa_matches_jax(name):
    """The same key and signature bytes in both packages; the port verifies
    its signature and the JAX one verifies the port's (crossed through
    ``convert``); a tampered message fails."""
    pe, je = eddsa.EdDSA(name, device=CPU), jeddsa.EdDSA(name)
    seed = bytes(range(32))
    pk, jk = pe.generate_key(seed), je.generate_key(seed)
    assert (pk.scalar, pk.rand_src) == (jk.scalar, jk.rand_src)
    assert pe.public_key_to_bytes(pk.public_key) == \
        je.public_key_to_bytes(jk.public_key)
    sig, jsig = pe.sign(pk, MSG), je.sign(jk, MSG)
    assert pe.signature_to_bytes(sig) == je.signature_to_bytes(jsig)
    assert pe.verify(pk.public_key, sig, MSG)
    assert not pe.verify(pk.public_key, sig, (124).to_bytes(32, "big"))
    # crossing: the JAX signature verifies in the port, the port's key and
    # signature in the JAX package
    psig = convert.eddsa_signature_from_jax(name, jsig, device=CPU)
    ppub = convert.eddsa_key_from_jax(name, jk, device=CPU).public_key
    assert pe.verify(ppub, psig, MSG)
    jpub = convert.eddsa_key_to_jax(name, pk.public_key)["a"]
    jsig2 = convert.eddsa_signature_to_jax(name, sig)
    assert je.verify(jeddsa.PublicKey(jted.AffinePoint(*jpub)),
                     jeddsa.Signature(jted.AffinePoint(*jsig2["r"]),
                                      jsig2["s"]), MSG)
    priv = convert.eddsa_key_to_jax(name, pk)
    assert (priv["scalar"], priv["rand_src"]) == (jk.scalar, jk.rand_src)


def test_eddsa_secret_ladders_add_every_step(monkeypatch):
    """generate_key and sign ladder the secret scalar and the nonce r
    regularly, one add a bit whatever the bits; a public ladder of a scalar
    with one set bit adds once, and the regular ladder gives the same
    point."""
    ed = eddsa.EdDSA("bn254", device=CPU)
    c = ed.curve
    nbits = 8 * ed.nb           # the key scalar and r are nb bytes
    adds, add = [], c.add
    monkeypatch.setattr(c, "add", lambda p, q: adds.append(1) or add(p, q))
    priv = ed.generate_key(b"\x03" * 32)
    assert len(adds) == nbits
    adds.clear()
    ed.sign(priv, MSG)
    assert len(adds) == nbits
    adds.clear()
    one = c.scalar_mul_int(ed._base(), [1 << 100])
    assert len(adds) == 1
    adds.clear()
    reg = c.scalar_mul_int(ed._base(), [1 << 100], nbits, regular=True)
    assert len(adds) == nbits
    assert aff_ints(c, c.to_affine(one)) == aff_ints(c, c.to_affine(reg))


def test_eddsa_rejects_malleable_and_codecs():
    """s + order, s = 0 and an identity R are rejected by verify and by the
    signature codec; the signature and key codecs round trip."""
    ed = eddsa.EdDSA("bn254", device=CPU)
    priv = ed.generate_key(b"\x02" * 32)
    msg = (7).to_bytes(32, "big")
    sig = ed.sign(priv, msg)
    order = ed.curve.spec.order
    s_int = int.from_bytes(sig.s, "big")
    for s in (s_int + order, 0):
        bad = eddsa.Signature(sig.r, s.to_bytes(ed.nb, "big"))
        assert not ed.verify(priv.public_key, bad, msg)
        with pytest.raises(ValueError):
            ed.signature_from_bytes(ed.signature_to_bytes(bad))
    c = ed.curve
    ident = c.to_affine(c.identity_ext((1,), device=CPU))
    assert aff_ints(c, ident) == [(0, 1)]
    assert not ed.verify(priv.public_key, eddsa.Signature(ident, sig.s), msg)
    sig2 = ed.signature_from_bytes(ed.signature_to_bytes(sig))
    assert aff_ints(c, sig2.r) == aff_ints(c, sig.r) and sig2.s == sig.s
    pub2 = ed.public_key_from_bytes(ed.public_key_to_bytes(priv.public_key))
    assert aff_ints(c, pub2.a) == aff_ints(c, priv.public_key.a)
    assert eddsa._pad_blocks(b"\x01\x02", 32, ed.curve.spec.base.modulus) \
        == bytes(30) + b"\x01\x02"
    with pytest.raises(ValueError):
        eddsa._pad_blocks(b"\xff" * 32, 32, ed.curve.spec.base.modulus)


# -- MiMC ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(mimc.PARAMS))
def test_mimc_matches_jax(name):
    """Round constants, hash_elements over a (2, 3) batch (with and without
    a chaining value) and the write / sum bytes equal the JAX hasher's."""
    spec = tfs.get_field(name)
    jspec = jmimc.fs.get_field(name)
    assert mimc.constants(spec) == jmimc.constants(jspec)
    assert mimc.PARAMS[name] == jmimc.PARAMS[name]
    rng = random.Random(name)
    q = spec.modulus
    vals = [rng.randrange(q) for _ in range(6)]
    ph, jh = mimc.MiMC(spec, CPU), jmimc.MiMC(jspec)
    blocks = ph.eng.from_int(vals, mont=False, device=CPU).reshape(2, 3, -1)
    jblocks = jh.eng.from_int(vals, mont=False).reshape(2, 3, -1)
    for h0 in (0, vals[0]):
        got = ph.eng.to_int(ph.hash_elements(blocks, h0=h0), mont=False)
        want = jh.eng.to_int(jh.hash_elements(jblocks, h0=h0), mont=False)
        assert got == [v % q for v in want]
    data = b"".join(v.to_bytes(spec.n_bytes, "big") for v in vals[:2])
    ph.write(data)
    jh.write(data)
    assert ph.sum() == jh.sum()
    ph.write(data[:spec.n_bytes])
    jh.write(data[:spec.n_bytes])
    assert ph.state() == jh.state()


def test_mimc_host_api_and_converters():
    """set_state / reset / the canonical checks, as the reference's; a
    hasher with buffered blocks crosses both ways through ``convert``."""
    h = mimc.mimc("bn254_fr", CPU)
    assert h is mimc.mimc("bn254_fr", "cpu")
    h.reset()
    nb, q = h.spec.n_bytes, h.spec.modulus
    assert h.sum() == bytes(nb)
    with pytest.raises(ValueError):
        h.write(b"\x01" * (nb - 1))
    with pytest.raises(ValueError):
        h.write(q.to_bytes(nb, "big"))
    with pytest.raises(ValueError):
        h.set_state(q.to_bytes(nb, "big"))
    h.write((5).to_bytes(nb, "big"))
    with pytest.raises(ValueError):
        h.set_state(bytes(nb))
    jh = jmimc.MiMC(jmimc.fs.get_field("bn254_fr"))
    jh.write((9).to_bytes(nb, "big"))
    ph = convert.mimc_from_jax(jh, device=CPU)
    st = convert.mimc_to_jax(ph)
    assert st == {"field": "bn254_fr", "state": 0,
                  "data": [(9).to_bytes(nb, "big")]}
    assert ph.sum() == jh.sum()
    ph.set_state(ph.state())
    ph.write((3).to_bytes(nb, "big"))
    jh.write((3).to_bytes(nb, "big"))
    assert ph.sum() == jh.sum()
    h.reset()


# -- the stark Pedersen hash --------------------------------------------------

def test_pedersen_matches_jax():
    """A batch of 3 random pairs (one with the high nibble set) equals the
    JAX package's hashes."""
    rng = random.Random(9)
    p = tfs.STARK_FP.modulus
    a = [rng.randrange(p) for _ in range(2)] + [(1 << 251) + 5]
    b = [rng.randrange(p) for _ in range(2)] + [0]
    assert (pedersen_hash.pedersen(a, b, device=CPU)
            == jped.pedersen(a, b))
    assert np.all(np.asarray(pedersen_hash.P) == np.asarray(jped.P))


def pedersen_oracle(a: int, b: int) -> int:
    """shift + [a lo]P0 + [a hi]P1 + [b lo]P2 + [b hi]P3 on Python
    integers (the stark curve, a = 1)."""
    p = tfs.STARK_FP.modulus
    acc = pedersen_hash.SHIFT
    m = (1 << 248) - 1
    for k, base in ((a & m, 0), (a >> 248, 1), (b & m, 2), (b >> 248, 3)):
        acc = oracle_add(acc, oracle_mul(pedersen_hash.P[base], k, p, 1),
                         p, 1)
    return acc[0]


def test_pedersen_vector_and_array():
    """pedersen(1, 2) is Starkware's vector; pedersen_array (the left fold
    and the length) equals the same fold on Python integers."""
    want = 0x5bb9440e27889a364bcb678b1f679ecd1347acdedcbf36e83494f857cc58026
    assert pedersen_hash.pedersen([1], [2], device=CPU) == [want]
    assert pedersen_oracle(1, 2) == want
    d = pedersen_oracle(pedersen_oracle(0, 5), 6)
    assert pedersen_hash.pedersen_array([5, 6], device=CPU) == \
        pedersen_oracle(d, 2)
