"""The port's ECDSA (``signature/ecdsa.py``) against the JAX package's, on
the CPU.

For secp256k1, secp256r1 (256-bit 8-word fields), the stark curve (whose
recovery takes Tonelli-Shanks) and bls12-381 G1 (cofactor > 1, 12-word
Fp): the same seed and message go to both packages, and the key, the
recoverable signature (v, r, s), its bytes, ``verify`` on an honest and a
tampered message, and the recovered public key must be equal, with keys
crossing through ``convert.ecdsa_key_from_jax`` / ``ecdsa_key_to_jax``.
Also the known secp256k1 vector of ``tests/test_signatures.py`` (an
independent Python-int signature) and the rejection of an infinity, an
off-curve and an out-of-range public key or signature. The port runs its
plain versions here; on the card the same calls launch the full-width
point kernels (``chip_smoke.py``).
"""

import hashlib

import pytest
import torch

from gnark_crypto_tpu.curve.jacobian import Affine as JAffine
from gnark_crypto_tpu.signature import ecdsa as jecdsa
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.jacobian import Affine
from gnark_crypto_tpu_torch.signature import ecdsa
from tests.test_curve_g1 import oracle_mul

CPU = "cpu"
CURVES = ["secp256k1_g1", "secp256r1_g1", "stark_g1", "bls12_381_g1"]
MSG = b"the quick brown fox"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the CPU; the plain point versions are many small tensor ops)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def seed_of(name: str) -> bytes:
    return b"torch-ecdsa-" + name.encode()


def key_ints(e, pub) -> tuple:
    f = e.curve.fp
    return f.to_int(pub.q.x)[0], f.to_int(pub.q.y)[0]


def jax_pub(name: str, pub) -> jecdsa.PublicKey:
    """The port's public key as the JAX package's."""
    q = convert.ecdsa_key_to_jax(name, pub)["q"]
    return jecdsa.PublicKey(JAffine(q.x, q.y))


@pytest.mark.parametrize("name", CURVES)
def test_key_and_signature_match_jax(name):
    """generate_key and sign_for_recover: the same d, public key, (v, r, s)
    and signature bytes in both packages; the bytes decode back."""
    je, pe = jecdsa.ECDSA(name), ecdsa.ECDSA(name, device=CPU)
    jk, pk = je.generate_key(seed_of(name)), pe.generate_key(seed_of(name))
    assert pk.d == jk.d
    assert key_ints(pe, pk.public_key) == key_ints(je, jk.public_key)
    jv, js = je.sign_for_recover(MSG, jk)
    pv, ps = pe.sign_for_recover(MSG, pk)
    assert (pv, ps.r, ps.s) == (jv, js.r, js.s)
    assert ps.s <= (pe.order - 1) // 2          # low s (BIP-62)
    assert pe.sign(MSG, pk) == ps
    buf = pe.signature_to_bytes(ps)
    assert buf == je.signature_to_bytes(js)
    assert pe.signature_from_bytes(buf) == ps
    # the key crosses both ways
    back = convert.ecdsa_key_from_jax(name, jk, device=CPU)
    assert back.d == jk.d
    assert key_ints(pe, back.public_key) == key_ints(pe, pk.public_key)
    assert convert.ecdsa_key_to_jax(name, pk)["d"] == jk.d


@pytest.mark.parametrize("name", CURVES)
def test_verify_matches_jax(name):
    """The port's verify of its own signature is True, and so is the JAX
    verify of the port's signature and key."""
    je, pe = jecdsa.ECDSA(name), ecdsa.ECDSA(name, device=CPU)
    pk = pe.generate_key(seed_of(name))
    sig = pe.sign(MSG, pk)
    assert pe.verify(MSG, sig, pk.public_key)
    jsig = jecdsa.Signature(sig.r, sig.s)
    assert je.verify(MSG, jsig, jax_pub(name, pk.public_key))


@pytest.mark.parametrize("name", CURVES)
def test_tampered_verify_is_false(name):
    """The port's verify is False on a tampered message and on s + 1, as
    the JAX verify is (``tests/test_signatures.py``)."""
    pe = ecdsa.ECDSA(name, device=CPU)
    pk = pe.generate_key(seed_of(name))
    sig = pe.sign(MSG, pk)
    assert not pe.verify(MSG + b"!", sig, pk.public_key)
    bad = ecdsa.Signature(sig.r, (sig.s + 1) % pe.order)
    assert not pe.verify(MSG, bad, pk.public_key)


@pytest.mark.parametrize("name", CURVES)
def test_recover_matches_jax(name):
    """recover_public_key from the JAX signature gives the signer's key in
    both packages; the other parity gives another key or none."""
    je, pe = jecdsa.ECDSA(name), ecdsa.ECDSA(name, device=CPU)
    jk = je.generate_key(seed_of(name))
    v, js = je.sign_for_recover(MSG, jk)
    sig = ecdsa.Signature(js.r, js.s)
    rec = pe.recover_public_key(MSG, v, sig)
    assert key_ints(pe, rec) == key_ints(je, jk.public_key)
    jrec = je.recover_public_key(MSG, v, js)
    assert key_ints(je, jrec) == key_ints(pe, rec)
    try:
        other = pe.recover_public_key(MSG, v ^ 1, sig)
        assert key_ints(pe, other) != key_ints(pe, rec)
    except ValueError:
        pass


@pytest.mark.parametrize("name", ["secp256k1_g1", "secp256r1_g1"])
def test_secret_ladders_add_every_step(name, monkeypatch):
    """generate_key and sign_for_recover ladder their secret scalars
    regularly, one add a bit whatever the bits; a public ladder of a scalar
    with one set bit adds once, and the regular ladder gives the same
    point."""
    e = ecdsa.ECDSA(name, device=CPU)
    c, nbits = e.curve, e.order.bit_length()
    adds, add = [], e.curve.add
    monkeypatch.setattr(c, "add", lambda p, q: adds.append(1) or add(p, q))
    key = e.generate_key(seed_of(name))
    assert len(adds) == nbits
    adds.clear()
    e.sign_for_recover(MSG, key)
    # one ladder a nonce; a nonce giving a high s is drawn again
    assert adds and len(adds) % nbits == 0
    adds.clear()
    one = c.scalar_mul(e._g(), e._fr(1 << 100))
    assert len(adds) == 1
    adds.clear()
    reg = c.scalar_mul(e._g(), e._fr(1 << 100), regular=True)
    assert len(adds) == nbits
    assert all(torch.equal(u, v) for u, v in zip(one, reg))


def test_known_secp256k1_vector():
    """The fixed (d, h, k) of ``tests/test_signatures.py``: (r, s) from an
    independent Python-int curve, verified by the port; the same s with
    another r does not verify."""
    e = ecdsa.ECDSA("secp256k1_g1", device=CPU)
    n, p = e.order, e.spec.fp.modulus
    d, h, k = 0x1234567890ABCDEF, 0xDEADBEEF, 0x1111111111111111
    g = (e.spec.gx, e.spec.gy)
    r = oracle_mul(g, k, p, 0)[0] % n
    s = pow(k, -1, n) * (h + r * d) % n

    class FixedHash:
        def __init__(self, data):
            pass

        def digest(self):
            return h.to_bytes(32, "big")

    pub = ecdsa.PublicKey(e._base_mul(d))
    assert key_ints(e, pub) == oracle_mul(g, d, p, 0)
    assert e.verify(b"ignored", ecdsa.Signature(r, s), pub,
                    hasher=FixedHash)
    assert not e.verify(b"ignored", ecdsa.Signature((r + 1) % n, s), pub,
                        hasher=FixedHash)


@pytest.mark.parametrize("name", ["secp256k1_g1", "secp256r1_g1"])
def test_rejects_bad_keys_and_scalars(name):
    """verify refuses the infinity public key, an off-curve point and
    r or s out of (0, n) before any ladder, as the JAX verify does;
    recovery refuses out-of-range scalars."""
    e = ecdsa.ECDSA(name, device=CPU)
    f = e.curve.fp
    sig = ecdsa.Signature(5, 7)
    inf = ecdsa.PublicKey(Affine(f.zeros((1,), device=CPU),
                                 f.zeros((1,), device=CPU)))
    assert not e.verify(MSG, sig, inf)
    off = ecdsa.PublicKey(Affine(f.from_int([1], device=CPU),
                                 f.from_int([1], device=CPU)))
    assert not bool(e.curve.on_curve_affine(off.q)[0])
    assert not e.verify(MSG, sig, off)
    g = ecdsa.PublicKey(e.curve.generator_affine(device=CPU))
    g = ecdsa.PublicKey(Affine(g.q.x[None], g.q.y[None]))
    for r, s in ((0, 7), (5, 0), (e.order, 7), (5, e.order)):
        assert not e.verify(MSG, ecdsa.Signature(r, s), g)
        with pytest.raises(ValueError):
            e.recover_public_key(MSG, 0, ecdsa.Signature(r, s))
    je = jecdsa.ECDSA(name)
    jinf = jax_pub(name, inf)
    assert not je.verify(MSG, jecdsa.Signature(5, 7), jinf)


def test_hash_to_int_matches_jax():
    """Leftmost-bits truncation on orders of 251-256 bits (stark's 252)."""
    digest = hashlib.sha512(b"x").digest()
    for order in (ecdsa.ECDSA("stark_g1", device=CPU).order,
                  ecdsa.ECDSA("secp256k1_g1", device=CPU).order,
                  (1 << 251) + 3):
        assert (ecdsa.hash_to_int(digest, order)
                == jecdsa.hash_to_int(digest, order))
        assert (ecdsa.hash_to_int(digest[:20], order)
                == jecdsa.hash_to_int(digest[:20], order))
    assert ecdsa.hash_to_int(b"\xff" * 32, (1 << 255) - 19) == (
        (1 << 255) - 1)
