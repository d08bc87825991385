"""The port's Ring-SIS hash against the JAX package (CPU).

``hashes/sis.py`` against ``gnark_crypto_tpu/hashes/sis.py`` on the same
seeded inputs: ``hash`` for koalabear, babybear and goldilocks at 2^10 to
2^12 elements with the derived (blake2b) key and with the reference's
test-vector key (``set_key_sage``), other limb bounds, and ``hash_many``
in Vortex's transversal shape (``RSis(koalabear, 42, 4, 8, 64)``). The Go
golden files that ``tests/test_sis.py`` reads are not in this checkout, so
the JAX package is the oracle, and a Python big-int negacyclic product
where the JAX hash raises (32-bit limbs of a multi-word field). Hashes are
compared as canonical integers; the tolerance is exact.
"""

import hashlib
import random

import jax
import jax.numpy as jnp
import pytest
import torch

from gnark_crypto_tpu.hashes.sis import RSis as JRSis
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch.hashes.sis import RSis, rsis
from gnark_crypto_tpu_torch.specs import field as tfs

CPU = "cpu"


def inputs(q, n, seed, bits=None):
    rng = random.Random(seed)
    top = q if bits is None else 1 << bits
    return [0, 1, q - 1][:n] + [rng.randrange(top) for _ in range(n - 3)]


def both_hash(field, log_deg, bound, n, seed, sage=None, bits=None):
    js = JRSis(jfs.get_field(field), 42, log_deg, bound, n)
    ts = RSis(tfs.get_field(field), 42, log_deg, bound, n, device=CPU)
    if sage is not None:
        js.set_key_sage(sage)
        ts.set_key_sage(sage)
    q = ts.spec.modulus
    vals = inputs(q, n, seed, bits)
    jh = js.eng.to_int(js.hash(js.eng.from_int(vals, mont=False)),
                       mont=False)
    th = ts.eng.to_int(ts.hash(ts.eng.from_int(vals, mont=False,
                                               device=CPU)), mont=False)
    return jh, th, ts


@pytest.mark.parametrize("field,n", [("koalabear", 1 << 12),
                                     ("babybear", 1 << 11),
                                     ("goldilocks", 1 << 10)])
def test_hash_matches_jax(field, n):
    """sis512_16 shape (degree 512, 16-bit limbs) with the blake2b key."""
    jh, th, ts = both_hash(field, 9, 16, n, 1)
    assert th == jh
    assert ts._radix_corr == 1 and len(th) == 512


@pytest.mark.parametrize("field", ["koalabear", "babybear", "goldilocks"])
def test_hash_sage_key_matches_jax(field):
    """The reference test-vector key A[i][j] = (seed+i)^(2^(j+1)), a short
    input (zero-padded limb matrix), degree 64, 8-bit limbs."""
    jh, th, _ = both_hash(field, 6, 8, 1 << 10, 2, sage=5)
    assert th == jh


@pytest.mark.parametrize("field,bound", [("koalabear", 32),
                                         ("goldilocks", 8)])
def test_hash_other_bounds_match_jax(field, bound):
    """Whole 32-bit words as limbs (koalabear); bytes as limbs of
    goldilocks inputs below 2^63, as the reference bench feeds them."""
    bits = 63 if field == "goldilocks" else None
    jh, th, _ = both_hash(field, 5, bound, 1 << 10, 3, bits=bits)
    assert th == jh


def sis_bigint(spec, seed, log_deg, bits, vals):
    """Ring-SIS by Python big ints: the blake2b key, little-endian limbs of
    ``bits`` bits written into the Montgomery slot (value l * R^-1, R the
    reference's radix, which is the port's), and the negacyclic product
    sum_i A_i * M_i mod (X^d + 1), coefficient by coefficient."""
    q, d = spec.modulus, 1 << log_deg
    rinv = pow(1 << (32 * spec.n_words), -1, q)
    limbs = [(v >> (bits * k)) & ((1 << bits) - 1)
             for v in vals for k in range(spec.n_bytes * 8 // bits)]
    limbs += [0] * (-len(limbs) % d)
    res = [0] * d
    for i in range(len(limbs) // d):
        key = [int.from_bytes(hashlib.blake2b(
            b"SIS" + seed.to_bytes(8, "big") + i.to_bytes(8, "big")
            + j.to_bytes(8, "big"), digest_size=32).digest(), "big") % q
            for j in range(d)]
        m = [v * rinv % q for v in limbs[i * d:(i + 1) * d]]
        for j in range(d):
            for k in range(d):
                if j + k < d:
                    res[j + k] += key[j] * m[k]
                else:
                    res[j + k - d] -= key[j] * m[k]
    return [v % q for v in res]


@pytest.mark.parametrize("field", ["goldilocks", "bls12_377_fr"])
def test_hash_32bit_limbs_match_bigint_product(field):
    """Whole 32-bit words as limbs of a multi-word field, where the JAX
    hash raises OverflowError (its limb mask): RSis(field, 3, 4, 32, 8)
    against the negacyclic product in Python big ints."""
    spec = tfs.get_field(field)
    q = spec.modulus
    vals = inputs(q, 8, 3)
    ts = RSis(spec, 3, 4, 32, 8, device=CPU)
    got = ts.eng.to_int(ts.hash(ts.eng.from_int(vals, mont=False,
                                                device=CPU)), mont=False)
    assert got == sis_bigint(spec, 3, 4, 32, vals)


def test_bigint_sis_oracle_matches_jax():
    """The big-int oracle itself against the JAX hash where that one runs
    (16-bit limbs of goldilocks)."""
    spec = tfs.GOLDILOCKS
    vals = inputs(spec.modulus, 8, 3)
    js = JRSis(jfs.GOLDILOCKS, 3, 4, 16, 8)
    want = js.eng.to_int(js.hash(js.eng.from_int(vals, mont=False)),
                         mont=False)
    assert sis_bigint(spec, 3, 4, 16, vals) == want


def test_hash_many_transversal_shape():
    """Vortex's column hash: RSis(koalabear, 42, 4, 8, 64) over a few
    columns of 64 elements, batched, equal to the JAX hashes."""
    spec = tfs.KOALABEAR
    js = JRSis(jfs.KOALABEAR, 42, 4, 8, 64)
    ts = rsis("koalabear", 42, 4, 8, 64, device=CPU)
    assert ts is rsis("koalabear", 42, 4, 8, 64, device=CPU)
    rng = random.Random(4)
    cols = [[rng.randrange(spec.modulus) for _ in range(64)]
            for _ in range(6)]
    jv = jnp.stack([js.eng.from_int(c, mont=False) for c in cols])
    tv = torch.stack([ts.eng.from_int(c, mont=False, device=CPU)
                      for c in cols])
    want = jax.vmap(js.hash)(jv)
    got = ts.hash_many(tv)
    assert got.shape == (6, 16)
    assert [ts.eng.to_int(got[i], mont=False) for i in range(6)] == [
        js.eng.to_int(want[i], mont=False) for i in range(6)]
    assert ts.eng.to_int(ts.hash(tv[2]), mont=False) == ts.eng.to_int(
        got[2], mont=False)


def test_hash_many_goldilocks_matches_hash():
    ts = RSis(tfs.GOLDILOCKS, 7, 4, 16, 40, device=CPU)
    rng = random.Random(6)
    q = tfs.GOLDILOCKS.modulus
    tv = torch.stack([ts.eng.from_int([rng.randrange(q) for _ in range(40)],
                                      mont=False, device=CPU)
                      for _ in range(3)])
    got = ts.hash_many(tv)
    for i in range(3):
        assert torch.equal(got[i], ts.hash(tv[i]))


def test_rsis_rejects():
    with pytest.raises(ValueError):
        RSis(tfs.KOALABEAR, 1, 4, 12, 8, device=CPU)   # bound not bytes
    with pytest.raises(ValueError):
        RSis(tfs.KOALABEAR, 1, 4, 24, 8, device=CPU)   # 3-byte limbs
    ts = RSis(tfs.KOALABEAR, 1, 4, 16, 8, device=CPU)
    with pytest.raises(ValueError):
        ts.hash(ts.eng.from_int(list(range(9)), mont=False, device=CPU))
