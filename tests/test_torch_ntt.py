"""The PyTorch port's NTT against the JAX package's CPU path (bn254 Fr).

Seeded inputs go to both packages (JAX limbs carried into port words through
``gnark_crypto_tpu_torch.convert``); outputs must be equal as canonical
integers. n = 512 covers all four (decimation, direction) pairs, coset and
``fft_batch`` on the port's radix-2 path; n = 2^14 covers (DIF, forward)
and (DIT, inverse) through the port's four-step dispatch. The JAX reference
is ``fft.fft``/``fft_inverse`` on the CPU, which ``tests/test_pallas_ntt.py``
holds bit-identical to both Pallas NTT kernels. The port runs its plain
versions here; ``tests/test_torch_cuda.py`` holds its kernels against them.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.ntt import fft as jfft
from gnark_crypto_tpu.ntt.domain import Domain as JDomain
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.ntt import fft as tfft
from gnark_crypto_tpu_torch.ntt import four_step, radix2
from gnark_crypto_tpu_torch.ntt.domain import Domain as TDomain
from gnark_crypto_tpu_torch.ntt.domain import domain_from_bytes
from gnark_crypto_tpu_torch.specs import field as tfs

JSPEC, TSPEC = jfs.BN254_FR, tfs.BN254_FR
Q = TSPEC.modulus
CPU = "cpu"
PAIRS = [("DIF", False), ("DIF", True), ("DIT", False), ("DIT", True)]


def rand_vals(n, seed):
    rng = random.Random(seed)
    return [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(n - 3)]


def jints(x):
    return jmont.to_int(JSPEC, x)


def tints(x):
    return tmont.to_int(TSPEC, x)


def carry(jx):
    return convert.from_jax_limbs(TSPEC, np.asarray(jx), device=CPU)


def jax_run(dom, a, dec, inverse, coset):
    f = jfft.fft_inverse if inverse else jfft.fft
    return jints(f(dom, a, dec, coset))


@pytest.fixture(scope="module")
def small():
    """n = 512: both domains, the inputs, and all eight JAX outputs."""
    n = 512
    jdom = JDomain(JSPEC, n)
    rows = [jmont.from_int(JSPEC, rand_vals(n, s)) for s in (11, 12)]
    want = {(dec, inv, coset): jax_run(jdom, rows[0], dec, inv, coset)
            for dec, inv in PAIRS for coset in (False, True)}
    want_row1 = jax_run(jdom, rows[1], "DIF", False, True)
    return dict(jdom=jdom, tdom=TDomain(TSPEC, n, device=CPU),
                a=carry(rows[0]), b=carry(rows[1]), want=want,
                want_row1=want_row1)


@pytest.mark.parametrize("coset", [False, True])
@pytest.mark.parametrize("dec,inverse", PAIRS)
def test_fft_matches_jax_512(small, dec, inverse, coset):
    f = tfft.fft_inverse if inverse else tfft.fft
    assert not four_step.supported(small["tdom"], dec, inverse)
    got = f(small["tdom"], small["a"], dec, coset)
    assert tints(got) == small["want"][dec, inverse, coset]


def test_fft_batch_matches_jax_rows(small):
    batch = torch.stack([small["a"], small["b"]])
    got = tfft.fft_batch(small["tdom"], batch, "DIF", coset=True)
    assert got.shape == batch.shape
    assert tints(got[0]) == small["want"]["DIF", False, True]
    assert tints(got[1]) == small["want_row1"]
    back = tfft.fft_batch(small["tdom"], got, "DIT", coset=True,
                          inverse=True)
    assert torch.equal(back, batch)


def test_round_trips_512(small):
    dom, a = small["tdom"], small["a"]
    for coset in (False, True):
        assert torch.equal(tfft.fft_inverse(
            dom, tfft.fft(dom, a, "DIF", coset), "DIT", coset), a)
        assert torch.equal(tfft.fft_inverse(
            dom, tfft.fft(dom, a, "DIT", coset), "DIF", coset), a)


def test_radix2_steps_match_plain_stages(small):
    """The CPU radix-2 path (stages + fused tail, as on the card) equals the
    plain stage-by-stage transform for every pair."""
    dom, a = small["tdom"], small["a"]
    for dec, inverse in PAIRS:
        assert torch.equal(radix2.run(dom, a, dec, inverse),
                           radix2.run_plain(dom, a, dec, inverse))


def test_domain_tables_and_bytes_match_jax(small):
    jdom, tdom = small["jdom"], small["tdom"]
    for s in (0, 3, 8):
        for inv in (False, True):
            assert tints(tdom.stage_twiddles(s, inv)) == jints(
                jdom.stage_twiddles(s, inv))
    assert tints(tdom.coset_table) == jints(jdom.coset_table)
    assert tints(tdom.coset_table_inv) == jints(jdom.coset_table_inv)
    for flag in (True, False):
        assert tdom.to_bytes(flag) == jdom.to_bytes(flag)
    back = domain_from_bytes(TSPEC, jdom.to_bytes(), device=CPU)
    assert (back.n, back.generator_int, back.shift_int) == (
        512, jdom.generator_int, jdom.shift_int)
    bad = bytearray(jdom.to_bytes())
    bad[8 + TSPEC.n_bytes] ^= 1  # corrupt the generator
    with pytest.raises(ValueError):
        domain_from_bytes(TSPEC, bytes(bad), device=CPU)
    with pytest.raises(ValueError):
        domain_from_bytes(TSPEC, bytes(20), device=CPU)


def test_bit_reverse_and_input_checks(small):
    x = tmont.from_int(TSPEC, list(range(8)), device=CPU)
    assert tints(tfft.bit_reverse(x)) == [0, 4, 2, 6, 1, 5, 3, 7]
    with pytest.raises(ValueError):
        tfft.fft(small["tdom"], small["a"][:256])
    with pytest.raises(ValueError):
        TDomain(TSPEC, 3, device=CPU)
    with pytest.raises(ValueError):
        TDomain(tfs.BN254_FP, 4, device=CPU)  # 2-adicity 1


# -- n = 2^14: the four-step dispatch ---------------------------------------

N4 = 1 << 14


@pytest.fixture(scope="module")
def big():
    jdom = JDomain(JSPEC, N4, with_coset=False)
    ja = jmont.from_int(JSPEC, rand_vals(N4, 13))
    return dict(jdom=jdom, ja=ja, a=carry(ja),
                tdom=TDomain(TSPEC, N4, with_coset=False, device=CPU))


@pytest.fixture(scope="module")
def big_fwd(big):
    return jax_run(big["jdom"], big["ja"], "DIF", False, False)


def test_four_step_forward_matches_jax(big, big_fwd):
    assert four_step.supported(big["tdom"], "DIF", False)
    got = tfft.fft(big["tdom"], big["a"], "DIF")
    assert tints(got) == big_fwd


def test_four_step_inverse_matches_jax(big, big_fwd):
    """DIT inverse of the forward output: the JAX result, and the input
    back (1/n is folded into the twist table and applied once)."""
    assert four_step.supported(big["tdom"], "DIT", True)
    fwd = tmont.from_int(TSPEC, big_fwd, device=CPU)
    got = tfft.fft_inverse(big["tdom"], fwd, "DIT")
    want = jax_run(big["jdom"], jmont.from_int(JSPEC, big_fwd), "DIT", True,
                   False)
    assert tints(got) == want
    assert torch.equal(got, big["a"])


def test_four_step_equals_radix2_plain(big):
    """Four-step and radix-2 paths agree element for element, and the
    four-step inverse equals the scaled radix-2 inverse."""
    dom, a = big["tdom"], big["a"]
    assert torch.equal(four_step.run(dom, a, "DIF", False),
                       radix2.run_plain(dom, a, "DIF", False))
    scaled = tmont.mul(TSPEC, radix2.run_plain(dom, a, "DIT", True),
                       dom.cardinality_inv)
    assert torch.equal(four_step.run(dom, a, "DIT", True), scaled)


def test_four_step_range():
    class D:  # what supported() reads of a domain
        def __init__(self, k):
            self.k = k

    assert not four_step.supported(D(13), "DIF", False)
    assert four_step.supported(D(24), "DIF", False)
    assert not four_step.supported(D(25), "DIF", False)
    assert not four_step.supported(D(20), "DIT", False)
    assert not four_step.supported(D(20), "DIF", True)


# -- the port imports no JAX ------------------------------------------------

def test_port_imports_without_jax():
    """With ``jax`` blocked, every port module and chip_smoke import."""
    root = Path(__file__).resolve().parents[1]
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in (root / "gnark_crypto_tpu_torch").rglob("*.py"))
    assert {f"gnark_crypto_tpu_torch.{m}" for m in (
        "specs.curve", "field.exp", "field.point_add", "curve.jacobian",
        "msm.pippenger", "convert")} <= set(mods)
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['gnark_crypto_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
