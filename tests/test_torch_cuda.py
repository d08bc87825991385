"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports nothing of JAX, so it also runs on
a machine without it:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

The tolerance is exact equality: both versions return canonical residues.
"""

import random

import pytest
import torch

from gnark_crypto_tpu_torch.field import kernels
from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.ntt import fft, four_step, radix2
from gnark_crypto_tpu_torch.ntt.domain import Domain
from gnark_crypto_tpu_torch.specs import field as fs

SPEC = fs.BN254_FR
Q = SPEC.modulus
PAIRS = [("DIF", False), ("DIF", True), ("DIT", False), ("DIT", True)]


def rand_vals(n, seed):
    rng = random.Random(seed)
    return ([0, 1, Q - 1] + [rng.randrange(Q) for _ in range(n)])[:n]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mont_mul_kernel_matches_plain(cuda):
    a, b = rand_vals(4099, 7), rand_vals(4099, 8)[::-1]
    x, y = (mont.from_int(SPEC, v, device=cuda) for v in (a, b))
    before = kernels.mont_mul.launches
    got = kernels.mont_mul(SPEC, x, y)
    assert kernels.mont_mul.launches == before + 1
    assert torch.equal(got, kernels.mont_mul_plain(SPEC, x, y))
    assert mont.to_int(SPEC, got[:64]) == [u * v % Q
                                           for u, v in zip(a[:64], b[:64])]


@pytest.mark.cuda
def test_mont_mul_rejects_bad_input(cuda):
    x = mont.from_int(SPEC, [1, 2, 3, 4], device=cuda)
    with pytest.raises(ValueError):
        kernels.mont_mul(SPEC, x, x.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.mont_mul(SPEC, x[::2], x[::2])
    for spec in (fs.BLS12_381_FP, fs.SECP256K1_FP):  # 12 words; q > 2^255
        y = mont.from_int(spec, [1], device=cuda)
        with pytest.raises(NotImplementedError):
            kernels.mont_mul(spec, y, y)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 12, 14, 15])
def test_ntt_kernels_match_plain(cuda, k):
    n = 1 << k
    dom = Domain(SPEC, n, device=cuda)
    cpu_dom = Domain(SPEC, n, device="cpu") if k <= 12 else None
    a = mont.from_int(SPEC, rand_vals(n, k), device=cuda)
    for dec, inverse in PAIRS:
        f = fft.fft_inverse if inverse else fft.fft
        for coset in (False, True):
            got = f(dom, a, dec, coset)
            if cpu_dom is not None:  # the CPU path takes the same steps
                assert torch.equal(got.cpu(), f(cpu_dom, a.cpu(), dec, coset))
        want = radix2.run_plain(dom, a, dec, inverse)
        if inverse and four_step.supported(dom, dec, inverse):
            # the four-step inverse folds 1/n into its twist table
            want = mont.mul(SPEC, want, dom.cardinality_inv)
        assert torch.equal(fft._run(dom, a, dec, inverse)[0], want)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject(cuda):
    dom = Domain(SPEC, 1 << 14, with_coset=False, device=cuda)
    a = mont.from_int(SPEC, rand_vals(1 << 14, 3), device=cuda)
    wrappers = (radix2.stage, radix2.block, four_step.sub_ntt)
    before = [w.launches for w in wrappers]
    fft.fft(dom, a, "DIT")      # radix-2: 4 wide stages + 1 fused tail
    fft.fft(dom, a, "DIF")      # four-step: 2 sub-NTT steps
    assert [w.launches - b for w, b in zip(wrappers, before)] == [4, 1, 2]
    with pytest.raises(ValueError):
        radix2.stage(SPEC, a[::2], dom.twiddles0, 13, 0, False)
    with pytest.raises(ValueError):
        radix2.block(SPEC, a, dom.twiddles0, 0, 11, False)
    _, _, tw1, _, _ = four_step.tables(dom, False)
    with pytest.raises(ValueError):
        four_step.sub_ntt(SPEC, a, tw1, 13, 2, True, False)
