"""The port's NTT at 10 and 12 words (bw6-633 Fr and bw6-761 Fr) against
the JAX package on the CPU.

Seeded inputs go to both packages; outputs must be equal as canonical
integers (tolerance 0). At n = 64 every (decimation, direction, coset)
form of ``fft``, ``fft_inverse`` and ``fft_batch`` is held against the JAX
``ntt/fft.py``, twice: with the default dispatch (one fused block), and
with ``radix2.TILE_LOG`` and ``four_step.MIN_LOG`` lowered so that the
plain stage, block and sub-NTT versions each take part. At n = 256 the
JAX Pallas radix-2 kernel (``run_stages_pallas``) runs in interpret mode,
as ``tests/test_pallas_ntt.py`` runs it, against the port's transform.

The CUDA wrappers are held without a card: the launch arguments they pass
at 10 and 12 words (field words, width, strides, rows, shared-memory
bytes and threads) against Python integers, through a stand-in for the
built library, and the width check, which takes 8, 10 and 12 words and
refuses 20 and 24 words and secp256k1/r1. ``tests/test_torch_cuda.py`` holds
the kernels against these plain versions on the card.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.ntt import fft as jfft
from gnark_crypto_tpu.ntt.domain import Domain as JDomain
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.field import kernels
from gnark_crypto_tpu_torch.field import mont as tmont
from gnark_crypto_tpu_torch.ntt import fft as tfft
from gnark_crypto_tpu_torch.ntt import four_step, radix2
from gnark_crypto_tpu_torch.ntt.domain import Domain as TDomain
from gnark_crypto_tpu_torch.specs import field as tfs
from gnark_crypto_tpu_torch.utils import build

CPU = "cpu"
NAMES = ["bw6_761_fr", "bw6_633_fr"]
WORDS = {"bw6_761_fr": 12, "bw6_633_fr": 10}
PAIRS = [("DIF", False), ("DIF", True), ("DIT", False), ("DIT", True)]
N = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain versions are many small tensor ops,
    and several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def specs(name):
    return jfs.get_field(name), tfs.get_field(name)


def rand_vals(q, n, seed):
    rng = random.Random(seed)
    return ([0, 1, q - 1] + [rng.randrange(q) for _ in range(n)])[:n]


def words_int(words) -> int:
    return sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(words))


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """(name, JAX spec, port spec, JAX domain, values) at n = 64; the JAX
    transforms of every form, computed once."""
    name = request.param
    jspec, tspec = specs(name)
    vals = rand_vals(tspec.modulus, N, WORDS[name])
    jdom = JDomain(jspec, N)
    ja = jmont.from_int(jspec, vals)
    want = {}
    for dec, inv in PAIRS:
        f = jfft.fft_inverse if inv else jfft.fft
        for coset in (False, True):
            want[dec, inv, coset] = jmont.to_int(jspec, f(jdom, ja, dec,
                                                          coset))
    return name, jspec, tspec, ja, vals, want


# (TILE_LOG, MIN_LOG): the default dispatch (one fused block, no
# four-step at 64), then 3 wide stages and a block of 3 on the radix-2
# path with the four-step path on (DIF, forward) and (DIT, inverse)
DISPATCH = [(radix2.TILE_LOG, four_step.MIN_LOG), (3, 4)]


@pytest.mark.parametrize("tile_log,min_log", DISPATCH)
def test_wide_fft_forms_match_jax(case, tile_log, min_log, monkeypatch):
    name, jspec, tspec, ja, vals, want = case
    monkeypatch.setattr(radix2, "TILE_LOG", tile_log)
    monkeypatch.setattr(four_step, "MIN_LOG", min_log)
    calls = {"stage": 0, "block": 0, "sub_ntt": 0}

    def spy(mod, fn_name, key):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, fn_name, wrapped)

    spy(radix2, "stage_plain", "stage")
    spy(radix2, "block_plain", "block")
    spy(four_step, "sub_ntt_plain", "sub_ntt")
    tdom = TDomain(tspec, N, device=CPU)
    ta = convert.from_jax_limbs(tspec, np.asarray(ja), device=CPU)
    assert tmont.to_int(tspec, ta) == vals
    for (dec, inv, coset), w in want.items():
        f = tfft.fft_inverse if inv else tfft.fft
        got = tmont.to_int(tspec, f(tdom, ta, dec, coset))
        assert got == w, (name, dec, inv, coset)
    if tile_log < 6:
        assert calls["stage"] > 0 and calls["block"] > 0
        # two steps for each of the two pairs, coset and not
        assert calls["sub_ntt"] == 8
    else:  # one fused block a transform
        assert calls == {"stage": 0, "block": 8, "sub_ntt": 0}


@pytest.mark.parametrize("tile_log,min_log", DISPATCH)
def test_wide_fft_batch_matches_jax(case, tile_log, min_log, monkeypatch):
    """fft_batch of three rows in every form equals the JAX transform of
    each row."""
    name, jspec, tspec, ja, vals, want = case
    monkeypatch.setattr(radix2, "TILE_LOG", tile_log)
    monkeypatch.setattr(four_step, "MIN_LOG", min_log)
    tdom = TDomain(tspec, N, device=CPU)
    rows = [vals, vals[::-1], rand_vals(tspec.modulus, N, 99)]
    jdom = JDomain(jspec, N)
    batch = torch.stack([tmont.from_int(tspec, r, device=CPU)
                         for r in rows])
    for dec, inv in PAIRS:
        for coset in (False, True):
            got = tfft.fft_batch(tdom, batch, dec, coset, inverse=inv)
            f = jfft.fft_inverse if inv else jfft.fft
            for i, r in enumerate(rows):
                w = (want[dec, inv, coset] if i == 0 else jmont.to_int(
                    jspec, f(jdom, jmont.from_int(jspec, r), dec, coset)))
                assert tmont.to_int(tspec, got[i]) == w, (dec, inv, coset, i)


@pytest.mark.parametrize("name,dec,inv", [("bw6_761_fr", "DIF", False),
                                          ("bw6_633_fr", "DIT", True)])
def test_wide_ntt_matches_pallas_interpret(name, dec, inv):
    """The JAX Pallas radix-2 kernel in interpret mode (n = 256, its
    smallest tile-divisible size; ~17 s a transform on a CPU) equals the
    port's transform before any scale: forward DIF at 12 words, inverse
    DIT at 10."""
    from gnark_crypto_tpu.ntt.pallas_ntt import run_stages_pallas

    jspec, tspec = specs(name)
    n = 256
    vals = rand_vals(tspec.modulus, n, 5)
    jdom, tdom = JDomain(jspec, n), TDomain(tspec, n, device=CPU)
    ja = jmont.from_int(jspec, vals)
    ta = tmont.from_int(tspec, vals, device=CPU)
    got = run_stages_pallas(jdom, ja, dec, inv, interpret=True)
    assert (tmont.to_int(tspec, radix2.run(tdom, ta, dec, inv))
            == jmont.to_int(jspec, got))


# -- the wrappers' launch arguments, without a card --------------------------

class FakeLib:
    """Stands in for a built entry point: records each call's arguments
    and returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: ``is_cuda`` reads True,
    ``build.function`` returns a recorder per entry point and the stream
    is 0. The kernels themselves do not run: the outputs stay empty."""
    libs = {}

    def function(lib, name, argtypes):
        return libs.setdefault(name, FakeLib())

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_ptr", lambda x: 0)
    return libs


def check_field_words(spec, fw):
    W = spec.n_words
    fw = list(fw)
    assert len(fw) == W + 1 and words_int(fw[:W]) == spec.modulus
    assert spec.modulus * fw[W] % (1 << 32) == (1 << 32) - 1


@pytest.mark.parametrize("name", NAMES)
def test_ntt_launch_args_at_10_12_words(name, fake_card):
    _, spec = specs(name)
    W = spec.n_words
    k = 12
    n = 1 << k
    x = torch.zeros((n, W), dtype=torch.int32)
    tw = torch.zeros((n // 2, W), dtype=torch.int32)
    wrappers = (radix2.stage, radix2.block, four_step.sub_ntt)
    before = [w.launches_by_width.get(W, 0) for w in wrappers]
    radix2.stage(spec, x, tw, k, 1, True)
    (xp, yp, twp, kk, s, dit, words, fw, stream), = \
        fake_card["gct_ntt_radix2_stage"].calls
    assert (xp, twp, kk, s, dit, words, stream) == (
        x.data_ptr(), tw.data_ptr(), k, 1, 1, W, 0)
    check_field_words(spec, fw)
    # the fused tail of a 2^12 transform at TILE_LOG = 10: rows of 2^10,
    # local stage s reads tw[(off << s) << 2]
    radix2.block(spec, x, tw, k - 10, 10, False)
    (xp, yp, twp, shift, log_s, rows, dit, words, fw, stream), = \
        fake_card["gct_ntt_radix2_block"].calls
    assert (shift, log_s, rows, dit, words) == (2, 10, 4, 0, W)
    check_field_words(spec, fw)
    # a four-step column step: 2^12-element columns of a (2^12, 4) view,
    # the twist fused
    xs = torch.zeros((n * 4, W), dtype=torch.int32)
    twist = torch.zeros((n * 4, W), dtype=torch.int32)
    four_step.sub_ntt(spec, xs, tw, 12, 4, True, False, twist)
    (xp, yp, twp, log_s, other, cols, twp2, dit, words, fw, stream), = \
        fake_card["gct_ntt_four_step"].calls
    assert (log_s, other, cols, twp2, dit, words) == (
        12, 4, 1, twist.data_ptr(), 0, W)
    check_field_words(spec, fw)
    assert [w.launches_by_width.get(W, 0) - b
            for w, b in zip(wrappers, before)] == [1, 1, 1]


@pytest.mark.parametrize("words", [8, 10, 12])
def test_ntt_block_geometry_fits_shared_memory(words):
    """Shared memory 4W << log_s bytes (``csrc/ntt_block.cuh``), threads
    min(S/2, 512): a 2^12 sub-NTT takes 128, 160 and 192 KB at 8, 10 and
    12 words, within the H100's 227 KB for one block."""
    for log_s in range(0, four_step.MAX_SUB_LOG + 1):
        threads, smem = radix2.block_geometry(words, log_s)
        assert smem == 4 * words * (1 << log_s)
        assert threads == max(1, min((1 << log_s) // 2, 512))
        assert smem <= radix2.SMEM_PER_BLOCK == 227 * 1024
    assert radix2.block_geometry(words, 12)[1] == {
        8: 131072, 10: 163840, 12: 196608}[words]
    with pytest.raises(ValueError):
        radix2.block_geometry(words, four_step.MAX_SUB_LOG + 1)


@pytest.mark.parametrize("name,words", [
    ("bn254_fr", 8), ("bw6_633_fr", 10), ("bw6_761_fr", 12),
    ("bls12_381_fp", 12), ("bls24_315_fp", 10)])
def test_ntt_width_check_admits(name, words):
    spec = tfs.get_field(name)
    assert spec.n_words == words and radix2.WIDTHS == (8, 10, 12)
    kernels.check_width(spec, "ntt_radix2 stage", radix2.WIDTHS)


@pytest.mark.parametrize("name", [
    "bw6_633_fp", "bw6_761_fp", "secp256k1_fr", "secp256k1_fp",
    "secp256r1_fr"])
def test_ntt_width_check_refuses(name, fake_card):
    """20 and 24 words (no NTT field has them) and the 256-bit 8-word
    fields (secp256k1/r1 Fr has 2-adicity 6 and 4: no NTT field either):
    refused before any launch."""
    spec = tfs.get_field(name)
    W = spec.n_words
    x = torch.zeros((16, W), dtype=torch.int32)
    for call in (lambda: radix2.stage(spec, x, x[:8], 4, 0, False),
                 lambda: radix2.block(spec, x, x[:8], 0, 4, True),
                 lambda: four_step.sub_ntt(spec, x, x[:8], 2, 4, True,
                                           False)):
        with pytest.raises(NotImplementedError) as info:
            call()
        assert (kernels.fills_width(spec)) == (W == 8)
        assert "q < 2^(32W-1)" in str(info.value)
    assert fake_card == {}
