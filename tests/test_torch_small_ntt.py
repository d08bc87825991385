"""The port's small-field NTT against the JAX package (CPU).

The plain versions behind ``ntt/radix2_f31.py`` and ``ntt/radix2_f64.py``
against the Pallas kernels they replace, run in interpret mode as the JAX
package's own tests run them: ``run_stages_pallas_f31``/``_f64`` at n = 2048
(the smallest n they take), with the port's dispatch forced onto its wide
stages (a radix-4 pair, a radix-2 stage and the fused block), and
``run_batch_small_f31``/``_f64`` at the Ring-SIS shapes (16 rows of 512, 64
rows of 16). Then ``fft``, ``fft_inverse``, coset, ``fft_batch``,
``fft_ext``, and the domain tables and bytes against the JAX ``fft`` and
``Domain``. Elements cross as bit views (the same R on both sides);
results are compared as canonical integers; the tolerance is exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import api as japi
from gnark_crypto_tpu.ntt import fft as jfft
from gnark_crypto_tpu.ntt import pallas_ntt_f31, pallas_ntt_f64
from gnark_crypto_tpu.ntt.domain import Domain as JDomain
from gnark_crypto_tpu.ntt.fftext import fft_ext as jfft_ext
from gnark_crypto_tpu.ntt.fftext import fft_inverse_ext as jfft_inverse_ext
from gnark_crypto_tpu.towers import smallfield as jsf
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.field import api as tapi
from gnark_crypto_tpu_torch.ntt import fft as tfft
from gnark_crypto_tpu_torch.ntt import radix2_f31, radix2_f64
from gnark_crypto_tpu_torch.ntt.domain import Domain as TDomain
from gnark_crypto_tpu_torch.ntt.domain import domain_from_bytes
from gnark_crypto_tpu_torch.ntt.fftext import fft_ext, fft_inverse_ext
from gnark_crypto_tpu_torch.towers import smallfield as tsf

CPU = "cpu"
PAIRS = [("DIF", False), ("DIF", True), ("DIT", False), ("DIT", True)]
RUNNERS = {"koalabear": (radix2_f31, pallas_ntt_f31.run_stages_pallas_f31,
                         pallas_ntt_f31.run_batch_small_f31),
           "goldilocks": (radix2_f64, pallas_ntt_f64.run_stages_pallas_f64,
                          pallas_ntt_f64.run_batch_small_f64)}


def jax_elems(field, n, seed, lead=()):
    je = japi.for_field(field)
    rng = random.Random(seed)
    q = je.spec.modulus
    vals = [0, 1, q - 1] + [rng.randrange(q) for _ in range(n - 3)]
    x = je.from_int(vals[:n])
    return je.reshape(x, (*lead, n // int(np.prod(lead or (1,)))))


def carry(field, jx):
    return convert.from_jax_small(tapi.for_field(field).spec, np.asarray(jx),
                                  device=CPU)


def ints(field, x):
    return tapi.for_field(field).to_int(x)


@pytest.fixture(scope="module", params=["koalabear", "goldilocks"])
def n2048(request):
    field = request.param
    spec = japi.for_field(field).spec
    ja = jax_elems(field, 2048, 21)
    return dict(field=field, jdom=JDomain(spec, 2048, with_coset=False),
                tdom=TDomain(tapi.for_field(field).spec, 2048,
                             with_coset=False, device=CPU),
                ja=ja, a=carry(field, ja))


@pytest.mark.parametrize("dec,inverse", PAIRS)
def test_run_matches_pallas_interpret(n2048, dec, inverse, monkeypatch):
    """The port's transform (default tile: one fused block; a 2^8 tile: a
    radix-4 pair (f31), radix-2 stages and the block) == the Pallas
    kernels in interpret mode."""
    mod, jrun, _ = RUNNERS[n2048["field"]]
    want = ints(n2048["field"], carry(n2048["field"], jrun(
        n2048["jdom"], n2048["ja"], dec, inverse, interpret=True)))
    dom, a = n2048["tdom"], n2048["a"]
    assert ints(n2048["field"], mod.run(dom, a, dec, inverse)) == want
    assert ints(n2048["field"], mod.run_plain(dom, a, dec, inverse)) == want
    monkeypatch.setattr(mod, "TILE_LOG", 8)
    assert ints(n2048["field"], mod.run(dom, a, dec, inverse)) == want


def test_f31_stage_forms_match():
    """The radix-4 form of two stages equals the two radix-2 stages in the
    transform's order, and every single stage the JAX stage kernel's."""
    field = "koalabear"
    ja = jax_elems(field, 2048, 22)
    spec = tapi.for_field(field).spec
    dom = TDomain(spec, 2048, with_coset=False, device=CPU)
    jdom = JDomain(japi.for_field(field).spec, 2048, with_coset=False)
    a = carry(field, ja)
    for dit in (False, True):
        tw0 = dom.twiddles0
        for s in range(3):
            two = radix2_f31.stage_plain(
                spec, radix2_f31.stage_plain(spec, a, tw0, 11,
                                             s + (1 if dit else 0), dit),
                tw0, 11, s + (0 if dit else 1), dit)
            assert torch.equal(radix2_f31.stage_r4(spec, a, tw0, 11, s, dit),
                               two)
    # stage 0 (half 1024) is the JAX big stage at this size
    jtw, _ = pallas_ntt_f31._tables(jdom, False, 256)
    got = pallas_ntt_f31._big_stage(jdom.eng.spec, ja.reshape(256, 8).T,
                                    jtw[0], 1024, True, True)
    want = carry(field, got.T.reshape(2048))
    assert torch.equal(radix2_f31.stage(spec, a, dom.twiddles0, 11, 0,
                                        False), want)


@pytest.mark.parametrize("rows,n", [(16, 512), (64, 16)])
@pytest.mark.parametrize("field", ["koalabear", "goldilocks"])
def test_batch_small_matches_pallas_interpret(field, rows, n):
    mod, _, jbatch = RUNNERS[field]
    spec = japi.for_field(field).spec
    jdom = JDomain(spec, n, with_coset=False)
    tdom = TDomain(tapi.for_field(field).spec, n, with_coset=False,
                   device=CPU)
    ja = jax_elems(field, rows * n, n + rows, lead=(rows,))
    a = carry(field, ja)
    for dec, inverse in (("DIF", False), ("DIT", True)):
        want = jbatch(jdom, ja, dec, inverse, interpret=True)
        got = mod.run_batch_small(tdom, a, dec, inverse)
        assert ints(field, got) == ints(field, carry(field, want))


@pytest.mark.parametrize("field", ["koalabear", "babybear", "goldilocks"])
def test_fft_matches_jax(field):
    """All four pairs, coset and not, fft_batch, the domain tables and
    bytes, at n = 256."""
    n = 256
    jspec = japi.for_field(field).spec
    tspec = tapi.for_field(field).spec
    jdom, tdom = JDomain(jspec, n), TDomain(tspec, n, device=CPU)
    ja = jax_elems(field, n, 31)
    a = carry(field, ja)
    for dec, inverse in PAIRS:
        jf = jfft.fft_inverse if inverse else jfft.fft
        tf = tfft.fft_inverse if inverse else tfft.fft
        for coset in (False, True):
            assert ints(field, tf(tdom, a, dec, coset)) == ints(
                field, carry(field, jf(jdom, ja, dec, coset))), (
                dec, inverse, coset)
    jb = jax_elems(field, 3 * n, 32, lead=(3,))
    b = carry(field, jb)
    for inverse in (False, True):
        for coset in (False, True):
            jf = jfft.fft_inverse if inverse else jfft.fft
            want = [ints(field, carry(field, jf(jdom, jb[i], "DIF", coset)))
                    for i in range(3)]
            got = tfft.fft_batch(tdom, b, "DIF", coset, inverse)
            assert [ints(field, got[i]) for i in range(3)] == want
    for attr in ("twiddles0", "twiddles0_inv", "coset_table",
                 "coset_table_inv"):
        assert ints(field, getattr(tdom, attr)) == ints(
            field, carry(field, getattr(jdom, attr))), attr
    assert ints(field, tdom.stage_twiddles(3, True)) == ints(
        field, carry(field, jdom.stage_twiddles(3, True)))
    for flag in (True, False):
        assert tdom.to_bytes(flag) == jdom.to_bytes(flag)
    back = domain_from_bytes(tapi.for_field(field), jdom.to_bytes(),
                             device=CPU)
    assert (back.n, back.generator_int, back.shift_int) == (
        n, jdom.generator_int, jdom.shift_int)
    bad = bytearray(jdom.to_bytes())
    bad[8 + tspec.n_bytes] ^= 1  # corrupt the generator
    with pytest.raises(ValueError):
        domain_from_bytes(tspec, bytes(bad), device=CPU)
    with pytest.raises(ValueError):
        tfft.fft(tdom, a[:128])


@pytest.mark.parametrize("field,tower", [("koalabear", "e4"),
                                         ("goldilocks", "e2")])
def test_fft_ext_matches_jax(field, tower):
    n = 32
    jeng, teng = getattr(jsf, tower)(field), getattr(tsf, tower)(field, CPU)
    q = tapi.for_field(field).spec.modulus
    rng = random.Random(5)

    def rand_elem(eng):
        if hasattr(eng, "degree"):
            return tuple(rand_elem(eng.base) for _ in range(eng.degree))
        return rng.randrange(q)

    vals = [rand_elem(teng) for _ in range(n)]
    ja = jnp.stack([jeng.from_int(v) for v in vals])
    a = teng.from_int(vals)
    base = tapi.for_field(field)
    jdom = JDomain(japi.for_field(field).spec, n)
    tdom = TDomain(base, n, device=CPU)
    for coset in (False, True):
        want = jfft_ext(jdom, ja, "DIF", coset)
        got = fft_ext(tdom, a, "DIF", coset)
        assert torch.equal(got, carry(field, want))
        back = fft_inverse_ext(tdom, got, "DIT", coset)
        assert torch.equal(back, carry(field, jfft_inverse_ext(
            jdom, want, "DIT", coset)))
        assert torch.equal(back, a)
