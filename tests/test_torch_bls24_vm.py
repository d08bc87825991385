"""The bls24-315 and bls24-317 VM pairing programs in the port, on the CPU.

* Program equality: the port's ``build_program`` for ``product``,
  ``miller``, ``reduce`` and ``full`` at the reference's tile of 128 is the
  JAX package's program row for row (registers, entry rows, outputs): the
  degree-24 tower, its symbolic twin, the BLS24 Miller loop and final
  exponentiation and the allocator at once.
* The schedule: each of the eight programs ``pair_vm`` runs, scheduled into
  waves of 16 rows, fits ``vm.reg_cap`` at 10 words (181 registers) with
  legal waves; the ``product`` and ``miller`` programs compute the same
  function as their built form (value numbering).
* Semantics: the scheduled bls24-317 ``product`` program on the plain
  executor equals the port's E24 products of the same inputs.

A bls24 pairing program on the plain executor takes minutes here; the
pairing itself is held against the golden bytes in the ``slow`` tests of
``tests/test_torch_bls24.py`` and on the card. The tolerance is 0.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.pairing import vm_pairing as jvp
from gnark_crypto_tpu_torch.field import mont, vm
from gnark_crypto_tpu_torch.pairing import vm_pairing
from gnark_crypto_tpu_torch.towers.tower24 import get_tower24
from tests.test_torch_vm_waves import check_waves, value_numbers

CURVES = ["bls24_315", "bls24_317"]
VARIANTS = ["full", "miller", "product", "reduce"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("curve", CURVES)
def test_bls24_build_program_equals_reference(curve, variant):
    got = vm_pairing.build_program(curve, variant, tile=128)
    want = jvp.build_program(curve, variant)
    assert got.tile == want.tile == 128
    assert got.spec.n_words == 10
    assert got.n_instrs == want.n_instrs
    assert np.array_equal(got.code, want.code)
    assert (got.n_regs, got.n_entry) == (want.n_regs, want.n_entry)
    assert got.entry_consts == want.entry_consts
    assert got.entry_inputs == want.entry_inputs
    assert got.out_regs == want.out_regs


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("curve", CURVES)
def test_bls24_schedule_fits_10_words(curve, variant):
    """The program ``pair_vm`` runs: waves of 16 legal rows, K within the
    10-word cap, from the widest look-ahead window that fits."""
    prog = vm_pairing.program(curve, variant)
    assert prog.spec.n_words == 10 and vm.reg_cap(prog.spec) == 181
    assert prog.warps == vm_pairing.WARPS and prog.tile == vm.TILE
    assert prog.window in vm.WINDOWS
    check_waves(prog)


@pytest.mark.parametrize("variant", ["miller", "product"])
@pytest.mark.parametrize("curve", CURVES)
def test_bls24_scheduled_program_same_function(curve, variant):
    built = vm_pairing.build_program(curve, variant)
    sched = vm_pairing.program(curve, variant)
    assert (sched.entry_consts, sched.entry_inputs, sched.n_entry) == (
        built.entry_consts, built.entry_inputs, built.n_entry)
    assert sched.op_counts()["MUL"] == built.op_counts()["MUL"]
    table = {}
    want = value_numbers(built, table)
    assert value_numbers(sched, table) == want


def test_bls24_317_product_program_plain_matches_e24_products():
    """The ``product`` program over one 32-lane tile of E24 values: every
    lane ends with the product of the tile, the port's E24 product tree of
    the same values."""
    name = "bls24_317"
    tw = get_tower24(name, "cpu")
    p = tw.p
    rng = random.Random(24)
    vals = [tuple(tuple(((rng.randrange(p), rng.randrange(p)),
                         (rng.randrange(p), rng.randrange(p)))
                        for _ in range(3)) for _ in range(2))
            for _ in range(vm.TILE)]
    zero4 = ((0, 0), (0, 0))
    vals[3] = ((((1, 0), (0, 0)), zero4, zero4), (zero4,) * 3)  # one
    x = tw.e12.from_int(vals, device="cpu")          # (32, 2, 3, 2, 2, 10)
    coeffs = x.reshape(vm.TILE, 24, 10)
    prog = vm_pairing.program(name, "product")
    out = vm.execute(prog, {f"f{i}": coeffs[:, i] for i in range(24)},
                     vm.TILE)
    got = torch.stack([out[f"g{i}"] for i in range(24)], 1).reshape(x.shape)
    acc = x
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = tw.e12.mul(acc[:h], acc[h:])
    want = acc.expand_as(x)
    assert torch.equal(got, want)
    assert mont.to_int(tw.fp_spec, got[:, 0, 0, 0, 0]) == mont.to_int(
        tw.fp_spec, want[:, 0, 0, 0, 0])
