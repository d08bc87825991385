"""The port's wave scheduler (``gnark_crypto_tpu_torch/field/vm.py``
``schedule``), which lays out every program that the VM kernel runs.

* Symbolic equivalence: each bn254, bls12-381 and bls12-377 pairing program
  (``full``, ``miller``, ``product``, ``reduce``, as ``pair_vm`` runs them)
  and its built form, run over value numbers (hash-consed ``(op,
  operands)``), give identical output expressions: the same function on
  every input, without a pairing on the plain executor.
* Wave legality: no register written by one row of a wave and read or
  written by another, no ROT into its own source, the register file within
  one block's shared memory, at most ``warps`` rows a wave.
* Plain runs: the scheduled and the built program on the plain executor,
  bit for bit, and one scheduled program against the JAX package's Pallas
  kernel in interpret mode, as canonical integers.

The tolerance is 0 (the field is exact).
"""

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.field.pallas import vm as jvm
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.field import mont, vm
from gnark_crypto_tpu_torch.pairing import vm_pairing
from gnark_crypto_tpu_torch.specs import field as fs

FAMILIES = ["bn254", "bls12_381", "bls12_377"]
VARIANTS = ["full", "miller", "product", "reduce"]
SPECS = [fs.BN254_FP, fs.BLS12_381_FP, fs.BLS12_377_FP]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: several test processes run plain field code at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def value_numbers(prog, table: dict) -> dict:
    """Each output of ``prog`` as a value number: entry rows and every row
    ``(op, operand numbers)`` hash-consed into ``table``, so two programs
    numbered into one table compute the same function where their outputs
    get the same numbers."""
    def number(key):
        return table.setdefault(key, len(table))

    regs = [None] * prog.n_regs
    for reg, val in prog.entry_consts:
        regs[reg] = number(("const", val))
    for reg, name in prog.entry_inputs:
        regs[reg] = number(("input", name))
    for op, d, a, b in prog.code[:prog.n_instrs].tolist():
        if op == vm.OP_NOP:
            continue
        if op == vm.OP_ROT:
            key = (op, regs[a], b)
        elif op == vm.OP_HALVE:
            key = (op, regs[a])
        else:
            key = (op, regs[a], regs[b])
        assert None not in key, "a row reads a register never written"
        regs[d] = number(key)
    return {name: regs[reg] for name, reg in prog.out_regs}


def check_waves(prog):
    """The layout the kernel relies on (csrc/vm.cu)."""
    assert 1 <= prog.warps <= vm.MAX_WARPS
    assert prog.n_instrs == prog.code.shape[0] == prog.n_waves * prog.warps
    assert prog.n_regs <= vm.reg_cap(prog.spec)
    assert prog.n_regs * prog.spec.n_words * 4 * vm.TILE <= vm.SMEM_BYTES
    waves = prog.code.reshape(prog.n_waves, prog.warps, 4).tolist()
    for wave in waves:
        rows = [r for r in wave if r[0] != vm.OP_NOP]
        assert rows, "an empty wave"
        for op, d, a, b in rows:
            if op == vm.OP_ROT:
                assert d != a and 0 < b < prog.tile
        reads = [{a} if op in (vm.OP_ROT, vm.OP_HALVE) else {a, b}
                 for op, _, a, b in rows]
        for i, (_, d, _, _) in enumerate(rows):
            for j, (_, dj, _, _) in enumerate(rows):
                if i != j:
                    assert d != dj and d not in reads[j]
    used = prog.code[prog.code[:, 0] != vm.OP_NOP, 1:3]
    assert used.max(initial=0) < prog.n_regs


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_scheduled_pairing_program_same_function(family, variant):
    built = vm_pairing.build_program(family, variant)
    sched = vm_pairing.program(family, variant)
    assert sched.warps == vm_pairing.WARPS
    assert sched.n_waves < built.n_instrs
    assert (sched.entry_consts, sched.entry_inputs, sched.n_entry) == (
        built.entry_consts, built.entry_inputs, built.n_entry)
    assert sched.op_counts()["MUL"] == built.op_counts()["MUL"]
    table = {}
    want = value_numbers(built, table)
    assert value_numbers(sched, table) == want
    assert list(want) == [name for name, _ in sched.out_regs]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("family", FAMILIES)
def test_scheduled_pairing_program_waves_legal(family, variant):
    prog = vm_pairing.program(family, variant)
    check_waves(prog)
    rows, muls = vm.critical_path(prog)
    assert (rows, muls) == vm.critical_path(
        vm_pairing.build_program(family, variant))
    assert prog.n_waves >= rows


def test_critical_path_of_bn254_full():
    """The longest chain of the bn254 ``full`` program: 6,358 rows, 905 of
    them products, against 117,029 rows in all."""
    prog = vm_pairing.build_program("bn254", "full")
    assert prog.n_instrs == 117029
    assert vm.critical_path(prog) == (6358, 905)


def random_state(prog, n_pad: int, seed: int) -> torch.Tensor:
    """Entry rows of ``prog`` over n_pad lanes: its constants, and random
    canonical inputs with 0, 1 and q - 1 in the first lanes."""
    spec = prog.spec
    q = spec.modulus
    rng = np.random.default_rng(seed)
    state = vm._entry_consts(prog, "cpu")[:, None, :].repeat(1, n_pad, 1)
    for reg, _ in prog.entry_inputs:
        vals = [0, 1, q - 1] + [int.from_bytes(rng.bytes(spec.n_words * 4),
                                               "big") % q
                                for _ in range(n_pad - 3)]
        state[reg] = mont.from_int(spec, vals, device="cpu")
    return state


@pytest.mark.parametrize("warps", [1, 8, 16])
@pytest.mark.parametrize("window", [12, 64])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_scheduled_random_program_plain_bit_exact(spec, window, warps):
    """A random program of all six ops (NOP rows, in-place rows, ROT) and
    its schedule on the plain executor over two tiles: equal bit for bit.
    The wide operand window fills the waves."""
    built = vm.random_program(spec, 600, seed=21, window=window)
    sched = vm.schedule(built, warps)
    check_waves(sched)
    assert sched.op_counts()["NOP"] > 0 or warps == 1
    if warps > 1 and window > 12:
        assert sched.n_waves * 4 < built.n_instrs
    state = random_state(built, 2 * vm.TILE, seed=window + warps)
    assert torch.equal(vm.vm_execute_plain(sched, state),
                       vm.vm_execute_plain(built, state))


@pytest.mark.parametrize("family", FAMILIES)
def test_scheduled_product_program_plain_bit_exact(family):
    """The ``product`` program that the multi-tile chain runs, scheduled
    and built, on the plain executor over two tiles."""
    built = vm_pairing.build_program(family, "product")
    sched = vm_pairing.program(family, "product")
    state = random_state(built, 2 * vm.TILE, seed=3)
    assert torch.equal(vm.vm_execute_plain(sched, state),
                       vm.vm_execute_plain(built, state))


def test_scheduled_program_matches_pallas_interpret():
    """A small random program of every op: scheduled into waves of 4 rows
    and run by the port, and in its built form by the JAX package's Pallas
    kernel in interpret mode; outputs equal as integers."""
    spec = fs.BN254_FP
    q = spec.modulus
    built = vm.random_program(spec, 120, seed=8, window=24)
    sched = vm.schedule(built, 4)
    check_waves(sched)
    jprog = jvm.Program(
        spec=jfs.BN254_FP, code=built.code, n_regs=built.n_regs,
        entry_consts=built.entry_consts, entry_inputs=built.entry_inputs,
        out_regs=built.out_regs, n_instrs=built.n_instrs, tile=built.tile,
        n_entry=built.n_entry)
    n = 40
    rng = np.random.default_rng(9)
    ins = {name: [0, 1, q - 1] + [int.from_bytes(rng.bytes(32), "big") % q
                                  for _ in range(n - 3)]
           for _, name in built.entry_inputs}
    jout = jvm.execute(jprog, {k: jmont.from_int(jfs.BN254_FP, v)
                               for k, v in ins.items()}, n, interpret=True)
    out = vm.execute(sched, {k: mont.from_int(spec, v, device="cpu")
                             for k, v in ins.items()}, n)
    for name, _ in built.out_regs:
        want = convert.from_jax_limbs(spec, np.asarray(jout[name]),
                                      device="cpu")
        assert mont.to_int(spec, out[name]) == mont.to_int(spec, want), name


def test_schedule_raises_past_the_register_cap():
    """A program whose own order keeps more values live than one block's
    shared memory holds at 12 words (151 registers) cannot be scheduled."""
    spec = fs.BLS12_381_FP
    asm = vm.Asm(spec)
    xs = [asm.input(f"x{i}") for i in range(160)]
    acc = xs[0]
    for x in xs[1:]:
        acc = asm.add(acc, x)
    prog = asm.build({"y": acc, **{f"z{i}": x for i, x in enumerate(xs)}})
    assert prog.n_regs > vm.reg_cap(spec)
    with pytest.raises(ValueError, match="registers"):
        vm.schedule(prog, 8)
    with pytest.raises(ValueError, match="warps"):
        vm.schedule(vm.random_program(spec, 20, seed=1), vm.MAX_WARPS + 1)
