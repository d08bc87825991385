"""The port's straight-line VM (``gnark_crypto_tpu_torch/field/vm.py``)
against the JAX package's (``gnark_crypto_tpu/field/pallas/vm.py``).

* Program equality: the port's bn254, bls12-381 and bls12-377
  ``build_program`` at the reference's tile of 256 is the reference's
  program row for row, with the same registers, entry rows and outputs.
  This holds the towers, the symbolic engines, the pairing formulas and the
  allocator at once.
* Semantics: the plain executor against the Pallas kernel in interpret
  mode on a small program of every op, and against Python integers on a
  random program (at 8 and 12 words) and on the ``product`` program at the
  port's tile.

Values cross as canonical integers; the tolerance is 0 (the field is exact).
"""

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.field.pallas import vm as jvm
from gnark_crypto_tpu.pairing import vm_pairing as jvp
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.field import mont, vm
from gnark_crypto_tpu_torch.pairing import vm_pairing
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.towers.tower12 import get_tower

SPEC = fs.BN254_FP
Q = SPEC.modulus


def lane_values(n, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, Q - 1, 2, (Q - 1) // 2]
    return (edge + [int.from_bytes(rng.bytes(32), "big") % Q
                    for _ in range(n)])[:n]


@pytest.mark.parametrize("variant", ["full", "miller", "product", "reduce"])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_build_program_equals_reference(curve, variant):
    got = vm_pairing.build_program(curve, variant, tile=256)
    want = jvp.build_program(curve, variant)
    assert got.tile == want.tile == 256
    assert got.n_instrs == want.n_instrs
    assert np.array_equal(got.code, want.code)
    assert (got.n_regs, got.n_entry) == (want.n_regs, want.n_entry)
    assert got.entry_consts == want.entry_consts
    assert got.entry_inputs == want.entry_inputs
    assert got.out_regs == want.out_regs


def _all_ops(asm):
    x, y = asm.input("x"), asm.input("y")
    t = asm.mul(x, y)
    u = asm.add(t, asm.const(7))
    v = asm.halve(u)
    w = asm.sub(v, asm.const(Q - 1))
    r = asm.rot(w, 3)
    s = asm.mul(r, asm.sub(asm.const(0), x))
    return asm.build({"w": w, "r": r, "s": s}, max_regs=16)


def test_vm_all_ops_match_pallas_interpret():
    """One program of every op (the Pallas run also walks the NOP padding)
    through both executors at tile 256; outputs equal as integers."""
    jprog = _all_ops(jvm.Asm(jfs.BN254_FP, tile=256))
    prog = _all_ops(vm.Asm(SPEC, tile=256))
    assert np.array_equal(prog.code, jprog.code)
    n = 9
    xs, ys = lane_values(n, 1), lane_values(n, 2)[::-1]
    jout = jvm.execute(jprog, {"x": jmont.from_int(jfs.BN254_FP, xs),
                               "y": jmont.from_int(jfs.BN254_FP, ys)}, n,
                       interpret=True)
    out = vm.execute(prog, {"x": mont.from_int(SPEC, xs, device="cpu"),
                            "y": mont.from_int(SPEC, ys, device="cpu")}, n)
    for name in ("w", "r", "s"):
        want = convert.from_jax_limbs(SPEC, np.asarray(jout[name]),
                                      device="cpu")
        assert torch.equal(out[name], want), name


def run_ints(prog, inputs: dict, n_pad: int) -> dict:
    """Python-integer oracle: the program over plain values, lane by lane."""
    Q = prog.spec.modulus
    inv2 = pow(2, -1, Q)
    regs = [None] * prog.n_regs
    for reg, val in prog.entry_consts:
        regs[reg] = [val] * n_pad
    for reg, name in prog.entry_inputs:
        regs[reg] = inputs[name] + [0] * (n_pad - len(inputs[name]))
    t = prog.tile
    for op, d, a, b in prog.code[:prog.n_instrs].tolist():
        if op == vm.OP_MUL:
            regs[d] = [u * v % Q for u, v in zip(regs[a], regs[b])]
        elif op == vm.OP_ADD:
            regs[d] = [(u + v) % Q for u, v in zip(regs[a], regs[b])]
        elif op == vm.OP_SUB:
            regs[d] = [(u - v) % Q for u, v in zip(regs[a], regs[b])]
        elif op == vm.OP_HALVE:
            regs[d] = [u * inv2 % Q for u in regs[a]]
        elif op == vm.OP_ROT:
            src = regs[a]
            regs[d] = [src[i - i % t + (i % t + b) % t] for i in range(n_pad)]
    return {name: regs[reg] for name, reg in prog.out_regs}


def test_vm_random_program_matches_ints():
    """A random program of all six ops (in-place destinations, ROT across
    a 32-lane tile, NOP rows) over two tiles with edge values."""
    prog = vm.random_program(SPEC, 600, seed=5)
    counts = prog.op_counts()
    assert all(counts[k] > 0 for k in counts), counts
    n = 40
    ins = {f"x{i}": lane_values(n, 10 + i) for i in range(4)}
    out = vm.execute(prog, {k: mont.from_int(SPEC, v, device="cpu")
                            for k, v in ins.items()}, n)
    want = run_ints(prog, ins, 64)
    for name, vals in want.items():
        assert mont.to_int(SPEC, out[name]) == vals[:n], name


@pytest.mark.parametrize("name", ["bls12_381_fp", "bls12_377_fp"])
def test_vm_random_program_matches_ints_12_words(name):
    """The same at 12 words, the width of the bls12 pairing programs."""
    spec = fs.get_field(name)
    q = spec.modulus
    prog = vm.random_program(spec, 600, seed=6)
    assert all(v > 0 for v in prog.op_counts().values())
    n = 40
    rng = np.random.default_rng(11)
    ins = {f"x{i}": ([0, 1, q - 1, 2, (q - 1) // 2] + [
        int.from_bytes(rng.bytes(48), "big") % q for _ in range(n)])[:n]
        for i in range(4)}
    out = vm.execute(prog, {k: mont.from_int(spec, v, device="cpu")
                            for k, v in ins.items()}, n)
    assert out["y0"].shape == (n, 12)
    want = run_ints(prog, ins, 64)
    for name_, vals in want.items():
        assert mont.to_int(spec, out[name_]) == vals[:n], name_


def test_vm_product_program_matches_e12_products():
    """The ``product`` program at the port's tile: the product of the live
    E12 rows (pad rows are one) lands in lane 0, as the tower's own
    products give it."""
    tw = get_tower("bn254", "cpu")
    prog = vm_pairing.build_program("bn254", "product")
    assert prog.tile == vm_pairing._TILE["bn254"]
    rng = np.random.default_rng(7)
    n_live = 5
    vals = [tuple(tuple(tuple(
        int.from_bytes(rng.bytes(32), "big") % Q
        for _ in range(2)) for _ in range(3)) for _ in range(2))
        for _ in range(n_live)]
    A = tw.e12.from_int(vals)
    one = tw.e12.ones(())
    rows = torch.cat([A, one.expand(prog.tile - n_live, *one.shape)])
    flat = rows.reshape(prog.tile, 12, -1)
    out = vm.execute(prog, {f"f{i}": flat[:, i] for i in range(12)},
                     prog.tile)
    got = torch.stack([out[f"g{i}"][0] for i in range(12)]).reshape(one.shape)
    acc = A[0]
    for i in range(1, n_live):
        acc = tw.e12.mul(acc, A[i])
    assert torch.equal(got, acc)


def test_vm_execute_checks_its_state():
    prog = vm.random_program(SPEC, 20, seed=1)
    state = torch.zeros((prog.n_entry, prog.tile + 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        vm.vm_execute(prog, state)
    with pytest.raises(ValueError):
        vm.vm_execute(prog, state[1:, :prog.tile])
