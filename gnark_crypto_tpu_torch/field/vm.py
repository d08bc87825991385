"""Kernel: a straight-line-program executor for field arithmetic.

Counterpart of ``gnark_crypto_tpu/field/pallas/vm.py``. A **program** is an
``(op, dst, a, b)`` int32 instruction stream over a per-lane register file
of field elements; one batch element is one lane. The pairing's Miller loop
and final exponentiation are assembled into such programs by running the
tower and pairing formulas over the symbolic engines
(``towers/symbolic.py``, ``pairing/vm_pairing.py``), so a pairing is one
kernel launch per program.

Ops (every result canonical, in [0, q)):
  MUL   d = a * b          (Montgomery product, R = 2^(32W))
  ADD   d = a + b mod q
  SUB   d = a - b mod q
  HALVE d = a / 2 mod q    (reference element.go:367 Halve)
  ROT   d = lane (i + b) mod tile of a, for lane i (b an immediate)
  NOP   padding

:class:`Asm` emits SSA instructions and :meth:`Asm.build` eliminates dead
code and allocates physical registers by linear scan, in the reference's
order, so a program built here at the reference's tile is the reference's
program, row for row. :func:`execute` loads the entry rows (inputs and
Montgomery constants) and calls :func:`vm_execute`: a CUDA tensor goes to
``csrc/vm.cu`` (one thread per lane, one block per tile, the register file
in shared memory; W = 8 or 12 words), a CPU tensor to
:func:`vm_execute_plain`, which runs the same program instruction by
instruction with the plain field ops. Both return canonical residues, so
they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.kernels import (
    FIELD_WIDTHS, check_width, count_launch, mont_mul_plain)
from gnark_crypto_tpu_torch.specs.field import FieldSpec, int_to_words
from gnark_crypto_tpu_torch.utils import build

TILE = 32       # default lanes per tile: one warp, one block on the card
CHUNK = 512     # Program.code is NOP-padded to a multiple of this (the
                # reference's SMEM block; the kernel runs only n_instrs rows)
SMEM_BYTES = 232448  # shared memory one block may use on Hopper

OP_MUL, OP_ADD, OP_SUB, OP_HALVE, OP_ROT, OP_NOP = range(6)


# ---------------------------------------------------------------------------
# SSA assembler + linear-scan register allocation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)  # identity eq/hash: programs
class Program:                                 # are built once and cached
    spec: FieldSpec
    code: np.ndarray                 # (n_chunks*CHUNK, 4) int32, phys regs
    n_regs: int                      # K (allocated register-file height)
    entry_consts: tuple              # ((phys_reg, int_value_plain), ...)
    entry_inputs: tuple              # ((phys_reg, input_name), ...)
    out_regs: tuple                  # ((name, phys_reg), ...)
    n_instrs: int                    # before NOP padding
    tile: int = TILE                 # lanes per tile (the width of ROT)
    n_entry: int = 0                 # entry rows = phys regs [0, n_entry)

    def op_counts(self) -> dict[str, int]:
        """Instructions of each op, NOP padding excluded."""
        ops = self.code[:self.n_instrs, 0]
        return {name: int((ops == op).sum()) for op, name in enumerate(
            ("MUL", "ADD", "SUB", "HALVE", "ROT", "NOP"))}


class Asm:
    """SSA instruction emitter for one field spec.

    Values are integer SSA ids. ``input``/``const`` define entry values;
    ``mul/add/sub/halve/rot`` emit instructions. ``build`` performs
    liveness analysis + greedy register allocation (auto-sized to the peak
    live count) and returns a :class:`Program`.

    ``tile``: lanes per tile — the semantic width of ``rot`` (cross-lane
    product trees span exactly one tile).
    """

    def __init__(self, spec: FieldSpec, tile: int = TILE):
        self.spec = spec
        self.tile = tile
        self.code: list[tuple] = []   # (op, dst_ssa, a_ssa, b_ssa_or_imm)
        self.n_vals = 0
        self._inputs: list[tuple] = []   # (ssa, name)
        self._consts: dict[int, int] = {}  # value -> ssa

    def _new(self) -> int:
        v = self.n_vals
        self.n_vals += 1
        return v

    def input(self, name: str) -> int:
        v = self._new()
        self._inputs.append((v, name))
        return v

    def const(self, value: int) -> int:
        value %= self.spec.modulus
        if value not in self._consts:
            self._consts[value] = self._new()
        return self._consts[value]

    def _emit(self, op, a, b) -> int:
        d = self._new()
        self.code.append((op, d, a, b))
        return d

    def mul(self, a, b):
        return self._emit(OP_MUL, a, b)

    def add(self, a, b):
        return self._emit(OP_ADD, a, b)

    def sub(self, a, b):
        return self._emit(OP_SUB, a, b)

    def halve(self, a):
        return self._emit(OP_HALVE, a, a)

    def rot(self, a, lanes: int):
        assert 0 < lanes < self.tile
        d = self._new()
        self.code.append((OP_ROT, d, a, -lanes))  # negative marks immediate
        return d

    def build(self, outputs: dict[str, int], max_regs: int = 1024) -> Program:
        """Dead-code-eliminate, allocate physical registers (auto-sized to
        peak-live + 1 NOP-dump row; raises past the ``max_regs`` cap) and
        return the padded Program."""
        # DCE: formulas emit values that end up unused (trailing line
        # coefficients, the final point coordinates, ...)
        live = set(outputs.values())
        keep = [False] * len(self.code)
        for pos in range(len(self.code) - 1, -1, -1):
            op, d, a, b = self.code[pos]
            if d in live:
                keep[pos] = True
                live.discard(d)
                live.add(a)
                if op != OP_ROT:
                    live.add(b)
        self.code = [ins for ins, k in zip(self.code, keep) if k]
        self._inputs = [(v, n) for v, n in self._inputs if v in live]
        self._consts = {val: v for val, v in self._consts.items()
                        if v in live}

        last_use = {}
        for pos, (op, d, a, b) in enumerate(self.code):
            last_use[a] = pos
            if op != OP_ROT and b >= 0:
                last_use[b] = pos
        for v in outputs.values():
            last_use[v] = len(self.code)  # live to the end

        phys = {}
        free: list[int] = list(range(max_regs - 1, -1, -1))

        def alloc(v):
            if not free:
                raise RuntimeError(
                    f"register spill: >{max_regs} live values")
            phys[v] = free.pop()

        # entry values live from position -1; allocated first, so they land
        # in contiguous registers [0, n_entry), the rows of the entry state
        entry_vals = [v for v, _ in self._inputs] + \
            list(self._consts.values())
        for v in entry_vals:
            alloc(v)
        n_entry = len(entry_vals)
        assert [phys[v] for v in entry_vals] == list(range(n_entry))
        # free entry values that are never used
        expiring: dict[int, list[int]] = {}
        for v in entry_vals:
            expiring.setdefault(last_use[v], []).append(v)

        out = np.zeros((max(len(self.code), 1), 4), np.int32)
        for pos, (op, d, a, b) in enumerate(self.code):
            pa = phys[a]
            if op == OP_ROT:
                pb = -b  # immediate lane shift
            else:
                pb = phys[b]
            # free operands whose last use is this instruction BEFORE
            # allocating d (d may reuse a's register: in-place ok — every
            # op reads its operands before it writes the destination)
            for v in expiring.pop(pos, []):
                free.append(phys[v])
            alloc(d)
            expiring.setdefault(last_use[d], []).append(d)
            out[pos] = (op, phys[d], pa, pb)

        n = len(self.code)
        # auto-size the register file: peak-live + 1 NOP-dump row
        peak = max(phys.values(), default=0)
        dump = peak + 1
        n_chunks = max(1, -(-n // CHUNK))
        padded = np.full((n_chunks * CHUNK, 4),
                         (OP_NOP, dump, dump, dump), np.int32)
        padded[:n] = out[:n]
        return Program(
            spec=self.spec,
            code=padded,
            n_regs=dump + 1,
            entry_consts=tuple(sorted(
                (phys[v], val) for val, v in self._consts.items())),
            entry_inputs=tuple((phys[v], name) for v, name in self._inputs),
            out_regs=tuple((name, phys[v]) for name, v in outputs.items()),
            n_instrs=n,
            tile=self.tile,
            n_entry=n_entry,
        )


def random_program(spec: FieldSpec, n_ops: int, seed: int,
                   tile: int = TILE, n_inputs: int = 4) -> Program:
    """A random program of all six ops for holding an executor against
    another: inputs ``x0..``, the constants 0, 1, 2 and q-1, ``n_ops``
    MUL/ADD/SUB/HALVE/ROT over recent values (some in place), every 50th
    row followed by a NOP, and the last 8 values as outputs."""
    rng = np.random.default_rng(seed)
    asm = Asm(spec, tile=tile)
    vals = [asm.input(f"x{i}") for i in range(n_inputs)]
    vals += [asm.const(c) for c in (0, 1, 2, spec.modulus - 1)]
    for _ in range(n_ops):
        a, b = (vals[int(i)] for i in rng.integers(
            max(0, len(vals) - 12), len(vals), size=2))
        op = int(rng.integers(0, 5))
        if op == OP_ROT:
            vals.append(asm.rot(a, int(rng.integers(1, tile))))
        elif op == OP_HALVE:
            vals.append(asm.halve(a))
        else:
            vals.append(asm._emit(op, a, b))
    prog = asm.build({f"y{i}": v for i, v in enumerate(vals[-8:])})
    rows = prog.code[:prog.n_instrs]
    nop = np.asarray([(OP_NOP,) + (prog.n_regs - 1,) * 3], np.int32)
    body = np.concatenate([np.concatenate([rows[i:i + 50], nop])
                           for i in range(0, len(rows), 50)])
    n_chunks = -(-len(body) // CHUNK)
    code = np.concatenate([body, np.repeat(
        nop, n_chunks * CHUNK - len(body), axis=0)])
    return dataclasses.replace(prog, code=code, n_instrs=len(body))


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------

def vm_execute_plain(prog: Program, state: torch.Tensor) -> torch.Tensor:
    """Run ``prog`` over entry rows ``state`` (n_entry, n_pad, W) with the
    plain field ops, instruction by instruction; returns the output rows
    (n_out, n_pad, W). ROT rolls the lanes within each tile."""
    spec = prog.spec
    _, n_pad, W = state.shape
    tile = prog.tile
    regs = torch.zeros((prog.n_regs, n_pad, W), dtype=torch.int32,
                       device=state.device)
    regs[:prog.n_entry] = state
    for op, d, a, b in prog.code[:prog.n_instrs].tolist():
        if op == OP_MUL:
            regs[d] = mont_mul_plain(spec, regs[a], regs[b])
        elif op == OP_ADD:
            regs[d] = mont.add(spec, regs[a], regs[b])
        elif op == OP_SUB:
            regs[d] = mont.sub(spec, regs[a], regs[b])
        elif op == OP_HALVE:
            regs[d] = mont.halve(spec, regs[a])
        elif op == OP_ROT:
            regs[d] = regs[a].reshape(-1, tile, W).roll(-b, dims=1).reshape(
                n_pad, W)
    return regs[[reg for _, reg in prog.out_regs]]


@functools.lru_cache(maxsize=None)
def _device_code(prog: Program, device: str):
    """(code rows without the NOP padding, output register map) on device."""
    code = torch.from_numpy(
        np.ascontiguousarray(prog.code[:prog.n_instrs])).to(device)
    omap = torch.tensor([reg for _, reg in prog.out_regs], dtype=torch.int32,
                        device=device)
    return code, omap


def vm_execute(prog: Program, state: torch.Tensor) -> torch.Tensor:
    """Run ``prog`` over entry rows ``state``, int32 (n_entry, n_pad, W)
    with n_pad a multiple of ``prog.tile``; returns int32 (n_out, n_pad, W).
    """
    spec = prog.spec
    n_entry, n_pad, W = state.shape
    if n_entry != prog.n_entry or n_pad % prog.tile:
        raise ValueError(f"vm_execute: state {tuple(state.shape)} does not "
                         f"hold {prog.n_entry} entry rows of whole tiles of "
                         f"{prog.tile} lanes")
    if not state.is_cuda:
        return vm_execute_plain(prog, state)
    check_width(spec, "vm_execute", FIELD_WIDTHS)
    if (state.dtype != torch.int32 or W != spec.n_words
            or not state.is_contiguous() or state.data_ptr() % 16):
        raise ValueError("vm_execute: expected a contiguous, 16-byte aligned"
                         f" int32 (n_entry, n_pad, {spec.n_words}) tensor, "
                         f"got {state.dtype} {tuple(state.shape)}")
    smem = prog.n_regs * W * 4 * prog.tile
    if prog.tile > 1024 or smem > SMEM_BYTES:
        raise ValueError(f"vm_execute: {prog.n_regs} registers x "
                         f"{prog.tile} lanes need {smem} bytes of shared "
                         f"memory, more than a block has ({SMEM_BYTES})")
    code, omap = _device_code(prog, str(state.device))
    out = torch.empty((len(prog.out_regs), n_pad, W), dtype=torch.int32,
                      device=state.device)
    fn = build.function("vm", "gct_vm_execute", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    count_launch(vm_execute, spec)
    build.check(fn(code.data_ptr(), prog.n_instrs, omap.data_ptr(),
                   omap.shape[0], state.data_ptr(), n_entry, out.data_ptr(),
                   n_pad, prog.tile, prog.n_regs, W, build.field_words(spec),
                   build.stream_ptr(state)), "vm_execute launch")
    return out


vm_execute.launches = 0
vm_execute.launches_by_width = {}


# ---------------------------------------------------------------------------
# host-side program execution
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry_consts(prog: Program, device: str) -> torch.Tensor:
    """(n_entry, W) int32 entry rows: Montgomery-form constants (R =
    2^(32W)) at their registers, zero at the input registers."""
    spec = prog.spec
    cols = np.zeros((prog.n_entry, spec.n_words), np.uint32)
    for reg, val in prog.entry_consts:
        cols[reg] = int_to_words(val * spec.r % spec.modulus, spec.n_words)
    return torch.from_numpy(cols.view(np.int32)).to(device)


def execute(prog: Program, inputs: dict, n: int) -> dict:
    """Run a Program over batched inputs.

    inputs: name -> (n, W) int32 Montgomery word tensors (or (W,), applied
    to every lane), all on one device. Lanes past n, up to a whole tile,
    get zero inputs. Returns name -> (n, W) tensors for ``prog.out_regs``.
    """
    W = prog.spec.n_words
    device = next(iter(inputs.values())).device
    n_pad = -(-max(n, 1) // prog.tile) * prog.tile
    state = _entry_consts(prog, str(device))[:, None, :].repeat(1, n_pad, 1)
    for reg, name in prog.entry_inputs:
        state[reg, :n] = inputs[name].expand(n, W)
    out = vm_execute(prog, state)
    return {name: out[i, :n] for i, (name, _) in enumerate(prog.out_regs)}
