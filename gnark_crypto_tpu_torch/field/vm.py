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
program, row for row. :func:`schedule` then packs a built program into
**waves** of at most ``warps`` mutually independent rows (list scheduling
by the longest weighted chain below each row) and allocates its registers
again in wave order, so that no register is written by one row of a wave
and read or written by another; the code is laid out [wave][slot].
:func:`execute` loads the entry rows (inputs and Montgomery constants) and
calls :func:`vm_execute`: a CUDA tensor goes to ``csrc/vm.cu`` (one block
of ``warps`` warps per 32-lane tile, warp w running slot w of every wave,
the register file in shared memory; W = 8, 10, 12, 20 or 24 words), which
runs scheduled programs only, a CPU tensor to :func:`vm_execute_plain`,
which runs any program row by row with the plain field ops (a wave's rows
in any order give the same registers). Both return canonical residues, so they
agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.kernels import (
    FIELD_WIDTHS, check_width, count_launch, load_align, mont_mul_plain)
from gnark_crypto_tpu_torch.specs.field import FieldSpec, int_to_words
from gnark_crypto_tpu_torch.utils import build

TILE = 32       # default lanes per tile: one warp; the card runs only this
CHUNK = 512     # a built Program's code is NOP-padded to a multiple of this
                # (the reference's SMEM block)
SMEM_BYTES = 232448  # shared memory one block may use on Hopper
MAX_WARPS = 16  # warps of one VM block (csrc/vm.cu __launch_bounds__)
MUL_WEIGHT = 6  # a MUL row's latency in ADD rows, for the list scheduler

OP_MUL, OP_ADD, OP_SUB, OP_HALVE, OP_ROT, OP_NOP = range(6)


# ---------------------------------------------------------------------------
# SSA assembler + linear-scan register allocation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)  # identity eq/hash: programs
class Program:                                 # are built once and cached
    spec: FieldSpec
    code: np.ndarray                 # (rows, 4) int32, phys regs: built,
                                     # n_chunks*CHUNK; scheduled, [wave][slot]
    n_regs: int                      # K (allocated register-file height)
    entry_consts: tuple              # ((phys_reg, int_value_plain), ...)
    entry_inputs: tuple              # ((phys_reg, input_name), ...)
    out_regs: tuple                  # ((name, phys_reg), ...)
    n_instrs: int                    # rows run (built: before the padding)
    tile: int = TILE                 # lanes per tile (the width of ROT)
    n_entry: int = 0                 # entry rows = phys regs [0, n_entry)
    warps: int = 0                   # rows a wave if scheduled, else 0
    window: int = 0                  # the scheduler's look-ahead window
                                     # that fitted (WINDOWS), else 0

    @property
    def n_waves(self) -> int:
        """Waves of a scheduled program (code rows [wave][slot])."""
        return self.n_instrs // self.warps

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
                   tile: int = TILE, n_inputs: int = 4,
                   window: int = 12) -> Program:
    """A random program of all six ops for holding an executor against
    another: inputs ``x0..``, the constants 0, 1, 2 and q-1, ``n_ops``
    MUL/ADD/SUB/HALVE/ROT over the last ``window`` values (some in place),
    every 50th row followed by a NOP, and the last 8 values as outputs. A
    wider window gives more independent rows for :func:`schedule`."""
    rng = np.random.default_rng(seed)
    asm = Asm(spec, tile=tile)
    vals = [asm.input(f"x{i}") for i in range(n_inputs)]
    vals += [asm.const(c) for c in (0, 1, 2, spec.modulus - 1)]
    for _ in range(n_ops):
        a, b = (vals[int(i)] for i in rng.integers(
            max(0, len(vals) - window), len(vals), size=2))
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
# wave scheduling
# ---------------------------------------------------------------------------

# look-ahead windows of the list scheduler, widest first: a row more than a
# window past the first unscheduled row (in the built order) waits, which
# bounds the live values. The first window whose registers fit is taken; a
# window of 1 is the built order itself, which always fits.
WINDOWS = (1024, 256, 64, 16, 4, 1)


def reg_cap(spec: FieldSpec) -> int:
    """Registers that one block's shared memory holds at the card's tile:
    K x W x 4 bytes x 32 lanes <= SMEM_BYTES (227 at 8 words, 181 at 10,
    151 at 12, 90 at 20, 75 at 24)."""
    return SMEM_BYTES // (spec.n_words * 4 * TILE)


def _operands(op: int, a: int, b: int) -> tuple:
    """The distinct values a row reads (ROT's b is a shift)."""
    return (a,) if op == OP_ROT or a == b else (a, b)


class _Dag:
    """The live rows of a program in SSA form, in the program's order:
    values 0..n_entry-1 are the entry rows, row j defines value n_entry + j
    (each write to a physical register defines a new value)."""

    def __init__(self, prog: Program):
        ne = self.n_entry = prog.n_entry
        cur = list(range(ne)) + [-1] * (prog.n_regs - ne)
        rows = []   # (op, a, b): value ids, b the shift of a ROT, a HALVE's a
        for op, d, a, b in prog.code[:prog.n_instrs].tolist():
            if op == OP_NOP:
                continue
            if op == OP_ROT:
                rows.append((op, cur[a], b))
            else:
                rows.append((op, cur[a], cur[a if op == OP_HALVE else b]))
            cur[d] = ne + len(rows) - 1
        outs = [cur[reg] for _, reg in prog.out_regs]
        live = set(outs)
        keep = [False] * len(rows)
        for j in range(len(rows) - 1, -1, -1):
            if ne + j in live:
                keep[j] = True
                live.update(_operands(*rows[j]))
        new = list(range(ne)) + [-1] * len(rows)
        self.rows = []
        for j, (op, a, b) in enumerate(rows):
            if keep[j]:
                new[ne + j] = ne + len(self.rows)
                self.rows.append((op, new[a], b if op == OP_ROT else new[b]))
        self.outs = [new[v] for v in outs]
        n = len(self.rows)
        self.succs = [[] for _ in range(n)]
        self.indeg = [0] * n
        self.reads = [0] * (ne + n)   # readers of each value, outputs too
        for i, row in enumerate(self.rows):
            for v in _operands(*row):
                self.reads[v] += 1
                if v >= ne:
                    self.succs[v - ne].append(i)
                    self.indeg[i] += 1
        for v in self.outs:
            self.reads[v] += 1

    def heights(self, weights) -> list[int]:
        """Each row's longest chain down to an output, rows weighted by op."""
        h = [0] * len(self.rows)
        for i in range(len(self.rows) - 1, -1, -1):
            h[i] = weights[self.rows[i][0]] + max(
                (h[s] for s in self.succs[i]), default=0)
        return h

    def waves(self, h: list[int], width: int, window: int) -> list[list]:
        """List scheduling, longest chain first: a wave is MUL rows (the
        slow ones, led by the longest ready MUL chain) filled up with other
        rows when a MUL leads the ready rows, else other rows only."""
        rows, succs = self.rows, self.succs
        indeg = self.indeg[:]
        muls, others, held = [], [], []
        done = [False] * len(rows)
        frontier = 0

        def ready(i):
            if i >= frontier + window:
                heapq.heappush(held, i)
            else:
                heapq.heappush(muls if rows[i][0] == OP_MUL else others,
                               (-h[i], i))

        for i in range(len(rows)):
            if not indeg[i]:
                ready(i)
        waves = []
        left = len(rows)
        while left:
            wave = []
            if muls and (not others or muls[0] <= others[0]):
                while muls and len(wave) < width:
                    wave.append(heapq.heappop(muls)[1])
            while others and len(wave) < width:
                wave.append(heapq.heappop(others)[1])
            waves.append(wave)
            left -= len(wave)
            new = []
            for i in wave:
                done[i] = True
                for s in succs[i]:
                    indeg[s] -= 1
                    if not indeg[s]:
                        new.append(s)
            while frontier < len(rows) and done[frontier]:
                frontier += 1
            for s in new:
                ready(s)
            while held and held[0] < frontier + window:
                ready(heapq.heappop(held))
        return waves

    def allocate(self, waves) -> tuple[int, list[int]]:
        """Registers in wave order: a value's register is free from the
        wave after its last read, and a row other than ROT may take the
        register of an operand that only it reads in its wave and that
        dies there. Returns (K, register of each value)."""
        ne, rows = self.n_entry, self.rows
        rem = self.reads[:]
        phys = list(range(ne)) + [0] * len(rows)
        free = [v for v in range(ne) if not rem[v]]
        top = ne
        for wave in waves:
            readers = {}
            for i in wave:
                for v in _operands(*rows[i]):
                    rem[v] -= 1
                    readers.setdefault(v, []).append(i)
            taken = set()
            for i in wave:
                reg = None
                if rows[i][0] != OP_ROT:
                    for v in _operands(*rows[i]):
                        if not rem[v] and v not in taken and \
                                readers[v] == [i]:
                            taken.add(v)
                            reg = phys[v]
                            break
                if reg is None:
                    if free:
                        reg = heapq.heappop(free)
                    else:
                        reg, top = top, top + 1
                phys[ne + i] = reg
            for v in readers:
                if not rem[v] and v not in taken:
                    heapq.heappush(free, phys[v])
        return top, phys


def critical_path(prog: Program) -> tuple[int, int]:
    """(rows, MUL rows) on the longest chain of dependent rows: the depth
    that no schedule can beat."""
    dag = _Dag(prog)
    chains = [max(dag.heights(w), default=0)
              for w in ((1,) * 6, (1, 0, 0, 0, 0, 0))]
    return chains[0], chains[1]


def schedule(prog: Program, warps: int) -> Program:
    """``prog`` packed into waves of at most ``warps`` mutually independent
    rows, laid out [wave][slot] with NOP fill, registers allocated again in
    wave order within :func:`reg_cap`; the same function of the same
    inputs. Cached per (program, warps). Raises if even the program's own
    order needs more registers than the cap."""
    return _schedule(prog, warps)


@functools.lru_cache(maxsize=None)
def _schedule(prog: Program, warps: int) -> Program:
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"schedule: {warps} warps, not 1..{MAX_WARPS}")
    dag = _Dag(prog)
    cap = reg_cap(prog.spec)
    h = dag.heights((MUL_WEIGHT, 1, 1, 1, 1, 1))
    for window in WINDOWS:
        waves = dag.waves(h, warps, window)
        K, phys = dag.allocate(waves)
        if K <= cap:
            break
    else:
        raise ValueError(f"schedule: the program needs {K} registers, more "
                         f"than a block holds at {prog.spec.n_words} words "
                         f"({cap})")
    ne = dag.n_entry
    code = np.zeros((len(waves) * warps, 4), np.int32)
    code[:, 0] = OP_NOP
    for k, wave in enumerate(waves):
        for slot, i in enumerate(wave):
            op, a, b = dag.rows[i]
            code[k * warps + slot] = (op, phys[ne + i], phys[a],
                                      b if op == OP_ROT else phys[b])
    return dataclasses.replace(
        prog, code=code, n_regs=max(K, 1), n_instrs=len(code), warps=warps,
        window=window,
        out_regs=tuple((name, phys[v]) for (name, _), v in zip(
            prog.out_regs, dag.outs)))


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------

def vm_execute_plain(prog: Program, state: torch.Tensor) -> torch.Tensor:
    """Run ``prog`` over entry rows ``state`` (n_entry, n_pad, W) with the
    plain field ops, instruction by instruction (a scheduled program's
    waves in slot order); returns the output rows (n_out, n_pad, W). ROT
    rolls the lanes within each tile."""
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
    On the card ``prog`` must come from :func:`schedule` at a tile of 32.
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
            or not state.is_contiguous()
            or state.data_ptr() % load_align(W)):
        raise ValueError("vm_execute: expected a contiguous, aligned int32 "
                         f"(n_entry, n_pad, {spec.n_words}) tensor, got "
                         f"{state.dtype} {tuple(state.shape)}")
    if not 1 <= prog.warps <= MAX_WARPS or prog.tile != TILE:
        raise ValueError("vm_execute: the kernel runs programs from "
                         f"vm.schedule at a tile of {TILE} lanes, got "
                         f"warps={prog.warps}, tile={prog.tile}")
    smem = prog.n_regs * W * 4 * TILE
    if smem > SMEM_BYTES:
        raise ValueError(f"vm_execute: {prog.n_regs} registers x {TILE} "
                         f"lanes need {smem} bytes of shared memory, more "
                         f"than a block has ({SMEM_BYTES})")
    code, omap = _device_code(prog, str(state.device))
    out = torch.empty((len(prog.out_regs), n_pad, W), dtype=torch.int32,
                      device=state.device)
    fn = build.function("vm", "gct_vm_execute", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    count_launch(vm_execute, spec)
    build.check(fn(code.data_ptr(), prog.n_waves, prog.warps,
                   omap.data_ptr(), omap.shape[0], state.data_ptr(), n_entry,
                   out.data_ptr(), n_pad, prog.n_regs, W,
                   build.field_words(spec), build.stream_ptr(state)),
                "vm_execute launch")
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
