#!/usr/bin/env python3
"""What a wave costs in the VM kernel (``csrc/vm.cu``), on one NVIDIA card.

    python3 tools/vm_waves.py

Builds the kernels (``utils/build.py``), then times with CUDA events
(median of 3 rounds of 3 launches):

* a wave of k rows of one op: k independent chains of 2000 ADD or MUL
  rows, scheduled into 2000 waves of k rows (k = 1, 4, 8, 16), at 8 and
  12 words, 32 lanes;
* every pairing program (bn254, bls12-381, bls12-377 x ``full``,
  ``miller``, ``product``, ``reduce``) at the lanes the pairing path gives
  it (32, 2048, 64, 32), scheduled at 4, 8, 12 and 16 warps a block: its
  waves, waves holding a MUL, registers K and ms.

Inputs are random canonical entry rows from a fixed seed; no result is
checked here (``chip_smoke.py`` holds the kernel against its plain
version). Prints the card's name and power limit, a line per measurement
and, last, one JSON object of them all. Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LANES = {"full": 32, "miller": 2048, "product": 64, "reduce": 32}
WARPS = (4, 8, 12, 16)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vm_waves: no CUDA device", file=sys.stderr)
        return 1
    from gnark_crypto_tpu_torch.field import vm
    from gnark_crypto_tpu_torch.pairing import vm_pairing
    from gnark_crypto_tpu_torch.specs import field as fs
    from gnark_crypto_tpu_torch.utils import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261018)

    def state(prog, n_pad):
        spec = prog.spec
        st = vm._entry_consts(prog, str(dev))[:, None, :].repeat(1, n_pad, 1)
        for reg, _ in prog.entry_inputs:
            w = rng.integers(0, 1 << 32, size=(n_pad, spec.n_words),
                             dtype=np.uint32)
            w[:, -1] %= spec.q_words[-1]
            st[reg] = torch.from_numpy(w.view(np.int32)).to(dev)
        return st

    def cuda_ms(prog, st, reps=3, rounds=3):
        vm.vm_execute(prog, st)
        torch.cuda.synchronize()
        per = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                vm.vm_execute(prog, st)
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / reps)
        return float(np.median(per))

    out = {}
    for spec in (fs.BN254_FP, fs.BLS12_381_FP):
        for op in ("add", "mul"):
            for k in (1, 4, 8, 16):
                asm = vm.Asm(spec)
                xs = [asm.input(f"x{i}") for i in range(k)]
                c = asm.const(3)
                for _ in range(2000):
                    xs = [getattr(asm, op)(x, c) for x in xs]
                prog = vm.schedule(
                    asm.build({f"y{i}": x for i, x in enumerate(xs)}), k)
                us = cuda_ms(prog, state(prog, vm.TILE)) * 1e3 / prog.n_waves
                key = f"{spec.n_words} words {op} wave of {k} rows"
                out[key] = {"us_per_wave": us}
                print(f"{key}: {us:.3f} us", flush=True)
    for name in vm_pairing.VM_FAMILIES:
        for variant, lanes in LANES.items():
            built = vm_pairing.build_program(name, variant)
            st = state(built, lanes)
            for warps in WARPS:
                prog = vm.schedule(built, warps)
                ms = cuda_ms(prog, st)
                ops = prog.code[:, 0].reshape(prog.n_waves, warps)
                row = {"ms": ms, "waves": prog.n_waves,
                       "mul_waves": int((ops == vm.OP_MUL).any(1).sum()),
                       "registers": prog.n_regs, "lanes": lanes}
                key = f"{name} {variant} {warps} warps"
                out[key] = row
                print(f"{key}: {json.dumps(row)}", flush=True)
    print(json.dumps({"vm_waves": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
