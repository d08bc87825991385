#!/usr/bin/env python3
"""Designs of the ``exp_const`` and ``jac_double2`` kernels, on one NVIDIA card.

    python3 tools/exp_dbl2_sweep.py            # the sweep
    python3 tools/exp_dbl2_sweep.py --wrappers  # only the wrappers' times

The package's kernels fix one design each at compile time. The sweep
builds ``tools/exp_dbl2_variants.cu`` (the same kernel templates of
``csrc/exp.cu`` and ``csrc/point_add2.cu``, the design a run-time
argument) into a library of its own under ``scratch/exp_dbl2_variants/``,
beside the package's build (``utils/build.py``), and prints what
``-Xptxas -v`` said of each instantiation (registers, spills) and, where
``cuobjdump`` is found, the SASS instructions of ``mont_mul_kernel`` (one
``gct::mont_mul`` a thread) and of the one-lane 8-word ``exp_const``
kernel (a ``gct::mont_mul_ilp`` in each role's loop). Then, with CUDA
events (median of 5 rounds of 5 launches, queued behind a spin kernel so
that the host's time a call does not count):

* ``exp_const`` at 128 lanes, e = q - 2 (the MSM seed), on bn254 (8
  words), bls24-315 and bls24-317 (10) and bls12-381 and bls12-377 (12)
  Fp, for every team size T (1, 2, 4, 8) at 32, 64 and 128 lanes a role:
  ms and us per serial square;
* ``jac_double2`` at 2^16 lanes (the G2 bases' ladder) for the three
  (words, u^2) pairs, one thread or a pair of threads a point, with
  ``gct::mont_mul`` or the column product, at 64, 128 and 256 threads a
  block;
* the public wrappers ``exp_const`` and ``jac_double2`` in their fixed
  designs, at the same shapes.

Each design's output is held against the plain version once (bit for bit);
a mismatch prints FAIL and the tool exits non-zero. Inputs are random
canonical words from a fixed seed, with 0 and 1 among the exponent's and
infinite points among the double's lanes. ``--wrappers`` times only the
wrappers, so that the same command times another checkout's package (its
directory in ``GCT_ROOT``). Prints the card's name and power limit, a line
per measurement and, last, one JSON object of them all. Exits non-zero
without a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, os.environ.get("GCT_ROOT") or str(ROOT))

SEED = 20261018
EXP_LANES = 128
DBL_LANES = 1 << 16
FIELDS = ("bn254_fp", "bls24_315_fp", "bls24_317_fp", "bls12_381_fp",
          "bls12_377_fp")
G2 = (("bn254", 8, -1), ("bls12_381", 12, -1), ("bls12_377", 12, -5))


def ptxas_report(log: Path) -> list[str]:
    """One line per kernel of an ``-Xptxas -v`` log: name, registers,
    stack frame, spills."""
    out, name, spill = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = (f"stack {m.group(1)} B, spills {m.group(2)}/"
                     f"{m.group(3)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{demangle(name)}: {m.group(1)} registers, {spill}")
            name = None
    return out


def demangle(name: str) -> str:
    tool = shutil.which("c++filt")
    if not tool:
        return name
    return subprocess.run([tool, name], capture_output=True,
                          text=True).stdout.strip()


def sass_counts(lib: Path, pattern: str) -> dict:
    """{kernel: SASS instructions} of the kernels of ``lib`` whose
    demangled name matches ``pattern``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = demangle(block.split("\n", 1)[0].strip())
        if re.search(pattern, name):
            insns = re.findall(r"/\*[0-9a-f]{4}\*/\s+([A-Z0-9_.]+)", block)
            ops = {}
            for op in insns:
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
            out[name] = {"instructions": len(insns),
                         "by_opcode": dict(sorted(ops.items(),
                                                  key=lambda kv: -kv[1]))}
    return out


def start_variants(build) -> tuple[Path, subprocess.Popen]:
    """Starts nvcc on ``tools/exp_dbl2_variants.cu``; returns the library's
    path and the process (its report in ``lib<name>.log`` beside it)."""
    out = ROOT / "scratch" / "exp_dbl2_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libexp_dbl2_variants.so"
    with open(out / "libexp_dbl2_variants.log", "w") as fh:
        proc = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I",
             str(ROOT / "gnark_crypto_tpu_torch" / "csrc"), "-o", str(lib),
             str(ROOT / "tools" / "exp_dbl2_variants.cu")],
            stdout=fh, stderr=subprocess.STDOUT)
    return lib, proc


def main() -> int:
    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_dbl2_sweep: no CUDA device", file=sys.stderr)
        return 1
    from gnark_crypto_tpu_torch.curve.g2 import g2_curve
    from gnark_crypto_tpu_torch.field import exp, point_add2
    from gnark_crypto_tpu_torch.specs import field as fs
    from gnark_crypto_tpu_torch.utils import build

    wrappers_only = "--wrappers" in sys.argv[1:]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    if not wrappers_only:
        vlib, vproc = start_variants(build)
    bdir = build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    out: dict = {}
    failures = []

    if not wrappers_only:
        if vproc.wait():
            print((vlib.parent / "libexp_dbl2_variants.log").read_text())
            raise RuntimeError("nvcc failed for tools/exp_dbl2_variants.cu")
        variants = ctypes.CDLL(str(vlib))
        exp_variant = variants.gct_exp_const_variant
        dbl_variant = variants.gct_jac_double2_variant
        P, I = ctypes.c_void_p, ctypes.c_int
        exp_variant.argtypes = [P, P, ctypes.c_longlong, I, P, P, P, I, I, I,
                                P]
        dbl_variant.argtypes = [P] * 6 + [ctypes.c_longlong, I, I, P, I, I,
                                          I, P]
        for lib, log in ((bdir / "libexp.so", bdir / "libexp.log"),
                         (bdir / "libpoint_add2.so",
                          bdir / "libpoint_add2.log"),
                         (bdir / "libmont_mul.so", bdir / "libmont_mul.log"),
                         (vlib, vlib.with_suffix(".log"))):
            lines = ptxas_report(log)
            out[f"ptxas {lib.stem}"] = lines
            for line in lines:
                print(f"ptxas {lib.stem}: {line}", flush=True)
        sass = {**sass_counts(bdir / "libmont_mul.so", r"mont_mul_kernel"),
                **sass_counts(bdir / "libexp.so", r"exp_const_kernel<8, 1>")}
        out["sass"] = sass
        for name, row in sass.items():
            print(f"sass {name}: {json.dumps(row)}", flush=True)

    def exp_launch(spec, x, e, team, lanes):
        words, nbits = exp.exponent_words(spec, e)
        res = torch.empty_like(x)
        word_t = ctypes.c_uint32 * spec.n_words
        build.check(exp_variant(
            x.data_ptr(), res.data_ptr(), x.shape[0], spec.n_words,
            build.field_words(spec), word_t(*spec.one_words), word_t(*words),
            nbits, team, lanes, build.stream_ptr(x)), "exp_const variant")
        return res

    def dbl_launch(fp, nr, coords, pair, ilp, threads):
        res = tuple(torch.empty_like(coords[0]) for _ in range(3))
        build.check(dbl_variant(
            *(t.data_ptr() for t in (*coords, *res)), coords[0].shape[0],
            fp.n_words, nr, build.field_words(fp), int(pair), int(ilp),
            threads, build.stream_ptr(coords[0])), "jac_double2 variant")
        return res

    def words(spec, n):
        w = rng.integers(0, 1 << 32, size=(n, spec.n_words), dtype=np.uint32)
        w[:, -1] %= spec.q_words[-1]
        return torch.from_numpy(w.view(np.int32)).to(dev)

    def cuda_ms(fn, reps=5, rounds=5):
        """Device time a call: the launches queue behind a spin kernel, so
        the host's own time a call does not count."""
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(5_000_000)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / reps)
        return float(np.median(per))

    def hold(name, got, want):
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        if not same:
            failures.append(name)
            print(f"FAIL {name} != plain", flush=True)

    for fname in FIELDS:
        spec = fs.get_field(fname)
        e = spec.modulus - 2
        x = words(spec, EXP_LANES)
        x[0] = 0
        x[1] = torch.tensor([w - (w >> 31 << 32) for w in spec.one_words],
                            dtype=torch.int32)
        squares = e.bit_length() - 1
        ms = cuda_ms(lambda: exp.exp_const(spec, x, e))
        out[f"exp_const {fname}"] = {"ms": ms}
        print(f"exp_const {fname} {EXP_LANES} lanes: {ms:.4f} ms",
              flush=True)
        if wrappers_only:
            continue
        want = exp.exp_const_plain(spec, x, e)
        hold(f"exp_const {fname}", (exp.exp_const(spec, x, e),), (want,))
        for team in (1, 2, 4, 8):
            for lanes in (32, 64, 128):
                fn = (lambda t=team, n=lanes: exp_launch(spec, x, e, t, n))
                key = f"exp_const {fname} T={team} lanes={lanes}"
                hold(key, (fn(),), (want,))
                ms = cuda_ms(fn)
                out[key] = {"ms": ms, "us_per_square": ms * 1e3 / squares,
                            "squares": squares}
                print(f"{key}: {ms:.4f} ms, "
                      f"{ms * 1e3 / squares:.3f} us a square", flush=True)

    for name, W, nr in G2:
        g2 = g2_curve(name, dev)
        fp = g2.spec.fp
        coords = []
        for _ in range(3):
            c = torch.stack([words(fp, DBL_LANES), words(fp, DBL_LANES)], 1)
            coords.append(c.contiguous())
        coords[2][::17] = 0  # infinite lanes: Z = 0
        ms = cuda_ms(lambda: point_add2.jac_double2(fp, nr, *coords))
        out[f"jac_double2 {name}"] = {"ms": ms}
        print(f"jac_double2 {name} {DBL_LANES} lanes: {ms:.4f} ms",
              flush=True)
        if wrappers_only:
            continue
        want = point_add2.jac_double2_plain(fp, nr, *coords)
        odd = [c[:DBL_LANES - 3] for c in coords]
        want_odd = [w[:DBL_LANES - 3] for w in want]
        hold(f"jac_double2 {name}", point_add2.jac_double2(fp, nr, *coords),
             want)
        for pair in (True, False):
            for ilp in (False, True):
                for threads in (64, 128, 256):
                    fn = (lambda p=pair, i=ilp, t=threads, cs=coords:
                          dbl_launch(fp, nr, cs, p, i, t))
                    key = (f"jac_double2 {name} pair={pair} ilp={ilp} "
                           f"threads={threads}")
                    hold(key, fn(), want)
                    hold(key + " odd n", fn(cs=odd), want_odd)
                    ms = cuda_ms(fn)
                    out[key] = {"ms": ms}
                    print(f"{key}: {ms:.4f} ms", flush=True)

    print(json.dumps({"exp_dbl2_sweep": out, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
