#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``gnark_crypto_tpu_torch/csrc`` (nvcc, sm_90a),
then drives the port's main path, the bn254 Fr NTT, through its public entry
points (``Domain``, ``fft``, ``fft_inverse``, ``mont.mul``) at 2^20 and 2^24
elements, and holds every result and every kernel against the plain PyTorch
versions on the same card, bit for bit (the field is exact: the tolerance is
0). Phases:

1. main path, with every kernel's launch count set to 0 before and read
   after: mont_mul on 2^20 random pairs plus the edge values 0, 1, q-1; all
   four (decimation, direction) pairs with and without coset at 2^20; DIF
   forward and the DIT inverse round trip at 2^24;
2. checks: each kernel against its plain version at the main path's shapes;
   each transform against the plain radix-2 stages; round trips; sampled
   outputs and twiddles against Python integers;
3. timing with CUDA events: each kernel, its plain version and whole
   transforms, with each kernel's bound (bytes over 3.35 TB/s, or 32-bit
   multiply-adds over the INT32 rate, whichever is larger).

Prints the card's name and power limit, the build time, a ``kernels`` JSON
line, a ``timings`` JSON line and, last, the device line. Exits non-zero,
with no result, without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth; the INT32 rate
# is 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12 multiply-adds/s,
# half the FP32 lane count behind the sheet's 67 TFLOP/s FP32.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9
MADS_PER_MONT_MUL = 136  # 8x8 for a*b, 8x8 for m*q, 8 for m (8-word CIOS)
ELEM_BYTES = 32
SEED = 20261016

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def bound(nbytes: float, mads: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mads / INT32_MAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from gnark_crypto_tpu_torch.field import kernels, mont
    from gnark_crypto_tpu_torch.ntt import fft, four_step, radix2
    from gnark_crypto_tpu_torch.ntt.domain import Domain, bitrev_perm
    from gnark_crypto_tpu_torch.specs import field as fs
    from gnark_crypto_tpu_torch.utils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    build_dir = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({build_dir})",
          flush=True)

    spec = fs.BN254_FR
    q = spec.modulus
    dev = torch.device("cuda", torch.cuda.current_device())
    nprng = np.random.default_rng(SEED)
    rng = random.Random(SEED)
    q_top = spec.q_words[-1]

    def random_elems(n: int) -> torch.Tensor:
        """n canonical elements (top word below q's, so every value < q)."""
        w = nprng.integers(0, 1 << 32, size=(n, spec.n_words),
                           dtype=np.uint32)
        w[:, -1] %= q_top
        return torch.from_numpy(w.view(np.int32)).to(dev)

    wrappers = {"mont_mul": kernels.mont_mul,
                "ntt_radix2_stage": radix2.stage,
                "ntt_radix2_block": radix2.block,
                "ntt_four_step": four_step.sub_ntt}

    # ---------------------------------------------------------------- phase 1
    n20, n24 = 1 << 20, 1 << 24
    x = torch.cat([mont.from_int(spec, [0, 1, q - 1], device=dev),
                   random_elems(n20)])
    y = torch.cat([mont.from_int(spec, [q - 1, 0, 1], device=dev),
                   random_elems(n20)])
    a20 = random_elems(n20)
    a24 = random_elems(n24)
    pairs = [(d, inv) for d in (fft.DIF, fft.DIT) for inv in (False, True)]

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    xy = mont.mul(spec, x, y)
    dom20 = Domain(spec, n20, device=dev)
    out20 = {}
    for dec, inv in pairs:
        for coset in (False, True):
            f = fft.fft_inverse if inv else fft.fft
            out20[dec, inv, coset] = f(dom20, a20, dec, coset)
    back20 = fft.fft_inverse(dom20, out20[fft.DIF, False, False], fft.DIT)
    back20c = fft.fft_inverse(dom20, out20[fft.DIF, False, True], fft.DIT,
                              coset=True)
    back20r = fft.fft_inverse(dom20, out20[fft.DIT, False, False], fft.DIF)
    dom24 = Domain(spec, n24, with_coset=False, device=dev)
    f24 = fft.fft(dom24, a24, fft.DIF)
    back24 = fft.fft_inverse(dom24, f24, fft.DIT)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    print("kernels: " + ", ".join(f"{k}={v}" for k, v in launches.items())
          + f" (main path {main_s:.2f} s)", flush=True)
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the main path ({count})")

    # ---------------------------------------------------------------- phase 2
    err = {name: 0 for name in wrappers}

    def compare(name: str, got: torch.Tensor, want: torch.Tensor,
                what: str) -> None:
        same = got.shape == want.shape
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()
                ) if same else -1
        err[name] = max(err[name], e) if e >= 0 else 2 ** 32
        check(same and e == 0, f"{name} == plain: {what}")

    mul_plain = kernels.mont_mul_plain
    compare("mont_mul", kernels.mont_mul(spec, x, y), mul_plain(spec, x, y),
            f"{x.shape[0]} pairs")
    compare("mont_mul", xy, mul_plain(spec, x, y), "mont.mul entry point")
    idx = [0, 1, 2] + rng.sample(range(3, x.shape[0]), 13)
    xs, ys, ps = (mont.to_int(spec, t[idx]) for t in (x, y, xy))
    check(ps == [u * v % q for u, v in zip(xs, ys)],
          "mont_mul: 16 samples == Python-int products")

    tw20 = dom20.twiddles0
    for dit in (False, True):
        z = a20
        for s in (range(9, -1, -1) if dit else range(10)):
            got = radix2.stage(spec, z, tw20, 20, s, dit)
            compare("ntt_radix2_stage", got,
                    radix2.stage_plain(spec, z, tw20, 20, s, dit),
                    f"2^20 stage {s} dit={dit}")
            z = got
        compare("ntt_radix2_block", radix2.block(spec, z, tw20, 10, 10, dit),
                radix2.block_plain(spec, z, tw20, 10, 10, dit),
                f"2^20 tail of 10 stages dit={dit}")

    def sub_ntt_steps(dom):
        steps = []
        for inv in (False, True):
            k1, k2, tw1, tw2, twist = four_step.tables(dom, inv)
            if inv:
                steps += [(tw2, k2, 1 << k1, False, True, twist),
                          (tw1, k1, 1 << k2, True, True, None)]
            else:
                steps += [(tw1, k1, 1 << k2, True, False, twist),
                          (tw2, k2, 1 << k1, False, False, None)]
        return steps

    for dom, a in ((dom20, a20), (dom24, a24)):
        for tw, log_s, other, cols, dit, twist in sub_ntt_steps(dom):
            args = (spec, a, tw, log_s, other, cols, dit, twist)
            compare("ntt_four_step", four_step.sub_ntt(*args),
                    four_step.sub_ntt_plain(*args),
                    f"2^{dom.k} {'columns' if cols else 'rows'} dit={dit} "
                    f"twist={twist is not None}")

    def plain_transform(dom, a, dec, inv, coset):
        """Plain radix-2 stages and plain products only."""
        if not inv:
            if coset:
                table = dom.coset_table
                a = mul_plain(spec, a, fft.bit_reverse(table)
                              if dec == fft.DIT else table)
            return radix2.run_plain(dom, a, dec, False)
        a = radix2.run_plain(dom, a, dec, True)
        scale = dom.cardinality_inv
        if coset:
            table = dom.coset_table_inv
            scale = mul_plain(spec, fft.bit_reverse(table)
                              if dec == fft.DIF else table, scale)
        return mul_plain(spec, a, scale)

    for (dec, inv, coset), got in out20.items():
        want = plain_transform(dom20, a20, dec, inv, coset)
        check(torch.equal(got, want), f"2^20 {dec} inverse={inv} "
              f"coset={coset} == plain stages")
    check(torch.equal(back20, a20), "2^20 DIT inverse(DIF fft(a)) == a")
    check(torch.equal(back20c, a20), "2^20 coset round trip == a")
    check(torch.equal(back20r, a20), "2^20 DIF inverse(DIT fft(a)) == a")
    t0 = time.perf_counter()
    want24 = plain_transform(dom24, a24, fft.DIF, False, False)
    torch.cuda.synchronize()
    plain24_s = time.perf_counter() - t0
    check(torch.equal(f24, want24), "2^24 DIF forward (four-step) == plain "
          f"stages ({plain24_s:.1f} s)")
    check(torch.equal(back24, a24), "2^24 DIT inverse(DIF fft(a)) == a")
    del want24

    # tables and outputs against Python integers at sampled points
    for table, base, what in (
            (dom24.twiddles0, dom24.generator_int, "2^24 twiddles"),
            (dom20.coset_table, dom20.shift_int, "2^20 coset table")):
        pts = rng.sample(range(table.shape[0]), 32)
        check(mont.to_int(spec, table[pts]) == [pow(base, i, q) for i in pts],
              f"{what} == powers at 32 points")
    a_int = mont.to_int(spec, a20)
    rev = bitrev_perm(n20)
    for i in rng.sample(range(n20), 2):
        wi = pow(dom20.generator_int, i, q)
        acc = 0
        for c in reversed(a_int):  # Horner: sum a_j w^(ij)
            acc = (acc * wi + c) % q
        check(mont.to_int(spec, out20[fft.DIF, False, False][int(rev[i])])
              == acc, f"2^20 DIF output at frequency {i} == Horner sum")

    # ---------------------------------------------------------------- phase 3
    def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
        """Median over rounds of the mean time of `reps` back-to-back calls."""
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / reps)
        return float(np.median(per))

    timings = {}
    kernel_rows = {}
    for dom, a, b in ((dom20, a20, x[3:]), (dom24, a24, None)):
        n, k = dom.n, dom.k
        tag = f"2^{k}"
        b = random_elems(n) if b is None else b
        t = min(k, radix2.TILE_LOG)
        s0 = k - t
        tw0 = dom.twiddles0
        k1, k2, tw1, tw2, twist = four_step.tables(dom, False)
        S1, S2 = 1 << k1, 1 << k2
        mm = MADS_PER_MONT_MUL
        rows = {
            "mont_mul": (
                lambda: kernels.mont_mul(spec, a, b),
                lambda: mul_plain(spec, a, b), 1,
                bound(3 * ELEM_BYTES * n, mm * n)),
            "ntt_radix2_stage": (
                lambda: [radix2.stage(spec, a, tw0, k, s, False)
                         for s in range(s0)],
                lambda: [radix2.stage_plain(spec, a, tw0, k, s, False)
                         for s in range(s0)], s0,
                bound(sum(2 * ELEM_BYTES * n + ELEM_BYTES * (n >> (s + 1))
                          for s in range(s0)) / s0, mm * n / 2)),
            "ntt_radix2_block": (
                lambda: radix2.block(spec, a, tw0, s0, t, False),
                lambda: radix2.block_plain(spec, a, tw0, s0, t, False), 1,
                bound(2 * ELEM_BYTES * n + ELEM_BYTES * (1 << (t - 1)),
                      mm * t * n / 2)),
            "ntt_four_step": (
                lambda: (four_step.sub_ntt(spec, a, tw1, k1, S2, True, False,
                                           twist),
                         four_step.sub_ntt(spec, a, tw2, k2, S1, False,
                                           False)),
                lambda: (four_step.sub_ntt_plain(spec, a, tw1, k1, S2, True,
                                                 False, twist),
                         four_step.sub_ntt_plain(spec, a, tw2, k2, S1, False,
                                                 False)), 2,
                bound((5 * ELEM_BYTES * n + ELEM_BYTES * (S1 + S2) / 2) / 2,
                      mm * (k * n / 2 + n) / 2)),
        }
        for name, (kfn, pfn, per_call, (b_ms, b_by)) in rows.items():
            ms = cuda_ms(kfn, reps=5) / per_call
            plain_ms = cuda_ms(pfn, reps=1, rounds=1) / per_call
            timings[f"{name} {tag}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "launches_per_call": per_call}
            kernel_rows.setdefault(name, timings[f"{name} {tag}"])
        for cols in (True, False):
            tw, ls, other, tws = ((tw1, k1, S2, twist) if cols
                                  else (tw2, k2, S1, None))
            nbytes = 2 * ELEM_BYTES * n + ELEM_BYTES * (1 << (ls - 1)) + (
                ELEM_BYTES * n if cols else 0)
            b_ms, b_by = bound(nbytes, mm * (ls * n / 2 + (n if cols else 0)))
            timings[f"ntt_four_step {'columns+twist' if cols else 'rows'} "
                    f"{tag}"] = {
                "ms": cuda_ms(lambda: four_step.sub_ntt(
                    spec, a, tw, ls, other, cols, False, tws), reps=5),
                "bound_ms": b_ms, "bound_by": b_by}
        for dec, inv in pairs:
            f = fft.fft_inverse if inv else fft.fft
            path = ("four-step" if four_step.supported(dom, dec, inv)
                    else "radix-2")
            ms = cuda_ms(lambda: f(dom, a, dec), reps=3)
            timings[f"fft {dec} inverse={inv} {tag} ({path})"] = {
                "ms": ms, "elems_per_s": n / (ms / 1e3)}
        timings[f"plain radix-2 DIF forward {tag}"] = {
            "ms": cuda_ms(lambda: plain_transform(dom, a, fft.DIF, False,
                                                  False), reps=1, rounds=1)}
        del b

    kernel_line = []
    sources = {
        "mont_mul": ("gnark_crypto_tpu_torch/csrc/mont_mul.cu",
                     "gnark_crypto_tpu/field/pallas/mont_mul.py:111"),
        "ntt_radix2_stage": ("gnark_crypto_tpu_torch/csrc/ntt_radix2.cu",
                             "gnark_crypto_tpu/ntt/pallas_ntt.py:309"),
        "ntt_radix2_block": ("gnark_crypto_tpu_torch/csrc/ntt_radix2.cu",
                             "gnark_crypto_tpu/ntt/pallas_ntt.py:309"),
        "ntt_four_step": ("gnark_crypto_tpu_torch/csrc/ntt_four_step.cu",
                          "gnark_crypto_tpu/ntt/pallas_ntt4.py:627"),
    }
    for name in wrappers:
        r = kernel_rows[name]
        kernel_line.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"timings": timings}), flush=True)
    print(json.dumps({"kernels": kernel_line}), flush=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
