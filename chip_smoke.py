#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``gnark_crypto_tpu_torch/csrc`` (nvcc, sm_90a),
then drives the port's ported paths through their public entry points and
holds every result and every kernel against the plain PyTorch versions on
the same card, bit for bit (the field is exact: the tolerance is 0):

* the bn254 Fr NTT (``Domain``, ``fft``, ``fft_inverse``, ``mont.mul``) at
  2^20 and 2^24 elements;
* the bn254 G1 MSM (``curve_ops``, ``scalar_mul``, ``to_affine``, ``msm``,
  ``batch_scalar_mul``): points [i+1]G for i < 2^16 by a 17-bit ladder,
  tiled to 2^20 and 2^24, random canonical scalars, MSMs at 2^16, 2^20 and
  2^24, ``batch_scalar_mul`` at 2^16, and a 2^12 ``stark_g1`` MSM (a = 1)
  so that the a != 0 branches of the kernels launch;
* the bn254 pairing (``pairing.api.pair``/``pairing_check`` on the VM
  kernel): 2048 pairs P_i = [a_i]G1 (``batch_scalar_mul``), Q_i = [b_i]G2
  (``g2_curve`` scalar mul), lane 0 infinite and the last lane
  (-sum a_i b_i G1, G2), so the product is 1; the same with one scalar
  changed; a batch-2 check in the KZG-verify shape; e(G1, G2) and
  e([5]G1, [7]G2) against the golden gnark bytes;
* the bn254 G2 MSM (``g2_curve``, ``batch_scalar_mul``, ``msm`` on the Fp2
  kernels): points [i+1]G2 for i < 2^16, tiled to 2^20, random canonical
  scalars, MSMs at 2^16 (c = 11) and 2^20 (c = 13), each against
  [sum s_i k_i mod r]G2 by one G2 scalar multiplication;
* bn254 KZG at 2^20 (``protocols.kzg``): an SRS from a seeded alpha
  ([alpha]G2 against a Python-int Fp2 ladder), ``commit`` and
  ``open_poly`` of a random polynomial against [p(alpha)]G1 and
  [q(alpha)]G1 from host integers, ``verify`` True and, with the claimed
  value changed, False; ``batch_open_single_point`` of 4 polynomials and
  ``batch_verify_single_point``, True and, with two digests swapped,
  False; and ``batch_verify_multi_points`` over 4 proofs at 4 points, True
  and, with one proof's H swapped, False;
* the small fields (``Domain``, ``fft``, ``fft_inverse`` over the f31 and
  f64 engines; ``hashes.sis.rsis``, ``RSis.hash``, ``RSis.hash_many``):
  the koalabear NTT at 2^20 (all four pairs, coset and not) and 2^24 (all
  four pairs), the babybear NTT at 2^20 and the goldilocks NTT at 2^20
  (with coset) and 2^24, DIF forward and the DIT inverse round trip; the
  Ring-SIS hash ``rsis(f, 42, 9, 16, n)`` of 2^20 koalabear elements and
  2^18 goldilocks elements below 2^63 (``bench.py:381-398``); and
  ``RSis(koalabear, 42, 4, 8, 64).hash_many`` over 2048 columns of 64
  elements (Vortex's column hash, ``protocols/vortex.py:54-58``);
* bls12-381 and bls12-377 (12-word Fp, the 12-word instantiations of the
  field, exponent, G1 point, Fp2 point and VM kernels; the Fp2 kernels at
  u^2 = -1 for bls12-381 and -5 for bls12-377): the G1 MSM as for bn254
  at 2^12 (an EIP-4844 blob), 2^16 and 2^20 with ``batch_scalar_mul`` at
  2^16; the pairing as for bn254 at 2048 pairs, tampered, at batch 2 and
  against the golden bytes, with Q_i = [b_i]G2 by the G2 ``scalar_mul``
  on the card (sampled lanes and a few [k]G2 against a Python-int Fp2
  ladder); the G2 MSM as for bn254 at 2^16 and 2^20; KZG as for bn254,
  bls12-381 at 4096 (a blob) and bls12-377 at 2^20;
* bls24-315 and bls24-317 (10-word Fp, the 10-word instantiations of the
  field, exponent, G1 point and VM kernels; G2 over E4 composed of field
  ops, its products on the 10-word ``mont_mul``): the G1 MSM at 2^12,
  2^16 and 2^20 with ``batch_scalar_mul`` at 2^16; the pairing as for
  bls12 at 2048 pairs, tampered, at batch 2 and against the golden bytes,
  Q_i = [b_i]G2 by the E4 ``scalar_mul`` on the card (b below 2^16: the
  E4 ladder costs ~0.15 s a bit; sampled lanes, b = 2, 3, 2^16 - 1, 1 and
  7 among them, against a Python-int Fp4 ladder); KZG as for bn254 (alpha
  below 2^16, for the same ladder), bls24-315
  (the inner curve of gnark's 2-chain with bw6-633) at 2^20 and bls24-317
  at 2^16;
* bw6-761 and bw6-633 (24- and 20-word Fp, the 24- and 20-word
  instantiations of the field, exponent, G1 point and VM kernels; G2 is a
  curve over Fp, on the same kernels; GT is E6): the G1 MSM at 2^12, 2^16
  and 2^20 with ``batch_scalar_mul`` at 2^16, and the bw6-761 G2 MSM at
  2^12 and 2^16 (a Groth16 prover's [B]_2), as for bn254's G1; the
  pairing as for bls24 at 2048 pairs, tampered, at batch 2 and against
  the golden bytes, Q_i = [b_i]G2 by the G2 ``scalar_mul`` (sampled
  lanes, b = 2, 3, r - 1, 1 and 7 among them, against a Python-int
  ladder), with ``gt_exp`` and ``gt_is_in_subgroup`` on the golden
  element; KZG as for bn254, bw6-761 at 2^20 and bw6-633 at 2^16 (the Fr
  products on the 12- and 10-word ``mont_mul``);
* the bw6 Fr NTT on the NTT kernels at 12 words (bw6-761 Fr) and 10 words
  (bw6-633 Fr), in the forms of the bn254 NTT path: every (decimation,
  direction, coset) form and three round trips at 2^20 (bw6-761) and 2^16
  (bw6-633), four-step DIF forward and DIT inverse at 2^24 (bw6-761) and
  2^20 (bw6-633's largest domain);
* the IOP toolkit (``protocols.iop``, ``permutation``, ``pedersen``,
  ``multilin``): on bw6-761 at 2^20 ``to_lagrange_batch`` of 4
  polynomials, ``evaluate_expression``, ``divide_by_x_minus_one`` of a
  2^21 polynomial by X^(2^20) - 1 (q (X^m - 1) == p at a random point on
  host integers) and ``build_ratio_copy_constraint`` over 3 columns; the
  permutation argument (``prove``, ``verify`` True, and False when t2 is
  not a permutation of t1) on bw6-761 at 2^20 and bn254 at 2^20 on their
  KZG paths' SRSs and on bw6-633 at 2^16; Pedersen on bn254 and bw6-761
  over 2^16 bases [i+1]G (``setup`` of two keys over one G2 point,
  ``commit`` and ``prove_knowledge`` against [sum v_i (i+1)]G and its
  sigma multiple, ``verify`` and ``batch_verify_multi_vk`` True and False
  on a negated PoK); ``multilin.evaluate`` of a 2^20 bn254 table against
  Python-int folds.

Phases:

1. each path, with every kernel's launch count set to 0 just before it and
   read just after (the MSM paths' wall time and peak memory per size and
   the KZG calls' wall times are taken here);
2. checks: each kernel against its plain version at the main path's
   shapes (the MSM kernels on the inputs they received in a second MSM at
   the path's second size, ``jac_add`` on its call with the most lanes
   whose operands are both finite, in that MSM or a second
   ``batch_scalar_mul``; that MSM's window fold whole, but on its first 4
   windows on bw6-761 G2, whose width G1 holds whole; the other folds
   whole at 8 words and on their first 4 windows at 10-24 words); each
   transform against the plain radix-2 stages, round trips and
   Python-integer samples; each MSM against msm([k_i]G, s) =
   [sum s_i k_i mod r]G, a 2^8 random-point MSM against a Python-int curve
   oracle, and ``batch_scalar_mul`` lanes against Python integers; each
   pairing against the golden bytes or its expected check; the wave VM
   kernel on the 2048-pair chain's ``product`` launch and on two random
   programs of all six ops, scheduled into waves of 8 and (with a wide
   operand window) 16 rows (for bls24 at 10 words, bls12 at 12 and bw6 at
   20 and 24, with ``mont_mul`` on the widest product of their MSM paths);
   ``gt_exp`` and ``gt_is_in_subgroup`` on bw6's golden GT; the five Fp2
   kernels on the inputs they received in a second 2^16 G2 MSM (the fold
   on its first 4 windows), on each of the three curves; the KZG results
   against alpha-oracle points and their expected verdicts; the four
   small-field kernels (both forms of ``ntt_f31_stage``) on every distinct
   call of the small-field path, each small-field transform against its
   plain stages, round trips and Python-integer samples, and each SIS
   result against the same pipeline on the plain versions; the 12- and
   10-word NTT kernels as the 8-word ones (the plain sub-NTT steps at 2^24
   on quarters of the rows); the toolkit's results against host integers
   and their expected verdicts;
3. timing with CUDA events: each kernel, its plain version and its bound
   (bytes over 3.35 TB/s, or 32-bit multiply-adds over the INT32 rate,
   whichever is larger); whole transforms; the G1 and G2 MSMs at 2^20
   split into their steps (host clock, synchronised after each); each VM
   program launch of the pairing path beside its waves, warps, registers,
   the scheduler's look-ahead window and longest chain of dependent rows;
   pairs/s at 2048 and the batch-2 ``pairing_check`` latency; each G2 MSM
   and KZG call (host clock, synchronised); the small-field transforms'
   elems/s, SIS elems/s and ``hash_many`` columns/s.

Prints the card's name and power limit, the build time, the launches of
every path, the number of checks and the run's seconds, a ``timings`` JSON
line, a ``kernels`` JSON line (a kernel built at several widths has a row
per width, the 10-, 12-, 20- and 24-word ones named with ``_w10``,
``_w12``, ``_w20`` and ``_w24``; their numbers from the bls24-315,
bls12-381, bw6-633 and bw6-761 paths, bls24-317's and bls12-377's in the
timings line; the NTT kernels' 12- and 10-word rows from bw6-761 Fr at
2^20 and bw6-633 Fr at 2^16) and, last, the device line. Exits
non-zero, with no result, without a CUDA card or without the package
beside it.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth; the INT32 rate
# is 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12 multiply-adds/s,
# half the FP32 lane count behind the sheet's 67 TFLOP/s FP32.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9
MADS_PER_MONT_MUL = 136  # 8x8 for a*b, 8x8 for m*q, 8 for m (8-word CIOS)
ELEM_BYTES = 32
SEED = 20261016
# the kernels built at 8 and 12 words; their 12-word instantiations are
# rows of their own, named with W12
W12_KERNELS = ("mont_mul", "exp_const", "jac_add", "jac_double",
               "affine_prep", "affine_finish", "jac_fold_windows",
               "vm_execute", "jac_add2", "jac_double2", "affine_prep2",
               "affine_finish2", "jac_fold_windows2")
W12 = "_w12"
# the kernels built at 10, 20 and 24 words too (not the Fp2 ones: bls24's
# G2 is over Fp4, bw6's over Fp); their 10-word rows are named with W10
W10_KERNELS = ("mont_mul", "exp_const", "jac_add", "jac_double",
               "affine_prep", "affine_finish", "jac_fold_windows",
               "vm_execute")
W10 = "_w10"
# their 20- and 24-word rows (bw6-633 and bw6-761 Fp, G1 and G2)
W20, W24 = "_w20", "_w24"
# the NTT kernels, built at 8, 10 and 12 words (bn254, bw6-633 and bw6-761
# Fr); their 10- and 12-word rows are named with W10 and W12
NTT_KERNELS = ("ntt_radix2_stage", "ntt_radix2_block", "ntt_four_step")
# the kernels that take the 256-bit 8-word fields (secp256k1/r1 Fp and Fr);
# their launches there count under the width key "8full"
# (field/kernels.py width_key) and are rows of their own, named with W8F
FULL_KERNELS = ("mont_mul", "exp_const", "jac_add", "jac_double",
                "affine_prep", "affine_finish", "jac_fold_windows")
W8F = "_w8full"
SUFFIX = {8: "", 10: W10, 12: W12, 20: W20, 24: W24, "8full": W8F}


def mads_per_product(words: int) -> int:
    """32-bit multiply-adds of one W-word CIOS product: W^2 for a*b, W^2
    for m*q, W for m (136 at 8 words, 300 at 12)."""
    return 2 * words * words + words


def exp_design(words: int) -> str:
    """exp_const's design at a width, as csrc/exp.cu fixes it (kTeam,
    kLanes)."""
    team = {8: 1, 10: 4, 12: 4, 20: 4, 24: 4}[words]
    product = "the column product" if team == 1 else "a team product"
    return (f"right to left, T={team} lanes an element ({product}), the "
            "multiplies on warps of their own, 32 lanes a role")


def dbl2_design(words: int, nr: int) -> str:
    """jac_double2's design at (words, u^2), as csrc/point_add2.cu fixes it
    (kDbl2Pair, kThreads)."""
    pair = (words, nr) == (12, -1)
    return (f"Fp2 sqr in 2 base products, "
            f"{'a pair of threads' if pair else 'one thread'} a point, "
            "column product, 128 threads a block")


FAILURES: list[str] = []
CHECKS: list[str] = []


def chain_products(e: int) -> int:
    """The fewest products that any addition chain for x^e takes, by
    Schoenhage's lower bound l(e) >= log2(e) + log2(v(e)) - 2.13, v(e) the
    set bits (and l(e) >= log2(e)): exp_const's operations bound. A
    secp256k1 q - 2 gives 262, its known chain 270, the kernel's own
    right-to-left ladder 503."""
    import math

    return max(math.ceil(math.log2(e)), math.ceil(
        math.log2(e) + math.log2(bin(e).count("1")) - 2.13))


def check(ok: bool, what: str) -> None:
    print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
    CHECKS.append(what)
    if not ok:
        FAILURES.append(what)


def bound(nbytes: float, mads: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mads / INT32_MAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oracle_add(P, Q, p: int, a: int):
    """Affine short-Weierstrass addition with Python ints; None = infinity."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def oracle_mul(P, k: int, p: int, a: int):
    """[k]P with Python ints (k >= 0; None = infinity): MSB-first
    double-and-add in Jacobian coordinates, one inversion at the end (an
    inversion a step made the 761-bit oracles take seconds)."""
    if P is None or k == 0:
        return None
    x2, y2 = P
    acc = None   # (X, Y, Z), x = X / Z^2, y = Y / Z^3
    for bit in bin(k)[2:]:
        if acc is not None:
            X, Y, Z = acc
            if Y == 0:
                acc = None
            else:
                xx, yy, zz = X * X % p, Y * Y % p, Z * Z % p
                s = 4 * X * yy % p
                m = (3 * xx + a * zz * zz) % p
                X3 = (m * m - 2 * s) % p
                acc = (X3, (m * (s - X3) - 8 * yy * yy) % p, 2 * Y * Z % p)
        if bit == "1":
            if acc is None:
                acc = (x2, y2, 1)
                continue
            X, Y, Z = acc
            zz = Z * Z % p
            h = (x2 * zz - X) % p
            r = (y2 * zz * Z - Y) % p
            if h == 0:
                # P itself (double it) or -P (infinity)
                acc = None if r else oracle_add((x2, y2), (x2, y2), p, a)
                if acc is not None:
                    acc = (*acc, 1)
                continue
            hh = h * h % p
            hhh = h * hh % p
            v = X * hh % p
            X3 = (r * r - hhh - 2 * v) % p
            acc = (X3, (r * (v - X3) - Y * hhh) % p, Z * h % p)
    if acc is None:
        return None
    X, Y, Z = acc
    zi = pow(Z, -1, p)
    zi2 = zi * zi % p
    return X * zi2 % p, Y * zi2 * zi % p


def random_scalars(nprng, spec, n: int, dev):
    """n canonical plain Fr words of a curve spec (top word below r's, so
    < r), from the numpy generator."""
    import numpy as np
    import torch

    w = nprng.integers(0, 1 << 32, size=(n, spec.fr.n_words), dtype=np.uint32)
    w[:, -1] %= spec.fr.q_words[-1]
    return torch.from_numpy(w.view(np.int32)).to(dev)


def weighted_total(s_words, base_n: int, r: int) -> int:
    """sum_i s_i * ((i mod base_n) + 1) mod r, exactly, on the card: 16-bit
    halves times k <= 2^16 summed over <= 2^24 lanes < 2^56."""
    import torch

    n = s_words.shape[0]
    u = s_words.to(torch.int64) & 0xFFFFFFFF
    halves = torch.stack([u & 0xFFFF, u >> 16], -1).reshape(n, -1)
    k = torch.arange(n, device=s_words.device) % base_n + 1
    sums = (halves * k[:, None]).sum(0).tolist()
    return sum(v << (16 * j) for j, v in enumerate(sums)) % r


def width(args) -> int:
    """The first dimension of a wrapper call's first tensor argument."""
    return next(a.shape[0] for a in args if hasattr(a, "shape"))


def plain_on_host(fn, args):
    """fn(*args) on CPU copies of the tensor arguments, its tensor outputs
    moved back to the arguments' device: a 1-lane plain fold there runs its
    products on Python integers (``field/kernels.py`` ``SMALL_BATCH``),
    seconds faster than its CIOS on the card."""
    import torch

    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    outs = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                for a in args))
    return tuple(o.to(dev) for o in outs)


def finite_pairs(args) -> int:
    """Lanes of a ``jac_add`` call whose operands are both finite (Z != 0):
    the lanes that run the add's formula, not its early return."""
    import torch

    z1, z2 = args[4], args[7]
    return int((torch.any(z1 != 0, -1) & torch.any(z2 != 0, -1)).sum())


class Recorder:
    """Stands in for a kernel wrapper in its module: calls it and, while
    ``on``, keeps the arguments of the call of the highest ``score`` (by
    default the widest: the first dimension of the first tensor argument),
    or of every call with ``keep_all``; with ``words``, only of calls on a
    field of that width key (the wrapper's first argument, a field spec:
    ``kernels.width_key``, its words or "8full")."""

    def __init__(self, module, name: str, keep_all: bool = False,
                 words: int | None = None, score=width):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.keep_all, self.on, self.words = keep_all, False, words
        self.score = score
        self.args, self.calls = None, []

    def __call__(self, *args):
        from gnark_crypto_tpu_torch.field.kernels import width_key

        if self.on and (self.words is None
                        or width_key(args[0]) == self.words):
            if self.keep_all:
                self.calls.append(args)
            else:
                n = self.score(args)
                if self.args is None or n > self.best:
                    self.args, self.best = args, n
        return self.fn(*args)

    @property
    def launches(self) -> int:
        """The wrapped wrapper's count: a wrapper counts its launches
        through its module-level name, which is this object while it is
        installed."""
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value

    @property
    def launches_by_width(self) -> dict:
        return self.fn.launches_by_width

    def install(self):
        setattr(self.module, self.name, self)

    def remove(self):
        setattr(self.module, self.name, self.fn)


class MsmSlice:
    """A G1 MSM path: inputs, main path, checks and timings. bn254 (8
    words) with a stark_g1 MSM beside it (a != 0), or a curve of another
    width (bls24: 10-word Fp, bls12: 12, bw6: 20 and 24, secp256k1/r1: the
    256-bit 8-word Fp), whose kernel rows are the instantiations at that
    width (``W10``, ``W12``, ``W20``, ``W24``, ``W8F``) and which also
    records and checks ``mont_mul``."""

    KERNELS = ("exp_const", "jac_add", "jac_double", "affine_prep",
               "affine_finish", "jac_fold_windows")
    FOLD_WINDOWS = 4   # windows of the other folds' check at 10-24 words

    def __init__(self, dev, nprng, base_log: int = 16,
                 sizes=(16, 20, 24), stark_log: int | None = 12,
                 name: str = "bn254_g1", whole_fold: bool = True):
        import torch

        from gnark_crypto_tpu_torch.curve.jacobian import curve_ops
        from gnark_crypto_tpu_torch.field import exp as field_exp
        from gnark_crypto_tpu_torch.field import kernels, mont, point_add
        from gnark_crypto_tpu_torch.msm import pippenger
        from gnark_crypto_tpu_torch.specs import curve as cs

        self.torch, self.dev, self.nprng = torch, dev, nprng
        self.pp, self.point_add, self.field_exp = pippenger, point_add, \
            field_exp
        self.spec = cs.get_curve(name)
        self.curve = curve_ops(self.spec)
        self.W = self.spec.fp.n_words
        self.key = kernels.width_key(self.spec.fp)
        self.suffix = SUFFIX[self.key]
        self.tag = f"{self.spec.name} " if self.suffix else ""
        self.stark = cs.get_curve("stark_g1") if stark_log else None
        kernel_names = self.KERNELS + (("mont_mul",) if self.suffix else ())
        self.kernels = tuple(self.kname(k) for k in kernel_names)
        self.wrappers = {"exp_const": field_exp.exp_const,
                         **{k: getattr(point_add, k) for k in self.KERNELS
                            if k != "exp_const"}}
        self.recorders = [Recorder(field_exp, "exp_const", words=self.key),
                          Recorder(point_add, "jac_fold_windows",
                                   keep_all=True)]
        self.recorders += [Recorder(point_add, k, words=self.key) for k in
                           ("affine_prep", "affine_finish")]
        self.recorders.append(Recorder(point_add, "jac_add", words=self.key,
                                       score=finite_pairs))
        self.plain = {"exp_const": field_exp.exp_const_plain,
                      **{k: getattr(point_add, f"{k}_plain")
                         for k in self.KERNELS if k != "exp_const"}}
        if self.suffix:
            # mont.mul reaches the kernel through its own module's name
            self.wrappers["mont_mul"] = kernels.mont_mul
            self.plain["mont_mul"] = kernels.mont_mul_plain
            self.recorders.append(Recorder(mont, "mont_mul", words=self.key))
        self.rec = {r.name: r for r in self.recorders}
        self.results, self.wall, self.peak = {}, {}, {}
        # points [i+1]G, i < 2^base_log, tiled to 2^k for k in sizes; the
        # kernels are checked and timed on a second MSM at sizes[1]
        self.base_log, self.sizes, self.stark_log = base_log, sizes, \
            stark_log
        # the second MSM's fold held whole against the plain fold, or (a
        # second path at a width already held whole) on its first windows
        self.whole_fold = whole_fold

    def kname(self, name: str) -> str:
        """The kernel row of ``name`` at this path's width."""
        return name + self.suffix

    def fold_prefix(self, args):
        """A recorded fold's arguments cut to its first FOLD_WINDOWS
        windows: the plain fold of a whole 2^12-2^20 MSM at 10-24 words is
        2,000-3,400 serial plain products, 10-33 s on the card."""
        spec, a, x, y, z, c = args
        w = self.FOLD_WINDOWS
        return (spec, a, x[:w].contiguous(), y[:w].contiguous(),
                z[:w].contiguous(), c)

    # -- inputs --------------------------------------------------------------
    def multiples(self, spec, n: int):
        """[i+1]G for i < n by the ladder of the port's API, as affine."""
        from gnark_crypto_tpu_torch.curve.jacobian import Jac, curve_ops

        curve = curve_ops(spec)
        g = curve.generator_jac(device=self.dev)
        G = Jac(*(c.expand(n, -1) for c in g))
        ks = curve.fr.from_int(list(range(1, n + 1)), mont=False,
                               device=self.dev)
        return curve.to_affine(curve.scalar_mul(G, ks,
                                                nbits=n.bit_length()))

    # -- phase 1 -------------------------------------------------------------
    def main_path(self):
        """Builds the inputs and runs every MSM; returns the seconds."""
        torch, pp = self.torch, self.pp
        from gnark_crypto_tpu_torch.curve.jacobian import Affine

        for r in self.recorders:
            r.install()
        self.rec["jac_fold_windows"].on = True
        if "mont_mul" in self.rec:
            self.rec["mont_mul"].on = True
        t0 = time.perf_counter()
        p16 = self.multiples(self.spec, 1 << self.base_log)
        self.p16 = p16
        self.s24 = random_scalars(self.nprng, self.spec,
                                  1 << self.sizes[-1], self.dev)
        for k in self.sizes:
            pts = self.tiled(k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            self.results[k] = pp.msm(self.spec, pts, self.s24[:1 << k])
            torch.cuda.synchronize()
            self.wall[k] = time.perf_counter() - t1
            self.peak[k] = torch.cuda.max_memory_allocated()
            del pts
        self.bsm = pp.batch_scalar_mul(
            self.spec, Affine(p16.x[0], p16.y[0]),
            self.s24[:1 << self.base_log])
        if self.stark is not None:
            self.stark_pts = self.multiples(self.stark, 1 << self.stark_log)
            self.stark_s = random_scalars(self.nprng, self.stark,
                                          1 << self.stark_log, self.dev)
            self.results["stark"] = pp.msm(self.stark, self.stark_pts,
                                           self.stark_s)
        torch.cuda.synchronize()
        self.rec["jac_fold_windows"].on = False
        if "mont_mul" in self.rec:
            self.rec["mont_mul"].on = False
        # out of the way of the other paths; checks() installs them again
        for r in self.recorders:
            r.remove()
        return time.perf_counter() - t0

    # -- phase 2 -------------------------------------------------------------
    def affine_ints(self, curve, pt):
        from gnark_crypto_tpu_torch.curve.jacobian import Jac
        from gnark_crypto_tpu_torch.field import mont

        aff = curve.to_affine(Jac(*(c.reshape(-1, c.shape[-1])
                                    for c in pt)))
        xs, ys = (mont.to_int(curve.spec.fp, c) for c in aff)
        return [None if x == 0 and y == 0 else (x, y)
                for x, y in zip(xs, ys)]

    def checks(self, compare, check):
        """Every MSM against the identity and the oracles, then each kernel
        against its plain version on the inputs of a second 2^20 MSM."""
        from gnark_crypto_tpu_torch.curve.jacobian import Affine, curve_ops
        from gnark_crypto_tpu_torch.field import mont

        torch, pp, pa = self.torch, self.pp, self.point_add
        for spec, key, scal, base_n in (
                [(self.spec, k, self.s24[:1 << k], 1 << self.base_log)
                 for k in self.sizes]
                + ([(self.stark, "stark", self.stark_s,
                     1 << self.stark_log)] if self.stark else [])):
            p, a = spec.fp.modulus, spec.a % spec.fp.modulus
            total = weighted_total(scal, base_n, spec.fr.modulus)
            want = oracle_mul((spec.gx % p, spec.gy % p), total, p, a)
            got = self.affine_ints(curve_ops(spec), self.results[key])
            tag = (f"{spec.name} 2^{key}" if key != "stark"
                   else f"{spec.name} 2^{self.stark_log}")
            check(got == [want], f"msm {tag} == [sum s_i k_i]G (identity)")
        name = self.spec.name

        # 2^8 random points against the Python-int oracle
        rng = random.Random(SEED + 8)
        p, r = self.spec.fp.modulus, self.spec.fr.modulus
        a_p = self.spec.a % p
        g = (self.spec.gx, self.spec.gy)
        pts = [oracle_mul(g, rng.randrange(1, 1 << 64), p, a_p)
               for _ in range(256)]
        ks = [rng.randrange(r) for _ in range(256)]
        want = None
        for pt, k in zip(pts, ks):
            want = oracle_add(want, oracle_mul(pt, k, p, a_p), p, a_p)
        f = self.curve.fp
        P = Affine(f.from_int([t[0] for t in pts], device=self.dev),
                   f.from_int([t[1] for t in pts], device=self.dev))
        got = pp.msm(self.spec, P, self.curve.fr.from_int(
            ks, mont=False, device=self.dev))
        check(self.affine_ints(self.curve, got) == [want],
              f"msm {name} 2^8 random points == Python-int oracle")

        # batch_scalar_mul at sampled lanes
        nb = 1 << self.base_log
        lanes = [0, 1, nb - 1] + rng.sample(range(2, nb - 1), 5)
        kk = mont.to_int(self.spec.fr, self.s24[lanes], mont=False)
        got = self.affine_ints(self.curve, type(self.bsm)(
            *(c[lanes] for c in self.bsm)))
        check(got == [oracle_mul(g, k, p, a_p) for k in kk],
              f"batch_scalar_mul {name} 2^{self.base_log}: 8 sampled lanes"
              " == Python ints")

        # the kernels on the inputs of a second 2^20 MSM
        for r_ in self.recorders:
            r_.install()
        for k in ("exp_const", "jac_add", "affine_prep", "affine_finish"):
            self.rec[k].on = True
        k20 = self.sizes[1]
        again = pp.msm(self.spec, self.tiled(k20), self.s24[:1 << k20])
        # jac_add also on the ladder's adds, whose lanes are mostly finite
        # (a wide MSM's phase-2 adds are mostly at infinity at 20-24 words)
        for k in ("exp_const", "affine_prep", "affine_finish"):
            self.rec[k].on = False
        bsm = pp.batch_scalar_mul(
            self.spec, Affine(self.p16.x[0], self.p16.y[0]),
            self.s24[:1 << self.base_log])
        for r_ in self.recorders:
            r_.on = False
            r_.remove()
        check(all(torch.equal(u, v)
                  for u, v in zip(again, self.results[k20])),
              f"msm {name} 2^{k20} run twice: the same Jacobian coordinates")
        check(all(torch.equal(u, v) for u, v in zip(bsm, self.bsm)),
              f"batch_scalar_mul {name} 2^{self.base_log} run twice: the "
              "same Jacobian coordinates")
        recorded = ("exp_const", "jac_add", "affine_prep", "affine_finish")
        if "mont_mul" in self.rec:
            recorded += ("mont_mul",)
        self.kargs = {k: self.rec[k].args for k in recorded}
        self.kargs["jac_double"] = (self.spec.fp, self.spec.a,
                                    *self.curve.from_affine(self.p16))
        folds = self.rec["jac_fold_windows"].calls
        # one fold per MSM chunk: 2^16, 2^20, four chunks of 2^24, stark
        # (bn254); 2^12, 2^16, 2^20 (bls12, bls24, bw6 G1); 2^12, 2^16 (bw6
        # G2). Each is timed whole; the second MSM's fold is the kernel row
        # and is held whole against the plain fold (but with whole_fold
        # off), the others too at 8 words and on their first windows at
        # 10-24 words
        self.fold_args = {f"2^{k}": folds[i]
                          for i, k in enumerate(self.sizes)}
        if self.stark is not None:
            self.fold_args[f"stark 2^{self.stark_log}"] = folds[-1]
        self.kargs["jac_fold_windows"] = (
            folds[1] if self.whole_fold else self.fold_prefix(folds[1]))
        plain = self.plain
        self.plain_ms = {}
        for k, args in self.kargs.items():
            outs = self.wrappers[k](*args)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            wants = plain[k](*args)
            self.torch.cuda.synchronize()
            self.plain_ms[k] = (time.perf_counter() - t0) * 1e3
            if k in ("exp_const", "mont_mul"):
                outs, wants = (outs,), (wants,)
            for i, (o, w) in enumerate(zip(outs, wants)):
                compare(self.kname(k), o, w,
                        f"{self.tag}{width(args)} lanes, output {i}")
        for tag, args in self.fold_args.items():
            if args is not folds[1]:
                what = f"{self.tag}{tag} fold"
                if self.W != 8:
                    args = self.fold_prefix(args)
                    what += f", first {self.FOLD_WINDOWS} windows"
                for i, (o, w) in enumerate(zip(
                        pa.jac_fold_windows(*args),
                        plain_on_host(pa.jac_fold_windows_plain, args))):
                    compare(self.kname("jac_fold_windows"), o, w,
                            f"{what}, output {i}")
        if self.stark is None:
            return
        stark_dbl = (self.stark.fp, self.stark.a,
                     *curve_ops(self.stark).from_affine(self.stark_pts))
        for i, (o, w) in enumerate(zip(pa.jac_double(*stark_dbl),
                                       pa.jac_double_plain(*stark_dbl))):
            compare("jac_double", o, w,
                    f"stark_g1 2^{self.stark_log} lanes, output {i}")

    # -- phase 3 -------------------------------------------------------------
    def bounds(self):
        """(bytes, multiply-adds) each kernel's recorded call must move and
        do on its data: mask bits tell which lanes do which products."""
        torch, pa = self.torch, self.point_add
        mm = mads_per_product(self.W)
        ELEM_BYTES = 4 * self.W
        out = {}
        if "mont_mul" in self.kargs:
            _, x, _ = self.kargs["mont_mul"]
            out["mont_mul"] = (3 * ELEM_BYTES * x.shape[0], mm * x.shape[0])
        spec, a, *pts = self.kargs["affine_prep"]
        n = pts[0].shape[0]
        _, _, bits = pa.affine_prep(spec, a, *pts)
        out["affine_prep"] = (n * (4 * ELEM_BYTES + 2 * ELEM_BYTES + 4),
                              mm * int(((bits & pa.MB_DBL) != 0).sum()))
        fargs = self.kargs["affine_finish"]
        mb, tb = fargs[12], fargs[13]
        eq = (tb & 1) != 0
        generic = eq & ((mb & (pa.MB_INFOUT | pa.MB_PINF | pa.MB_QINF)) == 0)
        n = fargs[2].shape[0]
        # always l_suf and the tree bits in, seven outputs out; r_pre, num,
        # 1/den and the mask bits only where the runs meet (eq); l_pre and
        # r_suf only where the sum does not replace them
        keep_pre = n - int((eq & ((tb & 2) != 0)).sum())
        keep_suf = n - int((eq & ((tb & 4) != 0)).sum())
        out["affine_finish"] = (
            n * (2 * ELEM_BYTES + 4 + 7 * ELEM_BYTES)
            + int(eq.sum()) * (4 * ELEM_BYTES + 4)
            + (keep_pre + keep_suf) * 2 * ELEM_BYTES,
            3 * mm * int(generic.sum()))
        self.finite_lanes = finite_pairs(self.kargs["jac_add"])
        out["jac_add"] = (width(self.kargs["jac_add"]) * 9 * ELEM_BYTES,
                          16 * mm * self.finite_lanes)
        spec, a, *c = self.kargs["jac_double"]
        out["jac_double"] = (c[0].shape[0] * 6 * ELEM_BYTES,
                             (7 if a == 0 else 10) * mm * c[0].shape[0])
        spec, x, e = self.kargs["exp_const"]
        # the kernel's right-to-left chain is its squares, nbits - 1 of
        # them, with popcount - 1 multiplies trailing; the bound counts the
        # least chain any method could take
        self.exp_serial = e.bit_length() - 1
        out["exp_const"] = (x.shape[0] * 2 * ELEM_BYTES,
                            mm * chain_products(e) * x.shape[0])
        for tag, (spec, a, fx, fy, fz, c_) in self.fold_args.items():
            nwin = fx.shape[0]
            serial = c_ * (nwin - 1) * 7 + (nwin - 1) * 16
            out[f"jac_fold_windows {tag}"] = (
                (3 * nwin + 3) * ELEM_BYTES, mm * serial, serial)
        return out

    def timings(self, cuda_ms, timings, kernel_rows):
        torch, pp = self.torch, self.pp
        for name, (nbytes, mads, *serial) in self.bounds().items():
            # a whole fold's tag (its MSM's size) after the kernel's name
            kname, _, tag = name.partition(" ")
            args = self.fold_args[tag] if tag else self.kargs[kname]
            b_ms, b_by = bound(nbytes, mads)
            row = {"ms": cuda_ms(lambda: self.wrappers[kname](*args),
                                 reps=5),
                   "bound_ms": b_ms, "bound_by": b_by, "lanes": width(args)}
            recorded = args is self.kargs[kname]
            if recorded:
                # the plain version's time from its run in checks() on
                # these inputs (host clock, synchronised)
                row["plain_ms"] = self.plain_ms[kname]
            if kname == "exp_const":
                row["serial_products"] = self.exp_serial
                row["us_per_serial_product"] = (row["ms"] * 1e3
                                                / self.exp_serial)
                row["design"] = exp_design(self.W)
            if kname == "jac_add":
                row["finite_lanes"] = self.finite_lanes
            if serial:
                row["serial_products"] = serial[0]
            timings[self.tag + (f"{name} fold" if tag else (
                f"{name} {width(args)} lanes"))] = row
            if recorded:
                kernel_rows[self.kname(kname)] = row
        curve = self.spec.name.removesuffix("_g1")
        for k in self.sizes:
            # the main path's run was the first at its size; time it again
            pts = self.tiled(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pp.msm(self.spec, pts, self.s24[:1 << k])
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            timings[f"msm {curve} 2^{k}"] = {
                "s": warm, "points_per_s": (1 << k) / warm,
                "s_main_path": self.wall[k], "peak_bytes": self.peak[k]}
            del pts
        k20 = self.sizes[1]
        timings[f"{self.tag}msm 2^{k20} steps"] = msm_steps(
            pp, lambda: pp.msm(self.spec, self.tiled(k20),
                               self.s24[:1 << k20]))

    def tiled(self, k: int):
        from gnark_crypto_tpu_torch.curve.jacobian import Affine

        if k <= self.base_log:
            return Affine(self.p16.x[:1 << k], self.p16.y[:1 << k])
        reps = 1 << (k - self.base_log)
        return Affine(self.p16.x.repeat(reps, 1), self.p16.y.repeat(reps, 1))


def msm_steps(pp, run):
    """One MSM by ``run()`` with each step synchronised and timed on the
    host clock: seconds per step, the rest as "other"."""
    import torch

    steps = {"digits": "signed_digits", "sort and gather": "_sorted_lanes",
             "phase 1 (affine levels)": "_affine_levels",
             "bucket rebuild": "_emitted_to_buckets",
             "phase 2 (jacobian levels)": "_jacobian_levels",
             "sweep": "_weighted_sweep", "fold": "_fold_windows"}
    spent = {k: 0.0 for k in steps}
    saved = {}

    def timed(label, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t
            return out
        return call

    for label, attr in steps.items():
        saved[attr] = getattr(pp, attr)
        setattr(pp, attr, timed(label, saved[attr]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(pp, attr, fn)
    total = time.perf_counter() - t0
    spent["other"] = total - sum(spent.values())
    spent["total"] = total
    return spent


class PairingSlice:
    """The bn254 pairing path: inputs, main path, checks and timings."""

    KERNELS = ("vm_execute", "mont_mul", "exp_const", "jac_add",
               "jac_double", "jac_add2", "jac_double2")
    NAME = "bn254"
    SUFFIX = ""    # kernel rows of the 8-word instantiations
    # gnark GT bytes of e(G1, G2) and e([5]G1, [7]G2), from the independent
    # oracle tests/gt_oracle.py
    GOLDEN = Path(__file__).resolve().parent / "tests/fixtures/gt_golden.json"

    def __init__(self, dev, nprng, n: int = 2048):
        import torch

        from gnark_crypto_tpu_torch.curve.g2 import g2_curve
        from gnark_crypto_tpu_torch.curve.jacobian import curve_ops
        from gnark_crypto_tpu_torch.field import vm
        from gnark_crypto_tpu_torch.pairing import api, vm_pairing
        from gnark_crypto_tpu_torch.specs import curve as cs

        self.torch, self.dev, self.nprng, self.n = torch, dev, nprng, n
        self.vm, self.api, self.vp = vm, api, vm_pairing
        self.spec = cs.get_curve(f"{self.NAME}_g1")
        self.g1 = curve_ops(self.spec)
        self.g2 = g2_curve(self.NAME, dev)
        self.r = self.spec.fr.modulus
        self.rec = Recorder(vm, "vm_execute", keep_all=True)
        with open(self.GOLDEN) as f:
            self.golden = json.load(f)[self.NAME]
        self.kernels = tuple(k + self.SUFFIX for k in self.KERNELS)
        self.tag = f"{self.NAME} " if self.SUFFIX else ""

    G2_BOUND = None   # the G2 scalars are below this bound, or below r

    def g2_scalars(self, rng, n: int) -> list[int]:
        """The G2 scalars b_i of n pairs."""
        return [rng.randrange(1, self.G2_BOUND or self.r) for _ in range(n)]

    G2_BY = "scalar_mul"

    # -- inputs --------------------------------------------------------------
    def g1_mul(self, ks):
        """[k]G1 for Python-int k (mod r) by the ported batch_scalar_mul;
        affine, k = 0 gives infinity."""
        from gnark_crypto_tpu_torch.msm import pippenger as pp

        s = self.g1.fr.from_int([k % self.r for k in ks], mont=False,
                                device=self.dev)
        g = self.g1.generator_affine(device=self.dev)
        return self.g1.to_affine(pp.batch_scalar_mul(self.spec, g, s))

    def g2_mul(self, ks):
        """[k]G2 for Python-int k by the G2 curve's scalar_mul; affine."""
        g2 = self.g2
        Q = g2.generator_jac(device=self.dev)
        s = g2.fr.from_int([k % self.r for k in ks], mont=False,
                           device=self.dev)
        n = len(ks)
        # the ladder over the longest scalar's bits
        nbits = max(k % self.r for k in ks).bit_length()
        return g2.to_affine(g2.scalar_mul(
            type(Q)(*(c.expand(n, *c.shape) for c in Q)), s, nbits=nbits))

    def gt_hex(self, z) -> str:
        from gnark_crypto_tpu_torch.io import gt_bytes

        return gt_bytes.gt_to_bytes(self.NAME, z)[0].hex()

    # -- phase 1 -------------------------------------------------------------
    def main_path(self):
        """Inputs, then every pairing of the path; returns the seconds."""
        torch, api, name = self.torch, self.api, self.NAME
        from gnark_crypto_tpu_torch.curve.jacobian import Affine

        self.rec.install()
        self.rec.on = True
        t0 = time.perf_counter()
        rng = random.Random(SEED + 4)
        n = self.n
        # lane 0: infinite P; the last lane cancels the rest
        a = [0] + [rng.randrange(1, self.r) for _ in range(n - 2)]
        b = self.g2_scalars(rng, n - 1)
        a.append(-sum(x * y for x, y in zip(a, b)) % self.r)
        b.append(1)
        # then the batch-2 KZG-verify shape and the golden pairs: one ladder
        # for every G1 input and one for every G2 input
        ka = rng.randrange(1, self.r)
        kb = rng.randrange(1, self.G2_BOUND or self.r)
        self.b = b + [kb, 1, 1, 7]
        P_all = self.g1_mul(a + [ka, -ka * kb, 1, 5])
        Q_all = self.g2_mul(self.b)
        torch.cuda.synchronize()
        self.inputs_s = time.perf_counter() - t0

        def rows(pt, i, j):
            return type(pt)(*(c[i:j] for c in pt))

        self.Q_all = Q_all
        self.P, self.Q = rows(P_all, 0, n), rows(Q_all, 0, n)
        P2, Q2 = rows(P_all, n, n + 2), rows(Q_all, n, n + 2)
        self.gt = {key: api.pair(name, rows(P_all, i, i + 1),
                                 *rows(Q_all, i, i + 1))
                   for key, i in (("generator", n + 2), ("p5_q7", n + 3))}
        self.check_big = api.pairing_check(name, self.P, *self.Q)
        tampered = self.g1_mul([a[1] + 1])
        Pt = Affine(*(torch.cat([c[:1], t, c[2:]])
                      for c, t in zip(self.P, tampered)))
        self.check_tampered = api.pairing_check(name, Pt, *self.Q)
        self.P2, self.Q2 = P2, Q2
        self.check_kzg = api.pairing_check(name, P2, *Q2)
        torch.cuda.synchronize()
        self.rec.on = False
        self.rec.remove()
        self.calls = self.rec.calls
        return time.perf_counter() - t0

    # -- phase 2 -------------------------------------------------------------
    def checks(self, compare, check):
        import numpy as np

        vm, vp = self.vm, self.vp
        name, vm_row = self.NAME, "vm_execute" + self.SUFFIX
        for key, z in self.gt.items():
            check(self.gt_hex(z) == self.golden[key],
                  f"pair {name} {key} on the card == golden gnark GT bytes")
        check(bool(self.check_big), f"pairing_check {name} over {self.n} "
              "pairs (lane 0 infinite, last lane -sum a_i b_i G1) is True")
        check(not bool(self.check_tampered),
              f"pairing_check {name} over {self.n} pairs, one scalar "
              "changed, is False")
        check(bool(self.check_kzg), f"pairing_check {name} at batch 2 "
              "(aG1, bG2), (-abG1, G2) is True")
        variants = ("full", "full", "miller", "product", "reduce", "miller",
                    "product", "reduce", "full")
        progs = [prog.n_instrs for prog, _ in self.calls]
        check(len(self.calls) == len(variants) and all(
            prog is vp.program(name, v)
            for (prog, _), v in zip(self.calls, variants)),
            f"vm_execute {name} programs on the path, scheduled into waves: "
            f"{progs}")
        # the kernel against its plain version: the product fold of the
        # 2048-pair chain, and random programs of all six ops, scheduled:
        # one as the earlier slices had it, one with a wide operand window
        # that fills waves of 16 rows
        prod = next(c for c in self.calls
                    if c[0] is vp.program(name, "product"))
        compare(vm_row, vm.vm_execute(*prod), vm.vm_execute_plain(*prod),
                f"{self.tag}product program, {prod[1].shape[1]} lanes")
        for seed, window, warps in ((SEED, 12, 8), (SEED + 1, 64, 16)):
            rand = vm.schedule(vm.random_program(
                self.spec.fp, 2900, seed=seed, window=window), warps)
            n_pad = 4 * rand.tile
            state = vm._entry_consts(rand, str(self.dev))[:, None, :].repeat(
                1, n_pad, 1)
            vals = self.nprng.integers(0, 1 << 32, size=(len(
                rand.entry_inputs), n_pad, self.spec.fp.n_words),
                dtype=np.uint32)
            vals[..., -1] %= self.spec.fp.q_words[-1]
            edges = self.g1.fp.from_int([0, 1, self.spec.fp.modulus - 1],
                                        device=self.dev)
            for i, (reg, _) in enumerate(rand.entry_inputs):
                state[reg] = self.torch.from_numpy(vals[i].view(np.int32)
                                                   ).to(self.dev)
                state[reg, :3] = edges
            compare(vm_row, vm.vm_execute(rand, state),
                    vm.vm_execute_plain(rand, state),
                    f"{self.tag}random program, operand window {window}: "
                    f"{rand.n_waves} waves of {warps} rows, K = "
                    f"{rand.n_regs}, {rand.op_counts()}, {n_pad} lanes")

    # -- phase 3 -------------------------------------------------------------
    def timings(self, cuda_ms, timings, kernel_rows):
        import numpy as np

        torch, api, vm, vp = self.torch, self.api, self.vm, self.vp
        name = self.NAME
        W = self.spec.fp.n_words
        mm = mads_per_product(W)
        labels = {vp.program(name, v): v for v in
                  ("full", "miller", "product", "reduce")}
        seen = set()
        for prog, state in self.calls:
            variant = labels[prog]
            lanes = state.shape[1]
            if (variant, lanes) in seen:
                continue
            seen.add((variant, lanes))
            n_mul = prog.op_counts()["MUL"]
            nbytes = (state.numel() * 4 + prog.n_instrs * 16
                      + len(prog.out_regs) * (4 + lanes * 4 * W))
            b_ms, b_by = bound(nbytes, mm * n_mul * lanes)
            chain, chain_mul = vm.critical_path(prog)
            ms = cuda_ms(lambda: vm.vm_execute(prog, state), reps=2,
                         rounds=3)
            row = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                   "products": n_mul,
                   "rows": prog.n_instrs - prog.op_counts()["NOP"],
                   "waves": prog.n_waves, "warps": prog.warps,
                   "window": prog.window,
                   "us_per_wave": ms * 1e3 / prog.n_waves,
                   "longest_chain": chain, "longest_chain_products": chain_mul,
                   "registers": prog.n_regs, "lanes": lanes,
                   "blocks": lanes // prog.tile}
            if variant == "product":
                row["plain_ms"] = cuda_ms(
                    lambda: vm.vm_execute_plain(prog, state), reps=1,
                    rounds=1)
                kernel_rows["vm_execute" + self.SUFFIX] = row
            timings[f"{self.tag}vm_execute {variant} {lanes} lanes"] = row

        def host_s(fn, rounds=3):
            fn()
            torch.cuda.synchronize()
            per = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                per.append(time.perf_counter() - t0)
            return float(np.median(per))

        before = vm.vm_execute.launches
        api.pair(name, self.P, *self.Q)
        launches = vm.vm_execute.launches - before
        s = host_s(lambda: api.pair(name, self.P, *self.Q))
        timings[f"pair {name} {self.n}"] = {
            "s": s, "pairs_per_s": self.n / s,
            "vm_launches_per_pair": launches}
        s2 = host_s(lambda: bool(api.pairing_check(name, self.P2, *self.Q2)),
                    rounds=5)
        timings[f"pairing_check {name} batch 2"] = {"s": s2}
        timings[f"{self.tag}pairing inputs (G1 batch_scalar_mul, G2 "
                f"{self.G2_BY}, {self.n} lanes)"] = {"s": self.inputs_s}


def fp2_oracle_add(P, Q, p: int, nr: int):
    """Affine addition on a G2 twist (a = 0) over Fp2 = Fp[u]/(u^2 - nr),
    with Python ints; an element is (re, im), None is infinity."""
    def mul(x, y):
        return ((x[0] * y[0] + nr * x[1] * y[1]) % p,
                (x[0] * y[1] + x[1] * y[0]) % p)

    def sub(x, y):
        return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)

    def inv(x):
        d = pow((x[0] * x[0] - nr * x[1] * x[1]) % p, -1, p)
        return (x[0] * d % p, -x[1] * d % p)

    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and (y1[0] + y2[0]) % p == 0 and (y1[1] + y2[1]) % p == 0:
        return None
    if P == Q:
        x1s = mul(x1, x1)
        lam = mul(((3 * x1s[0]) % p, (3 * x1s[1]) % p),
                  inv(((2 * y1[0]) % p, (2 * y1[1]) % p)))
    else:
        lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(mul(lam, lam), x1), x2)
    return x3, sub(mul(lam, sub(x1, x3)), y1)


def g2_affine_ints(g2, pt):
    """Affine G2 points -> ((x.re, x.im), (y.re, y.im)) canonical ints per
    point."""
    xs, ys = (list(zip(*g2.fp.to_int(c))) for c in pt)
    return list(zip(xs, ys))


def fp2_oracle_mul(P, k: int, p: int, nr: int):
    acc = None
    while k:
        if k & 1:
            acc = fp2_oracle_add(acc, P, p, nr)
        P = fp2_oracle_add(P, P, p, nr)
        k >>= 1
    return acc


class Bls12PairingSlice(PairingSlice):
    """A bls12 pairing path (12-word Fp, the 12-word VM kernel): 2048 pairs
    P_i = [a_i]G1 by batch_scalar_mul on the 12-word point kernels and
    Q_i = [b_i]G2 by the G2 scalar_mul on the 12-word Fp2 kernels, as
    bn254's; sampled Q_i and a few [k]G2 are held against the Python-int
    Fp2 ladder."""

    SUFFIX = W12

    def __init__(self, dev, nprng, name: str, n: int = 2048):
        self.NAME = name
        super().__init__(dev, nprng, n)
        self.nr = self.g2.fp.nr

    def checks(self, compare, check):
        super().checks(compare, check)
        g2, name = self.g2, self.NAME
        spec = g2.spec
        g, p = (tuple(spec.gx), tuple(spec.gy)), spec.fp.modulus
        lanes = [1, 2, self.n // 2, self.n - 2, self.n - 1]
        got = g2_affine_ints(g2, type(self.Q)(*(c[lanes] for c in self.Q)))
        check(got == [fp2_oracle_mul(g, self.b[i], p, self.nr)
                      for i in lanes],
              f"{name} G2 scalar_mul inputs at lanes {lanes} == Python-int "
              "ladder")
        ks = [1, 2, 3, self.r - 1, random.Random(SEED + 9).randrange(self.r)]
        got = g2_affine_ints(g2, self.g2_mul(ks))
        check(got == [fp2_oracle_mul(g, k, p, self.nr) for k in ks],
              f"{name} G2 scalar_mul on the card, k = 1, 2, 3, r - 1 and a "
              "random k, == Python-int ladder")


def fp4_oracle(name: str):
    """Python-int G2 arithmetic of a bls24 curve: affine addition and the
    double-and-add ladder over Fp4 = Fp2[v]/(v^2 - v_sq), Fp2 =
    Fp[u]/(u^2 - beta), the tower's parameters (``towers/tower24.py``); an
    element is ((a, b), (c, d)), None is infinity."""
    from gnark_crypto_tpu_torch.towers.tower24 import TOWER24_PARAMS

    spec, beta, v_sq = TOWER24_PARAMS[name]
    p = spec.modulus

    def m2(x, y):
        return ((x[0] * y[0] + beta * x[1] * y[1]) % p,
                (x[0] * y[1] + x[1] * y[0]) % p)

    def a2(x, y):
        return ((x[0] + y[0]) % p, (x[1] + y[1]) % p)

    def s2(x, y):
        return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)

    def mul(x, y):
        return (a2(m2(x[0], y[0]), m2(v_sq, m2(x[1], y[1]))),
                a2(m2(x[0], y[1]), m2(x[1], y[0])))

    def sub(x, y):
        return (s2(x[0], y[0]), s2(x[1], y[1]))

    def inv(x):
        n = s2(m2(x[0], x[0]), m2(v_sq, m2(x[1], x[1])))
        d = pow((n[0] * n[0] - beta * n[1] * n[1]) % p, -1, p)
        ni = (n[0] * d % p, -n[1] * d % p)
        return (m2(x[0], ni), s2((0, 0), m2(x[1], ni)))

    def small(k):
        return ((k % p, 0), (0, 0))

    def add(P, Q):
        if P is None or Q is None:
            return Q if P is None else P
        (x1, y1), (x2, y2) = P, Q
        if x1 == x2 and sub(small(0), y1) == y2:
            return None
        if P == Q:
            lam = mul(mul(small(3), mul(x1, x1)), inv(mul(small(2), y1)))
        else:
            lam = mul(sub(y2, y1), inv(sub(x2, x1)))
        x3 = sub(sub(mul(lam, lam), x1), x2)
        return x3, sub(mul(lam, sub(x1, x3)), y1)

    def ladder(P, k: int):
        acc = None
        while k:
            if k & 1:
                acc = add(acc, P)
            P = add(P, P)
            k >>= 1
        return acc

    return ladder


def g4_affine_ints(g2, pt):
    """Affine G2 points over E4 -> (((x.a, x.b), (x.c, x.d)), (y ...))
    canonical ints per point."""
    coords = []
    for c in pt:
        halves = [list(zip(*g2.fp.base.to_int(g2.fp.coeff(c, i))))
                  for i in range(2)]
        coords.append(list(zip(*halves)))
    return list(zip(*coords))


class Bls24PairingSlice(PairingSlice):
    """A bls24 pairing path (10-word Fp, the 10-word VM kernel; E24 GT,
    the programs 2-6x a bls12 program's rows): 2048 pairs P_i = [a_i]G1 by
    batch_scalar_mul on the 10-word point kernels and Q_i = [b_i]G2 by the
    G2 scalar_mul over E4, composed of field ops (its products on the
    10-word ``mont_mul``), with b = 2, 3 and 2^16 - 1 in the first lanes;
    sampled Q_i are held against a Python-int Fp4 ladder. The E4 ladder
    costs ~0.15 s a bit on the card whatever the lanes, so the edge
    scalars ride in the path's one ladder, not in a ladder of their own,
    and the G2 scalars are below 2^16: a 16-bit ladder, not a 253-bit one
    (the 2048 pairs and their check are the same; every bit is the same
    double and masked add)."""

    SUFFIX = W10
    KERNELS = ("vm_execute", "mont_mul", "exp_const", "jac_add",
               "jac_double")
    G2_BOUND = 1 << 16

    def __init__(self, dev, nprng, name: str, n: int = 2048):
        self.NAME = name
        super().__init__(dev, nprng, n)
        self.oracle = fp4_oracle(name)

    def g2_scalars(self, rng, n: int) -> list[int]:
        return [2, 3, self.G2_BOUND - 1] + super().g2_scalars(rng, n - 3)

    def checks(self, compare, check):
        super().checks(compare, check)
        g2, name, n = self.g2, self.NAME, self.n
        spec = g2.spec
        g = (spec.gx, spec.gy)
        # b = 2, 3, r - 1, random, ..., 1 (the lane that cancels the rest),
        # then the batch-2 and golden lanes' kb, 1 and 7
        lanes = [0, 1, 2, 3, n // 2, n - 2, n - 1, n, n + 2, n + 3]
        Q = self.Q_all
        got = g4_affine_ints(g2, type(Q)(*(c[lanes] for c in Q)))
        bits = self.G2_BOUND.bit_length() - 1
        check(got == [self.oracle(g, self.b[i]) for i in lanes],
              f"{name} G2 (E4) scalar_mul on the card at lanes {lanes} (k = "
              f"2, 3, 2^{bits} - 1, 1, 7 and random below 2^{bits}) == "
              "Python-int Fp4 ladder")


class Bw6PairingSlice(PairingSlice):
    """A bw6 pairing path (24-word Fp for bw6-761, 20-word for bw6-633: the
    VM kernel at that width, E6 GT, the programs smaller than bls24's):
    2048 pairs P_i = [a_i]G1 by batch_scalar_mul and Q_i = [b_i]G2 by the
    G2 scalar_mul, both on the point kernels of that width (bw6's G2 is a
    curve over Fp), with b = 2, 3 and r - 1 in the first lanes; sampled
    Q_i are held against the Python-int ladder, and ``gt_exp`` and
    ``gt_is_in_subgroup`` run on the golden e(G1, G2)."""

    KERNELS = ("vm_execute", "mont_mul", "exp_const", "jac_add",
               "jac_double")

    def __init__(self, dev, nprng, name: str, n: int = 2048):
        from gnark_crypto_tpu_torch.specs import curve as cs

        self.NAME = name
        self.SUFFIX = SUFFIX[cs.get_curve(f"{name}_g1").fp.n_words]
        super().__init__(dev, nprng, n)

    def g2_scalars(self, rng, n: int) -> list[int]:
        return [2, 3, self.r - 1] + super().g2_scalars(rng, n - 3)

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.field import mont
        from gnark_crypto_tpu_torch.io import gt_bytes

        super().checks(compare, check)
        torch, api, name, n = self.torch, self.api, self.NAME, self.n
        spec = self.g2.spec
        p = spec.fp.modulus
        lanes = [0, 1, 2, 3, n // 2, n - 2, n - 1, n, n + 2, n + 3]
        Q = self.Q_all
        xs, ys = (mont.to_int(spec.fp, c[lanes]) for c in Q)
        check(list(zip(xs, ys)) == [oracle_mul((spec.gx, spec.gy),
                                               self.b[i], p, 0)
                                    for i in lanes],
              f"{name} G2 (over Fp) scalar_mul on the card at lanes "
              f"{lanes} (k = 2, 3, r - 1, 1, 7 and random) == Python-int "
              "ladder")
        z = gt_bytes.gt_from_bytes(name, bytes.fromhex(
            self.golden["generator"]), device=self.dev)
        z35 = api.gt_exp(name, z, 35)
        check(self.gt_hex(z35) == self.golden["p5_q7"],
              f"gt_exp {name}: golden e(G1, G2)^35 == golden "
              "e([5]G1, [7]G2)")
        e6 = api.gt_engine(name, self.dev)
        check(bool(e6.equal(e6.mul(api.gt_exp(name, z, -35), z35),
                            e6.ones())),
              f"gt_exp {name}: z^-35 z^35 == 1")
        bad = z.clone()
        bad[1, 2] = mont.add(spec.fp, bad[1, 2],
                             mont.from_int(spec.fp, 1, device=self.dev))
        check(api.gt_is_in_subgroup(name, torch.stack([z, bad])).tolist()
              == [True, False], f"gt_is_in_subgroup {name}: the golden "
              "element True, it with one coefficient plus one False")


class G2MsmSlice:
    """A G2 MSM path: inputs, main path, checks and timings. bn254 (8-word
    Fp2, u^2 = -1), or a bls12 curve (12-word Fp2: bls12-381 u^2 = -1,
    bls12-377 u^2 = -5), whose kernel rows are the 12-word instantiations
    (``W12``)."""

    KERNELS = ("exp_const", "affine_prep2", "affine_finish2", "jac_add2",
               "jac_double2", "jac_fold_windows2")
    FOLD_WINDOWS = 4   # windows of the fold's plain-version check

    def __init__(self, dev, nprng, name: str = "bn254", base_log: int = 16,
                 sizes=(16, 20)):
        import torch

        from gnark_crypto_tpu_torch.curve.g2 import g2_curve
        from gnark_crypto_tpu_torch.field import point_add2
        from gnark_crypto_tpu_torch.msm import pippenger

        self.torch, self.dev, self.nprng = torch, dev, nprng
        self.pp, self.pa2 = pippenger, point_add2
        self.name = name
        self.g2 = g2_curve(name, dev)
        self.r = self.g2.spec.fr.modulus
        self.W = self.g2.spec.fp.n_words
        self.nr = self.g2.fp.nr
        self.suffix = "" if self.W == 8 else W12
        self.tag = "" if self.W == 8 else f"{name} "
        self.kernels = tuple(k + self.suffix for k in self.KERNELS)
        self.wrappers = {k: getattr(point_add2, k) for k in self.KERNELS[1:]}
        self.plain = {k: getattr(point_add2, f"{k}_plain")
                      for k in self.KERNELS[1:]}
        self.recorders = [Recorder(point_add2, "jac_fold_windows2",
                                   keep_all=True, words=self.W)]
        self.recorders += [Recorder(point_add2, k, words=self.W) for k in
                           ("jac_add2", "affine_prep2", "affine_finish2")]
        self.rec = {r.name: r for r in self.recorders}
        self.results, self.wall, self.peak, self.base = {}, {}, {}, {}
        self.base_log, self.sizes = base_log, sizes

    def tiled(self, k: int):
        from gnark_crypto_tpu_torch.curve.jacobian import Affine

        reps = 1 << (k - self.base_log)
        return Affine(self.p16.x.repeat(reps, 1, 1),
                      self.p16.y.repeat(reps, 1, 1))

    def g2_mul(self, k: int):
        """[k]G2 by one scalar multiplication of the G2 group law."""
        from gnark_crypto_tpu_torch.curve.jacobian import Jac

        g2 = self.g2
        G = Jac(*(c[None] for c in g2.generator_jac(device=self.dev)))
        return g2.scalar_mul(G, g2.fr.from_int([k % self.r], mont=False,
                                               device=self.dev))

    # -- phase 1 -------------------------------------------------------------
    def main_path(self):
        """Bases [i+1]G2 (i < 2^base_log) by the G2 batch_scalar_mul, then
        every MSM; returns the seconds."""
        torch, pp, g2 = self.torch, self.pp, self.g2
        for r in self.recorders:
            r.install()
        self.rec["jac_fold_windows2"].on = True
        t0 = time.perf_counter()
        nb = 1 << self.base_log
        ks = g2.fr.from_int(list(range(1, nb + 1)), mont=False,
                            device=self.dev)
        self.p16 = g2.to_affine(pp.batch_scalar_mul(
            g2, g2.generator_affine(device=self.dev), ks))
        torch.cuda.synchronize()
        self.bases_s = time.perf_counter() - t0
        self.scalars = random_scalars(self.nprng, g2.spec,
                                      1 << self.sizes[-1], self.dev)
        for k in self.sizes:
            pts = self.tiled(k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the earlier paths' live tensors, under the peak
            self.base[k] = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            self.results[k] = pp.msm(g2, pts, self.scalars[:1 << k])
            torch.cuda.synchronize()
            self.wall[k] = time.perf_counter() - t1
            self.peak[k] = torch.cuda.max_memory_allocated()
            del pts
        self.rec["jac_fold_windows2"].on = False
        # out of the way of the other paths; checks() installs them again
        for r in self.recorders:
            r.remove()
        return time.perf_counter() - t0

    # -- phase 2 -------------------------------------------------------------
    def affine_ints(self, pt):
        """Affine or Jacobian G2 points -> ((x.re, x.im), (y.re, y.im))
        canonical ints per point."""
        from gnark_crypto_tpu_torch.curve.jacobian import Jac

        g2 = self.g2
        flat = [c.reshape(-1, *c.shape[-2:]) for c in pt]
        return g2_affine_ints(g2, flat if len(flat) == 2
                              else g2.to_affine(Jac(*flat)))

    def checks(self, compare, check):
        """Every MSM against [sum s_i k_i]G2, sampled bases against the
        Python-int Fp2 ladder, then each kernel against its plain version
        on the inputs of a second 2^sizes[0] MSM."""
        torch, pp, name = self.torch, self.pp, self.name
        nb = 1 << self.base_log
        lanes = [0, 1, nb - 1]
        got = self.affine_ints(type(self.p16)(*(c[lanes] for c in self.p16)))
        spec = self.g2.spec
        g, p = (tuple(spec.gx), tuple(spec.gy)), spec.fp.modulus
        check(got == [fp2_oracle_mul(g, i + 1, p, self.nr) for i in lanes],
              f"{name} G2 batch_scalar_mul bases [i+1]G2 at lanes {lanes} "
              "== Python-int ladder")
        for k in self.sizes:
            total = weighted_total(self.scalars[:1 << k], nb, self.r)
            check(self.affine_ints(self.results[k])
                  == self.affine_ints(self.g2_mul(total)),
                  f"msm {name} G2 2^{k} == [sum s_i k_i]G2 (identity)")
        for r_ in self.recorders:
            r_.install()
        for k in ("jac_add2", "affine_prep2", "affine_finish2"):
            self.rec[k].on = True
        k0 = self.sizes[0]
        again = pp.msm(self.g2, self.tiled(k0), self.scalars[:1 << k0])
        for r_ in self.recorders:
            r_.on = False
            r_.remove()
        check(all(torch.equal(u, v) for u, v in zip(again, self.results[k0])),
              f"msm {name} G2 2^{k0} run twice: the same Jacobian "
              "coordinates")
        self.kargs = {k: self.rec[k].args for k in
                      ("jac_add2", "affine_prep2", "affine_finish2")}
        # the bases' ladder doubles every lane of 2^base_log
        self.kargs["jac_double2"] = (spec.fp, self.nr,
                                     *self.g2.from_affine(self.p16))
        folds = self.rec["jac_fold_windows2"].calls
        # one fold per MSM: sizes in order
        self.fold_args = {f"2^{k}": folds[i] for i, k in enumerate(self.sizes)}
        fspec, nr, x, y, z, c = folds[0]
        w = self.FOLD_WINDOWS
        self.kargs["jac_fold_windows2"] = (fspec, nr, x[:w].contiguous(),
                                           y[:w].contiguous(),
                                           z[:w].contiguous(), c)
        # the plain versions' times from these runs (host clock,
        # synchronised): the 12-word plain fold costs seconds
        self.plain_ms = {}
        for k, args in self.kargs.items():
            outs = self.wrappers[k](*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wants = self.plain[k](*args)
            torch.cuda.synchronize()
            self.plain_ms[k] = (time.perf_counter() - t0) * 1e3
            for i, (o, w_) in enumerate(zip(outs, wants)):
                compare(k + self.suffix, o, w_,
                        f"{self.tag}G2 {width(args)} lanes, output {i}")
        # the double's ragged edge: an odd batch leaves a pair half past n
        spec, nr, *c = self.kargs["jac_double2"]
        odd = [t[:t.shape[0] - 3] for t in c]
        for i, (o, w_) in enumerate(zip(
                self.pa2.jac_double2(spec, nr, *odd),
                self.pa2.jac_double2_plain(spec, nr, *odd))):
            compare("jac_double2" + self.suffix, o, w_,
                    f"{self.tag}G2 {odd[0].shape[0]} lanes, output {i}")

    # -- phase 3 -------------------------------------------------------------
    def bounds(self):
        """(bytes, multiply-adds) of each kernel's recorded call on its data:
        an Fp2 element is 8W bytes, an Fp2 product 3 base products."""
        torch, pa2 = self.torch, self.pa2
        mm2 = 3 * mads_per_product(self.W)
        E2 = 8 * self.W
        out = {}
        spec, nr, *pts = self.kargs["affine_prep2"]
        n = pts[0].shape[0]
        _, _, bits = pa2.affine_prep2(spec, nr, *pts)
        out["affine_prep2"] = (n * (6 * E2 + 4),
                               mm2 * int(((bits & 1) != 0).sum()))
        fargs = self.kargs["affine_finish2"]
        mb, tb = fargs[12], fargs[13]
        eq = (tb & 1) != 0
        generic = eq & ((mb & 14) == 0)     # no INFOUT, PINF or QINF bit
        n = fargs[2].shape[0]
        keep_pre = n - int((eq & ((tb & 2) != 0)).sum())
        keep_suf = n - int((eq & ((tb & 4) != 0)).sum())
        out["affine_finish2"] = (
            n * (2 * E2 + 4 + 7 * E2) + int(eq.sum()) * (4 * E2 + 4)
            + (keep_pre + keep_suf) * 2 * E2,
            3 * mm2 * int(generic.sum()))
        spec, nr, *c = self.kargs["jac_add2"]
        both = ~(torch.all(c[2] == 0, -1).all(-1)
                 | torch.all(c[5] == 0, -1).all(-1))
        out["jac_add2"] = (c[0].shape[0] * 9 * E2, 16 * mm2 * int(both.sum()))
        # the double: 2 Fp2 products and 5 Fp2 squares of 2 base products
        spec, nr, *c = self.kargs["jac_double2"]
        out["jac_double2"] = (c[0].shape[0] * 6 * E2,
                              16 * mads_per_product(self.W) * c[0].shape[0])
        self.fold_serial = {}
        for tag, args in [("check", self.kargs["jac_fold_windows2"])] + list(
                self.fold_args.items()):
            nwin, c_ = args[2].shape[0], args[5]
            serial = c_ * (nwin - 1) * 16 + (nwin - 1) * 3 * 16
            self.fold_serial[tag] = serial
            key = ("jac_fold_windows2" if tag == "check"
                   else f"jac_fold_windows2 {tag}")
            out[key] = ((3 * nwin + 3) * E2,
                        mads_per_product(self.W) * serial)
        return out

    def timings(self, cuda_ms, timings, kernel_rows):
        torch, pp, name = self.torch, self.pp, self.name
        for key, (nbytes, mads) in self.bounds().items():
            kname, _, tag = key.partition(" ")
            args = self.fold_args[tag] if tag else self.kargs[kname]
            b_ms, b_by = bound(nbytes, mads)
            row = {"ms": cuda_ms(lambda: self.wrappers[kname](*args),
                                 reps=5),
                   "bound_ms": b_ms, "bound_by": b_by, "lanes": width(args)}
            if kname == "jac_fold_windows2":
                row["serial_products"] = self.fold_serial[tag or "check"]
                row["windows"], row["c"] = args[2].shape[0], args[5]
            if kname == "jac_double2":
                row["design"] = dbl2_design(self.W, self.nr)
            if not tag:
                row["plain_ms"] = self.plain_ms[kname]
                kernel_rows[kname + self.suffix] = row
            timings[f"{self.tag}{key} G2 {width(args)} lanes"] = row
        for k in self.sizes:
            pts = self.tiled(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pp.msm(self.g2, pts, self.scalars[:1 << k])
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            timings[f"msm {name} G2 2^{k}"] = {
                "s": warm, "points_per_s": (1 << k) / warm,
                "s_main_path": self.wall[k], "peak_bytes": self.peak[k],
                "peak_over_live_bytes": self.peak[k] - self.base[k]}
            del pts
        timings[f"{self.tag}G2 bases (batch_scalar_mul, 2^{self.base_log} "
                "lanes)"] = {"s": self.bases_s}
        k = self.sizes[-1]
        timings[f"{self.tag}msm G2 2^{k} steps"] = msm_steps(
            pp, lambda: pp.msm(self.g2, self.tiled(k), self.scalars[:1 << k]))


class KzgSlice:
    """KZG end to end on one curve: SRS, commit, open, verify and the batch
    forms, held against alpha-oracle points and tampered inputs. bn254, or a
    bls12 curve, whose G1 and G2 kernels are the 12-word instantiations
    (``W12``), or a bls24 curve, whose G1 kernels are the 10-word ones
    (``W10``) and whose G2 over E4 is composed of 10-word products, or a bw6
    curve, whose G1 and G2 (over Fp) run on the 24- or 20-word kernels
    (``W24``, ``W20``). The Fr products are 8-word ones but on bw6, whose Fr
    is bls12-377's or bls24-315's Fp (12 and 10 words)."""

    KERNELS = ("exp_const", "jac_add", "jac_double", "affine_prep",
               "affine_finish", "jac_fold_windows", "vm_execute", "jac_add2",
               "jac_double2")
    K = 4   # polynomials of the batch forms

    def __init__(self, dev, nprng, name: str = "bn254", log_n: int = 20):
        import torch

        from gnark_crypto_tpu_torch.curve.g2 import g2_curve
        from gnark_crypto_tpu_torch.curve.jacobian import curve_ops
        from gnark_crypto_tpu_torch.protocols import kzg
        from gnark_crypto_tpu_torch.specs import curve as cs

        self.torch, self.dev, self.nprng, self.kzg = torch, dev, nprng, kzg
        self.NAME = name
        self.g1 = curve_ops(cs.get_curve(f"{name}_g1"))
        self.g2 = g2_curve(name, dev)
        self.r = self.g1.spec.fr.modulus
        self.n = 1 << log_n
        self.wall = {}
        W = self.g1.spec.fp.n_words
        self.e4 = name.startswith("bls24")
        # alpha's bits are new_srs's [alpha]G2 ladder: over E4 (field ops,
        # ~0.15 s a bit on the card) alpha is below 2^16
        self.alpha_bound = 1 << 16 if self.e4 else self.r
        self.g2_fp = name.startswith("bw6")
        kernels = self.KERNELS
        if self.e4 or self.g2_fp:
            # G2 over E4 (field ops, its products on mont_mul) or over Fp
            # (the G1 kernels): no Fp2 kernel
            kernels = tuple(k for k in kernels
                            if not k.endswith("2")) + ("mont_mul",)
        # the Fr products through mont_mul
        self.kernels = ("mont_mul" + SUFFIX[self.g1.spec.fr.n_words],) + \
            tuple(k + SUFFIX[W] for k in kernels)

    def timed(self, label, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if isinstance(out, self.torch.Tensor):
            out = bool(out)
        self.torch.cuda.synchronize()
        self.wall.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    def fr(self, ks):
        return self.g1.fr.from_int([k % self.r for k in ks], mont=False,
                                   device=self.dev)

    # -- phase 1 -------------------------------------------------------------
    def main_path(self):
        torch, kzg, name, K = self.torch, self.kzg, self.NAME, self.K
        t0 = time.perf_counter()
        rng = random.Random(SEED + 5)
        self.alpha = rng.randrange(2, self.alpha_bound)
        self.srs = srs = self.timed("new_srs", lambda: kzg.new_srs(
            name, self.n, self.alpha, device=self.dev))
        self.polys = torch.stack([
            random_scalars(self.nprng, self.g1.spec, self.n, self.dev)
            for _ in range(K)])
        self.a = [rng.randrange(self.r) for _ in range(K)]
        p0, a0 = self.polys[0], self.fr(self.a[:1])
        self.C = self.timed("commit", lambda: kzg.commit(name, srs.pk, p0))
        self.proof = self.timed("open_poly", lambda: kzg.open_poly(
            name, srs.pk, p0, a0))
        self.ok = self.timed("verify", lambda: kzg.verify(
            name, self.C, self.proof, a0, srs.vk))
        bad = kzg.OpeningProof(self.proof.h, self.fr(
            [self.g1.fr.to_int(self.proof.claimed_value, mont=False)[0]
             + 1]))
        self.bad = self.timed("verify", lambda: kzg.verify(
            name, self.C, bad, a0, srs.vk))
        self.digests = [self.C] + [kzg.commit(name, srs.pk, self.polys[i])
                                   for i in range(1, K)]
        self.bproof = self.timed("batch_open_single_point", lambda:
                                 kzg.batch_open_single_point(
                                     name, srs.pk, self.polys, a0,
                                     self.digests))
        self.bok = self.timed("batch_verify_single_point", lambda:
                              kzg.batch_verify_single_point(
                                  name, self.digests, self.bproof, a0,
                                  srs.vk))
        swapped = [self.digests[1], self.digests[0], *self.digests[2:]]
        self.bbad = self.timed("batch_verify_single_point", lambda:
                               kzg.batch_verify_single_point(
                                   name, swapped, self.bproof, a0, srs.vk))
        self.proofs = [self.proof] + [kzg.open_poly(
            name, srs.pk, self.polys[i], self.fr([self.a[i]]))
            for i in range(1, K)]
        lam = [1] + [rng.randrange(self.r) for _ in range(K - 1)]
        pts = [self.fr([a]) for a in self.a]
        self.mok = self.timed("batch_verify_multi_points", lambda:
                              kzg.batch_verify_multi_points(
                                  name, self.digests, self.proofs, pts,
                                  srs.vk, lambdas=lam))
        tampered = list(self.proofs)
        tampered[2] = kzg.OpeningProof(self.proofs[1].h,
                                       self.proofs[2].claimed_value)
        self.mbad = self.timed("batch_verify_multi_points", lambda:
                               kzg.batch_verify_multi_points(
                                   name, self.digests, tampered, pts,
                                   srs.vk, lambdas=lam))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # -- phase 2 -------------------------------------------------------------
    def g1_ints(self, pts):
        from gnark_crypto_tpu_torch.field import mont

        fp = self.g1.spec.fp
        return list(zip(mont.to_int(fp, pts.x), mont.to_int(fp, pts.y)))

    def g1_mul(self, ks):
        """[k]G1 by the G1 group law's ladder, affine."""
        from gnark_crypto_tpu_torch.curve.jacobian import Jac

        g1 = self.g1
        G = g1.generator_jac(device=self.dev)
        return g1.to_affine(g1.scalar_mul(
            Jac(*(c.expand(len(ks), -1) for c in G)), self.fr(ks)))

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.field import mont

        r, alpha = self.r, self.alpha
        coeffs = mont.to_int(self.g1.spec.fr, self.polys[0], mont=False)
        p_alpha = p_a = 0
        for c in reversed(coeffs):     # Horner on host integers
            p_alpha = (p_alpha * alpha + c) % r
            p_a = (p_a * self.a[0] + c) % r
        lanes = [0, 1, 2, self.n - 1]
        pk = self.srs.pk.g1
        name = f"{self.NAME} 2^{self.n.bit_length() - 1}"
        check(self.g1_ints(type(pk)(*(c[lanes] for c in pk)))
              == self.g1_ints(self.g1_mul([pow(alpha, i, r) for i in lanes])),
              f"kzg {name}: SRS [alpha^i]G1 at lanes {lanes}")
        spec2 = self.g2.spec
        if self.e4:
            check(g4_affine_ints(self.g2, self.srs.vk.alpha_g2)
                  == [fp4_oracle(self.NAME)((spec2.gx, spec2.gy), alpha)],
                  f"kzg {name}: SRS [alpha]G2 == Python-int Fp4 ladder")
        elif self.g2_fp:
            check(self.g1_ints(self.srs.vk.alpha_g2)
                  == [oracle_mul((spec2.gx, spec2.gy), alpha,
                                 spec2.fp.modulus, 0)],
                  f"kzg {name}: SRS [alpha]G2 (over Fp) == Python-int "
                  "ladder")
        else:
            check(g2_affine_ints(self.g2, self.srs.vk.alpha_g2)
                  == [fp2_oracle_mul((tuple(spec2.gx), tuple(spec2.gy)),
                                     alpha, spec2.fp.modulus,
                                     self.g2.fp.nr)],
                  f"kzg {name}: SRS [alpha]G2 == Python-int Fp2 ladder")
        check(self.g1_ints(self.C) == self.g1_ints(self.g1_mul([p_alpha])),
              f"kzg {name}: commit == [p(alpha)]G1")
        check(mont.to_int(self.g1.spec.fr, self.proof.claimed_value,
                          mont=False) == [p_a],
              f"kzg {name}: open_poly claimed value == p(a) on host "
              "integers")
        q_alpha = (p_alpha - p_a) * pow(alpha - self.a[0], -1, r) % r
        check(self.g1_ints(self.proof.h) == self.g1_ints(self.g1_mul(
            [q_alpha])), f"kzg {name}: open_poly H == [(p(alpha) - p(a)) / "
              "(alpha - a)]G1")
        check(self.ok is True, f"kzg {name}: verify True on the honest "
              "opening")
        check(self.bad is False, f"kzg {name}: verify False with the "
              "claimed value + 1")
        check(self.bok is True, f"kzg {name}: batch_verify_single_point "
              f"over {self.K} polynomials True")
        check(self.bbad is False, f"kzg {name}: batch_verify_single_point "
              "with two digests swapped False")
        check(self.mok is True, f"kzg {name}: batch_verify_multi_points "
              f"over {self.K} proofs at distinct points True")
        check(self.mbad is False, f"kzg {name}: batch_verify_multi_points "
              "with one proof's H swapped False")

    # -- phase 3 -------------------------------------------------------------
    def timings(self, cuda_ms, timings, kernel_rows):
        import numpy as np

        for label, per in self.wall.items():
            timings[f"kzg {self.NAME} 2^{self.n.bit_length() - 1} {label}"] = {
                "s": float(np.median(per)), "runs": per}


class SmallFieldSlice:
    """The small-field path: the koalabear, babybear and goldilocks NTTs
    (``Domain``, ``fft``, ``fft_inverse``) and the Ring-SIS hash (``rsis``,
    ``RSis.hash``, ``RSis.hash_many``), on the four small-field kernels."""

    KERNELS = ("ntt_f31_stage", "ntt_f31_stage_r4", "ntt_f31_block",
               "ntt_f64_stage", "ntt_f64_block")
    SOURCES = {
        "ntt_f31_stage": ("gnark_crypto_tpu_torch/csrc/ntt_f31.cu",
                          "gnark_crypto_tpu/ntt/pallas_ntt_f31.py:119"),
        "ntt_f31_stage_r4": ("gnark_crypto_tpu_torch/csrc/ntt_f31.cu",
                             "gnark_crypto_tpu/ntt/pallas_ntt_f31.py:190"),
        "ntt_f31_block": ("gnark_crypto_tpu_torch/csrc/ntt_f31.cu",
                          "gnark_crypto_tpu/ntt/pallas_ntt_f31.py:253"),
        "ntt_f64_stage": ("gnark_crypto_tpu_torch/csrc/ntt_f64.cu",
                          "gnark_crypto_tpu/ntt/pallas_ntt_f64.py:191"),
        "ntt_f64_block": ("gnark_crypto_tpu_torch/csrc/ntt_f64.cu",
                          "gnark_crypto_tpu/ntt/pallas_ntt_f64.py:256"),
    }
    # 32-bit multiply-adds per product (csrc/ntt_f31.cu: a*b, m, m*q;
    # csrc/ntt_f64.cu: 4 for a*b, 3 for m, 4 for m*q) and bytes per element
    MADS = {1: 3, 2: 11}
    ALL4 = (("DIF", False), ("DIF", True), ("DIT", False), ("DIT", True))
    DIF_FWD = (("DIF", False),)

    def __init__(self, dev, nprng, logs=(20, 24), sis_logs=(20, 18),
                 cols=2048):
        import numpy as np
        import torch

        from gnark_crypto_tpu_torch.field import api
        from gnark_crypto_tpu_torch.ntt import radix2_f31, radix2_f64
        from gnark_crypto_tpu_torch.specs import field as fs

        self.torch, self.np, self.dev, self.nprng = torch, np, dev, nprng
        self.api, self.fs = api, fs
        self.mods = {1: radix2_f31, 2: radix2_f64}   # by n_words
        where = {"ntt_f31_stage": (radix2_f31, "stage"),
                 "ntt_f31_stage_r4": (radix2_f31, "stage_r4"),
                 "ntt_f31_block": (radix2_f31, "block"),
                 "ntt_f64_stage": (radix2_f64, "stage"),
                 "ntt_f64_block": (radix2_f64, "block")}
        self.wrappers = {k: getattr(m, a) for k, (m, a) in where.items()}
        self.plain = {k: getattr(m, f"{a}_plain")
                      for k, (m, a) in where.items()}
        self.recorders = {k: Recorder(m, a, keep_all=True)
                          for k, (m, a) in where.items()}
        lo, hi = logs
        # (field, log n) -> (the (decimation, inverse) pairs run on the
        # input, whether the coset forms run too)
        self.plan = {("koalabear", lo): (self.ALL4, True),
                     ("koalabear", hi): (self.ALL4, False),
                     ("babybear", lo): (self.DIF_FWD, False),
                     ("goldilocks", lo): (self.DIF_FWD, True),
                     ("goldilocks", hi): (self.DIF_FWD, False)}
        self.logs, self.sis_logs, self.cols = logs, sis_logs, cols
        self.inputs = {key: self.random_elems(key[0], 1 << key[1])
                       for key in self.plan}
        q31 = fs.KOALABEAR.modulus
        self.sis_in = {
            "koalabear": torch.from_numpy(nprng.integers(
                0, q31, size=1 << sis_logs[0], dtype=np.int64).astype(
                    np.int32)).to(dev),
            # goldilocks inputs below 2^63, as bench.py:396-398 makes them
            "goldilocks": torch.from_numpy(nprng.integers(
                0, 1 << 63, size=1 << sis_logs[1], dtype=np.int64).view(
                    np.int32).reshape(-1, 2).copy()).to(dev)}
        self.cols_in = torch.from_numpy(nprng.integers(
            0, q31, size=(cols, 64), dtype=np.int64).astype(np.int32)).to(dev)
        self.out, self.back, self.doms, self.sis, self.hashes = {}, {}, {}, \
            {}, {}
        self.setup_s = {}

    def random_elems(self, field, n: int):
        """n random canonical elements (every canonical value is a valid
        Montgomery form)."""
        np, spec = self.np, self.fs.get_field(field)
        if spec.n_words == 1:
            v = self.nprng.integers(0, spec.modulus, size=n, dtype=np.int64)
            return self.torch.from_numpy(v.astype(np.int32)).to(self.dev)
        v = self.nprng.integers(0, spec.modulus, size=n, dtype=np.uint64)
        return self.torch.from_numpy(
            v.view(np.int32).reshape(n, 2).copy()).to(self.dev)

    # -- phase 1 -------------------------------------------------------------
    def main_path(self):
        from gnark_crypto_tpu_torch.hashes.sis import RSis, rsis
        from gnark_crypto_tpu_torch.ntt import fft
        from gnark_crypto_tpu_torch.ntt.domain import Domain

        torch = self.torch
        for r in self.recorders.values():
            r.install()
            r.on = True
        t0 = time.perf_counter()
        for (field, k), (pairs, coset) in self.plan.items():
            a = self.inputs[field, k]
            dom = Domain(self.api.for_field(field), 1 << k, with_coset=coset,
                         device=self.dev)
            self.doms[field, k] = dom
            for dec, inv in pairs:
                f = fft.fft_inverse if inv else fft.fft
                for cs in ((False, True) if coset else (False,)):
                    self.out[field, k, dec, inv, cs] = f(dom, a, dec, cs)
            self.back[field, k, "DIF"] = fft.fft_inverse(
                dom, self.out[field, k, "DIF", False, False], fft.DIT)
            if coset:
                self.back[field, k, "coset"] = fft.fft_inverse(
                    dom, self.out[field, k, "DIF", False, True], fft.DIT,
                    coset=True)
            if ("DIT", False) in pairs:
                self.back[field, k, "DIT"] = fft.fft_inverse(
                    dom, self.out[field, k, "DIT", False, False], fft.DIF)
        torch.cuda.synchronize()
        self.ntt_s = time.perf_counter() - t0
        for field, lg in zip(("koalabear", "goldilocks"), self.sis_logs):
            t1 = time.perf_counter()
            inst = rsis(field, 42, 9, 16, 1 << lg, device=self.dev)
            torch.cuda.synchronize()
            self.setup_s[field] = time.perf_counter() - t1
            self.sis[field] = inst
            self.hashes[field] = inst.hash(self.sis_in[field])
        t1 = time.perf_counter()
        self.vortex = RSis(self.fs.KOALABEAR, 42, 4, 8, 64, device=self.dev)
        torch.cuda.synchronize()
        self.setup_s["vortex"] = time.perf_counter() - t1
        self.hashes["vortex"] = self.vortex.hash_many(self.cols_in)
        torch.cuda.synchronize()
        for r in self.recorders.values():
            r.on = False
            r.remove()
        return time.perf_counter() - t0

    # -- phase 2 -------------------------------------------------------------
    def plain_transform(self, dom, a, dec, inv, coset):
        """Plain stages and plain products only."""
        from gnark_crypto_tpu_torch.ntt import fft

        eng, mod = dom.eng, self.mods[dom.spec.n_words]
        if not inv:
            if coset:
                t = dom.coset_table
                a = eng.mul(a, fft.bit_reverse(t) if dec == "DIT" else t)
            return mod.run_plain(dom, a, dec, False)
        a = mod.run_plain(dom, a, dec, True)
        scale = dom.cardinality_inv
        if coset:
            t = dom.coset_table_inv
            scale = eng.mul(fft.bit_reverse(t) if dec == "DIF" else t, scale)
        return eng.mul(a, scale)

    def sis_plain(self, inst, vs):
        """The hash pipeline on the plain versions: (B, N) -> (B, d)."""
        eng, dom = inst.eng, inst.domain
        mod = self.mods[dom.spec.n_words]
        tail = tuple(vs.shape[2:])
        m = inst._decompose(vs)
        B, P, d = m.shape[:3]
        rows = eng.mul(eng.reshape(m, (B * P, d)), dom.coset_table)
        kf = mod.block_plain(dom.spec, rows.reshape(-1, *tail),
                             dom.twiddles0, 0, dom.k, False)
        acc = eng.mul(kf.reshape(B, P, d, *tail), inst.ag[None])
        res = eng.sum_reduce(acc.transpose(0, 1)).contiguous()
        out = mod.block_plain(dom.spec, res.reshape(-1, *tail),
                              dom.twiddles0_inv, 0, dom.k, True)
        scale = eng.mul(dom.coset_table_inv, dom.cardinality_inv)
        return eng.from_mont(eng.mul(out.reshape(B, d, *tail), scale))

    def call_key(self, name, args):
        """What makes a recorded call distinct: shape, stage, direction."""
        spec, x, _tw, a3, a4, dit = args
        return (name, spec.name, tuple(x.shape), a3, a4, dit)

    def checks(self, compare, check):
        torch = self.torch
        from gnark_crypto_tpu_torch.ntt.domain import bitrev_perm

        # each kernel against its plain version on the inputs it got on the
        # path, once per distinct call (shape, stage, direction)
        self.kargs = {}
        for name, rec in self.recorders.items():
            seen = set()
            for args in rec.calls:
                key = self.call_key(name, args)
                if key in seen:
                    continue
                seen.add(key)
                self.kargs.setdefault(name, []).append(args)
                compare(name, self.wrappers[name](*args),
                        self.plain[name](*args),
                        f"{args[0].name} {tuple(args[1].shape)} "
                        f"args {args[3:]}")
            rec.calls = []
        # each transform against its plain stages, round trips, samples
        for (field, k, dec, inv, cs), got in self.out.items():
            dom, a = self.doms[field, k], self.inputs[field, k]
            check(torch.equal(got, self.plain_transform(dom, a, dec, inv,
                                                        cs)),
                  f"{field} 2^{k} {dec} inverse={inv} coset={cs} == plain "
                  "stages")
        for (field, k, what), got in self.back.items():
            check(torch.equal(got, self.inputs[field, k]),
                  f"{field} 2^{k} round trip ({what}) == a")
        rng = random.Random(SEED)
        for field, k in self.plan:
            if k != self.logs[0]:
                continue
            dom, eng = self.doms[field, k], self.api.for_field(field)
            q = eng.spec.modulus
            a_int = eng.to_int(self.inputs[field, k])
            out = self.out[field, k, "DIF", False, False]
            rev = bitrev_perm(dom.n)
            for i in rng.sample(range(dom.n), 2):
                wi = pow(dom.generator_int, i, q)
                acc = 0
                for c in reversed(a_int):   # Horner: sum a_j w^(ij)
                    acc = (acc * wi + c) % q
                check(eng.to_int(out[int(rev[i])]) == acc,
                      f"{field} 2^{k} DIF output at frequency {i} == "
                      "Horner sum")
        # each hash against the same pipeline on the plain versions
        for field, inst in self.sis.items():
            v = self.sis_in[field]
            want = self.sis_plain(inst, v[None])[0]
            got = self.hashes[field]
            check(got.shape == want.shape and torch.equal(got, want),
                  f"SIS {field} hash of {v.shape[0]} elements == plain "
                  "pipeline")
        got = self.hashes["vortex"]
        want = self.sis_plain(self.vortex, self.cols_in)
        check(got.shape == (self.cols, 16) and torch.equal(got, want),
              f"SIS hash_many of {self.cols} columns of 64 == plain "
              "pipeline")
        check(torch.equal(got[5], self.vortex.hash(self.cols_in[5])),
              "SIS hash_many column 5 == hash of that column")

    # -- phase 3 -------------------------------------------------------------
    def bound_of(self, name, args):
        """(bytes, multiply-adds) of one call: each element read and written
        once, each twiddle the call reads read once."""
        spec, x, _tw, a3, a4, _dit = args
        nw = spec.n_words
        eb, mm = 4 * nw, self.MADS[nw]
        n = x.shape[0]
        if name.endswith("block"):
            log_n = a4
            return 2 * eb * n + eb * ((1 << log_n) >> 1), mm * log_n * n // 2
        k, s = a3, a4
        half = n >> (s + 1)
        if name.endswith("r4"):
            return 2 * eb * n + eb * half, mm * n
        return 2 * eb * n + eb * half, mm * n // 2

    def timings(self, cuda_ms, timings, kernel_rows):
        from gnark_crypto_tpu_torch.ntt import fft

        for name, calls in self.kargs.items():
            for args in calls:
                if args[5]:
                    continue          # forward calls: one of each shape
                shape = tuple(args[1].shape)
                b_ms, b_by = bound(*self.bound_of(name, args))
                row = {"ms": cuda_ms(lambda: self.wrappers[name](*args),
                                     reps=10),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "elements": shape[0], "args": list(args[3:5])}
                row["plain_ms"] = cuda_ms(lambda: self.plain[name](*args),
                                          reps=1, rounds=1)
                timings[f"{name} {args[0].name} {shape[0]} "
                        f"args {args[3]},{args[4]}"] = row
                kernel_rows.setdefault(name, row)
        for (field, k), (pairs, _) in self.plan.items():
            dom, a = self.doms[field, k], self.inputs[field, k]
            for dec, inv in (("DIF", False), ("DIT", True)):
                f = fft.fft_inverse if inv else fft.fft
                ms = cuda_ms(lambda: f(dom, a, dec), reps=5)
                timings[f"fft {field} {dec} inverse={inv} 2^{k}"] = {
                    "ms": ms, "elems_per_s": dom.n / (ms / 1e3)}
            ms = cuda_ms(lambda: self.plain_transform(dom, a, "DIF", False,
                                                      False),
                         reps=1, rounds=1)
            timings[f"plain stages {field} DIF forward 2^{k}"] = {"ms": ms}
        for field, inst in self.sis.items():
            v = self.sis_in[field]
            ms = cuda_ms(lambda: inst.hash(v), reps=5)
            timings[f"sis {field} hash of {v.shape[0]}"] = {
                "ms": ms, "elems_per_s": v.shape[0] / (ms / 1e3),
                "key_setup_s": self.setup_s[field]}
        ms = cuda_ms(lambda: self.vortex.hash_many(self.cols_in), reps=5)
        timings[f"sis koalabear hash_many {self.cols} columns of 64"] = {
            "ms": ms, "columns_per_s": self.cols / (ms / 1e3),
            "key_setup_s": self.setup_s["vortex"]}
        timings["small-field NTT path (host clock)"] = {"s": self.ntt_s}


def horner(coeffs, x: int, q: int) -> int:
    """sum_j coeffs[j] x^j mod q on host integers."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % q
    return acc


class WideNttSlice:
    """The bw6 Fr NTT at 12 words (bw6-761 Fr, 2-adicity 46) or 10 words
    (bw6-633 Fr, 2-adicity 20), in the forms and sizes of the bn254 NTT
    path: every (decimation, direction, coset) form and three round trips
    at the smaller size, four-step DIF forward and DIT inverse at the
    larger; every NTT kernel (``ntt_radix2_stage``, ``ntt_radix2_block``,
    ``ntt_four_step``) at that width in its ``_w12`` or ``_w10`` row."""

    NTT = ("ntt_radix2_stage", "ntt_radix2_block", "ntt_four_step")
    # the plain sub-NTT steps from 2^24 up run on quarters of the rows
    CHUNKS, CHUNK_LOG = 4, 24

    def __init__(self, dev, nprng, name: str, logs=(20, 24)):
        import torch

        from gnark_crypto_tpu_torch.specs import field as fs

        self.torch, self.dev, self.nprng = torch, dev, nprng
        self.NAME = name
        self.spec = fs.get_field(f"{name}_fr")
        self.W = self.spec.n_words
        self.suffix = SUFFIX[self.W]
        self.logs = logs
        self.kernels = tuple(k + self.suffix for k in self.NTT) + (
            "mont_mul" + self.suffix,)

    def random_elems(self, n: int):
        import numpy as np

        w = self.nprng.integers(0, 1 << 32, size=(n, self.W),
                                dtype=np.uint32)
        w[:, -1] %= self.spec.q_words[-1]
        return self.torch.from_numpy(w.view(np.int32)).to(self.dev)

    # -- phase 1 -------------------------------------------------------------
    def main_path(self):
        from gnark_crypto_tpu_torch.ntt import fft
        from gnark_crypto_tpu_torch.ntt.domain import Domain

        spec, dev = self.spec, self.dev
        t0 = time.perf_counter()
        k1, k2 = self.logs
        self.a1 = self.random_elems(1 << k1)
        self.a2 = self.random_elems(1 << k2)
        self.dom1 = dom1 = Domain(spec, 1 << k1, device=dev)
        self.out1 = {}
        for dec in (fft.DIF, fft.DIT):
            for inv in (False, True):
                f = fft.fft_inverse if inv else fft.fft
                for coset in (False, True):
                    self.out1[dec, inv, coset] = f(dom1, self.a1, dec, coset)
        self.back = fft.fft_inverse(dom1, self.out1[fft.DIF, False, False],
                                    fft.DIT)
        self.back_c = fft.fft_inverse(dom1, self.out1[fft.DIF, False, True],
                                      fft.DIT, coset=True)
        self.back_r = fft.fft_inverse(dom1, self.out1[fft.DIT, False, False],
                                      fft.DIF)
        self.dom2 = Domain(spec, 1 << k2, with_coset=False, device=dev)
        self.f2 = fft.fft(self.dom2, self.a2, fft.DIF)
        self.back2 = fft.fft_inverse(self.dom2, self.f2, fft.DIT)
        self.torch.cuda.synchronize()
        return time.perf_counter() - t0

    # -- phase 2 -------------------------------------------------------------
    def sub_ntt_steps(self, dom):
        from gnark_crypto_tpu_torch.ntt import four_step

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

    def sub_ntt_plain_chunked(self, a, tw, log_s, other, cols, dit, twist,
                              chunks: int):
        """The plain sub-NTT step over ``chunks`` slices of the independent
        rows (columns of the (S, other) view, or rows of the (other, S)
        view): the same values, a quarter of the int64 temporaries."""
        from gnark_crypto_tpu_torch.ntt import four_step

        torch, spec, W = self.torch, self.spec, self.W
        if chunks == 1:
            return four_step.sub_ntt_plain(spec, a, tw, log_s, other, cols,
                                           dit, twist)
        S, step = 1 << log_s, other // chunks
        if cols:
            v = a.reshape(S, other, W)
            tv = None if twist is None else twist.reshape(S, other, W)
            parts = [four_step.sub_ntt_plain(
                spec, v[:, c:c + step].reshape(-1, W), tw, log_s, step,
                True, dit, None if tv is None
                else tv[:, c:c + step].reshape(-1, W)).reshape(S, step, W)
                for c in range(0, other, step)]
            return torch.cat(parts, dim=1).reshape(-1, W)
        v = a.reshape(other, S, W)
        tv = None if twist is None else twist.reshape(other, S, W)
        return torch.cat([four_step.sub_ntt_plain(
            spec, v[c:c + step].reshape(-1, W), tw, log_s, step, False, dit,
            None if tv is None else tv[c:c + step].reshape(-1, W))
            for c in range(0, other, step)]).reshape(-1, W)

    def plain_transform(self, dom, a, dec, inv, coset):
        """Plain radix-2 stages and plain products only."""
        from gnark_crypto_tpu_torch.field.kernels import mont_mul_plain
        from gnark_crypto_tpu_torch.ntt import fft, radix2

        spec = self.spec
        if not inv:
            if coset:
                table = dom.coset_table
                a = mont_mul_plain(spec, a, fft.bit_reverse(table)
                                   if dec == fft.DIT else table)
            return radix2.run_plain(dom, a, dec, False)
        a = radix2.run_plain(dom, a, dec, True)
        scale = dom.cardinality_inv
        if coset:
            table = dom.coset_table_inv
            scale = mont_mul_plain(spec, fft.bit_reverse(table)
                                   if dec == fft.DIF else table, scale)
        return mont_mul_plain(spec, a, scale)

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.field import mont
        from gnark_crypto_tpu_torch.ntt import fft, four_step, radix2
        from gnark_crypto_tpu_torch.ntt.domain import bitrev_perm

        torch, spec, sfx = self.torch, self.spec, self.suffix
        q = spec.modulus
        name = self.spec.name
        k1, k2 = self.logs
        tw1 = self.dom1.twiddles0
        t = min(k1, radix2.TILE_LOG)
        s0 = k1 - t
        for dit in (False, True):
            z = self.a1
            for s in (range(s0 - 1, -1, -1) if dit else range(s0)):
                got = radix2.stage(spec, z, tw1, k1, s, dit)
                compare("ntt_radix2_stage" + sfx, got,
                        radix2.stage_plain(spec, z, tw1, k1, s, dit),
                        f"{name} 2^{k1} stage {s} dit={dit}")
                z = got
            compare("ntt_radix2_block" + sfx,
                    radix2.block(spec, z, tw1, s0, t, dit),
                    radix2.block_plain(spec, z, tw1, s0, t, dit),
                    f"{name} 2^{k1} tail of {t} stages dit={dit}")
        for dom, a in ((self.dom1, self.a1), (self.dom2, self.a2)):
            chunks = self.CHUNKS if dom.k >= self.CHUNK_LOG else 1
            for tw, log_s, other, cols, dit, twist in self.sub_ntt_steps(dom):
                args = (spec, a, tw, log_s, other, cols, dit, twist)
                compare("ntt_four_step" + sfx, four_step.sub_ntt(*args),
                        self.sub_ntt_plain_chunked(a, tw, log_s, other, cols,
                                                   dit, twist, chunks),
                        f"{name} 2^{dom.k} {'columns' if cols else 'rows'} "
                        f"dit={dit} twist={twist is not None}")
        for (dec, inv, coset), got in self.out1.items():
            want = self.plain_transform(self.dom1, self.a1, dec, inv, coset)
            check(torch.equal(got, want), f"{name} 2^{k1} {dec} "
                  f"inverse={inv} coset={coset} == plain stages")
        check(torch.equal(self.back, self.a1),
              f"{name} 2^{k1} DIT inverse(DIF fft(a)) == a")
        check(torch.equal(self.back_c, self.a1),
              f"{name} 2^{k1} coset round trip == a")
        check(torch.equal(self.back_r, self.a1),
              f"{name} 2^{k1} DIF inverse(DIT fft(a)) == a")
        t0 = time.perf_counter()
        want2 = self.plain_transform(self.dom2, self.a2, fft.DIF, False,
                                     False)
        torch.cuda.synchronize()
        check(torch.equal(self.f2, want2), f"{name} 2^{k2} DIF forward "
              f"(four-step) == plain stages ({time.perf_counter() - t0:.1f}"
              " s)")
        del want2
        check(torch.equal(self.back2, self.a2),
              f"{name} 2^{k2} DIT inverse(DIF fft(a)) == a")
        rng = random.Random(SEED + self.W)
        for table, base, what in (
                (self.dom2.twiddles0, self.dom2.generator_int,
                 f"2^{k2} twiddles"),
                (self.dom1.coset_table, self.dom1.shift_int,
                 f"2^{k1} coset table")):
            pts = rng.sample(range(table.shape[0]), 32)
            check(mont.to_int(spec, table[pts])
                  == [pow(base, i, q) for i in pts],
                  f"{name} {what} == powers at 32 points")
        a_int = mont.to_int(spec, self.a1)
        rev = bitrev_perm(1 << k1)
        for i in rng.sample(range(1 << k1), 2):
            wi = pow(self.dom1.generator_int, i, q)
            check(mont.to_int(spec, self.out1[fft.DIF, False, False][
                int(rev[i])]) == horner(a_int, wi, q),
                  f"{name} 2^{k1} DIF output at frequency {i} == Horner sum")

    # -- phase 3 -------------------------------------------------------------
    def timings(self, cuda_ms, timings, kernel_rows):
        """Each kernel at both sizes and its plain version at the smaller
        (the kernels line's row); every form of the whole transform."""
        from gnark_crypto_tpu_torch.field import kernels
        from gnark_crypto_tpu_torch.ntt import fft, four_step, radix2

        spec, sfx, W = self.spec, self.suffix, self.W
        eb, mm = 4 * W, mads_per_product(W)
        for dom, a in ((self.dom1, self.a1), (self.dom2, self.a2)):
            n, k = dom.n, dom.k
            tag = f"{spec.name} 2^{k}"
            t = min(k, radix2.TILE_LOG)
            s0 = k - t
            tw0 = dom.twiddles0
            k1, k2, tw1, tw2, twist = four_step.tables(dom, False)
            S1, S2 = 1 << k1, 1 << k2
            plain = dom is self.dom1
            rows = {
                "ntt_radix2_stage": (
                    lambda: [radix2.stage(spec, a, tw0, k, s, False)
                             for s in range(s0)],
                    lambda: [radix2.stage_plain(spec, a, tw0, k, s, False)
                             for s in range(s0)], s0,
                    bound(sum(2 * eb * n + eb * (n >> (s + 1))
                              for s in range(s0)) / s0, mm * n / 2)),
                "ntt_radix2_block": (
                    lambda: radix2.block(spec, a, tw0, s0, t, False),
                    lambda: radix2.block_plain(spec, a, tw0, s0, t, False),
                    1, bound(2 * eb * n + eb * (1 << (t - 1)),
                             mm * t * n / 2)),
                "ntt_four_step": (
                    lambda: (four_step.sub_ntt(spec, a, tw1, k1, S2, True,
                                               False, twist),
                             four_step.sub_ntt(spec, a, tw2, k2, S1, False,
                                               False)),
                    lambda: (four_step.sub_ntt_plain(spec, a, tw1, k1, S2,
                                                     True, False, twist),
                             four_step.sub_ntt_plain(spec, a, tw2, k2, S1,
                                                     False, False)), 2,
                    bound((5 * eb * n + eb * (S1 + S2) / 2) / 2,
                          mm * (k * n / 2 + n) / 2)),
            }
            for name, (kfn, pfn, per_call, (b_ms, b_by)) in rows.items():
                if name == "ntt_radix2_stage" and s0 == 0:
                    continue
                row = {"ms": cuda_ms(kfn, reps=5) / per_call,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "launches_per_call": per_call}
                if plain:
                    row["plain_ms"] = cuda_ms(pfn, reps=1,
                                              rounds=1) / per_call
                    kernel_rows[name + sfx] = row
                timings[f"{name} {tag}"] = row
            b = self.random_elems(n)
            timings[f"mont_mul {tag}"] = {
                "ms": cuda_ms(lambda: kernels.mont_mul(spec, a, b), reps=5),
                "bound_ms": bound(3 * eb * n, mm * n)[0]}
            del b
            forms = ([(d, i) for d in (fft.DIF, fft.DIT)
                      for i in (False, True)] if plain
                     else [(fft.DIF, False), (fft.DIT, True)])
            for dec, inv in forms:
                f = fft.fft_inverse if inv else fft.fft
                path = ("four-step" if four_step.supported(dom, dec, inv)
                        else "radix-2")
                ms = cuda_ms(lambda: f(dom, a, dec), reps=3)
                timings[f"fft {dec} inverse={inv} {tag} ({path})"] = {
                    "ms": ms, "elems_per_s": n / (ms / 1e3)}


class ToolkitSlice:
    """The IOP toolkit on one curve (``protocols.iop``, ``permutation``,
    ``pedersen``, ``multilin``), every transform on the NTT kernels at the
    curve's Fr width and every commitment on its G1 kernels:

    * iop (``iop_log``): ``to_lagrange_batch`` of 4 polynomials,
      ``evaluate_expression`` over them, ``divide_by_x_minus_one`` of a
      size-2N polynomial by X^N - 1, ``build_ratio_copy_constraint`` over 3
      columns under a permutation of the 3N indices;
    * ``permutation.prove`` and ``verify`` at 2^log_n on the KZG path's SRS
      (the same curve's ``KzgSlice``), True on t2 a permutation of t1 and
      False when one value of t2 is changed;
    * Pedersen (``pedersen_log``) over the MSM path's bases [i+1]G:
      ``setup`` of two keys over one G2 point, ``commit``,
      ``prove_knowledge``, ``verify`` (True, False on a tampered PoK),
      ``batch_verify_multi_vk`` over the two keys (True, False with one
      PoK tampered);
    * ``multilin.evaluate`` of a 2^multilin_log table (``multilin_log``)."""

    def __init__(self, dev, nprng, name: str, log_n: int, kzg_slice,
                 msm_slice=None, iop_log: int | None = None,
                 pedersen_log: int | None = None,
                 multilin_log: int | None = None):
        import torch

        from gnark_crypto_tpu_torch.curve.jacobian import curve_ops
        from gnark_crypto_tpu_torch.specs import curve as cs

        self.torch, self.dev, self.nprng = torch, dev, nprng
        self.NAME = name
        self.g1 = curve_ops(cs.get_curve(f"{name}_g1"))
        self.fr_spec = self.g1.spec.fr
        self.r = self.fr_spec.modulus
        self.n = 1 << log_n
        self.kzg, self.msm = kzg_slice, msm_slice
        self.iop_log, self.pedersen_log = iop_log, pedersen_log
        self.multilin_log = multilin_log
        self.wall = {}
        fr_sfx = SUFFIX[self.fr_spec.n_words]
        fp_sfx = SUFFIX[self.g1.spec.fp.n_words]
        self.kernels = (
            "mont_mul" + fr_sfx, "exp_const" + fr_sfx,
            "ntt_four_step" + fr_sfx,
            *(k + fp_sfx for k in ("exp_const", "jac_add", "jac_double",
                                   "affine_prep", "affine_finish",
                                   "jac_fold_windows", "vm_execute")))
        if pedersen_log and name == "bn254":
            # setup's G2 ladder on the Fp2 kernels
            self.kernels += ("jac_add2", "jac_double2")

    def timed(self, label, fn):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if isinstance(out, torch.Tensor) and out.dtype == torch.bool:
            out = bool(out)
        torch.cuda.synchronize()
        self.wall.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    def fr(self, ks, mont: bool = False):
        return self.g1.fr.from_int([k % self.r for k in ks], mont=mont,
                                   device=self.dev)

    def random_fr(self, n: int):
        return random_scalars(self.nprng, self.g1.spec, n, self.dev)

    # -- phase 1 -------------------------------------------------------------
    def main_path(self):
        t0 = time.perf_counter()
        if self.iop_log:
            self.run_iop()
        self.run_permutation()
        if self.pedersen_log:
            self.run_pedersen()
        if self.multilin_log:
            self.run_multilin()
        self.torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run_iop(self):
        from gnark_crypto_tpu_torch.protocols import iop

        torch, spec, dev = self.torch, self.fr_spec, self.dev
        n = 1 << self.iop_log
        rng = random.Random(SEED + 13)
        self.polys = [iop.from_canonical(spec, self.random_fr(n))
                      for _ in range(4)]
        self.lag = self.timed("to_lagrange_batch", lambda:
                              iop.to_lagrange_batch(self.polys))
        self.expr = self.timed("evaluate_expression", lambda:
                               iop.evaluate_expression(
                                   spec, lambda e, a, b, c, d: e.sub(
                                       e.add(e.mul(a, b), c), d),
                                   *self.polys))
        # p = (X^n - 1) h, size 2n: the quotient is h
        self.h = self.random_fr(n)
        p = torch.cat([self.g1.fr.neg(self.h), self.h])
        self.p = iop.from_canonical(spec, p)
        self.quot = self.timed("divide_by_x_minus_one", lambda:
                               iop.divide_by_x_minus_one(self.p))
        # 3 Lagrange columns and sigma a product of disjoint transpositions
        # of the 3n indices, each pair's two values equal: the grand
        # product wraps to 1
        k = 3
        gen = torch.Generator().manual_seed(SEED + 3)
        order = torch.randperm(k * n, generator=gen).to(dev)
        sigma = torch.empty(k * n, dtype=torch.int64, device=dev)
        sigma[order[0::2]] = order[1::2]
        sigma[order[1::2]] = order[0::2]
        vals = self.random_fr(k * n)
        vals[order[1::2]] = vals[order[0::2]]
        self.sigma, self.cols = sigma, vals.reshape(k, n, -1)
        self.beta, self.gamma = rng.randrange(self.r), rng.randrange(self.r)
        entries = [iop.Polynomial(spec, self.cols[j], iop.Basis.LAGRANGE,
                                  iop.Layout.REGULAR) for j in range(k)]
        self.z = self.timed("build_ratio_copy_constraint", lambda:
                            iop.build_ratio_copy_constraint(
                                spec, entries, sigma, self.beta,
                                self.gamma))

    def run_permutation(self):
        from gnark_crypto_tpu_torch.protocols import permutation

        torch, name = self.torch, self.NAME
        srs = self.kzg.srs
        self.t1 = self.random_fr(self.n)
        gen = torch.Generator().manual_seed(SEED + 7)
        perm = torch.randperm(self.n, generator=gen).to(self.dev)
        t2 = self.t1[perm]
        self.proof = self.timed("permutation prove", lambda:
                                permutation.prove(name, srs.pk, self.t1, t2))
        self.ok = self.timed("permutation verify", lambda:
                             permutation.verify(name, srs.vk, self.proof))
        t2_bad = t2.clone()
        t2_bad[0] = self.fr([self.g1.fr.to_int(t2[:1], mont=False)[0] + 1])[0]
        bad = self.timed("permutation prove", lambda: permutation.prove(
            name, srs.pk, self.t1, t2_bad))
        # its own label: the host relation at eta refuses this proof
        # before either pairing check
        self.bad = self.timed("permutation verify (t2 changed)", lambda:
                              permutation.verify(name, srs.vk, bad))

    def run_pedersen(self):
        from gnark_crypto_tpu_torch.curve.jacobian import Affine
        from gnark_crypto_tpu_torch.protocols import pedersen

        name, g1 = self.NAME, self.g1
        nb = 1 << self.pedersen_log
        rng = random.Random(SEED + 17)
        bases = Affine(self.msm.p16.x[:nb], self.msm.p16.y[:nb])
        self.sigmas = [rng.randrange(1, self.r) for _ in range(2)]
        # two ceremonies over one G2 point, as batch_verify_multi_vk asks
        g2_scalar = rng.randrange(2, 1 << 16)
        keys = [self.timed("pedersen setup", lambda s=s: pedersen.setup(
            name, [bases], sigma=s, g2_scalar=g2_scalar))
            for s in self.sigmas]
        self.values = [self.random_fr(nb) for _ in range(2)]
        self.coms = [self.timed("pedersen commit", lambda k=k, v=v:
                                pedersen.commit(name, k[0][0], v))
                     for k, v in zip(keys, self.values)]
        self.poks = [self.timed("pedersen prove_knowledge", lambda k=k, v=v:
                                pedersen.prove_knowledge(name, k[0][0], v))
                     for k, v in zip(keys, self.values)]
        vk = keys[0][1]
        self.ped_ok = self.timed("pedersen verify", lambda: pedersen.verify(
            name, vk, self.coms[0], self.poks[0]))
        tampered = Affine(self.poks[0].x, g1.fp.neg(self.poks[0].y))
        self.ped_bad = self.timed("pedersen verify", lambda: pedersen.verify(
            name, vk, self.coms[0], tampered))
        vks = [k[1] for k in keys]
        coeff = rng.randrange(1, self.r)
        self.multi_ok = self.timed(
            "pedersen batch_verify_multi_vk", lambda:
            pedersen.batch_verify_multi_vk(name, vks, self.coms, self.poks,
                                           coeff))
        self.multi_bad = self.timed(
            "pedersen batch_verify_multi_vk", lambda:
            pedersen.batch_verify_multi_vk(name, vks, self.coms,
                                           [self.poks[0], tampered], coeff))

    def run_multilin(self):
        from gnark_crypto_tpu_torch.protocols import multilin

        spec = self.fr_spec
        k = self.multilin_log
        self.table = self.g1.fr.to_mont(self.random_fr(1 << k))
        self.coords = self.g1.fr.to_mont(self.random_fr(k))
        self.ml = self.timed("multilin evaluate", lambda: multilin.evaluate(
            spec, self.table, self.coords))

    # -- phase 2 -------------------------------------------------------------
    def checks(self, compare, check):
        tag = f"{self.NAME} 2^{self.n.bit_length() - 1}"
        if self.iop_log:
            self.check_iop(check)
        check(self.ok is True, f"permutation {tag}: verify True on t2 a "
              "permutation of t1")
        check(self.bad is False, f"permutation {tag}: verify False with one "
              "value of t2 changed")
        if self.pedersen_log:
            self.check_pedersen(check)
        if self.multilin_log:
            from gnark_crypto_tpu_torch.field import mont

            q = self.r
            table = mont.to_int(self.fr_spec, self.table)
            for r in mont.to_int(self.fr_spec, self.coords):
                mid = len(table) // 2
                table = [(table[i] + r * (table[i + mid] - table[i])) % q
                         for i in range(mid)]
            check(mont.to_int(self.fr_spec, self.ml) == table[0],
                  f"multilin {self.NAME} 2^{self.multilin_log}: evaluate == "
                  "Python-int folds")

    def check_iop(self, check):
        from gnark_crypto_tpu_torch.field import mont
        from gnark_crypto_tpu_torch.protocols import iop

        torch, spec = self.torch, self.fr_spec
        q = self.r
        n = 1 << self.iop_log
        tag = f"iop {self.NAME} 2^{self.iop_log}"
        rng = random.Random(SEED + 19)
        dom = iop.domain(spec, n, self.dev)
        single = [p.to_lagrange().to_regular() for p in self.polys]
        check(all(torch.equal(a.values, b.values)
                  for a, b in zip(self.lag, single))
              and all(p.basis == iop.Basis.LAGRANGE
                      and p.layout == iop.Layout.REGULAR for p in self.lag),
              f"{tag}: to_lagrange_batch of 4 == each to_lagrange")
        i = rng.randrange(n)
        c0 = mont.to_int(spec, self.polys[0].values, mont=False)
        check(mont.to_int(spec, self.lag[0].values[i:i + 1], mont=False)
              == [horner(c0, pow(dom.generator_int, i, q), q)],
              f"{tag}: Lagrange value {i} == Python-int Horner at g^{i}")
        idx = rng.sample(range(n), 16)
        vals = [mont.to_int(spec, p.values[idx], mont=False)
                for p in self.lag]
        want = [(a * b + c - d) % q for a, b, c, d in zip(*vals)]
        check(mont.to_int(spec, self.expr.values[idx], mont=False) == want
              and self.expr.basis == iop.Basis.LAGRANGE,
              f"{tag}: evaluate_expression a*b + c - d at 16 points")
        check(torch.equal(self.quot.values[:n], self.h)
              and bool((self.quot.values[n:] == 0).all()),
              f"{tag}: divide_by_x_minus_one((X^n - 1) h) == h, N = 2^"
              f"{self.iop_log + 1}")
        z = rng.randrange(q)
        pz = horner(mont.to_int(spec, self.p.values, mont=False), z, q)
        qz = horner(mont.to_int(spec, self.quot.values, mont=False), z, q)
        check(qz * (pow(z, n, q) - 1) % q == pz,
              f"{tag}: q(z) (z^n - 1) == p(z) at a random z")
        # Z: Z_0 = 1, Z_(i+1) = Z_i ratio_i, and the wrap Z_(n-1) ratio = 1
        u, g = dom.shift_int, dom.generator_int
        sigma = self.sigma.tolist()
        zv = self.z.values
        beta, gamma = self.beta, self.gamma

        def ratio(i):
            num = den = 1
            for j in range(3):
                f = mont.to_int(spec, self.cols[j, i:i + 1], mont=False)[0]
                s = sigma[j * n + i]
                num = num * (f + beta * pow(u, j, q) * pow(g, i, q) + gamma)
                den = den * (f + beta * pow(u, s // n, q) * pow(g, s % n, q)
                             + gamma)
            return num * pow(den, -1, q) % q

        zi = mont.to_int(spec, zv, mont=False)
        ok = zi[0] == 1
        for i in rng.sample(range(n - 1), 4):
            ok &= zi[i + 1] == zi[i] * ratio(i) % q
        check(ok, f"{tag}: ratio copy constraint Z_0 = 1, Z_(i+1) = Z_i "
              "ratio_i at 4 points")
        check(zi[n - 1] * ratio(n - 1) % q == 1,
              f"{tag}: ratio copy constraint wraps to 1 under sigma")

    def check_pedersen(self, check):
        from gnark_crypto_tpu_torch.field import mont

        g1, r = self.g1, self.r
        fp = g1.spec.fp
        p, a = fp.modulus, g1.spec.a
        nb = 1 << self.pedersen_log
        tag = f"pedersen {self.NAME} 2^{self.pedersen_log}"

        def ints(pt):
            return list(zip(mont.to_int(fp, pt.x), mont.to_int(fp, pt.y)))

        gen = (g1.spec.gx, g1.spec.gy)
        for i in range(2):
            w = weighted_total(self.values[i], nb, r)
            check(ints(self.coms[i]) == [oracle_mul(gen, w, p, a)],
                  f"{tag}: commit {i} == [sum v_j (j + 1)]G")
            check(ints(self.poks[i]) == [oracle_mul(
                gen, w * self.sigmas[i] % r, p, a)],
                  f"{tag}: prove_knowledge {i} == [sigma sum v_j (j + 1)]G")
        check(self.ped_ok is True, f"{tag}: verify True")
        check(self.ped_bad is False, f"{tag}: verify False on a negated PoK")
        check(self.multi_ok is True, f"{tag}: batch_verify_multi_vk over 2 "
              "keys True")
        check(self.multi_bad is False, f"{tag}: batch_verify_multi_vk False "
              "with one PoK negated")

    # -- phase 3 -------------------------------------------------------------
    def timings(self, cuda_ms, timings, kernel_rows):
        import numpy as np

        for label, per in self.wall.items():
            timings[f"toolkit {self.NAME} 2^{self.n.bit_length() - 1} "
                    f"{label}"] = {"s": float(np.median(per)), "runs": per}


# ---------------------------------------------------------------------------
# the 256-bit 8-word fields and the signature stack (secp256k1/r1, ECDSA,
# twisted Edwards and EdDSA over MiMC, the stark Pedersen hash)
# ---------------------------------------------------------------------------

FULL_FIELDS = ("secp256k1_fp", "secp256k1_fr", "secp256r1_fp",
               "secp256r1_fr")


def edge_values(q: int, bits: int) -> list[int]:
    """0, 1, 2, q-1, q-2, q-3, (q-1)/2, (q+1)/2, 2^(bits-1), 2^(bits-1) - 1
    and 2^bits - 1 reduced mod q, and q - 2^32: the operands at the carries
    of a field that fills all its bits."""
    return [0, 1, 2, q - 1, q - 2, q - 3, (q - 1) // 2, (q + 1) // 2,
            (1 << (bits - 1)) % q, ((1 << (bits - 1)) - 1) % q,
            ((1 << bits) - 1) % q, q - (1 << 32)]


def host_wall(torch, fn):
    """(fn(), seconds) on the host clock, synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class FullFieldSlice:
    """``mont_mul`` and ``exp_const`` at the full 256-bit width on
    secp256k1 and secp256r1 Fp and Fr: ``mont.mul`` over 2^20 lanes with
    every pair of the edge operands in the first lanes, and ``mont.inverse``
    (``exp_const`` with e = q - 2) over 128 lanes with the edge values
    first; each held bit for bit against its plain version and on the edge
    lanes and a sample against Python integers."""

    KERNELS = ("mont_mul" + W8F, "exp_const" + W8F)

    def __init__(self, dev, nprng, log_n: int = 20):
        import torch

        from gnark_crypto_tpu_torch.specs import field as fs

        self.torch, self.dev, self.nprng = torch, dev, nprng
        self.specs = [fs.get_field(n) for n in FULL_FIELDS]
        self.n = 1 << log_n

    def operands(self, spec, n: int):
        import numpy as np

        from gnark_crypto_tpu_torch.field import mont

        edge = edge_values(spec.modulus, 256)
        a = [u for u in edge for _ in edge]
        b = [v for _ in edge for v in edge]
        w = self.nprng.integers(0, 1 << 32, size=(2, n - len(a), 8),
                                dtype=np.uint32)
        w[..., -1] %= spec.q_words[-1]
        rnd = self.torch.from_numpy(w.view(np.int32)).to(self.dev)
        return (self.torch.cat([mont.from_int(spec, a, device=self.dev),
                                rnd[0]]),
                self.torch.cat([mont.from_int(spec, b, device=self.dev),
                                rnd[1]]))

    def main_path(self):
        from gnark_crypto_tpu_torch.field import mont

        t0 = time.perf_counter()
        self.runs = {}
        for spec in self.specs:
            x, y = self.operands(spec, self.n)
            edge = edge_values(spec.modulus, 256)
            e = mont.from_int(spec, edge + [0] * (128 - len(edge)),
                              device=self.dev)
            e[len(edge):] = x[-(128 - len(edge)):]
            self.runs[spec.name] = (x, y, mont.mul(spec, x, y), e,
                                    mont.inverse(spec, e))
        self.torch.cuda.synchronize()
        return time.perf_counter() - t0

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.field import exp, kernels, mont

        rng = random.Random(SEED + 255)
        for spec in self.specs:
            x, y, xy, e, inv = self.runs[spec.name]
            q = spec.modulus
            compare("mont_mul" + W8F, xy, kernels.mont_mul_plain(spec, x, y),
                    f"{spec.name} 2^{self.n.bit_length() - 1} lanes, edge "
                    "pairs first")
            idx = list(range(144)) + rng.sample(range(144, self.n), 32)
            xs, ys, ps = (mont.to_int(spec, t[idx]) for t in (x, y, xy))
            check(ps == [u * v % q for u, v in zip(xs, ys)],
                  f"mont_mul {spec.name}: 144 edge pairs and 32 samples == "
                  "Python-int products")
            compare("exp_const" + W8F, inv,
                    exp.exp_const_plain(spec, e, q - 2),
                    f"{spec.name} 128 lanes, e = q - 2, edge values first")
            es = mont.to_int(spec, e)
            check(mont.to_int(spec, inv) == [pow(v, q - 2, q) for v in es],
                  f"exp_const {spec.name}: 128 lanes == Python-int "
                  "inverses (0 -> 0)")

    def timings(self, cuda_ms, timings, kernel_rows):
        from gnark_crypto_tpu_torch.field import exp, kernels

        mm = mads_per_product(8)
        for spec in self.specs:
            x, y, _, e, _ = self.runs[spec.name]
            n = x.shape[0]
            b_ms, b_by = bound(3 * 32 * n, mm * n)
            timings[f"mont_mul {spec.name} 2^{n.bit_length() - 1}"] = {
                "ms": cuda_ms(lambda: kernels.mont_mul(spec, x, y), reps=5),
                "bound_ms": b_ms, "bound_by": b_by}
            q = spec.modulus
            serial = (q - 2).bit_length() - 1
            b_ms, b_by = bound(2 * 32 * 128,
                               mm * chain_products(q - 2) * 128)
            ms = cuda_ms(lambda: exp.exp_const(spec, e, q - 2), reps=5)
            timings[f"exp_const {spec.name} 128 lanes e=q-2"] = {
                "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                "serial_products": serial,
                "us_per_serial_product": ms * 1e3 / serial}


def host_nonce(order: int, d: int, h: int) -> int:
    """The deterministic HMAC-SHA256 nonce of both packages' ECDSA (RFC 6979
    flavour), on the host."""
    import hashlib
    import hmac

    nb = (order.bit_length() + 7) // 8
    data = d.to_bytes(nb, "big") + h.to_bytes(nb, "big")
    k, v = b"\x00" * 32, b"\x01" * 32
    k = hmac.new(k, v + b"\x00" + data, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + data, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        t = b""
        while len(t) < nb:
            v = hmac.new(k, v, hashlib.sha256).digest()
            t += v
        cand = int.from_bytes(t[:nb], "big") % order
        if cand:
            return cand


def host_ecdsa(spec, seed: bytes, msg: bytes):
    """(d, public key, v, r, s) on Python integers: the key of ``seed`` and
    its low-s recoverable signature of ``msg`` under SHA-256 (the
    packages' key derivation, nonce rule and HashToInt truncation)."""
    import hashlib

    n, p, a = spec.fr.modulus, spec.fp.modulus, spec.a % spec.fp.modulus
    g = (spec.gx % p, spec.gy % p)
    d = int.from_bytes(hashlib.sha512(b"ecdsa-key" + seed).digest(),
                       "big") % n or 1
    digest = hashlib.sha256(msg).digest()[:(n.bit_length() + 7) // 8]
    h = int.from_bytes(digest, "big")
    if len(digest) * 8 > n.bit_length():
        h >>= len(digest) * 8 - n.bit_length()
    ctr = 0
    while True:
        k = host_nonce(n, d, h + ctr)
        ctr += 1
        x, y = oracle_mul(g, k, p, a)
        r = x % n
        s = pow(k, -1, n) * (h + r * d) % n
        if r and s and s <= (n - 1) // 2:
            return d, oracle_mul(g, d, p, a), ((x // n) << 1) | (y & 1), r, s


class EcdsaSlice:
    """ECDSA through ``signature.ecdsa.ECDSA`` on the card: for each curve
    and key, ``generate_key``, ``sign_for_recover``, ``verify`` (True),
    ``verify`` of a tampered message (False), ``recover_public_key`` (the
    key) and the signature's byte round trip; every key and (v, r, s)
    against a Python-int ECDSA with the same nonce rule. secp256k1 64 keys
    and secp256r1 32 (the full-width point kernels: Ethereum's ``ecrecover``
    over a block's transactions, P-256 passkey checks), stark and bn254 G1 8
    each (stark recovers through Tonelli-Shanks); and the known secp256k1
    vector of ``tests/test_signatures.py``."""

    CURVES = (("secp256k1_g1", 64), ("secp256r1_g1", 32), ("stark_g1", 8),
              ("bn254_g1", 8))
    KERNELS = ("mont_mul" + W8F, "exp_const" + W8F, "jac_add" + W8F,
               "jac_double" + W8F, "jac_add", "jac_double")

    def __init__(self, dev):
        import torch

        self.torch, self.dev = torch, dev

    def main_path(self):
        from gnark_crypto_tpu_torch.signature import ecdsa

        torch = self.torch
        t0 = time.perf_counter()
        self.results, self.sign_s, self.verify_s = {}, {}, {}
        for name, n_keys in self.CURVES:
            e = ecdsa.ECDSA(name, device=self.dev)
            rows, signs, verifies = [], [], []
            for i in range(n_keys):
                seed = f"chip-ecdsa-{name}-{i}".encode()
                msg = f"transaction {i} of a block".encode()
                key = e.generate_key(seed)
                (v, sig), s_sign = host_wall(
                    torch, lambda: e.sign_for_recover(msg, key))
                ok, s_verify = host_wall(
                    torch, lambda: e.verify(msg, sig, key.public_key))
                bad = e.verify(msg + b"!", sig, key.public_key)
                rec = e.recover_public_key(msg, v, sig)
                buf = e.signature_to_bytes(sig)
                f = e.curve.fp
                rows.append({
                    "seed": seed, "msg": msg, "d": key.d,
                    "pub": (f.to_int(key.public_key.q.x)[0],
                            f.to_int(key.public_key.q.y)[0]),
                    "vrs": (v, sig.r, sig.s), "ok": ok, "bad": bad,
                    "rec": (f.to_int(rec.q.x)[0], f.to_int(rec.q.y)[0]),
                    "bytes": e.signature_from_bytes(buf) == sig
                    and len(buf) == 2 * e.spec.fr.n_bytes})
                signs.append(s_sign)
                verifies.append(s_verify)
            self.results[name] = rows
            self.sign_s[name], self.verify_s[name] = signs, verifies
        self.vector_ok = self.known_vector(ecdsa)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def known_vector(self, ecdsa) -> bool:
        """The fixed (d, h, k) of ``tests/test_signatures.py``, (r, s) from
        Python integers, verified on the card."""
        e = ecdsa.ECDSA("secp256k1_g1", device=self.dev)
        n, p = e.order, e.spec.fp.modulus
        d, h, k = 0x1234567890ABCDEF, 0xDEADBEEF, 0x1111111111111111
        r = oracle_mul((e.spec.gx, e.spec.gy), k, p, 0)[0] % n
        s = pow(k, -1, n) * (h + r * d) % n

        class FixedHash:
            def __init__(self, data):
                pass

            def digest(self):
                return h.to_bytes(32, "big")

        pub = ecdsa.PublicKey(e._base_mul(d))
        return (e.verify(b"", ecdsa.Signature(r, s), pub, hasher=FixedHash)
                and not e.verify(b"", ecdsa.Signature(r, (s + 1) % n), pub,
                                 hasher=FixedHash))

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.specs import curve as cs

        for name, rows in self.results.items():
            spec = cs.get_curve(name)
            want = [host_ecdsa(spec, row["seed"], row["msg"])
                    for row in rows]
            n = len(rows)
            check(all(row["d"] == w[0] and row["pub"] == w[1]
                      for row, w in zip(rows, want)),
                  f"ecdsa {name}: {n} keys == Python-int keys")
            check(all(row["vrs"] == w[2:] for row, w in zip(rows, want)),
                  f"ecdsa {name}: {n} (v, r, s) == Python-int signatures")
            check(all(row["ok"] is True for row in rows),
                  f"ecdsa {name}: {n} verify True")
            check(all(row["bad"] is False for row in rows),
                  f"ecdsa {name}: {n} tampered verify False")
            check(all(row["rec"] == row["pub"] for row in rows),
                  f"ecdsa {name}: {n} recovered keys == the signers'")
            check(all(row["bytes"] for row in rows),
                  f"ecdsa {name}: {n} signature byte round trips")
        check(self.vector_ok, "ecdsa secp256k1 known vector verifies on the "
              "card (and s + 1 does not)")

    def timings(self, cuda_ms, timings, kernel_rows):
        import numpy as np

        for name, _ in self.CURVES:
            signs, verifies = self.sign_s[name], self.verify_s[name]
            timings[f"ecdsa {name}"] = {
                "keys": len(signs),
                "sign_s_median": float(np.median(signs)),
                "verify_s_median": float(np.median(verifies)),
                "signs_per_s": len(signs) / sum(signs),
                "verifies_per_s": len(verifies) / sum(verifies)}


def ted_oracle_add(P, Q, a: int, d: int, q: int):
    """Affine twisted Edwards addition on Python integers (complete)."""
    (x1, y1), (x2, y2) = P, Q
    t = d * x1 * x2 * y1 * y2 % q
    return ((x1 * y2 + y1 * x2) * pow(1 + t, -1, q) % q,
            (y1 * y2 - a * x1 * x2) * pow(1 - t, -1, q) % q)


def ted_oracle_mul(P, k: int, a: int, d: int, q: int):
    acc = (0, 1)
    for bit in bin(k)[2:]:
        acc = ted_oracle_add(acc, acc, a, d, q)
        if bit == "1":
            acc = ted_oracle_add(acc, P, a, d, q)
    return acc


def mimc_oracle(name: str, blocks: list[int], h: int = 0) -> int:
    """MiMC (Miyaguchi-Preneel) of plain Fr blocks on Python integers."""
    from gnark_crypto_tpu_torch.hashes import mimc
    from gnark_crypto_tpu_torch.specs import field as fs

    spec = fs.get_field(name)
    q, (_, e) = spec.modulus, mimc.PARAMS[name]
    cs = mimc.constants(spec)
    for m in blocks:
        r = m
        for c in cs:
            r = pow(r + h + c, e, q)
        h = (r + h + h + m) % q
    return h


def host_eddsa(ted_spec, seed: bytes, msg: bytes) -> bytes:
    """The signature bytes of ``msg`` under the key of ``seed`` on Python
    integers: gnark's key pruning and blinding, R = [r]B, hram by MiMC over
    R, A and the message, s = r + hram * scalar."""
    import hashlib

    base = ted_spec.base
    q, nb = base.modulus, base.n_bytes
    a, d = ted_spec.a % q, ted_spec.d % q
    g = (ted_spec.gx, ted_spec.gy)
    h = bytearray(hashlib.blake2b(seed, digest_size=64).digest())
    rand_src = bytes(h[32:64])
    h[0] &= 0xF8
    h[31] &= 0x7F
    h[31] |= 0x40
    scalar = int.from_bytes(bytes(reversed(h[:nb])), "big")
    A = ted_oracle_mul(g, scalar, a, d, q)
    blind = hashlib.blake2b(rand_src + msg, digest_size=64).digest()
    r = int.from_bytes(blind[:nb], "big")
    R = ted_oracle_mul(g, r, a, d, q)
    padded = b"\x00" * (-len(msg) % nb) + msg
    blocks = [*R, *A] + [int.from_bytes(padded[i:i + nb], "big")
                         for i in range(0, len(padded), nb)]
    hram = mimc_oracle(base.name, blocks)
    s = (r + hram * scalar) % ted_spec.order
    yb = bytearray(R[1].to_bytes(nb, "big"))
    if R[0] > (q - 1) // 2:
        yb[0] |= 0x80
    return bytes(reversed(yb)) + s.to_bytes(nb, "big")


class EddsaSlice:
    """EdDSA through ``signature.eddsa.EdDSA`` on the card (the twisted
    Edwards law and MiMC composed of field ops: each product a ``mont_mul``
    launch at the curve's Fr width): bn254 (Baby Jubjub) 8 signatures,
    bls12-381, bandersnatch, bls12-377 and bw6-761 (a 12-word base) 4 each.
    Each: ``generate_key``, ``sign``, ``verify`` True, False on a tampered
    message, s + order, s = 0 and an identity R rejected, the signature and
    public-key codecs; every signature's bytes against a Python-int EdDSA
    (the curve law and MiMC on host integers)."""

    CURVES = (("bn254", 8), ("bls12_381", 4), ("bandersnatch", 4),
              ("bls12_377", 4), ("bw6_761", 4))
    KERNELS = ("mont_mul", "mont_mul" + W12, "exp_const", "exp_const" + W12)

    def __init__(self, dev):
        import torch

        self.torch, self.dev = torch, dev

    def main_path(self):
        from gnark_crypto_tpu_torch.signature import eddsa

        torch = self.torch
        t0 = time.perf_counter()
        self.results, self.sign_s, self.verify_s = {}, {}, {}
        for name, n_sigs in self.CURVES:
            ed = eddsa.EdDSA(name, device=self.dev)
            c, order = ed.curve, ed.curve.spec.order
            ident = c.to_affine(c.identity_ext((1,)))
            rows, signs, verifies = [], [], []
            for i in range(n_sigs):
                seed = bytes([i]) * 32
                msg = (1000 + i).to_bytes(ed.nb, "big")
                key = ed.generate_key(seed)
                sig, s_sign = host_wall(torch, lambda: ed.sign(key, msg))
                ok, s_verify = host_wall(
                    torch, lambda: ed.verify(key.public_key, sig, msg))
                s_int = int.from_bytes(sig.s, "big")
                bad_s = [eddsa.Signature(sig.r, v.to_bytes(ed.nb, "big"))
                         for v in (s_int + order, 0)]
                buf = ed.signature_to_bytes(sig)
                back = ed.signature_from_bytes(buf)
                pk_buf = ed.public_key_to_bytes(key.public_key)
                pub2 = ed.public_key_from_bytes(pk_buf)
                f = c.f
                rows.append({
                    "seed": seed, "msg": msg, "bytes": buf, "ok": ok,
                    "bad": ed.verify(key.public_key, sig,
                                     (2000 + i).to_bytes(ed.nb, "big")),
                    "malleable": [ed.verify(key.public_key, b, msg)
                                  for b in bad_s],
                    "identity_r": ed.verify(
                        key.public_key, eddsa.Signature(ident, sig.s), msg),
                    "codec": (ed.signature_to_bytes(back) == buf
                              and ed.public_key_to_bytes(pub2) == pk_buf
                              and back.s == sig.s
                              and all(f.to_int(u) == f.to_int(v) for u, v in
                                      zip((*back.r, *pub2.a),
                                          (*sig.r, *key.public_key.a))))})
                signs.append(s_sign)
                verifies.append(s_verify)
            self.results[name] = rows
            self.sign_s[name], self.verify_s[name] = signs, verifies
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.curve.twistededwards import get_ted

        for name, rows in self.results.items():
            spec = get_ted(name)
            n = len(rows)
            check(all(row["bytes"] == host_eddsa(spec, row["seed"],
                                                 row["msg"])
                      for row in rows),
                  f"eddsa {name}: {n} signatures == Python-int EdDSA bytes")
            check(all(row["ok"] is True for row in rows),
                  f"eddsa {name}: {n} verify True")
            check(all(row["bad"] is False for row in rows),
                  f"eddsa {name}: {n} tampered verify False")
            check(all(row["malleable"] == [False, False] for row in rows),
                  f"eddsa {name}: s + order and s = 0 rejected ({n})")
            check(all(row["identity_r"] is False for row in rows),
                  f"eddsa {name}: identity R rejected ({n})")
            check(all(row["codec"] for row in rows),
                  f"eddsa {name}: signature and public-key codecs ({n})")

    def timings(self, cuda_ms, timings, kernel_rows):
        import numpy as np

        for name, _ in self.CURVES:
            signs, verifies = self.sign_s[name], self.verify_s[name]
            timings[f"eddsa {name}"] = {
                "signatures": len(signs),
                "sign_s_median": float(np.median(signs)),
                "verify_s_median": float(np.median(verifies)),
                "signs_per_s": len(signs) / sum(signs),
                "verifies_per_s": len(verifies) / sum(verifies)}


class MimcSlice:
    """MiMC over bn254 Fr (``hashes.mimc``): ``hash_elements`` over (4,
    2^log_n) random blocks on the card (each round 3 ``mont_mul`` launches
    over the 2^log_n lanes), a 2^10-lane slice against Python-int MiMC; the
    host ``write`` / ``sum`` API on the card against the same."""

    KERNELS = ("mont_mul",)
    NAME = "bn254_fr"

    def __init__(self, dev, nprng, log_n: int = 20, blocks: int = 4):
        import torch

        self.torch, self.dev, self.nprng = torch, dev, nprng
        self.n, self.nb = 1 << log_n, blocks

    def main_path(self):
        import numpy as np

        from gnark_crypto_tpu_torch.hashes import mimc

        torch = self.torch
        h = mimc.mimc(self.NAME, self.dev)
        spec = h.spec
        w = self.nprng.integers(0, 1 << 32, size=(self.nb, self.n, 8),
                                dtype=np.uint32)
        w[..., -1] %= spec.q_words[-1]
        self.blocks = torch.from_numpy(w.view(np.int32)).to(self.dev)
        t0 = time.perf_counter()
        self.out, self.wall = host_wall(torch,
                                        lambda: h.hash_elements(self.blocks))
        h.reset()
        self.data = [(7 * i + 1) for i in range(3)]
        h.write(b"".join(v.to_bytes(spec.n_bytes, "big")
                         for v in self.data))
        self.digest = h.sum()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.field import mont
        from gnark_crypto_tpu_torch.specs import field as fs

        spec = fs.get_field(self.NAME)
        k = 1 << 10
        lanes = mont.to_int(spec, self.blocks[:, :k].reshape(-1, 8),
                            mont=False)
        got = mont.to_int(spec, self.out[:k], mont=False)
        want = [mimc_oracle(self.NAME, lanes[j::k]) for j in range(k)]
        check(got == want, f"mimc {self.NAME} hash_elements ({self.nb}, "
              f"2^{self.n.bit_length() - 1}): the first {k} lanes == "
              "Python-int MiMC")
        check(int.from_bytes(self.digest, "big")
              == mimc_oracle(self.NAME, self.data),
              f"mimc {self.NAME} write/sum on the card == Python-int MiMC")

    def timings(self, cuda_ms, timings, kernel_rows):
        from gnark_crypto_tpu_torch.hashes import mimc

        h = mimc.mimc(self.NAME, self.dev)
        _, s = host_wall(self.torch, lambda: h.hash_elements(self.blocks))
        timings[f"mimc {self.NAME} ({self.nb}, 2^"
                f"{self.n.bit_length() - 1}) blocks"] = {
            "s": s, "hashes_per_s": self.n / s, "s_main_path": self.wall}


class PedersenSlice:
    """The Starkware Pedersen hash (``hashes.pedersen_hash``) over 2^log_n
    random pairs on the stark point kernels (a = 1), 16 sampled lanes
    against Python integers, and pedersen(1, 2) against Starkware's
    vector."""

    KERNELS = ("mont_mul", "exp_const", "jac_add", "jac_double")
    VECTOR = 0x5bb9440e27889a364bcb678b1f679ecd1347acdedcbf36e83494f857cc58026

    def __init__(self, dev, nprng, log_n: int = 16):
        import torch

        self.torch, self.dev, self.nprng = torch, dev, nprng
        self.n = 1 << log_n

    def main_path(self):
        from gnark_crypto_tpu_torch.hashes import pedersen_hash
        from gnark_crypto_tpu_torch.specs import field as fs

        p = fs.STARK_FP.modulus
        rng = random.Random(SEED + 252)
        self.a = [rng.randrange(p) for _ in range(self.n)]
        self.b = [rng.randrange(p) for _ in range(self.n)]
        t0 = time.perf_counter()
        self.out, self.wall = host_wall(
            self.torch, lambda: pedersen_hash.pedersen(self.a, self.b,
                                                       self.dev))
        self.one_two = pedersen_hash.pedersen([1], [2], self.dev)[0]
        return time.perf_counter() - t0

    def checks(self, compare, check):
        from gnark_crypto_tpu_torch.hashes import pedersen_hash as ph
        from gnark_crypto_tpu_torch.specs import field as fs

        p = fs.STARK_FP.modulus
        m = (1 << 248) - 1

        def oracle(a: int, b: int) -> int:
            acc = ph.SHIFT
            for k, i in ((a & m, 0), (a >> 248, 1), (b & m, 2),
                         (b >> 248, 3)):
                acc = oracle_add(acc, oracle_mul(ph.P[i], k, p, 1), p, 1)
            return acc[0]

        check(self.one_two == self.VECTOR, "pedersen(1, 2) on the card == "
              "Starkware's vector")
        rng = random.Random(SEED + 253)
        idx = [0, self.n - 1] + rng.sample(range(1, self.n - 1),
                                           min(14, self.n - 2))
        check([self.out[i] for i in idx]
              == [oracle(self.a[i], self.b[i]) for i in idx],
              f"pedersen 2^{self.n.bit_length() - 1} pairs: {len(idx)} "
              "sampled lanes == Python-int hashes")

    def timings(self, cuda_ms, timings, kernel_rows):
        from gnark_crypto_tpu_torch.hashes import pedersen_hash

        _, s = host_wall(self.torch, lambda: pedersen_hash.pedersen(
            self.a, self.b, self.dev))
        timings[f"pedersen stark 2^{self.n.bit_length() - 1} pairs"] = {
            "s": s, "hashes_per_s": self.n / s, "s_main_path": self.wall}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from gnark_crypto_tpu_torch.field import kernels, mont, vm
    from gnark_crypto_tpu_torch.ntt import fft, four_step, radix2
    from gnark_crypto_tpu_torch.ntt.domain import Domain, bitrev_perm
    from gnark_crypto_tpu_torch.specs import field as fs
    from gnark_crypto_tpu_torch.utils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t_run = t0 = time.perf_counter()
    build_dir = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({build_dir}); "
          "each source's nvcc wall time, all compiling at once: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(
              build.build_seconds.items(), key=lambda kv: kv[1])),
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

    msm = MsmSlice(dev, nprng)
    pairing = PairingSlice(dev, nprng)
    g2msm = G2MsmSlice(dev, nprng)
    kzg = KzgSlice(dev, nprng)
    small = SmallFieldSlice(dev, np.random.default_rng(SEED + 6))
    # bls12-381 and bls12-377 at 12-word Fp: the G1 MSM at 2^12 (an
    # EIP-4844 blob), 2^16 and 2^20, and the pairing
    bls_rng = np.random.default_rng(SEED + 12)
    bls_msm = [MsmSlice(dev, bls_rng, sizes=(12, 16, 20), stark_log=None,
                        name=f"{c}_g1") for c in ("bls12_381", "bls12_377")]
    bls_pair = [Bls12PairingSlice(dev, bls_rng, c)
                for c in ("bls12_381", "bls12_377")]
    # their G2 MSMs on the 12-word Fp2 kernels (u^2 = -1 and -5) at 2^16
    # and 2^20, and KZG: bls12-381 at 4096 (an EIP-4844 blob), bls12-377 at
    # 2^20
    bls_g2 = [G2MsmSlice(dev, bls_rng, c) for c in ("bls12_381", "bls12_377")]
    bls_kzg = [KzgSlice(dev, bls_rng, "bls12_381", log_n=12),
               KzgSlice(dev, bls_rng, "bls12_377", log_n=20)]
    # bls24-315 and bls24-317 at 10-word Fp: the G1 MSM at 2^12, 2^16 and
    # 2^20, the pairing (G2 over E4, composed of 10-word products), and
    # KZG: bls24-315 (the inner curve of gnark's 2-chain with bw6-633) at
    # 2^20, bls24-317 at 2^16
    bls24_rng = np.random.default_rng(SEED + 24)
    bls24 = ("bls24_315", "bls24_317")
    bls24_msm = [MsmSlice(dev, bls24_rng, sizes=(12, 16, 20), stark_log=None,
                          name=f"{c}_g1") for c in bls24]
    bls24_pair = [Bls24PairingSlice(dev, bls24_rng, c) for c in bls24]
    bls24_kzg = [KzgSlice(dev, bls24_rng, "bls24_315", log_n=20),
                 KzgSlice(dev, bls24_rng, "bls24_317", log_n=16)]
    # bw6-761 at 24-word Fp and bw6-633 at 20 (the outer curves of gnark's
    # 2-chains over bls12-377 and bls24-315): the G1 MSM at 2^12, 2^16 and
    # 2^20, the G2 MSM of bw6-761 (G2 over Fp, on the same kernels) at 2^16
    # (a Groth16 prover's [B]_2), the pairing (E6 GT), and KZG: bw6-761 at
    # 2^20, bw6-633 at 2^16
    bw6_rng = np.random.default_rng(SEED + 6)
    bw6 = ("bw6_761", "bw6_633")
    bw6_msm = [MsmSlice(dev, bw6_rng, sizes=(12, 16, 20), stark_log=None,
                        name=f"{c}_g1") for c in bw6]
    # (its 24-word fold is held whole on bw6-761 G1's)
    bw6_msm.append(MsmSlice(dev, bw6_rng, sizes=(12, 16), stark_log=None,
                            name="bw6_761_g2", whole_fold=False))
    bw6_pair = [Bw6PairingSlice(dev, bw6_rng, c) for c in bw6]
    bw6_kzg = [KzgSlice(dev, bw6_rng, "bw6_761", log_n=20),
               KzgSlice(dev, bw6_rng, "bw6_633", log_n=16)]
    # the bw6 Fr NTT at 12 words (bw6-761 Fr: 2^20 and 2^24) and 10 words
    # (bw6-633 Fr: 2^16 and 2^20, its largest domain), and the IOP toolkit:
    # iop at 2^20, the permutation argument on the bw6-761 KZG SRS and
    # Pedersen over 2^16 bases on bw6-761; the permutation argument and
    # Pedersen on bn254 (2^20, on the bn254 KZG SRS), with multilin over a
    # 2^20 table; the permutation argument on bw6-633 at 2^16
    tk_rng = np.random.default_rng(SEED + 13)
    wide_ntt = [WideNttSlice(dev, tk_rng, "bw6_761", logs=(20, 24)),
                WideNttSlice(dev, tk_rng, "bw6_633", logs=(16, 20))]
    toolkit = [ToolkitSlice(dev, tk_rng, "bw6_761", 20, bw6_kzg[0],
                            bw6_msm[0], iop_log=20, pedersen_log=16),
               ToolkitSlice(dev, tk_rng, "bn254", 20, kzg, msm,
                            pedersen_log=16, multilin_log=20),
               ToolkitSlice(dev, tk_rng, "bw6_633", 16, bw6_kzg[1])]
    # secp256k1 and secp256r1 on the full-width 8-word kernels: the G1 MSM
    # (secp256k1 at 2^12, 2^16, 2^20; secp256r1, a = -3, at 2^12 and 2^16),
    # the field kernels on the four 256-bit fields, ECDSA; then EdDSA over
    # MiMC, MiMC over 2^20 lanes and the stark Pedersen hash over 2^16 pairs
    secp_rng = np.random.default_rng(SEED + 256)
    secp_msm = [MsmSlice(dev, secp_rng, sizes=(12, 16, 20), stark_log=None,
                         name="secp256k1_g1"),
                MsmSlice(dev, secp_rng, sizes=(12, 16), stark_log=None,
                         name="secp256r1_g1")]
    full_field = FullFieldSlice(dev, secp_rng)
    sig_slices = [EcdsaSlice(dev), EddsaSlice(dev), MimcSlice(dev, secp_rng),
                  PedersenSlice(dev, secp_rng)]
    ntt_kernels = ("mont_mul", "ntt_radix2_stage", "ntt_radix2_block",
                   "ntt_four_step")
    wrappers = {"mont_mul": kernels.mont_mul,
                "ntt_radix2_stage": radix2.stage,
                "ntt_radix2_block": radix2.block,
                "ntt_four_step": four_step.sub_ntt, **msm.wrappers,
                "vm_execute": vm.vm_execute, **g2msm.wrappers,
                **small.wrappers}

    def read_counts() -> dict:
        """{kernel row: launches}: a kernel built at several widths counts
        its 8-word launches under its name, its 10-, 12-, 20- and 24-word
        ones under name + W10, W12, W20 and W24, and those on the 256-bit
        8-word fields under name + W8F."""
        counts = {}
        for name, w in wrappers.items():
            if name in NTT_KERNELS:
                counts[name] = w.launches_by_width.get(8, 0)
                counts[name + W10] = w.launches_by_width.get(10, 0)
                counts[name + W12] = w.launches_by_width.get(12, 0)
            elif name in W12_KERNELS:
                counts[name] = w.launches_by_width.get(8, 0)
                counts[name + W12] = w.launches_by_width.get(12, 0)
                if name in W10_KERNELS:
                    counts[name + W10] = w.launches_by_width.get(10, 0)
                    counts[name + W20] = w.launches_by_width.get(20, 0)
                    counts[name + W24] = w.launches_by_width.get(24, 0)
            else:
                counts[name] = w.launches
            if name in FULL_KERNELS:
                counts[name + W8F] = w.launches_by_width.get("8full", 0)
        return counts

    def drive(path: str, run, kernel_names) -> dict:
        """Counts to 0, the path, counts read: {kernel row: launches}."""
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, "launches_by_width"):
                w.launches_by_width.clear()
        seconds = run()
        counts = read_counts()
        print(f"{path} path: " + ", ".join(
            f"{k}={v}" for k, v in counts.items() if v)
            + f" ({seconds:.2f} s)", flush=True)
        for name in kernel_names:
            check(counts[name] > 0,
                  f"{name} launched on the {path} path ({counts[name]})")
        return counts

    # ---------------------------------------------------------------- phase 1
    n20, n24 = 1 << 20, 1 << 24
    x = torch.cat([mont.from_int(spec, [0, 1, q - 1], device=dev),
                   random_elems(n20)])
    y = torch.cat([mont.from_int(spec, [q - 1, 0, 1], device=dev),
                   random_elems(n20)])
    a20 = random_elems(n20)
    a24 = random_elems(n24)
    pairs = [(d, inv) for d in (fft.DIF, fft.DIT) for inv in (False, True)]

    out20 = {}

    def ntt_path() -> float:
        nonlocal xy, dom20, back20, back20c, back20r, dom24, f24, back24
        t0 = time.perf_counter()
        xy = mont.mul(spec, x, y)
        dom20 = Domain(spec, n20, device=dev)
        for dec, inv in pairs:
            for coset in (False, True):
                f = fft.fft_inverse if inv else fft.fft
                out20[dec, inv, coset] = f(dom20, a20, dec, coset)
        back20 = fft.fft_inverse(dom20, out20[fft.DIF, False, False],
                                 fft.DIT)
        back20c = fft.fft_inverse(dom20, out20[fft.DIF, False, True],
                                  fft.DIT, coset=True)
        back20r = fft.fft_inverse(dom20, out20[fft.DIT, False, False],
                                  fft.DIF)
        dom24 = Domain(spec, n24, with_coset=False, device=dev)
        f24 = fft.fft(dom24, a24, fft.DIF)
        back24 = fft.fft_inverse(dom24, f24, fft.DIT)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    xy = dom20 = back20 = back20c = back20r = dom24 = f24 = back24 = None
    ntt_counts = drive("NTT", ntt_path, ntt_kernels)
    msm_counts = drive("MSM", msm.main_path, msm.KERNELS)
    pair_counts = drive("pairing", pairing.main_path, pairing.KERNELS)
    g2_counts = drive("G2 MSM", g2msm.main_path, g2msm.kernels)
    kzg_counts = drive("KZG", kzg.main_path, kzg.kernels)
    small_counts = drive("small fields", small.main_path, small.KERNELS)
    bls_counts = [drive(f"{sl.spec.name} MSM", sl.main_path, sl.kernels)
                  for sl in bls_msm]
    bls_counts += [drive(f"{sl.NAME} pairing", sl.main_path, sl.kernels)
                   for sl in bls_pair]
    bls_counts += [drive(f"{sl.name} G2 MSM", sl.main_path, sl.kernels)
                   for sl in bls_g2]
    bls_counts += [drive(f"{sl.NAME} KZG", sl.main_path, sl.kernels)
                   for sl in bls_kzg]
    bls24_counts = [drive(f"{sl.spec.name} MSM", sl.main_path, sl.kernels)
                    for sl in bls24_msm]
    bls24_counts += [drive(f"{sl.NAME} pairing", sl.main_path, sl.kernels)
                     for sl in bls24_pair]
    bls24_counts += [drive(f"{sl.NAME} KZG", sl.main_path, sl.kernels)
                     for sl in bls24_kzg]
    bw6_counts = [drive(f"{sl.spec.name} MSM", sl.main_path, sl.kernels)
                  for sl in bw6_msm]
    bw6_counts += [drive(f"{sl.NAME} pairing", sl.main_path, sl.kernels)
                   for sl in bw6_pair]
    bw6_counts += [drive(f"{sl.NAME} KZG", sl.main_path, sl.kernels)
                   for sl in bw6_kzg]
    tk_counts = [drive(f"{sl.spec.name} NTT", sl.main_path, sl.kernels)
                 for sl in wide_ntt]
    tk_counts += [drive(f"{sl.NAME} toolkit", sl.main_path, sl.kernels)
                  for sl in toolkit]
    secp_counts = [drive(f"{sl.spec.name} MSM", sl.main_path, sl.kernels)
                   for sl in secp_msm]
    secp_counts.append(drive("256-bit field", full_field.main_path,
                             full_field.KERNELS))
    sig_counts = [drive(label, sl.main_path, sl.KERNELS) for label, sl in
                  zip(("ECDSA", "EdDSA", "MiMC", "stark Pedersen"),
                      sig_slices)]
    path_counts = (ntt_counts, msm_counts, pair_counts, g2_counts,
                   kzg_counts, small_counts, *bls_counts, *bls24_counts,
                   *bw6_counts, *tk_counts, *secp_counts, *sig_counts)
    row_names = (list(wrappers) + [k + W12 for k in W12_KERNELS]
                 + [k + W10 for k in W10_KERNELS]
                 + [k + w for w in (W20, W24) for k in W10_KERNELS]
                 + [k + w for w in (W10, W12) for k in NTT_KERNELS]
                 + [k + W8F for k in FULL_KERNELS])
    launches = {name: sum(c[name] for c in path_counts)
                for name in row_names}
    for name in W12_KERNELS:
        check(launches[name + W12] > 0, f"{name} launched at 12 words on "
              f"the bls12 paths ({launches[name + W12]})")
    for name in W10_KERNELS:
        check(sum(c[name + W10] for c in bls24_counts) > 0,
              f"{name} launched at 10 words on the bls24 paths "
              f"({launches[name + W10]})")
        for w in (W20, W24):
            check(sum(c[name + w] for c in bw6_counts) > 0,
                  f"{name} launched at {w[2:]} words on the bw6 paths "
                  f"({launches[name + w]})")
    for name in NTT_KERNELS:
        for sl, w, c in zip(wide_ntt, (W12, W10), tk_counts):
            check(c[name + w] > 0, f"{name} launched at {w[2:]} words on "
                  f"the {sl.spec.name} NTT path ({c[name + w]})")
    for name in FULL_KERNELS:
        for sl, c in zip(secp_msm, secp_counts):
            check(c[name + W8F] > 0, f"{name} launched at the full 256-bit "
                  f"width on the {sl.spec.name} MSM path ({c[name + W8F]})")
    print("launches by path: " + json.dumps(
        {"ntt": ntt_counts, "msm": msm_counts, "pairing": pair_counts,
         "g2_msm": g2_counts, "kzg": kzg_counts, "small": small_counts,
         "bls12": bls_counts, "bls24": bls24_counts, "bw6": bw6_counts,
         "bw6_ntt_and_toolkit": tk_counts, "secp": secp_counts,
         "signatures_and_hashes": sig_counts}), flush=True)

    # ---------------------------------------------------------------- phase 2
    # seconds of each step of phases 2 and 3, printed at the end
    spent = {"build": build_s, "phase 1": time.perf_counter() - t_run
             - build_s}
    t_step = time.perf_counter()

    def timed(label: str, fn, *args) -> None:
        t = time.perf_counter()
        fn(*args)
        spent[label] = time.perf_counter() - t

    def slice_label(sl) -> str:
        name = (getattr(sl, "NAME", None) or getattr(sl, "name", None)
                or getattr(getattr(sl, "spec", None), "name", ""))
        return f"{type(sl).__name__} {name}".strip()

    err = {name: 0 for name in row_names}

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

    spent["checks NTT"] = time.perf_counter() - t_step
    for sl in (msm, pairing, g2msm, kzg, small, *bls_msm, *bls_pair,
               *bls_g2, *bls_kzg, *bls24_msm, *bls24_pair, *bls24_kzg,
               *bw6_msm, *bw6_pair, *bw6_kzg, *wide_ntt, *toolkit,
               *secp_msm, full_field, *sig_slices):
        timed(f"checks {slice_label(sl)}", sl.checks, compare, check)
    t_step = time.perf_counter()

    # ---------------------------------------------------------------- phase 3
    def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
        """Median over rounds of the mean time of `reps` back-to-back calls;
        the calls queue behind a spin kernel, so that a wrapper's host time
        does not count where its kernel is shorter."""
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

    spent["timings NTT"] = time.perf_counter() - t_step
    for sl in (msm, pairing, g2msm, kzg, small):
        timed(f"timings {slice_label(sl)}", sl.timings, cuda_ms, timings,
              kernel_rows)
    # the kernels line takes each 12-word row from bls12-381; bls12-377's
    # rows are in the timings line
    for sl, into in ((bls_msm[0], kernel_rows), (bls_msm[1], {}),
                     (bls_pair[0], kernel_rows), (bls_pair[1], {}),
                     (bls_g2[0], kernel_rows), (bls_g2[1], {}),
                     (bls_kzg[0], {}), (bls_kzg[1], {})):
        timed(f"timings {slice_label(sl)}", sl.timings, cuda_ms, timings,
              into)
    # the 10-word rows from bls24-315; bls24-317's in the timings line
    for sl, into in ((bls24_msm[0], kernel_rows), (bls24_msm[1], {}),
                     (bls24_pair[0], kernel_rows), (bls24_pair[1], {}),
                     (bls24_kzg[0], {}), (bls24_kzg[1], {})):
        timed(f"timings {slice_label(sl)}", sl.timings, cuda_ms, timings,
              into)
    # the 24-word rows from bw6-761 and the 20-word ones from bw6-633 (each
    # curve its own width); the bw6-761 G2 MSM's in the timings line
    for sl, into in ((bw6_msm[0], kernel_rows), (bw6_msm[1], kernel_rows),
                     (bw6_msm[2], {}), (bw6_pair[0], kernel_rows),
                     (bw6_pair[1], kernel_rows), (bw6_kzg[0], {}),
                     (bw6_kzg[1], {})):
        timed(f"timings {slice_label(sl)}", sl.timings, cuda_ms, timings,
              into)
    # the 12- and 10-word NTT rows from bw6-761 and bw6-633 Fr
    for sl in (*wide_ntt, *toolkit):
        timed(f"timings {slice_label(sl)}", sl.timings, cuda_ms, timings,
              kernel_rows)
    # the full-width rows from secp256k1; secp256r1's (a = -3) and the
    # 256-bit field kernels at 2^20 in the timings line
    for sl, into in ((secp_msm[0], kernel_rows), (secp_msm[1], {}),
                     (full_field, {}), *((sl, {}) for sl in sig_slices)):
        timed(f"timings {slice_label(sl)}", sl.timings, cuda_ms, timings,
              into)

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
        "exp_const": ("gnark_crypto_tpu_torch/csrc/exp.cu",
                      "gnark_crypto_tpu/field/pallas/exp.py:67"),
        "jac_add": ("gnark_crypto_tpu_torch/csrc/point_add.cu",
                    "gnark_crypto_tpu/field/pallas/point_add.py:198"),
        "jac_double": ("gnark_crypto_tpu_torch/csrc/point_add.cu",
                       "gnark_crypto_tpu/field/pallas/point_add.py:209"),
        "affine_prep": ("gnark_crypto_tpu_torch/csrc/affine_level.cu",
                        "gnark_crypto_tpu/field/pallas/point_add.py:294"),
        "affine_finish": ("gnark_crypto_tpu_torch/csrc/affine_level.cu",
                          "gnark_crypto_tpu/field/pallas/point_add.py:329"),
        "jac_fold_windows": ("gnark_crypto_tpu_torch/csrc/point_add.cu",
                             "gnark_crypto_tpu/field/pallas/point_add.py:421"),
        "vm_execute": ("gnark_crypto_tpu_torch/csrc/vm.cu",
                       "gnark_crypto_tpu/field/pallas/vm.py:354"),
        "affine_prep2": ("gnark_crypto_tpu_torch/csrc/affine_level2.cu",
                         "gnark_crypto_tpu/field/pallas/point_add2.py:192"),
        "affine_finish2": ("gnark_crypto_tpu_torch/csrc/affine_level2.cu",
                           "gnark_crypto_tpu/field/pallas/point_add2.py:227"),
        "jac_add2": ("gnark_crypto_tpu_torch/csrc/point_add2.cu",
                     "gnark_crypto_tpu/field/pallas/point_add2.py:320"),
        "jac_double2": ("gnark_crypto_tpu_torch/csrc/point_add2.cu",
                        "gnark_crypto_tpu/field/pallas/point_add2.py:328"),
        "jac_fold_windows2": (
            "gnark_crypto_tpu_torch/csrc/point_add2.cu",
            "gnark_crypto_tpu/field/pallas/point_add2.py:367"),
        **SmallFieldSlice.SOURCES,
    }
    for name in row_names:
        r = kernel_rows[name]
        base = name
        for w in (W10, W12, W20, W24, W8F):
            base = base.removesuffix(w)
        kernel_line.append({
            "name": name, "route": "cuda", "source": sources[base][0],
            "replaces": sources[base][1], "launches": launches[name],
            "max_abs_err": err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            **({"design": r["design"]} if "design" in r else {})})
    print("seconds by step: " + json.dumps(
        {k: round(v, 2) for k, v in spent.items()}), flush=True)
    print(f"chip_smoke: {len(CHECKS)} checks, {len(FAILURES)} failed, "
          f"{time.perf_counter() - t_run:.2f} s in all (build included)",
          flush=True)
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
