"""The koalabear/babybear NTT on its kernels, and their plain versions.

Counterpart of ``gnark_crypto_tpu/ntt/pallas_ntt_f31.py``:
``run_stages_pallas_f31`` is :func:`run`, ``run_batch_small_f31`` is
:func:`run_batch_small`. Elements are the f31 engine's ``int32`` Montgomery
values (``field/f31.py``), flat ``(n,)``; stage s pairs ``lo`` and
``lo + half`` (half = n >> (s + 1)) with twiddle ``tw0[(lo mod half) << s]``:

* DIF: (a + b, (a - b) w), stages 0 .. k-1, natural order in, bit-reversed
  out;
* DIT: (a + w b, a - w b), stages k-1 .. 0, bit-reversed in, natural out.

On the card, the stages whose half-block is wider than a shared-memory
tile run as :func:`stage_r4` (two stages in one pass, ``ntt_f31_stage``
with R = 2) while two remain and as :func:`stage` (one stage, R = 1) for an
odd one; the last t = min(k, TILE_LOG) stages (DIF) or the first (DIT) run
in one :func:`block` pass (``ntt_f31_block``), which also runs a whole batch
of small transforms in one launch. On the CPU the same wrappers run their
plain versions, so both devices take the same steps. :func:`run_plain` is
the transform stage by stage with plain tensor code, the reference the
kernels are held against. See ``csrc/ntt_f31.cu`` for the bound.
"""

from __future__ import annotations

import ctypes

import torch

from gnark_crypto_tpu_torch.field import f31
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.utils import build

DIF = "DIF"
DIT = "DIT"
TILE_LOG = 13  # 2^13 elements = 32 KB of shared memory per block


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def butterfly_plain(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor,
                    tw: torch.Tensor, dit: bool):
    if dit:
        hi = f31.mul(spec, hi, tw)
        return f31.add(spec, lo, hi), f31.sub(spec, lo, hi)
    return f31.add(spec, lo, hi), f31.mul(spec, f31.sub(spec, lo, hi), tw)


def stage_plain(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor, k: int,
                s: int, dit: bool) -> torch.Tensor:
    """Butterfly stage s of a size-2^k transform."""
    half = (1 << k) >> (s + 1)
    v = x.reshape(1 << s, 2, half)
    lo, hi = butterfly_plain(spec, v[:, 0], v[:, 1], tw0[:: 1 << s][:half],
                             dit)
    return torch.stack([lo, hi], dim=1).reshape(x.shape)


def stage_r4_plain(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor,
                   k: int, s: int, dit: bool) -> torch.Tensor:
    """Stages s and s + 1 in the transform's order."""
    for st in ((s + 1, s) if dit else (s, s + 1)):
        x = stage_plain(spec, x, tw0, k, st, dit)
    return x


def block_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
                tw_shift: int, log_n: int, dit: bool) -> torch.Tensor:
    """Every stage of each contiguous 2^log_n block of x (flat); local
    stage s uses twiddle tw[(off << s) << tw_shift]."""
    n = 1 << log_n
    rows = x.reshape(-1, n)
    for s in (range(log_n - 1, -1, -1) if dit else range(log_n)):
        half = n >> (s + 1)
        v = rows.reshape(rows.shape[0], 1 << s, 2, half)
        idx = torch.arange(half, device=x.device) << (s + tw_shift)
        lo, hi = butterfly_plain(spec, v[:, :, 0], v[:, :, 1], tw[idx], dit)
        rows = torch.stack([lo, hi], dim=2).reshape(rows.shape)
    return rows.reshape(x.shape)


def run_plain(domain, a: torch.Tensor, decimation: str, inverse: bool
              ) -> torch.Tensor:
    """The whole transform stage by stage with plain tensor code."""
    tw0 = domain.twiddles0_inv if inverse else domain.twiddles0
    k, dit = domain.k, decimation == DIT
    for s in (range(k - 1, -1, -1) if dit else range(k)):
        a = stage_plain(domain.spec, a, tw0, k, s, dit)
    return a


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(spec: FieldSpec, what: str, *ts: torch.Tensor) -> None:
    if spec.n_words != 1 or spec.limb_bits != 32:
        raise NotImplementedError(f"{what}: {spec.name} is not a 31-bit "
                                  "field")
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{what}: expected int32 (n,), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != ts[0].device or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must share one device and be "
                             "contiguous")


def _launch_stage(spec, x, tw0, k, s, stages, dit, what):
    _check(spec, what, x, tw0)
    if x.shape[0] != 1 << k or tw0.shape[0] < (1 << k) >> 1 or not (
            0 <= s and s + stages <= k):
        raise ValueError(f"{what}: expected 2^{k} elements, 2^{k - 1} "
                         f"twiddles and stages {s}..{s + stages - 1} < {k}")
    out = torch.empty_like(x)
    fn = build.function("ntt_f31", "gct_ntt_f31_stage", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_void_p])
    return out, fn, (x.data_ptr(), out.data_ptr(), tw0.data_ptr(), k, s,
                     stages, int(dit), spec.modulus, spec.qinv32,
                     build.stream_ptr(x))


def stage(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor, k: int,
          s: int, dit: bool) -> torch.Tensor:
    """One butterfly stage of a size-2^k transform (``ntt_f31_stage``,
    R = 1)."""
    if not x.is_cuda:
        return stage_plain(spec, x, tw0, k, s, dit)
    out, fn, args = _launch_stage(spec, x, tw0, k, s, 1, dit, "ntt_f31_stage")
    stage.launches += 1
    build.check(fn(*args), "ntt_f31_stage launch")
    return out


def stage_r4(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor, k: int,
             s: int, dit: bool) -> torch.Tensor:
    """Stages s and s + 1 in one pass (``ntt_f31_stage``, R = 2)."""
    if not x.is_cuda:
        return stage_r4_plain(spec, x, tw0, k, s, dit)
    out, fn, args = _launch_stage(spec, x, tw0, k, s, 2, dit,
                                  "ntt_f31_stage r4")
    stage_r4.launches += 1
    build.check(fn(*args), "ntt_f31_stage r4 launch")
    return out


def block(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, tw_shift: int,
          log_n: int, dit: bool) -> torch.Tensor:
    """Every stage of each contiguous 2^log_n block (``ntt_f31_block``)."""
    if not x.is_cuda:
        return block_plain(spec, x, tw, tw_shift, log_n, dit)
    _check(spec, "ntt_f31_block", x, tw)
    if log_n > TILE_LOG or x.shape[0] % (1 << log_n) or x.shape[0] == 0:
        raise ValueError(f"ntt_f31_block: {x.shape[0]} elements are not a "
                         f"multiple of 2^{log_n}, or 2^{log_n} exceeds the "
                         "tile")
    if tw.shape[0] < (1 << (log_n + tw_shift)) >> 1:
        raise ValueError("ntt_f31_block: twiddle table too short")
    out = torch.empty_like(x)
    fn = build.function("ntt_f31", "gct_ntt_f31_block", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_void_p])
    block.launches += 1
    build.check(fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_shift,
                   log_n, x.shape[0], int(dit), spec.modulus, spec.qinv32,
                   build.stream_ptr(x)), "ntt_f31_block launch")
    return out


stage.launches = 0
stage_r4.launches = 0
block.launches = 0


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def run(domain, a: torch.Tensor, decimation: str, inverse: bool
        ) -> torch.Tensor:
    """The raw stages of one transform (no 1/n scale), on the kernels for a
    CUDA tensor: the wide stages in radix-4 pairs and one radix-2 pass for
    an odd one, then (DIF) or first (DIT) the fused block of
    t = min(k, TILE_LOG) stages."""
    spec, k = domain.spec, domain.k
    if k == 0:
        return a.clone()
    tw0 = domain.twiddles0_inv if inverse else domain.twiddles0
    t = min(k, TILE_LOG)
    s0 = k - t
    if decimation == DIF:
        s = 0
        while s + 1 < s0:
            a = stage_r4(spec, a, tw0, k, s, False)
            s += 2
        if s < s0:
            a = stage(spec, a, tw0, k, s, False)
        return block(spec, a, tw0, s0, t, False)
    a = block(spec, a, tw0, s0, t, True)
    s = s0 - 1
    while s >= 1:
        a = stage_r4(spec, a, tw0, k, s - 1, True)
        s -= 2
    if s == 0:
        a = stage(spec, a, tw0, k, 0, True)
    return a


def run_batch_small(domain, a2: torch.Tensor, decimation: str,
                    inverse: bool) -> torch.Tensor:
    """B independent size-n transforms of ``a2`` (B, n), n <= 2^TILE_LOG,
    in one :func:`block` pass (raw stages, no 1/n scale): the shape of the
    Ring-SIS hash."""
    B, n = a2.shape
    if n != domain.n or domain.k > TILE_LOG:
        raise ValueError(f"run_batch_small: rows of {n} for a domain of "
                         f"{domain.n} (at most 2^{TILE_LOG})")
    if domain.k == 0:
        return a2.clone()
    tw0 = domain.twiddles0_inv if inverse else domain.twiddles0
    flat = a2.reshape(B * n).contiguous()
    return block(domain.spec, flat, tw0, 0, domain.k,
                 decimation == DIT).reshape(B, n)
