"""The goldilocks NTT on its kernels, and their plain versions.

Counterpart of ``gnark_crypto_tpu/ntt/pallas_ntt_f64.py``:
``run_stages_pallas_f64`` is :func:`run`, ``run_batch_small_f64`` is
:func:`run_batch_small`. Elements are the f64 engine's ``int32[n, 2]``
words of Montgomery values (``field/f64.py``); the kernels read each pair
as one uint64. Stage s pairs ``lo`` and ``lo + half`` (half = n >> (s + 1))
with twiddle ``tw0[(lo mod half) << s]``:

* DIF: (a + b, (a - b) w), stages 0 .. k-1, natural order in, bit-reversed
  out;
* DIT: (a + w b, a - w b), stages k-1 .. 0, bit-reversed in, natural out.

On the card, each stage whose half-block is wider than a shared-memory
tile runs as one :func:`stage` pass (``ntt_f64_stage``); the last
t = min(k, TILE_LOG) stages (DIF) or the first (DIT) run in one
:func:`block` pass (``ntt_f64_block``), which also runs a whole batch of
small transforms in one launch. On the CPU the same wrappers run their
plain versions, so both devices take the same steps. :func:`run_plain` is
the transform stage by stage with plain tensor code, the reference the
kernels are held against. See ``csrc/ntt_f64.cu`` for the bound.
"""

from __future__ import annotations

import ctypes

import torch

from gnark_crypto_tpu_torch.field import f64
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.utils import build

DIF = "DIF"
DIT = "DIT"
TILE_LOG = 12  # 2^12 elements = 32 KB of shared memory per block


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def butterfly_plain(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor,
                    tw: torch.Tensor, dit: bool):
    if dit:
        hi = f64.mul(spec, hi, tw)
        return f64.add(spec, lo, hi), f64.sub(spec, lo, hi)
    return f64.add(spec, lo, hi), f64.mul(spec, f64.sub(spec, lo, hi), tw)


def stage_plain(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor, k: int,
                s: int, dit: bool) -> torch.Tensor:
    """Butterfly stage s of a size-2^k transform."""
    half = (1 << k) >> (s + 1)
    v = x.reshape(1 << s, 2, half, 2)
    lo, hi = butterfly_plain(spec, v[:, 0], v[:, 1], tw0[:: 1 << s][:half],
                             dit)
    return torch.stack([lo, hi], dim=1).reshape(x.shape)


def block_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
                tw_shift: int, log_n: int, dit: bool) -> torch.Tensor:
    """Every stage of each contiguous 2^log_n block of x (flat); local
    stage s uses twiddle tw[(off << s) << tw_shift]."""
    n = 1 << log_n
    rows = x.reshape(-1, n, 2)
    for s in (range(log_n - 1, -1, -1) if dit else range(log_n)):
        half = n >> (s + 1)
        v = rows.reshape(rows.shape[0], 1 << s, 2, half, 2)
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

def _args(spec: FieldSpec, what: str, *ts: torch.Tensor) -> tuple:
    """Checks the tensors and returns (q, -q^-1 mod 2^64) for the kernel."""
    if spec.n_words != 2 or spec.limb_bits != 32:
        raise NotImplementedError(f"{what}: {spec.name} is not goldilocks")
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 2:
            raise ValueError(f"{what}: expected int32 (n, 2), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if (t.device != ts[0].device or not t.is_contiguous()
                or t.data_ptr() % 8):
            raise ValueError(f"{what}: tensors must share one device and be "
                             "contiguous and 8-byte aligned")
    q = spec.modulus
    return q, (-pow(q, -1, 1 << 64)) % (1 << 64)


def stage(spec: FieldSpec, x: torch.Tensor, tw0: torch.Tensor, k: int,
          s: int, dit: bool) -> torch.Tensor:
    """One butterfly stage of a size-2^k transform (``ntt_f64_stage``)."""
    if not x.is_cuda:
        return stage_plain(spec, x, tw0, k, s, dit)
    q, qinv = _args(spec, "ntt_f64_stage", x, tw0)
    if x.shape[0] != 1 << k or tw0.shape[0] < (1 << k) >> 1 or not (
            0 <= s < k):
        raise ValueError(f"ntt_f64_stage: expected 2^{k} elements, "
                         f"2^{k - 1} twiddles and stage {s} < {k}")
    out = torch.empty_like(x)
    fn = build.function("ntt_f64", "gct_ntt_f64_stage", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p])
    stage.launches += 1
    build.check(fn(x.data_ptr(), out.data_ptr(), tw0.data_ptr(), k, s,
                   int(dit), q, qinv, build.stream_ptr(x)),
                "ntt_f64_stage launch")
    return out


def block(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, tw_shift: int,
          log_n: int, dit: bool) -> torch.Tensor:
    """Every stage of each contiguous 2^log_n block (``ntt_f64_block``)."""
    if not x.is_cuda:
        return block_plain(spec, x, tw, tw_shift, log_n, dit)
    q, qinv = _args(spec, "ntt_f64_block", x, tw)
    if log_n > TILE_LOG or x.shape[0] % (1 << log_n) or x.shape[0] == 0:
        raise ValueError(f"ntt_f64_block: {x.shape[0]} elements are not a "
                         f"multiple of 2^{log_n}, or 2^{log_n} exceeds the "
                         "tile")
    if tw.shape[0] < (1 << (log_n + tw_shift)) >> 1:
        raise ValueError("ntt_f64_block: twiddle table too short")
    out = torch.empty_like(x)
    fn = build.function("ntt_f64", "gct_ntt_f64_block", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_void_p])
    block.launches += 1
    build.check(fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_shift,
                   log_n, x.shape[0], int(dit), q, qinv,
                   build.stream_ptr(x)), "ntt_f64_block launch")
    return out


stage.launches = 0
block.launches = 0


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def run(domain, a: torch.Tensor, decimation: str, inverse: bool
        ) -> torch.Tensor:
    """The raw stages of one transform (no 1/n scale), on the kernels for a
    CUDA tensor: one pass per wide stage, then (DIF) or first (DIT) the
    fused block of t = min(k, TILE_LOG) stages."""
    spec, k = domain.spec, domain.k
    if k == 0:
        return a.clone()
    tw0 = domain.twiddles0_inv if inverse else domain.twiddles0
    t = min(k, TILE_LOG)
    s0 = k - t
    if decimation == DIF:
        for s in range(s0):
            a = stage(spec, a, tw0, k, s, False)
        return block(spec, a, tw0, s0, t, False)
    a = block(spec, a, tw0, s0, t, True)
    for s in range(s0 - 1, -1, -1):
        a = stage(spec, a, tw0, k, s, True)
    return a


def run_batch_small(domain, a3: torch.Tensor, decimation: str,
                    inverse: bool) -> torch.Tensor:
    """B independent size-n transforms of ``a3`` (B, n, 2),
    n <= 2^TILE_LOG, in one :func:`block` pass (raw stages, no 1/n scale):
    the shape of the Ring-SIS hash."""
    B, n = a3.shape[:2]
    if n != domain.n or domain.k > TILE_LOG:
        raise ValueError(f"run_batch_small: rows of {n} for a domain of "
                         f"{domain.n} (at most 2^{TILE_LOG})")
    if domain.k == 0:
        return a3.clone()
    tw0 = domain.twiddles0_inv if inverse else domain.twiddles0
    flat = a3.reshape(B * n, 2).contiguous()
    return block(domain.spec, flat, tw0, 0, domain.k,
                 decimation == DIT).reshape(B, n, 2)
