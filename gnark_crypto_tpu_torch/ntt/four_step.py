"""Kernel 3: the four-step NTT, and its plain PyTorch version.

n = S1 * S2 with k1 = k - k//2, k2 = k//2, element i = h * S2 + l:

* forward DIF: S2 DIF sub-NTTs of size S1 over h (the columns, root
  w^S2), each output multiplied by the twist w^(l * rev_S1(h)); then S1 DIF
  sub-NTTs of size S2 over l (the rows, root w^S1). The result lands in the
  global bit-reversed DIF order, rev_n(kh + S1 kl) = rev_S1(kh) S2 +
  rev_S2(kl), so it equals the radix-2 output element for element.
* inverse DIT: the mirror. Row sub-NTTs (DIT, root w^-S1) with the twist
  by w^-(l * rev_S1(h)) / n fused after them, then column sub-NTTs (DIT,
  root w^-S2). The 1/n scale is folded into the twist table, so
  ``fft_inverse`` must not scale again (``scale_folded``).

Each step is one launch of :func:`sub_ntt` (``csrc/ntt_four_step.cu``): one
block per sub-NTT holding its whole row in shared memory, the columns read
in place at stride S2 (no transpose). A CPU tensor runs
:func:`sub_ntt_plain` instead, which transposes and runs
``radix2.rows_plain``.

Replaces the Pallas kernels of ``gnark_crypto_tpu/ntt/pallas_ntt4.py``
``run_stages_four_step``, which serves the same two pairs from n = 2^14 up.
Here the sub-NTT rows must fit shared memory (S1 <= 2^12), so the four-step
path serves 2^14 <= n <= 2^24 and larger transforms take the radix-2 path.
"""

from __future__ import annotations

import ctypes

import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.kernels import (
    check_kernel_args, count_launch, mont_mul_plain)
from gnark_crypto_tpu_torch.ntt import radix2
from gnark_crypto_tpu_torch.ntt.domain import bitrev_perm, exp_table
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.utils import build

MIN_LOG = 14   # S1, S2 >= 128, as the TPU path
# 2^12 elements a sub-NTT: 4W << 12 bytes of shared memory (128, 160 and
# 192 KB at 8, 10 and 12 words, within the H100's 227 KB a block)
MAX_SUB_LOG = 12


def supported(domain, decimation: str, inverse: bool) -> bool:
    """(DIF, forward) or (DIT, inverse) with 2^14 <= n <= 2^24."""
    k = domain.k
    ok_dir = ((decimation == radix2.DIF and not inverse)
              or (decimation == radix2.DIT and inverse))
    return ok_dir and MIN_LOG <= k and k - k // 2 <= MAX_SUB_LOG


def tables(domain, inverse: bool):
    """(k1, k2, tw1, tw2, twist) for this domain and direction, built once
    on the domain's device and kept on the domain: tw1[j] = w1^j (j < S1/2,
    w1 = w^S2), tw2[j] = w2^j (j < S2/2, w2 = w^S1), twist[h * S2 + l] =
    w^(l * rev_S1(h)), times 1/n for the inverse."""
    key = ("four_step", inverse)
    if key in domain.tables:
        return domain.tables[key]
    spec, dev, k = domain.spec, domain.device, domain.k
    q = spec.modulus
    k2 = k // 2
    k1 = k - k2
    S1, S2 = 1 << k1, 1 << k2
    w = domain.generator_inv_int if inverse else domain.generator_int
    tw1 = exp_table(spec, mont.from_int(spec, pow(w, S2, q), device=dev),
                    max(S1 // 2, 1))
    tw2 = exp_table(spec, mont.from_int(spec, pow(w, S1, q), device=dev),
                    max(S2 // 2, 1))
    # twist: T[h * S2 + l] = base_h^l, base_h = w^rev(h), by log-doubling
    bases = mont.from_int(spec, [pow(w, int(r), q)
                                 for r in bitrev_perm(S1)], device=dev)
    wp = bases.repeat_interleave(S2, dim=0)
    lo = torch.arange(S2, device=dev).repeat(S1)
    twist = mont.ones(spec, (S1 * S2,), device=dev)
    for bit in range(k2):
        twist = mont.select(spec, ((lo >> bit) & 1) == 1,
                            mont.mul(spec, twist, wp), twist)
        if bit != k2 - 1:
            wp = mont.square(spec, wp)
    del wp, lo
    if inverse:
        twist = mont.mul(spec, twist, domain.cardinality_inv)
    out = (k1, k2, tw1, tw2, twist.contiguous())
    domain.tables[key] = out
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _view_rows(x: torch.Tensor, log_s: int, other: int, columns: bool,
               W: int) -> torch.Tensor:
    if columns:  # row r = column r of the (S, other) view
        return x.reshape(1 << log_s, other, W).transpose(0, 1)
    return x.reshape(other, 1 << log_s, W)


def sub_ntt_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
                  log_s: int, other: int, columns: bool, dit: bool,
                  twist: torch.Tensor | None = None) -> torch.Tensor:
    """``other`` sub-NTTs of size S = 2^log_s: over the rows of the
    (other, S) view (columns=False) or the columns of the (S, other) view
    (columns=True); then the optional twist at each element's position."""
    W = spec.n_words
    rows = _view_rows(x, log_s, other, columns, W).contiguous()
    out = radix2.rows_plain(spec, rows, tw, 0, dit)
    if twist is not None:
        out = mont_mul_plain(spec, out,
                             _view_rows(twist, log_s, other, columns, W))
    if columns:
        out = out.transpose(0, 1)
    return out.reshape(x.shape).contiguous()


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def sub_ntt(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, log_s: int,
            other: int, columns: bool, dit: bool,
            twist: torch.Tensor | None = None) -> torch.Tensor:
    """One four-step step (``gct_ntt_four_step``): CUDA tensors launch the
    kernel, CPU tensors run :func:`sub_ntt_plain`."""
    if not x.is_cuda:
        return sub_ntt_plain(spec, x, tw, log_s, other, columns, dit, twist)
    check_kernel_args(spec, "ntt_four_step",
                      *([x, tw] + ([] if twist is None else [twist])),
                      widths=radix2.WIDTHS)
    n = x.shape[0]
    if (log_s > MAX_SUB_LOG or n != other << log_s
            or tw.shape[0] < max(1, (1 << log_s) >> 1)
            or (twist is not None and twist.shape[0] != n)):
        raise ValueError(f"sub_ntt: bad shapes n={n}, 2^{log_s} x {other}")
    radix2.block_geometry(spec.n_words, log_s)
    out = torch.empty_like(x)
    fn = build.function("ntt_four_step", "gct_ntt_four_step", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    count_launch(sub_ntt, spec)
    build.check(fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(), log_s, other,
                   int(columns), None if twist is None else twist.data_ptr(),
                   int(dit), spec.n_words, build.field_words(spec),
                   build.stream_ptr(x)),
                "ntt_four_step launch")
    return out


sub_ntt.launches = 0
sub_ntt.launches_by_width = {}


def run(domain, a: torch.Tensor, decimation: str, inverse: bool
        ) -> torch.Tensor:
    """The four-step transform for a supported (decimation, direction);
    the inverse includes the 1/n scale."""
    if not supported(domain, decimation, inverse):
        raise ValueError("four-step supports (DIF, forward) and "
                         "(DIT, inverse) for 2^14 <= n <= 2^24")
    spec = domain.spec
    k1, k2, tw1, tw2, twist = tables(domain, inverse)
    S1, S2 = 1 << k1, 1 << k2
    if not inverse:
        x = sub_ntt(spec, a, tw1, k1, S2, columns=True, dit=False,
                    twist=twist)
        return sub_ntt(spec, x, tw2, k2, S1, columns=False, dit=False)
    x = sub_ntt(spec, a, tw2, k2, S1, columns=False, dit=True, twist=twist)
    return sub_ntt(spec, x, tw1, k1, S2, columns=True, dit=True)
