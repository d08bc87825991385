"""Radix-2 NTT over field tensors: the public transforms.

Counterpart of ``gnark_crypto_tpu/ntt/fft.py`` (reference
``ecc/bn254/fr/fft/fft.go``), with the same semantics, output for output:

  * ``fft(a, DIF)``  : natural-order input  -> bit-reversed output
  * ``fft(a, DIT)``  : bit-reversed input   -> natural-order output
  * ``fft_inverse``  : same decimations with inverse twiddles + 1/n scale
  * ``coset=True``   : evaluate on u*<g>: pre-scale by u^i (DIF) /
    u^bitrev(i) (DIT); the inverse post-scales by u^-i

A transform runs where its input lives (the domain's device), over the
domain's engine: ``(n,)`` int32 for koalabear/babybear, ``(n, 2)`` words
for goldilocks, ``(n, W)`` words for the multi-word fields. Dispatch
follows the JAX package: the small fields go to their own kernels
(``ntt/radix2_f31.py``, ``ntt/radix2_f64.py``); the multi-word fields to
the four-step path (``ntt/four_step.py``) for (DIF, forward) and (DIT,
inverse) when it supports n, else the radix-2 path (``ntt/radix2.py``). On
the card those are the NTT kernels; on the CPU the same steps run their
plain versions.
"""

from __future__ import annotations

import torch

from gnark_crypto_tpu_torch.field import f31, f64
from gnark_crypto_tpu_torch.ntt import four_step, radix2, radix2_f31, \
    radix2_f64
from gnark_crypto_tpu_torch.ntt.domain import Domain, bitrev_perm

DIF = radix2.DIF
DIT = radix2.DIT

_SMALL = {f31: radix2_f31, f64: radix2_f64}  # engine -> its NTT module


def bit_reverse(a: torch.Tensor) -> torch.Tensor:
    """Bit-reversal permutation along the leading axis (one gather)."""
    perm = torch.from_numpy(bitrev_perm(a.shape[0])).to(a.device)
    return a[perm]


def _elem_tail(domain: Domain) -> tuple[int, ...]:
    return (domain.spec.n_words,) if domain.eng.elem_dims else ()


def _check_input(domain: Domain, a: torch.Tensor, lead=()) -> torch.Tensor:
    shape = (*lead, domain.n, *_elem_tail(domain))
    if tuple(a.shape) != shape or a.dtype != torch.int32:
        raise ValueError(f"expected int32 {shape}, got {a.dtype} "
                         f"{tuple(a.shape)}")
    if a.device != domain.device:
        raise ValueError(f"input on {a.device}, domain on {domain.device}")
    return a.contiguous()


def _run(domain: Domain, a: torch.Tensor, decimation: str, inverse: bool):
    """Returns (out, scale_folded): the four-step inverse folds the 1/n
    scale into its twist table, so callers skip the separate scale when
    scale_folded is True."""
    small = _SMALL.get(domain.eng.impl)
    if small is not None:
        return small.run(domain, a, decimation, inverse), False
    if four_step.supported(domain, decimation, inverse):
        return four_step.run(domain, a, decimation, inverse), inverse
    return radix2.run(domain, a, decimation, inverse), False


def _coset_in(domain: Domain, decimation: str) -> torch.Tensor:
    """The forward coset pre-scale: u^i (DIF) or u^bitrev(i) (DIT)."""
    table = domain.coset_table
    return bit_reverse(table) if decimation == DIT else table


def _inverse_scale(domain: Domain, decimation: str, coset: bool,
                   scale_folded: bool) -> torch.Tensor | None:
    """The inverse post-scale: 1/n, times u^-i (DIT) or u^-bitrev(i) (DIF)
    for a coset; None when there is nothing to apply."""
    if not coset:
        return None if scale_folded else domain.cardinality_inv
    table = domain.coset_table_inv
    if decimation == DIF:
        table = bit_reverse(table)
    return table if scale_folded else domain.eng.mul(
        table, domain.cardinality_inv)


def fft(domain: Domain, a: torch.Tensor, decimation: str = DIF,
        coset: bool = False) -> torch.Tensor:
    """Forward NTT; layout conventions as in the module docstring."""
    a = _check_input(domain, a)
    if coset:
        a = domain.eng.mul(a, _coset_in(domain, decimation))
    out, _ = _run(domain, a, decimation, inverse=False)
    return out


def fft_inverse(domain: Domain, a: torch.Tensor, decimation: str = DIF,
                coset: bool = False) -> torch.Tensor:
    """Inverse NTT (+ 1/n scale; + coset unscale when coset=True)."""
    a, scale_folded = _run(domain, _check_input(domain, a), decimation,
                           inverse=True)
    scale = _inverse_scale(domain, decimation, coset, scale_folded)
    return a if scale is None else domain.eng.mul(a, scale)


def fft_batch(domain: Domain, a: torch.Tensor, decimation: str = DIF,
              coset: bool = False, inverse: bool = False) -> torch.Tensor:
    """Transform a batch of B polynomials along axis 1: ``a`` is (B, n)
    for koalabear/babybear, (B, n, 2) for goldilocks, (B, n, W) for the
    multi-word fields.

    On a small field with n within one shared-memory tile the whole batch
    is one ``run_batch_small`` pass (one block-kernel launch on the card),
    with the coset and 1/n scales as batched products; otherwise one row
    at a time, as the JAX TPU path does (the reference's per-polynomial
    ``domain.FFT`` calls in a loop). Both give every row's ``fft`` output."""
    small = _SMALL.get(domain.eng.impl)
    if small is None or domain.k > small.TILE_LOG:
        fn = fft_inverse if inverse else fft
        return torch.stack([fn(domain, a[i], decimation, coset)
                            for i in range(a.shape[0])], dim=0)
    eng = domain.eng
    a = _check_input(domain, a, lead=(a.shape[0],))
    if not inverse:
        if coset:
            a = eng.mul(a, _coset_in(domain, decimation))
        return small.run_batch_small(domain, a, decimation, False)
    out = small.run_batch_small(domain, a, decimation, True)
    return eng.mul(out, _inverse_scale(domain, decimation, coset, False))
