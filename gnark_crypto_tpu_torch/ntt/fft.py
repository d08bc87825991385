"""Radix-2 NTT over word tensors: the public transforms.

Counterpart of ``gnark_crypto_tpu/ntt/fft.py`` (reference
``ecc/bn254/fr/fft/fft.go``), with the same semantics, output for output:

  * ``fft(a, DIF)``  : natural-order input  -> bit-reversed output
  * ``fft(a, DIT)``  : bit-reversed input   -> natural-order output
  * ``fft_inverse``  : same decimations with inverse twiddles + 1/n scale
  * ``coset=True``   : evaluate on u*<g>: pre-scale by u^i (DIF) /
    u^bitrev(i) (DIT); the inverse post-scales by u^-i

A transform runs where its input lives (the domain's device). Dispatch
follows the JAX package: the four-step path (``ntt/four_step.py``) for
(DIF, forward) and (DIT, inverse) when it supports n, else the radix-2 path
(``ntt/radix2.py``). On the card those are the NTT kernels; on the CPU the
same steps run their plain versions.
"""

from __future__ import annotations

import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.ntt import four_step, radix2
from gnark_crypto_tpu_torch.ntt.domain import Domain, bitrev_perm

DIF = radix2.DIF
DIT = radix2.DIT


def bit_reverse(a: torch.Tensor) -> torch.Tensor:
    """Bit-reversal permutation along the leading axis (one gather)."""
    perm = torch.from_numpy(bitrev_perm(a.shape[0])).to(a.device)
    return a[perm]


def _check_input(domain: Domain, a: torch.Tensor) -> torch.Tensor:
    if a.shape != (domain.n, domain.spec.n_words) or a.dtype != torch.int32:
        raise ValueError(f"expected int32 ({domain.n}, "
                         f"{domain.spec.n_words}), got {a.dtype} "
                         f"{tuple(a.shape)}")
    if a.device != domain.device:
        raise ValueError(f"input on {a.device}, domain on {domain.device}")
    return a.contiguous()


def _run(domain: Domain, a: torch.Tensor, decimation: str, inverse: bool):
    """Returns (out, scale_folded): the four-step inverse folds the 1/n
    scale into its twist table, so callers skip the separate scale when
    scale_folded is True."""
    if four_step.supported(domain, decimation, inverse):
        return four_step.run(domain, a, decimation, inverse), inverse
    return radix2.run(domain, a, decimation, inverse), False


def fft(domain: Domain, a: torch.Tensor, decimation: str = DIF,
        coset: bool = False) -> torch.Tensor:
    """Forward NTT; layout conventions as in the module docstring."""
    a = _check_input(domain, a)
    if coset:
        table = domain.coset_table
        if decimation == DIT:
            table = bit_reverse(table)
        a = mont.mul(domain.spec, a, table)
    out, _ = _run(domain, a, decimation, inverse=False)
    return out


def fft_inverse(domain: Domain, a: torch.Tensor, decimation: str = DIF,
                coset: bool = False) -> torch.Tensor:
    """Inverse NTT (+ 1/n scale; + coset unscale when coset=True)."""
    spec = domain.spec
    a, scale_folded = _run(domain, _check_input(domain, a), decimation,
                           inverse=True)
    if not coset:
        return a if scale_folded else mont.mul(spec, a,
                                               domain.cardinality_inv)
    table = domain.coset_table_inv
    if decimation == DIF:
        table = bit_reverse(table)
    scale = table if scale_folded else mont.mul(spec, table,
                                                domain.cardinality_inv)
    return mont.mul(spec, a, scale)


def fft_batch(domain: Domain, a: torch.Tensor, decimation: str = DIF,
              coset: bool = False, inverse: bool = False) -> torch.Tensor:
    """Transform a batch of B polynomials, ``a``: (B, n, W), one row at a
    time as the JAX TPU path does (the reference's per-polynomial
    ``domain.FFT`` calls in a loop)."""
    fn = fft_inverse if inverse else fft
    return torch.stack([fn(domain, a[i], decimation, coset)
                        for i in range(a.shape[0])], dim=0)
