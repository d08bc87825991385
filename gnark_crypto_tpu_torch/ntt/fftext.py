"""NTT over extension-field vectors.

Counterpart of ``gnark_crypto_tpu/ntt/fftext.py`` (reference
``field/<f>/fft/fftext.go``). The DFT is linear over the base field, so a
transform of an E2/E4/E6 vector is one base-field transform per
coefficient slot: the slots become the rows of one ``fft.fft_batch`` call
(one block-kernel pass on the card for a small field and n within a tile),
where the JAX package vmaps its ``fft`` over them.
"""

from __future__ import annotations

import torch

from gnark_crypto_tpu_torch.ntt import fft as fftm
from gnark_crypto_tpu_torch.ntt.domain import Domain


def _slots(domain: Domain, a: torch.Tensor) -> torch.Tensor:
    """(n, *ext_dims, *base) -> (d, n, *base), d = prod(ext_dims)."""
    base = a.shape[a.dim() - domain.eng.elem_dims:]
    flat = a.reshape(domain.n, -1, *base)
    return flat.transpose(0, 1).contiguous()


def _unslot(out: torch.Tensor, shape) -> torch.Tensor:
    return out.transpose(0, 1).reshape(shape)


def fft_ext(domain: Domain, a: torch.Tensor, decimation: str = fftm.DIF,
            coset: bool = False) -> torch.Tensor:
    """a: (n, *ext_dims, *base_elem_dims) Montgomery -> same shape."""
    return _unslot(fftm.fft_batch(domain, _slots(domain, a), decimation,
                                  coset), a.shape)


def fft_inverse_ext(domain: Domain, a: torch.Tensor,
                    decimation: str = fftm.DIF, coset: bool = False
                    ) -> torch.Tensor:
    return _unslot(fftm.fft_batch(domain, _slots(domain, a), decimation,
                                  coset, inverse=True), a.shape)
