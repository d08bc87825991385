"""Engine-generic parallel scans on word tensors (log-stride).

Counterpart of ``gnark_crypto_tpu/utils/scans.py``: the same scans over
any engine of the field protocol (``field/api.py``, or an extension
engine), run where their operands live, and the log-stride prefix product
that the reference writes inline in ``protocols/iop.py`` and
``protocols/permutation.py``.
"""

from __future__ import annotations

import torch


def prefix_sum(eng, x: torch.Tensor) -> torch.Tensor:
    """Inclusive modular prefix sum along the leading element axis
    (Hillis-Steele: log2(N) elementwise modular additions)."""
    n = eng.eshape(x)[0]
    d = 1
    while d < n:
        x = torch.cat([x[:d], eng.add(x[d:], x[:-d])], dim=0)
        d *= 2
    return x


def prefix_product(eng, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along the leading element axis (Montgomery;
    Hillis-Steele: log2(N) batched products)."""
    n = eng.eshape(x)[0]
    d = 1
    while d < n:
        x = torch.cat([x[:d], eng.mul(x[d:], x[:-d])], dim=0)
        d *= 2
    return x


def exclusive_prefix_product(eng, x: torch.Tensor) -> torch.Tensor:
    """[1, x_0, x_0 x_1, ..., x_0 ... x_(N-2)] (Montgomery): the grand
    product accumulator Z of the copy-constraint and permutation
    arguments, Z_0 = 1."""
    z = prefix_product(eng, x)
    one = eng.ones((1,), device=x.device)
    return torch.cat([one, z[:-1]], dim=0)


def exp_table(eng, w: torch.Tensor, n: int) -> torch.Tensor:
    """[w^0 .. w^(n-1)] (Montgomery) for a single element w (shape () or
    (1,)): one masked product per bit of the index, so log2(n) products of
    the whole table."""
    nbits = max((n - 1).bit_length(), 1)
    idx = torch.arange(n, device=w.device)
    table = eng.ones((n,), device=w.device)
    wp = w[None] if eng.eshape(w) == () else w
    for bit in range(nbits):
        bit_set = ((idx >> bit) & 1) == 1
        table = eng.where(bit_set,
                          eng.mul(table, eng.broadcast_to(wp[0], (n,))),
                          table)
        wp = eng.square(wp)
    return table
