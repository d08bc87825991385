"""Multilinear (bookkeeping-table) polynomials for sumcheck/GKR protocols.

Counterpart of ``gnark_crypto_tpu/protocols/multilin.py`` (reference
``ecc/<curve>/fr/polynomial/multilin.go``): Fold (partial evaluation of the
first variable), Evaluate (repeated folds), EvalEq (the eq(q, h) Lagrange
kernel). Tables are Montgomery Fr words ``(2^k, W)`` on any device; each
fold is one batched product and two modular adds over the half table (the
reference parallelizes with a worker pool, multilin.go FoldParallel). On
the card the products run the ``mont_mul`` kernel.
"""

from __future__ import annotations

import torch

from gnark_crypto_tpu_torch.field.api import for_spec
from gnark_crypto_tpu_torch.specs.field import FieldSpec


def fold(spec: FieldSpec, table: torch.Tensor, r: torch.Tensor
         ) -> torch.Tensor:
    """table[i] <- table[i] + r*(table[i+mid] - table[i]); halves the table.
    table: (2^k, W) Montgomery; r: a Montgomery element (W,)."""
    eng = for_spec(spec)
    mid = table.shape[0] // 2
    bottom, top = table[:mid], table[mid:]
    return eng.add(bottom, eng.mul(eng.sub(top, bottom), r))


def evaluate(spec: FieldSpec, table: torch.Tensor, coords) -> torch.Tensor:
    """m(r_1, ..., r_k) by repeated folding (multilin.go Evaluate); coords
    is a sequence of Montgomery elements (or a (k, W) tensor). Returns a
    Montgomery element (W,)."""
    for r in coords:
        table = fold(spec, table, r)
    return table[0]


def eval_eq(spec: FieldSpec, q: torch.Tensor, h: torch.Tensor
            ) -> torch.Tensor:
    """eq(q, h) = prod_i (1 + 2 q_i h_i - q_i - h_i) (multilin.go EvalEq).
    q, h: (k, W) Montgomery; returns a Montgomery element (W,), the product
    taken as a pairwise tree."""
    eng = for_spec(spec)
    one = eng.ones((), device=q.device)
    terms = eng.sub(eng.add(eng.double(eng.mul(q, h)), one), eng.add(q, h))
    while terms.shape[0] > 1:
        half = terms.shape[0] // 2
        red = eng.mul(terms[:half], terms[half:2 * half])
        terms = torch.cat([red, terms[2 * half:]], dim=0)
    return terms[0]
