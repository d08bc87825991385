"""GLV scalar decomposition.

Counterpart of ``gnark_crypto_tpu/curve/glv.py`` (reference
``ecc/utils.go:243 SplitScalar``), so far :func:`split_scalar` only, which
the GT Frobenius-GLV exponentiation (``towers/tower12.py`` gt_exp_glv)
needs. The G1 GLV ladder comes with the KZG slice (ROADMAP.md).
"""

from __future__ import annotations


def split_scalar(k: int, lam: int, basis, r: int):
    """k -> (k1, k2) with k = k1 + k2*lam (mod r), both ~ sqrt(r).

    Babai rounding against a Gauss-reduced lattice basis (ecc/utils.go:243
    SplitScalar semantics; signs carried in the values)."""
    (a1, b1), (a2, b2) = basis
    det = a1 * b2 - a2 * b1  # = +-r
    # solve (k, 0) = c1*(a1,b1) + c2*(a2,b2) over Q, then round
    c1 = _round_div(b2 * k, det)
    c2 = _round_div(-b1 * k, det)
    k1 = k - c1 * a1 - c2 * a2
    k2 = -(c1 * b1 + c2 * b2)
    assert (k1 + k2 * lam - k) % r == 0
    return k1, k2


def _round_div(num: int, den: int) -> int:
    """round(num/den) with exact integer arithmetic."""
    if den < 0:
        num, den = -num, -den
    q, rem = divmod(num, den)
    return q + (1 if 2 * rem >= den else 0)
