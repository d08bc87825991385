"""GT (pairing target group) byte codecs, bit-compatible with gnark-crypto.

Counterpart of ``gnark_crypto_tpu/io/gt_bytes.py``. Reference layouts (each
coefficient is a canonical big-endian base-field element of ``fp.Bytes``):

  * E12 (bn254, bls12-381, bls12-377): REVERSED flat coefficient order —
    C1.B2.A1 first, C0.B0.A0 last (``ecc/bn254/internal/fptower/e12.go:663``).
  * E24 (bls24-315, bls24-317): NATURAL order — D0.C0.B0.A0 first
    (``ecc/bls24-315/internal/fptower/e24.go:650``).
  * E6 direct (bw6-761, bw6-633): REVERSED — B1.A2 first, B0.A0 last
    (``ecc/bw6-761/internal/fptower/e6.go:653``).

In-memory layouts ravel naturally: E12 ``(..., 2, 3, 2, W)`` = [C][B][A],
E24 ``(..., 2, 3, 2, 2, W)`` = [D][C][B][A], E6 ``(..., 2, 3, W)`` =
[B][A] — so encoding is a flat ravel, optionally reversed, of
per-coefficient canonical bytes.
"""

from __future__ import annotations

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.specs.curve import get_curve
from gnark_crypto_tpu_torch.specs.field import FieldSpec

# family -> (n GT coefficients over fp, natural byte order?)
_GT_LAYOUT = {
    "bn254": (12, False),
    "bls12_381": (12, False),
    "bls12_377": (12, False),
    "bls24_315": (24, True),
    "bls24_317": (24, True),
    "bw6_761": (6, False),
    "bw6_633": (6, False),
}


def _fp_spec(name: str) -> FieldSpec:
    return get_curve(f"{name}_g1").fp


def gt_size(name: str) -> int:
    """SizeOfGT (e12.go:647): n_coeffs * fp byte length."""
    n, _ = _GT_LAYOUT[name]
    return n * _fp_spec(name).n_bytes


def gt_to_bytes(name: str, z, mont_form: bool = True) -> list[bytes]:
    """GT element(s) -> gnark ``Bytes()`` encoding; returns one bytes per
    batch element (a single unbatched element yields a 1-list)."""
    n, natural = _GT_LAYOUT[name]
    spec = _fp_spec(name)
    rows = mont.to_bytes_host(spec, z.reshape(-1, spec.n_words),
                              mont=mont_form)
    order = range(n) if natural else range(n - 1, -1, -1)
    return [b"".join(rows[i * n + j] for j in order)
            for i in range(len(rows) // n)]


def gt_from_bytes(name: str, data: bytes, device=mont.DEFAULT_DEVICE):
    """gnark GT bytes -> GT element (Montgomery form, unbatched) on device."""
    n, natural = _GT_LAYOUT[name]
    spec = _fp_spec(name)
    nb = spec.n_bytes
    if len(data) != n * nb:
        raise ValueError(f"invalid GT buffer size {len(data)} != {n * nb}")
    chunks = [data[i * nb:(i + 1) * nb] for i in range(n)]
    if not natural:
        chunks = chunks[::-1]
    # from_bytes_host enforces canonical (< q) encodings, like SetBytes
    flat = mont.from_bytes_host(spec, chunks, device=device)
    shape = (2, 3, 2) if n == 12 else (2, 3, 2, 2) if n == 24 else (2, 3)
    return flat.reshape(*shape, spec.n_words)
