"""gnark-compatible point encoding (bit-exact byte formats), G1 and G2.

Counterpart of the encoding half of ``gnark_crypto_tpu/io/marshal.py``
(reference ``ecc/<curve>/marshal.go``). Flag bits in the 2 MSBs of the
first byte (marshal.go:24-30):

  00 uncompressed | 10 compressed smallest-Y | 11 compressed largest-Y |
  01 compressed infinity

The compressed payload is big-endian X (G2: X.A1 || X.A0, marshal.go G2
Bytes); uncompressed is X || Y. The largest-Y flag is the lexicographic
order of Y (element.go:277 LexicographicallyLargest: v > (q-1)/2, decided
on the highest nonzero coefficient), which needs no square root. Encoding
is host work on canonical integers. Decoding (``from_bytes``) needs the
Fp2 square root and the subgroup checks and is not ported yet (ROADMAP.md
queue 1, item 3).
"""

from __future__ import annotations

from gnark_crypto_tpu_torch.curve.jacobian import Affine, Curve

M_MASK = 0b11 << 6
M_UNCOMPRESSED = 0b00 << 6
M_COMPRESSED_SMALLEST = 0b10 << 6
M_COMPRESSED_LARGEST = 0b11 << 6
M_COMPRESSED_INFINITY = 0b01 << 6


class PointCodec:
    """Encoding for one group: G1, or G2 with an extension-engine curve
    (coefficient order from the engine's ``to_int`` tuples)."""

    def __init__(self, curve: Curve):
        self.curve = curve
        self.fp = curve.fp
        base, degree = self.fp, 1
        while not hasattr(base, "spec"):   # walk extensions down to Fp
            degree *= base.degree
            base = base.base
        self.q = base.spec.modulus
        self.nb = degree * base.spec.n_bytes

    def _coord_to_bytes(self, v, nb: int | None = None) -> bytes:
        """Coordinate (int or nested tuple) -> big-endian bytes, highest
        coefficient first, recursively (A1 || A0 for E2)."""
        nb = self.nb if nb is None else nb
        if isinstance(v, tuple):
            sub = nb // len(v)
            return b"".join(self._coord_to_bytes(c, sub) for c in reversed(v))
        return v.to_bytes(nb, "big")

    def _lex_largest(self, v) -> bool:
        """Lexicographic order decided on the highest nonzero coefficient
        (fptower LexicographicallyLargest)."""
        if isinstance(v, tuple):
            for c in reversed(v):
                if not _is_zero_coord(c):
                    return self._lex_largest(c)
            return False
        return v > (self.q - 1) // 2

    def _coords_list(self, t):
        """Per-point coordinates (int or nested tuple) of a batch."""
        v = _soa_to_aos(self.fp.to_int(t))
        return v if isinstance(v, list) else [v]

    def to_bytes(self, pts: Affine, raw: bool = False) -> list[bytes]:
        """Bytes() / RawBytes() (marshal.go:800,825) of an affine batch."""
        xs = self._coords_list(pts.x)
        ys = self._coords_list(pts.y)
        out = []
        for x, y in zip(xs, ys):
            inf = _is_zero_coord(x) and _is_zero_coord(y)
            if raw:
                if inf:
                    out.append(bytes([M_UNCOMPRESSED])
                               + b"\x00" * (2 * self.nb - 1))
                    continue
                buf = bytearray(self._coord_to_bytes(x)
                                + self._coord_to_bytes(y))
                buf[0] |= M_UNCOMPRESSED
            else:
                if inf:
                    out.append(bytes([M_COMPRESSED_INFINITY])
                               + b"\x00" * (self.nb - 1))
                    continue
                buf = bytearray(self._coord_to_bytes(x))
                buf[0] |= (M_COMPRESSED_LARGEST if self._lex_largest(y)
                           else M_COMPRESSED_SMALLEST)
            out.append(bytes(buf))
        return out

    def from_bytes(self, bufs, subgroup_check: bool = True) -> Affine:
        raise NotImplementedError(
            "PointCodec.from_bytes needs the Fp2 square root and the "
            "subgroup checks, not ported yet (ROADMAP.md queue 1, item 3)")


def _is_zero_coord(v) -> bool:
    if isinstance(v, tuple):
        return all(_is_zero_coord(c) for c in v)
    return v == 0


def _soa_to_aos(v):
    """Structure-of-arrays (nested tuples of per-coefficient lists) ->
    list of per-element nested tuples; scalars pass through."""
    if isinstance(v, tuple):
        subs = [_soa_to_aos(c) for c in v]
        if isinstance(subs[0], list):
            return [tuple(s[i] for s in subs) for i in range(len(subs[0]))]
        return tuple(subs)
    return v
