"""EdDSA over the twisted Edwards companion curves, byte-compatible with the
reference (``ecc/<curve>/twistededwards/eddsa/eddsa.go``).

Counterpart of ``gnark_crypto_tpu/signature/eddsa.py``:

  * key gen: blake2b-512 of a 32-byte seed, RFC8032 pruning, little-endian
    scalar pickup (eddsa.go:52-77)
  * sign: blinding r = blake2b(randSrc || msg)[:32]; R = [r]B;
    hram = H(R.x || R.y || A.x || A.y || msg); s = r + hram*scalar mod order
  * verify: [8][s]B == [8](R + [hram]A) (cofactor-cleared, eddsa.go:218-236)

H defaults to the field's MiMC (``hashes/mimc.py``), as gnark uses it. The
curve math (``curve/twistededwards.py``) and the MiMC rounds run on the
device given to :class:`EdDSA`, the byte plumbing on the host.
"""

from __future__ import annotations

import dataclasses
import hashlib

from gnark_crypto_tpu_torch.curve.twistededwards import (AffinePoint,
                                                         TedCurve, ted_curve)
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.hashes.mimc import MiMC, mimc


@dataclasses.dataclass
class PublicKey:
    a: AffinePoint  # batch-of-1


@dataclasses.dataclass
class PrivateKey:
    public_key: PublicKey
    scalar: bytes     # big-endian, sizeFr
    rand_src: bytes   # 32 bytes


@dataclasses.dataclass
class Signature:
    r: AffinePoint
    s: bytes          # big-endian, sizeFr


class EdDSA:
    def __init__(self, curve_name: str = "bn254", hasher: MiMC | None = None,
                 device=DEFAULT_DEVICE):
        self.curve: TedCurve = ted_curve(curve_name, device)
        self.h = hasher or mimc(self.curve.spec.base.name, device)
        self.nb = self.curve.spec.base.n_bytes

    def _base(self):
        return self.curve.from_affine(self.curve.generator_affine((1,)))

    # -- keys ---------------------------------------------------------------
    def generate_key(self, seed: bytes) -> PrivateKey:
        if len(seed) != 32:
            raise ValueError("eddsa: the seed must be 32 bytes")
        h = hashlib.blake2b(seed, digest_size=64).digest()
        rand_src = h[32:64]
        hb = bytearray(h)
        hb[0] &= 0xF8
        hb[31] &= 0x7F
        hb[31] |= 0x40
        scalar = bytes(reversed(hb[: self.nb]))  # little-endian -> big-endian
        s_int = int.from_bytes(scalar, "big")
        a = self.curve.to_affine(self.curve.scalar_mul_int(
            self._base(), [s_int], 8 * self.nb, regular=True))
        return PrivateKey(PublicKey(a), scalar, rand_src)

    # -- hram ---------------------------------------------------------------
    def _hram(self, r: AffinePoint, a: AffinePoint, msg: bytes) -> int:
        f = self.curve.f
        self.h.reset()
        for v in (f.to_int(r.x)[0], f.to_int(r.y)[0],
                  f.to_int(a.x)[0], f.to_int(a.y)[0]):
            self.h.write(v.to_bytes(self.nb, "big"))
        self.h.write(_pad_blocks(msg, self.nb, self.curve.spec.base.modulus))
        return int.from_bytes(self.h.sum(), "big")

    # -- sign / verify ------------------------------------------------------
    def sign(self, priv: PrivateKey, msg: bytes) -> Signature:
        order = self.curve.spec.order
        blind = hashlib.blake2b(priv.rand_src + msg, digest_size=64).digest()
        r_int = int.from_bytes(blind[: self.nb], "big")
        r_pt = self.curve.to_affine(self.curve.scalar_mul_int(
            self._base(), [r_int], 8 * self.nb, regular=True))
        hram = self._hram(r_pt, priv.public_key.a, msg)
        s = (r_int + hram * int.from_bytes(priv.scalar, "big")) % order
        return Signature(r_pt, s.to_bytes(self.nb, "big"))

    def _reject_malleable(self, sig: Signature) -> None:
        """Anti-malleability checks matching eddsa/marshal.go SetBytes:
        reject S == 0 or S >= order (s + k*order would verify identically),
        and reject R == identity (zero R)."""
        s_int = int.from_bytes(sig.s, "big")
        if s_int == 0 or s_int >= self.curve.spec.order:
            raise ValueError("eddsa: non-canonical S (malleable signature)")
        f = self.curve.f
        rx, ry = f.to_int(sig.r.x), f.to_int(sig.r.y)
        if isinstance(rx, list):
            rx, ry = rx[0], ry[0]
        if rx == 0 and ry == 1:
            raise ValueError("eddsa: R is the identity point")

    def verify(self, pub: PublicKey, sig: Signature, msg: bytes) -> bool:
        curve = self.curve
        try:
            self._reject_malleable(sig)
        except ValueError:
            return False
        if not bool(curve.on_curve_affine(pub.a)[0]):
            return False
        if not bool(curve.on_curve_affine(sig.r)[0]):
            return False
        hram = self._hram(sig.r, pub.a, msg)
        s_int = int.from_bytes(sig.s, "big")
        cof = curve.spec.cofactor
        lhs = curve.scalar_mul_int(self._base(), [s_int * cof])
        rhs_in = curve.add(
            curve.scalar_mul_int(curve.from_affine(pub.a), [hram]),
            curve.from_affine(sig.r))
        rhs = curve.scalar_mul_int(rhs_in, [cof])
        la = curve.to_affine(lhs)
        ra = curve.to_affine(rhs)
        f = curve.f
        eq = f.equal(la.x, ra.x) & f.equal(la.y, ra.y)
        return bool(eq[0])

    # -- serialization (eddsa/marshal.go) -----------------------------------
    def signature_to_bytes(self, sig: Signature) -> bytes:
        return self.curve.point_to_bytes(sig.r)[0] + sig.s

    def signature_from_bytes(self, buf: bytes) -> Signature:
        r = self.curve.point_from_bytes([buf[: self.nb]])
        sig = Signature(r, buf[self.nb : 2 * self.nb])
        self._reject_malleable(sig)
        return sig

    def public_key_to_bytes(self, pub: PublicKey) -> bytes:
        return self.curve.point_to_bytes(pub.a)[0]

    def public_key_from_bytes(self, buf: bytes) -> PublicKey:
        return PublicKey(self.curve.point_from_bytes([buf[: self.nb]]))


def _pad_blocks(msg: bytes, nb: int, modulus: int) -> bytes:
    """MiMC Write needs canonical nb-byte blocks; zero-pad the message left
    like the reference's byte-to-field handling for short inputs."""
    if len(msg) == 0:
        return b""
    if len(msg) % nb:
        msg = b"\x00" * (nb - len(msg) % nb) + msg
    # ensure each block is canonical (callers hash field-sized data in gnark)
    out = b""
    for i in range(0, len(msg), nb):
        block = msg[i : i + nb]
        if int.from_bytes(block, "big") >= modulus:
            raise ValueError("message block not canonical for field hashing")
        out += block
    return out
