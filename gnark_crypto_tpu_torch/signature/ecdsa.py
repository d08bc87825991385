"""ECDSA over any registered curve (secp256k1/r1, stark, pairing G1s).

Counterpart of ``gnark_crypto_tpu/signature/ecdsa.py`` (reference
``ecc/<curve>/ecdsa/ecdsa.go``): the same math (sign/verify, HashToInt
truncation ecdsa.go:117, public-key recovery) and the same deterministic
HMAC-SHA256 nonce, so both packages make the same signature for the same key
and message. Nonces differ from gnark's AES-CTR csprng (ecdsa.go:167), whose
signatures are randomized anyway; they verify in both directions.

The curve math is the port's group law (``curve/jacobian.py``) on the
device given to :class:`ECDSA`: on the card each ladder step is one
``jac_double`` and one or two ``jac_add`` launches over one lane (the
256-bit secp256k1/r1 fields on the full-width 8-word kernels), on the CPU
their plain versions. The scalar arithmetic mod n, the nonce and the
square root of recovery are host integers, as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac

import numpy as np
import torch

from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.curve.twistededwards import _tonelli_int
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs.curve import CurveSpec, get_curve


@dataclasses.dataclass
class PublicKey:
    q: Affine  # batch-of-1


@dataclasses.dataclass
class PrivateKey:
    public_key: PublicKey
    d: int


@dataclasses.dataclass
class Signature:
    r: int
    s: int


def hash_to_int(msg_hash: bytes, order: int) -> int:
    """Leftmost-bits truncation (ecdsa.go HashToInt)."""
    n_bits = order.bit_length()
    n_bytes = (n_bits + 7) // 8
    h = msg_hash[:n_bytes]
    v = int.from_bytes(h, "big")
    excess = len(h) * 8 - n_bits
    if excess > 0:
        v >>= excess
    return v


def _raw_scalar(spec, k: int, device) -> torch.Tensor:
    """(1, W) plain Fr words of k < 2^(32W), not reduced mod r (the
    cofactor check ladders by r itself)."""
    words = np.frombuffer(k.to_bytes(4 * spec.n_words, "little"), "<u4")
    return torch.from_numpy(words.view(np.int32).copy()[None]).to(device)


class ECDSA:
    def __init__(self, curve_name: str, device=DEFAULT_DEVICE):
        self.spec: CurveSpec = get_curve(curve_name)
        self.curve = curve_ops(self.spec)
        self.order = self.spec.fr.modulus
        self.device = torch.device(device)

    def _g(self) -> Jac:
        """The generator as a batch of one, in Jacobian coordinates."""
        g = self.curve.generator_jac(device=self.device)
        return Jac(*(c[None] for c in g))

    def _fr(self, k: int) -> torch.Tensor:
        return self.curve.fr.from_int([k], mont=False, device=self.device)

    def _base_mul(self, k: int) -> Affine:
        """[k]G for a secret k (a key or a nonce): the regular ladder."""
        c = self.curve
        return c.to_affine(c.scalar_mul(self._g(), self._fr(k % self.order),
                                        regular=True))

    def generate_key(self, seed: bytes) -> PrivateKey:
        d = int.from_bytes(
            hashlib.sha512(b"ecdsa-key" + seed).digest(), "big") % self.order
        if d == 0:
            d = 1
        return PrivateKey(PublicKey(self._base_mul(d)), d)

    def _nonce(self, priv_d: int, h: int) -> int:
        nb = (self.order.bit_length() + 7) // 8
        data = priv_d.to_bytes(nb, "big") + h.to_bytes(nb, "big")
        k, v = b"\x00" * 32, b"\x01" * 32
        k = hmac.new(k, v + b"\x00" + data, hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()
        k = hmac.new(k, v + b"\x01" + data, hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()
        while True:
            t = b""
            while len(t) < nb:
                v = hmac.new(k, v, hashlib.sha256).digest()
                t += v
            cand = int.from_bytes(t[:nb], "big") % self.order
            if cand != 0:
                return cand

    def sign(self, msg: bytes, priv: PrivateKey,
             hasher=hashlib.sha256) -> Signature:
        """Sign with BIP-62 low-s normalization, like the reference's Sign
        (which delegates to SignForRecover, ecdsa.go:336)."""
        return self.sign_for_recover(msg, priv, hasher)[1]

    def sign_for_recover(self, msg: bytes, priv: PrivateKey,
                         hasher=hashlib.sha256):
        """(v, Signature) with recovery id v = (x_P div n) << 1 | y_P parity
        (ecdsa.go:248 SignForRecover). The deterministic nonce is re-derived
        (counter-perturbed) until r != 0 and s <= (n-1)/2 — the reference's
        rejection loop with fresh randomness."""
        n = self.order
        h = hash_to_int(hasher(msg).digest(), n)
        f = self.curve.fp
        ctr = 0
        while True:
            k = self._nonce(priv.d, h + ctr)
            ctr += 1
            rp = self._base_mul(k)
            x = f.to_int(rp.x)[0]
            y = f.to_int(rp.y)[0]
            v = ((x // n) << 1) | (y & 1)
            r = x % n
            if r == 0:
                continue
            s = pow(k, -1, n) * (h + r * priv.d) % n
            if s == 0 or s > (n - 1) // 2:
                continue
            return v, Signature(r, s)

    def recover_public_key(self, msg: bytes, v: int, sig: Signature,
                           hasher=hashlib.sha256) -> PublicKey:
        """Public-key recovery (marshal.go:58 RecoverFrom + ecdsa.go:111
        recoverP): P = point with x = r + (v>>1)*n and y parity v&1;
        Q = [-z/r]G + [s/r]P via the joint ladder."""
        n = self.order
        p = self.spec.fp.modulus
        if not (0 < sig.r < n and 0 < sig.s < n):
            raise ValueError("invalid signature scalars")
        # the whole x-quotient, not one bit: pairing G1s have p >> n, so the
        # nonce point's x // n can be large (the reference carries it whole)
        x = sig.r + (v >> 1) * n
        if x >= p:
            raise ValueError("recovery x overflows the base field")
        a = self.spec.a % p
        y2 = (pow(x, 3, p) + a * x + self.spec.b) % p
        if p % 4 == 3:
            y = pow(y2, (p + 1) // 4, p)
        else:
            y = _tonelli_int(y2, p)
        if y * y % p != y2:
            raise ValueError("recovery point has no square root")
        if (y & 1) != (v & 1):
            y = p - y
        z = hash_to_int(hasher(msg).digest(), n)
        rinv = pow(sig.r, -1, n)
        u1 = (-z * rinv) % n
        u2 = sig.s * rinv % n
        c = self.curve
        f = c.fp
        pj = c.from_affine(Affine(f.from_int([x], device=self.device),
                                  f.from_int([y], device=self.device)))
        q = c.joint_scalar_mul(self._g(), pj, self._fr(u1), self._fr(u2))
        if bool(c.is_inf_jac(q)[0]):
            raise ValueError("recovered point at infinity")
        return PublicKey(c.to_affine(q))

    def verify(self, msg: bytes, sig: Signature, pub: PublicKey,
               hasher=hashlib.sha256) -> bool:
        n = self.order
        if not (0 < sig.r < n and 0 < sig.s < n):
            return False
        c = self.curve
        # Public-key validation: reject the point at infinity explicitly
        # (on_curve_affine admits (0,0) via its infinity clause) and, for
        # cofactor > 1 curves, points outside the prime-order subgroup.
        if bool(c.is_inf_affine(pub.q)[0]):
            return False
        if not bool(c.on_curve_affine(pub.q)[0]):
            return False
        if getattr(self.spec, "cofactor", 1) != 1:
            # n unreduced: n is the Fr modulus, so a reducing from_int would
            # turn this into the vacuous [0]Q check
            rn = c.scalar_mul(c.from_affine(pub.q),
                              _raw_scalar(self.spec.fr, n, pub.q.x.device),
                              nbits=n.bit_length() + 1)
            if not bool(c.is_inf_jac(rn)[0]):
                return False
        h = hash_to_int(hasher(msg).digest(), n)
        w = pow(sig.s, -1, n)
        u1 = h * w % n
        u2 = sig.r * w % n
        # [u1]G + [u2]Q with a shared doubling chain (the reference's
        # JointScalarMultiplicationBase, g1.go:873)
        res = c.joint_scalar_mul(self._g(), c.from_affine(pub.q),
                                 self._fr(u1), self._fr(u2))
        if bool(c.is_inf_jac(res)[0]):
            return False
        rp = c.to_affine(res)
        return c.fp.to_int(rp.x)[0] % n == sig.r

    # -- serialization (ecdsa/marshal.go: r||s big-endian fr pairs) ---------
    def signature_to_bytes(self, sig: Signature) -> bytes:
        nb = self.spec.fr.n_bytes
        return sig.r.to_bytes(nb, "big") + sig.s.to_bytes(nb, "big")

    def signature_from_bytes(self, buf: bytes) -> Signature:
        nb = self.spec.fr.n_bytes
        return Signature(int.from_bytes(buf[:nb], "big"),
                         int.from_bytes(buf[nb : 2 * nb], "big"))
