"""MiMC hash (Miyaguchi-Preneel mode) over Fr, bit-exact with the reference.

Counterpart of ``gnark_crypto_tpu/hashes/mimc.py`` (reference
``ecc/<curve>/fr/mimc/mimc.go``): x^e S-box (e = 5, or 17 for bls12-377),
per-curve round counts, round constants derived from the legacy Keccak-256
chain seeded with "seed" (mimc.go:250-263). The compression function runs
on the device of its blocks, batched over parallel hash states: the JAX
``lax.scan`` over rounds and over blocks are Python loops over field ops on
``(batch, W)`` word tensors, so on the card each product of a round is one
``mont_mul`` launch over the whole batch (a round is e's squarings and one
multiply: 3 launches at e = 5, 5 at e = 17).
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.hashes.keccak import keccak256
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.specs.field import FieldSpec

# (rounds, sbox exponent) per field — from each generated mimc.go:52 + encrypt
PARAMS: dict[str, tuple[int, int]] = {
    "bn254_fr": (110, 5),
    "bls12_377_fr": (62, 17),
    "bls12_381_fr": (111, 5),
    "bls24_315_fr": (109, 5),
    "bls24_317_fr": (91, 5),
    "bw6_633_fr": (136, 5),
    "bw6_761_fr": (163, 5),
    "grumpkin_fr": (110, 5),
}

SEED = b"seed"


@functools.lru_cache(maxsize=None)
def constants(spec: FieldSpec) -> tuple[int, ...]:
    """Round constants: keccak chain rnd -> keccak(rnd), c_i = rnd mod r
    (mimc.go initConstants)."""
    rounds, _ = PARAMS[spec.name]
    rnd = keccak256(SEED)
    out = []
    for _ in range(rounds):
        rnd = keccak256(rnd)
        out.append(int.from_bytes(rnd, "big") % spec.modulus)
    return tuple(out)


class MiMC:
    """Batched MiMC hasher for one field, on one device.

    Device API: :meth:`hash_elements` hashes a ``(blocks, batch, W)`` tensor
    of plain Fr words into ``(batch, W)`` plain digests. Host API mirrors
    the reference's hash.Hash (``write`` accumulates canonical blocks of
    ``n_bytes``; ``sum`` returns the digest bytes), hashing on ``device``.
    """

    def __init__(self, spec: FieldSpec, device=DEFAULT_DEVICE):
        self.spec = spec
        self.device = torch.device(device)
        self.eng: FieldEngine = for_spec(spec)
        self.rounds, self.exponent = PARAMS[spec.name]
        # (rounds, W) Montgomery round constants
        self._cs_mont = self.eng.from_int(list(constants(spec)),
                                          device=self.device)
        self._data: list[bytes] = []
        self._state = 0  # flushed Miyaguchi-Preneel chaining value (plain)

    # -- device path --------------------------------------------------------
    def _encrypt(self, m: torch.Tensor, h: torch.Tensor, cs: torch.Tensor
                 ) -> torch.Tensor:
        """E_h(m): rounds of m = (m + h + c_i)^e, then + h (mimc.go:224).
        All values Montgomery, (batch, W); cs the (rounds, W) constants."""
        eng = self.eng
        k = (self.exponent - 1).bit_length() - 1  # e = 2^k + 1
        for c in cs:
            tmp = eng.add(eng.add(m, h), c)
            acc = tmp
            for _ in range(k):
                acc = eng.square(acc)
            m = eng.mul(acc, tmp)
        return eng.add(m, h)

    def hash_elements(self, blocks: torch.Tensor, h0: int = 0
                      ) -> torch.Tensor:
        """(nb_blocks, batch, W) plain Fr -> (batch, W) plain Fr digests, on
        the blocks' device.

        Miyaguchi-Preneel: h = E_h(m) + h + m per block (mimc.go:186-190).
        ``h0``: initial chaining value (SetState support, mimc.go:279).
        """
        eng = self.eng
        bm = eng.to_mont(blocks)
        dev = blocks.device
        shape = eng.eshape(bm[0])
        h = (eng.broadcast_to(eng.from_int(h0, device=dev), shape).clone()
             if h0 else eng.zeros(shape, device=dev))
        cs = self._cs_mont.to(dev)
        for m in bm:
            h = eng.add(eng.add(self._encrypt(m, h, cs), h), m)
        return eng.from_mont(h)

    # -- host hash.Hash-compatible path (reference Write/Sum semantics) -----
    def reset(self):
        self._data = []
        self._state = 0

    def set_state(self, new_state: bytes):
        """Load an externally saved chaining value (mimc.go:279 SetState):
        must be canonical fr bytes; rejects a hasher with buffered blocks
        (the reference clears d.data, but silently dropping written data
        diverges from every caller's intent — flush with sum() first)."""
        if self._data:
            raise ValueError("mimc has buffered data; call sum() first")
        if len(new_state) != self.spec.n_bytes:
            raise ValueError(
                f"mimc state must be {self.spec.n_bytes} bytes")
        v = int.from_bytes(new_state, "big")
        if v >= self.spec.modulus:
            raise ValueError("invalid mimc state (non-canonical)")
        self._state = v
        self._data = []

    def state(self) -> bytes:
        """Flush buffered blocks into the chaining value and return it
        (mimc.go:295 State)."""
        return self.sum()

    def write(self, data: bytes):
        """Strict: data must be canonical fr chunks (mimc.go Write)."""
        bs = self.spec.n_bytes
        if len(data) % bs:
            raise ValueError(f"invalid input length (must be {bs}-multiples)")
        for i in range(0, len(data), bs):
            chunk = data[i : i + bs]
            if int.from_bytes(chunk, "big") >= self.spec.modulus:
                raise ValueError("non-canonical block")
            self._data.append(chunk)

    def sum(self) -> bytes:
        """Fold buffered blocks into the chaining value and return its bytes
        (reference Sum flushes: checksum mutates d.h, mimc.go:109,178)."""
        if not self._data:
            # no blocks -> current state (0 on a fresh hasher)
            return self._state.to_bytes(self.spec.n_bytes, "big")
        vals = [int.from_bytes(c, "big") for c in self._data]
        arr = self.eng.from_int(vals, mont=False, device=self.device)
        out = self.hash_elements(arr[:, None], h0=self._state)
        buf = self.eng.to_bytes_host(out, mont=False)[0]
        self._state = int.from_bytes(buf, "big")
        self._data = []
        return buf

    # hashlib-style aliases (for Transcript)
    def update(self, data: bytes):
        self.write(data)

    def digest(self) -> bytes:
        return self.sum()


@functools.lru_cache(maxsize=None)
def _mimc(field_name: str, device: torch.device) -> MiMC:
    return MiMC(fs.get_field(field_name), device)


def mimc(field_name: str, device=DEFAULT_DEVICE) -> MiMC:
    """The hasher of ``field_name`` on ``device``, one per (field,
    device)."""
    return _mimc(field_name, torch.device(device))
