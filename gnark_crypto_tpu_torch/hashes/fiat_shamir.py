"""Fiat-Shamir transcript, byte for byte the reference's.

Counterpart (own copy) of ``gnark_crypto_tpu/hashes/fiat_shamir.py``,
itself the counterpart of ``fiat-shamir/transcript.go``: named challenges,
computed in order, each binding the previous one:

  challenge = H(name || previous_challenge? || bindings...)

This is sequential byte work: it stays on the host; the field math it
drives runs on the device.
"""

from __future__ import annotations

import hashlib


class TranscriptError(ValueError):
    pass


class Transcript:
    """The reference Transcript (transcript.go:33). ``h`` is a factory of a
    hashlib-like object (``hashlib.sha256`` by default)."""

    def __init__(self, h=hashlib.sha256, challenge_ids=()):
        self._h = h
        self._order: list[str] = []
        self._challenges: dict[str, dict] = {}
        for cid in challenge_ids:
            self.new_challenge(cid)

    def new_challenge(self, cid: str):
        if cid in self._challenges:
            raise TranscriptError(f"challenge already exists: {cid}")
        self._order.append(cid)
        self._challenges[cid] = {"bindings": [], "value": None}

    def bind(self, cid: str, value: bytes):
        ch = self._challenges.get(cid)
        if ch is None:
            raise TranscriptError(f"challenge not recorded: {cid}")
        if ch["value"] is not None:
            raise TranscriptError(f"challenge already computed: {cid}")
        ch["bindings"].append(bytes(value))

    def compute_challenge(self, cid: str) -> bytes:
        ch = self._challenges.get(cid)
        if ch is None:
            raise TranscriptError(f"challenge not recorded: {cid}")
        if ch["value"] is not None:
            return ch["value"]
        pos = self._order.index(cid)
        h = self._h()
        h.update(cid.encode())
        if pos > 0:
            prev = self._challenges[self._order[pos - 1]]
            if prev["value"] is None:
                raise TranscriptError("previous challenge not computed")
            h.update(prev["value"])
        for b in ch["bindings"]:
            h.update(b)
        ch["value"] = h.digest()
        return ch["value"]
