"""FFT/NTT domain: roots of unity, twiddle tables, coset tables.

Counterpart of ``gnark_crypto_tpu/ntt/domain.py`` (reference
``ecc/bn254/fr/fft/domain.go``): the same integer constants, twiddles
``w^j`` with the per-stage tables as strided views of the stage-0 table, the
coset tables ``u^i``, and gnark's byte layout. A domain works over any
field engine of ``field/api.py`` (the word engine, f31, f64), given as the
engine or as its spec. Tables live on the domain's device and are built
there with log-doubling multiplies through the engine (for bn254,
``mont_mul`` kernel launches on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec


def engine(spec_or_eng) -> FieldEngine:
    """The field engine of a spec, or the engine itself."""
    if isinstance(spec_or_eng, FieldEngine):
        return spec_or_eng
    return for_spec(spec_or_eng)


@functools.lru_cache(maxsize=None)
def bitrev_perm(n: int) -> np.ndarray:
    """rev[i] = i with its log2(n) bits reversed (utils/bitreverse.go:14)."""
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def exp_table(spec_or_eng, w: torch.Tensor, n: int) -> torch.Tensor:
    """[w^0, ..., w^(n-1)] (Montgomery) in log2(n) masked full-width muls:
    table[i] = prod over the set bits b of i of w^(2^b). (Reference
    ``BuildExpTable``, domain.go:300.)"""
    if n & (n - 1) or n < 1:
        raise ValueError("table size must be a power of two")
    eng = engine(spec_or_eng)
    table = eng.ones((n,), device=w.device)
    idx = torch.arange(n, device=w.device)
    wp = eng.reshape(w, (1,))  # w^(2^bit)
    for bit in range(n.bit_length() - 1):
        bit_set = ((idx >> bit) & 1) == 1
        table = eng.where(bit_set, eng.mul(table, wp), table)
        wp = eng.square(wp)
    return table


class Domain:
    """Radix-2 evaluation domain of size 2^k over any field engine.

    Mirrors the reference Domain: Generator (primitive n-th root),
    GeneratorInv, CardinalityInv, FrMultiplicativeGen (coset shift u),
    twiddle and coset tables (``domain.go:24-58``). ``device`` holds every
    table (default: the card)."""

    def __init__(self, spec_or_eng, n: int, shift: int | None = None,
                 with_coset: bool = True, device=mont.DEFAULT_DEVICE):
        eng = engine(spec_or_eng)
        spec = eng.spec
        if n < 1 or n & (n - 1):
            raise ValueError("cardinality must be a power of two")
        k = n.bit_length() - 1
        if k > spec.two_adicity:
            raise ValueError(
                f"{spec.name}: 2-adicity {spec.two_adicity} < log2(n)={k}")
        if spec.two_adic_root is None:
            raise ValueError(f"{spec.name} has no configured 2-adic root")
        self.eng = eng
        self.spec = spec
        self.n = n
        self.k = k
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        q = spec.modulus
        # Generator = root^(2^(s-k)) -> order exactly n (domain.go:202)
        self.generator_int = pow(spec.two_adic_root,
                                 1 << (spec.two_adicity - k), q)
        self.generator_inv_int = pow(self.generator_int, -1, q)
        self.cardinality_inv_int = pow(n, -1, q)
        u = spec.generator if shift is None else shift
        if u is None:
            raise ValueError(f"{spec.name} has no multiplicative generator")
        self.shift_int = u % q
        self.shift_inv_int = pow(self.shift_int, -1, q)

        self.generator = eng.from_int(self.generator_int, device=device)
        self.generator_inv = eng.from_int(self.generator_inv_int,
                                          device=device)
        self.cardinality_inv = eng.from_int(self.cardinality_inv_int,
                                            device=device)

        # stage-0 twiddles w^j, j < n/2; stage s reads t0[::2^s]. Built
        # lazily: the four-step path never reads them, and at 2^24 each is
        # 256 MB.
        self._twiddles0 = None
        self._twiddles0_inv = None
        # per-transform tables of the NTT kernels (ntt/four_step.py)
        self.tables: dict = {}
        if with_coset:
            self.coset_table = exp_table(
                eng, eng.from_int(self.shift_int, device=device), n)
            self.coset_table_inv = exp_table(
                eng, eng.from_int(self.shift_inv_int, device=device), n)
        else:
            self.coset_table = None
            self.coset_table_inv = None

    @property
    def twiddles0(self) -> torch.Tensor:
        if self._twiddles0 is None:
            self._twiddles0 = exp_table(self.eng, self.generator,
                                        max(self.n // 2, 1))
        return self._twiddles0

    @property
    def twiddles0_inv(self) -> torch.Tensor:
        if self._twiddles0_inv is None:
            self._twiddles0_inv = exp_table(self.eng, self.generator_inv,
                                            max(self.n // 2, 1))
        return self._twiddles0_inv

    def stage_twiddles(self, stage: int, inverse: bool = False
                       ) -> torch.Tensor:
        """Twiddles for one stage: w^(j*2^stage), j in [0, n/2^(stage+1))."""
        t0 = self.twiddles0_inv if inverse else self.twiddles0
        return t0[:: 1 << stage][: self.n >> (stage + 1)]

    # -- serialization (byte parity with fft/domain.go:348 WriteTo) ---------
    def to_bytes(self, with_precompute: bool = True) -> bytes:
        """uint64-BE cardinality || 5 canonical fr elements (CardinalityInv,
        Generator, GeneratorInv, FrMultiplicativeGen, its inverse) || one
        precompute flag byte: the reference's exact wire layout."""
        nb = self.spec.n_bytes
        out = self.n.to_bytes(8, "big")
        for v in (self.cardinality_inv_int, self.generator_int,
                  self.generator_inv_int, self.shift_int,
                  self.shift_inv_int):
            out += v.to_bytes(nb, "big")
        return out + bytes([1 if with_precompute else 0])


def domain_from_bytes(spec_or_eng, buf: bytes,
                      device=mont.DEFAULT_DEVICE) -> Domain:
    """Parse a gnark fft.Domain blob (domain.go:381 ReadFrom): rebuild the
    domain from (cardinality, shift) and check that the stored generator
    chain matches the field's 2-adic tower (corruption detection)."""
    spec = engine(spec_or_eng).spec
    nb = spec.n_bytes
    if len(buf) < 8 + 5 * nb + 1:
        raise ValueError("domain blob too short")
    n = int.from_bytes(buf[:8], "big")
    vals = [int.from_bytes(buf[8 + i * nb: 8 + (i + 1) * nb], "big")
            for i in range(5)]
    card_inv, gen, gen_inv, shift, shift_inv = vals
    if any(v >= spec.modulus for v in vals):
        raise ValueError("non-canonical domain element")
    dom = Domain(spec_or_eng, n, shift=shift, device=device)
    if (dom.generator_int != gen or dom.generator_inv_int != gen_inv
            or dom.cardinality_inv_int != card_inv
            or dom.shift_inv_int != shift_inv):
        raise ValueError("domain blob inconsistent with field constants")
    return dom
