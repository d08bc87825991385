"""IOP polynomial layer: basis x layout tracked polynomials with lazy
conversions.

Counterpart of ``gnark_crypto_tpu/protocols/iop.py`` (reference
``ecc/<curve>/fr/iop/polynomial.go:22-392``), with the same values, output
for output. A Polynomial tracks (Basis, Layout):

  Basis:  CANONICAL (coefficients) | LAGRANGE (evals on <g>) |
          LAGRANGE_COSET (evals on u*<g>)
  Layout: REGULAR | BIT_REVERSE

Conversions ride the NTT (``ntt/fft.py``) with the reference's decimation
bookkeeping (DIF: natural -> bit-reversed, DIT: bit-reversed -> natural),
so a conversion never pays a separate bit reversal when the target layout
absorbs it. Values are plain (non-Montgomery) Fr words ``(n, W)`` and stay
on their device: on the card every transform runs the NTT kernels, at 8
words (bn254 Fr), 10 (bw6-633 Fr) or 12 (bw6-761 Fr, bls12-381/377 Fr).

The reference builds its index and vanishing vectors on the host with a
Python ``pow`` per element (``iop.py:193-194,225-229``). Here the same
integers are built on the device: powers by ``exp_table`` (log2(n) masked
products), inverses by one ``batch_inverse``, and the grand product by the
log-stride scan of ``utils/scans.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import torch

from gnark_crypto_tpu_torch.field.api import for_spec
from gnark_crypto_tpu_torch.ntt import fft as fftm
from gnark_crypto_tpu_torch.ntt.domain import Domain, bitrev_perm
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.utils.scans import (
    exclusive_prefix_product, exp_table)


class Basis(enum.Enum):
    CANONICAL = 0
    LAGRANGE = 1
    LAGRANGE_COSET = 2


class Layout(enum.Enum):
    REGULAR = 0
    BIT_REVERSE = 1


@functools.lru_cache(maxsize=None)
def _domain_on(spec: FieldSpec, n: int, device: str) -> Domain:
    return Domain(spec, n, device=device)


def domain(spec: FieldSpec, n: int, device) -> Domain:
    """The size-n domain of ``spec`` with its tables on ``device``, built
    once per (field, size, device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _domain_on(spec, n, str(dev))


def _powers(eng, base: int, n: int, device) -> torch.Tensor:
    """[base^0, ..., base^(n-1)] (Montgomery) for n a power of two, built on
    the device."""
    return exp_table(eng, eng.from_int([base % eng.spec.modulus],
                                       device=device), n)


@dataclasses.dataclass
class Polynomial:
    spec: FieldSpec
    values: torch.Tensor  # (n, W) plain Fr
    basis: Basis
    layout: Layout

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def eng(self):
        return for_spec(self.spec)

    def _dom(self) -> Domain:
        return domain(self.spec, self.n, self.values.device)

    # -- layout ------------------------------------------------------------
    def to_regular(self) -> "Polynomial":
        if self.layout == Layout.REGULAR:
            return self
        return Polynomial(self.spec, fftm.bit_reverse(self.values),
                          self.basis, Layout.REGULAR)

    def to_bit_reverse(self) -> "Polynomial":
        if self.layout == Layout.BIT_REVERSE:
            return self
        return Polynomial(self.spec, fftm.bit_reverse(self.values),
                          self.basis, Layout.BIT_REVERSE)

    # -- basis (polynomial.go ToCanonical/ToLagrange/ToLagrangeCoset) -------
    def to_canonical(self) -> "Polynomial":
        if self.basis == Basis.CANONICAL:
            return self
        eng, dom = self.eng, self._dom()
        m = eng.to_mont(self.values)
        coset = self.basis == Basis.LAGRANGE_COSET
        if self.layout == Layout.BIT_REVERSE:
            out = fftm.fft_inverse(dom, m, fftm.DIT, coset=coset)
            lay = Layout.REGULAR
        else:
            out = fftm.fft_inverse(dom, m, fftm.DIF, coset=coset)
            lay = Layout.BIT_REVERSE
        return Polynomial(self.spec, eng.from_mont(out), Basis.CANONICAL, lay)

    def to_lagrange(self, coset: bool = False) -> "Polynomial":
        target = Basis.LAGRANGE_COSET if coset else Basis.LAGRANGE
        if self.basis == target:
            return self
        if self.basis != Basis.CANONICAL:
            return self.to_canonical().to_lagrange(coset)
        eng, dom = self.eng, self._dom()
        m = eng.to_mont(self.values)
        if self.layout == Layout.REGULAR:
            out = fftm.fft(dom, m, fftm.DIF, coset=coset)
            lay = Layout.BIT_REVERSE
        else:
            out = fftm.fft(dom, m, fftm.DIT, coset=coset)
            lay = Layout.REGULAR
        return Polynomial(self.spec, eng.from_mont(out), target, lay)

    def to_lagrange_coset(self) -> "Polynomial":
        return self.to_lagrange(coset=True)

    # -- evaluation (polynomial.go Evaluate) --------------------------------
    def evaluate(self, point: torch.Tensor) -> torch.Tensor:
        """P(point) for a plain Fr (1, W); an inner product with the powers
        of the point. Returns plain Fr (1, W)."""
        p = self.to_canonical().to_regular()
        eng = self.eng
        pows = exp_table(eng, eng.to_mont(point), p.n)
        return eng.from_mont(eng.inner_product(eng.to_mont(p.values),
                                               pows))[None]


def from_canonical(spec: FieldSpec, coeffs: torch.Tensor) -> Polynomial:
    return Polynomial(spec, coeffs, Basis.CANONICAL, Layout.REGULAR)


def to_lagrange_batch(polys: list[Polynomial], coset: bool = False
                      ) -> list[Polynomial]:
    """Convert many polynomials to (LAGRANGE[_COSET], REGULAR): each group
    of canonical polynomials of one (layout, size) runs one ``fft_batch``
    (the reference's quotient pipeline loops per-polynomial domain.FFT
    calls, iop/quotient.go:21); the others convert one by one."""
    target = Basis.LAGRANGE_COSET if coset else Basis.LAGRANGE
    out: list[Polynomial | None] = [None] * len(polys)
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(polys):
        if p.basis == Basis.CANONICAL:
            groups.setdefault((p.layout, p.n), []).append(i)
        else:  # already Lagrange-family (or coset mismatch): per-poly path
            out[i] = p.to_lagrange(coset).to_regular()
    for (layout, n), idxs in groups.items():
        first = polys[idxs[0]]
        eng = first.eng
        dom = domain(first.spec, n, first.values.device)
        batch = eng.to_mont(torch.stack([polys[i].values for i in idxs]))
        if layout == Layout.REGULAR:
            ev = fftm.fft_batch(dom, batch, fftm.DIF, coset=coset)
            # DIF output is bit-reversed: undo it along axis 1
            perm = torch.from_numpy(bitrev_perm(n)).to(ev.device)
            ev = ev[:, perm]
        else:
            ev = fftm.fft_batch(dom, batch, fftm.DIT, coset=coset)
        ev = eng.from_mont(ev)
        for j, i in enumerate(idxs):
            out[i] = Polynomial(polys[i].spec, ev[j], target, Layout.REGULAR)
    return out


def evaluate_expression(spec: FieldSpec, fn, *polys: Polynomial
                        ) -> Polynomial:
    """Pointwise expression over Lagrange vectors (iop/expressions.go:17).

    fn receives the engine and the Montgomery-form value tensors; every
    input is converted to (LAGRANGE, REGULAR), the canonical ones in one
    batched transform."""
    eng = for_spec(spec)
    lag = to_lagrange_batch(list(polys))
    out = fn(eng, *(eng.to_mont(p.values) for p in lag))
    return Polynomial(spec, eng.from_mont(out), Basis.LAGRANGE,
                      Layout.REGULAR)


def divide_by_x_minus_one(poly: Polynomial, vanish_n: int | None = None
                          ) -> Polynomial:
    """Quotient h = p / (X^m - 1) via coset evaluation
    (iop/quotient.go:21 DivideByXMinusOne).

    p: CANONICAL of size N (deg p < N); divisor X^m - 1 with m | N, m < N
    (default m = N/2). On the size-N coset u*<g> the vanishing values
    (u g^i)^m - 1 are nonzero and periodic with period N/m: their inverses
    are N/m powers, one batch inversion and a gather, on the device."""
    spec, eng = poly.spec, poly.eng
    big_n = poly.n
    n = vanish_n or big_n // 2
    if big_n % n or n >= big_n:
        raise ValueError(f"X^{n} - 1 must divide into a size-{big_n} domain "
                         "with m < N")
    period = big_n // n
    dev = poly.values.device
    dom_big = domain(spec, big_n, dev)
    padded = poly.to_canonical().to_regular().values
    evals = fftm.fft(dom_big, eng.to_mont(padded), fftm.DIF, coset=True)
    q = spec.modulus
    # zh_i = u^m (g^m)^i - 1, i < period
    zh = eng.sub(eng.mul(_powers(eng, pow(dom_big.generator_int, n, q),
                                 period, dev),
                         eng.from_int(pow(dom_big.shift_int, n, q),
                                      device=dev)),
                 eng.ones((period,), device=dev))
    zh_inv = eng.batch_inverse(zh)
    zh_vec = zh_inv[torch.arange(big_n, device=dev) % period]
    # evals are bit-reversed: apply the same permutation to zh_vec
    h_evals = eng.mul(evals, fftm.bit_reverse(zh_vec))
    h = fftm.fft_inverse(dom_big, h_evals, fftm.DIT, coset=True)
    return Polynomial(spec, eng.from_mont(h), Basis.CANONICAL,
                      Layout.REGULAR)


def build_ratio_copy_constraint(spec: FieldSpec, entries: list[Polynomial],
                                sigma, beta: int, gamma: int
                                ) -> Polynomial:
    """Grand-product accumulator Z for the copy-constraint/permutation
    argument (iop/ratios.go:47 BuildRatioCopyConstraint):

      Z_0 = 1;  Z_{i+1} = Z_i * prod_j (f_j(w^i) + beta*w^i*nu^j + gamma)
                              / (f_j(w^i) + beta*sigma_j(i) + gamma)

    where sigma (a sequence of k*n ints, or an int64 tensor) is the
    permutation over the concatenated index space and nu = u, the field's
    multiplicative generator, shifts each column into its own coset. The
    identities id_j(i) = u^j g^i are built on the device (``exp_table``),
    sigma's values by one gather of them."""
    eng = for_spec(spec)
    n = entries[0].n
    k = len(entries)
    q = spec.modulus
    dev = entries[0].values.device
    dom = domain(spec, n, dev)
    fs_vals = [eng.to_mont(p.to_lagrange().to_regular().values)
               for p in entries]
    g_pows = _powers(eng, dom.generator_int, n, dev)
    u_pows = eng.from_int([pow(dom.shift_int, j, q) for j in range(k)],
                          device=dev)
    ids = eng.mul(u_pows[:, None], g_pows[None])            # (k, n, W)
    sig = torch.as_tensor(sigma, dtype=torch.int64).to(dev)
    sig_vals = ids.reshape(k * n, spec.n_words)[sig].reshape(k, n,
                                                             spec.n_words)
    beta_m = eng.from_int(beta % q, device=dev)
    gamma_m = eng.from_int(gamma % q, device=dev)
    num = eng.ones((n,), device=dev)
    den = num
    for j in range(k):
        num = eng.mul(num, eng.add(eng.add(fs_vals[j],
                                           eng.mul(ids[j], beta_m)),
                                   gamma_m))
        den = eng.mul(den, eng.add(eng.add(fs_vals[j],
                                           eng.mul(sig_vals[j], beta_m)),
                                   gamma_m))
    ratio = eng.mul(num, eng.batch_inverse(den))
    z = exclusive_prefix_product(eng, ratio)
    return Polynomial(spec, eng.from_mont(z), Basis.LAGRANGE, Layout.REGULAR)
