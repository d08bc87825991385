"""Ring-SIS hash over Z_q[X]/(X^d + 1), bit-exact with the reference.

Counterpart of ``gnark_crypto_tpu/hashes/sis.py`` (reference
``field/<f>/sis/sis.go``): key polynomials A_i derived from
blake2b("SIS" || seed || i || j) on the host; inputs limb-decomposed
little-endian into 2^logTwoBound digits; the negacyclic multiply-accumulate
done in evaluation form on the coset sqrt(g)<g> (the reference's WithShift
domain, sis.go:93-99); one inverse DIT coset transform at the end.

The limb matrix of a hash, and of all the hashes of :meth:`RSis.hash_many`,
is transformed by one ``fft.fft_batch`` call, which on a small field is one
``run_batch_small`` pass: one ``ntt_f31_block`` or ``ntt_f64_block`` launch
on the card for every row at once (the JAX package batches goldilocks only
when its rows fill whole TPU tiles; the port has no such limit). Every
other step is plain tensor code on the device of the inputs.
"""

from __future__ import annotations

import functools
import hashlib

import torch

from gnark_crypto_tpu_torch.field.api import for_spec
from gnark_crypto_tpu_torch.field.kernels import to_i32
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.ntt import fft as fftm
from gnark_crypto_tpu_torch.ntt.domain import Domain
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.specs.field import FieldSpec

M32 = 0xFFFFFFFF


def _derive_element(seed: int, i: int, j: int, q: int) -> int:
    buf = b"SIS" + seed.to_bytes(8, "big") + i.to_bytes(8, "big") \
        + j.to_bytes(8, "big")
    return int.from_bytes(
        hashlib.blake2b(buf, digest_size=32).digest(), "big") % q


class RSis:
    def __init__(self, spec: FieldSpec, seed: int, log_two_degree: int,
                 log_two_bound: int, max_nb_elements: int,
                 device=DEFAULT_DEVICE):
        if log_two_bound % 8 != 0:
            raise ValueError("logTwoBound must be a multiple of 8")
        if (spec.n_bytes * 8) % log_two_bound and spec.n_bytes % (
                log_two_bound // 8):
            raise ValueError("limb size must divide the field byte size")
        self.spec = spec
        self.eng = for_spec(spec)
        self.device = torch.device(device)
        self.degree = 1 << log_two_degree
        self.log_two_bound = log_two_bound
        self.limbs_per_elem = spec.n_bytes // (log_two_bound // 8)
        n = self.limbs_per_elem * max_nb_elements
        self.n_polys = -(-n // self.degree)
        self.max_nb_elements = max_nb_elements
        q = spec.modulus
        # coset shift = generator of order 2d (sqrt of the domain generator)
        shift = pow(spec.two_adic_root,
                    1 << (spec.two_adicity - (log_two_degree + 1)), q)
        self.domain = Domain(self.eng, self.degree, shift=shift,
                             device=device)
        # The reference writes decomposed limbs straight into the Montgomery
        # slot (InnerHash: k[j][0] = l, sis.go:225), so a coefficient's VALUE
        # is l * R_ref^-1, R_ref being the Go field's radix (2^32 for the
        # 31-bit fields, 2^(64 * words) above). The hash is bilinear, so a
        # radix mismatch R_ours / R_ref is folded into the key once. Every
        # engine of this package uses R_ref itself, so the factor is 1.
        words = -(-q.bit_length() // 64)
        r_ref = (1 << (32 if q.bit_length() <= 32 else 64 * words)) % q
        self._radix_corr = spec.r * pow(r_ref, -1, q) % q
        self.set_key([[_derive_element(seed, i, j, q)
                       for j in range(self.degree)]
                      for i in range(self.n_polys)])

    def set_key(self, a_rows: list[list[int]]):
        """Install explicit key polynomials (rows of canonical ints) and
        precompute their coset-evaluation form (reference Ag)."""
        eng = self.eng
        flat = [int(v) for row in a_rows for v in row]
        if self._radix_corr != 1:
            q = self.spec.modulus
            flat = [v * self._radix_corr % q for v in flat]
        a = eng.reshape(eng.from_int(flat, device=self.device),
                        (self.n_polys, self.degree))
        self.ag = fftm.fft_batch(self.domain, a, fftm.DIF, coset=True)

    def set_key_sage(self, seed: int):
        """The reference test-vector key (sis_test.go:147
        makeKeyDeterministic): A[i][j] = (seed+i)^(2^(j+1)) mod q."""
        q = self.spec.modulus
        rows = []
        for i in range(self.n_polys):
            s = (seed + i) % q
            row = []
            for _ in range(self.degree):
                s = s * s % q
                row.append(s)
            rows.append(row)
        self.set_key(rows)

    def _decompose(self, v: torch.Tensor) -> torch.Tensor:
        """(..., N) plain field elements -> (..., n_polys, degree) elements
        whose raw Montgomery slots hold the limbs.

        Little-endian limb order within each element (LimbIterator,
        sis.go:319-342), zero-padded to the full polynomial matrix. A limb
        of b < 32 bits is one masked piece of a 32-bit word; a limb of b =
        32c bits is c consecutive words."""
        eng, b, L = self.eng, self.log_two_bound, self.limbs_per_elem
        lead = eng.eshape(v)[:-1]
        u = (v.to(torch.int64) & M32).reshape(-1, self.spec.n_words)
        if b < 32:
            shifts = torch.arange(0, 32, b, device=v.device)
            pieces = ((u[..., None] >> shifts) & ((1 << b) - 1))
            pieces = pieces.reshape(u.shape[0], -1)[:, :L, None]
        else:
            pieces = u.reshape(u.shape[0], -1, b // 32)[:, :L]
        if eng.elem_dims:
            pieces = torch.nn.functional.pad(
                pieces, (0, self.spec.n_words - pieces.shape[-1]))
        else:
            pieces = pieces[..., 0]
        per_row = eng.reshape(to_i32(pieces), (*lead, -1))
        total = self.n_polys * self.degree
        width = per_row.shape[len(lead)]
        if width > total:
            raise ValueError(f"at most {self.max_nb_elements} elements "
                             "per hash")
        pad = [0, 0] * eng.elem_dims + [0, total - width]
        m = torch.nn.functional.pad(per_row, pad)
        return eng.reshape(m, (*lead, self.n_polys, self.degree))

    def _fft_rows_coset(self, m: torch.Tensor) -> torch.Tensor:
        """Coset DIF over every (degree,) row of ``m``, one batched call."""
        return fftm.fft_batch(self.domain, m, fftm.DIF, coset=True)

    def hash(self, v: torch.Tensor) -> torch.Tensor:
        """(N,) plain field elements -> (degree,) plain hash coefficients.

        res = InvFFT_coset( sum_i FFT_coset(m_i) * Ag_i )  (sis.go:142-196).
        """
        eng = self.eng
        kf = self._fft_rows_coset(self._decompose(v))
        res = eng.sum_reduce(eng.mul(kf, self.ag))
        out = fftm.fft_inverse(self.domain, res, fftm.DIT, coset=True)
        return eng.from_mont(out)

    def hash_many(self, vs: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (B, degree): B independent hashes in one batched
        pipeline (the Vortex transversal-hash shape,
        transversal_hash.go:10-51): one forward pass over all B * n_polys
        rows and one inverse pass over the B results."""
        eng = self.eng
        m = self._decompose(vs)                      # (B, P, d)
        B, P = m.shape[:2]
        kf = self._fft_rows_coset(eng.reshape(m, (B * P, self.degree)))
        acc = eng.mul(eng.reshape(kf, (B, P, self.degree)), self.ag[None])
        res = eng.sum_reduce(acc.transpose(0, 1))    # (B, d)
        out = fftm.fft_batch(self.domain, res.contiguous(), fftm.DIT,
                             coset=True, inverse=True)
        return eng.from_mont(out)


@functools.lru_cache(maxsize=None)
def rsis(field_name: str, seed: int, log_two_degree: int, log_two_bound: int,
         max_nb_elements: int, device=DEFAULT_DEVICE) -> RSis:
    return RSis(fs.get_field(field_name), seed, log_two_degree,
                log_two_bound, max_nb_elements, device=device)
