"""KZG polynomial commitment: commit, open, verify and the batch forms.

Counterpart of ``gnark_crypto_tpu/protocols/kzg.py`` (reference
``ecc/bn254/kzg/kzg.go``), run eagerly where its tensors live:

* commit is one G1 MSM over the SRS (kzg.go:160);
* open gives the claimed value and the quotient (p(X) - p(a)) / (X - a).
  The reference's synthetic division (kzg.go:595) is a serial recurrence;
  here q_i = (p(a) - s_i) * a^-(i+1), with s_i the prefix sums of p_j a^j:
  two log-depth scans (``utils/scans.py``), then one MSM;
* verify is the 2-pairing check e([y]G1 - [a]H - C, G2) e(H, [alpha]G2)
  == 1 (kzg.go:208), [y]G1 + [-a]H by one joint ladder;
* BatchOpenSinglePoint, FoldProof and BatchVerifyMultiPoints with the
  same Fiat-Shamir gamma (kzg.go:255,350,423,559).

Polynomials, points and claimed values are plain (non-Montgomery) Fr
words: a polynomial ``(n, W)``, a point or value ``(1, W)``. Commitments
and quotients are affine G1 batches of one point, as in the JAX package.
Any pairing curve works: bn254, bls12-381/377, bls24-315/317 and
bw6-761/633, on the card or on the CPU's plain versions.

Not ported yet (ROADMAP.md queue 1, item 3): ``VerifyingKey.with_lines``
and the fixed-Q pairing of ``pairing/lines.py``; ``new_srs`` computes
[alpha]G2 with the G2 group law's ladder, not the GLS ladder of
``curve/glv.py``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.hashes.fiat_shamir import Transcript
from gnark_crypto_tpu_torch.io.marshal import PointCodec
from gnark_crypto_tpu_torch.msm.pippenger import batch_scalar_mul, msm
from gnark_crypto_tpu_torch.pairing import api as pairing_api
from gnark_crypto_tpu_torch.specs import curve as cs
from gnark_crypto_tpu_torch.utils.scans import exp_table, prefix_sum


_NO_LINES = ("precomputed pairing lines: the fixed-Q pairing of "
             "pairing/lines.py is not ported yet (ROADMAP.md queue 1, "
             "item 3)")


@dataclasses.dataclass
class ProvingKey:
    g1: Affine  # [alpha^i]G1, batch (size,)


@dataclasses.dataclass
class VerifyingKey:
    g2: Affine        # [1]G2, batch (1,): Fp2 coordinates (1, 2, W), or
                      # Fp4 coordinates (1, 2, 2, W) for BLS24
    alpha_g2: Affine  # [alpha]G2
    g1: Affine        # [1]G1
    # precomputed pairing lines for [g2, alpha_g2] (reference kzg.go:45
    # Lines field); None runs the full Miller loop
    lines: object = None

    def with_lines(self, name: str) -> "VerifyingKey":
        """Attach fixed-Q line tables (reference kzg.go:114-123)."""
        raise NotImplementedError(_NO_LINES)


@dataclasses.dataclass
class SRS:
    pk: ProvingKey
    vk: VerifyingKey


@dataclasses.dataclass
class OpeningProof:
    h: Affine                   # quotient commitment (1,)
    claimed_value: torch.Tensor  # plain Fr (1, W)


@dataclasses.dataclass
class BatchOpeningProof:
    h: Affine
    claimed_values: torch.Tensor  # plain Fr (k, W)


def _g1(name: str):
    return curve_ops(cs.get_curve(f"{name}_g1"))


def _as_batch(p: Jac) -> Jac:
    return Jac(*(c[None] for c in p))


def new_srs(name: str, size: int, alpha: int, device=DEFAULT_DEVICE) -> SRS:
    """SRS from the secret alpha (kzg.go:73 NewSRS); for tests and
    benchmarks: a production SRS comes from an MPC ceremony."""
    g1c = _g1(name)
    g2c = g2_curve(name, device)
    r = g1c.spec.fr.modulus
    # alpha^i for i < size on the device (log2(size) masked products), as
    # the plain scalars of the ladder
    k = g1c.fr.from_mont(exp_table(
        g1c.fr, g1c.fr.from_int([alpha % r], device=device), size))
    g = g1c.generator_affine(device=device)
    # one-base batch mul: a shared window table, nbits/c adds per power
    # (the reference's BatchScalarMultiplicationG1 call in kzg.go:73)
    pk_g1 = g1c.to_affine(batch_scalar_mul(g1c.spec, g, k))
    g2gen = g2c.generator_affine(device=device)
    g2b = Jac(*(c[None] for c in g2c.from_affine(g2gen)))
    # the ladder runs over alpha's own bits: no doublings of infinity
    alpha_g2 = g2c.to_affine(g2c.scalar_mul(
        g2b, g2c.fr.from_int([alpha % r], mont=False, device=device),
        nbits=max(1, (alpha % r).bit_length())))
    g2_aff = Affine(g2gen.x[None], g2gen.y[None])
    g1_aff = Affine(g.x[None], g.y[None])
    return SRS(ProvingKey(pk_g1), VerifyingKey(g2_aff, alpha_g2, g1_aff))


def commit(name: str, pk: ProvingKey, poly: torch.Tensor) -> Affine:
    """Commit = MSM(SRS, coefficients) (kzg.go:160)."""
    g1c = _g1(name)
    n = poly.shape[0]
    pts = Affine(pk.g1.x[:n], pk.g1.y[:n])
    return g1c.to_affine(_as_batch(msm(g1c.spec, pts, poly)))


def eval_poly(name: str, poly: torch.Tensor, point: torch.Tensor
              ) -> torch.Tensor:
    """p(a) = <coefficients, powers of a> (kzg.go:56 eval); plain (1, W)."""
    fr = _g1(name).fr
    pows = exp_table(fr, fr.to_mont(point), poly.shape[0])
    return fr.from_mont(fr.inner_product(fr.to_mont(poly), pows))[None]


def _open_div_fn(name: str):
    """The synthetic-division core: (quotient (n-1, W), p(a) (1, W)),
    both plain."""
    fr = _g1(name).fr

    def div(poly: torch.Tensor, point: torch.Tensor):
        n = poly.shape[0]
        a_m = fr.to_mont(point)                      # (1, W) Montgomery
        pows = exp_table(fr, a_m, n)                 # a^i
        pm = fr.to_mont(poly)
        s = prefix_sum(fr, fr.mul(pm, pows))         # s_i
        total = s[n - 1:n]
        inv_pows = exp_table(fr, fr.inverse(a_m), n + 1)   # a^-i
        # q_i = (total - s_i) * a^-(i+1); for a == 0, q_i = p_(i+1)
        if bool(fr.is_zero(a_m).all()):
            q = torch.cat([pm[1:], fr.zeros((1,), device=pm.device)])
        else:
            q = fr.mul(fr.sub(total.expand_as(s), s), inv_pows[1:])
        q = fr.from_mont(q)[: n - 1] if n > 1 else fr.zeros(
            (1,), device=pm.device)
        # s_(n-1) = p(a) covers a = 0 too (only the p_0 term survives)
        return q, fr.from_mont(total)

    return div


def _inf_aff(g1c, device) -> Affine:
    z = g1c.fp.zeros((1,), device=device)
    return Affine(z, z)


def open_poly(name: str, pk: ProvingKey, poly: torch.Tensor,
              point: torch.Tensor) -> OpeningProof:
    """Opening proof at ``point`` (kzg.go:181 Open)."""
    n = poly.shape[0]
    q, claimed = _open_div_fn(name)(poly, point)
    h = (commit(name, pk, q) if n > 1
         else _inf_aff(_g1(name), poly.device))
    return OpeningProof(h=h, claimed_value=claimed)


def _fr_neg_plain(fr, k: torch.Tensor) -> torch.Tensor:
    return fr.from_mont(fr.neg(fr.to_mont(k)))


def _pairing_check(name: str, P: Affine, vk: VerifyingKey) -> torch.Tensor:
    """e(P_0, G2) e(P_1, [alpha]G2) == 1. The G2 coordinates concatenate
    along the batch axis, (2, 2, W) over Fp2 or (2, 2, 2, W) over Fp4."""
    if vk.lines is not None:
        raise NotImplementedError(_NO_LINES)
    qx = torch.cat([vk.g2.x, vk.alpha_g2.x])
    qy = torch.cat([vk.g2.y, vk.alpha_g2.y])
    return pairing_api.pairing_check(name, P, qx, qy)


def verify(name: str, commitment: Affine, proof: OpeningProof,
           point: torch.Tensor, vk: VerifyingKey) -> torch.Tensor:
    """Single-point verification (kzg.go:208): checks
    e([y]G1 - [a]H - C, G2) * e(H, [alpha]G2) == 1."""
    g1c = _g1(name)
    neg_a = _fr_neg_plain(g1c.fr, point)
    # one shared doubling chain for [y]G1 + [-a]H (Strauss-Shamir,
    # g1.go:873)
    t = g1c.joint_scalar_mul(g1c.from_affine(vk.g1),
                             g1c.from_affine(proof.h),
                             proof.claimed_value, neg_a)
    total = g1c.to_affine(g1c.add(t, g1c.neg_jac(
        g1c.from_affine(commitment))))
    P = Affine(torch.cat([total.x, proof.h.x]),
               torch.cat([total.y, proof.h.y]))
    return _pairing_check(name, P, vk)


# ---------------------------------------------------------------------------
# batch opening at a single point (Fiat-Shamir folding)
# ---------------------------------------------------------------------------

def _derive_gamma(name: str, point, digests, claimed_values,
                  data_transcript: bytes = b"") -> int:
    """deriveGamma (kzg.go:559): a sha256 transcript binding the point, the
    compressed digests and the claimed values; a plain Fr integer."""
    g1c = _g1(name)
    fr = g1c.fr
    codec = PointCodec(g1c)
    t = Transcript(challenge_ids=["gamma"])
    t.bind("gamma", fr.to_bytes_host(point, mont=False)[0])
    for d in digests:
        # gnark's digest.Marshal() is the compressed encoding
        t.bind("gamma", codec.to_bytes(d)[0])
    for v in claimed_values:
        t.bind("gamma", fr.to_bytes_host(v, mont=False)[0])
    if data_transcript:
        t.bind("gamma", data_transcript)
    b = t.compute_challenge("gamma")
    return int.from_bytes(b, "big") % fr.spec.modulus


def batch_open_single_point(name: str, pk: ProvingKey, polys: torch.Tensor,
                            point: torch.Tensor, digests=None
                            ) -> BatchOpeningProof:
    """BatchOpenSinglePoint (kzg.go:255): fold the (k, n, W) polynomials
    with powers of gamma and open the folded polynomial."""
    fr = _g1(name).fr
    k = polys.shape[0]
    if digests is None:
        digests = [commit(name, pk, polys[i]) for i in range(k)]
    claimed = [eval_poly(name, polys[i], point) for i in range(k)]
    gamma = _derive_gamma(name, point, digests, claimed)
    gammas = [pow(gamma, i, fr.spec.modulus) for i in range(k)]
    g_m = fr.from_int(gammas, device=polys.device)     # Montgomery
    folded = fr.from_mont(fr.sum_reduce(fr.mul(fr.to_mont(polys),
                                               g_m[:, None])))
    proof = open_poly(name, pk, folded, point)
    return BatchOpeningProof(h=proof.h,
                             claimed_values=torch.cat(claimed))


def batch_verify_single_point(name: str, digests, batch_proof, point,
                              vk: VerifyingKey) -> torch.Tensor:
    """FoldProof + Verify (kzg.go:350 FoldProof, :208)."""
    g1c = _g1(name)
    fr = g1c.fr
    k = len(digests)
    claimed = [batch_proof.claimed_values[i:i + 1] for i in range(k)]
    gamma = _derive_gamma(name, point, digests, claimed)
    gammas = [pow(gamma, i, fr.spec.modulus) for i in range(k)]
    dev = point.device
    g_plain = fr.from_int(gammas, mont=False, device=dev)
    # folded digest = sum gamma^i D_i (an MSM over the digests)
    D = Affine(torch.cat([d.x for d in digests]),
               torch.cat([d.y for d in digests]))
    folded_digest = g1c.to_affine(_as_batch(msm(g1c.spec, D, g_plain,
                                                c=4)))
    folded_claimed = fr.from_mont(fr.inner_product(
        fr.to_mont(batch_proof.claimed_values), fr.to_mont(g_plain)))[None]
    proof = OpeningProof(h=batch_proof.h, claimed_value=folded_claimed)
    return verify(name, folded_digest, proof, point, vk)


# ---------------------------------------------------------------------------
# batch verification of openings at distinct points (one pairing check)
# ---------------------------------------------------------------------------

def _point_int(fr, point) -> int:
    if isinstance(point, int):
        return point % fr.spec.modulus
    v = fr.to_int(point, mont=False)
    return v[0] if isinstance(v, list) else v


def _as_fr(fr, point, device) -> torch.Tensor:
    """int or plain (1, W) Fr -> plain (1, W) Fr."""
    if isinstance(point, int):
        return fr.from_int([point % fr.spec.modulus], mont=False,
                           device=device)
    return point


def batch_verify_multi_points(name: str, digests, proofs, points,
                              vk: VerifyingKey, lambdas=None
                              ) -> torch.Tensor:
    """BatchVerifyMultiPoints (kzg.go:423): k openings at k distinct points
    in one pairing check, through a random linear combination with
    lambda_0 = 1:

      e(sum_i l_i ([f_i(a)]G1 - [y_i]G1 + [p_i][H_i]), G2)
      * e(-sum_i l_i [H_i], [alpha]G2) == 1.

    digests: k affine (1,) commitments; proofs: k OpeningProof; points: k
    plain Fr (1, W) tensors or ints; lambdas: k host ints (lambda_0 is
    forced to 1), sampled from os.urandom when not given, as the reference
    samples crypto/rand.
    """
    g1c = _g1(name)
    fr = g1c.fr
    r = fr.spec.modulus
    k = len(digests)
    if len(proofs) != k or len(points) != k:
        raise ValueError("digests/proofs/points length mismatch")
    if k == 0:
        raise ValueError("zero digests")
    dev = digests[0].x.device
    if k == 1:
        return verify(name, digests[0], proofs[0],
                      _as_fr(fr, points[0], dev), vk)
    if lambdas is None:
        lambdas = [1] + [int.from_bytes(os.urandom(31), "big") % r
                         for _ in range(k - 1)]
    lambdas = [1] + [int(v) % r for v in lambdas[1:]]

    H = Affine(torch.cat([p.h.x for p in proofs]),
               torch.cat([p.h.y for p in proofs]))
    lam = fr.from_int(lambdas, mont=False, device=dev)
    folded_quotients = msm(g1c.spec, H, lam, c=4)            # sum l_i H_i
    D = Affine(torch.cat([d.x for d in digests]),
               torch.cat([d.y for d in digests]))
    folded_digests = msm(g1c.spec, D, lam, c=4)              # sum l_i D_i
    # sum l_i y_i and the scalars l_i p_i (host fold of tiny values)
    pts_int = [_point_int(fr, p) for p in points]
    evals = torch.cat([p.claimed_value[:1] for p in proofs])
    folded_evals = fr.from_mont(fr.inner_product(fr.to_mont(evals),
                                                 fr.to_mont(lam)))[None]
    lam_pts = fr.from_int([lambdas[i] * pts_int[i] % r for i in range(k)],
                          mont=False, device=dev)
    evals_commit = Jac(*(c[0] for c in g1c.scalar_mul(
        g1c.from_affine(vk.g1), folded_evals)))          # [sum l_i y_i]G1
    folded_pts_quotients = msm(g1c.spec, H, lam_pts, c=4)
    total = g1c.add(folded_digests, g1c.neg_jac(evals_commit))
    total = g1c.add(total, folded_pts_quotients)
    total_aff = g1c.to_affine(_as_batch(total))
    neg_q_aff = g1c.to_affine(_as_batch(g1c.neg_jac(folded_quotients)))
    P = Affine(torch.cat([total_aff.x, neg_q_aff.x]),
               torch.cat([total_aff.y, neg_q_aff.y]))
    return _pairing_check(name, P, vk)
