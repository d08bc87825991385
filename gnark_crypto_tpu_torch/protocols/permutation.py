"""Permutation proof: t2 is a permutation of t1 (PLONK-style grand product
over KZG).

Counterpart of ``gnark_crypto_tpu/protocols/permutation.py`` (reference
``ecc/<curve>/fr/permutation/permutation.go``), proof for proof: the same
Fiat-Shamir transcript over the raw point encodings, so the same
challenges and the same points. Protocol (permutation.go:131 Prove / :257
Verify):

  Z(w^0)=1, Z(w^{i+1}) = Z(w^i) * (eps - t1_i)/(eps - t2_i)
  identity on the coset:  Z(gx)(eps - t2) - Z(x)(eps - t1)
                          + omega * L0(x)(Z(x) - 1) = q(x) (X^n - 1)
  openings of t1, t2, Z, q at eta (batched) + Z at g*eta.

The prover runs where its tables live: three inverse NTTs, three coset
NTTs, one coset inverse, four KZG commits and two openings. The
accumulator is one batch inversion and a log-stride prefix product; the
coset values 1/(u g^i - 1), which the reference takes with a Python
``pow`` per element (``permutation.py:113-114``), are powers by
``exp_table`` and one batch inversion on the device. Any pairing curve
works: bn254, bls12-381/377, bls24-315/317, bw6-761/633.
"""

from __future__ import annotations

import dataclasses

import torch

from gnark_crypto_tpu_torch.curve.jacobian import Affine, curve_ops
from gnark_crypto_tpu_torch.hashes.fiat_shamir import Transcript
from gnark_crypto_tpu_torch.io.marshal import PointCodec
from gnark_crypto_tpu_torch.ntt import fft as fftm
from gnark_crypto_tpu_torch.protocols import kzg
from gnark_crypto_tpu_torch.protocols.iop import domain
from gnark_crypto_tpu_torch.specs import curve as cs
from gnark_crypto_tpu_torch.utils.scans import (
    exclusive_prefix_product, exp_table)


@dataclasses.dataclass
class Proof:
    size: int
    t1: Affine
    t2: Affine
    z: Affine
    q: Affine
    batched: kzg.BatchOpeningProof
    shifted: kzg.OpeningProof


def _g1(name: str):
    return curve_ops(cs.get_curve(f"{name}_g1"))


def _derive(t: Transcript, cid: str, digests, g1c) -> int:
    codec = PointCodec(g1c)
    for d in digests:
        t.bind(cid, codec.to_bytes(d, raw=True)[0])
    b = t.compute_challenge(cid)
    return int.from_bytes(b, "big") % g1c.spec.fr.modulus


def _ifft_natural(dom, eng, vals_plain: torch.Tensor) -> torch.Tensor:
    """Lagrange (natural) -> canonical (natural) coefficients."""
    m = eng.to_mont(vals_plain)
    return eng.from_mont(fftm.fft_inverse(dom, fftm.bit_reverse(m),
                                          fftm.DIT))


def _coset_evals(dom, eng, coeffs_plain: torch.Tensor) -> torch.Tensor:
    """canonical (natural) -> coset Lagrange (natural)."""
    m = eng.to_mont(coeffs_plain)
    return eng.from_mont(fftm.bit_reverse(fftm.fft(dom, m, fftm.DIF,
                                                   coset=True)))


def prove(name: str, pk: kzg.ProvingKey, t1: torch.Tensor,
          t2: torch.Tensor) -> Proof:
    """t1, t2: plain Fr (s, W) on one device, s a power of two."""
    g1c = _g1(name)
    eng = g1c.fr
    r = g1c.spec.fr.modulus
    s = t1.shape[0]
    dev = t1.device
    dom = domain(g1c.spec.fr, s, dev)
    fs = Transcript(challenge_ids=["epsilon", "omega", "eta"])

    ct1 = _ifft_natural(dom, eng, t1)
    ct2 = _ifft_natural(dom, eng, t2)
    com_t1 = kzg.commit(name, pk, ct1)
    com_t2 = kzg.commit(name, pk, ct2)
    epsilon = _derive(fs, "epsilon", [com_t1, com_t2], g1c)

    # grand product Z (natural Lagrange order)
    eps_m = eng.from_int(epsilon, device=dev)
    ratio = eng.mul(eng.sub(eps_m, eng.to_mont(t1)),
                    eng.batch_inverse(eng.sub(eps_m, eng.to_mont(t2))))
    lz_m = exclusive_prefix_product(eng, ratio)
    cz = _ifft_natural(dom, eng, eng.from_mont(lz_m))
    com_z = kzg.commit(name, pk, cz)
    omega = _derive(fs, "omega", [com_z], g1c)

    # coset evaluations
    lt1 = eng.to_mont(_coset_evals(dom, eng, ct1))
    lt2 = eng.to_mont(_coset_evals(dom, eng, ct2))
    lz = eng.to_mont(_coset_evals(dom, eng, cz))
    lz_shift = torch.cat([lz[1:], lz[:1]], dim=0)
    part1 = eng.sub(eng.mul(lz_shift, eng.sub(eps_m, lt2)),
                    eng.mul(lz, eng.sub(eps_m, lt1)))
    # part2 = L0-ish term: (z - 1) * (u^n - 1) / (x_i - 1) on the coset,
    # x_i = u g^i
    u = dom.shift_int
    tn = (pow(u, s, r) - 1) % r
    xs = eng.mul(exp_table(eng, eng.from_int([dom.generator_int],
                                             device=dev), s),
                 eng.from_int(u, device=dev))
    one = eng.ones((), device=dev)
    scale = eng.mul(eng.batch_inverse(eng.sub(xs, one)),
                    eng.from_int(tn, device=dev))
    part2 = eng.mul(eng.sub(lz, one), scale)

    om_m = eng.from_int(omega, device=dev)
    tn_inv = eng.from_int(pow(tn, -1, r), device=dev)
    lsnum = eng.mul(eng.add(eng.mul(om_m, part2), part1), tn_inv)
    # back to canonical: coset Lagrange natural -> canonical
    q_coeffs = eng.from_mont(fftm.fft_inverse(
        dom, fftm.bit_reverse(lsnum), fftm.DIT, coset=True))
    com_q = kzg.commit(name, pk, q_coeffs)
    eta = _derive(fs, "eta", [com_q], g1c)

    eta_dev = eng.from_int([eta], mont=False, device=dev)
    polys = torch.stack([ct1, ct2, cz, q_coeffs])
    batched = kzg.batch_open_single_point(
        name, pk, polys, eta_dev, digests=[com_t1, com_t2, com_z, com_q])
    shifted_pt = eng.from_int([eta * dom.generator_int % r], mont=False,
                              device=dev)
    shifted = kzg.open_poly(name, pk, cz, shifted_pt)
    return Proof(size=s, t1=com_t1, t2=com_t2, z=com_z, q=com_q,
                 batched=batched, shifted=shifted)


def verify(name: str, vk: kzg.VerifyingKey, proof: Proof) -> bool:
    """The algebraic relation at eta on host integers, then the two KZG
    checks (each one pairing check, where the proof's points live)."""
    g1c = _g1(name)
    eng = g1c.fr
    r = g1c.spec.fr.modulus
    s = proof.size
    fs = Transcript(challenge_ids=["epsilon", "omega", "eta"])
    epsilon = _derive(fs, "epsilon", [proof.t1, proof.t2], g1c)
    omega = _derive(fs, "omega", [proof.z], g1c)
    eta = _derive(fs, "eta", [proof.q], g1c)

    cv = eng.to_int(proof.batched.claimed_values, mont=False)
    z_shift = eng.to_int(proof.shifted.claimed_value, mont=False)[0]
    # relation: (eps - t2(eta)) z(g eta) - (eps - t1(eta)) z(eta)
    #           + omega * L0(eta) (z(eta)-1) == q(eta) (eta^n - 1)
    rhs = (pow(eta, s, r) - 1) % r
    l0 = rhs * pow((eta - 1) % r, -1, r) % r
    rhs = rhs * cv[3] % r
    lhs = ((epsilon - cv[1]) * z_shift - (epsilon - cv[0]) * cv[2]) % r
    lhs = (lhs + omega * l0 % r * ((cv[2] - 1) % r)) % r
    if lhs != rhs:
        return False

    dev = proof.t1.x.device
    gen = pow(g1c.spec.fr.two_adic_root,
              1 << (g1c.spec.fr.two_adicity - (s.bit_length() - 1)), r)
    eta_dev = eng.from_int([eta], mont=False, device=dev)
    ok1 = kzg.batch_verify_single_point(
        name, [proof.t1, proof.t2, proof.z, proof.q], proof.batched,
        eta_dev, vk)
    shifted_pt = eng.from_int([eta * gen % r], mont=False, device=dev)
    ok2 = kzg.verify(name, proof.z, proof.shifted, shifted_pt, vk)
    return bool(ok1) and bool(ok2)
