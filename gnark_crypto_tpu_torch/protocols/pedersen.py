"""Pedersen vector commitment with proof of knowledge (sigma-G2 trapdoor).

Counterpart of ``gnark_crypto_tpu/protocols/pedersen.py`` (reference
``ecc/<curve>/fr/pedersen/pedersen.go``), output for output:

  Setup: trapdoor sigma; pk = (basis, basis^sigma); vk = (G2, G2^-sigma)
  Commit = MSM(basis, values); ProveKnowledge = MSM(basis^sigma, values)
  Verify: e(commitment, G2^-sigma) * e(pok, G2) == 1  (pedersen.go:198)
  BatchProve / fold with combination coefficient powers (pedersen.go:145).

Points are the port's affine batches, values plain Fr words ``(n, W)``;
everything runs where the bases live. ``setup`` ladders one G2 point: over
Fp2 for bn254 and bls12 (the Fp2 point kernels on the card), over Fp for
bw6 (the G1 kernels), over Fp4 for bls24 (field ops: its group law runs,
``scalar_mul`` only). The commitments are G1 MSMs and ``verify`` one
pairing check, so every pairing curve runs; the tests and ``chip_smoke.py``
take bn254 and bw6-761.
"""

from __future__ import annotations

import dataclasses

import torch

from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.msm.pippenger import msm
from gnark_crypto_tpu_torch.pairing import api as pairing_api
from gnark_crypto_tpu_torch.specs import curve as cs


@dataclasses.dataclass
class ProvingKey:
    basis: Affine
    basis_exp_sigma: Affine


@dataclasses.dataclass
class VerifyingKey:
    g: Affine            # G2 point (batch of 1)
    g_sigma_neg: Affine  # [-sigma] G2


def _g1(name: str):
    return curve_ops(cs.get_curve(f"{name}_g1"))


def _one_point(g1c, res: Jac) -> Affine:
    return g1c.to_affine(Jac(*(c[None] for c in res)))


def setup(name: str, bases: list[Affine], sigma: int, g2_scalar: int = 1):
    """Trusted setup (pedersen.go:65). sigma and g2_scalar come from the
    caller (the reference samples them from crypto/rand). Each ladder runs
    over its scalar's own bits, on the bases' device."""
    g1c = _g1(name)
    dev = bases[0].x.device
    g2c = g2_curve(name, dev)
    r = g1c.spec.fr.modulus
    sigma = sigma % r
    k2 = g2_scalar % r
    neg = (-sigma) % r

    def g2_mul(p: Jac, k: int) -> Affine:
        return g2c.to_affine(g2c.scalar_mul(
            p, g2c.fr.from_int([k], mont=False, device=dev),
            nbits=max(1, k.bit_length())))

    gen = g2c.generator_affine(device=dev)
    g = g2_mul(Jac(*(c[None] for c in g2c.from_affine(gen))), k2)
    g_sigma_neg = g2_mul(g2c.from_affine(g), neg)

    pks = []
    for basis in bases:
        n = basis.x.shape[0]
        k = g1c.fr.from_int([sigma] * n, mont=False, device=dev)
        exp_sigma = g1c.to_affine(g1c.scalar_mul(
            g1c.from_affine(basis), k, nbits=max(1, sigma.bit_length())))
        pks.append(ProvingKey(basis, exp_sigma))
    return pks, VerifyingKey(g, g_sigma_neg)


def commit(name: str, pk: ProvingKey, values: torch.Tensor) -> Affine:
    g1c = _g1(name)
    return _one_point(g1c, msm(g1c.spec, pk.basis, values))


def prove_knowledge(name: str, pk: ProvingKey, values: torch.Tensor
                    ) -> Affine:
    g1c = _g1(name)
    return _one_point(g1c, msm(g1c.spec, pk.basis_exp_sigma, values))


def verify(name: str, vk: VerifyingKey, commitment: Affine, pok: Affine
           ) -> torch.Tensor:
    """e(commitment, -sigma G2) * e(pok, G2) == 1 (pedersen.go:204)."""
    P = Affine(torch.cat([commitment.x, pok.x]),
               torch.cat([commitment.y, pok.y]))
    qx = torch.cat([vk.g_sigma_neg.x, vk.g.x])
    qy = torch.cat([vk.g_sigma_neg.y, vk.g.y])
    return pairing_api.pairing_check(name, P, qx, qy)


def fold_commitments(name: str, commitments: list[Affine], coeff: int
                     ) -> Affine:
    """sum coeff^i * C_i (curve.Fold semantics used by BatchProve)."""
    g1c = _g1(name)
    r = g1c.spec.fr.modulus
    pts = Affine(torch.cat([c.x for c in commitments]),
                 torch.cat([c.y for c in commitments]))
    scalars = g1c.fr.from_int([pow(coeff, i, r)
                               for i in range(len(commitments))],
                              mont=False, device=pts.x.device)
    return _one_point(g1c, msm(g1c.spec, pts, scalars, c=4))


def batch_verify_multi_vk(name: str, vks: list[VerifyingKey],
                          commitments: list[Affine], poks: list[Affine],
                          coeff: int) -> torch.Tensor:
    """Verify several separate PoKs with n+1 pairings instead of 2n
    (pedersen.go:227 BatchVerifyMultiVk).

    The vks may come from different ceremonies but must share the G2 point
    (the reference enforces vk[i].G == vk[0].G). ``poks`` is either one
    proof per vk, or a single already-folded proof. ``coeff`` is the
    verifier's random combination coefficient: the check is
    e(C_0, -s_0 G2) * prod_i e([coeff^i]C_i, -s_i G2) * e(fold(poks), G2).
    """
    g1c = _g1(name)
    r = g1c.spec.fr.modulus
    k = len(vks)
    if len(commitments) != k:
        raise ValueError("commitments length mismatch")
    if len(poks) not in (k, 1):
        raise ValueError("pok length mismatch")
    dev = commitments[0].x.device
    g1s = [commitments[0]]
    for i in range(1, k):
        c = pow(coeff, i, r)
        s = g1c.fr.from_int([c], mont=False, device=dev)
        g1s.append(g1c.to_affine(g1c.scalar_mul(
            g1c.from_affine(commitments[i]), s,
            nbits=max(1, c.bit_length()))))
    folded_pok = poks[0] if len(poks) == 1 else \
        fold_commitments(name, poks, coeff)
    P = Affine(torch.cat([p.x for p in g1s] + [folded_pok.x]),
               torch.cat([p.y for p in g1s] + [folded_pok.y]))
    qx = torch.cat([vk.g_sigma_neg.x for vk in vks] + [vks[0].g.x])
    qy = torch.cat([vk.g_sigma_neg.y for vk in vks] + [vks[0].g.y])
    return pairing_api.pairing_check(name, P, qx, qy)


def batch_prove(name: str, pks: list[ProvingKey], values: list,
                coeff: int) -> Affine:
    """Single PoK for several commitments (pedersen.go:145): fold the
    values with the powers of coeff, basis by basis, then one MSM over the
    concatenated sigma-bases."""
    g1c = _g1(name)
    fr = g1c.fr
    r = g1c.spec.fr.modulus
    folded = [fr.mul(v, fr.from_int(pow(coeff, i, r), device=v.device))
              for i, v in enumerate(values)]
    bx = torch.cat([pk.basis_exp_sigma.x for pk in pks])
    by = torch.cat([pk.basis_exp_sigma.y for pk in pks])
    return _one_point(g1c, msm(g1c.spec, Affine(bx, by),
                               torch.cat(folded)))
