"""Curve-dispatching pairing facade.

Counterpart of ``gnark_crypto_tpu/pairing/api.py``: protocols call
pairings through this module (reference per-curve ``Pair``/
``PairingCheck``, ``ecc/<curve>/pairing.go``). The BN/BLS12/BLS24
families run on ``pairing/pairing12.py``, BW6 on the direct sextic tower
of ``pairing/pairing6.py``. Every function runs on the device of its
inputs.
"""

from __future__ import annotations

from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.pairing import pairing6, pairing12
from gnark_crypto_tpu_torch.specs.curve import get_curve

_BW6 = ("bw6_761", "bw6_633")


def pair(name: str, P, QX, QY):
    """prod_i e(P_i, Q_i) for a batch of G1 affine points and G2 affine
    coordinates; returns one GT element."""
    if name in _BW6:
        return pairing6.pair(name, P, QX, QY)
    return pairing12.pair(name, P, QX, QY)


def pairing_check(name: str, P, QX, QY):
    """prod_i e(P_i, Q_i) == 1, as a 0-dim bool tensor."""
    if name in _BW6:
        return pairing6.pairing_check(name, P, QX, QY)
    return pairing12.pairing_check(name, P, QX, QY)


def gt_engine(name: str, device=DEFAULT_DEVICE):
    """The target-group (GT) extension engine for a curve: E6 for BW6,
    E12 or E24 for the others."""
    if name in _BW6:
        return pairing6.get_ctx6(name, device).tower.e6
    return pairing12.get_ctx(name, device).tower.e12


def gt_exp(name: str, z, e: int):
    """z^e for z in GT (reference E12.CyclotomicExp / ExpGLV: the GLV
    variant halves the squarings with the Frobenius endomorphism and is
    used when |e| is full scalar width; it is valid for order-r z). BW6:
    the E6 square-and-multiply ladder, a negative e through the conjugate
    (the unitary inverse in the cyclotomic subgroup)."""
    if name in _BW6:
        e6 = gt_engine(name, z.device)
        if e < 0:
            return e6.conjugate(e6.exp_const(z, -e))
        return e6.exp_const(z, e)
    tw = pairing12.get_ctx(name, z.device).tower
    if abs(e) >= 1 << 129:
        return tw.gt_exp_glv(z, e)
    return tw.gt_exp(z, e)


def gt_is_in_subgroup(name: str, z):
    """GT membership: z in the order-r subgroup of E12/E24/E6 (reference
    E12.IsInSubGroup, e12.go:729). Batched mask."""
    if name in _BW6:
        # the reference has no dedicated check for BW6 GT: z^r == 1
        e6 = gt_engine(name, z.device)
        r = get_curve(f"{name}_g1").fr.modulus
        return e6.equal(e6.exp_const(z, r), e6.ones())
    ctx = pairing12.get_ctx(name, z.device)
    tw = ctx.tower
    e12 = tw.e12

    def expt(x):
        r = tw.exp_cyclotomic(x, ctx.seed)
        return tw.conjugate(r) if ctx.seed_neg else r

    if ctx.family == "bn":
        # Frobenius(z) == z^(6x^2) == t-1 (bn254 e12.go:729)
        a = tw.frobenius(z)
        b = tw.cyclotomic_square(expt(expt(z)))    # z^(2x^2)
        b = e12.mul(b, tw.cyclotomic_square(b))    # z^(6x^2)
        return e12.equal(a, b)
    # BLS12/BLS24: z^(phi_k(p)) == 1 and z^(p+1-t) == 1, i.e.
    # FrobeniusSquare(z) == FrobeniusSquare(FrobeniusSquare(z))*z (k = 12;
    # FrobeniusQuad for k = 24) and Frobenius(z) == z^x (bls12-381 e12.go
    # IsInSubGroup)
    fr2 = tw.frobenius_quad if ctx.family == "bls24" else tw.frobenius_square
    a = fr2(z)
    b = e12.mul(fr2(a), z)
    cyc = e12.equal(a, b)
    tor = e12.equal(tw.frobenius(z), expt(z))
    return cyc & tor
