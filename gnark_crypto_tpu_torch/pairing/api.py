"""Curve-dispatching pairing facade.

Counterpart of ``gnark_crypto_tpu/pairing/api.py``: protocols call
pairings through this module (reference per-curve ``Pair``/
``PairingCheck``, ``ecc/<curve>/pairing.go``). The BN/BLS12/BLS24
families run on ``pairing/pairing12.py``; BW6 is not ported yet
(ROADMAP.md queue 1, item 4). Every function runs on the device of its
inputs.
"""

from __future__ import annotations

from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.pairing import pairing12

_LATER = ("bw6_761", "bw6_633")


def _ctx(name: str, device):
    if name in _LATER:
        raise NotImplementedError(
            f"{name}: the BW6 pairings are not ported yet (ROADMAP.md "
            "queue 1, item 4)")
    return pairing12.get_ctx(name, device)


def pair(name: str, P, QX, QY):
    """prod_i e(P_i, Q_i) for a batch of G1 affine points and G2 affine
    coordinates; returns one GT element."""
    _ctx(name, P.x.device)
    return pairing12.pair(name, P, QX, QY)


def pairing_check(name: str, P, QX, QY):
    """prod_i e(P_i, Q_i) == 1, as a 0-dim bool tensor."""
    _ctx(name, P.x.device)
    return pairing12.pairing_check(name, P, QX, QY)


def gt_engine(name: str, device=DEFAULT_DEVICE):
    """The target-group (GT) extension engine for a curve."""
    return _ctx(name, device).tower.e12


def gt_exp(name: str, z, e: int):
    """z^e for z in GT (reference E12.CyclotomicExp / ExpGLV: the GLV
    variant halves the squarings with the Frobenius endomorphism and is
    used when |e| is full scalar width; it is valid for order-r z)."""
    tw = _ctx(name, z.device).tower
    if abs(e) >= 1 << 129:
        return tw.gt_exp_glv(z, e)
    return tw.gt_exp(z, e)


def gt_is_in_subgroup(name: str, z):
    """GT membership: z in the order-r subgroup of E12 (reference
    E12.IsInSubGroup, e12.go:729). Batched mask."""
    ctx = _ctx(name, z.device)
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
