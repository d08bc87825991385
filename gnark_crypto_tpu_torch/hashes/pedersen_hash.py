"""Starkware Pedersen hash on the stark curve.

Counterpart of ``gnark_crypto_tpu/hashes/pedersen_hash.py`` (reference
``ecc/stark-curve/pedersen-hash/pedersen_hash.go``): H(a, b).x where the
point is

  shift + [a mod 2^248]P0 + [a >> 248]P1 + [b mod 2^248]P2 + [b >> 248]P3

(the reference's nibble tables are a fixed-base precompute of the same
scalar multiples). Batched: N pairs a call, each part a bit ladder over the
N lanes on the stark point kernels (a = 1, 8 words): one ``jac_double``
and one ``jac_add`` launch a bit over the whole batch on the card.
"""

from __future__ import annotations

from gnark_crypto_tpu_torch.curve.jacobian import (Affine, Curve, Jac,
                                                   curve_ops)
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs.curve import get_curve

# constants from pedersen_hash.go init() (Starkware reference points)
SHIFT = (2089986280348253421170679821480865132823066470938446095505822317253594081284,
         1713931329540660377023406109199410414810705867260802078187082345529207694986)
P = [
    (996781205833008774514500082376783249102396023663454813447423147977397232763,
     1668503676786377725805489344771023921079126552019160156920634619255970485781),
    (2251563274489750535117886426533222435294046428347329203627021249169616184184,
     1798716007562728905295480679789526322175868328062420237419143593021674992973),
    (2138414695194151160943305727036575959195309218611738193261179310511854807447,
     113410276730064486255102093846540133784865286929052426931474106396135072156),
    (2379962749567351885752724891227938183011949129833673362440656643086021394946,
     776496453633298175483985398648758586525933812536653089401905292063708816422),
]

_MASK248 = (1 << 248) - 1


def _point(curve: Curve, xy, n: int, device) -> Jac:
    """The affine point xy broadcast to n lanes, in Jacobian
    coordinates."""
    f = curve.fp
    return curve.from_affine(Affine(
        f.broadcast_to(f.from_int(xy[0], device=device), (n,)),
        f.broadcast_to(f.from_int(xy[1], device=device), (n,))))


def pedersen(a_vals: list[int], b_vals: list[int], device=DEFAULT_DEVICE
             ) -> list[int]:
    """Batched Pedersen(a, b) -> x coordinates (ints). pedersen_hash.go:77."""
    curve = curve_ops(get_curve("stark_g1"))
    n = len(a_vals)
    acc = _point(curve, SHIFT, n, device)
    parts = [
        ([a & _MASK248 for a in a_vals], P[0], 248),
        ([a >> 248 for a in a_vals], P[1], 4),
        ([b & _MASK248 for b in b_vals], P[2], 248),
        ([b >> 248 for b in b_vals], P[3], 4),
    ]
    for ks, base, nbits in parts:
        # raw scalars below 2^248 < r: as Fr words they are not reduced
        acc = curve.add(acc, curve.scalar_mul(
            _point(curve, base, n, device),
            curve.fr.from_int(ks, mont=False, device=device), nbits))
    aff = curve.to_affine(acc)
    return curve.fp.to_int(aff.x)


def pedersen_array(elems: list[int], device=DEFAULT_DEVICE) -> int:
    """PedersenArray: left fold + length absorption (pedersen_hash.go:64)."""
    d = 0
    for e in elems:
        d = pedersen([d], [e], device)[0]
    return pedersen([d], [len(elems)], device)[0]
