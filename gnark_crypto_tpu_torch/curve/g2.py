"""G2 groups: the short-Weierstrass group law instantiated over Fp2.

Counterpart of ``gnark_crypto_tpu/curve/g2.py``. The reference generates a
parallel implementation for G2 (``ecc/<curve>/g2.go``); here the generic
Jacobian code (``curve/jacobian.py``) runs over the quadratic-extension
engine of the curve's pairing tower. Constants from each curve's init()
(``bn254.go:124-128``, ``bls12-381.go:119-124``, ``bls12-377.go``); the
twist coefficient b' comes from the pairing context (``pairing12.py``).
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.curve.jacobian import Curve, curve_ops
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.pairing.pairing12 import get_ctx
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.specs.curve import CurveSpec, get_curve

_G2 = {
    "bn254": dict(
        fr=fs.BN254_FR,
        fp=fs.BN254_FP,
        gx=(10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634),
        gy=(8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531),
    ),
    "bls12_381": dict(
        fr=fs.BLS12_381_FR,
        fp=fs.BLS12_381_FP,
        gx=(352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
            3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758),
        gy=(1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
            927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582),
    ),
    "bls12_377": dict(
        fr=fs.BLS12_377_FR,
        fp=fs.BLS12_377_FP,
        # ecc/bls12-377/bls12-377.go g2Gen
        gx=(233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
            140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118),
        gy=(63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
            149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491),
    ),
}


@functools.lru_cache(maxsize=None)
def _g2(name: str, device: str) -> Curve:
    if name.startswith("bw6"):
        # BW6: G2 is a plain short-Weierstrass curve over Fp, registered in
        # the curve-spec registry
        return curve_ops(get_curve(f"{name}_g2"))
    ctx = get_ctx(name, device)
    info = _G2[name]
    spec = CurveSpec(
        name=f"{name}_g2",
        fp=info["fp"],
        fr=info["fr"],
        a=(0, 0),
        b=ctx.b_twist,
        gx=info["gx"],
        gy=info["gy"],
    )
    return Curve(spec, fp_eng=ctx.tower.e2)


def g2_curve(name: str, device=DEFAULT_DEVICE) -> Curve:
    """The G2 group of a pairing curve; its engine's constants on device
    (the group ops run where their points live)."""
    return _g2(name, str(torch.device(device)))
