"""gnark_crypto_tpu_torch — the PyTorch/CUDA port of the JAX package
(``gnark_crypto_tpu``).

Same registries and public operations as the JAX package, with elements as
``int32[..., W]`` tensors of 32-bit Montgomery words (R = 2^(32W), gnark's
own radix) and hand-written CUDA kernels for Hopper (``csrc/``). Every
entry point runs where its input tensor lives; constructors default to
``device="cuda"``. Plain PyTorch versions of every kernel serve CPU tensors.

Ported so far (see ROADMAP.md for the rest):
  specs/      field and curve constant registries
  field/      Montgomery word engine; mont_mul, exp_const and point kernels
  ntt/        radix-2 domains, radix-2 and four-step NTT kernels
  curve/      G1 group law in Jacobian coordinates
  msm/        G1 Pippenger MSM (batch-affine bucket tree)
  convert.py  JAX limb arrays and points <-> port word tensors
"""

# curve ID registry (ecc.ID analogue)
CURVES = (
    "bn254", "bls12_377", "bls12_381", "bls24_315", "bls24_317",
    "bw6_633", "bw6_761", "grumpkin", "secp256k1", "secp256r1", "stark",
)

# The curve families of the reference. This package has G1 and its MSM;
# pairings and G2 come with later slices (ROADMAP.md queue 1).
PAIRING_CURVES = (
    "bn254", "bls12_381", "bls12_377", "bls24_315", "bls24_317",
    "bw6_761", "bw6_633",
)
PLAIN_CURVES = ("grumpkin", "secp256k1", "secp256r1", "stark")

SMALL_FIELDS = ("goldilocks", "babybear", "koalabear")


def field(name: str):
    """FieldEngine by spec name (e.g. 'bn254_fr')."""
    from gnark_crypto_tpu_torch.field.api import for_field

    return for_field(name)
