"""gnark_crypto_tpu_torch — the PyTorch/CUDA port of the JAX package
(``gnark_crypto_tpu``).

Same registries and public operations as the JAX package, with elements as
``int32[..., W]`` tensors of 32-bit Montgomery words (R = 2^(32W), gnark's
own radix) and hand-written CUDA kernels for Hopper (``csrc/``). Every
entry point runs where its input tensor lives; constructors default to
``device="cuda"``. Plain PyTorch versions of every kernel serve CPU tensors.

Ported so far (see ROADMAP.md for the rest):
  specs/      field and curve constant registries
  field/      Montgomery word engine; mont_mul, exp_const, point (Fp and
              Fp2) and VM kernels (field/vm.py: the straight-line program
              executor)
  ntt/        radix-2 domains, radix-2 and four-step NTT kernels
  curve/      Jacobian group law (G1 on the Fp point kernels; G2 over Fp2
              in curve/g2.py, on the Fp2 point kernels); GLV scalar
              splitting (curve/glv.py)
  msm/        G1 and G2 Pippenger MSM (batch-affine bucket tree)
  towers/     Fp2/Fp6/Fp12 extension engines, the BN/BLS12 tower and its
              symbolic twin that assembles VM programs
  pairing/    bn254/bls12 optimal ate pairing as VM programs; the api facade
  protocols/  KZG commitment: SRS, commit, open, verify, batch forms
  hashes/     Fiat-Shamir transcript (host)
  io/         gnark GT byte codec; point encoder (io/marshal.py)
  utils/      kernel build (utils/build.py); log-depth scans
              (utils/scans.py)
  convert.py  JAX limb arrays (elements, extension elements, points) <->
              port word tensors
"""

# curve ID registry (ecc.ID analogue)
CURVES = (
    "bn254", "bls12_377", "bls12_381", "bls24_315", "bls24_317",
    "bw6_633", "bw6_761", "grumpkin", "secp256k1", "secp256r1", "stark",
)

# The curve families of the reference. This package pairs the BN/BLS12
# families; BLS24 and BW6 come with a later slice (ROADMAP.md queue 1).
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
