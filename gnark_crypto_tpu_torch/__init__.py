"""gnark_crypto_tpu_torch — the PyTorch/CUDA port of the JAX package
(``gnark_crypto_tpu``).

Same registries and public operations as the JAX package, with elements as
``int32`` tensors: ``int32[..., W]`` 32-bit Montgomery words (R = 2^(32W),
gnark's own radix) for the multi-word fields and goldilocks (W = 2),
``int32[...]`` for koalabear and babybear (R = 2^32). Hand-written CUDA
kernels for Hopper live in ``csrc/``. Every entry point runs where its
input tensor lives; constructors default to ``device="cuda"``. Plain
PyTorch versions of every kernel serve CPU tensors.

Ported so far (see ROADMAP.md for the rest):
  specs/      field and curve constant registries
  field/      Montgomery word engine; the small-field engines (f31.py:
              koalabear, babybear; f64.py: goldilocks); mont_mul,
              exp_const, point (Fp and Fp2) and VM kernels (field/vm.py:
              the straight-line program executor and its wave scheduler)
  ntt/        radix-2 domains over any engine; radix-2 and four-step NTT
              kernels (bn254), the f31 and f64 NTT kernels
              (radix2_f31.py, radix2_f64.py); extension-vector NTT
              (fftext.py)
  curve/      Jacobian group law (G1 on the Fp point kernels; G2 in
              curve/g2.py: over Fp2 on the Fp2 point kernels, over Fp4
              for bls24 composed of field ops, over Fp for bw6 on the Fp
              point kernels); GLV scalar splitting (curve/glv.py)
  msm/        G1 and G2 Pippenger MSM (batch-affine bucket tree)
  towers/     extension engines, the BN/BLS12 tower, the BLS24 tower
              (tower24.py), the BW6 direct sextic tower (tower6.py) and
              their symbolic twins that assemble VM programs; the
              small-field E2/E4/E6 towers (smallfield.py)
  pairing/    the optimal ate pairings of every family (pairing12.py:
              BN/BLS12/BLS24, pairing6.py: BW6) as VM programs; the api
              facade
  protocols/  KZG commitment: SRS, commit, open, verify, batch forms
  hashes/     Fiat-Shamir transcript (host); the Ring-SIS hash (sis.py)
  io/         gnark GT byte codec; point encoder (io/marshal.py)
  utils/      kernel build (utils/build.py); log-depth scans
              (utils/scans.py)
  convert.py  JAX arrays (elements, extension elements, points; small
              fields as bit views) <-> port tensors
"""

# curve ID registry (ecc.ID analogue)
CURVES = (
    "bn254", "bls12_377", "bls12_381", "bls24_315", "bls24_317",
    "bw6_633", "bw6_761", "grumpkin", "secp256k1", "secp256r1", "stark",
)

# The pairing curves of the reference; this package pairs them all.
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
