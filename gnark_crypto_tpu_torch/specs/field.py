"""Field specifications for the PyTorch/CUDA engine.

A :class:`FieldSpec` carries the constants of one prime field as plain Python
ints, computed once at registry time. The moduli, generators and 2-adic roots
are those of gnark-crypto (``internal/generator/config/*.go`` and
``internal/generator/field/generator_fft.go``).

Element format of the word engine (``field/mont.py``): ``int32[..., W]``
tensors holding the little-endian 32-bit words of ``x * 2**(32*W) mod q``,
always canonical (< q). ``W = 2 * ceil(bits / 64)`` above 32 bits, so
``R = 2**(32*W)`` is gnark's own Montgomery radix (four 64-bit words for
bn254: R = 2**256; two 32-bit words for goldilocks: R = 2**64). A modulus
of at most 32 bits takes ``W = 1``, so R = 2**32 for koalabear and
babybear, as gnark's 31-bit fields and the JAX engine have it. The small
fields have engines of their own (``field/f31.py``: one int32 per element;
``field/f64.py``: the two words of goldilocks), which keep this R.

``limb_bits`` and ``n_limbs`` describe the JAX engine's limb layout
(``int32[..., L]`` limbs of ``limb_bits`` bits, radix ``2**(limb_bits*L)``);
they are kept only so that :mod:`gnark_crypto_tpu_torch.convert` can read
and write that layout.
"""

from __future__ import annotations

import dataclasses
import functools


def _two_adicity(n: int) -> int:
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s


def int_to_words(x: int, n_words: int) -> tuple[int, ...]:
    """Little-endian unsigned 32-bit words of ``x``."""
    return tuple((x >> (32 * i)) & 0xFFFFFFFF for i in range(n_words))


def words_to_int(words) -> int:
    """Inverse of :func:`int_to_words`; accepts signed int32 words."""
    x = 0
    for i, w in enumerate(words):
        x += (int(w) & 0xFFFFFFFF) << (32 * i)
    return x


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """All constants for one prime field (hashable)."""

    name: str
    modulus: int
    limb_bits: int    # JAX engine limb width (convert.py only)
    n_limbs: int      # JAX engine limb count (convert.py only)
    n_words: int      # W: 32-bit words per element in this engine
    r: int            # R mod q, R = 2**(32*W)
    r2: int           # R^2 mod q
    r_inv: int        # R^-1 mod q
    qinv32: int       # -q^-1 mod 2**32 (CIOS factor of the 32-bit kernels)
    qinv16: int       # -q^-1 mod 2**16 (CIOS factor of the plain versions)
    two_adicity: int          # s with q-1 = 2^s * t, t odd
    generator: int | None     # generator of F_q^* (gnark fftConfigs)
    two_adic_root: int | None  # generator of the 2^s-subgroup
    n_bytes: int              # canonical byte length (gnark Element.Bytes)

    @property
    def bit_length(self) -> int:
        return self.modulus.bit_length()

    @property
    def t_odd(self) -> int:
        """Odd part t of q-1 = 2^s * t."""
        return (self.modulus - 1) >> self.two_adicity

    @functools.cached_property
    def q_words(self) -> tuple[int, ...]:
        return int_to_words(self.modulus, self.n_words)

    @functools.cached_property
    def one_words(self) -> tuple[int, ...]:
        """Montgomery form of 1 (== R mod q)."""
        return int_to_words(self.r, self.n_words)

    @functools.cached_property
    def r2_words(self) -> tuple[int, ...]:
        return int_to_words(self.r2, self.n_words)

    def __repr__(self) -> str:
        return f"FieldSpec({self.name}, {self.bit_length}b, {self.n_words}w)"


def make_field_spec(
    name: str,
    modulus: int,
    limb_bits: int | None = None,
    generator: int | None = None,
    two_adic_root: int | None = None,
    n_limbs: int | None = None,
) -> FieldSpec:
    """Derive the Montgomery and NTT constants from the modulus.

    ``limb_bits``/``n_limbs`` follow the JAX engine's defaults (12-bit limbs
    with one headroom bit up to 400 bits, 11-bit above, one 31-bit lane for
    31-bit fields) so that both layouts can be converted exactly.
    """
    nbits = modulus.bit_length()
    if limb_bits is None:
        if nbits <= 31:
            limb_bits = 31
        elif nbits <= 400:
            limb_bits = 12
        else:
            limb_bits = 11
    if n_limbs is None:
        n_limbs = 1 if nbits <= limb_bits else -(-(nbits + 1) // limb_bits)
    n_words = 1 if nbits <= 32 else 2 * -(-nbits // 64)
    r = (1 << (32 * n_words)) % modulus
    s = _two_adicity(modulus - 1)
    if two_adic_root is None and generator is not None:
        two_adic_root = pow(generator, (modulus - 1) >> s, modulus)
    return FieldSpec(
        name=name,
        modulus=modulus,
        limb_bits=limb_bits,
        n_limbs=n_limbs,
        n_words=n_words,
        r=r,
        r2=r * r % modulus,
        r_inv=pow(r, -1, modulus),
        qinv32=(-pow(modulus, -1, 1 << 32)) % (1 << 32),
        qinv16=(-pow(modulus, -1, 1 << 16)) % (1 << 16),
        two_adicity=s,
        generator=generator,
        two_adic_root=two_adic_root,
        n_bytes=(nbits + 7) // 8,
    )


# ---------------------------------------------------------------------------
# Registry: every field gnark-crypto ships.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, FieldSpec] = {}


def register(spec: FieldSpec) -> FieldSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_field(name: str) -> FieldSpec:
    return _REGISTRY[name]


def all_fields() -> dict[str, FieldSpec]:
    return dict(_REGISTRY)


# -- pairing-curve scalar/base fields (multi-word) ---------------------------

BN254_FR = register(make_field_spec(
    "bn254_fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
))
BN254_FP = register(make_field_spec(
    "bn254_fp",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,  # two-adicity 1: no NTT domain beyond n = 2
))
BLS12_381_FR = register(make_field_spec(
    "bls12_381_fr",
    52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
))
BLS12_381_FP = register(make_field_spec(
    "bls12_381_fp",
    4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
))
BLS12_377_FR = register(make_field_spec(
    "bls12_377_fr",
    8444461749428370424248824938781546531375899335154063827935233455917409239041,
    generator=22,
))
BLS12_377_FP = register(make_field_spec(
    "bls12_377_fp",
    258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
))
BLS24_315_FR = register(make_field_spec(
    "bls24_315_fr",
    11502027791375260645628074404575422495959608200132055716665986169834464870401,
    generator=7,
))
BLS24_315_FP = register(make_field_spec(
    "bls24_315_fp",
    39705142709513438335025689890408969744933502416914749335064285505637884093126342347073617133569,
))
BLS24_317_FR = register(make_field_spec(
    "bls24_317_fr",
    30869589236456844204538189757527902584594726589286811523515204428962673459201,
    generator=7,
))
BLS24_317_FP = register(make_field_spec(
    "bls24_317_fp",
    136393071104295911515099765908274057061945112121419593977210139303905973197232025618026156731051,
))
BW6_761_FR = register(make_field_spec(
    "bw6_761_fr",
    258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
    generator=15,
))
BW6_761_FP = register(make_field_spec(
    "bw6_761_fp",
    6891450384315732539396789682275657542479668912536150109513790160209623422243491736087683183289411687640864567753786613451161759120554247759349511699125301598951605099378508850372543631423596795951899700429969112842764913119068299,
))
BW6_633_FR = register(make_field_spec(
    "bw6_633_fr",
    39705142709513438335025689890408969744933502416914749335064285505637884093126342347073617133569,
    generator=13,
))
BW6_633_FP = register(make_field_spec(
    "bw6_633_fp",
    20494478644167774678813387386538961497669590920908778075528754551012016751717791778743535050360001387419576570244406805463255765034468441182772056330021723098661967429339971741066259394985997,
))

# -- plain curves -------------------------------------------------------------

GRUMPKIN_FR = register(make_field_spec(  # == bn254_fp (2-cycle)
    "grumpkin_fr", BN254_FP.modulus, generator=3))
GRUMPKIN_FP = register(make_field_spec(  # == bn254_fr
    "grumpkin_fp", BN254_FR.modulus, generator=5))
SECP256K1_FR = register(make_field_spec(
    "secp256k1_fr",
    115792089237316195423570985008687907852837564279074904382605163141518161494337,
))
SECP256K1_FP = register(make_field_spec(
    "secp256k1_fp",
    115792089237316195423570985008687907853269984665640564039457584007908834671663,
))
SECP256R1_FR = register(make_field_spec(
    "secp256r1_fr",
    115792089210356248762697446949407573529996955224135760342422259061068512044369,
))
SECP256R1_FP = register(make_field_spec(
    "secp256r1_fp",
    115792089210356248762697446949407573530086143415290314195533631308867097853951,
))
STARK_FR = register(make_field_spec(
    "stark_fr",
    3618502788666131213697322783095070105526743751716087489154079457884512865583,
))
STARK_FP = register(make_field_spec(
    "stark_fp",
    3618502788666131213697322783095070105623107215331596699973092056135872020481,
))

# -- standalone small fields (engines: field/f31.py, field/f64.py) -----------

GOLDILOCKS = register(make_field_spec(
    "goldilocks", 0xFFFFFFFF00000001, limb_bits=32, generator=7, n_limbs=2,
))
KOALABEAR = register(make_field_spec(
    "koalabear", 0x7F000001, limb_bits=32, generator=3,
))
BABYBEAR = register(make_field_spec(
    "babybear", 0x78000001, limb_bits=32, generator=31,
))
