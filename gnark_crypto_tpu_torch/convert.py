"""Carry field state between the JAX package and this one.

The JAX engine stores an element as ``int32[..., L]`` limbs of
``limb_bits`` bits of ``x * 2^(limb_bits * L) mod q``; this package as
``int32[..., W]`` 32-bit words of ``x * 2^(32W) mod q``. The two meet only
through canonical integers: limb arrays are never compared or copied
across. Inputs are reduced mod q, because JAX limb arrays may hold
non-canonical values (any 12-bit limbs, up to 2^264 for bn254).

Extension elements (E2, E6, E12 of ``towers/tower12.py``; E4, E12 and E24
of ``towers/tower24.py``) cross as they are: the limb or word axis is last
in both packages and the coefficient axes before it agree, so
:func:`from_jax_limbs` and :func:`to_jax_limbs` convert every coefficient
of any leading shape (a BLS24 GT element is (..., 2, 3, 2, 2, L) on one
side and (..., 2, 3, 2, 2, W) on the other). A ``Domain`` crosses as
gnark bytes: ``ntt.domain.domain_from_bytes`` reads what the JAX
``Domain.to_bytes`` writes, and the reverse. A curve point, G1 or G2 (over E2, or E4 for
BLS24), crosses coordinate by coordinate (:func:`point_from_jax`,
:func:`point_to_jax`); scalars cross with ``mont_form=False``.

Signature state crosses the same way (:func:`ecdsa_key_from_jax`,
:func:`ecdsa_key_to_jax`, :func:`eddsa_key_from_jax`,
:func:`eddsa_key_to_jax`, :func:`eddsa_signature_from_jax`,
:func:`eddsa_signature_to_jax`, :func:`mimc_from_jax`,
:func:`mimc_to_jax`): points coordinate by coordinate, scalars and byte
strings as they are, a MiMC hasher as its chaining value and buffered
blocks.

Protocol state crosses field by field on the same rule: an IOP
``Polynomial`` (its plain values, basis and layout by name;
:func:`poly_from_jax`, :func:`poly_to_jax`), a permutation ``Proof``
(:func:`perm_proof_from_jax`, :func:`perm_proof_to_jax`) and the Pedersen
keys (:func:`pedersen_keys_from_jax`, :func:`pedersen_keys_to_jax`). The
"to JAX" side gives numpy and plain Python containers of the same fields,
which the caller wraps in the JAX package's types.

The small fields use the same R on both sides (2^32 for koalabear and
babybear, 2^64 for goldilocks), so their elements cross as bit views:
``uint32 (...)`` <-> ``int32 (...)`` for the f31 engine, ``uint32 (..., 2)``
<-> ``int32 (..., 2)`` for goldilocks (:func:`from_jax_small`,
:func:`to_jax_small`; :func:`from_jax_limbs` and :func:`to_jax_limbs` send
small-field specs there).

Only numpy crosses the boundary, so this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac
from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.specs.field import FieldSpec


def _limbs_to_ints(spec: FieldSpec, limbs: np.ndarray) -> list[int]:
    b = spec.limb_bits
    rows = np.asarray(limbs, dtype=np.int64).reshape(-1, spec.n_limbs)
    return [sum(int(v) << (b * i) for i, v in enumerate(row))
            for row in rows]


def _is_small(spec: FieldSpec) -> bool:
    return spec.limb_bits == 32


def from_jax_small(spec: FieldSpec, arr, device=mont.DEFAULT_DEVICE
                   ) -> torch.Tensor:
    """A JAX small-field array (uint32, any form) -> the port's int32
    tensor of the same bits and shape."""
    if not _is_small(spec):
        raise ValueError(f"{spec.name} is not a small field")
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_jax_small(spec: FieldSpec, x: torch.Tensor) -> np.ndarray:
    """The port's small-field tensor -> uint32 numpy of the same bits."""
    if not _is_small(spec):
        raise ValueError(f"{spec.name} is not a small field")
    return np.ascontiguousarray(
        x.detach().to("cpu").numpy().astype(np.int32)).view(np.uint32)


def from_jax_limbs(spec: FieldSpec, limbs: np.ndarray, mont_form: bool = True,
                   device=mont.DEFAULT_DEVICE) -> torch.Tensor:
    """JAX limbs (Montgomery w.r.t. 2^(bL) when ``mont_form``) -> port words
    (Montgomery w.r.t. 2^(32W)), same leading shape."""
    if _is_small(spec):
        return from_jax_small(spec, limbs, device=device)
    limbs = np.asarray(limbs)
    q = spec.modulus
    vals = _limbs_to_ints(spec, limbs)
    if mont_form:
        jax_r_inv = pow(2, -spec.limb_bits * spec.n_limbs, q)
        vals = [v * jax_r_inv % q for v in vals]
    out = mont.from_int(spec, vals, mont=mont_form, device=device)
    return out.reshape(*limbs.shape[:-1], spec.n_words)


def to_jax_limbs(spec: FieldSpec, x: torch.Tensor, mont_form: bool = True
                 ) -> np.ndarray:
    """Port words -> canonical JAX limbs (int32 numpy), same leading shape
    (small fields: uint32 numpy of the same bits)."""
    if _is_small(spec):
        return to_jax_small(spec, x)
    q = spec.modulus
    vals = mont.to_int(spec, x.reshape(-1, spec.n_words), mont=mont_form)
    if mont_form:
        jax_r = pow(2, spec.limb_bits * spec.n_limbs, q)
        vals = [v * jax_r % q for v in vals]
    b, L = spec.limb_bits, spec.n_limbs
    mask = (1 << b) - 1
    out = np.asarray([[(v >> (b * i)) & mask for i in range(L)]
                      for v in vals], dtype=np.int64).astype(np.int32)
    return out.reshape(*x.shape[:-1], L)


def point_from_jax(spec: FieldSpec, p, device=mont.DEFAULT_DEVICE):
    """A JAX ``Affine``/``Jac`` (coordinates as numpy or JAX limb arrays
    over ``spec``, the curve's base field, or E2 or E4 arrays over it for
    G2) -> the port's point of the same kind."""
    kind = Jac if len(p) == 3 else Affine
    return kind(*(from_jax_limbs(spec, np.asarray(c), device=device)
                  for c in p))


def point_to_jax(spec: FieldSpec, p):
    """A port point -> the same kind of NamedTuple holding canonical JAX
    limb arrays (numpy); wrap with the JAX ``Affine``/``Jac`` to use it."""
    return type(p)(*(to_jax_limbs(spec, c) for c in p))


# ---------------------------------------------------------------------------
# protocol state: IOP polynomials, permutation proofs, Pedersen keys
# ---------------------------------------------------------------------------

def poly_from_jax(p, device=mont.DEFAULT_DEVICE):
    """A JAX ``iop.Polynomial`` -> the port's, same field, plain values,
    basis and layout."""
    from gnark_crypto_tpu_torch.protocols import iop
    from gnark_crypto_tpu_torch.specs.field import get_field

    spec = get_field(p.spec.name)
    vals = from_jax_limbs(spec, np.asarray(p.values), mont_form=False,
                          device=device)
    return iop.Polynomial(spec, vals, iop.Basis[p.basis.name],
                          iop.Layout[p.layout.name])


def poly_to_jax(p) -> dict:
    """The port's ``Polynomial`` -> {"spec": field name, "values": plain
    canonical JAX limbs (numpy), "basis": name, "layout": name}."""
    return {"spec": p.spec.name,
            "values": to_jax_limbs(p.spec, p.values, mont_form=False),
            "basis": p.basis.name, "layout": p.layout.name}


def _fr_from_jax(spec: FieldSpec, a, device) -> torch.Tensor:
    return from_jax_limbs(spec, np.asarray(a), mont_form=False,
                          device=device)


def _affine_from_jax(spec: FieldSpec, p, device) -> Affine:
    return Affine(*(from_jax_limbs(spec, np.asarray(c), device=device)
                    for c in (p.x, p.y)))


def perm_proof_from_jax(name: str, proof, device=mont.DEFAULT_DEVICE):
    """A JAX ``permutation.Proof`` over curve ``name`` -> the port's."""
    from gnark_crypto_tpu_torch.protocols import kzg, permutation
    from gnark_crypto_tpu_torch.specs import curve as cs

    g1 = cs.get_curve(f"{name}_g1")
    fp, fr = g1.fp, g1.fr

    def pt(p):
        return _affine_from_jax(fp, p, device)

    return permutation.Proof(
        size=int(proof.size), t1=pt(proof.t1), t2=pt(proof.t2),
        z=pt(proof.z), q=pt(proof.q),
        batched=kzg.BatchOpeningProof(
            h=pt(proof.batched.h),
            claimed_values=_fr_from_jax(fr, proof.batched.claimed_values,
                                        device)),
        shifted=kzg.OpeningProof(
            h=pt(proof.shifted.h),
            claimed_value=_fr_from_jax(fr, proof.shifted.claimed_value,
                                       device)))


def perm_proof_to_jax(name: str, proof) -> dict:
    """The port's permutation ``Proof`` -> the same fields as numpy: points
    as (x, y) canonical JAX limbs, claimed values as plain limbs."""
    from gnark_crypto_tpu_torch.specs import curve as cs

    g1 = cs.get_curve(f"{name}_g1")

    def pt(p):
        return point_to_jax(g1.fp, p)

    return {"size": proof.size, "t1": pt(proof.t1), "t2": pt(proof.t2),
            "z": pt(proof.z), "q": pt(proof.q),
            "batched": {"h": pt(proof.batched.h),
                        "claimed_values": to_jax_limbs(
                            g1.fr, proof.batched.claimed_values,
                            mont_form=False)},
            "shifted": {"h": pt(proof.shifted.h),
                        "claimed_value": to_jax_limbs(
                            g1.fr, proof.shifted.claimed_value,
                            mont_form=False)}}


def pedersen_keys_from_jax(name: str, pks, vk, device=mont.DEFAULT_DEVICE):
    """JAX Pedersen keys (a list of ``ProvingKey`` and a ``VerifyingKey``)
    over curve ``name`` -> the port's (pks, vk). The G2 points cross over
    the curve's base field: Fp2 or Fp4 coordinates as they are, or Fp for
    bw6."""
    from gnark_crypto_tpu_torch.protocols import pedersen
    from gnark_crypto_tpu_torch.specs import curve as cs

    fp = cs.get_curve(f"{name}_g1").fp
    out = [pedersen.ProvingKey(_affine_from_jax(fp, pk.basis, device),
                               _affine_from_jax(fp, pk.basis_exp_sigma,
                                                device)) for pk in pks]
    return out, pedersen.VerifyingKey(
        _affine_from_jax(fp, vk.g, device),
        _affine_from_jax(fp, vk.g_sigma_neg, device))


def pedersen_keys_to_jax(name: str, pks, vk) -> dict:
    """The port's Pedersen keys -> {"pks": [{"basis", "basis_exp_sigma"}],
    "vk": {"g", "g_sigma_neg"}}, each point (x, y) canonical JAX limbs."""
    from gnark_crypto_tpu_torch.specs import curve as cs

    fp = cs.get_curve(f"{name}_g1").fp
    return {"pks": [{"basis": point_to_jax(fp, pk.basis),
                     "basis_exp_sigma": point_to_jax(fp, pk.basis_exp_sigma)}
                    for pk in pks],
            "vk": {"g": point_to_jax(fp, vk.g),
                   "g_sigma_neg": point_to_jax(fp, vk.g_sigma_neg)}}


# ---------------------------------------------------------------------------
# signature state: ECDSA and EdDSA keys, EdDSA signatures, MiMC hashers
# ---------------------------------------------------------------------------

def ecdsa_key_from_jax(curve_name: str, key, device=mont.DEFAULT_DEVICE):
    """A JAX ECDSA ``PublicKey`` or ``PrivateKey`` over ``curve_name`` ->
    the port's, the point on ``device``."""
    from gnark_crypto_tpu_torch.signature import ecdsa
    from gnark_crypto_tpu_torch.specs import curve as cs

    fp = cs.get_curve(curve_name).fp
    if hasattr(key, "d"):
        return ecdsa.PrivateKey(
            ecdsa_key_from_jax(curve_name, key.public_key, device),
            int(key.d))
    return ecdsa.PublicKey(_affine_from_jax(fp, key.q, device))


def ecdsa_key_to_jax(curve_name: str, key) -> dict:
    """The port's ECDSA key -> {"q": (x, y) canonical JAX limbs} for a
    public key, {"public_key": that, "d": int} for a private one."""
    from gnark_crypto_tpu_torch.specs import curve as cs

    if hasattr(key, "d"):
        return {"public_key": ecdsa_key_to_jax(curve_name, key.public_key),
                "d": key.d}
    return {"q": point_to_jax(cs.get_curve(curve_name).fp, key.q)}


def _ted_base(name: str) -> FieldSpec:
    from gnark_crypto_tpu_torch.curve.twistededwards import get_ted

    return get_ted(name).base


def _ted_point_from_jax(name: str, p, device):
    from gnark_crypto_tpu_torch.curve.twistededwards import AffinePoint

    base = _ted_base(name)
    return AffinePoint(*(from_jax_limbs(base, np.asarray(c), device=device)
                         for c in (p.x, p.y)))


def eddsa_key_from_jax(name: str, key, device=mont.DEFAULT_DEVICE):
    """A JAX EdDSA ``PublicKey`` or ``PrivateKey`` on the twisted Edwards
    curve ``name`` -> the port's, the point on ``device``."""
    from gnark_crypto_tpu_torch.signature import eddsa

    if hasattr(key, "scalar"):
        return eddsa.PrivateKey(
            eddsa_key_from_jax(name, key.public_key, device),
            bytes(key.scalar), bytes(key.rand_src))
    return eddsa.PublicKey(_ted_point_from_jax(name, key.a, device))


def eddsa_key_to_jax(name: str, key) -> dict:
    """The port's EdDSA key -> {"a": (x, y) canonical JAX limbs} for a
    public key, {"public_key": that, "scalar", "rand_src"} for a private
    one."""
    if hasattr(key, "scalar"):
        return {"public_key": eddsa_key_to_jax(name, key.public_key),
                "scalar": key.scalar, "rand_src": key.rand_src}
    return {"a": point_to_jax(_ted_base(name), key.a)}


def eddsa_signature_from_jax(name: str, sig, device=mont.DEFAULT_DEVICE):
    """A JAX EdDSA ``Signature`` -> the port's (R on ``device``)."""
    from gnark_crypto_tpu_torch.signature import eddsa

    return eddsa.Signature(_ted_point_from_jax(name, sig.r, device),
                           bytes(sig.s))


def eddsa_signature_to_jax(name: str, sig) -> dict:
    """The port's EdDSA ``Signature`` -> {"r": (x, y) canonical JAX limbs,
    "s": bytes}."""
    return {"r": point_to_jax(_ted_base(name), sig.r), "s": sig.s}


def mimc_from_jax(h, device=mont.DEFAULT_DEVICE):
    """A JAX ``MiMC`` hasher -> a new port hasher of the same field, with
    its chaining value and buffered blocks, hashing on ``device``."""
    from gnark_crypto_tpu_torch.hashes.mimc import MiMC
    from gnark_crypto_tpu_torch.specs.field import get_field

    out = MiMC(get_field(h.spec.name), device)
    out._state = int(h._state)
    out._data = [bytes(c) for c in h._data]
    return out


def mimc_to_jax(h) -> dict:
    """A port ``MiMC`` hasher -> {"field": name, "state": the chaining
    value (int), "data": the buffered blocks}; set them on a JAX hasher of
    that field (``set_state`` and ``write`` check them again)."""
    return {"field": h.spec.name, "state": h._state, "data": list(h._data)}
