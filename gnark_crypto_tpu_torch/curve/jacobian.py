"""Short-Weierstrass group law in Jacobian coordinates, batched over points.

Counterpart of ``gnark_crypto_tpu/curve/jacobian.py``: the same EFD
formulas (add-2007-bl, madd-2007-bl, dbl-2009-l; reference
``g1.go:332,428,519``) with every data-dependent branch (infinity,
P == Q, P == -Q) a masked select. Infinity is Z = 0, encoded as all-zero
(0, 0, 0) in Jacobian and (0, 0) in affine coordinates.

A point is a NamedTuple of coordinate tensors: ``int32[..., W]``
Montgomery words (``field/mont.py``) over a prime field, or extension
elements (``int32[..., 2, W]`` over Fp2) when the curve is built over an
extension engine (``Curve(spec, fp_eng)``, the G2 groups of
``curve/g2.py``). Scalars are plain (non-Montgomery) Fr words.

Over a prime field, :meth:`Curve.add` and :meth:`Curve.double` go to the
``jac_add`` and ``jac_double`` kernels for CUDA tensors at every batch
size, and to their plain versions for CPU tensors (``field/point_add.py``).
Over a quadratic extension with a small-int non-residue and a = 0 (the G2
groups; the JAX package's ``_pallas2_ok`` test) they go to ``jac_add2``
and ``jac_double2`` (``field/point_add2.py``) in the same way. A curve
whose field the kernels refuse (12-word bls12 Fp, say) raises on CUDA, as
``mont.mul`` does. Over any other extension, and for ``add_mixed``
everywhere, the group law stays composed of field ops, as in the JAX
package; on the card those ops launch ``mont_mul``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import point_add, point_add2
from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs.curve import CurveSpec


class Affine(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


class Jac(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _le_bits(raw: np.ndarray, nbits: int, device
             ) -> tuple[torch.Tensor, list[bool]]:
    """Bits 0..nbits-1 of little-endian (n, bytes) uint8 rows, MSB first:
    (nbits, n) int32 on ``device``, and whether each bit row has a bit
    set."""
    bits = np.unpackbits(raw, axis=1, count=nbits, bitorder="little")
    bits = np.ascontiguousarray(bits[:, ::-1].T)
    return (torch.from_numpy(bits.astype(np.int32)).to(device),
            bits.any(axis=1).tolist())


def int_bits(ks: list[int], nbits: int, device
             ) -> tuple[torch.Tensor, list[bool]]:
    """MSB-first bits of host integers 0 <= k < 2^nbits: (nbits, len(ks))
    int32 on ``device``, and whether each bit row has a bit set."""
    nb = (nbits + 7) // 8
    raw = np.frombuffer(b"".join(k.to_bytes(nb, "little") for k in ks),
                        dtype=np.uint8).reshape(len(ks), nb)
    return _le_bits(raw, nbits, device)


def _flat(coords, tail: tuple[int, ...]):
    """Broadcast coordinates to one batch shape; (N, *tail) contiguous
    views for a kernel wrapper (tail: one element's shape, (W,) or
    (2, W)), and that batch shape."""
    k = len(tail)
    shape = torch.broadcast_shapes(*(c.shape[:-k] for c in coords))
    return ([c.expand(*shape, *tail).reshape(-1, *tail).contiguous()
             for c in coords], shape)


def _flat_ints(v):
    if isinstance(v, tuple):
        for c in v:
            yield from _flat_ints(c)
    else:
        yield v


class Curve:
    """Binds a CurveSpec to its fp/fr engines and exposes the group ops.

    ``fp_eng`` may be an extension engine (``towers/engine.py``): that is
    how G2 (a curve over Fp2) reuses this code, with tuple-valued a, b, gx
    and gy in the spec.
    """

    def __init__(self, spec: CurveSpec, fp_eng=None):
        self.spec = spec
        self.fp = fp_eng if fp_eng is not None else for_spec(spec.fp)
        self.fr: FieldEngine = for_spec(spec.fr)
        self.a_is_zero = all(c % spec.fp.modulus == 0
                             for c in _flat_ints(spec.a))
        # the point kernels take curves over the prime field itself, and
        # (jac_add2/jac_double2) over a quadratic extension of it with a
        # small-int non-residue and a = 0 (G2 on every pairing curve); over
        # any other extension the group law is composed of field ops
        self._kernels = isinstance(self.fp, FieldEngine)
        if not (self._kernels or self.a_is_zero):
            raise NotImplementedError(
                f"{spec.name}: a != 0 over an extension field")
        nr = getattr(self.fp, "nr", None)
        self._kernels2 = (getattr(self.fp, "degree", 0) == 2
                          and isinstance(self.fp.base, FieldEngine)
                          and isinstance(nr, int) and nr != 0
                          and -16 <= nr <= 16)
        # one element's trailing shape: (W,) over Fp, (2, W) over Fp2
        self.elem_tail = ((spec.fp.n_words,) if self._kernels
                          else (2, spec.fp.n_words) if self._kernels2
                          else None)

    def _select(self, cond: torch.Tensor, a, b):
        """cond ? a : b coordinate by coordinate (cond: element shape)."""
        return type(a)(*(self.fp.where(cond, xa, xb) for xa, xb in zip(a, b)))

    # -- constructors -------------------------------------------------------
    def const_affine(self, x: int, y: int, device=DEFAULT_DEVICE) -> Affine:
        return Affine(self.fp.from_int(x, device=device),
                      self.fp.from_int(y, device=device))

    def generator_affine(self, device=DEFAULT_DEVICE) -> Affine:
        return self.const_affine(self.spec.gx, self.spec.gy, device)

    def generator_jac(self, device=DEFAULT_DEVICE) -> Jac:
        return self.from_affine(self.generator_affine(device))

    def inf_jac(self, shape=(), device=DEFAULT_DEVICE) -> Jac:
        z = self.fp.zeros(shape, device=device)
        return Jac(z, z, z)

    def inf_affine(self, shape=(), device=DEFAULT_DEVICE) -> Affine:
        z = self.fp.zeros(shape, device=device)
        return Affine(z, z)

    # -- predicates ---------------------------------------------------------
    def is_inf_jac(self, p: Jac) -> torch.Tensor:
        return self.fp.is_zero(p.z)

    def is_inf_affine(self, p: Affine) -> torch.Tensor:
        return self.fp.is_zero(p.x) & self.fp.is_zero(p.y)

    def on_curve_affine(self, p: Affine) -> torch.Tensor:
        """y^2 == x^3 + ax + b, or infinity (g1.go IsOnCurve)."""
        f = self.fp
        dev = p.x.device
        y2 = f.square(p.y)
        x3 = f.mul(f.square(p.x), p.x)
        rhs = f.add(x3, f.from_int(self.spec.b, device=dev))
        if not self.a_is_zero:
            rhs = f.add(rhs, f.mul(p.x, f.from_int(self.spec.a, device=dev)))
        return f.equal(y2, rhs) | self.is_inf_affine(p)

    def eq_jac(self, p: Jac, q: Jac) -> torch.Tensor:
        """Projective equality via cross-multiplication."""
        f = self.fp
        pz2, qz2 = f.square(p.z), f.square(q.z)
        x_eq = f.equal(f.mul(p.x, qz2), f.mul(q.x, pz2))
        y_eq = f.equal(f.mul(p.y, f.mul(q.z, qz2)),
                       f.mul(q.y, f.mul(p.z, pz2)))
        both_inf = self.is_inf_jac(p) & self.is_inf_jac(q)
        one_inf = self.is_inf_jac(p) ^ self.is_inf_jac(q)
        return (x_eq & y_eq & ~one_inf) | both_inf

    # -- conversions --------------------------------------------------------
    def from_affine(self, p: Affine) -> Jac:
        f = self.fp
        inf = self.is_inf_affine(p)
        one = f.ones(f.eshape(p.x), device=p.x.device)
        return Jac(p.x, p.y, f.where(inf, torch.zeros_like(one), one))

    def to_affine(self, p: Jac) -> Affine:
        """Batch Jacobian -> affine with one shared inversion (reference
        ``BatchJacobianToAffineG1`` g1.go:1266)."""
        f = self.fp
        lead = f.eshape(p.z)
        if len(lead) == 0:
            zinv = f.inverse(p.z)
        else:
            zinv = f.batch_inverse(p.z.reshape(-1, *p.z.shape[len(lead):])
                                   ).reshape(p.z.shape)
        zinv2 = f.square(zinv)
        x = f.mul(p.x, zinv2)
        y = f.mul(p.y, f.mul(zinv, zinv2))
        inf = self.is_inf_jac(p)
        return Affine(f.where(inf, torch.zeros_like(x), x),
                      f.where(inf, torch.zeros_like(y), y))

    # -- group law ----------------------------------------------------------
    def neg_jac(self, p: Jac) -> Jac:
        return Jac(p.x, self.fp.neg(p.y), p.z)

    def neg_affine(self, p: Affine) -> Affine:
        return Affine(p.x, self.fp.neg(p.y))

    def double(self, p: Jac) -> Jac:
        """dbl-2009-l (a = 0) / dbl-2007-bl (general a); infinity-safe
        (reference g1.go:397-424 DoubleAssign). One ``jac_double`` over a
        prime field, one ``jac_double2`` over Fp2."""
        if self.elem_tail is None:
            return self._double_composed(p)
        return self._launch(point_add.jac_double, point_add2.jac_double2, p)

    def add(self, p: Jac, q: Jac) -> Jac:
        """Complete masked add-2007-bl (reference g1.go:332 AddAssign),
        broadcasting the two batches. One ``jac_add`` over a prime field, one
        ``jac_add2`` over Fp2."""
        if self.elem_tail is None:
            return self._add_composed(p, q)
        return self._launch(point_add.jac_add, point_add2.jac_add2, (*p, *q))

    def _launch(self, fp_kernel, fp2_kernel, coords) -> Jac:
        """One point-kernel call over the broadcast batch: ``fp_kernel``
        (spec, a, ...) over Fp, ``fp2_kernel`` (spec, nr, ...) over Fp2."""
        flat, shape = _flat(coords, self.elem_tail)
        out = (fp_kernel(self.spec.fp, self.spec.a, *flat) if self._kernels
               else fp2_kernel(self.spec.fp, self.fp.nr, *flat))
        return Jac(*(o.reshape(*shape, *self.elem_tail) for o in out))

    def _double_composed(self, p: Jac) -> Jac:
        """dbl-2009-l (a = 0) in field ops (the JAX package's
        ``Curve.double``)."""
        f = self.fp
        A = f.square(p.x)
        B = f.square(p.y)
        C = f.square(B)
        t = f.square(f.add(p.x, B))
        D = f.double(f.sub(f.sub(t, A), C))
        E = f.add(f.double(A), A)  # 3A
        F = f.square(E)
        x3 = f.sub(F, f.double(D))
        eight_c = f.double(f.double(f.double(C)))
        y3 = f.sub(f.mul(E, f.sub(D, x3)), eight_c)
        z3 = f.double(f.mul(p.y, p.z))
        return Jac(x3, y3, z3)

    def _add_composed(self, p: Jac, q: Jac) -> Jac:
        """Complete masked add-2007-bl in field ops (the JAX package's
        ``Curve.add``)."""
        f = self.fp
        z1z1 = f.square(p.z)
        z2z2 = f.square(q.z)
        u1 = f.mul(p.x, z2z2)
        u2 = f.mul(q.x, z1z1)
        s1 = f.mul(f.mul(p.y, q.z), z2z2)
        s2 = f.mul(f.mul(q.y, p.z), z1z1)
        h = f.sub(u2, u1)
        i = f.square(f.double(h))
        j = f.mul(h, i)
        rr = f.double(f.sub(s2, s1))
        v = f.mul(u1, i)
        x3 = f.sub(f.sub(f.square(rr), j), f.double(v))
        y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.double(f.mul(s1, j)))
        z3 = f.mul(f.sub(f.sub(f.square(f.add(p.z, q.z)), z1z1), z2z2), h)
        out = Jac(x3, y3, z3)

        h0 = f.is_zero(h)
        r0 = f.is_zero(rr)
        p_inf = self.is_inf_jac(p)
        q_inf = self.is_inf_jac(q)
        dbl = self.double(p)
        zero = torch.zeros_like(x3)
        out = self._select(h0 & r0, dbl, out)          # P == Q -> double
        out = self._select(h0 & ~r0 & ~p_inf & ~q_inf,  # P == -Q -> infinity
                           Jac(zero, zero, zero), out)
        out = self._select(p_inf, q, out)
        out = self._select(q_inf, p, out)
        return out

    def add_mixed(self, p: Jac, q: Affine) -> Jac:
        """Complete masked madd-2007-bl (reference g1.go:428 AddMixed)."""
        f = self.fp
        z1z1 = f.square(p.z)
        u2 = f.mul(q.x, z1z1)
        s2 = f.mul(f.mul(q.y, p.z), z1z1)
        h = f.sub(u2, p.x)
        hh = f.square(h)
        i = f.double(f.double(hh))
        j = f.mul(h, i)
        rr = f.double(f.sub(s2, p.y))
        v = f.mul(p.x, i)
        x3 = f.sub(f.sub(f.square(rr), j), f.double(v))
        y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.double(f.mul(p.y, j)))
        z3 = f.sub(f.sub(f.square(f.add(p.z, h)), z1z1), hh)
        out = Jac(x3, y3, z3)

        h0 = f.is_zero(h)
        r0 = f.is_zero(rr)
        p_inf = self.is_inf_jac(p)
        q_inf = self.is_inf_affine(q)
        dbl = self.double(p)
        out = self._select(h0 & r0 & ~p_inf, dbl, out)
        zero = torch.zeros_like(x3)
        out = self._select(h0 & ~r0 & ~p_inf, Jac(zero, zero, zero), out)
        out = self._select(p_inf, self.from_affine(q), out)
        out = self._select(q_inf, p, out)
        return out

    # -- scalar multiplication ---------------------------------------------
    def scalar_bits(self, k: torch.Tensor, nbits: int | None = None
                    ) -> tuple[torch.Tensor, list[bool]]:
        """Plain Fr words (..., W) -> int32 bit matrix (nbits, ...), MSB
        first, and whether each bit row has a bit set (:func:`int_bits`)."""
        nbits = nbits or self.spec.fr.modulus.bit_length()
        raw = (k.reshape(-1, k.shape[-1]).cpu().numpy().astype("<i4")
               .view(np.uint8))
        bits, any_set = _le_bits(raw, nbits, k.device)
        return bits.reshape(nbits, *k.shape[:-1]), any_set

    def scalar_mul(self, p: Jac, k: torch.Tensor, nbits: int | None = None,
                   regular: bool = False) -> Jac:
        """[k]P by double-and-add over the scalar bits, MSB first. k is
        plain Fr words. Steps where no lane has its bit set only double,
        unless ``regular``: then every step adds and selects, as the JAX
        ladder does, so that the launches and the time do not follow the
        bits of a secret scalar (a key, a nonce)."""
        bits, any_set = self.scalar_bits(k, nbits)
        acc = self.inf_jac(self.fp.eshape(p.x), device=p.x.device)
        for row, go in zip(bits, any_set):
            acc = self.double(acc)
            if go or regular:
                acc = self._select(row == 1, self.add(acc, p), acc)
        return acc

    def joint_scalar_mul(self, p: Jac, q: Jac, k1: torch.Tensor,
                         k2: torch.Tensor, nbits: int | None = None) -> Jac:
        """[k1]P + [k2]Q with one shared doubling chain (Strauss-Shamir,
        reference g1.go:873 JointScalarMultiplication): two masked adds per
        step."""
        b1, any1 = self.scalar_bits(k1, nbits)
        b2, any2 = self.scalar_bits(k2, nbits)
        acc = self.inf_jac(self.fp.eshape(p.x), device=p.x.device)
        for r1, r2, a1, a2 in zip(b1, b2, any1, any2):
            acc = self.double(acc)
            if a1 or a2:
                acc = self._select(r1 == 1, self.add(acc, p), acc)
                acc = self._select(r2 == 1, self.add(acc, q), acc)
        return acc


@functools.lru_cache(maxsize=None)
def curve_ops(spec: CurveSpec) -> Curve:
    return Curve(spec)
