"""Short-Weierstrass group law in Jacobian coordinates, batched over points.

Counterpart of ``gnark_crypto_tpu/curve/jacobian.py`` for G1 (curves over a
prime field): the same EFD formulas (add-2007-bl, madd-2007-bl,
dbl-2009-l; reference ``g1.go:332,428,519``) with every data-dependent
branch (infinity, P == Q, P == -Q) a masked select. Infinity is Z = 0,
encoded as all-zero (0, 0, 0) in Jacobian and (0, 0) in affine coordinates.

A point is a NamedTuple of ``int32[..., W]`` coordinate tensors
(Montgomery words, ``field/mont.py``); scalars are plain (non-Montgomery)
Fr words. :meth:`Curve.add` and :meth:`Curve.double` go to the ``jac_add``
and ``jac_double`` kernels for CUDA tensors at every batch size, and to
their plain versions for CPU tensors (``field/point_add.py``). A curve
whose field the kernels refuse (12-word bls12 Fp, say) raises on CUDA, as
``mont.mul`` does. ``add_mixed`` has no kernel and stays composed of field
ops, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gnark_crypto_tpu_torch.field import point_add
from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec
from gnark_crypto_tpu_torch.field.kernels import u32
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs.curve import CurveSpec


class Affine(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


class Jac(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _sel(cond: torch.Tensor, a, b):
    """cond ? a : b coordinate by coordinate (cond has the element shape)."""
    return type(a)(*(torch.where(cond[..., None], xa, xb)
                     for xa, xb in zip(a, b)))


def _flat(coords, W: int):
    """Broadcast coordinates to one element shape; (N, W) contiguous views
    for a kernel wrapper, and that shape."""
    shape = torch.broadcast_shapes(*(c.shape[:-1] for c in coords))
    return ([c.expand(*shape, W).reshape(-1, W).contiguous()
             for c in coords], shape)


class Curve:
    """Binds a G1 CurveSpec to its fp/fr engines and exposes the group ops."""

    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.fp: FieldEngine = for_spec(spec.fp)
        self.fr: FieldEngine = for_spec(spec.fr)
        self.a_is_zero = spec.a % spec.fp.modulus == 0

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
            zinv = f.batch_inverse(p.z.reshape(-1, p.z.shape[-1])
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
        (reference g1.go:397-424 DoubleAssign). One ``jac_double``."""
        W = self.spec.fp.n_words
        flat, shape = _flat(p, W)
        out = point_add.jac_double(self.spec.fp, self.spec.a, *flat)
        return Jac(*(o.reshape(*shape, W) for o in out))

    def add(self, p: Jac, q: Jac) -> Jac:
        """Complete masked add-2007-bl (reference g1.go:332 AddAssign),
        broadcasting the two batches. One ``jac_add``."""
        W = self.spec.fp.n_words
        flat, shape = _flat((*p, *q), W)
        out = point_add.jac_add(self.spec.fp, self.spec.a, *flat)
        return Jac(*(o.reshape(*shape, W) for o in out))

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
        out = _sel(h0 & r0 & ~p_inf, dbl, out)
        zero = torch.zeros_like(x3)
        out = _sel(h0 & ~r0 & ~p_inf, Jac(zero, zero, zero), out)
        out = _sel(p_inf, self.from_affine(q), out)
        out = _sel(q_inf, p, out)
        return out

    # -- scalar multiplication ---------------------------------------------
    def scalar_bits(self, k: torch.Tensor, nbits: int | None = None
                    ) -> torch.Tensor:
        """Plain Fr words (..., W) -> int32 bit matrix (nbits, ...), MSB
        first."""
        nbits = nbits or self.spec.fr.modulus.bit_length()
        u = u32(k)
        zero = torch.zeros_like(u[..., 0])
        cols = [(u[..., i // 32] >> (i % 32)) & 1 if i // 32 < u.shape[-1]
                else zero for i in range(nbits)]
        return torch.stack(cols[::-1], dim=0).to(torch.int32)

    def scalar_mul(self, p: Jac, k: torch.Tensor, nbits: int | None = None
                   ) -> Jac:
        """[k]P by double-and-add over the scalar bits, MSB first; rows
        where no lane adds only double. k is plain Fr words."""
        bits = self.scalar_bits(k, nbits)
        acc = self.inf_jac(self.fp.eshape(p.x), device=p.x.device)
        for row, any_set in zip(bits, bits.reshape(len(bits), -1).amax(1).tolist()):
            acc = self.double(acc)
            if any_set:
                acc = _sel(row == 1, self.add(acc, p), acc)
        return acc

    def joint_scalar_mul(self, p: Jac, q: Jac, k1: torch.Tensor,
                         k2: torch.Tensor, nbits: int | None = None) -> Jac:
        """[k1]P + [k2]Q with one shared doubling chain (Strauss-Shamir,
        reference g1.go:873 JointScalarMultiplication): two masked adds per
        step."""
        b1 = self.scalar_bits(k1, nbits)
        b2 = self.scalar_bits(k2, nbits)
        any1 = b1.reshape(len(b1), -1).amax(1).tolist()
        any2 = b2.reshape(len(b2), -1).amax(1).tolist()
        acc = self.inf_jac(self.fp.eshape(p.x), device=p.x.device)
        for r1, r2, a1, a2 in zip(b1, b2, any1, any2):
            acc = self.double(acc)
            if a1 or a2:
                acc = _sel(r1 == 1, self.add(acc, p), acc)
                acc = _sel(r2 == 1, self.add(acc, q), acc)
        return acc


@functools.lru_cache(maxsize=None)
def curve_ops(spec: CurveSpec) -> Curve:
    return Curve(spec)
