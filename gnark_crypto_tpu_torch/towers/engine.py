"""Extension-field engines: towers as stacked word tensors.

Counterpart of ``gnark_crypto_tpu/towers/engine.py``, itself the
counterpart of the reference's generated ``internal/fptower`` packages
(``e2.go``/``e6.go``/``e12.go``). Extensions are built compositionally:
``QuadExtEngine``/``CubicExtEngine`` wrap any engine that implements the
field protocol (``field/api.py``'s ``FieldEngine``, another extension engine,
or the symbolic engines of ``towers/symbolic.py``) and expose the same
protocol, so the G2 group law over Fp2 and the Fp12 pairing target reuse the
generic code.

An element of a degree-d extension over a base with element shape S is a
tensor of shape (..., d, *S): coefficient index first, lowest degree at 0.
``elem_dims`` counts the trailing element axes: the base's plus one (1 for
word tensors at the bottom, 0 for the symbolic engine's SSA ids).

An engine is bound to a device (default: the card): its constructors
(``zeros``, ``ones``, ``from_int``) make tensors there unless given another.
The arithmetic runs where its operands live.

Multiplication algorithms match the reference's choices (Karatsuba 3-mul
for quadratic, ``e2_fallback.go``; Karatsuba/CH-SQR2 for cubic,
``e6.go:15``).

Over the word tensors of a multi-word field, an extension's linear ops
(add, sub, neg, double, halve, the zero and equality tests) run once over
all its coefficients, and a product's base products go to one batched
base product (stacked on a new leading axis), so an E4 product is one
``mont_mul`` launch, not nine: the same values, fewer launches, which
bound the tower's ops on the card at small batches (bls24's G2 over Fp4).
The symbolic engines keep the per-coefficient order, in which the VM
programs are emitted.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.api import FieldEngine
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE


class ExtEngine:
    """Common protocol bits shared by Quad/Cubic extension engines."""

    base: object  # FieldEngine or ExtEngine
    degree: int
    device: torch.device

    # -- shape helpers ------------------------------------------------------
    @property
    def elem_dims(self):
        return self.base.elem_dims + 1

    def eshape(self, x):
        return tuple(x.shape[: x.ndim - self.elem_dims])

    def broadcast_to(self, x, shape):
        return x.expand(*shape, *x.shape[x.ndim - self.elem_dims:])

    def where(self, cond, x, y):
        cond = cond[(...,) + (None,) * self.elem_dims]
        return torch.where(cond, x, y)

    # -- coefficient access -------------------------------------------------
    def coeff(self, x, i: int):
        """i-th coefficient (a base element)."""
        idx = (Ellipsis, i) + (slice(None),) * self.base.elem_dims
        return x[idx]

    def build(self, coeffs):
        """Stack base elements into an extension element."""
        return torch.stack(list(coeffs), dim=-1 - self.base.elem_dims)

    # -- generic constructors ----------------------------------------------
    def zeros(self, shape=(), device=None):
        device = self.device if device is None else device
        return self.build([self.base.zeros(shape, device=device)]
                          * self.degree)

    def ones(self, shape=(), device=None):
        device = self.device if device is None else device
        one = self.base.ones(shape, device=device)
        zero = self.base.zeros(shape, device=device)
        return self.build([one] + [zero] * (self.degree - 1))

    def from_int(self, v, mont: bool = True, device=None):
        """int -> embed in degree 0; tuple -> coefficients (ints or nested
        tuples for deeper towers); list -> batch of elements."""
        device = self.device if device is None else device
        if isinstance(v, int):
            v = (v,) + (0,) * (self.degree - 1)
        if isinstance(v, list):
            return torch.stack([self.from_int(e, mont=mont, device=device)
                                for e in v], dim=0)
        assert len(v) == self.degree, (len(v), self.degree)
        return self.build([self.base.from_int(c, mont=mont, device=device)
                           for c in v])

    def to_int(self, x, mont: bool = True):
        return tuple(self.base.to_int(self.coeff(x, i), mont=mont)
                     for i in range(self.degree))

    # -- word-tensor fast paths ---------------------------------------------
    @functools.cached_property
    def _flat(self):
        """The multi-word field engine at the bottom of the tower, whose
        ops act coefficientwise on a whole extension element; None for the
        other engines (symbolic, small fields)."""
        b = self.base
        while isinstance(b, ExtEngine):
            b = b.base
        return b if isinstance(b, FieldEngine) and b.impl is mont else None

    def _products(self, xs, ys):
        """The base products xs[i] * ys[i] in one batched base ``mul`` over
        a stacked leading axis (word tensors only)."""
        ops = torch.broadcast_tensors(*xs, *ys)
        prods = self.base.mul(torch.stack(ops[:len(xs)]),
                              torch.stack(ops[len(xs):]))
        return prods.unbind(0)

    # -- linear ops ---------------------------------------------------------
    def add(self, x, y):
        if self._flat is not None:
            return self._flat.add(x, y)
        return self._lift2(self.base.add, x, y)

    def sub(self, x, y):
        if self._flat is not None:
            return self._flat.sub(x, y)
        return self._lift2(self.base.sub, x, y)

    def neg(self, x):
        if self._flat is not None:
            return self._flat.neg(x)
        return self._lift1(self.base.neg, x)

    def double(self, x):
        if self._flat is not None:
            return self._flat.double(x)
        return self._lift1(self.base.double, x)

    def halve(self, x):
        if self._flat is not None:
            return self._flat.halve(x)
        return self._lift1(self.base.halve, x)

    def _lift1(self, fn, x):
        return self.build([fn(self.coeff(x, i)) for i in range(self.degree)])

    def _lift2(self, fn, x, y):
        return self.build([fn(self.coeff(x, i), self.coeff(y, i))
                           for i in range(self.degree)])

    # -- predicates ---------------------------------------------------------
    def _all_coeffs(self, mask):
        """A word engine's per-coefficient mask -> one bool per element."""
        k = self.elem_dims - 1
        return mask.reshape(*mask.shape[:mask.dim() - k], -1).all(-1)

    def is_zero(self, x):
        if self._flat is not None:
            return self._all_coeffs(self._flat.is_zero(x))
        r = self.base.is_zero(self.coeff(x, 0))
        for i in range(1, self.degree):
            r = r & self.base.is_zero(self.coeff(x, i))
        return r

    def equal(self, x, y):
        if self._flat is not None:
            return self._all_coeffs(self._flat.equal(x, y))
        r = self.base.equal(self.coeff(x, 0), self.coeff(y, 0))
        for i in range(1, self.degree):
            r = r & self.base.equal(self.coeff(x, i), self.coeff(y, i))
        return r

    # -- exponentiation -----------------------------------------------------
    def exp_const(self, x, e: int):
        """x^e for a static e >= 0: MSB-first square-and-multiply from x
        (the reference's eager ladder, ``utils/hostloop.py`` exp_ladder)."""
        if e == 0:
            return self.broadcast_to(self.ones(), self.eshape(x))
        res = x
        for bit in bin(e)[3:]:  # MSB consumed by res = x
            res = self.square(res)
            if bit == "1":
                res = self.mul(res, x)
        return res

    def batch_inverse(self, x):
        """Elementwise inverse (0 -> 0). Every extension inverse bottoms out
        in one base-field ``inverse`` of the whole batch, a single
        ``exp_const`` launch, so no Montgomery trick is needed."""
        return self.inverse(x)

    def _key(self):
        return (type(self).__name__, self.base, self.nr
                if isinstance(self.nr, (int, tuple)) else None, self.tag,
                str(self.device))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return type(other) is type(self) and other._key() == self._key()

    def __repr__(self):
        return f"{type(self).__name__}({self.base!r}, deg={self.degree})"


class QuadExtEngine(ExtEngine):
    """base[u] / (u^2 - nr). Reference: fptower E2 (over fp) / E12 (over E6)."""

    degree = 2

    def __init__(self, base, nr, mul_by_nr: Callable | None = None,
                 tag: str = "", device=DEFAULT_DEVICE):
        self.base = base
        self.nr = nr  # int or tuple (base element constant), used if no hook
        self.tag = tag
        self.device = torch.device(device)
        if mul_by_nr is not None:
            self.mul_by_nr = mul_by_nr
        else:
            self.mul_by_nr = self._default_mul_by_nr

    def _default_mul_by_nr(self, a):
        if isinstance(self.nr, int):
            if self.nr == -1:
                return self.base.neg(a)
            if 0 < self.nr <= 16:
                return self.base.mul_const(a, self.nr)
            if -16 <= self.nr < 0:
                return self.base.neg(self.base.mul_const(a, -self.nr))
        const = self.base.from_int(self.nr, device=self.device)
        return self.base.mul(a, self.base.broadcast_to(
            const, self.base.eshape(a)))

    def mul(self, x, y):
        b = self.base
        a0, a1 = self.coeff(x, 0), self.coeff(x, 1)
        b0, b1 = self.coeff(y, 0), self.coeff(y, 1)
        if self._flat is not None:
            v0, v1, t = self._products((a0, a1, b.add(a0, a1)),
                                       (b0, b1, b.add(b0, b1)))
        else:  # the symbolic engines emit in this order
            v0 = b.mul(a0, b0)
            v1 = b.mul(a1, b1)
            t = b.mul(b.add(a0, a1), b.add(b0, b1))
        c0 = b.add(v0, self.mul_by_nr(v1))
        c1 = b.sub(b.sub(t, v0), v1)
        return self.build([c0, c1])

    def square(self, x):
        # complex-style squaring (the generic 2-mul version)
        b = self.base
        a0, a1 = self.coeff(x, 0), self.coeff(x, 1)
        if self._flat is not None:
            v, t = self._products((a0, b.add(a0, a1)),
                                  (a1, b.add(a0, self.mul_by_nr(a1))))
        else:  # the symbolic engines emit in this order
            v = b.mul(a0, a1)
            t = b.mul(b.add(a0, a1), b.add(a0, self.mul_by_nr(a1)))
        c0 = b.sub(b.sub(t, v), self.mul_by_nr(v))
        c1 = b.double(v)
        return self.build([c0, c1])

    def inverse(self, x):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 - nr*a1^2)   (e2.go Inverse)
        b = self.base
        a0, a1 = self.coeff(x, 0), self.coeff(x, 1)
        norm = b.sub(b.square(a0), self.mul_by_nr(b.square(a1)))
        ninv = b.inverse(norm)
        return self.build([b.mul(a0, ninv), b.neg(b.mul(a1, ninv))])

    def conjugate(self, x):
        return self.build([self.coeff(x, 0), self.base.neg(self.coeff(x, 1))])


class CubicExtEngine(ExtEngine):
    """base[v] / (v^3 - nr). Reference: fptower E6 over E2 (e6.go)."""

    degree = 3

    def __init__(self, base, nr, mul_by_nr: Callable | None = None,
                 tag: str = "", device=DEFAULT_DEVICE):
        self.base = base
        self.nr = nr
        self.tag = tag
        self.device = torch.device(device)
        if mul_by_nr is not None:
            self.mul_by_nr = mul_by_nr
        else:
            self.mul_by_nr = lambda a: base.mul(a, base.broadcast_to(
                base.from_int(nr, device=self.device), base.eshape(a)))

    def mul(self, x, y):
        # Karatsuba (e6.go:15 Mul, Devegili et al. 4.Karatsuba)
        b = self.base
        a0, a1, a2 = (self.coeff(x, i) for i in range(3))
        b0, b1, b2 = (self.coeff(y, i) for i in range(3))
        if self._flat is not None:
            v0, v1, v2, u0, u1, u2 = self._products(
                (a0, a1, a2, b.add(a1, a2), b.add(a0, a1), b.add(a0, a2)),
                (b0, b1, b2, b.add(b1, b2), b.add(b0, b1), b.add(b0, b2)))
            t0 = b.sub(b.sub(u0, v1), v2)
            t1 = b.sub(b.sub(u1, v0), v1)
            t2 = b.sub(b.sub(u2, v0), v2)
        else:  # the symbolic engines emit in this order
            v0, v1, v2 = b.mul(a0, b0), b.mul(a1, b1), b.mul(a2, b2)
            t0 = b.sub(b.sub(b.mul(b.add(a1, a2), b.add(b1, b2)), v1), v2)
            t1 = b.sub(b.sub(b.mul(b.add(a0, a1), b.add(b0, b1)), v0), v1)
            t2 = b.sub(b.sub(b.mul(b.add(a0, a2), b.add(b0, b2)), v0), v2)
        c0 = b.add(v0, self.mul_by_nr(t0))
        c1 = b.add(t1, self.mul_by_nr(v2))
        c2 = b.add(t2, v1)
        return self.build([c0, c1, c2])

    def square(self, x):
        # CH-SQR2 (e6.go Square)
        b = self.base
        a0, a1, a2 = (self.coeff(x, i) for i in range(3))
        if self._flat is not None:
            m = b.add(b.sub(a0, a1), a2)
            s0, ab, s2, bc, s4 = self._products((a0, a0, m, a1, a2),
                                                (a0, a1, m, a2, a2))
            s1, s3 = b.double(ab), b.double(bc)
        else:  # the symbolic engines emit in this order
            s0 = b.square(a0)
            ab = b.mul(a0, a1)
            s1 = b.double(ab)
            s2 = b.square(b.add(b.sub(a0, a1), a2))
            bc = b.mul(a1, a2)
            s3 = b.double(bc)
            s4 = b.square(a2)
        c0 = b.add(s0, self.mul_by_nr(s3))
        c1 = b.add(s1, self.mul_by_nr(s4))
        c2 = b.sub(b.add(b.add(s1, s2), s3), b.add(s0, s4))
        return self.build([c0, c1, c2])

    def inverse(self, x):
        # e6.go Inverse (Grewal et al. / standard cubic inversion)
        b = self.base
        a0, a1, a2 = (self.coeff(x, i) for i in range(3))
        t0, t1, t2 = b.square(a0), b.square(a1), b.square(a2)
        t3, t4, t5 = b.mul(a0, a1), b.mul(a0, a2), b.mul(a1, a2)
        c0 = b.sub(t0, self.mul_by_nr(t5))
        c1 = b.sub(self.mul_by_nr(t2), t3)
        c2 = b.sub(t1, t4)
        t6 = b.add(b.mul(a0, c0),
                   self.mul_by_nr(b.add(b.mul(a2, c1), b.mul(a1, c2))))
        f = b.inverse(t6)
        return self.build([b.mul(c0, f), b.mul(c1, f), b.mul(c2, f)])

    def mul_by_v(self, x):
        """x * v: coefficient rotation with one nr-mul."""
        a0, a1, a2 = (self.coeff(x, i) for i in range(3))
        return self.build([self.mul_by_nr(a2), a0, a1])
