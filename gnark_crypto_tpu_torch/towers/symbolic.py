"""Symbolic field/tower engines: run formula code to EMIT VM programs.

Counterpart of ``gnark_crypto_tpu/towers/symbolic.py``. The extension
towers (``towers/engine.py``, ``towers/tower12.py``, ``towers/tower24.py``,
``towers/tower6.py``) and the pairing step formulas
(``pairing/pairing12.py``, ``pairing/pairing6.py``) are written
against the field-engine protocol. This module provides a drop-in engine
whose "elements" are numpy arrays of SSA value ids and whose ops append
instructions to a :class:`field.vm.Asm`, so the same tower and pairing
code that computes values on word tensors also assembles the
straight-line programs the VM kernel executes.

Only the ops a straight-line program can express are supported; anything
data-dependent (where/is_zero on runtime values) raises. Device arguments
are accepted and ignored: a program is data, not a tensor.
"""

from __future__ import annotations

import numpy as np

from gnark_crypto_tpu_torch.field import vm
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.towers.engine import CubicExtEngine, QuadExtEngine
from gnark_crypto_tpu_torch.towers.tower12 import TOWER12_PARAMS, Tower12
from gnark_crypto_tpu_torch.towers.tower24 import TOWER24_PARAMS, Tower24
from gnark_crypto_tpu_torch.towers.tower6 import TOWER6_PARAMS, Tower6


class SymField:
    """Field-engine protocol over SSA ids (numpy int32 arrays)."""

    elem_dims = 0

    def __init__(self, spec: FieldSpec, asm: vm.Asm):
        assert asm.spec == spec
        self.spec = spec
        self.asm = asm

    # -- shape helpers -------------------------------------------------------
    def eshape(self, x):
        return np.asarray(x).shape

    def broadcast_to(self, x, shape):
        return np.broadcast_to(np.asarray(x), shape)

    # -- emission ------------------------------------------------------------
    def _map2(self, op, a, b):
        a, b = np.asarray(a), np.asarray(b)
        sh = np.broadcast_shapes(a.shape, b.shape)
        af = np.broadcast_to(a, sh).ravel()
        bf = np.broadcast_to(b, sh).ravel()
        out = [self.asm._emit(op, int(x), int(y)) for x, y in zip(af, bf)]
        return np.asarray(out, np.int32).reshape(sh)

    def _map1(self, fn, a):
        a = np.asarray(a)
        out = [fn(int(x)) for x in a.ravel()]
        return np.asarray(out, np.int32).reshape(a.shape)

    # -- constants / constructors --------------------------------------------
    def from_int(self, v, mont: bool = True, device=None):
        assert mont, "symbolic engine carries field values only"
        if isinstance(v, (list, tuple)):
            return np.asarray([self.asm.const(int(c)) for c in v], np.int32)
        return np.asarray(self.asm.const(int(v)), np.int32)

    def zeros(self, shape=(), device=None):
        return np.broadcast_to(np.asarray(self.asm.const(0), np.int32), shape)

    def ones(self, shape=(), device=None):
        return np.broadcast_to(np.asarray(self.asm.const(1), np.int32), shape)

    def input(self, name: str, shape=()):
        return np.broadcast_to(
            np.asarray(self.asm.input(name), np.int32), shape)

    # -- arithmetic ------------------------------------------------------------
    def mul(self, a, b):
        return self._map2(vm.OP_MUL, a, b)

    def add(self, a, b):
        return self._map2(vm.OP_ADD, a, b)

    def sub(self, a, b):
        return self._map2(vm.OP_SUB, a, b)

    def square(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

    def halve(self, a):
        return self._map1(lambda x: self.asm.halve(x), a)

    def neg(self, a):
        return self.sub(self.zeros(self.eshape(a)), a)

    def rot(self, a, lanes: int):
        """Cross-lane rotation (lane i <- lane i+lanes); VM-only op."""
        return self._map1(lambda x: self.asm.rot(x, lanes), a)

    def mul_const(self, a, c: int):
        """x * c for small plain c via a double-and-add chain."""
        c = int(c)
        if c == 0:
            return self.zeros(self.eshape(a))

        def chain(x):
            bits = bin(c)[2:]
            acc = x
            for bit in bits[1:]:
                acc = self.asm.add(acc, acc)
                if bit == "1":
                    acc = self.asm.add(acc, x)
            return acc

        return self._map1(chain, a)

    def exp_const(self, a, e: int):
        """x^e, plain MSB square-and-multiply (static exponent)."""
        assert e >= 0
        if e == 0:
            return self.ones(self.eshape(a))

        def ladder(x):
            bits = bin(e)[2:]
            acc = x
            for bit in bits[1:]:
                acc = self.asm.mul(acc, acc)
                if bit == "1":
                    acc = self.asm.mul(acc, x)
            return acc

        return self._map1(ladder, a)

    def inverse(self, a):
        """Fermat x^(q-2) (maps 0 -> 0, like the engine inverse)."""
        return self.exp_const(a, self.spec.modulus - 2)

    # -- unsupported (data-dependent) ----------------------------------------
    def _unsupported(self, *_a, **_k):
        raise NotImplementedError(
            "data-dependent op in a straight-line VM program")

    where = select = is_zero = equal = sqrt = legendre = _unsupported

    def __repr__(self):
        return f"SymField({self.spec.name})"

    def __hash__(self):
        return hash(("SymField", self.spec, id(self.asm)))

    def __eq__(self, other):
        return self is other


class _SymExtMixin:
    """Numpy-backed structural ops (the base class stacks torch tensors)."""

    def build(self, coeffs):
        return np.stack([np.asarray(c) for c in coeffs],
                        axis=-1 - self.base.elem_dims)

    def broadcast_to(self, x, shape):
        x = np.asarray(x)
        return np.broadcast_to(x, (*shape, *x.shape[x.ndim - self.elem_dims:]))

    def where(self, *_a, **_k):
        raise NotImplementedError(
            "data-dependent select in a straight-line VM program")


class SymQuadExt(_SymExtMixin, QuadExtEngine):
    pass


class SymCubicExt(_SymExtMixin, CubicExtEngine):
    pass


class SymTower12(Tower12):
    """Tower12 over a symbolic fp engine."""

    def __init__(self, name: str, asm: vm.Asm):
        spec, beta, xi = TOWER12_PARAMS[name]
        super().__init__(name, spec, beta, xi,
                         fp=SymField(spec, asm),
                         quad_cls=SymQuadExt, cubic_cls=SymCubicExt)

    def rot(self, x, lanes: int):
        """Lane-rotate every fp coefficient (for in-kernel product trees)."""
        return self.fp.rot(x, lanes)


class SymTower24(Tower24):
    """Tower24 over a symbolic fp engine (the BLS24 VM pairing programs)."""

    def __init__(self, name: str, asm: vm.Asm):
        spec, beta, v_sq = TOWER24_PARAMS[name]
        super().__init__(name, spec, beta, v_sq,
                         fp=SymField(spec, asm),
                         quad_cls=SymQuadExt, cubic_cls=SymCubicExt)

    def rot(self, x, lanes: int):
        """Lane-rotate every fp coefficient (for in-kernel product trees)."""
        return self.fp.rot(x, lanes)


class SymTower6(Tower6):
    """Tower6 over a symbolic fp engine (the BW6 VM pairing programs)."""

    def __init__(self, name: str, asm: vm.Asm):
        spec, nr = TOWER6_PARAMS[name]
        super().__init__(name, spec, nr, fp=SymField(spec, asm),
                         quad_cls=SymQuadExt, cubic_cls=SymCubicExt)

    def rot(self, x, lanes: int):
        """Lane-rotate every fp coefficient (for in-kernel product trees)."""
        return self.fp.rot(x, lanes)
