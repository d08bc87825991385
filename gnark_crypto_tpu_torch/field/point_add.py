"""Kernels: short-Weierstrass point arithmetic, and their plain versions.

Counterpart of ``gnark_crypto_tpu/field/pallas/point_add.py``. Each wrapper
takes and returns ``(N, W)`` int32 coordinate tensors (Montgomery words) in
the JAX wrapper's argument order, with the curve's ``a`` as a plain int:

* :func:`jac_add` / :func:`jac_double`: complete masked Jacobian add
  (add-2007-bl with the doubling fallback; P = Q, P = -Q and infinities)
  and Jacobian double (dbl-2009-l, dbl-2007-bl when a != 0);
* :func:`affine_prep` / :func:`affine_finish`: one level of the MSM's
  batch-affine tree, before and after the batched inversion of the
  denominators;
* :func:`jac_fold_windows`: the Horner fold of the per-window totals.

A CUDA tensor goes to ``csrc/point_add.cu`` or ``csrc/affine_level.cu``
(cores in ``csrc/point.cuh``; W = 8, 10, 12, 20 or 24 words, and at 8
the 256-bit secp256k1/r1 Fp too), a CPU tensor to the ``*_plain`` version
here. The plain versions use only
:func:`mont_mul_plain` and the plain ``mont.add``/``mont.sub``, so on the
card they launch no kernel. Both follow the JAX formulas in the same
order with canonical arithmetic, so they agree bit for bit, and with the
JAX package as integers.

Infinity is all-zero: (0, 0, 0) in Jacobian and (0, 0) in affine
coordinates. Mask bits (``affine_prep``'s third output, int32 (N,)):
``MB_DBL | MB_INFOUT | MB_PINF | MB_QINF``; tree bits (int32 (N,)): bit 0
eq, bit 1 l_single, bit 2 r_single.
"""

from __future__ import annotations

import ctypes

import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.kernels import (
    FIELD_WIDTHS, FULL_WIDTHS, check_kernel_args, const_words, count_launch,
    mont_mul_plain, to_i32)
from gnark_crypto_tpu_torch.specs.field import FieldSpec, int_to_words
from gnark_crypto_tpu_torch.utils import build

MB_DBL, MB_INFOUT, MB_PINF, MB_QINF = 1, 2, 4, 8

Coords = tuple[torch.Tensor, ...]


def _a_mont(spec: FieldSpec, a_int: int) -> int:
    return a_int % spec.modulus * spec.r % spec.modulus


def _elem(spec: FieldSpec, value: int, like: torch.Tensor) -> torch.Tensor:
    """A (W,) int32 constant on like's device (Montgomery words given)."""
    return to_i32(const_words(int_to_words(value, spec.n_words),
                              str(like.device)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

class _Ops:
    """The field ops of the plain cores (``_field_ops``) on ``(N, W)``
    elements; ``field/point_add2.py`` subclasses it for Fp2, as the JAX
    package's cores take an ops tuple."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def mul(self, a, b):
        return mont_mul_plain(self.spec, a, b)

    def add(self, a, b):
        return mont.add(self.spec, a, b)

    def sub(self, a, b):
        return mont.sub(self.spec, a, b)

    def dbl(self, a):
        return self.add(a, a)

    def is_zero(self, t: torch.Tensor) -> torch.Tensor:
        return torch.all(t == 0, dim=-1)

    def equal(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.is_zero(a ^ b)

    def sel(self, cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
        return torch.where(cond[..., None], a, b)

    def one(self, like: torch.Tensor) -> torch.Tensor:
        """Montgomery one, shaped like ``like``."""
        return _elem(self.spec, self.spec.r, like).expand_as(like)


def _dbl_core(f: _Ops, a_int: int, x1, y1, z1) -> Coords:
    """dbl-2009-l / dbl-2007-bl (g1.go:397); Z3 = 0 when Z1 = 0."""
    A = f.mul(x1, x1)
    B = f.mul(y1, y1)
    C = f.mul(B, B)
    t = f.add(x1, B)
    t = f.mul(t, t)
    D = f.dbl(f.sub(f.sub(t, A), C))
    E = f.add(f.dbl(A), A)
    if a_int % f.spec.modulus:
        z2 = f.mul(z1, z1)
        a = _elem(f.spec, _a_mont(f.spec, a_int), x1)
        E = f.add(E, f.mul(f.mul(z2, z2), a))
    F = f.mul(E, E)
    xd = f.sub(F, f.dbl(D))
    yd = f.sub(f.mul(E, f.sub(D, xd)), f.dbl(f.dbl(f.dbl(C))))
    zd = f.dbl(f.mul(y1, z1))
    return xd, yd, zd


def _add_core(f: _Ops, a_int: int, x1, y1, z1, x2, y2, z2) -> Coords:
    """Complete masked add-2007-bl (g1.go:332) with the doubling fallback,
    the branches selected lane by lane (``_add_core_ops``)."""
    z1z1 = f.mul(z1, z1)
    z2z2 = f.mul(z2, z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(f.mul(y1, z2), z2z2)
    s2 = f.mul(f.mul(y2, z1), z1z1)
    h = f.sub(u2, u1)
    i = f.dbl(h)
    i = f.mul(i, i)
    j = f.mul(h, i)
    rr = f.dbl(f.sub(s2, s1))
    v = f.mul(u1, i)
    x3 = f.sub(f.sub(f.mul(rr, rr), j), f.dbl(v))
    y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.dbl(f.mul(s1, j)))
    z12 = f.add(z1, z2)
    z3 = f.mul(f.sub(f.sub(f.mul(z12, z12), z1z1), z2z2), h)

    h0, r0 = f.is_zero(h), f.is_zero(rr)
    p_inf, q_inf = f.is_zero(z1), f.is_zero(z2)
    is_dbl = h0 & r0
    is_inf = h0 & ~r0 & ~p_inf & ~q_inf
    # the doubling fallback only where a lane takes it (the same values)
    dbl = (_dbl_core(f, a_int, x1, y1, z1) if bool(is_dbl.any())
           else (x3, y3, z3))
    zero = torch.zeros_like(x3)
    out = []
    for gen, d, pc, qc in zip((x3, y3, z3), dbl, (x1, y1, z1), (x2, y2, z2)):
        o = f.sel(is_dbl, d, gen)
        o = f.sel(is_inf, zero, o)
        o = f.sel(p_inf, qc, o)
        out.append(f.sel(q_inf, pc, o))
    return tuple(out)


def _prep_core(f: _Ops, a_int: int, px, py, qx, qy):
    """(den, num, maskbits) of the complete affine add P + Q."""
    p_inf = f.is_zero(px) & f.is_zero(py)
    q_inf = f.is_zero(qx) & f.is_zero(qy)
    both = ~p_inf & ~q_inf
    x_eq = f.equal(px, qx)
    y_eq = f.equal(py, qy)
    is_dbl = x_eq & y_eq & both
    inf_out = (x_eq & ~y_eq & both) | (is_dbl & f.is_zero(py))
    den = f.sel(is_dbl, f.dbl(py), f.sub(qx, px))
    den = f.sel(f.is_zero(den), f.one(den), den)
    x2 = f.mul(px, px)
    num_dbl = f.add(f.dbl(x2), x2)
    if a_int % f.spec.modulus:
        num_dbl = f.add(num_dbl, _elem(f.spec, _a_mont(f.spec, a_int),
                                       px).expand_as(num_dbl))
    num = f.sel(is_dbl, num_dbl, f.sub(qy, py))
    bits = (is_dbl.to(torch.int32) * MB_DBL
            + inf_out.to(torch.int32) * MB_INFOUT
            + p_inf.to(torch.int32) * MB_PINF
            + q_inf.to(torch.int32) * MB_QINF)
    return den, num, bits


def _finish_core(f: _Ops, lpx, lpy, lsx, lsy, rpx, rpy, rsx, rsy, num, dinv,
                 maskbits, treebits) -> Coords:
    """(pre.x, pre.y, suf.x, suf.y, pt_a.x, pt_a.y, z_a) of one level."""
    px, py, qx, qy = lsx, lsy, rpx, rpy
    inf_out = (maskbits & MB_INFOUT) != 0
    p_inf = (maskbits & MB_PINF) != 0
    q_inf = (maskbits & MB_QINF) != 0
    s = f.mul(num, dinv)
    x3 = f.sub(f.sub(f.mul(s, s), px), qx)
    y3 = f.sub(f.mul(s, f.sub(px, x3)), py)
    zero = torch.zeros_like(px)
    mx, my = f.sel(inf_out, zero, x3), f.sel(inf_out, zero, y3)
    mx, my = f.sel(p_inf, qx, mx), f.sel(p_inf, qy, my)
    mx, my = f.sel(q_inf, px, mx), f.sel(q_inf, py, my)
    eq = (treebits & 1) != 0
    l_single = (treebits & 2) != 0
    r_single = (treebits & 4) != 0
    pax, pay = f.sel(eq, mx, px), f.sel(eq, my, py)
    za = f.sel(f.is_zero(pax) & f.is_zero(pay), zero, f.one(px))
    return (f.sel(l_single & eq, mx, lpx), f.sel(l_single & eq, my, lpy),
            f.sel(r_single & eq, mx, rsx), f.sel(r_single & eq, my, rsy),
            pax, pay, za)


def _fold_core(f: _Ops, a_int: int, x, y, z, c: int) -> Coords:
    """acc = sum_w 2^(c w) T_w by Horner; (nwin, ...) in, (1, ...) out."""
    nwin = x.shape[0]
    acc = (x[nwin - 1:], y[nwin - 1:], z[nwin - 1:])
    for w in range(nwin - 2, -1, -1):
        for _ in range(c):
            acc = _dbl_core(f, a_int, *acc)
        acc = _add_core(f, a_int, *acc, x[w:w + 1], y[w:w + 1], z[w:w + 1])
    return acc


def jac_add_plain(spec: FieldSpec, a_int: int, x1, y1, z1, x2, y2, z2
                  ) -> Coords:
    return _add_core(_Ops(spec), a_int, x1, y1, z1, x2, y2, z2)


def jac_double_plain(spec: FieldSpec, a_int: int, x1, y1, z1) -> Coords:
    return _dbl_core(_Ops(spec), a_int, x1, y1, z1)


def affine_prep_plain(spec: FieldSpec, a_int: int, px, py, qx, qy
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _prep_core(_Ops(spec), a_int, px, py, qx, qy)


def affine_finish_plain(spec: FieldSpec, a_int: int, lpx, lpy, lsx, lsy,
                        rpx, rpy, rsx, rsy, num, dinv, maskbits, treebits
                        ) -> Coords:
    return _finish_core(_Ops(spec), lpx, lpy, lsx, lsy, rpx, rpy, rsx, rsy,
                        num, dinv, maskbits, treebits)


def jac_fold_windows_plain(spec: FieldSpec, a_int: int, x, y, z, c: int
                           ) -> Coords:
    return _fold_core(_Ops(spec), a_int, x, y, z, c)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _curve_args(spec: FieldSpec, a_int: int):
    """(curve words: a then one, Montgomery; a_is_zero) for a launch."""
    am = _a_mont(spec, a_int)
    words = (*int_to_words(am, spec.n_words), *spec.one_words)
    return (ctypes.c_uint32 * len(words))(*words), int(am == 0)


def _check(spec: FieldSpec, what: str, *coords: torch.Tensor) -> int:
    check_kernel_args(spec, what, *coords, widths=FIELD_WIDTHS,
                      full_widths=FULL_WIDTHS)
    n = coords[0].shape[0]
    if any(t.shape[0] != n for t in coords):
        raise ValueError(f"{what}: coordinate tensors differ in length")
    return n


def _check_bits(what: str, n: int, *bits: torch.Tensor) -> None:
    for b in bits:
        if (b.dtype != torch.int32 or tuple(b.shape) != (n,)
                or not b.is_contiguous() or not b.is_cuda):
            raise ValueError(f"{what}: bit words must be contiguous int32 "
                             f"({n},) on the card")


_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int


def _ptrs(*ts: torch.Tensor) -> list[int]:
    return [t.data_ptr() for t in ts]


def jac_add(spec: FieldSpec, a_int: int, x1, y1, z1, x2, y2, z2) -> Coords:
    """Complete Jacobian add of two (N, W) point batches."""
    if not x1.is_cuda:
        return jac_add_plain(spec, a_int, x1, y1, z1, x2, y2, z2)
    n = _check(spec, "jac_add", x1, y1, z1, x2, y2, z2)
    out = tuple(torch.empty_like(x1) for _ in range(3))
    cw, az = _curve_args(spec, a_int)
    fn = build.function("point_add", "gct_jac_add",
                        [_P] * 9 + [_N, _I, _P, _P, _I, _P])
    count_launch(jac_add, spec)
    build.check(fn(*_ptrs(x1, y1, z1, x2, y2, z2, *out), n, spec.n_words,
                   build.field_words(spec), cw, az, build.stream_ptr(x1)),
                "jac_add launch")
    return out


def jac_double(spec: FieldSpec, a_int: int, x1, y1, z1) -> Coords:
    """Jacobian double of an (N, W) point batch (infinity-safe)."""
    if not x1.is_cuda:
        return jac_double_plain(spec, a_int, x1, y1, z1)
    n = _check(spec, "jac_double", x1, y1, z1)
    out = tuple(torch.empty_like(x1) for _ in range(3))
    cw, az = _curve_args(spec, a_int)
    fn = build.function("point_add", "gct_jac_double",
                        [_P] * 6 + [_N, _I, _P, _P, _I, _P])
    count_launch(jac_double, spec)
    build.check(fn(*_ptrs(x1, y1, z1, *out), n, spec.n_words,
                   build.field_words(spec), cw, az, build.stream_ptr(x1)),
                "jac_double launch")
    return out


def affine_prep(spec: FieldSpec, a_int: int, px, py, qx, qy):
    """(den, num, maskbits) for the complete affine adds P + Q: (N, W) in,
    den/num (N, W) and maskbits (N,) int32 out."""
    if not px.is_cuda:
        return affine_prep_plain(spec, a_int, px, py, qx, qy)
    n = _check(spec, "affine_prep", px, py, qx, qy)
    den, num = torch.empty_like(px), torch.empty_like(px)
    bits = torch.empty((n,), dtype=torch.int32, device=px.device)
    cw, az = _curve_args(spec, a_int)
    fn = build.function("affine_level", "gct_affine_prep",
                        [_P] * 7 + [_N, _I, _P, _P, _I, _P])
    count_launch(affine_prep, spec)
    build.check(fn(*_ptrs(px, py, qx, qy, den, num, bits), n, spec.n_words,
                   build.field_words(spec), cw, az, build.stream_ptr(px)),
                "affine_prep launch")
    return den, num, bits


def affine_finish(spec: FieldSpec, a_int: int, lpx, lpy, lsx, lsy, rpx, rpy,
                  rsx, rsy, num, dinv, maskbits, treebits) -> Coords:
    """Finish one tree level: (pre.x, pre.y, suf.x, suf.y, pt_a.x, pt_a.y,
    z_a), all (N, W); z_a is Montgomery one, or zero where pt_a is
    infinity."""
    ins = (lpx, lpy, lsx, lsy, rpx, rpy, rsx, rsy, num, dinv)
    if not lpx.is_cuda:
        return affine_finish_plain(spec, a_int, *ins, maskbits, treebits)
    n = _check(spec, "affine_finish", *ins)
    _check_bits("affine_finish", n, maskbits, treebits)
    out = tuple(torch.empty_like(lpx) for _ in range(7))
    cw, _ = _curve_args(spec, a_int)
    fn = build.function("affine_level", "gct_affine_finish",
                        [_P] * 4 + [_N, _I, _P, _P, _P])
    count_launch(affine_finish, spec)
    build.check(fn((_P * 10)(*_ptrs(*ins)), maskbits.data_ptr(),
                   treebits.data_ptr(), (_P * 7)(*_ptrs(*out)), n,
                   spec.n_words, build.field_words(spec), cw,
                   build.stream_ptr(lpx)),
                "affine_finish launch")
    return out


def jac_fold_windows(spec: FieldSpec, a_int: int, x, y, z, c: int
                     ) -> Coords:
    """Horner fold of per-window totals (msmReduceChunkG1Affine,
    multiexp.go:303): x/y/z are (nwin, W) Jacobian coordinates; returns
    the folded point as (1, W) coordinates."""
    if not x.is_cuda:
        return jac_fold_windows_plain(spec, a_int, x, y, z, c)
    nwin = _check(spec, "jac_fold_windows", x, y, z)
    if nwin < 1:
        raise ValueError("jac_fold_windows: no window")
    out = tuple(torch.empty((1, spec.n_words), dtype=torch.int32,
                            device=x.device) for _ in range(3))
    cw, az = _curve_args(spec, a_int)
    fn = build.function("point_add", "gct_jac_fold_windows",
                        [_P] * 6 + [_I, _I, _I, _P, _P, _I, _P])
    count_launch(jac_fold_windows, spec)
    build.check(fn(*_ptrs(x, y, z, *out), nwin, c, spec.n_words,
                   build.field_words(spec), cw, az, build.stream_ptr(x)),
                "jac_fold_windows launch")
    return out


for _w in (jac_add, jac_double, affine_prep, affine_finish, jac_fold_windows):
    _w.launches = 0
    _w.launches_by_width = {}
del _w
