"""Kernels: G2 point arithmetic over Fp2, and their plain versions.

Counterpart of ``gnark_crypto_tpu/field/pallas/point_add2.py``: the Fp2
twins of ``field/point_add.py`` for curves over a quadratic extension with
a = 0 (the G2 twists). Each wrapper takes and returns ``(N, 2, W)`` int32
coordinate tensors (re, im Montgomery words) in the JAX wrapper's argument
order, with the BASE field spec and the non-residue ``nr`` (u^2 = nr):

* :func:`jac_add2` / :func:`jac_double2`: complete masked Jacobian add
  and Jacobian double (dbl-2009-l);
* :func:`affine_prep2` / :func:`affine_finish2`: one level of the G2 MSM's
  batch-affine tree, with the mask and tree bits of ``field/point_add.py``;
* :func:`jac_fold_windows2`: the Horner fold of the per-window totals.

A CUDA tensor goes to ``csrc/point_add2.cu`` or ``csrc/affine_level2.cu``
(the cores of ``csrc/point.cuh`` over ``csrc/fp2.cuh``), built for the
(words, nr) pairs of :data:`PAIRS`: bn254's Fp2 (8 words, u^2 = -1),
bls12-381's (12, -1) and bls12-377's (12, -5); any other pair raises on the
card before any launch. A CPU tensor goes to the ``*_plain`` version here,
which takes every word count and every nr in [-16, 16]. The plain versions run
the cores of ``field/point_add.py`` over Fp2 ops built from
:func:`mont_mul_plain` and the plain ``mont.add``/``mont.sub``, so on the
card they launch no kernel; both versions follow the JAX formulas in the
same order with canonical arithmetic and agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from gnark_crypto_tpu_torch.field import mont
from gnark_crypto_tpu_torch.field.kernels import check_width, count_launch
from gnark_crypto_tpu_torch.field.point_add import (
    _P, _N, _I, Coords, _check_bits, _dbl_core, _add_core, _finish_core,
    _fold_core, _Ops, _prep_core, _ptrs)
from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.utils import build


# the (base field words, nr) pairs the Fp2 kernels are built for
# (csrc/fp2.cuh gct::for_fp2), and their widths
PAIRS = ((8, -1), (12, -1), (12, -5))
WIDTHS = tuple(sorted({w for w, _ in PAIRS}))


class _Ops2(_Ops):
    """Fp2 = Fp[u]/(u^2 - nr) on ``(..., 2, W)`` tensors (``_fp2_ops``):
    Karatsuba with 3 base products, nr folded into additions."""

    def __init__(self, spec: FieldSpec, nr: int):
        if not (isinstance(nr, int) and nr != 0 and -16 <= nr <= 16):
            raise ValueError(f"non-residue {nr!r}: a small int in [-16, 16]"
                             " is needed")
        super().__init__(spec)
        self.nr = nr

    def _small(self, x, k: int):
        """k * x for 1 <= k <= 16."""
        acc = x
        for _ in range(k - 1):
            acc = mont.add(self.spec, acc, x)
        return acc

    def mul(self, a, b):
        s = self.spec
        ar, ai, br, bi = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        v0 = super().mul(ar, br)
        v1 = super().mul(ai, bi)
        t = super().mul(mont.add(s, ar, ai), mont.add(s, br, bi))
        if self.nr < 0:
            c0 = mont.sub(s, v0, self._small(v1, -self.nr))
        else:
            c0 = mont.add(s, v0, self._small(v1, self.nr))
        c1 = mont.sub(s, mont.sub(s, t, v0), v1)
        return torch.stack(torch.broadcast_tensors(c0, c1), dim=-2)

    def is_zero(self, t: torch.Tensor) -> torch.Tensor:
        return torch.all(t == 0, dim=-1).all(dim=-1)

    def sel(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    def one(self, like: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(like)
        out[..., 0, :] = super().one(like[..., 0, :])
        return out


def jac_add2_plain(spec: FieldSpec, nr: int, x1, y1, z1, x2, y2, z2
                   ) -> Coords:
    return _add_core(_Ops2(spec, nr), 0, x1, y1, z1, x2, y2, z2)


def jac_double2_plain(spec: FieldSpec, nr: int, x1, y1, z1) -> Coords:
    return _dbl_core(_Ops2(spec, nr), 0, x1, y1, z1)


def affine_prep2_plain(spec: FieldSpec, nr: int, px, py, qx, qy):
    return _prep_core(_Ops2(spec, nr), 0, px, py, qx, qy)


def affine_finish2_plain(spec: FieldSpec, nr: int, lpx, lpy, lsx, lsy,
                         rpx, rpy, rsx, rsy, num, dinv, maskbits, treebits
                         ) -> Coords:
    return _finish_core(_Ops2(spec, nr), lpx, lpy, lsx, lsy, rpx, rpy, rsx,
                        rsy, num, dinv, maskbits, treebits)


def jac_fold_windows2_plain(spec: FieldSpec, nr: int, x, y, z, c: int
                            ) -> Coords:
    return _fold_core(_Ops2(spec, nr), 0, x, y, z, c)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(spec: FieldSpec, nr: int, what: str, *coords: torch.Tensor
           ) -> int:
    """An Fp2 of :data:`PAIRS` and int32 (N, 2, W) coordinates, as the
    kernels take; any other (W, nr) pair raises here, before any launch."""
    check_width(spec, what, WIDTHS)
    if (spec.n_words, nr) not in PAIRS:
        raise NotImplementedError(
            f"{what}: the CUDA kernels take Fp2 over {spec.n_words}-word "
            f"fields with u^2 = "
            f"{' or '.join(str(r) for w, r in PAIRS if w == spec.n_words)}"
            f"; nr = {nr} is not built")
    n = coords[0].shape[0]
    for t in coords:
        if (t.dtype != torch.int32 or tuple(t.shape) != (n, 2, spec.n_words)
                or t.device != coords[0].device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"{what}: expected contiguous, 16-byte aligned int32 "
                f"({n}, 2, {spec.n_words}) tensors on one device, got "
                f"{t.dtype} {tuple(t.shape)}")
    return n


def _one_words(spec: FieldSpec) -> ctypes.Array:
    """Montgomery one of the base field, W words."""
    return (ctypes.c_uint32 * spec.n_words)(*spec.one_words)


def _field_args(spec: FieldSpec, nr: int) -> tuple:
    """Every entry's arguments after its tensors and counts: n_words, nr,
    and the field words (q, then -q^-1 mod 2^32)."""
    return spec.n_words, nr, build.field_words(spec)


def jac_add2(spec: FieldSpec, nr: int, x1, y1, z1, x2, y2, z2) -> Coords:
    """Complete Jacobian add of two (N, 2, W) G2 point batches."""
    if not x1.is_cuda:
        return jac_add2_plain(spec, nr, x1, y1, z1, x2, y2, z2)
    n = _check(spec, nr, "jac_add2", x1, y1, z1, x2, y2, z2)
    out = tuple(torch.empty_like(x1) for _ in range(3))
    fn = build.function("point_add2", "gct_jac_add2",
                        [_P] * 9 + [_N, _I, _I, _P, _P])
    count_launch(jac_add2, spec)
    build.check(fn(*_ptrs(x1, y1, z1, x2, y2, z2, *out), n,
                   *_field_args(spec, nr), build.stream_ptr(x1)),
                "jac_add2 launch")
    return out


def jac_double2(spec: FieldSpec, nr: int, x1, y1, z1) -> Coords:
    """Jacobian double of an (N, 2, W) G2 point batch (infinity-safe)."""
    if not x1.is_cuda:
        return jac_double2_plain(spec, nr, x1, y1, z1)
    n = _check(spec, nr, "jac_double2", x1, y1, z1)
    out = tuple(torch.empty_like(x1) for _ in range(3))
    fn = build.function("point_add2", "gct_jac_double2",
                        [_P] * 6 + [_N, _I, _I, _P, _P])
    count_launch(jac_double2, spec)
    build.check(fn(*_ptrs(x1, y1, z1, *out), n, *_field_args(spec, nr),
                   build.stream_ptr(x1)), "jac_double2 launch")
    return out


def affine_prep2(spec: FieldSpec, nr: int, px, py, qx, qy):
    """(den, num, maskbits) for the complete affine adds P + Q over Fp2:
    (N, 2, W) in, den/num (N, 2, W) and maskbits (N,) int32 out."""
    if not px.is_cuda:
        return affine_prep2_plain(spec, nr, px, py, qx, qy)
    n = _check(spec, nr, "affine_prep2", px, py, qx, qy)
    den, num = torch.empty_like(px), torch.empty_like(px)
    bits = torch.empty((n,), dtype=torch.int32, device=px.device)
    fn = build.function("affine_level2", "gct_affine_prep2",
                        [_P] * 7 + [_N, _I, _I, _P, _P, _P])
    count_launch(affine_prep2, spec)
    build.check(fn(*_ptrs(px, py, qx, qy, den, num, bits), n,
                   *_field_args(spec, nr), _one_words(spec),
                   build.stream_ptr(px)), "affine_prep2 launch")
    return den, num, bits


def affine_finish2(spec: FieldSpec, nr: int, lpx, lpy, lsx, lsy, rpx, rpy,
                   rsx, rsy, num, dinv, maskbits, treebits) -> Coords:
    """Finish one Fp2 tree level: (pre.x, pre.y, suf.x, suf.y, pt_a.x,
    pt_a.y, z_a), all (N, 2, W); z_a is one, or zero where pt_a is
    infinity."""
    ins = (lpx, lpy, lsx, lsy, rpx, rpy, rsx, rsy, num, dinv)
    if not lpx.is_cuda:
        return affine_finish2_plain(spec, nr, *ins, maskbits, treebits)
    n = _check(spec, nr, "affine_finish2", *ins)
    _check_bits("affine_finish2", n, maskbits, treebits)
    out = tuple(torch.empty_like(lpx) for _ in range(7))
    fn = build.function("affine_level2", "gct_affine_finish2",
                        [_P] * 4 + [_N, _I, _I, _P, _P, _P])
    count_launch(affine_finish2, spec)
    build.check(fn((_P * 10)(*_ptrs(*ins)), maskbits.data_ptr(),
                   treebits.data_ptr(), (_P * 7)(*_ptrs(*out)), n,
                   *_field_args(spec, nr), _one_words(spec),
                   build.stream_ptr(lpx)), "affine_finish2 launch")
    return out


def jac_fold_windows2(spec: FieldSpec, nr: int, x, y, z, c: int) -> Coords:
    """Horner fold of per-window G2 totals: x/y/z are (nwin, 2, W) Jacobian
    coordinates; returns the folded point as (1, 2, W) coordinates."""
    if not x.is_cuda:
        return jac_fold_windows2_plain(spec, nr, x, y, z, c)
    nwin = _check(spec, nr, "jac_fold_windows2", x, y, z)
    if nwin < 1:
        raise ValueError("jac_fold_windows2: no window")
    out = tuple(torch.empty((1, 2, spec.n_words), dtype=torch.int32,
                            device=x.device) for _ in range(3))
    fn = build.function("point_add2", "gct_jac_fold_windows2",
                        [_P] * 6 + [_I, _I, _I, _I, _P, _P])
    count_launch(jac_fold_windows2, spec)
    build.check(fn(*_ptrs(x, y, z, *out), nwin, c, *_field_args(spec, nr),
                   build.stream_ptr(x)), "jac_fold_windows2 launch")
    return out


for _w in (jac_add2, jac_double2, affine_prep2, affine_finish2,
           jac_fold_windows2):
    _w.launches = 0
    _w.launches_by_width = {}
del _w
