"""Full pairings as straight-line VM programs.

Counterpart of ``gnark_crypto_tpu/pairing/vm_pairing.py``. The entire
Miller loop + final exponentiation is ASSEMBLED into a VM program
(``field/vm.py``) by running the pairing formulas of
``pairing/pairing12.py`` over the symbolic tower (``towers/symbolic.py``):
the digit branches become straight-line code because the loop counters are
compile-time constants, as in the reference's unrolled ``e12_pairing.go``
chains.

The BLS24 programs run the same formulas over ``SymTower24``: G2
coordinates are E4 elements (four fp inputs each, ``qx0..qx3``) and GT is
E24 (24 fp outputs), at 10 words.

Execution: ONE VM launch per ``_TILE[name]`` pairs (Miller + in-program
lane product + final exp, the ``full`` program), or a short chain for
larger batches: ``miller`` per tile, ``product`` folds while more than one
tile of tile-products remains, then ``reduce`` (lane product + final exp).
The product over lanes is exact, so the GT result does not depend on the
tiling. Every program runs as ``vm.schedule`` lays it out in waves
(:func:`program`), on the CPU as on the card.

Infinite pairs are neutralized without branches: the caller feeds per-lane
Montgomery masks (m, mc) in {0, 1}, and the program computes
``facc = m*facc + mc`` before the product tree (the reference's pair
filtering, pairing.go:118-126). Pad lanes beyond the batch get m = 0 and
mc = 1.

Reference anchors: Pair/MillerLoop/FinalExponentiation
(``ecc/bn254/pairing.go:26,111,52``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import vm
from gnark_crypto_tpu_torch.pairing.pairing12 import (
    G2Proj, PairingCtx, final_exponentiation, get_ctx)
from gnark_crypto_tpu_torch.towers.symbolic import SymTower12, SymTower24
from gnark_crypto_tpu_torch.towers.tower12 import (
    TOWER12_PARAMS, _scale_ext_by_fp)
from gnark_crypto_tpu_torch.towers.tower24 import TOWER24_PARAMS

VM_FAMILIES = ("bn254", "bls12_381", "bls12_377", "bls24_315", "bls24_317")

# lanes per VM tile, per family: one warp, one block of the VM kernel, whose
# register file (K x 4W bytes a lane: K <= 168 at 8 words, 140 at 12, 181 at
# 10 for the bls24 programs) fits a block's shared memory at 32 lanes. The
# reference's 256 and 128 answered the TPU's VMEM and its 128-lane rotates.
_TILE = {"bn254": 32, "bls12_381": 32, "bls12_377": 32,
         "bls24_315": 32, "bls24_317": 32}

# rows a wave, i.e. warps of the VM block, for every program variant: on
# the H100 each of the 12 pairing programs runs fastest at 16 of 4, 8, 12
# and 16 warps, with little left between 12 and 16, where the SM's four
# schedulers are issue-bound (tools/vm_waves.py; PERF.md)
WARPS = 16

def _bls24(name: str) -> bool:
    return name.startswith("bls24")


def _gt_coeffs(name: str) -> int:
    """GT coefficients over fp: 24 for BLS24 (E24), 12 for BN/BLS12."""
    return 24 if _bls24(name) else 12


def _gt_shape(name: str) -> tuple[int, ...]:
    """[w][v][u] for E12, [z][w][v][u] for E24."""
    return (2, 3, 2, 2) if _bls24(name) else (2, 3, 2)


def _q_coords(name: str) -> int:
    """fp coefficients per G2 coordinate: 2 over E2, 4 over E4 (BLS24)."""
    return 4 if _bls24(name) else 2


def _coord_shape(name: str) -> tuple[int, ...]:
    return (2, 2) if _bls24(name) else (2,)


def _flat_ids(x) -> list[int]:
    return [int(v) for v in np.asarray(x).ravel()]


def _coord_input(asm: vm.Asm, prefix: str, name: str):
    """A G2 coordinate's program inputs ``{prefix}0..`` as an id array of
    the coordinate engine's element shape."""
    ids = [asm.input(f"{prefix}{i}") for i in range(_q_coords(name))]
    return np.asarray(ids, np.int32).reshape(_coord_shape(name))


def _mask_gt(tw, facc, m, mc):
    """facc = m * facc (+ mc at the real unit slot): dead-lane neutralizer."""
    f = tw.fp
    facc = _scale_ext_by_fp(tw, facc, m)
    idx = (0,) * facc.ndim
    facc = np.array(facc)
    facc[idx] = f.add(facc[idx], mc)
    return facc


def _sym_miller12(asm: vm.Asm, ctx: PairingCtx):
    """BN/BLS12/BLS24 Miller loop over the symbolic tower; returns the
    masked facc coefficient-id array. ``e2`` is the G2 coordinate engine:
    E2, or E4 for BLS24."""
    tw = ctx.tower
    f, e2 = tw.fp, tw.e2

    px, py = f.input("px"), f.input("py")
    qx = _coord_input(asm, "qx", ctx.name)
    qy = _coord_input(asm, "qy", ctx.name)
    m, mc = f.input("m"), f.input("mc")

    q = G2Proj(qx, qy, e2.ones(()))
    qny = e2.neg(qy)
    facc = tw.e12.ones(())

    for d in ctx.loop[-2::-1]:
        facc = tw.e12.square(facc)
        q, line = ctx.double_step(q)
        facc = ctx.line_prod(facc, line, px, py)
        if d != 0:
            q, line = ctx.add_mixed_step(q, qx, qny if d == -1 else qy)
            facc = ctx.line_prod(facc, line, px, py)

    if ctx.family == "bn":
        # terminal lines with Q1 = pi(Q), Q2 = -pi^2(Q) (pairing.go:256-286)
        q1x, q1y = ctx.psi_coords(qx, qy)
        q2x, q2y = ctx.psi2_coords(qx, qy)
        q, line = ctx.add_mixed_step(q, q1x, q1y)
        facc = ctx.line_prod(facc, line, px, py)
        facc = ctx.line_prod(facc, ctx.line_compute(q, q2x, q2y), px, py)
    elif ctx.seed_neg:
        facc = tw.conjugate(facc)

    return _mask_gt(tw, facc, m, mc)


def _sym_lane_product(tw, facc):
    """All-lanes product: log2(tile) rotate-multiply rounds; afterwards
    every lane holds the product over its tile (the assembler's tile)."""
    k = tw.fp.asm.tile // 2
    while k:
        facc = tw.e12.mul(facc, tw.rot(facc, k))
        k //= 2
    return facc


def build_program(name: str, variant: str, tile: int | None = None
                  ) -> vm.Program:
    """variant: 'full' (miller+product+finalexp), 'miller' (per-tile
    miller+product), 'product' (lane product only, GT in -> GT out),
    'reduce' (lane product + finalexp over GT inputs). ``tile`` defaults
    to the family's ``_TILE``. Programs are cached."""
    return _build_program(name, variant, tile or _TILE[name])


@functools.lru_cache(maxsize=None)
def _build_program(name: str, variant: str, tile: int) -> vm.Program:
    assert name in VM_FAMILIES, name
    if _bls24(name):
        asm = vm.Asm(TOWER24_PARAMS[name][0], tile=tile)
        tw = SymTower24(name, asm)
    else:
        asm = vm.Asm(TOWER12_PARAMS[name][0], tile=tile)
        tw = SymTower12(name, asm)
    ctx = PairingCtx(name, tower=tw)
    nc = _gt_coeffs(name)

    def outputs(gt):
        return {f"g{i}": v for i, v in enumerate(_flat_ids(gt))}

    if variant in ("reduce", "product"):
        f = tw.fp
        facc = np.asarray([f.input(f"f{i}") for i in range(nc)],
                          np.int32).reshape(_gt_shape(name))
        facc = _sym_lane_product(tw, facc)
        if variant == "product":
            return asm.build(outputs(facc))
        return asm.build(outputs(final_exponentiation(ctx, facc)))

    facc = _sym_lane_product(tw, _sym_miller12(asm, ctx))
    if variant == "miller":
        return asm.build(outputs(facc))
    assert variant == "full"
    return asm.build(outputs(final_exponentiation(ctx, facc)))


def program(name: str, variant: str) -> vm.Program:
    """The program that :func:`pair_vm` runs: ``build_program``'s at the
    family's tile, scheduled into waves of ``WARPS`` rows (cached by
    ``vm.schedule``)."""
    return vm.schedule(build_program(name, variant), WARPS)


def _pad_rows(x, n_pad: int, fill):
    """(n, W) -> (n_pad, W) with constant fill rows."""
    n, W = x.shape
    if n == n_pad:
        return x
    return torch.cat([x, fill.expand(n_pad - n, W)], dim=0)


def pair_vm(name: str, P, QX, QY):
    """Reduced pairing prod_i e(P_i, Q_i) via VM programs, on the device of
    the inputs: one launch for a batch of at most one tile, otherwise
    ``miller``, then ``product`` while more than one tile of products
    remains, then ``reduce``.

    P: G1 ``Affine`` of (n, W) words; QX, QY: (n, 2, W) E2 coordinates,
    or (n, 2, 2, W) E4 coordinates for BLS24; infinity is all-zero.
    Returns the GT element, (2, 3, 2, W), or (2, 3, 2, 2, W) for BLS24.
    """
    if name not in VM_FAMILIES:
        raise NotImplementedError(
            f"{name}: the BW6 pairings are not ported yet (ROADMAP.md "
            "queue 1, item 4)")
    ctx = get_ctx(name, P.x.device)
    tw = ctx.tower
    f, e2 = tw.fp, tw.e2
    n = f.eshape(P.x)[0]
    tile = _TILE[name]
    n_pad = -(-n // tile) * tile

    inf = (f.is_zero(P.x) & f.is_zero(P.y)) | \
        (e2.is_zero(QX) & e2.is_zero(QY))
    one_row = f.ones(device=P.x.device)
    zero_row = torch.zeros_like(one_row)
    m = f.where(inf, zero_row.expand(n, -1), one_row.expand(n, -1))
    mc = f.where(inf, one_row.expand(n, -1), zero_row.expand(n, -1))
    inputs = {
        "px": _pad_rows(P.x, n_pad, zero_row),
        "py": _pad_rows(P.y, n_pad, zero_row),
        "m": _pad_rows(m, n_pad, zero_row),
        "mc": _pad_rows(mc, n_pad, one_row),
    }
    W = f.spec.n_words
    qxf, qyf = QX.reshape(n, -1, W), QY.reshape(n, -1, W)
    for i in range(_q_coords(name)):
        inputs[f"qx{i}"] = _pad_rows(qxf[:, i], n_pad, zero_row)
        inputs[f"qy{i}"] = _pad_rows(qyf[:, i], n_pad, zero_row)
    nc = _gt_coeffs(name)

    def gt_from(out, row):
        coeffs = [out[f"g{i}"][row] for i in range(nc)]
        return torch.stack(coeffs, 0).reshape(*_gt_shape(name), -1)

    if n_pad == tile:
        out = vm.execute(program(name, "full"), inputs, n_pad)
        return gt_from(out, 0)

    # multi-tile: per-tile miller products, then cross-tile reduce+finalexp;
    # for more than one tile of tile-products, fold with product rounds
    out = vm.execute(program(name, "miller"), inputs, n_pad)
    T = n_pad // tile
    vals = [out[f"g{i}"][::tile] for i in range(nc)]

    def tile_inputs(vals, t_pad):
        return {f"f{i}": _pad_rows(v, t_pad, one_row if i == 0 else zero_row)
                for i, v in enumerate(vals)}

    while T > tile:
        t_pad = -(-T // tile) * tile
        out = vm.execute(program(name, "product"),
                         tile_inputs(vals, t_pad), t_pad)
        T = t_pad // tile
        vals = [out[f"g{i}"][::tile] for i in range(nc)]

    out = vm.execute(program(name, "reduce"), tile_inputs(vals, tile),
                     tile)
    return gt_from(out, 0)
