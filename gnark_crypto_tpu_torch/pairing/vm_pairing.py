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
E24 (24 fp outputs), at 10 words. The BW6 programs run the joint two-row
Miller loop and final exponentiation of ``pairing/pairing6.py`` over
``SymTower6``: G2 is over Fp (one fp input a coordinate, ``qx0``, ``qy0``)
and GT is E6 (6 fp outputs), at 24 words (bw6-761) and 20 (bw6-633).

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
from gnark_crypto_tpu_torch.pairing import pairing6
from gnark_crypto_tpu_torch.pairing.pairing12 import (
    G2Proj, PairingCtx, final_exponentiation, get_ctx)
from gnark_crypto_tpu_torch.towers.symbolic import (
    SymTower6, SymTower12, SymTower24)
from gnark_crypto_tpu_torch.towers.tower12 import (
    TOWER12_PARAMS, _scale_ext_by_fp)
from gnark_crypto_tpu_torch.towers.tower24 import TOWER24_PARAMS
from gnark_crypto_tpu_torch.towers.tower6 import TOWER6_PARAMS

VM_FAMILIES = ("bn254", "bls12_381", "bls12_377", "bls24_315", "bls24_317",
               "bw6_761", "bw6_633")
_BW6 = ("bw6_761", "bw6_633")

# lanes per VM tile, per family: one warp, one block of the VM kernel, whose
# register file (K x 4W bytes a lane: K <= 168 at 8 words, 140 at 12, 181 at
# 10 for the bls24 programs, 90 at 20 and 75 at 24 for bw6) fits a block's
# shared memory at 32 lanes. The reference's 256 and 128 answered the TPU's
# VMEM and its 128-lane rotates.
_TILE = {"bn254": 32, "bls12_381": 32, "bls12_377": 32,
         "bls24_315": 32, "bls24_317": 32, "bw6_761": 32, "bw6_633": 32}

# rows a wave, i.e. warps of the VM block, for every program variant: on
# the H100 each of the 12 pairing programs runs fastest at 16 of 4, 8, 12
# and 16 warps, with little left between 12 and 16, where the SM's four
# schedulers are issue-bound (tools/vm_waves.py; PERF.md)
WARPS = 16

def _bls24(name: str) -> bool:
    return name.startswith("bls24")


def _gt_coeffs(name: str) -> int:
    """GT coefficients over fp: 6 for BW6 (E6), 24 for BLS24 (E24), 12 for
    BN/BLS12."""
    return 6 if name in _BW6 else 24 if _bls24(name) else 12


def _gt_shape(name: str) -> tuple[int, ...]:
    """[v][u] for E6, [w][v][u] for E12, [z][w][v][u] for E24."""
    return {6: (2, 3), 12: (2, 3, 2), 24: (2, 3, 2, 2)}[_gt_coeffs(name)]


def _q_coords(name: str) -> int:
    """fp coefficients per G2 coordinate: 1 over Fp (BW6), 2 over E2, 4 over
    E4 (BLS24)."""
    return 1 if name in _BW6 else 4 if _bls24(name) else 2


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


def _sym_miller6(asm: vm.Asm, ctx: pairing6.PairingCtx6):
    """BW6 joint two-row Miller loop over the symbolic Tower6; returns the
    masked facc coefficient-id array. The reference's eager loop
    (pairing6.miller_loop) selects 1 on infinite lanes; here the lanes are
    masked as a whole."""
    tw = ctx.tower
    f, e6 = tw.fp, tw.e6
    px, py = f.input("px"), f.input("py")
    qx, qy = f.input("qx0"), f.input("qy0")
    m, mc = f.input("m"), f.input("mc")

    w = f.from_int(ctx.third_root)
    q0 = (qx, qy)
    q0n = (qx, f.neg(qy))
    q1 = (f.mul(qx, w), f.neg(qy))         # pairing.go:157-161
    q1n = (q1[0], qy)
    adds = {3: q1, 1: q0, -1: q0n, -3: q1n}

    start = q1 if ctx.par["start_q1"] else q0  # MSB of the scaled-by-3 row
    qp = pairing6.G2ProjFp(start[0], start[1], f.ones(()))
    facc = e6.ones(())

    for i in range(ctx.nbits - 1, 0, -1):
        facc = e6.square(facc)
        qp, line = ctx.double_step(qp)
        facc = e6.mul(facc, ctx.line_value(line, px, py))
        j = ctx._dig(i)
        if j:
            ax, ay = adds[j]
            qp, line = ctx.add_mixed_step(qp, ax, ay)
            facc = e6.mul(facc, ctx.line_value(line, px, py))
    # i = 0: the tangent, then the final line with no point update
    # (bw6-761 pairing.go:259-271 j=-3 -> q1Neg; bw6-633 :274-289 j=1 -> q0)
    facc = e6.square(facc)
    qp, line = ctx.double_step(qp)
    facc = e6.mul(facc, ctx.line_value(line, px, py))
    lp = {"q1n": q1n, "q0": q0}[ctx.par["i0"][0]]
    facc = e6.mul(facc, ctx.line_value(ctx.line_compute(qp, lp[0], lp[1]),
                                       px, py))
    if ctx.par["conj_end"]:
        facc = tw.conjugate(facc)  # negative seed (bw6-633)

    return _mask_gt(tw, facc, m, mc)


def _sym_lane_product(tw, gt, facc):
    """All-lanes product over the GT engine ``gt``: log2(tile)
    rotate-multiply rounds; afterwards every lane holds the product over its
    tile (the assembler's tile)."""
    k = tw.fp.asm.tile // 2
    while k:
        facc = gt.mul(facc, tw.rot(facc, k))
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
    if name in _BW6:
        asm = vm.Asm(TOWER6_PARAMS[name][0], tile=tile)
        tw = SymTower6(name, asm)
        ctx = pairing6.PairingCtx6(name, tower=tw)
        gt = tw.e6
        fin = pairing6.final_exponentiation
        miller = _sym_miller6
    else:
        params = TOWER24_PARAMS if _bls24(name) else TOWER12_PARAMS
        asm = vm.Asm(params[name][0], tile=tile)
        tw = (SymTower24 if _bls24(name) else SymTower12)(name, asm)
        ctx = PairingCtx(name, tower=tw)
        gt = tw.e12
        fin = final_exponentiation
        miller = _sym_miller12
    nc = _gt_coeffs(name)

    def outputs(z):
        return {f"g{i}": v for i, v in enumerate(_flat_ids(z))}

    if variant in ("reduce", "product"):
        f = tw.fp
        # the GT shape from gt.ones, which registers the constants 1 and 0
        # here, in the reference's order
        facc = np.asarray([f.input(f"f{i}") for i in range(nc)],
                          np.int32).reshape(gt.ones(()).shape)
        facc = _sym_lane_product(tw, gt, facc)
        if variant == "product":
            return asm.build(outputs(facc))
        return asm.build(outputs(fin(ctx, facc)))

    facc = _sym_lane_product(tw, gt, miller(asm, ctx))
    if variant == "miller":
        return asm.build(outputs(facc))
    assert variant == "full"
    return asm.build(outputs(fin(ctx, facc)))


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
    (n, 2, 2, W) E4 coordinates for BLS24, or (n, W) Fp coordinates for
    BW6; infinity is all-zero. Returns the GT element, (2, 3, 2, W),
    (2, 3, 2, 2, W) for BLS24 or (2, 3, W) for BW6.
    """
    if name in _BW6:
        tw = pairing6.get_ctx6(name, P.x.device).tower
        f = e2 = tw.fp   # G2 is over Fp
    else:
        tw = get_ctx(name, P.x.device).tower
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
