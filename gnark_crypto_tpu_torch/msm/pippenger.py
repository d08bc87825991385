"""Multi-scalar multiplication (Pippenger), G1 and G2.

Counterpart of ``gnark_crypto_tpu/msm/pippenger.py`` (reference
``ecc/bn254/multiexp.go``, ``multiexp_affine.go`` for G2), with JAX's
``jit`` and ``scan`` written as eager loops:

* signed base-2^c digits, so 2^(c-1) buckets per window
  (``partitionScalars``, multiexp.go:710);
* ALL windows of a group share one flat array sorted by the key
  window*slots + digit; equal-key runs reduce in a segmented tree whose
  levels are batch-affine (one complete affine add per lane, the
  denominators inverted together, reference ``batchAddG1Affine``
  g1.go:1396): the ``affine_prep`` and ``affine_finish`` kernels around a
  log-depth batch inverse seeded by one ``exp_const`` launch per level;
* below ``BOT_W`` lanes the tree finishes in Jacobian coordinates at
  constant width (``jac_add``); completed runs are emitted densely and
  placed into the bucket array by one argsort and a unique-key scatter;
* the weighted bucket sweep runs once for all windows (``jac_add``,
  ``jac_double``), and the windows fold by Horner in one
  ``jac_fold_windows`` launch (``msmReduceChunkG1Affine``,
  multiexp.go:303).

G1 points are affine ``int32[N, W]`` Montgomery words; scalars plain Fr
words. A G2 curve (``curve/g2.py``: a = 0 over Fp2 with a small-int
non-residue) takes ``int32[N, 2, W]`` points through the same steps on the
Fp2 kernels of ``field/point_add2.py`` (``affine_prep2``,
``affine_finish2``, ``jac_add2``, ``jac_double2``,
``jac_fold_windows2``); its batch inverse goes through the norm, so each
level's 128-lane seed is still one ``exp_const`` launch on Fp.
The sort keys are sorted with ``stable=True``, as ``jnp.argsort`` sorts, so
every step takes the JAX package's lanes in the same order.
"""

from __future__ import annotations

import functools

import torch

from gnark_crypto_tpu_torch.curve.jacobian import (
    Affine, Curve, Jac, curve_ops)
from gnark_crypto_tpu_torch.field import point_add, point_add2
from gnark_crypto_tpu_torch.field.kernels import u32
from gnark_crypto_tpu_torch.specs.curve import CurveSpec

BOT_W = 1 << 12     # tree width where phase 1 (affine) hands to phase 2
MAX_FLAT = 1 << 22  # lanes of one flat accumulate; points per MSM chunk
INV_STOP_W = 128    # _log_batch_inverse hands this width to exp_const


def best_c(n: int) -> int:
    """Window size by input size (reference bestC, multiexp.go:76-96, as
    the JAX package tuned it)."""
    if n <= 1 << 5:
        return 3
    if n <= 1 << 8:
        return 5
    if n <= 1 << 12:
        return 8
    if n <= 1 << 16:
        return 11
    if n <= 1 << 20:
        return 13
    return 16


def n_windows(nbits: int, c: int) -> int:
    """Signed-digit window count. The borrow can spill past the top scalar
    bit only when c divides nbits: a partial top window of r = nbits % c
    bits holds at most 2^r - 1 + 1 <= 2^(c-1), so it never spills."""
    nwin = -(-nbits // c)
    return nwin + 1 if nbits % c == 0 else nwin


def signed_digits(curve: Curve, scalars: torch.Tensor, c: int):
    """Plain Fr words (N, W) -> (mags int32 (nwin, N) in [0, 2^(c-1)],
    negs bool (nwin, N)), the borrow cascade of ``partitionScalars``.

    A c-bit window straddles two 32-bit words and int32 shifts extend the
    sign, so the windows are cut from the words as int64 in [0, 2^32)."""
    nbits = curve.spec.fr.modulus.bit_length()
    nwin = n_windows(nbits, c)
    half, full = 1 << (c - 1), 1 << c
    u = u32(scalars)
    W = u.shape[-1]
    mags, negs = [], []
    carry = None
    for w in range(nwin):
        i, off = divmod(w * c, 32)
        t = u[..., i] >> off if i < W else torch.zeros_like(u[..., 0])
        if off + c > 32 and i + 1 < W:
            t = t | (u[..., i + 1] << (32 - off))
        t = t & (full - 1)
        if carry is not None:
            t = t + carry
        big = t > half
        carry = big.to(torch.int64)
        mags.append(torch.where(big, full - t, t).to(torch.int32))
        negs.append(big)
    return torch.stack(mags), torch.stack(negs)


def _pair_split(x: torch.Tensor):
    """(2k, ...) -> even and odd rows, each copied contiguous: the kernel
    wrappers take contiguous (N, W) tensors (one copy per level)."""
    v = x.reshape(x.shape[0] // 2, 2, *x.shape[1:])
    return v[:, 0].contiguous(), v[:, 1].contiguous()


def _split_affine(p: Affine) -> tuple[Affine, Affine]:
    (xe, xo), (ye, yo) = _pair_split(p.x), _pair_split(p.y)
    return Affine(xe, ye), Affine(xo, yo)


def _log_batch_inverse(f, d: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick batch inversion with log-depth pairwise sweeps.

    Up-sweep products down to ``INV_STOP_W`` lanes, one ``inverse`` of
    those (one ``exp_const`` launch on the card), then the pairwise
    down-sweep: about 3N products in 2 log2(N / 128) rounds. Zero entries
    must be masked to 1 by the caller.

    Over Fp2 the sweeps run on the norms in Fp (e2.go Inverse:
    1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 - nr a1^2)): the inverse is the
    same canonical value as sweeping in Fp2, for 4 full-width base
    products and 3 additions instead of about 3N Fp2 products, each of
    them 3 base products and 5 additions in launches."""
    if getattr(f, "degree", 0) == 2:
        b = f.base
        a0, a1 = f.coeff(d, 0), f.coeff(d, 1)
        ninv = _log_batch_inverse(b, b.sub(b.square(a0),
                                           f.mul_by_nr(b.square(a1))))
        return f.build([b.mul(a0, ninv), b.neg(b.mul(a1, ninv))])
    w = d.shape[0]
    m = 1 << (w - 1).bit_length()
    if m != w:
        d = torch.cat([d, f.ones((m - w,), device=d.device)])
    levels = [d]
    while levels[-1].shape[0] > INV_STOP_W:
        ev, od = _pair_split(levels[-1])
        levels.append(f.mul(ev, od))
    inv = f.inverse(levels[-1])
    for cur in levels[-2::-1]:
        a, b = _pair_split(cur)
        ia = f.mul(inv, b)
        ib = f.mul(inv, a)
        inv = torch.stack([ia, ib], dim=1).reshape(2 * ia.shape[0],
                                                   *ia.shape[1:])
    return inv[:w]


def _emitted_to_buckets(buckets: Jac, keys: list, pts: list,
                        sentinel: int) -> None:
    """buckets[k] = pt for every emitted key k < sentinel, in place. One
    argsort over the dense emissions keeps the (at most sentinel + 1)
    smallest keys; every valid key is unique and below sentinel, and the
    rest land in the junk row ``sentinel``."""
    ekeys = torch.cat(keys)
    K = min(sentinel + 1, ekeys.shape[0])
    top = torch.argsort(ekeys, stable=True)[:K]
    k_top = ekeys[top]
    idx = torch.where(k_top < sentinel, k_top, sentinel)
    for bc, pc in zip(buckets, zip(*pts)):
        bc[idx] = torch.cat(pc)[top]


def _sorted_lanes(curve: Curve, points: Affine, mag, neg, c: int):
    """Flatten the G windows of a group into one array sorted by the key
    window*slots + digit (so runs never merge across windows), padded to a
    multiple of 2^L lanes, L the phase-1 level count, not to a power of two:
    every phase-1 level needs only an even width.

    Returns the sorted keys (m,) and the signed points (m, *tail), infinity
    on digit-0 and padding lanes (key % slots == 0 covers both)."""
    f = curve.fp
    tail = curve.elem_tail
    E = points.x[0].numel()
    dev = mag.device
    G, n = mag.shape
    slots = (1 << (c - 1)) + 1
    keys = (mag.to(torch.int64)
            + (torch.arange(G, device=dev) * slots)[:, None]).reshape(G * n)
    negf = neg.reshape(G * n)
    W0 = G * n
    L = max(0, (W0 - 1).bit_length() - BOT_W.bit_length() + 1)
    m = -(-W0 // (1 << L)) << L
    if m != W0:
        keys = torch.cat([keys, keys.new_full((m - W0,), G * slots)])
        negf = torch.cat([negf, negf.new_zeros((m - W0,))])

    order = torch.argsort(keys, stable=True)
    key_s = keys[order]
    # one gather of both coordinates, packed side by side
    pk = torch.cat([points.x.reshape(n, E), points.y.reshape(n, E)],
                   dim=1).index_select(0, order % n)
    px, py = pk[:, :E].reshape(m, *tail), pk[:, E:].reshape(m, *tail)
    py = f.where(negf[order], f.neg(py), py)
    digit0 = (key_s % slots) == 0
    return key_s, Affine(f.where(digit0, 0, px), f.where(digit0, 0, py))


def _affine_levels(curve: Curve, pts: Affine, keys, sentinel: int):
    """Phase 1: halve the tree with batch-affine levels while it is wider
    than ``BOT_W``. A node carries the partial sums of its leftmost (pre)
    and rightmost (suf) digit runs; merging two nodes adds l_suf + r_pre
    once per lane and completes the runs that end inside the new node.

    Returns the nodes (pre, suf, pre_d, suf_d, single) and the completed
    runs, emitted densely as keys (sentinel where nothing completes or the
    sum is infinity) and Jacobian points."""
    f = curve.fp
    prep, finish = _level_kernels(curve)
    e_keys, e_pts = [], []
    one = f.ones((1,), device=keys.device)

    def emit(valid, d, pt: Affine, is_inf):
        k = torch.where(valid & ~is_inf, d, sentinel)
        e_keys.append(k)
        e_pts.append(Jac(pt.x, pt.y, f.where(k < sentinel, one, 0)))

    pre = suf = pts
    pre_d = suf_d = keys
    single = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    while pre.x.shape[0] > BOT_W:
        l_pre, r_pre = _split_affine(pre)
        # level 0 has pre == suf: split once
        l_suf, r_suf = (l_pre, r_pre) if suf is pre else _split_affine(suf)
        l_pre_d, r_pre_d = _pair_split(pre_d)
        l_suf_d, r_suf_d = _pair_split(suf_d)
        l_single, r_single = _pair_split(single)

        eq = l_suf_d == r_pre_d
        emit_a = ~l_single & (~eq | ~r_single)
        emit_b = ~eq & ~r_single
        den, num, mbits = prep(*l_suf, *r_pre)
        dinv = _log_batch_inverse(f, den)
        tb = (eq.to(torch.int32) + (l_single.to(torch.int32) << 1)
              + (r_single.to(torch.int32) << 2))
        prex, prey, sufx, sufy, pax, pay, za = finish(
            *l_pre, *l_suf, *r_pre, *r_suf, num, dinv, mbits, tb)
        emit(emit_a, l_suf_d, Affine(pax, pay), f.is_zero(za))
        emit(emit_b, r_pre_d, r_pre, curve.is_inf_affine(r_pre))
        pre, suf = Affine(prex, prey), Affine(sufx, sufy)
        pre_d, suf_d = l_pre_d, r_suf_d
        single = l_single & r_single & eq
    return (pre, suf, pre_d, suf_d, single), e_keys, e_pts


def _jacobian_levels(curve: Curve, nodes, sentinel: int):
    """Phase 2: the remaining levels at constant width in Jacobian
    coordinates (``jac_add``), padded to 2^k lanes. Node i of size 2^(j+1)
    keeps its data at slot i; step j merges slot i (i % 2^(j+1) == 0) with
    slot i + 2^j. Returns the emitted keys and points, as phase 1 does,
    the root's runs included."""
    f = curve.fp
    sel = curve._select
    pre, suf, pre_d, suf_d, single = nodes
    dev = pre_d.device
    B0 = pre.x.shape[0]
    B = 1 << (B0 - 1).bit_length()
    if B != B0:
        pad = B - B0
        zpad = f.zeros((pad,), device=dev)
        pre = Affine(*(torch.cat([t, zpad]) for t in pre))
        suf = Affine(*(torch.cat([t, zpad]) for t in suf))
        dpad = pre_d.new_full((pad,), sentinel)
        pre_d = torch.cat([pre_d, dpad])
        suf_d = torch.cat([suf_d, dpad])
        single = torch.cat([single, single.new_ones((pad,))])
    preJ = curve.from_affine(pre)
    sufJ = curve.from_affine(suf)
    iota = torch.arange(B, device=dev)
    j_keys, j_pts = [], []
    for j in range(B.bit_length() - 1):
        s = 1 << j

        def rl(t):               # slot i <- old slot i + s
            return torch.roll(t, -s, dims=0)

        r_pre, r_suf = Jac(*map(rl, preJ)), Jac(*map(rl, sufJ))
        r_pre_d, r_suf_d, r_single = rl(pre_d), rl(suf_d), rl(single)
        aligned = (iota & (2 * s - 1)) == 0

        mid = curve.add(sufJ, r_pre)
        eq = suf_d == r_pre_d
        emit_a = aligned & ~single & (~eq | ~r_single)
        j_keys.append(torch.where(emit_a, suf_d, sentinel))
        j_pts.append(sel(eq, mid, sufJ))
        emit_b = aligned & ~eq & ~r_single
        j_keys.append(torch.where(emit_b, r_pre_d, sentinel))
        j_pts.append(r_pre)

        preJ = sel(aligned, sel(single & eq, mid, preJ), preJ)
        sufJ = sel(aligned, sel(r_single & eq, mid, r_suf), sufJ)
        suf_d = torch.where(aligned, r_suf_d, suf_d)
        single = torch.where(aligned, single & r_single & eq, single)

    first = iota == 0
    j_keys += [torch.where(first, pre_d, sentinel),
               torch.where(first & ~single, suf_d, sentinel)]
    j_pts += [preJ, sufJ]
    return j_keys, j_pts


def _bucket_accumulate_affine(curve: Curve, points: Affine, mag, neg,
                              c: int) -> Jac:
    """Window group -> Jacobian buckets (G, slots, *tail); slot 0 of each
    window holds digit-0 junk and is never swept.

    mag/neg: (G, N). :func:`_sorted_lanes`, then phase 1
    (:func:`_affine_levels`: ``affine_prep``, ``_log_batch_inverse``,
    ``affine_finish`` per level) and phase 2 (:func:`_jacobian_levels`:
    ``jac_add``). Every digit run completes exactly once, so its key is
    unique among the emissions, and each phase's emissions go into the
    bucket array by one argsort and one scatter."""
    G = mag.shape[0]
    slots = (1 << (c - 1)) + 1
    sentinel = G * slots
    keys, pts = _sorted_lanes(curve, points, mag, neg, c)
    nodes, e_keys, e_pts = _affine_levels(curve, pts, keys, sentinel)
    buckets = Jac(*(t.clone() for t in curve.inf_jac((sentinel + 1,),
                                                     device=mag.device)))
    if e_keys:
        _emitted_to_buckets(buckets, e_keys, e_pts, sentinel)
    j_keys, j_pts = _jacobian_levels(curve, nodes, sentinel)
    _emitted_to_buckets(buckets, j_keys, j_pts, sentinel)
    return Jac(*(bc[:sentinel].reshape(G, slots, *curve.elem_tail)
                 for bc in buckets))


def _strided_scan_add(curve: Curve, p: Jac, S: int, suffix: bool) -> Jac:
    """Log-depth strided reductions on a flat (nwin*S,) point batch.

    suffix=False: in-window pairwise tree sum (the window total lands at
    each window's slot 0); suffix=True: in-window Hillis-Steele inclusive
    suffix sums (out[k] = sum_{j >= k} p[j])."""
    n = p.x.shape[0]
    iota = torch.arange(n, device=p.x.device)
    for j in range((S - 1).bit_length()):
        s = 1 << j
        added = curve.add(p, Jac(*(torch.roll(t, -s, dims=0) for t in p)))
        valid = (iota % S) + s < S
        if not suffix:
            valid &= (iota & (2 * s - 1)) == 0
        p = curve._select(valid, added, p)
    return p


def _weighted_sweep(curve: Curve, buckets: Jac, c: int,
                    n_chunks: int = 128) -> Jac:
    """Buckets (nwin, half+1) -> window totals sum_j j*B_j (nwin,).

    Each window's buckets split into S chunks of m = half/S; the running
    sweep (S += B_j; T += S) runs on all nwin*S chunks together for m
    steps, giving local weighted sums T_k and chunk sums C_k, and
        sum_j j*B_j = sum_k T_k + m * sum_{k>=1} suffix_k(C),
    with log-depth strided tree and suffix sums and log2(m) doublings."""
    tail = curve.elem_tail
    half = 1 << (c - 1)
    nwin = buckets.x.shape[0]
    S = min(half, n_chunks)
    m = half // S
    dev = buckets.x.device

    # (nwin, half) buckets j = 1..half -> (m, nwin*S) in scan order i = m..1
    rev = Jac(*(t[:, 1:].reshape(nwin * S, m, *tail).flip(1)
                .transpose(0, 1).contiguous() for t in buckets))
    s = t = curve.inf_jac((nwin * S,), device=dev)
    for i in range(m):
        s = curve.add(s, Jac(*(r[i] for r in rev)))
        t = curve.add(t, s)

    def window_slot0(p):
        return Jac(*(a.reshape(nwin, S, *tail)[:, 0] for a in p))

    sum_t = window_slot0(_strided_scan_add(curve, t, S, suffix=False))
    if S == 1:
        return sum_t
    suf = _strided_scan_add(curve, s, S, suffix=True)
    k0 = (torch.arange(nwin * S, device=dev) % S) == 0
    suf = curve._select(k0, curve.inf_jac((nwin * S,), device=dev), suf)
    w = window_slot0(_strided_scan_add(curve, suf, S, suffix=False))
    for _ in range(m.bit_length() - 1):  # * m (a power of two)
        w = curve.double(w)
    return curve.add(sum_t, w)


def _window_totals(curve: Curve, points: Affine, mags, negs, c: int) -> Jac:
    """(nwin, N) digits -> per-window totals (nwin,). Windows go in
    groups of G so that a flat accumulate stays within ``MAX_FLAT`` lanes;
    the last group is padded with zero digits, as the JAX package pads
    it."""
    nwin, n = mags.shape
    G = max(1, min(nwin, MAX_FLAT // max(n, 1)))
    bks = []
    for g0 in range(0, nwin, G):
        mg, ng = mags[g0:g0 + G], negs[g0:g0 + G]
        if mg.shape[0] < G:
            pad = G - mg.shape[0]
            mg = torch.cat([mg, mg.new_zeros((pad, n))])
            ng = torch.cat([ng, ng.new_zeros((pad, n))])
        bks.append(_bucket_accumulate_affine(curve, points, mg, ng, c))
    buckets = Jac(*(torch.cat(comp)[:nwin] for comp in zip(*bks)))
    return _weighted_sweep(curve, buckets, c)


def _fold_windows(curve: Curve, totals: Jac, c: int) -> Jac:
    """Horner fold acc = sum_w 2^(cw) T_w, one ``jac_fold_windows`` (or
    ``jac_fold_windows2`` over Fp2)."""
    coords = (t.contiguous() for t in totals)
    if curve._kernels2:
        ox, oy, oz = point_add2.jac_fold_windows2(
            curve.spec.fp, curve.fp.nr, *coords, c)
    else:
        ox, oy, oz = point_add.jac_fold_windows(
            curve.spec.fp, curve.spec.a, *coords, c)
    return Jac(ox[0], oy[0], oz[0])


def _level_kernels(curve: Curve):
    """The (prep, finish) tree-level wrappers for the curve's field, with
    their curve arguments bound (``_affine_levels``)."""
    if curve._kernels2:
        return (functools.partial(point_add2.affine_prep2, curve.spec.fp,
                                  curve.fp.nr),
                functools.partial(point_add2.affine_finish2, curve.spec.fp,
                                  curve.fp.nr))
    return (functools.partial(point_add.affine_prep, curve.spec.fp,
                              curve.spec.a),
            functools.partial(point_add.affine_finish, curve.spec.fp,
                              curve.spec.a))


def _resolve(spec_or_curve) -> Curve:
    """A CurveSpec (G1) or a built Curve (G2 needs its tower engine, which
    a bare spec cannot rebuild). Curves the MSM's kernels do not take
    (over other extensions) raise."""
    curve = (spec_or_curve if isinstance(spec_or_curve, Curve)
             else curve_ops(spec_or_curve))
    if curve.elem_tail is None:
        raise NotImplementedError(
            f"{curve.spec.name}: the MSM takes curves over a prime field or "
            "over Fp2 with a small-int non-residue")
    return curve


def _msm_chunk(curve: Curve, points: Affine, scalars, c: int) -> Jac:
    mags, negs = signed_digits(curve, scalars, c)
    return _fold_windows(curve, _window_totals(curve, points, mags, negs, c),
                         c)


def msm(spec: CurveSpec, points: Affine, scalars: torch.Tensor,
        c: int | None = None) -> Jac:
    """MultiExp: sum_i scalars[i] * points[i] (reference multiexp.go:21).

    spec: a G1 CurveSpec or a Curve (``g2_curve`` for G2). points: affine
    (N, *tail) batch; scalars: plain Fr words (N, W). Returns one Jacobian
    point (coordinates (*tail,)). Inputs longer than ``MAX_FLAT``
    run in chunks of that many points whose sums are added (the
    reference's data split, multiexp.go:129-141, here bounding peak device
    memory); c is chosen from the whole input."""
    curve = _resolve(spec)
    n = points.x.shape[0]
    if scalars.shape[0] != n:
        raise ValueError("msm: len(points) != len(scalars)")
    c = c or best_c(n)
    acc = None
    for s in range(0, n, MAX_FLAT):
        e = min(n, s + MAX_FLAT)
        part = _msm_chunk(curve, Affine(points.x[s:e], points.y[s:e]),
                          scalars[s:e], c)
        acc = part if acc is None else curve.add(acc, part)
    return acc


def _bsm_table(curve: Curve, bx, by, c: int) -> Jac:
    """Signed-digit base table [inf, B, 2B, .., half*B] by doubling its
    length: T_2S = T_S ++ (T_S + [S]B), log2(half) batched adds."""
    half = 1 << (c - 1)
    tail = curve.elem_tail
    b1 = Jac(bx.reshape(1, *tail), by.reshape(1, *tail),
             curve.fp.ones((1,), device=bx.device))
    table = Jac(*(torch.cat(comp) for comp in
                  zip(curve.inf_jac((1,), device=bx.device), b1)))
    sb = b1                                    # [S]B for the current size
    while table.x.shape[0] < half:
        S = table.x.shape[0]
        sb = curve.add(sb, sb) if S > 2 else curve.add(b1, b1)
        shifted = curve.add(table, Jac(*(t.expand(S, *tail) for t in sb)))
        # entry 0 is infinity: shifted[0] = [S]B (complete add)
        table = Jac(*(torch.cat([t, u]) for t, u in zip(table, shifted)))
    top = curve.add(sb, sb) if half > 1 else b1     # [half]B
    return Jac(*(torch.cat([t, u]) for t, u in zip(table, top)))


def _bsm_scan(curve: Curve, c: int, table: Jac, scalars) -> Jac:
    """Windowed one-base ladder over the table, MSB window first: c
    doublings, then one add of the signed table entry per window."""
    f = curve.fp
    mags, negs = signed_digits(curve, scalars, c)
    acc = curve.inf_jac((scalars.shape[0],), device=scalars.device)
    for w in range(mags.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = curve.double(acc)
        t = Jac(*(comp.index_select(0, mags[w]) for comp in table))
        t = Jac(t.x, f.where(negs[w], f.neg(t.y), t.y), t.z)
        acc = curve.add(acc, t)
    return acc


def batch_scalar_mul(spec: CurveSpec, base: Affine, scalars: torch.Tensor,
                     c: int | None = None) -> Jac:
    """[k_i]B for one shared base B (g1.go:1316
    BatchScalarMultiplicationG1, used by KZG SRS generation): one
    signed-digit window table shared by every lane, then nbits doublings
    and nbits/c table adds per lane.

    base: one affine point (coordinates (*tail,) or (1, *tail)); scalars:
    plain Fr words (N, W). Returns Jac (N, *tail)."""
    curve = _resolve(spec)
    n = scalars.shape[0]
    c = c or max(2, min(10, best_c(n)))
    table = _bsm_table(curve, base.x, base.y, c)
    return _bsm_scan(curve, c, table, scalars)


def fold(spec: CurveSpec, points: Affine, coeff: int,
         c: int | None = None) -> Jac:
    """sum_i coeff^i * points[i] (reference Fold, multiexp.go:321)."""
    curve = _resolve(spec)
    r = curve.spec.fr.modulus
    ks, acc = [], 1
    for _ in range(points.x.shape[0]):
        ks.append(acc)
        acc = acc * coeff % r
    return msm(spec, points, curve.fr.from_int(ks, mont=False,
                                               device=points.x.device), c=c)


def msm_naive(spec: CurveSpec, points: Affine, scalars: torch.Tensor) -> Jac:
    """Oracle: per-point scalar_mul, then adds in order (for tests)."""
    curve = _resolve(spec)
    prods = curve.scalar_mul(curve.from_affine(points), scalars)
    acc = Jac(*(t[0] for t in prods))
    for i in range(1, points.x.shape[0]):
        acc = curve.add(acc, Jac(*(t[i] for t in prods)))
    return acc
