"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports nothing of JAX, so it also runs on
a machine without it:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

The tolerance is exact equality: both versions return canonical residues.
"""

import random

import numpy as np
import pytest
import torch

from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.field import api, exp, kernels, point_add
from gnark_crypto_tpu_torch.field import mont, vm
from gnark_crypto_tpu_torch.io import gt_bytes
from gnark_crypto_tpu_torch.pairing import api as pairing_api
from gnark_crypto_tpu_torch.msm import pippenger
from gnark_crypto_tpu_torch.hashes.sis import RSis
from gnark_crypto_tpu_torch.ntt import fft, four_step, radix2, radix2_f31
from gnark_crypto_tpu_torch.ntt import radix2_f64
from gnark_crypto_tpu_torch.ntt.domain import Domain
from gnark_crypto_tpu_torch.specs import curve as cs
from gnark_crypto_tpu_torch.specs import field as fs

SPEC = fs.BN254_FR
Q = SPEC.modulus
PAIRS = [("DIF", False), ("DIF", True), ("DIT", False), ("DIT", True)]


def rand_vals(n, seed):
    rng = random.Random(seed)
    return ([0, 1, Q - 1] + [rng.randrange(Q) for _ in range(n)])[:n]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mont_mul_kernel_matches_plain(cuda):
    a, b = rand_vals(4099, 7), rand_vals(4099, 8)[::-1]
    x, y = (mont.from_int(SPEC, v, device=cuda) for v in (a, b))
    before = kernels.mont_mul.launches
    got = kernels.mont_mul(SPEC, x, y)
    assert kernels.mont_mul.launches == before + 1
    assert torch.equal(got, kernels.mont_mul_plain(SPEC, x, y))
    assert mont.to_int(SPEC, got[:64]) == [u * v % Q
                                           for u, v in zip(a[:64], b[:64])]


@pytest.mark.cuda
def test_mont_mul_rejects_bad_input(cuda):
    x = mont.from_int(SPEC, [1, 2, 3, 4], device=cuda)
    with pytest.raises(ValueError):
        kernels.mont_mul(SPEC, x, x.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.mont_mul(SPEC, x[::2], x[::2])
    # 12-word rows for an 8-word field
    y = mont.from_int(fs.BLS12_381_FP, [1, 2, 3, 4], device=cuda)
    with pytest.raises(ValueError):
        kernels.mont_mul(SPEC, y, y)


# the 256-bit 8-word fields (2^255 <= q < 2^256): secp256k1/r1 Fp and Fr
FULL = [fs.SECP256K1_FP, fs.SECP256K1_FR, fs.SECP256R1_FP, fs.SECP256R1_FR]


def full_edges(q):
    """0, 1, 2, q-1, q-2, q-3, (q-1)/2, (q+1)/2, 2^255, 2^255 - 1 and
    2^256 - 1 reduced mod q, and q - 2^32."""
    return [0, 1, 2, q - 1, q - 2, q - 3, (q - 1) // 2, (q + 1) // 2,
            (1 << 255) % q, ((1 << 255) - 1) % q, ((1 << 256) - 1) % q,
            q - (1 << 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", FULL, ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain_full_width(cuda, spec):
    """Every pair of the edge operands and random ones over 4,096 lanes:
    the kernel equals the plain version and Python integers, counted under
    the "8full" width."""
    q = spec.modulus
    edge = full_edges(q)
    rng = random.Random(spec.name)
    a = [u for u in edge for _ in edge] + [rng.randrange(q)
                                           for _ in range(3952)]
    b = [v for _ in edge for v in edge] + [rng.randrange(q)
                                           for _ in range(3952)]
    x = mont.from_int(spec, a, device=cuda)
    y = mont.from_int(spec, b, device=cuda)
    by_width = kernels.mont_mul.launches_by_width
    before = (by_width.get("8full", 0), by_width.get(8, 0))
    got = kernels.mont_mul(spec, x, y)
    assert (by_width["8full"], by_width.get(8, 0)) == (before[0] + 1,
                                                       before[1])
    assert torch.equal(got, kernels.mont_mul_plain(spec, x, y))
    assert mont.to_int(spec, got) == [u * v % q for u, v in zip(a, b)]


# the 12-word fields of the kernels built at 8, 10 and 12 words
W12 = [fs.BLS12_381_FP, fs.BLS12_377_FP, fs.BW6_761_FR]
# and their 10-word fields (bw6-633 Fr is bls24-315 Fp)
W10 = [fs.BLS24_315_FP, fs.BLS24_317_FP, fs.BW6_633_FR]
# and their 20- and 24-word fields (bw6-633 Fp, bw6-761 Fp)
W20_24 = [fs.BW6_633_FP, fs.BW6_761_FP]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W12, ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain_12_words(cuda, spec):
    q = spec.modulus
    rng = random.Random(12)
    a = [0, 1, q - 1] + [rng.randrange(q) for _ in range(4096)]
    b = [q - 1, 0, 1] + [rng.randrange(q) for _ in range(4096)]
    x, y = (mont.from_int(spec, v, device=cuda) for v in (a, b))
    by_width = dict(kernels.mont_mul.launches_by_width)
    got = kernels.mont_mul(spec, x, y)
    assert kernels.mont_mul.launches_by_width[12] == by_width.get(12, 0) + 1
    assert kernels.mont_mul.launches_by_width.get(8) == by_width.get(8)
    assert torch.equal(got, kernels.mont_mul_plain(spec, x, y))
    assert mont.to_int(spec, got[:64]) == [u * v % q
                                           for u, v in zip(a[:64], b[:64])]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W12, ids=lambda s: s.name)
def test_exp_const_kernel_matches_plain_12_words(cuda, spec):
    q = spec.modulus
    rng = random.Random(13)
    vals = [0, 1, q - 1] + [rng.randrange(q) for _ in range(200)]
    x = mont.from_int(spec, vals, device=cuda)
    for e in (q - 2, 3, (q - 1) // 2, 0, 1 << 400):
        before = exp.exp_const.launches_by_width.get(12, 0)
        got = exp.exp_const(spec, x, e)
        assert exp.exp_const.launches_by_width[12] == before + 1
        assert torch.equal(got, exp.exp_const_plain(spec, x, e))
    assert mont.to_int(spec, mont.inverse(spec, x[:8])) == [
        pow(v, q - 2, q) for v in vals[:8]]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W10, ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain_10_words(cuda, spec):
    """At 10 words every second row is only 8-byte aligned: odd lengths and
    a slice from an odd row take the kernel's 8-byte loads."""
    q = spec.modulus
    rng = random.Random(10)
    a = [0, 1, q - 1, (q - 1) // 2] + [rng.randrange(q) for _ in range(4097)]
    b = [q - 1, 0, 1, (q + 1) // 2] + [rng.randrange(q) for _ in range(4097)]
    x, y = (mont.from_int(spec, v, device=cuda) for v in (a, b))
    by_width = dict(kernels.mont_mul.launches_by_width)
    got = kernels.mont_mul(spec, x, y)
    assert kernels.mont_mul.launches_by_width[10] == by_width.get(10, 0) + 1
    assert kernels.mont_mul.launches_by_width.get(12) == by_width.get(12)
    assert torch.equal(got, kernels.mont_mul_plain(spec, x, y))
    assert x[1:].data_ptr() % 16 == 8
    assert torch.equal(kernels.mont_mul(spec, x[1:], y[1:]), got[1:])
    assert mont.to_int(spec, got[:64]) == [u * v % q
                                           for u, v in zip(a[:64], b[:64])]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W10, ids=lambda s: s.name)
def test_exp_const_kernel_matches_plain_10_words(cuda, spec):
    q = spec.modulus
    rng = random.Random(14)
    vals = [0, 1, q - 1] + [rng.randrange(q) for _ in range(200)]
    x = mont.from_int(spec, vals, device=cuda)
    for e in (q - 2, 3, (q - 1) // 2, 0, 1 << 400):
        before = exp.exp_const.launches_by_width.get(10, 0)
        got = exp.exp_const(spec, x, e)
        assert exp.exp_const.launches_by_width[10] == before + 1
        assert torch.equal(got, exp.exp_const_plain(spec, x, e))
    assert mont.to_int(spec, mont.inverse(spec, x[:8])) == [
        pow(v, q - 2, q) for v in vals[:8]]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W20_24, ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain_20_24_words(cuda, spec):
    """The rolled CIOS of the 20- and 24-word products (80- and 96-byte
    rows, 16-byte loads), odd lengths and a slice from row 1."""
    q, W = spec.modulus, spec.n_words
    rng = random.Random(W)
    a = [0, 1, q - 1, (q - 1) // 2] + [rng.randrange(q) for _ in range(4097)]
    b = [q - 1, 0, 1, (q + 1) // 2] + [rng.randrange(q) for _ in range(4097)]
    x, y = (mont.from_int(spec, v, device=cuda) for v in (a, b))
    by_width = dict(kernels.mont_mul.launches_by_width)
    got = kernels.mont_mul(spec, x, y)
    assert kernels.mont_mul.launches_by_width[W] == by_width.get(W, 0) + 1
    assert kernels.mont_mul.launches_by_width.get(12) == by_width.get(12)
    assert torch.equal(got, kernels.mont_mul_plain(spec, x, y))
    assert torch.equal(kernels.mont_mul(spec, x[1:], y[1:]), got[1:])
    assert mont.to_int(spec, got[:64]) == [u * v % q
                                           for u, v in zip(a[:64], b[:64])]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W20_24, ids=lambda s: s.name)
def test_exp_const_kernel_matches_plain_20_24_words(cuda, spec):
    """A team of 4 lanes an element, 5 or 6 words a lane."""
    q, W = spec.modulus, spec.n_words
    rng = random.Random(W + 1)
    vals = [0, 1, q - 1] + [rng.randrange(q) for _ in range(200)]
    x = mont.from_int(spec, vals, device=cuda)
    for e in (q - 2, 3, (q - 1) // 2, 0, 1 << 800):
        before = exp.exp_const.launches_by_width.get(W, 0)
        got = exp.exp_const(spec, x, e)
        assert exp.exp_const.launches_by_width[W] == before + 1
        assert torch.equal(got, exp.exp_const_plain(spec, x, e))
    assert mont.to_int(spec, mont.inverse(spec, x[:8])) == [
        pow(v, q - 2, q) for v in vals[:8]]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 12, 14, 15])
def test_ntt_kernels_match_plain(cuda, k):
    n = 1 << k
    dom = Domain(SPEC, n, device=cuda)
    cpu_dom = Domain(SPEC, n, device="cpu") if k <= 12 else None
    a = mont.from_int(SPEC, rand_vals(n, k), device=cuda)
    for dec, inverse in PAIRS:
        f = fft.fft_inverse if inverse else fft.fft
        for coset in (False, True):
            got = f(dom, a, dec, coset)
            if cpu_dom is not None:  # the CPU path takes the same steps
                assert torch.equal(got.cpu(), f(cpu_dom, a.cpu(), dec, coset))
        want = radix2.run_plain(dom, a, dec, inverse)
        if inverse and four_step.supported(dom, dec, inverse):
            # the four-step inverse folds 1/n into its twist table
            want = mont.mul(SPEC, want, dom.cardinality_inv)
        assert torch.equal(fft._run(dom, a, dec, inverse)[0], want)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject(cuda):
    dom = Domain(SPEC, 1 << 14, with_coset=False, device=cuda)
    a = mont.from_int(SPEC, rand_vals(1 << 14, 3), device=cuda)
    wrappers = (radix2.stage, radix2.block, four_step.sub_ntt)
    before = [w.launches for w in wrappers]
    fft.fft(dom, a, "DIT")      # radix-2: 4 wide stages + 1 fused tail
    fft.fft(dom, a, "DIF")      # four-step: 2 sub-NTT steps
    assert [w.launches - b for w, b in zip(wrappers, before)] == [4, 1, 2]
    with pytest.raises(ValueError):
        radix2.stage(SPEC, a[::2], dom.twiddles0, 13, 0, False)
    with pytest.raises(ValueError):
        radix2.block(SPEC, a, dom.twiddles0, 0, 11, False)
    _, _, tw1, _, _ = four_step.tables(dom, False)
    with pytest.raises(ValueError):
        four_step.sub_ntt(SPEC, a, tw1, 13, 2, True, False)


# the NTT fields at 10 and 12 words: bw6-633 Fr and bw6-761 Fr
NTT_WIDE = [fs.BW6_633_FR, fs.BW6_761_FR]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 12, 14, 15])
@pytest.mark.parametrize("spec", NTT_WIDE, ids=lambda s: s.name)
def test_ntt_kernels_match_plain_10_12_words(cuda, spec, k):
    """Every (decimation, direction, coset) form at 10 and 12 words: the
    card's steps equal the CPU's (the plain versions) up to 2^12, and the
    kernels' transform equals the plain radix-2 stages."""
    n = 1 << k
    q = spec.modulus
    dom = Domain(spec, n, device=cuda)
    cpu_dom = Domain(spec, n, device="cpu") if k <= 12 else None
    rng = random.Random(k)
    a = mont.from_int(spec, ([0, 1, q - 1] + [rng.randrange(q)
                                              for _ in range(n)])[:n],
                      device=cuda)
    W = spec.n_words
    wrappers = (radix2.stage, radix2.block, four_step.sub_ntt)
    before = [w.launches_by_width.get(W, 0) for w in wrappers]
    for dec, inverse in PAIRS:
        f = fft.fft_inverse if inverse else fft.fft
        for coset in (False, True):
            got = f(dom, a, dec, coset)
            if cpu_dom is not None:
                assert torch.equal(got.cpu(), f(cpu_dom, a.cpu(), dec, coset))
        want = radix2.run_plain(dom, a, dec, inverse)
        if inverse and four_step.supported(dom, dec, inverse):
            want = mont.mul(spec, want, dom.cardinality_inv)
        assert torch.equal(fft._run(dom, a, dec, inverse)[0], want)
    after = [w.launches_by_width.get(W, 0) for w in wrappers]
    assert after[1] > before[1]  # every size runs a fused block
    if k >= four_step.MIN_LOG:
        assert after[2] > before[2]
    if k > radix2.TILE_LOG:
        assert after[0] > before[0]


@pytest.mark.cuda
@pytest.mark.parametrize("columns", [True, False])
@pytest.mark.parametrize("dit", [False, True])
@pytest.mark.parametrize("spec", NTT_WIDE, ids=lambda s: s.name)
def test_sub_ntt_2e12_tile_matches_plain_10_12_words(cuda, spec, dit,
                                                     columns):
    """The largest shared-memory tile: 2^12-element sub-NTTs (160 KB at 10
    words, 192 KB at 12), with a twist, over the rows or the columns of a
    2^14-element array."""
    q = spec.modulus
    rng = random.Random(12 + spec.n_words)
    n, log_s = 1 << 14, 12
    other = n >> log_s
    a = mont.from_int(spec, [rng.randrange(q) for _ in range(n)],
                      device=cuda)
    twist = mont.from_int(spec, [rng.randrange(q) for _ in range(n)],
                          device=cuda)
    tw = Domain(spec, 1 << log_s, with_coset=False, device=cuda).twiddles0
    for tws in (None, twist):
        args = (spec, a, tw, log_s, other, columns, dit, tws)
        assert torch.equal(four_step.sub_ntt(*args),
                           four_step.sub_ntt_plain(*args))


# -- exp_const and the point kernels -----------------------------------------

# a = 0 and a = 1 at 8 words; the bls24 G1 curves at 10, the bls12 at 12,
# bw6-633 G1 and G2 at 20 and bw6-761 G1 and G2 at 24 (bw6's G2 is over Fp);
# secp256k1 (a = 0) and secp256r1 (a = -3) on the 256-bit 8-word Fp
CURVES = ["bn254_g1", "stark_g1", "bls24_315_g1", "bls24_317_g1",
          "bls12_381_g1", "bls12_377_g1", "bw6_633_g1", "bw6_633_g2",
          "bw6_761_g1", "bw6_761_g2", "secp256k1_g1", "secp256r1_g1"]


def oracle_add(P, Q, p, a):
    """Affine group law with Python ints; None is infinity."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def oracle_mul(P, k, p, a):
    acc = None
    while k:
        if k & 1:
            acc = oracle_add(acc, P, p, a)
        P = oracle_add(P, P, p, a)
        k >>= 1
    return acc


def edge_batches(curve, n, seed, device):
    """Two (n,) Jacobian batches: random multiples of G with P + P,
    P + (-P), P + inf, inf + Q and inf + inf lanes mixed in."""
    p, a = curve.spec.fp.modulus, curve.spec.a % curve.spec.fp.modulus
    g = (curve.spec.gx % p, curve.spec.gy % p)
    rng = random.Random(seed)
    base = [oracle_mul(g, rng.randrange(1, 1 << 20), p, a) for _ in range(32)]
    neg = [(x, -y % p) for x, y in base]
    ps, qs = [], []
    for i in range(n):
        u = rng.choice(base)
        kind = i % 8
        v = {0: u, 1: neg[base.index(u)], 2: None}.get(kind, rng.choice(base))
        if kind == 3:
            u = None
        if kind == 4:
            u = v = None
        ps.append(u)
        qs.append(v)

    def batch(pts):
        f = curve.fp
        aff = Affine(f.from_int([0 if t is None else t[0] for t in pts],
                                device=device),
                     f.from_int([0 if t is None else t[1] for t in pts],
                                device=device))
        return curve.from_affine(aff)

    return batch(ps), batch(qs), ps, qs


def aff_ints(curve, pt):
    aff = curve.to_affine(Jac(*(c.reshape(-1, c.shape[-1]) for c in pt)))
    xs, ys = (mont.to_int(curve.spec.fp, c) for c in aff)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


@pytest.mark.cuda
def test_exp_const_kernel_matches_plain(cuda):
    x = mont.from_int(SPEC, rand_vals(300, 5), device=cuda)
    for e in (Q - 2, 3, (Q - 1) // 2, 0, 1 << 300):
        before = exp.exp_const.launches
        got = exp.exp_const(SPEC, x, e)
        assert exp.exp_const.launches == before + 1
        assert torch.equal(got, exp.exp_const_plain(SPEC, x, e))
    assert mont.to_int(SPEC, mont.inverse(SPEC, x[:8])) == [
        pow(v, Q - 2, Q) for v in rand_vals(8, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CURVES)
def test_jac_add_double_kernels_match_plain(cuda, name):
    curve = curve_ops(cs.get_curve(name))
    fp, a = curve.spec.fp, curve.spec.a
    P, Qb, ps, qs = edge_batches(curve, 1027, 1, cuda)
    before = (point_add.jac_add.launches, point_add.jac_double.launches)
    got = point_add.jac_add(fp, a, *P, *Qb)
    dbl = point_add.jac_double(fp, a, *P)
    assert (point_add.jac_add.launches, point_add.jac_double.launches) == (
        before[0] + 1, before[1] + 1)
    for k, w in zip(got, point_add.jac_add_plain(fp, a, *P, *Qb)):
        assert torch.equal(k, w)
    for k, w in zip(dbl, point_add.jac_double_plain(fp, a, *P)):
        assert torch.equal(k, w)
    p_mod, a_mod = fp.modulus, a % fp.modulus
    assert aff_ints(curve, Jac(*(c[:64] for c in got))) == [
        oracle_add(u, v, p_mod, a_mod) for u, v in zip(ps[:64], qs[:64])]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CURVES)
def test_affine_level_kernels_match_plain(cuda, name):
    curve = curve_ops(cs.get_curve(name))
    fp, a = curve.spec.fp, curve.spec.a
    P, Qb, _, _ = edge_batches(curve, 2051, 2, cuda)
    L, R = curve.to_affine(P), curve.to_affine(Qb)
    den, num, bits = point_add.affine_prep(fp, a, *L, *R)
    wd, wn, wb = point_add.affine_prep_plain(fp, a, *L, *R)
    assert torch.equal(den, wd) and torch.equal(num, wn)
    assert torch.equal(bits, wb)
    dinv = pippenger._log_batch_inverse(curve.fp, den)
    tb = torch.from_numpy(np.random.default_rng(3).integers(
        0, 8, size=(den.shape[0],)).astype(np.int32)).to(cuda)
    args = (*R, *L, *R, *L, num, dinv, bits, tb)
    for k, w in zip(point_add.affine_finish(fp, a, *args),
                    point_add.affine_finish_plain(fp, a, *args)):
        assert torch.equal(k, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CURVES)
def test_fold_kernel_matches_plain(cuda, name):
    curve = curve_ops(cs.get_curve(name))
    fp, a = curve.spec.fp, curve.spec.a
    T, _, _, _ = edge_batches(curve, 20, 4, cuda)
    before = point_add.jac_fold_windows.launches
    got = point_add.jac_fold_windows(fp, a, *T, 13)
    assert point_add.jac_fold_windows.launches == before + 1
    for k, w in zip(got, point_add.jac_fold_windows_plain(fp, a, *T, 13)):
        assert torch.equal(k, w)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W20_24, ids=lambda s: s.name)
def test_point_kernels_a_nonzero_20_24_words(cuda, spec):
    """Every bw6 curve has a = 0; the a != 0 instantiations at 20 and 24
    words against the plain versions on coordinates of no curve (the
    formulas take any field values): the double, the add with its doubling
    lanes (P + P) and the fold."""
    q, W = spec.modulus, spec.n_words
    rng = random.Random(W + 2)
    n = 515
    c = [mont.from_int(spec, [rng.randrange(q) for _ in range(n)],
                       device=cuda) for _ in range(3)]
    d = [t.clone() for t in c]
    for t, u in zip(d, c):      # every fourth lane adds P to itself
        t[::4] = u[::4]
    a = 5
    for k, w in zip(point_add.jac_double(spec, a, *c),
                    point_add.jac_double_plain(spec, a, *c)):
        assert torch.equal(k, w)
    for k, w in zip(point_add.jac_add(spec, a, *c, *d),
                    point_add.jac_add_plain(spec, a, *c, *d)):
        assert torch.equal(k, w)
    T = [t[:6].contiguous() for t in c]
    for k, w in zip(point_add.jac_fold_windows(spec, a, *T, 3),
                    point_add.jac_fold_windows_plain(spec, a, *T, 3)):
        assert torch.equal(k, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CURVES)
def test_msm_2e12_matches_identity(cuda, name):
    """msm([i+1]G, s) == [sum s_i (i+1) mod r]G, compared as affine ints."""
    curve = curve_ops(cs.get_curve(name))
    p, a = curve.spec.fp.modulus, curve.spec.a % curve.spec.fp.modulus
    r = curve.spec.fr.modulus
    n = 1 << 12
    g = curve.generator_jac(device=cuda)
    G = Jac(*(c.expand(n, -1) for c in g))
    ks = curve.fr.from_int(list(range(1, n + 1)), mont=False, device=cuda)
    pts = curve.to_affine(curve.scalar_mul(G, ks, nbits=13))
    rng = random.Random(n)
    ss = [rng.randrange(r) for _ in range(n)]
    got = pippenger.msm(curve.spec, pts, curve.fr.from_int(
        ss, mont=False, device=cuda))
    total = sum(s * (i + 1) for i, s in enumerate(ss)) % r
    assert aff_ints(curve, got) == [oracle_mul(
        (curve.spec.gx % p, curve.spec.gy % p), total, p, a)]


@pytest.mark.cuda
def test_point_kernels_reject(cuda):
    curve = curve_ops(cs.get_curve("bn254_g1"))
    P, _, _, _ = edge_batches(curve, 8, 5, cuda)
    fp = curve.spec.fp
    with pytest.raises(ValueError):
        point_add.jac_add(fp, 0, *P, P.x[:4], P.y[:4], P.z[:4])
    with pytest.raises(ValueError):
        point_add.jac_double(fp, 0, P.x[::2], P.y[::2], P.z[::2])
    with pytest.raises(ValueError):
        point_add.affine_finish(fp, 0, *([P.x] * 10),
                                torch.zeros(8, dtype=torch.int64,
                                            device=cuda),
                                torch.zeros(8, dtype=torch.int32,
                                            device=cuda))
    # 8-word rows for a 12-word field
    bls = cs.get_curve("bls12_381_g1").fp
    with pytest.raises(ValueError):
        point_add.jac_double(bls, 0, *P)


def vm_state(prog, n_pad, cuda):
    """Entry rows of ``prog``: its constants, random canonical inputs with
    0, 1 and q - 1 in the first lanes."""
    spec = prog.spec
    state = vm._entry_consts(prog, str(cuda))[:, None, :].repeat(1, n_pad, 1)
    for i, (reg, _) in enumerate(prog.entry_inputs):
        rng = random.Random(i)
        vals = [0, 1, spec.modulus - 1] + [
            rng.randrange(spec.modulus) for _ in range(n_pad)]
        state[reg] = mont.from_int(spec, vals[:n_pad], device=cuda)
    return state


@pytest.mark.cuda
def test_vm_kernel_matches_plain(cuda):
    """A random program of all six ops, scheduled into waves of 8 rows,
    over three 32-lane tiles with edge values; the kernel and the plain
    executor on the same entry rows."""
    prog = vm.schedule(vm.random_program(fs.BN254_FP, 2900, seed=17), 8)
    state = vm_state(prog, 3 * prog.tile, cuda)
    before = vm.vm_execute.launches
    got = vm.vm_execute(prog, state)
    assert vm.vm_execute.launches == before + 1
    assert torch.equal(got, vm.vm_execute_plain(prog, state))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 4, 16])
@pytest.mark.parametrize("spec", [fs.BN254_FP, *W10[:2], *W12[:2],
                                  *W20_24], ids=lambda s: s.name)
def test_vm_wave_kernel_matches_plain_wide(cuda, spec, warps):
    """Random programs with a wide operand window, whose waves are full,
    at 8, 10, 12, 20 and 24 words and 1, 4 and 16 warps a block."""
    prog = vm.schedule(vm.random_program(spec, 2900, seed=23, window=64),
                       warps)
    state = vm_state(prog, 2 * prog.tile, cuda)
    assert torch.equal(vm.vm_execute(prog, state),
                       vm.vm_execute_plain(prog, state))


@pytest.mark.cuda
def test_vm_kernel_rejects(cuda):
    built = vm.random_program(fs.BN254_FP, 50, seed=3)
    prog = vm.schedule(built, 8)
    state = torch.zeros((prog.n_entry, prog.tile, 8), dtype=torch.int32,
                        device=cuda)
    with pytest.raises(ValueError):
        vm.vm_execute(prog, state.to(torch.int64))
    with pytest.raises(ValueError):
        vm.vm_execute(prog, state.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):  # the kernel runs scheduled programs
        vm.vm_execute(built, state)
    secp = vm.schedule(vm.random_program(fs.SECP256K1_FP, 50, seed=3), 8)
    with pytest.raises(NotImplementedError):  # q >= 2^255 at 8 words
        vm.vm_execute(secp, torch.zeros((secp.n_entry, secp.tile, 8),
                                        dtype=torch.int32, device=cuda))
    prog12 = vm.schedule(vm.random_program(fs.BLS12_381_FP, 50, seed=3), 8)
    assert prog12.n_entry == prog.n_entry
    with pytest.raises(ValueError):  # a 12-word program on 8-word rows
        vm.vm_execute(prog12, state)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W12[:2], ids=lambda s: s.name)
def test_vm_kernel_matches_plain_12_words(cuda, spec):
    """The random program of all six ops at 12 words (bls12 Fp)."""
    prog = vm.schedule(vm.random_program(spec, 2900, seed=19), 8)
    state = vm_state(prog, 3 * prog.tile, cuda)
    before = vm.vm_execute.launches_by_width.get(12, 0)
    got = vm.vm_execute(prog, state)
    assert vm.vm_execute.launches_by_width[12] == before + 1
    assert torch.equal(got, vm.vm_execute_plain(prog, state))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W10[:2], ids=lambda s: s.name)
def test_vm_kernel_matches_plain_10_words(cuda, spec):
    """The random program of all six ops at 10 words (bls24 Fp): the
    entry rows and outputs are 40-byte rows, read and written by 8-byte
    loads."""
    prog = vm.schedule(vm.random_program(spec, 2900, seed=21), 8)
    state = vm_state(prog, 3 * prog.tile, cuda)
    before = vm.vm_execute.launches_by_width.get(10, 0)
    got = vm.vm_execute(prog, state)
    assert vm.vm_execute.launches_by_width[10] == before + 1
    assert torch.equal(got, vm.vm_execute_plain(prog, state))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", W20_24, ids=lambda s: s.name)
def test_vm_kernel_matches_plain_20_24_words(cuda, spec):
    """The random program of all six ops at 20 and 24 words (bw6 Fp):
    K x 80 or 96 bytes a lane, within reg_cap (90, 75)."""
    W = spec.n_words
    prog = vm.schedule(vm.random_program(spec, 2900, seed=W), 8)
    assert prog.n_regs <= vm.reg_cap(spec)
    state = vm_state(prog, 3 * prog.tile, cuda)
    before = vm.vm_execute.launches_by_width.get(W, 0)
    got = vm.vm_execute(prog, state)
    assert vm.vm_execute.launches_by_width[W] == before + 1
    assert torch.equal(got, vm.vm_execute_plain(prog, state))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bw6_633", "bw6_761"])
def test_bw6_pair_on_card_equals_golden(cuda, name):
    """e(G1, G2) through the 20- or 24-word VM kernel (G2 over Fp), the
    2-pair check e(P, Q) e(-P, Q) == 1, and gt_exp and the subgroup check
    on the golden element."""
    import json
    import os

    fix = os.path.join(os.path.dirname(__file__), "fixtures",
                       "gt_golden.json")
    with open(fix) as f:
        want = json.load(f)[name]
    g1 = curve_ops(cs.get_curve(f"{name}_g1")).generator_affine(device=cuda)
    g2 = g2_curve(name, cuda).generator_affine(device=cuda)
    fp = cs.get_curve(f"{name}_g1").fp
    before = vm.vm_execute.launches_by_width.get(fp.n_words, 0)
    P = Affine(g1.x[None], g1.y[None])
    z = pairing_api.pair(name, P, g2.x[None], g2.y[None])
    assert vm.vm_execute.launches_by_width[fp.n_words] == before + 1
    assert gt_bytes.gt_to_bytes(name, z)[0].hex() == want["generator"]
    assert gt_bytes.gt_to_bytes(name, pairing_api.gt_exp(name, z, 35))[
        0].hex() == want["p5_q7"]
    assert bool(pairing_api.gt_is_in_subgroup(name, z))
    P2 = Affine(torch.cat([P.x, P.x]),
                torch.cat([P.y, mont.neg(fp, P.y)]))
    QX, QY = (torch.cat([c[None], c[None]]) for c in g2)
    assert bool(pairing_api.pairing_check(name, P2, QX, QY))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bls24_315", "bls24_317"])
def test_bls24_pair_on_card_equals_golden(cuda, name):
    """e(G1, G2) through the 10-word VM kernel, G2 over E4 composed of
    10-word products, and the 2-pair check e(P, Q) e(-P, Q) == 1."""
    import json
    import os

    fix = os.path.join(os.path.dirname(__file__), "fixtures",
                       "gt_golden.json")
    with open(fix) as f:
        want = json.load(f)[name]["generator"]
    g1 = curve_ops(cs.get_curve(f"{name}_g1")).generator_affine(device=cuda)
    g2 = g2_curve(name, cuda).generator_affine(device=cuda)
    before = vm.vm_execute.launches_by_width.get(10, 0)
    P = Affine(g1.x[None], g1.y[None])
    z = pairing_api.pair(name, P, g2.x[None], g2.y[None])
    assert vm.vm_execute.launches_by_width[10] == before + 1
    assert gt_bytes.gt_to_bytes(name, z)[0].hex() == want
    fp = cs.get_curve(f"{name}_g1").fp
    P2 = Affine(torch.cat([P.x, P.x]),
                torch.cat([P.y, mont.neg(fp, P.y)]))
    QX, QY = (torch.cat([c[None], c[None]]) for c in g2)
    assert bool(pairing_api.pairing_check(name, P2, QX, QY))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bls12_381", "bls12_377"])
def test_bls12_pair_on_card_equals_golden(cuda, name):
    """e(G1, G2) and the 2-pair check through the 12-word VM kernel."""
    import json
    import os

    fix = os.path.join(os.path.dirname(__file__), "fixtures",
                       "gt_golden.json")
    with open(fix) as f:
        want = json.load(f)[name]["generator"]
    g1 = curve_ops(cs.get_curve(f"{name}_g1")).generator_affine(device=cuda)
    g2 = g2_curve(name, cuda).generator_affine(device=cuda)
    before = vm.vm_execute.launches_by_width.get(12, 0)
    P = Affine(g1.x[None], g1.y[None])
    z = pairing_api.pair(name, P, g2.x[None], g2.y[None])
    assert vm.vm_execute.launches_by_width[12] == before + 1
    assert gt_bytes.gt_to_bytes(name, z)[0].hex() == want
    fp = cs.get_curve(f"{name}_g1").fp
    P2 = Affine(torch.cat([P.x, P.x]),
                torch.cat([P.y, mont.neg(fp, P.y)]))
    QX, QY = (torch.cat([c[None], c[None]]) for c in g2)
    assert bool(pairing_api.pairing_check(name, P2, QX, QY))


@pytest.mark.cuda
def test_unported_widths_raise_before_any_kernel(cuda):
    """On the card, the Fp2 kernels called with a (words, nr) pair they
    were not built for (bn254's Fp with u^2 = -5, bls12-381's with -7, a
    10-, 20- or 24-word Fp), the NTT kernels called with a 20- or 24-word
    field (no NTT field has that width) and the VM and NTT kernels called
    with a 256-bit 8-word field (secp256k1/r1, which only the field,
    exponent and G1 point kernels take) raise NotImplementedError and
    launch no kernel on the way."""
    from gnark_crypto_tpu_torch.field import point_add2

    eight = (radix2.stage, radix2.block, four_step.sub_ntt,
             point_add2.jac_add2, point_add2.jac_double2,
             point_add2.affine_prep2, point_add2.affine_finish2,
             point_add2.jac_fold_windows2)
    before = [w.launches for w in eight]
    for spec, nr in ((fs.BN254_FP, -5), (fs.BLS12_381_FP, -7),
                     (fs.BLS24_315_FP, -1), (fs.BW6_633_FP, -1),
                     (fs.BW6_761_FP, -1)):
        x = torch.zeros((4, 2, spec.n_words), dtype=torch.int32, device=cuda)
        bits = torch.zeros((4,), dtype=torch.int32, device=cuda)
        for fn, args in ((point_add2.jac_add2, (x,) * 6),
                         (point_add2.jac_double2, (x,) * 3),
                         (point_add2.affine_prep2, (x,) * 4),
                         (point_add2.affine_finish2, (x,) * 10 + (bits,) * 2),
                         (point_add2.jac_fold_windows2, (x,) * 3 + (3,))):
            with pytest.raises(NotImplementedError):
                fn(spec, nr, *args)
    for fp in (fs.BW6_761_FP, fs.BW6_633_FP):
        a = mont.from_int(fp, list(range(1 << 4)), device=cuda)
        tw = a[:8]
        with pytest.raises(NotImplementedError):
            radix2.stage(fp, a, tw, 4, 0, False)
        with pytest.raises(NotImplementedError):
            radix2.block(fp, a, tw, 0, 4, True)
        with pytest.raises(NotImplementedError):
            four_step.sub_ntt(fp, a, tw, 2, 4, True, False)
    assert [w.launches for w in eight] == before
    before = [w.launches for w in (*eight, vm.vm_execute)]
    for spec in FULL:
        a = mont.from_int(spec, list(range(1 << 4)), device=cuda)
        tw = a[:8]
        with pytest.raises(NotImplementedError):
            radix2.stage(spec, a, tw, 4, 0, False)
        with pytest.raises(NotImplementedError):
            four_step.sub_ntt(spec, a, tw, 2, 4, True, False)
        prog = vm.schedule(vm.random_program(spec, 50, seed=3), 8)
        with pytest.raises(NotImplementedError):
            vm.vm_execute(prog, torch.zeros((prog.n_entry, prog.tile, 8),
                                            dtype=torch.int32, device=cuda))
    assert [w.launches for w in (*eight, vm.vm_execute)] == before


@pytest.mark.cuda
def test_pair_on_card_equals_golden(cuda):
    """e(G1, G2) through the VM kernel (the ``full`` program, one tile)
    equals the golden gnark bytes."""
    import json
    import os

    fix = os.path.join(os.path.dirname(__file__), "fixtures",
                       "gt_golden.json")
    with open(fix) as f:
        want = json.load(f)["bn254"]["generator"]
    g1 = curve_ops(cs.get_curve("bn254_g1")).generator_affine(device=cuda)
    g2 = g2_curve("bn254", cuda).generator_affine(device=cuda)
    before = vm.vm_execute.launches
    z = pairing_api.pair("bn254", Affine(g1.x[None], g1.y[None]),
                         g2.x[None], g2.y[None])
    assert vm.vm_execute.launches == before + 1
    assert gt_bytes.gt_to_bytes("bn254", z)[0].hex() == want


# -- the G2 (Fp2) kernels, the G2 MSM and KZG ---------------------------------

# the three built (words, nr) pairs: (8, -1), (12, -1), (12, -5)
G2_CURVES = ["bn254", "bls12_381", "bls12_377"]


def g2_multiples(g2, ks, device):
    """[k]G2 for small k > 0 by the G2 ladder, as Jacobian (n, 2, W)."""
    G = g2.generator_jac(device=device)
    n = len(ks)
    return g2.scalar_mul(Jac(*(c.expand(n, -1, -1) for c in G)),
                         g2.fr.from_int(ks, mont=False, device=device),
                         nbits=max(ks).bit_length())


def g2_edge_batches(g2, n, seed, device):
    """Two (n,) G2 Jacobian batches with P + P, P + (-P), P + inf,
    inf + Q and inf + inf lanes among random sums."""
    rng = random.Random(seed)
    base = g2_multiples(g2, [rng.randrange(1, 1 << 12) for _ in range(n)],
                        device)
    other = g2_multiples(g2, [rng.randrange(1, 1 << 12) for _ in range(n)],
                         device)
    kind = torch.arange(n, device=device) % 8
    inf = g2.inf_jac((n,), device=device)
    P = g2._select((kind == 3) | (kind == 4), inf, base)
    Q = g2._select(kind == 0, base, other)
    Q = g2._select(kind == 1, g2.neg_jac(base), Q)
    Q = g2._select((kind == 2) | (kind == 4), inf, Q)
    return P, Q


@pytest.mark.cuda
@pytest.mark.parametrize("name", G2_CURVES)
def test_fp2_jac_kernels_match_plain(cuda, name):
    from gnark_crypto_tpu_torch.field import point_add2

    g2 = g2_curve(name, cuda)
    fp, nr = g2.spec.fp, g2.fp.nr
    P, Qb = g2_edge_batches(g2, 515, 6, cuda)
    wrappers = (point_add2.jac_add2, point_add2.jac_double2)
    before = [w.launches_by_width.get(fp.n_words, 0) for w in wrappers]
    got = point_add2.jac_add2(fp, nr, *P, *Qb)
    dbl = point_add2.jac_double2(fp, nr, *P)
    assert [w.launches_by_width[fp.n_words] - b
            for w, b in zip(wrappers, before)] == [1, 1]
    for k, w in zip(got, point_add2.jac_add2_plain(fp, nr, *P, *Qb)):
        assert torch.equal(k, w)
    for k, w in zip(dbl, point_add2.jac_double2_plain(fp, nr, *P)):
        assert torch.equal(k, w)
    # the group law routes through the kernel and agrees with the composed
    # Fp2 formulas
    added = g2.add(P, Qb)
    assert point_add2.jac_add2.launches_by_width[fp.n_words] == before[0] + 2
    assert all(torch.equal(u, v) for u, v in
               zip(added, g2._add_composed(P, Qb)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", G2_CURVES)
def test_fp2_affine_level_and_fold_kernels_match_plain(cuda, name):
    from gnark_crypto_tpu_torch.field import point_add2

    g2 = g2_curve(name, cuda)
    fp, nr = g2.spec.fp, g2.fp.nr
    P, Qb = g2_edge_batches(g2, 1029, 7, cuda)
    L, R = g2.to_affine(P), g2.to_affine(Qb)
    den, num, bits = point_add2.affine_prep2(fp, nr, *L, *R)
    wd, wn, wb = point_add2.affine_prep2_plain(fp, nr, *L, *R)
    assert torch.equal(den, wd) and torch.equal(num, wn)
    assert torch.equal(bits, wb)
    dinv = pippenger._log_batch_inverse(g2.fp, den)
    tb = torch.from_numpy(np.random.default_rng(8).integers(
        0, 8, size=(den.shape[0],)).astype(np.int32)).to(cuda)
    args = (*R, *L, *R, *L, num, dinv, bits, tb)
    for k, w in zip(point_add2.affine_finish2(fp, nr, *args),
                    point_add2.affine_finish2_plain(fp, nr, *args)):
        assert torch.equal(k, w)
    T = Jac(*(c[:6].contiguous() for c in P))
    by_width = point_add2.jac_fold_windows2.launches_by_width
    before = by_width.get(fp.n_words, 0)
    got = point_add2.jac_fold_windows2(fp, nr, *T, 5)
    assert by_width[fp.n_words] == before + 1
    for k, w in zip(got, point_add2.jac_fold_windows2_plain(fp, nr, *T, 5)):
        assert torch.equal(k, w)


@pytest.mark.cuda
def test_g2_msm_2e12_matches_identity(cuda):
    """msm([i+1]G2, s) == [sum s_i (i+1) mod r]G2 by one G2 ladder."""
    from gnark_crypto_tpu_torch.field import point_add2

    g2 = g2_curve("bn254", cuda)
    r = g2.spec.fr.modulus
    n = 1 << 12
    pts = g2.to_affine(g2_multiples(g2, list(range(1, n + 1)), cuda))
    rng = random.Random(n)
    ss = [rng.randrange(r) for _ in range(n)]
    # at c = 5 the sweep needs no doubling, so jac_double2 does not launch
    wrappers = [getattr(point_add2, k) for k in (
        "affine_prep2", "affine_finish2", "jac_add2", "jac_fold_windows2")]
    before = [w.launches for w in wrappers]
    got = pippenger.msm(g2, pts, g2.fr.from_int(ss, mont=False, device=cuda),
                        c=5)    # 51 windows x 4096 lanes: phase 1 runs
    assert all(w.launches > b for w, b in zip(wrappers, before))
    total = sum(s * (i + 1) for i, s in enumerate(ss)) % r
    want = g2.scalar_mul(Jac(*(c[None] for c in g2.generator_jac(
        device=cuda))), g2.fr.from_int([total], mont=False, device=cuda))
    got_a = g2.to_affine(Jac(*(c[None] for c in got)))
    want_a = g2.to_affine(want)
    assert all(torch.equal(u, v) for u, v in zip(got_a, want_a))


@pytest.mark.cuda
def test_fp2_kernels_reject(cuda):
    from gnark_crypto_tpu_torch.field import point_add2

    g2 = g2_curve("bn254", cuda)
    fp = g2.spec.fp
    P = g2_multiples(g2, [1, 2, 3, 4], cuda)
    with pytest.raises(ValueError):
        point_add2.jac_add2(fp, -1, *P, P.x[:2], P.y[:2], P.z[:2])
    with pytest.raises(ValueError):
        point_add2.jac_double2(fp, -1, P.x[::2], P.y[::2], P.z[::2])
    with pytest.raises(NotImplementedError):
        point_add2.jac_double2(fp, -5, *P)
    bls = g2_curve("bls12_381", cuda)  # 12-word Fp2: bn254's tensors refused
    x = bls.fp.zeros((4,), device=cuda)
    with pytest.raises(ValueError):
        point_add2.jac_double2(bls.spec.fp, -1, *P)
    for fn, args in ((point_add2.jac_double2, (x, x, x)),
                     (point_add2.affine_prep2, (x, x, x, x)),
                     (point_add2.jac_fold_windows2, (x, x, x, 3))):
        with pytest.raises(NotImplementedError):
            fn(bls.spec.fp, -3, *args)
    bls24 = curve_ops(cs.get_curve("bls24_315_g1"))  # 10-word Fp
    with pytest.raises(NotImplementedError):
        point_add2.jac_double2(bls24.spec.fp, -1, *(
            torch.zeros((2, 2, 10), dtype=torch.int32, device=cuda),) * 3)


def fp2_oracle_add(P, Q, p, nr):
    """Affine G2 addition (a = 0) over Fp[u]/(u^2 - nr) with Python ints;
    an element is (re, im), None is infinity. (This file imports no other
    test module: a ``tests`` package installed in site-packages shadows
    the repository's ``tests`` directory, which has no ``__init__.py``.)"""
    def mul(x, y):
        return ((x[0] * y[0] + nr * x[1] * y[1]) % p,
                (x[0] * y[1] + x[1] * y[0]) % p)

    def inv(x):
        d = pow((x[0] * x[0] - nr * x[1] * x[1]) % p, -1, p)
        return x[0] * d % p, -x[1] * d % p

    def sub(x, y):
        return (x[0] - y[0]) % p, (x[1] - y[1]) % p

    if P is None or Q is None:
        return Q if P is None else P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and sub((0, 0), y1) == y2:
        return None
    if P == Q:
        sq = mul(x1, x1)
        lam = mul((3 * sq[0] % p, 3 * sq[1] % p),
                  inv((2 * y1[0] % p, 2 * y1[1] % p)))
    else:
        lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(mul(lam, lam), x1), x2)
    return x3, sub(mul(lam, sub(x1, x3)), y1)


def fp2_oracle_mul(P, k, p, nr):
    acc = None
    while k:
        if k & 1:
            acc = fp2_oracle_add(acc, P, p, nr)
        P = fp2_oracle_add(P, P, p, nr)
        k >>= 1
    return acc


def g2_aff_ints(g2, pt):
    """G2 Jacobian points -> ((x.re, x.im), (y.re, y.im)) ints, None at
    infinity."""
    aff = g2.to_affine(Jac(*(c.reshape(-1, *c.shape[-2:]) for c in pt)))
    xs, ys = (list(zip(*g2.fp.to_int(c))) for c in aff)
    return [None if x == (0, 0) and y == (0, 0) else (x, y)
            for x, y in zip(xs, ys)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bls12_381", "bls12_377"])
def test_bls12_g2_msm_2e8_matches_oracle(cuda, name):
    """A bls12 G2 MSM of 2^8 points [i+1]G2 on the 12-word Fp2 kernels, at
    c = 5 so that phase 1 runs (51 windows x 256 lanes), equals
    [sum s_i (i+1) mod r]G2 by the Python-int Fp2 ladder."""
    from gnark_crypto_tpu_torch.field import point_add2

    g2 = g2_curve(name, cuda)
    p, r, nr = g2.spec.fp.modulus, g2.spec.fr.modulus, g2.fp.nr
    n = 1 << 8
    pts = g2.to_affine(g2_multiples(g2, list(range(1, n + 1)), cuda))
    rng = random.Random(n + nr)
    ss = [rng.randrange(r) for _ in range(n)]
    wrappers = [getattr(point_add2, k) for k in (
        "affine_prep2", "affine_finish2", "jac_add2", "jac_fold_windows2")]
    before = [w.launches_by_width.get(12, 0) for w in wrappers]
    got = pippenger.msm(g2, pts, g2.fr.from_int(ss, mont=False, device=cuda),
                        c=5)
    assert all(w.launches_by_width.get(12, 0) > b
               for w, b in zip(wrappers, before))
    total = sum(s * (i + 1) for i, s in enumerate(ss)) % r
    assert g2_aff_ints(g2, Jac(*(c[None] for c in got))) == [
        fp2_oracle_mul((g2.spec.gx, g2.spec.gy), total, p, nr)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", G2_CURVES)
def test_commit_open_verify_on_card(cuda, name):
    """A 2^12 new_srs/commit/open/verify on the card, against the alpha
    oracle; [alpha]G2 of the SRS against the Python-int Fp2 ladder."""
    from gnark_crypto_tpu_torch.protocols import kzg

    g1 = curve_ops(cs.get_curve(f"{name}_g1"))
    r = g1.spec.fr.modulus
    rng = random.Random(12)
    alpha = rng.randrange(r)
    n = 1 << 12
    srs = kzg.new_srs(name, n, alpha, device=cuda)
    g2 = g2_curve(name, cuda)
    assert g2_aff_ints(g2, g2.from_affine(srs.vk.alpha_g2)) == [
        fp2_oracle_mul((g2.spec.gx, g2.spec.gy), alpha, g2.spec.fp.modulus,
                       g2.fp.nr)]
    coeffs = [rng.randrange(r) for _ in range(n)]
    a = rng.randrange(r)
    poly = g1.fr.from_int(coeffs, mont=False, device=cuda)
    point = g1.fr.from_int([a], mont=False, device=cuda)
    C = kzg.commit(name, srs.pk, poly)
    proof = kzg.open_poly(name, srs.pk, poly, point)
    p_alpha = p_a = 0
    for c in reversed(coeffs):
        p_alpha = (p_alpha * alpha + c) % r
        p_a = (p_a * a + c) % r
    q_alpha = (p_alpha - p_a) * pow(alpha - a, -1, r) % r
    G = g1.generator_jac(device=cuda)
    want = g1.to_affine(g1.scalar_mul(
        Jac(*(c.expand(2, -1) for c in G)),
        g1.fr.from_int([p_alpha, q_alpha], mont=False, device=cuda)))
    assert aff_ints(g1, g1.from_affine(C)) == aff_ints(
        g1, Jac(*(c[:1] for c in g1.from_affine(want))))
    assert aff_ints(g1, g1.from_affine(proof.h)) == aff_ints(
        g1, Jac(*(c[1:] for c in g1.from_affine(want))))
    assert g1.fr.to_int(proof.claimed_value, mont=False) == [p_a]
    assert bool(kzg.verify(name, C, proof, point, srs.vk))
    bad = kzg.OpeningProof(proof.h, g1.fr.from_int(
        [(p_a + 1) % r], mont=False, device=cuda))
    assert not bool(kzg.verify(name, C, bad, point, srs.vk))


# -- the small fields: koalabear/babybear and goldilocks NTT kernels ---------

def small_elems(spec, n, seed, device):
    """n random canonical Montgomery elements of a small field."""
    eng = api.for_spec(spec)
    rng = np.random.default_rng(seed)
    if eng.elem_dims == 0:
        v = rng.integers(0, spec.modulus, size=n, dtype=np.int64)
        return torch.from_numpy(v.astype(np.int32)).to(device)
    v = rng.integers(0, spec.modulus, size=n, dtype=np.uint64)
    return torch.from_numpy(v.view(np.int32).reshape(n, 2).copy()).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["koalabear", "babybear"])
def test_f31_kernels_match_plain(cuda, name):
    spec = fs.get_field(name)
    k = 20
    dom = Domain(spec, 1 << k, device=cuda)
    a = small_elems(spec, 1 << k, 5, cuda)
    tw0 = dom.twiddles0
    before = [w.launches for w in (radix2_f31.stage, radix2_f31.stage_r4,
                                   radix2_f31.block)]
    for dit in (False, True):
        for s in (0, 3, 6):
            assert torch.equal(radix2_f31.stage(spec, a, tw0, k, s, dit),
                               radix2_f31.stage_plain(spec, a, tw0, k, s, dit))
            assert torch.equal(
                radix2_f31.stage_r4(spec, a, tw0, k, s, dit),
                radix2_f31.stage_r4_plain(spec, a, tw0, k, s, dit))
        assert torch.equal(radix2_f31.block(spec, a, tw0, 7, 13, dit),
                           radix2_f31.block_plain(spec, a, tw0, 7, 13, dit))
    for rows, log_n in ((4096, 9), (32768, 4)):  # the SIS shapes
        small = Domain(spec, 1 << log_n, with_coset=False, device=cuda)
        b = small_elems(spec, rows << log_n, log_n, cuda)
        for dit in (False, True):
            got = radix2_f31.block(spec, b, small.twiddles0, 0, log_n, dit)
            assert torch.equal(got, radix2_f31.block_plain(
                spec, b, small.twiddles0, 0, log_n, dit))
    assert [w.launches - n for w, n in zip(
        (radix2_f31.stage, radix2_f31.stage_r4, radix2_f31.block),
        before)] == [6, 6, 6]
    for dec, inverse in PAIRS:
        assert torch.equal(fft._run(dom, a, dec, inverse)[0],
                           radix2_f31.run_plain(dom, a, dec, inverse))


@pytest.mark.cuda
def test_f64_kernels_match_plain(cuda):
    spec = fs.GOLDILOCKS
    k = 20
    dom = Domain(spec, 1 << k, device=cuda)
    a = small_elems(spec, 1 << k, 6, cuda)
    tw0 = dom.twiddles0
    for dit in (False, True):
        for s in (0, 7):
            assert torch.equal(radix2_f64.stage(spec, a, tw0, k, s, dit),
                               radix2_f64.stage_plain(spec, a, tw0, k, s, dit))
        assert torch.equal(radix2_f64.block(spec, a, tw0, 8, 12, dit),
                           radix2_f64.block_plain(spec, a, tw0, 8, 12, dit))
    small = Domain(spec, 512, with_coset=False, device=cuda)
    b = small_elems(spec, 2048 * 512, 9, cuda)  # the 2^18-element SIS rows
    for dit in (False, True):
        assert torch.equal(
            radix2_f64.block(spec, b, small.twiddles0, 0, 9, dit),
            radix2_f64.block_plain(spec, b, small.twiddles0, 0, 9, dit))
    for dec, inverse in PAIRS:
        assert torch.equal(fft._run(dom, a, dec, inverse)[0],
                           radix2_f64.run_plain(dom, a, dec, inverse))


@pytest.mark.cuda
def test_small_field_kernels_reject(cuda):
    kb, gl = fs.KOALABEAR, fs.GOLDILOCKS
    a = small_elems(kb, 1 << 10, 1, cuda)
    g = small_elems(gl, 1 << 10, 2, cuda)
    tw, twg = (Domain(s, 1 << 10, with_coset=False, device=cuda).twiddles0
               for s in (kb, gl))
    with pytest.raises(ValueError):
        radix2_f31.stage(kb, a[::2], tw, 9, 0, False)
    with pytest.raises(ValueError):
        radix2_f31.stage_r4(kb, a, tw, 10, 9, False)   # stage 10 is past k
    with pytest.raises(ValueError):
        radix2_f31.block(kb, a[:1000], tw, 0, 10, False)
    with pytest.raises(NotImplementedError):
        radix2_f31.block(gl, g, twg, 0, 10, False)
    with pytest.raises(ValueError):
        radix2_f64.stage(gl, g.to(torch.int64), twg, 10, 0, False)
    with pytest.raises(ValueError):
        radix2_f64.block(gl, g, twg, 0, 13, False)      # beyond the tile
    with pytest.raises(NotImplementedError):
        radix2_f64.stage(kb, a, tw, 10, 0, False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["koalabear", "goldilocks"])
def test_sis_on_card_equals_cpu(cuda, name):
    """Ring-SIS hash and hash_many on the card (block-kernel passes) equal
    the CPU's plain pipeline."""
    spec = fs.get_field(name)
    eng = api.for_spec(spec)
    on_card = RSis(spec, 42, 9, 16, 1 << 12, device=cuda)
    on_cpu = RSis(spec, 42, 9, 16, 1 << 12, device="cpu")
    v = eng.from_mont(small_elems(spec, 1 << 12, 3, "cpu"))
    before = (radix2_f31.block if eng.elem_dims == 0
              else radix2_f64.block).launches
    got = on_card.hash(v.to(cuda))
    assert (radix2_f31.block if eng.elem_dims == 0
            else radix2_f64.block).launches == before + 2
    assert torch.equal(got.cpu(), on_cpu.hash(v))
    vs = torch.stack([v[:1000], v[1000:2000], v[2000:3000]])
    assert torch.equal(on_card.hash_many(vs.to(cuda)).cpu(),
                       on_cpu.hash_many(vs))


# -- the redesigned exp_const and jac_double2 -----------------------------------

EXP_FIELDS = [fs.BN254_FP, fs.BLS24_315_FP, fs.BLS24_317_FP,
              fs.BLS12_381_FP, fs.BLS12_377_FP, *FULL]


def exp_inputs(spec, n, seed, cuda):
    """n canonical Montgomery values, 0 and 1 among them."""
    q = spec.modulus
    rng = random.Random(seed)
    vals = ([0, 1, q - 1] + [rng.randrange(q) for _ in range(n)])[:n]
    return mont.from_int(spec, vals, device=cuda)


def exps(spec):
    q, W = spec.modulus, spec.n_words
    return [0, 1, 2, q - 2, (q - 1) // 2, (q + 1) // 4,
            (spec.t_odd - 1) // 2, (1 << (32 * W)) + 12345]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", EXP_FIELDS, ids=lambda s: s.name)
def test_exp_const_right_to_left_every_exponent(cuda, spec):
    x = exp_inputs(spec, 129, 17, cuda)
    by_width = exp.exp_const.launches_by_width
    key = kernels.width_key(spec)   # "8full" for secp256k1/r1
    for e in exps(spec):
        before = by_width.get(key, 0)
        got = exp.exp_const(spec, x, e)
        assert by_width[key] == before + 1
        assert torch.equal(got, exp.exp_const_plain(spec, x, e)), e


@pytest.mark.cuda
@pytest.mark.parametrize("spec", EXP_FIELDS, ids=lambda s: s.name)
def test_exp_const_batches_and_designs(cuda, spec):
    """Batches 1, 31, 128, 129, 4096 at e = q - 2 in the design that
    csrc/exp.cu fixes for the width (the blocks' ragged edges)."""
    e = spec.modulus - 2
    x = exp_inputs(spec, 4096, 19, cuda)
    want = exp.exp_const_plain(spec, x, e)
    for n in (1, 31, 128, 129, 4096):
        assert torch.equal(exp.exp_const(spec, x[:n], e), want[:n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("name", G2_CURVES)
def test_jac_double2_designs_match_plain(cuda, name):
    """The double in the design that csrc/point_add2.cu fixes for the
    (words, u^2) pair (a thread pair at (12, -1)) on odd n, n = 1 and Z = 0
    lanes."""
    from gnark_crypto_tpu_torch.field import point_add2

    g2 = g2_curve(name, cuda)
    fp, nr = g2.spec.fp, g2.fp.nr
    P, _ = g2_edge_batches(g2, 515, 9, cuda)
    assert bool(torch.all(P.z == 0, -1).all(-1).any())
    want = point_add2.jac_double2_plain(fp, nr, *P)
    for n in (515, 1):
        Pn = [c[:n].contiguous() for c in P]
        got = point_add2.jac_double2(fp, nr, *Pn)
        assert all(torch.equal(k, w[:n]) for k, w in zip(got, want)), n
