"""The designs of the ``exp_const`` and ``jac_double2`` kernels, on the CPU.

The CUDA kernels (``csrc/exp.cu``, ``csrc/point_add2.cu``) run only on the
card, so here Python models of their designs, step for step, are held
against the unchanged plain versions and the JAX package:

* the exponent words the wrapper hands the kernel (cached per (spec, e))
  rebuild e, or e reduced mod q - 1 where e >= 2^(32W);
* the kernel's right-to-left ladder, squares handed from one group of
  warps to the other in chunks, equals ``exp_const_plain``;
* the team product (T lanes an element) and the column product
  (``gct::mont_mul_ilp``) equal a b R^-1 mod q on Python integers;
* the Fp2 square in 2 base products equals the Fp2 product, at
  u^2 = -1 and -5, on Python integers and on plain word tensors;
* the thread-pair double (each lane's formulas) equals
  ``jac_double2_plain``, which equals the JAX package's G2 double.

The tolerance is exact equality: every value is a canonical residue.
"""

import random

import pytest
import torch

from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.g2 import g2_curve
from gnark_crypto_tpu_torch.curve.jacobian import Jac
from gnark_crypto_tpu_torch.field import exp, mont, point_add2
from gnark_crypto_tpu_torch.field.kernels import mont_mul_plain
from gnark_crypto_tpu_torch.specs import field as fs

CPU = "cpu"
M32 = (1 << 32) - 1
# 8 words (T = 1 on the card), 10 and 12 (a team of T = 4; at 10 words each
# lane holds K = 3 words, the twelfth slot zero)
FIELDS = [fs.BN254_FP, fs.BLS24_315_FP, fs.BLS24_317_FP, fs.BLS12_381_FP,
          fs.BLS12_377_FP]
CURVES = [("bn254", -1), ("bls12_381", -1), ("bls12_377", -5)]
CHUNK = 4  # csrc/exp.cu kChunk


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exponents(spec):
    q, W = spec.modulus, spec.n_words
    return {"0": 0, "1": 1, "2": 2, "q-2": q - 2, "(q-1)/2": (q - 1) // 2,
            "(q+1)/4": (q + 1) // 4, "(t_odd-1)/2": (spec.t_odd - 1) // 2,
            "e>=2^(32W)": (1 << (32 * W)) + 12345}


def words_of(v: int, n: int) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(n)]


def int_of(ws) -> int:
    return sum(w << (32 * i) for i, w in enumerate(ws))


# -- the exponent encoding ----------------------------------------------------

@pytest.mark.parametrize("name", list(exponents(fs.BN254_FP)))
@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
def test_exponent_words_rebuild_e(spec, name):
    q, W = spec.modulus, spec.n_words
    e = exponents(spec)[name]
    words, nbits = exp.exponent_words(spec, e)
    want = e if e < 1 << (32 * W) else (e - 1) % (q - 1) + 1
    assert len(words) == W and all(0 <= w <= M32 for w in words)
    assert int_of(words) == want and nbits == want.bit_length()
    assert exp.exponent_words(spec, e) is exp.exponent_words(spec, e)
    rng = random.Random(W)
    for x in [0, 1, q - 1] + [rng.randrange(q) for _ in range(4)]:
        assert pow(x, want, q) == pow(x, e, q)


# -- the right-to-left ladder ------------------------------------------------

def rtl_model(spec, x, e):
    """csrc/exp.cu: the squaring warps fill chunk ch with
    x^(2^b), b in the chunk, while the multiplying warps take chunk ch - 1;
    acc starts at the first set bit's square. Returns (x^e, squares,
    multiplies)."""
    words, nb = exp.exponent_words(spec, e)
    bits = int_of(words)
    base, acc, first = x, exp._one(spec, x), True
    squares = mults = 0
    chunks = -(-nb // CHUNK)
    buf = {}
    for ch in range(chunks + 1):
        if ch < chunks:  # the squaring warps
            for u in range(CHUNK):
                b = ch * CHUNK + u
                if b >= nb:
                    break
                buf[ch % 2, u] = base
                if b + 1 < nb:
                    base = mont_mul_plain(spec, base, base)
                    squares += 1
        if ch > 0:  # the multiplying warps, one chunk behind
            for u in range(CHUNK):
                b = (ch - 1) * CHUNK + u
                if b >= nb:
                    break
                if (bits >> b) & 1:
                    v = buf[(ch - 1) % 2, u]
                    if first:
                        acc = v
                    else:
                        acc = mont_mul_plain(spec, acc, v)
                        mults += 1
                    first = False
    return acc, squares, mults


@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
def test_rtl_ladder_model_equals_plain(spec):
    q = spec.modulus
    rng = random.Random(spec.n_words + 1)
    x = mont.from_int(spec, [0, 1, q - 1] + [rng.randrange(q)
                                             for _ in range(3)], device=CPU)
    for e in (0, 1, 2, 5, 12345, q - 2):
        got, squares, mults = rtl_model(spec, x, e)
        assert torch.equal(got, exp.exp_const_plain(spec, x, e))
        # the chain is the squares: nbits - 1; the multiplies trail it
        assert squares == max(e.bit_length() - 1, 0)
        assert mults == max(bin(e).count("1") - 1, 0)
    assert mont.to_int(spec, rtl_model(spec, x, q - 2)[0]) == [
        pow(v, q - 2, q) for v in mont.to_int(spec, x)]


# -- the products ------------------------------------------------------------

def mont_ref(spec, a: int, b: int) -> int:
    return a * b * pow(1 << (32 * spec.n_words), -1, spec.modulus) \
        % spec.modulus


def column_model(spec, a: int, b: int) -> int:
    """gct::mont_mul_ilp: columns summed into a fresh three-word
    accumulator, the carry in, the newest m's term, then m."""
    W, qw, qinv = spec.n_words, spec.q_words, spec.qinv32
    aw, bw = words_of(a, W), words_of(b, W)
    m, r = [0] * W, [0] * W
    cl = ch = 0
    for c in range(2 * W - 1):
        lo, hi = (0, c) if c < W else (c - W + 1, W - 1)
        d = sum(aw[k] * bw[c - k] for k in range(lo, hi + 1))
        d += sum(m[k] * qw[c - k] for k in range(lo, c - 1 if c < W else W))
        d += cl + (ch << 32)
        if c < W:
            if c >= 1:
                d += m[c - 1] * qw[1]
            m[c] = (d & M32) * qinv & M32
            d += m[c] * qw[0]
            assert d & M32 == 0
        else:
            r[c - W] = d & M32
        assert d < 1 << 96
        cl, ch = (d >> 32) & M32, d >> 64
    r[W - 1] = cl
    v = int_of(r) + (ch << (32 * W))
    return v - spec.modulus if v >= spec.modulus else v


def team_model(spec, a: int, b: int, T: int) -> int:
    """The team CIOS of csrc/exp.cu: lane j holds words [jK, jK + K) and a
    carry h into lane j + 1; a shuffle is a read of the other lanes'
    values of the same step."""
    W, qinv = spec.n_words, spec.qinv32
    K = -(-W // T)

    def lanes(v):
        ws = words_of(v, T * K)
        return [ws[j * K:(j + 1) * K] for j in range(T)]

    A, B, Q = lanes(a), lanes(b), lanes(spec.modulus)
    s = [[0] * K for _ in range(T)]
    h = [0] * T
    for i in range(W):
        ai = A[i // K][i % K]
        c1 = [0] * T
        for j in range(T):
            for k in range(K):
                p = ai * B[j][k] + s[j][k] + c1[j]
                s[j][k], c1[j] = p & M32, p >> 32
        m = s[0][0] * qinv & M32
        c2 = [0] * T
        for j in range(T):
            for k in range(K):
                p = m * Q[j][k] + s[j][k] + c2[j]
                s[j][k], c2[j] = p & M32, p >> 32
        assert s[0][0] == 0
        nxt = [s[j + 1][0] if j < T - 1 else 0 for j in range(T)]
        for j in range(T):
            top = c1[j] + c2[j] + h[j] + nxt[j]
            s[j] = s[j][1:] + [top & M32]
            h[j] = top >> 32
    out, r = [0] * T, None
    for _ in range(T):  # carries ripple up, one lane a round
        ins = [0] + [(h[j] + out[j]) & M32 for j in range(T - 1)]
        r, out = [], []
        for j in range(T):
            t, rw = ins[j], []
            for k in range(K):
                t += s[j][k]
                rw.append(t & M32)
                t >>= 32
            r.append(rw)
            out.append(t)
    borrow, d = [0] * T, None
    for _ in range(T):  # then the borrow of r - q
        ins = [0] + borrow[:-1]
        d, borrow = [], []
        for j in range(T):
            bb, dw = ins[j], []
            for k in range(K):
                t = r[j][k] - Q[j][k] - bb
                dw.append(t & M32)
                bb = 1 if t < 0 else 0
            d.append(dw)
            borrow.append(bb)
    res = r if borrow[T - 1] else d
    return int_of([w for lane in res for w in lane])


def product_inputs(spec, seed):
    q = spec.modulus
    rng = random.Random(seed)
    vals = [0, 1, q - 1, q - 2] + [rng.randrange(q) for _ in range(12)]
    return [(u, v) for u in vals[:4] for v in vals[:4]] + list(
        zip(vals[4:], vals[:3:-1]))


@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
def test_column_product_model(spec):
    for a, b in product_inputs(spec, 3):
        assert column_model(spec, a, b) == mont_ref(spec, a, b)


@pytest.mark.parametrize("T", [2, 4, 8])
@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
def test_team_product_model(spec, T):
    for a, b in product_inputs(spec, T):
        assert team_model(spec, a, b, T) == mont_ref(spec, a, b)


# -- the Fp2 square and the thread pair ----------------------------------------

def f2_mul(a, b, p, nr):
    return ((a[0] * b[0] + nr * a[1] * b[1]) % p,
            (a[0] * b[1] + a[1] * b[0]) % p)


def f2_sqr(a, p, nr):
    """csrc/fp2.cuh sqr: v = a0 a1, im = 2v,
    re = (a0 + a1)(a0 + nr a1) - (1 + nr) v."""
    v = a[0] * a[1] % p
    u = (a[0] + a[1]) * (a[0] + nr * a[1]) % p
    return (u - (1 + nr) * v) % p, 2 * v % p


def sqr_words(spec, nr, a):
    """The same square on plain word tensors (N, 2, W), op for op."""
    ops = point_add2._Ops2(spec, nr)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    v = mont_mul_plain(spec, a0, a1)
    k1 = ops._small(a1, abs(nr))
    plus = mont.sub(spec, a0, k1) if nr < 0 else mont.add(spec, a0, k1)
    u = mont_mul_plain(spec, mont.add(spec, a0, a1), plus)
    if nr == -1:
        re = u
    elif nr < -1:
        re = mont.add(spec, u, ops._small(v, -1 - nr))
    else:
        re = mont.sub(spec, u, ops._small(v, 1 + nr))
    return torch.stack([re, mont.add(spec, v, v)], dim=-2)


def fp2_values(p, seed, n=16):
    rng = random.Random(seed)
    edge = [0, 1, p - 1]
    return [(u, v) for u in edge for v in edge] + [
        (rng.randrange(p), rng.randrange(p)) for _ in range(n)]


@pytest.mark.parametrize("name,nr", CURVES)
def test_fp2_sqr_identity(name, nr):
    g2 = g2_curve(name, CPU)
    fp = g2.spec.fp
    p = fp.modulus
    vals = fp2_values(p, 11)
    assert [f2_sqr(a, p, nr) for a in vals] == [f2_mul(a, a, p, nr)
                                                for a in vals]
    a = g2.fp.from_int(vals, device=CPU)
    got = sqr_words(fp, nr, a)
    assert torch.equal(got, point_add2._Ops2(fp, nr).mul(a, a))
    assert [tuple(mont.to_int(fp, c)) for c in got] == [
        f2_mul(v, v, p, nr) for v in vals]


class _PairModel(point_add2._Ops2):
    """The Fp2 ops as the two lanes of a pair run them (csrc/fp2.cuh
    Half2T): lane 0 computes re, lane 1 im, each from its own half and
    its partner's; a square is an op whose operands are one tensor."""

    def mul(self, a, b):
        s, nr = self.spec, self.nr
        mm = mont_mul_plain
        a0, a1 = a[..., 0, :], a[..., 1, :]
        if a is b:
            re = sqr_words(s, nr, a)[..., 0, :]        # lane 0: u, then v
            v = mm(s, a1, a0)                           # lane 1
            return torch.stack([re, mont.add(s, v, v)], dim=-2)
        b0, b1 = b[..., 0, :], b[..., 1, :]
        t = self._small(mm(s, a1, b1), abs(nr))       # lane 0
        p1 = mm(s, a0, b0)
        re = mont.sub(s, p1, t) if nr < 0 else mont.add(s, p1, t)
        im = mont.add(s, mm(s, a1, b0), mm(s, a0, b1))  # lane 1
        return torch.stack([re, im], dim=-2)


def g2_points(g2, n, seed):
    """n random Jacobian Fp2 coordinates with Z = 0 (infinity) lanes; the
    double's formula needs no curve point."""
    p = g2.spec.fp.modulus
    x, y, z = (fp2_values(p, seed + k, n)[-n:] for k in range(3))
    z[1] = z[n - 2] = (0, 0)
    x[2], y[3] = (0, 1), (p - 1, 0)
    return tuple(g2.fp.from_int(c, device=CPU) for c in (x, y, z))


@pytest.mark.parametrize("name,nr", CURVES)
def test_pair_double_model_equals_plain(name, nr):
    from gnark_crypto_tpu_torch.field.point_add import _dbl_core

    g2 = g2_curve(name, CPU)
    fp = g2.spec.fp
    P = g2_points(g2, 7, 21)
    got = _dbl_core(_PairModel(fp, nr), 0, *P)
    want = point_add2.jac_double2_plain(fp, nr, *P)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert bool((got[2][[1, 5]] == 0).all())  # Z = 0 in, Z = 0 out


@pytest.mark.parametrize("name,nr", CURVES)
def test_jac_double2_plain_matches_jax(name, nr):
    """The plain double against the JAX package's G2 double (its plain
    XLA path on the CPU), as canonical integers."""
    from gnark_crypto_tpu.curve.g2 import g2_curve as jg2_curve
    from gnark_crypto_tpu.curve.jacobian import Jac as JJac
    from gnark_crypto_tpu.field import mont as jmont
    from gnark_crypto_tpu.specs import field as jfs

    g2 = g2_curve(name, CPU)
    fp = g2.spec.fp
    P = Jac(*g2_points(g2, 5, 31))
    want = jg2_curve(name).double(JJac(*convert.point_to_jax(fp, P)))
    got = point_add2.jac_double2(fp, nr, *P)   # CPU: the plain version
    jfp = jfs.get_field(fp.name)
    for g, w in zip(got, want):
        arr = convert.to_jax_limbs(fp, g)
        assert jmont.to_int(jfp, arr.reshape(-1, arr.shape[-1])) == \
            jmont.to_int(jfp, w.reshape(-1, w.shape[-1]))


# -- the wrappers ------------------------------------------------------------

def test_wrappers_take_the_plain_path_and_refuse_bad_designs():
    """On CPU tensors both wrappers run their plain versions and launch
    nothing; a negative exponent and a non-residue out of range are
    refused before any work."""
    spec = fs.BN254_FP
    x = mont.from_int(spec, [3, 5], device=CPU)
    before = exp.exp_const.launches
    assert torch.equal(exp.exp_const(spec, x, 7),
                       exp.exp_const_plain(spec, x, 7))
    assert exp.exp_const.launches == before
    with pytest.raises(ValueError, match="negative"):
        exp.exp_const(spec, x, -1)
    g2 = g2_curve("bn254", CPU)
    P = g2_points(g2, 4, 41)
    before = point_add2.jac_double2.launches
    got = point_add2.jac_double2(g2.spec.fp, -1, *P)
    want = point_add2.jac_double2_plain(g2.spec.fp, -1, *P)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert point_add2.jac_double2.launches == before
    with pytest.raises(ValueError, match="non-residue"):
        point_add2.jac_double2(g2.spec.fp, 17, *P)
