"""Montgomery arithmetic over 32-bit word tensors (PyTorch).

Counterpart of ``gnark_crypto_tpu/field/mont.py``. An element is an
``int32[..., W]`` tensor of the little-endian 32-bit words of
``x * R mod q``, ``R = 2^(32W)`` (gnark's own Montgomery form), always
canonical (< q). Every op is batched over the leading dims and runs on the
device of its inputs; constructors take ``device`` and default to CUDA.

``mul`` (and everything built on it) goes to the CUDA kernel for CUDA
tensors and to the plain version for CPU tensors (``field/kernels.py``);
so does ``exp_const`` (``field/exp.py``), and with it ``inverse``,
``legendre`` and ``sqrt``.
Additions, subtractions and the other linear ops are plain tensor code on
both devices, as in the JAX engine, which also runs them outside any kernel.
Word carries are computed in int64, where PyTorch has every op it needs on
both devices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnark_crypto_tpu_torch.field import exp as field_exp
from gnark_crypto_tpu_torch.field.kernels import (
    M32, carry_words, const_words, mont_mul, to_i32, u32)
from gnark_crypto_tpu_torch.specs.field import FieldSpec, int_to_words

DEFAULT_DEVICE = "cuda"


# ---------------------------------------------------------------------------
# host-side conversions
# ---------------------------------------------------------------------------

def _ints_to_words(values: list[int], n_words: int) -> np.ndarray:
    buf = b"".join(v.to_bytes(4 * n_words, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(len(values), n_words)


def _words_to_ints(x: torch.Tensor) -> list[int]:
    arr = np.ascontiguousarray(
        x.detach().to("cpu").numpy().astype("<u4")).reshape(-1, x.shape[-1])
    return [int.from_bytes(row.tobytes(), "little") for row in arr]


def from_int(spec: FieldSpec, values, mont: bool = True,
             device=DEFAULT_DEVICE) -> torch.Tensor:
    """Python int(s) -> word tensor, (W,) for an int, (N, W) for a list.

    Values are reduced mod q; ``mont`` converts to Montgomery form."""
    single = isinstance(values, int)
    vals = [values] if single else list(values)
    q = spec.modulus
    vals = [(v % q) * spec.r % q if mont else v % q for v in vals]
    arr = _ints_to_words(vals, spec.n_words).view(np.int32)
    out = torch.from_numpy(arr.copy()).to(device)
    return out[0] if single else out


def to_int(spec: FieldSpec, x: torch.Tensor, mont: bool = True):
    """Word tensor -> Python int ((W,) input) or list of ints."""
    vals = _words_to_ints(x)
    if mont:
        vals = [v * spec.r_inv % spec.modulus for v in vals]
    return vals[0] if x.dim() == 1 else vals


def _const(spec: FieldSpec, words, like: torch.Tensor) -> torch.Tensor:
    return to_i32(const_words(tuple(words), str(like.device)))


def zeros(spec: FieldSpec, shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.zeros((*shape, spec.n_words), dtype=torch.int32,
                       device=device)


def ones(spec: FieldSpec, shape=(), device=DEFAULT_DEVICE) -> torch.Tensor:
    one = to_i32(const_words(spec.one_words, str(torch.device(device))))
    return one.expand(*shape, spec.n_words).clone()


# ---------------------------------------------------------------------------
# ring ops
# ---------------------------------------------------------------------------

def _lookahead(g: torch.Tensor, p: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The carries of a word-serial chain c_(i+1) = g_i | (p_i & c_i),
    c_0 = 0, where word i generates (g_i) or propagates (p_i) one, never
    both (int64 0/1 words): returns the carry into each word and out of the
    top one. One integer addition runs the whole chain, as a carry-lookahead
    adder does: with the bits packed, G = sum g_i 2^i and P = sum p_i 2^i,
    bit i of ((G << 1) + P) ^ P is c_i. A handful of tensor ops whatever
    the width, where a loop over the words costs four a word: the field's
    add and sub on small batches are bound by their launches on the card."""
    sh = const_words(tuple(range(g.shape[-1])), str(g.device))
    big_p = (p << sh).sum(-1)
    c = (((g << sh).sum(-1) << 1) + big_p) ^ big_p
    return (c[..., None] >> sh) & 1, (c >> g.shape[-1]) & 1


def _carry(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Word sums s_i < 2^33 -> their words carried, and the carry out."""
    w = s & M32
    cin, top = _lookahead(s >> 32, (w == M32).to(torch.int64))
    return (w + cin) & M32, top


def _borrow(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Word differences |d_i| < 2^32 -> their words borrowed, and the
    borrow out."""
    bin_, bout = _lookahead((d < 0).to(torch.int64),
                            (d == 0).to(torch.int64))
    return (d - bin_) & M32, bout


def add(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x + y) mod q. Reference: ``element.go:394``."""
    s, top = _carry(u32(x) + u32(y))
    # s + top * R - q, kept unless it borrows past top
    d, bout = _borrow(s - const_words(spec.q_words, str(s.device)))
    return to_i32(torch.where((top >= bout)[..., None], d, s))


def sub(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x - y) mod q. Reference: ``element.go:434``."""
    d, bout = _borrow(u32(x) - u32(y))
    dq, _ = _carry(d + const_words(spec.q_words, str(d.device)))
    return to_i32(torch.where((bout == 1)[..., None], dq, d))


def neg(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(x), x)


def double(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return add(spec, x, x)


def halve(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """x/2 mod q (q odd). Reference: ``element.go:367``."""
    u = u32(x)
    odd = (u[..., :1] & 1) == 1
    q = const_words(spec.q_words, str(x.device))
    t, top = carry_words(torch.where(odd, u + q, u))
    hi = torch.cat([t[..., 1:], top[..., None]], dim=-1)
    return to_i32((t >> 1) | ((hi & 1) << 31))


def mul(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Montgomery product x * y * R^-1 mod q, broadcasting leading dims.

    CUDA tensors run the ``mont_mul`` kernel, CPU tensors its plain version;
    there is no size threshold."""
    W = spec.n_words
    shape = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    xb = x.expand(*shape, W).reshape(-1, W).contiguous()
    yb = y.expand(*shape, W).reshape(-1, W).contiguous()
    return mont_mul(spec, xb, yb).reshape(*shape, W)


def square(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mul(spec, x, x)


def to_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mul(spec, x, _const(spec, spec.r2_words, x))


def from_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mul(spec, x, _const(spec, int_to_words(1, spec.n_words), x))


def mul_const(spec: FieldSpec, x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c for a plain-int constant c (reference ``MulBy3/5/13``)."""
    if c == 0:
        return torch.zeros_like(x)
    if c == 1:
        return x
    cm = int_to_words(c % spec.modulus * spec.r % spec.modulus, spec.n_words)
    return mul(spec, x, _const(spec, cm, x))


# ---------------------------------------------------------------------------
# vector reductions (reference: Vector.Sum / InnerProduct)
# ---------------------------------------------------------------------------

def sum_reduce(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Modular sum along the leading axis: (N, ..., W) -> (..., W), as a
    pairwise tree of modular adds (every intermediate stays < q)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        red = add(spec, x[:half], x[half:2 * half])
        x = torch.cat([red, x[2 * half:]], dim=0)
    return x[0]


def inner_product(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """<x, y> along the leading axis."""
    return sum_reduce(spec, mul(spec, x, y))


# ---------------------------------------------------------------------------
# predicates / select
# ---------------------------------------------------------------------------

def is_zero(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return torch.all(x == 0, dim=-1)


def equal(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.all(x == y, dim=-1)


def select(spec: FieldSpec, cond: torch.Tensor, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    """cond ? x : y, broadcasting cond over the word dim."""
    return torch.where(cond[..., None], x, y)


# ---------------------------------------------------------------------------
# exponentiation / inversion
# ---------------------------------------------------------------------------

def exp_const(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a Python-int exponent (Montgomery in/out), square-and-
    multiply MSB first (reference ``element.go:748`` Exp).

    CUDA tensors run the whole ladder in one ``exp_const`` kernel launch,
    CPU tensors its plain version (``field/exp.py``)."""
    W = spec.n_words
    flat = x.reshape(-1, W).contiguous()
    return field_exp.exp_const(spec, flat, e).reshape(x.shape)


def inverse(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """x^-1 via Fermat (x^(q-2)); maps 0 -> 0 like the reference Inverse."""
    return exp_const(spec, x, spec.modulus - 2)


def _prefix_products(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the leading axis, log-depth."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], mul(spec, x[d:], x[:-d])], dim=0)
        d *= 2
    return x


def batch_inverse(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Batch inversion along the leading axis; zero entries -> zero
    (matches ``element.go:666`` BatchInvert).

    One Fermat inversion of the total product; each x_i^-1 is the product
    of the others (exclusive prefix times exclusive suffix) over the total.
    The prefix and suffix products are log-depth scans, so the work is
    O(N log N) products in O(log N) batched launches."""
    zmask = is_zero(spec, x)
    one = ones(spec, x.shape[1:-1], device=x.device)
    xe = select(spec, zmask, one.expand_as(x), x)
    pre = _prefix_products(spec, xe)
    suf = _prefix_products(spec, xe.flip(0)).flip(0)
    total_inv = inverse(spec, pre[-1])
    pre_ex = torch.cat([one[None], pre[:-1]], dim=0)
    suf_ex = torch.cat([suf[1:], one[None]], dim=0)
    out = mul(spec, mul(spec, pre_ex, suf_ex), total_inv)
    return select(spec, zmask, torch.zeros_like(out), out)


def legendre(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Euler criterion: x^((q-1)/2), in {0, 1, q-1} (Montgomery form)."""
    return exp_const(spec, x, (spec.modulus - 1) // 2)


# ---------------------------------------------------------------------------
# sqrt
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sqrt_consts(spec: FieldSpec):
    c = 2
    while pow(c, (spec.modulus - 1) // 2, spec.modulus) != spec.modulus - 1:
        c += 1
    return pow(c, spec.t_odd, spec.modulus)  # generator of the 2-Sylow group


def sqrt(spec: FieldSpec, x: torch.Tensor):
    """Square root; returns (root, has_root), root = 0 where none exists.

    q = 3 mod 4: one exponentiation x^((q+1)/4) (reference ``SqrtQ3Mod4``,
    ``element.go:1511``). Otherwise constant-trip masked Tonelli-Shanks
    (reference ``element.go:1584``), every branch a select, as in the JAX
    engine."""
    q = spec.modulus
    if q % 4 == 3:
        cand = exp_const(spec, x, (q + 1) // 4)
        ok = equal(spec, square(spec, cand), x)
        return (select(spec, ok, cand, torch.zeros_like(cand)),
                ok | is_zero(spec, x))
    return _sqrt_tonelli(spec, x)


def _sqrt_tonelli(spec: FieldSpec, x: torch.Tensor):
    s = spec.two_adicity
    bshape = x.shape[:-1]
    one = ones(spec, bshape, device=x.device)
    c = from_int(spec, _sqrt_consts(spec), device=x.device).expand_as(x)
    w = exp_const(spec, x, (spec.t_odd - 1) // 2)
    r = mul(spec, x, w)   # invariant: r^2 = x * b
    b = mul(spec, r, w)   # b = x^t, ord(b) | 2^s
    m = torch.full(bshape, s, dtype=torch.int64, device=x.device)
    for _ in range(s):
        # i = least j >= 0 with b^(2^j) == 1
        val = b
        i_cnt = torch.zeros_like(m)
        seen = torch.zeros(bshape, dtype=torch.bool, device=x.device)
        for _j in range(s):
            seen = seen | equal(spec, val, one)
            i_cnt = i_cnt + (~seen).to(torch.int64)
            val = square(spec, val)
        done = i_cnt == 0  # b == 1
        # f = c^(2^(m-i-1)) by masked repeated squaring
        n_sq = torch.clamp(m - i_cnt - 1, min=0)
        f = c
        for k in range(s):
            f = select(spec, k < n_sq, square(spec, f), f)
        f2 = square(spec, f)
        r = select(spec, done, r, mul(spec, r, f))
        b = select(spec, done, b, mul(spec, b, f2))
        c = select(spec, done, c, f2)
        m = torch.where(done, m, i_cnt)
    ok = equal(spec, square(spec, r), x)
    return select(spec, ok, r, torch.zeros_like(r)), ok | is_zero(spec, x)


# ---------------------------------------------------------------------------
# bytes (gnark-compatible canonical big-endian)
# ---------------------------------------------------------------------------

def to_bytes_host(spec: FieldSpec, x: torch.Tensor, mont: bool = True
                  ) -> list[bytes]:
    """Canonical big-endian fixed-width bytes (``element.go:1000`` Bytes()),
    one per element, vectorized over the batch."""
    if mont:
        x = from_mont(spec, x)
    W, nb = spec.n_words, spec.n_bytes
    arr = x.detach().to("cpu").numpy().reshape(-1, W).view("<u4")
    be = np.ascontiguousarray(arr[:, ::-1]).astype(">u4").view(np.uint8)
    be = be.reshape(-1, 4 * W)[:, 4 * W - nb:]
    return [row.tobytes() for row in be]


def from_bytes_host(spec: FieldSpec, bs, mont: bool = True,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Strict canonical decode to (N, W); raises on >= q (``SetBytes``,
    ``element.go:1018``)."""
    W, nb = spec.n_words, spec.n_bytes
    if any(len(b) != nb for b in bs):
        raise ValueError(f"field element encoding must be {nb} bytes")
    raw = np.frombuffer(b"".join(bs), dtype=np.uint8).reshape(len(bs), nb)
    padded = np.zeros((len(bs), 4 * W), dtype=np.uint8)
    padded[:, 4 * W - nb:] = raw
    be = padded.view(">u4")  # most significant word first
    qbe = np.asarray(spec.q_words[::-1], dtype=np.uint64)
    diff = be != qbe
    first = diff.argmax(axis=1)
    rows = np.arange(len(bs))
    below = diff.any(axis=1) & (be[rows, first] < qbe[first])
    if not below.all():
        raise ValueError("non-canonical field element encoding")
    words = np.ascontiguousarray(be[:, ::-1]).astype("<u4").view(np.int32)
    out = torch.from_numpy(words.copy()).to(device)
    return to_mont(spec, out) if mont else out

