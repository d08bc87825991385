"""Exponentiation, square roots and sums for the small-field engines.

``field/f31.py`` and ``field/f64.py`` share these algorithms: each takes the
engine module (``ops``) whose ``mul``, ``square``, ``add``, ``ones``,
``from_int``, ``equal``, ``is_zero`` and ``select`` it runs on. They are
plain tensor code on both devices, as the JAX package runs its small-field
ladders outside any kernel (``gnark_crypto_tpu/field/f31.py``,
``gnark_crypto_tpu/field/f64.py``), and they give the same canonical
values: the square root is the same masked constant-trip Tonelli-Shanks,
so it picks the same root.
"""

from __future__ import annotations

import functools

import torch


def exp_const(ops, spec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a Python-int exponent (Montgomery in and out), square and
    multiply MSB first; e = 0 gives one."""
    if e < 0:
        raise ValueError("exponent must be non-negative")
    res = ops.ones(spec, ops.eshape(x), device=x.device)
    for i in range(e.bit_length() - 1, -1, -1):
        res = ops.square(spec, res)
        if (e >> i) & 1:
            res = ops.mul(spec, res, x)
    return res


@functools.lru_cache(maxsize=None)
def _sylow_generator(q: int, t_odd: int) -> int:
    """c^t for the least non-residue c: a generator of the 2-Sylow group."""
    c = 2
    while pow(c, (q - 1) // 2, q) != q - 1:
        c += 1
    return pow(c, t_odd, q)


def sqrt(ops, spec, x: torch.Tensor):
    """Square root; returns (root, has_root), root = 0 where none exists.

    q = 3 mod 4: x^((q+1)/4). Otherwise the reference's masked
    constant-trip Tonelli-Shanks, every branch a select."""
    q = spec.modulus
    if q % 4 == 3:
        cand = exp_const(ops, spec, x, (q + 1) // 4)
        ok = ops.equal(spec, ops.square(spec, cand), x)
        return (ops.select(spec, ok, cand, torch.zeros_like(cand)),
                ok | ops.is_zero(spec, x))
    s = spec.two_adicity
    bshape = ops.eshape(x)
    one = ops.ones(spec, bshape, device=x.device)
    c = ops.from_int(spec, _sylow_generator(q, spec.t_odd),
                     device=x.device).expand_as(x)
    w = exp_const(ops, spec, x, (spec.t_odd - 1) // 2)
    r = ops.mul(spec, x, w)   # invariant: r^2 = x * b
    b = ops.mul(spec, r, w)   # b = x^t, ord(b) | 2^s
    m = torch.full(bshape, s, dtype=torch.int64, device=x.device)
    for _ in range(s):
        # i = least j >= 0 with b^(2^j) == 1
        val = b
        i_cnt = torch.zeros_like(m)
        seen = torch.zeros(bshape, dtype=torch.bool, device=x.device)
        for _j in range(s):
            seen = seen | ops.equal(spec, val, one)
            i_cnt = i_cnt + (~seen).to(torch.int64)
            val = ops.square(spec, val)
        done = i_cnt == 0
        # f = c^(2^(m-i-1)) by masked repeated squaring
        n_sq = torch.clamp(m - i_cnt - 1, min=0)
        f = c
        for k in range(s):
            f = ops.select(spec, k < n_sq, ops.square(spec, f), f)
        f2 = ops.square(spec, f)
        r = ops.select(spec, done, r, ops.mul(spec, r, f))
        b = ops.select(spec, done, b, ops.mul(spec, b, f2))
        c = ops.select(spec, done, c, f2)
        m = torch.where(done, m, i_cnt)
    ok = ops.equal(spec, ops.square(spec, r), x)
    return (ops.select(spec, ok, r, torch.zeros_like(r)),
            ok | ops.is_zero(spec, x))


def sum_reduce(ops, spec, x: torch.Tensor) -> torch.Tensor:
    """Modular sum along the leading axis as a pairwise tree of modular
    adds (every intermediate stays canonical)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        red = ops.add(spec, x[:half], x[half:2 * half])
        x = torch.cat([red, x[2 * half:]], dim=0)
    return x[0]
