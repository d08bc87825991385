"""Kernel 1: the batched Montgomery product, and its plain PyTorch version.

``mont_mul(spec, x, y)`` on ``(N, W)`` int32 word tensors returns
``x * y * 2^(-32W) mod q``, canonical. A CUDA tensor goes to the hand-written
kernel ``csrc/mont_mul.cu`` (W-word CIOS at W = 8, 10, 12, 20 or 24, one
thread per element; at 8 words also for the 256-bit secp256k1/r1 moduli),
a CPU tensor to :func:`mont_mul_plain`. The two agree bit for bit, because
both return the canonical residue.

The plain version cannot use uint32/uint64 arithmetic (PyTorch on the CPU
has no shifts or compares for them), so it splits each word into two 16-bit
halves held in int64 and runs the same CIOS over 2W half-limbs with lazy
carries: 16 * 2W = 32W, so R is the same. On a CPU tensor, a batch of at
most :data:`SMALL_BATCH` products goes to Python integers instead.

Replaces the Pallas kernel ``gnark_crypto_tpu/field/pallas/mont_mul.py``
``mont_mul``; see the kernel source for its bound on the H100.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnark_crypto_tpu_torch.specs.field import FieldSpec
from gnark_crypto_tpu_torch.utils import build

M16 = 0xFFFF
M32 = 0xFFFFFFFF

# the widths csrc/field.cuh instantiates (gct::for_width): the field,
# exponent, point and VM kernels are built at each
FIELD_WIDTHS = (8, 10, 12, 20, 24)
# the widths at which mont_mul, exp_const and the five G1 point kernels also
# take a modulus that fills all 32W bits, 2^(32W-1) <= q < 2^(32W): the
# 256-bit 8-word fields of secp256k1 and secp256r1 (Fp and Fr). Their CIOS,
# column product, add, sub, halve and reduce_once are exact for any q < R
# (csrc/field.cuh); the VM, NTT and Fp2 kernels keep q < 2^(32W-1), which
# no field that needs them breaks (secp has no pairing, and its Fr has
# 2-adicity 6 and 4)
FULL_WIDTHS = (8,)


# ---------------------------------------------------------------------------
# int64 word helpers shared with field/mont.py
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def const_words(words: tuple[int, ...], device: str) -> torch.Tensor:
    """A cached int64 tensor of unsigned words (never mutate it)."""
    return torch.tensor(words, dtype=torch.int64, device=device)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & M32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 words (two's complement)."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def carry_words(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry/borrow-propagate int64 words (any sign, |t_i| < 2^62).

    Returns the words in [0, 2^32) and the signed carry out of the top word
    (arithmetic shifts floor, so borrows propagate).
    """
    out = torch.empty_like(t)
    c = torch.zeros_like(t[..., 0])
    for i in range(t.shape[-1]):
        v = t[..., i] + c
        out[..., i] = v & M32
        c = v >> 32
    return out, c


def reduce_once(spec: FieldSpec, s: torch.Tensor, top: torch.Tensor
                ) -> torch.Tensor:
    """(s + top * R) - q if that is >= 0, else s; s + top * R < 2q."""
    d, b = carry_words(s - const_words(spec.q_words, str(s.device)))
    return torch.where((b + top >= 0)[..., None], d, s)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _halves(x: torch.Tensor) -> torch.Tensor:
    u = u32(x)
    return torch.stack([u & M16, u >> 16], dim=-1).reshape(
        *x.shape[:-1], 2 * x.shape[-1])


# the largest batch a plain call on CPU tensors computes on Python integers
# instead (below): the CIOS's ~130 tensor ops cost ~1.6 ms whatever the
# batch on the CPU, so a width-1 ladder (a signature, a window fold) spent
# seconds on them; one product on Python integers takes ~0.09 ms. A CUDA
# tensor always runs the CIOS, so that a plain product on the card never
# waits for the host
SMALL_BATCH = 8


def _mont_mul_ints(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor
                   ) -> torch.Tensor:
    """x * y * R^-1 mod q element by element on Python integers."""
    W, q, r_inv = spec.n_words, spec.modulus, spec.r_inv
    x, y = torch.broadcast_tensors(x, y)
    shape = x.shape
    xs = u32(x).reshape(-1, W).tolist()
    ys = u32(y).reshape(-1, W).tolist()
    out = []
    for a, b in zip(xs, ys):
        va = sum(w << (32 * i) for i, w in enumerate(a))
        vb = sum(w << (32 * i) for i, w in enumerate(b))
        v = va * vb * r_inv % q
        out.append([(v >> (32 * i)) & M32 for i in range(W)])
    return to_i32(torch.tensor(out, dtype=torch.int64, device=x.device)
                  ).reshape(shape)


def mont_mul_plain(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor
                   ) -> torch.Tensor:
    """x * y * R^-1 mod q by lazy-carry CIOS on 16-bit halves in int64, or,
    for a batch of at most :data:`SMALL_BATCH` products on CPU tensors, on
    Python integers.

    Broadcasts x and y over their leading dims. Every half-limb stays below
    2 * 2W * 2^32 + carries < 2^40, and m * q below 2^56, so int64 is exact.
    """
    if (x.device.type == "cpu" and y.device.type == "cpu"
            and max(x[..., 0].numel(), y[..., 0].numel()) <= SMALL_BATCH):
        return _mont_mul_ints(spec, x, y)
    L = 2 * spec.n_words
    dev = str(x.device)
    q16 = const_words(
        tuple((spec.modulus >> (16 * i)) & M16 for i in range(L)), dev)
    x16, y16 = torch.broadcast_tensors(_halves(x), _halves(y))
    t = torch.zeros_like(x16)
    for i in range(L):
        t = t + x16[..., i:i + 1] * y16
        m = (t[..., 0] * spec.qinv16) & M16
        t = t + m[..., None] * q16
        c = t[..., 0] >> 16  # the low 16 bits of t_0 are now zero
        t = torch.nn.functional.pad(t[..., 1:], (0, 1))
        t[..., 0] += c
    # words w_i = t_2i + t_2i+1 * 2^16 < 2^56, then one carry pass: < 2q
    w = t[..., 0::2] + (t[..., 1::2] << 16)
    s, top = carry_words(w)
    return to_i32(reduce_once(spec, s, top))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def fills_width(spec: FieldSpec) -> bool:
    """q >= 2^(32W-1): the modulus fills all 32W bits of its words."""
    return bool(spec.modulus >> (32 * spec.n_words - 1))


def check_width(spec: FieldSpec, what: str, widths: tuple[int, ...],
                full_widths: tuple[int, ...] = ()) -> None:
    """Raise unless the kernel ``what``, built for ``widths`` words, takes
    ``spec``: W in widths, and q < 2^(32W - 1) unless W is in
    ``full_widths``, where the kernel takes any q < 2^(32W)
    (:data:`FULL_WIDTHS`)."""
    W = spec.n_words
    full = fills_width(spec)
    if W in widths and (not full or W in full_widths):
        return
    also = "".join(f", or {w} words with q < 2^{32 * w}"
                   for w in full_widths)
    raise NotImplementedError(
        f"{what}: {spec.name} ({W} words, {spec.modulus.bit_length()} "
        f"bits) is not ported to its CUDA kernel, which takes "
        f"{' or '.join(map(str, widths))}-word fields with "
        f"q < 2^(32W-1){also}")


def load_align(n_words: int) -> int:
    """The bytes a kernel loads an element's words in (``csrc/field.cuh``
    ``load_elem``): 16 when W is a multiple of 4, else 8. A 10-word row is
    40 bytes, so every second row of an (N, 10) tensor is 8-byte aligned."""
    return 16 if n_words % 4 == 0 else 8


def check_kernel_args(spec: FieldSpec, what: str, *ts: torch.Tensor,
                      widths: tuple[int, ...],
                      full_widths: tuple[int, ...] = ()) -> None:
    """What every CUDA wrapper checks before a launch: a field of a width
    its kernel was built for (:func:`check_width`), and int32 (N, W)
    tensors, contiguous, aligned to the kernel's loads
    (:func:`load_align`), on one device."""
    check_width(spec, what, widths, full_widths)
    align = load_align(spec.n_words)
    for t in ts:
        if (t.dtype != torch.int32 or t.dim() != 2
                or t.shape[1] != spec.n_words):
            raise ValueError(f"{what}: expected int32 (N, {spec.n_words}), "
                             f"got {t.dtype} {tuple(t.shape)}")
        if (t.device != ts[0].device or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"{what}: tensors must share one device and be "
                             f"contiguous and {align}-byte aligned")


def width_key(spec: FieldSpec):
    """``spec``'s key in a wrapper's ``launches_by_width``: W, or the
    string ``f"{W}full"`` for a modulus that fills all 32W bits
    (:func:`fills_width`), so that a secp256k1/r1 launch is counted apart
    from bn254's 8-word ones."""
    return f"{spec.n_words}full" if fills_width(spec) else spec.n_words


def count_launch(wrapper, spec: FieldSpec) -> None:
    """One launch of ``wrapper``'s kernel at ``spec``'s width: adds one to
    ``wrapper.launches`` (all widths) and to
    ``wrapper.launches_by_width[width_key(spec)]``."""
    wrapper.launches += 1
    by_width = wrapper.launches_by_width
    key = width_key(spec)
    by_width[key] = by_width.get(key, 0) + 1


def mont_mul(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """Montgomery product of two (N, W) int32 tensors on one device."""
    if not x.is_cuda:
        return mont_mul_plain(spec, x, y)
    check_kernel_args(spec, "mont_mul", x, y, widths=FIELD_WIDTHS,
                      full_widths=FULL_WIDTHS)
    if y.shape != x.shape:
        raise ValueError("mont_mul: x and y differ in shape")
    out = torch.empty_like(x)
    fn = build.function("mont_mul", "gct_mont_mul", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    count_launch(mont_mul, spec)
    build.check(fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0],
                   spec.n_words, build.field_words(spec),
                   build.stream_ptr(x)), "mont_mul launch")
    return out


mont_mul.launches = 0
mont_mul.launches_by_width = {}
