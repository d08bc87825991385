"""The 256-bit 8-word fields (secp256k1 and secp256r1 Fp and Fr) in the
port's kernels and plain versions, on the CPU.

* The CUDA sources on the host: ``csrc/field.cuh`` (through a small
  harness), ``csrc/mont_mul.cu``, ``csrc/point_add.cu`` and
  ``csrc/affine_level.cu`` (with their ``point.cuh`` cores) built with g++
  against a stub ``cuda_runtime.h``, each launch rewritten into host loops
  over blocks and threads, the PTX carry chains through their host
  branches. The CIOS, the column product, ``add_mod``, ``sub_mod``,
  ``halve_mod`` and ``reduce_once`` on 12 edge operands (every pair) and
  4,000 random pairs against Python integers, for 2^255 <= q < 2^256 and
  two controls below; the point kernels (add, double, the affine level
  and the window fold) for a = 0 (secp256k1) and a = -3 (secp256r1)
  through the port's own wrappers, against their plain versions and a
  Python-int curve. Skipped only where no g++ exists.
* Which wrappers take q >= 2^255 (``mont_mul``, ``exp_const`` and the five
  G1 point kernels, counted under the ``"8full"`` width) and which refuse
  it before any launch (the VM, the NTT and the Fp2 kernels).
* The port's plain field ops on secp Fp and Fr against the JAX engine as
  canonical integers, and the plain product's two forms (Python integers
  for up to eight products, the CIOS for a larger batch) against each
  other.

The tolerance is 0: every value is a canonical residue.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gnark_crypto_tpu.field import mont as jmont
from gnark_crypto_tpu.specs import field as jfs
from gnark_crypto_tpu_torch import convert
from gnark_crypto_tpu_torch.curve.jacobian import Affine, Jac, curve_ops
from gnark_crypto_tpu_torch.field import exp, kernels, mont, point_add
from gnark_crypto_tpu_torch.field import point_add2, vm
from gnark_crypto_tpu_torch.ntt import four_step, radix2
from gnark_crypto_tpu_torch.specs import curve as tcs
from gnark_crypto_tpu_torch.specs import field as tfs
from gnark_crypto_tpu_torch.utils import build
from tests.test_curve_g1 import oracle_add, oracle_mul

CPU = "cpu"
FULL = ["secp256k1_fp", "secp256k1_fr", "secp256r1_fp", "secp256r1_fr"]
# below the full width: bn254 Fp (8 words) and bls12-381 Fp (12)
CONTROLS = ["bn254_fp", "bls12_381_fp"]
CURVES = ["secp256k1_g1", "secp256r1_g1"]   # a = 0 and a = -3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the CPU; the plain versions are many small tensor ops)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def edge_values(spec) -> list[int]:
    """0, 1, 2, q-1, q-2, q-3, (q-1)/2, (q+1)/2, 2^(32W-1), 2^(32W-1) - 1 and
    2^(32W) - 1 reduced mod q, and q - 2^32."""
    q, bits = spec.modulus, 32 * spec.n_words
    return [0, 1, 2, q - 1, q - 2, q - 3, (q - 1) // 2, (q + 1) // 2,
            (1 << (bits - 1)) % q, ((1 << (bits - 1)) - 1) % q,
            ((1 << bits) - 1) % q, q - (1 << 32)]


def operand_pairs(spec, n_random: int = 4000, seed: int = 7):
    rng = np.random.default_rng(seed)
    edge = edge_values(spec)
    a = [u for u in edge for _ in edge]
    b = [v for _ in edge for v in edge]
    q = spec.modulus
    rnd = [int.from_bytes(rng.bytes(4 * spec.n_words), "little") % q
           for _ in range(2 * n_random)]
    return a + rnd[:n_random], b + rnd[n_random:]


def words(spec, vals) -> np.ndarray:
    buf = b"".join(v.to_bytes(4 * spec.n_words, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), spec.n_words)


def ints(arr: np.ndarray) -> list[int]:
    return [int.from_bytes(row.astype("<u4").tobytes(), "little")
            for row in arr]


# -- the host build ----------------------------------------------------------

STUB = r"""
#pragma once
#include <cstdint>
#include <functional>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostDim { unsigned x = 0, y = 0, z = 0; };
inline HostDim blockIdx, threadIdx, blockDim;
// a launch: every thread of every block in turn (the kernels built here
// use no barrier, shuffle or shared memory)
inline void host_launch(long long grid, long long block,
                        const std::function<void()>& body) {
  blockDim.x = (unsigned)block;
  for (long long b = 0; b < grid; ++b)
    for (long long t = 0; t < block; ++t) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = (unsigned)t;
      body();
    }
}
"""

# field.cuh's ops one element at a time: 0 the CIOS, 1 the column product,
# 2 add_mod, 3 sub_mod, 4 halve_mod(a), 5 reduce_once(a, top = b's bit 0)
HARNESS = r"""
#include "field.cuh"
extern "C" int gct_field_op(int op, const uint32_t* a, const uint32_t* b,
                            uint32_t* out, long long n, int n_words,
                            const uint32_t* field_words) {
  return gct::for_width(n_words, [&](auto width) {
    constexpr int W = decltype(width)::value;
    const gct::FieldConstT<W> fc = gct::field_const<W>(field_words);
    for (long long i = 0; i < n; ++i) {
      const auto x = gct::load_elem<W>(a + i * W);
      const auto y = gct::load_elem<W>(b + i * W);
      gct::ElemT<W> r;
      switch (op) {
        case 0: r = gct::mont_mul(x, y, fc); break;
        case 1: r = gct::mont_mul_ilp(x, y, fc); break;
        case 2: r = gct::add_mod(x, y, fc); break;
        case 3: r = gct::sub_mod(x, y, fc); break;
        case 4: r = gct::halve_mod(x, fc); break;
        default: r = gct::reduce_once(x, y.w[0] & 1u, fc); break;
      }
      gct::store_elem(out + i * W, r);
    }
    return 0;
  });
}
"""

# k<<<grid, block, ...>>>(args); -> host_launch(grid, block, [&] { k(args); });
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
SOURCES = ("mont_mul", "point_add", "affine_level")


def host_source(text: str) -> str:
    def launch(m):
        grid, block = (a.strip() for a in m.group(2).split(",")[:2])
        return (f"host_launch({grid}, {block}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    out, n = LAUNCH.subn(launch, text)
    assert n > 0, "no launch found to rewrite"
    return out


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{name: ctypes library} of the host builds (g++ -O1, in parallel)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    d = tmp_path_factory.mktemp("host_cuda")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "field_ops.cpp").write_text(HARNESS)
    for name in SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        (d / f"{name}.cpp").write_text(host_source(text))
    procs = {name: subprocess.Popen(
        [gxx, "-std=c++17", "-O1", "-w", "-shared", "-fPIC", "-I", str(d),
         "-I", str(build.CSRC), "-o", str(d / f"lib{name}.so"),
         str(d / f"{name}.cpp")], stderr=subprocess.PIPE, text=True)
        for name in (*SOURCES, "field_ops")}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"g++ {name}: {err}"
    return {name: ctypes.CDLL(str(d / f"lib{name}.so")) for name in procs}


@pytest.fixture
def host_card(host_libs, monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, into the host builds:
    ``is_cuda`` reads True, ``build.function`` loads from the host
    libraries, the stream is 0."""

    def function(lib, name, argtypes):
        fn = getattr(host_libs[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_ptr", lambda x: 0)
    return host_libs


def field_op(libs, op: int, spec, a, b) -> list[int]:
    x, y = words(spec, a), words(spec, b)
    out = np.zeros_like(x)
    ptr = ctypes.c_void_p
    assert libs["field_ops"].gct_field_op(
        ctypes.c_int(op), ptr(x.ctypes.data), ptr(y.ctypes.data),
        ptr(out.ctypes.data), ctypes.c_longlong(len(a)),
        ctypes.c_int(spec.n_words), build.field_words(spec)) == 0
    return ints(out)


@pytest.mark.parametrize("name", FULL + CONTROLS)
def test_host_field_ops_exact(host_libs, name):
    """The CIOS, the column product, add, sub, halve and reduce_once of
    ``field.cuh`` on every pair of the edge operands and 4,000 random
    pairs equal Python integers (Montgomery products as x y R^-1)."""
    spec = tfs.get_field(name)
    q, R = spec.modulus, 1 << (32 * spec.n_words)
    assert kernels.fills_width(spec) == (name in FULL)
    a, b = operand_pairs(spec)
    r_inv = pow(R, -1, q)
    prod = [u * v * r_inv % q for u, v in zip(a, b)]
    assert field_op(host_libs, 0, spec, a, b) == prod
    assert field_op(host_libs, 1, spec, a, b) == prod
    assert field_op(host_libs, 2, spec, a, b) == [(u + v) % q
                                                 for u, v in zip(a, b)]
    assert field_op(host_libs, 3, spec, a, b) == [(u - v) % q
                                                 for u, v in zip(a, b)]
    half = pow(2, -1, q)
    assert field_op(host_libs, 4, spec, a, b) == [u * half % q for u in a]
    # reduce_once of s = u + v < 2q, given as s mod R and its top bit
    s = [u + v for u, v in zip(a, b)]
    got = field_op(host_libs, 5, spec, [t % R for t in s],
                   [t // R for t in s])
    assert got == [t % q for t in s]
    if name in FULL:  # the top word is set on some of these sums
        assert any(t >= R for t in s)


@pytest.mark.parametrize("name", FULL + CONTROLS[:1])
def test_host_mont_mul_kernel_matches_plain(host_card, name):
    """``mont_mul.cu`` through the ``mont_mul`` wrapper (counted under its
    width key) equals the plain version and Python integers."""
    spec = tfs.get_field(name)
    a, b = operand_pairs(spec, n_random=500, seed=11)
    x = mont.from_int(spec, a, device=CPU)
    y = mont.from_int(spec, b, device=CPU)
    with pytest.MonkeyPatch.context() as m:   # the plain version first
        m.setattr(torch.Tensor, "is_cuda", property(lambda s: False))
        want = kernels.mont_mul_plain(spec, x, y)
    key = kernels.width_key(spec)
    assert key == ("8full" if name in FULL else 8)
    before = kernels.mont_mul.launches_by_width.get(key, 0)
    got = kernels.mont_mul(spec, x, y)
    assert kernels.mont_mul.launches_by_width[key] == before + 1
    assert torch.equal(got, want)
    q = spec.modulus
    assert mont.to_int(spec, got) == [u * v % q for u, v in zip(a, b)]


def edge_points(curve, n: int, seed: int):
    """Two (n,) Python-int point lists (None = infinity): random multiples
    of G, with P + P, P + (-P), P + inf, inf + Q and inf + inf lanes."""
    p, a = curve.spec.fp.modulus, curve.spec.a % curve.spec.fp.modulus
    g = (curve.spec.gx % p, curve.spec.gy % p)
    rng = np.random.default_rng(seed)
    base = [oracle_mul(g, int(k), p, a)
            for k in rng.integers(1, 1 << 62, size=12)]
    ps, qs = [], []
    for i in range(n):
        j = int(rng.integers(len(base)))
        u, v = base[j], base[int(rng.integers(len(base)))]
        kind = i % 8
        if kind == 0:
            v = u
        elif kind == 1:
            v = (u[0], -u[1] % p)
        elif kind == 2:
            v = None
        elif kind == 3:
            u = None
        elif kind == 4:
            u = v = None
        ps.append(u)
        qs.append(v)
    return ps, qs


def affine_of(curve, pts) -> Affine:
    f = curve.fp
    return Affine(f.from_int([0 if t is None else t[0] for t in pts],
                             device=CPU),
                  f.from_int([0 if t is None else t[1] for t in pts],
                             device=CPU))


def jac_ints(curve, pt) -> list:
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.Tensor, "is_cuda", property(lambda s: False))
        aff = curve.to_affine(Jac(*pt))
    xs, ys = (mont.to_int(curve.spec.fp, c) for c in aff)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", CURVES)
def test_host_point_kernels_match_plain(host_card, name):
    """``point_add.cu`` and ``affine_level.cu`` through the five G1 point
    wrappers on secp256k1 (a = 0) and secp256r1 (a = -3): every output
    equals the plain version bit for bit, the adds and doubles equal a
    Python-int curve, and each launch counts under ``"8full"``."""
    curve = curve_ops(tcs.get_curve(name))
    spec, a_int = curve.spec.fp, curve.spec.a
    p, a = spec.modulus, a_int % spec.modulus
    assert kernels.fills_width(spec)
    ps, qs = edge_points(curve, 40, seed=3)
    P, Q = curve.from_affine(affine_of(curve, ps)), \
        curve.from_affine(affine_of(curve, qs))
    Pa, Qa = affine_of(curve, ps), affine_of(curve, qs)
    wrappers = [point_add.jac_add, point_add.jac_double,
                point_add.affine_prep, point_add.affine_finish,
                point_add.jac_fold_windows]
    before = [w.launches_by_width.get("8full", 0) for w in wrappers]
    rng = torch.Generator().manual_seed(5)
    treebits = torch.randint(0, 8, (len(ps),), generator=rng,
                             dtype=torch.int32)
    calls = {
        "jac_add": (spec, a_int, *P, *Q),
        "jac_double": (spec, a_int, *P),
        "affine_prep": (spec, a_int, *Pa, *Qa),
        "jac_fold_windows": (spec, a_int, P.x[:5], P.y[:5], P.z[:5], 3)}
    with pytest.MonkeyPatch.context() as m:   # plain versions first
        m.setattr(torch.Tensor, "is_cuda", property(lambda s: False))
        plain = {k: getattr(point_add, f"{k}_plain")(*args)
                 for k, args in calls.items()}
        den, num, bits = plain["affine_prep"]
        dinv = mont.batch_inverse(spec, den)
        calls["affine_finish"] = (spec, a_int, *Qa, *Pa, *Qa, *Pa, num,
                                  dinv, bits, treebits)
        plain["affine_finish"] = point_add.affine_finish_plain(
            *calls["affine_finish"])
    for k, args in calls.items():
        got = getattr(point_add, k)(*args)
        for i, (u, v) in enumerate(zip(got, plain[k])):
            assert torch.equal(u, v), f"{name} {k} output {i}"
    assert [w.launches_by_width["8full"] - b
            for w, b in zip(wrappers, before)] == [1] * 5
    # the kernels' adds, doubles and the fold against Python integers
    got_add = jac_ints(curve, point_add.jac_add(*calls["jac_add"]))
    assert got_add == [oracle_add(u, v, p, a) for u, v in zip(ps, qs)]
    got_dbl = jac_ints(curve, point_add.jac_double(*calls["jac_double"]))
    assert got_dbl == [oracle_add(u, u, p, a) for u in ps]
    want = None
    for t in reversed(ps[:5]):   # sum_w 2^(3w) T_w, by Horner
        want = oracle_add(oracle_mul(want, 8, p, a), t, p, a)
    fold = point_add.jac_fold_windows(*calls["jac_fold_windows"])
    assert jac_ints(curve, fold) == [want]


# -- which wrappers take q >= 2^255 ------------------------------------------

class FakeLib:
    """A built entry point's stand-in: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("name", FULL)
def test_full_width_admission(name, monkeypatch):
    """On a (faked) card ``mont_mul``, ``exp_const`` and the five G1 point
    wrappers launch for a 256-bit 8-word field, counted under ``"8full"``
    apart from bn254's 8-word launches; the VM, the three NTT wrappers and
    the five Fp2 wrappers raise ``NotImplementedError`` before any
    launch."""
    libs = {}
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    monkeypatch.setattr(build, "function",
                        lambda lib, fn, argtypes: libs.setdefault(
                            fn, FakeLib()))
    monkeypatch.setattr(build, "stream_ptr", lambda x: 0)
    spec = tfs.get_field(name)
    x = torch.zeros((16, 8), dtype=torch.int32)
    bits = torch.zeros((16,), dtype=torch.int32)
    admitted = {
        kernels.mont_mul: lambda: kernels.mont_mul(spec, x, x),
        exp.exp_const: lambda: exp.exp_const(spec, x, spec.modulus - 2),
        point_add.jac_add: lambda: point_add.jac_add(spec, -3, *[x] * 6),
        point_add.jac_double: lambda: point_add.jac_double(spec, 0, x, x, x),
        point_add.affine_prep: lambda: point_add.affine_prep(
            spec, 0, x, x, x, x),
        point_add.affine_finish: lambda: point_add.affine_finish(
            spec, 0, *[x] * 10, bits, bits),
        point_add.jac_fold_windows: lambda: point_add.jac_fold_windows(
            spec, 0, x, x, x, 4)}
    for w, call in admitted.items():
        n8 = w.launches_by_width.get(8, 0)
        full = w.launches_by_width.get("8full", 0)
        call()
        assert w.launches_by_width["8full"] == full + 1
        assert w.launches_by_width.get(8, 0) == n8
    (_, _, _, n_words, fw, one, ew, nbits, _), = libs["gct_exp_const"].calls
    assert n_words == 8 and list(fw)[:8] == list(spec.q_words)
    assert nbits == (spec.modulus - 2).bit_length()
    prog = vm.schedule(vm.random_program(spec, 40, seed=1), 8)
    state = torch.zeros((prog.n_entry, prog.tile, 8), dtype=torch.int32)
    tw = x[:8]
    x2 = torch.zeros((16, 2, 8), dtype=torch.int32)
    refused = [
        lambda: vm.vm_execute(prog, state),
        lambda: radix2.stage(spec, x, tw, 4, 0, False),
        lambda: radix2.block(spec, x, tw, 0, 4, True),
        lambda: four_step.sub_ntt(spec, x, tw, 2, 4, True, False),
        lambda: point_add2.jac_add2(spec, -1, *[x2] * 6),
        lambda: point_add2.jac_double2(spec, -1, *[x2] * 3),
        lambda: point_add2.affine_prep2(spec, -1, *[x2] * 4),
        lambda: point_add2.affine_finish2(spec, -1, *[x2] * 10, bits, bits),
        lambda: point_add2.jac_fold_windows2(spec, -1, *[x2] * 3, 4)]
    n_calls = sum(len(f.calls) for f in libs.values())
    for call in refused:
        with pytest.raises(NotImplementedError, match="q < 2"):
            call()
    assert sum(len(f.calls) for f in libs.values()) == n_calls


def test_exp_team_product_refuses_full_width():
    """``exp.cu`` refuses a q that fills 32W bits at the widths where its
    product is a team of lanes, whose top carry it drops; at 8 words (the
    one full width the wrappers admit) the product is the lone lane's."""
    text = (build.CSRC / "exp.cu").read_text()
    assert "constexpr int kTeam = W == 8 ? 1 : 4;" in text
    assert "if (kTeam<W> > 1 && (field_words[W - 1] >> 31))" in text
    assert kernels.FULL_WIDTHS == (8,)


# -- the plain field ops against the JAX engine ------------------------------

@pytest.mark.parametrize("name", FULL)
def test_plain_ops_match_jax(name):
    """add, sub, mul, neg, double, halve, square, inverse, legendre, sqrt
    and exp_const of the port (plain versions) equal the JAX engine's on
    the edge values and random ones, as canonical integers."""
    t, j = tfs.get_field(name), jfs.get_field(name)
    q = t.modulus
    rng = np.random.default_rng(13)
    a = edge_values(t) + [int.from_bytes(rng.bytes(32), "little") % q
                          for _ in range(4)]
    b = a[::-1]
    ja, jb = jmont.from_int(j, a), jmont.from_int(j, b)
    ta = convert.from_jax_limbs(t, np.asarray(ja), device=CPU)
    tb = convert.from_jax_limbs(t, np.asarray(jb), device=CPU)
    assert mont.to_int(t, ta) == [v % q for v in a]

    def same(jx, tx):
        return jmont.to_int(j, jx) == mont.to_int(t, tx)

    for op in ("add", "sub", "mul"):
        assert same(getattr(jmont, op)(j, ja, jb),
                    getattr(mont, op)(t, ta, tb)), op
    for op in ("neg", "double", "halve", "square", "inverse", "legendre"):
        assert same(getattr(jmont, op)(j, ja), getattr(mont, op)(t, ta)), op
    e = (1 << 300) + 12345   # past 2^256: the exponent's reduction
    assert same(jmont.exp_const(j, ja, e), mont.exp_const(t, ta, e))
    root, ok = mont.sqrt(t, mont.square(t, ta))
    assert bool(ok.all())
    assert mont.to_int(t, mont.square(t, root)) == [v * v % q for v in a]


@pytest.mark.parametrize("name", FULL + CONTROLS)
def test_plain_product_forms_agree(name):
    """Plain products in batches of at most eight (Python integers) equal the
    same products in a larger batch (the CIOS on 16-bit halves), on every
    edge pair."""
    spec = tfs.get_field(name)
    a, b = operand_pairs(spec, n_random=0)
    x = mont.from_int(spec, a, device=CPU)
    y = mont.from_int(spec, b, device=CPU)
    batch = kernels.mont_mul_plain(spec, x, y)
    assert len(a) > kernels.SMALL_BATCH == 8
    for i in range(0, len(a), 13):
        few = kernels.mont_mul_plain(spec, x[i:i + 8], y[i:i + 8])
        assert torch.equal(few, batch[i:i + 8])
        one = kernels.mont_mul_plain(spec, x[i], y[i:i + 1])  # broadcast
        assert torch.equal(one, batch[i:i + 1])
