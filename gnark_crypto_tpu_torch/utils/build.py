"""Builds the CUDA kernels of ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` (a plain C interface, no
PyTorch headers), compiled by ``nvcc`` for ``sm_90a``; all sources compile in
parallel at first use into ``_build/<hash>/`` inside this package, where the
hash covers every source and the flags, so an edited source rebuilds. There
is no fallback: a missing ``nvcc`` or a failed build raises.

The wrappers pass device pointers and the stream as ``ctypes.c_void_p``;
every entry point returns the CUDA error code of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
# --split-compile=0: one source's device code is optimised and assembled
# on every core (the 12-word Fp2 point kernels take minutes on one)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
# wall seconds of each source's nvcc in this process's build, from its start
# to its end, every source compiling at once (name -> s)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that is not built yet, all in parallel,
    and return the build directory.

    Writes ``nvcc``'s report (``-Xptxas -v``: registers, shared memory,
    spills) beside each library as ``lib<name>.log``, and each source's
    nvcc wall seconds, from its own start to its end while every other
    source compiles beside it, into :data:`build_seconds`.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            lib = out / f"lib{src.stem}.so"
            if lib.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out / f".lib{src.stem}.{os.getpid()}.so"
            log = out / f"lib{src.stem}.log"
            with open(log, "w") as fh:
                start = time.perf_counter()
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                     str(src)], stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((src, lib, tmp, log, proc, start))
    finally:
        codes, pending = [], list(jobs)
        while pending:  # each source's seconds as it finishes
            for job in [j for j in pending if j[4].poll() is not None]:
                build_seconds[job[0].name] = time.perf_counter() - job[5]
                codes.append((job, job[4].returncode))
                pending.remove(job)
            time.sleep(0.05)
    failed = []
    for (src, lib, tmp, log, _, _), rc in codes:
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src.name} (rc {rc}):\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def _library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """``lib<lib_name>.so``'s ``fn_name`` with its argtypes, returning int."""
    key = f"{lib_name}:{fn_name}"
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(_library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def field_words(spec) -> ctypes.Array:
    """q's words then -q^-1 mod 2^32, as the kernels' ``field_words``."""
    return (ctypes.c_uint32 * (spec.n_words + 1))(*spec.q_words, spec.qinv32)


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
