"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use with ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``
(``build_all`` starts one ``nvcc`` per source, all at once):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an unchanged one is loaded from ``build/kernels/``
(listed in ``.gitignore``).  No ``--use_fast_math``: the kernels must round
exactly as the plain versions do.  There is no fallback: a missing
``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "nvcc_path", "build",
           "build_all", "load", "launch", "stream_handle"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = ("lorenzo", "entropy", "flash_attn", "flash_attn_sm90")

_LOCK = threading.Lock()
_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler, or RuntimeError: kernels are never skipped."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from csrc/ on first use and have no fallback"
    )


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    library's ``path``, the compile ``seconds`` (0 when cached) and the
    ``ptxas`` resource lines."""
    with _LOCK:
        return _finish(_start(name))


def _start(name: str):
    """(name, output path, process or None when built already, start time)."""
    out = _lib_path(name)
    if out.exists():
        return name, out, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, out, proc, time.perf_counter()


def _finish(started) -> dict:
    name, out, proc, t0 = started
    if proc is None:
        return {"path": out, "seconds": 0.0, "ptxas": ""}
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{log}")
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)  # atomic for other loaders
    return {"path": out, "seconds": time.perf_counter() - t0, "ptxas": log}


def build_all(names=SOURCES) -> dict:
    """Build every named source at once (one ``nvcc`` each, started
    together); ``name -> build()``'s record."""
    with _LOCK:
        started = [_start(name) for name in names]
        return {s[0]: _finish(s) for s in started}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` from ``signatures`` (C function -> ctypes argument types)
    and an int return (a ``cudaError_t``) on every function."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_finish(_start(name))["path"]))
            for fn, args in signatures.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
        return lib


def stream_handle() -> int:
    """The raw handle of the current device's current CUDA stream: what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    ``torch.cuda.Stream`` object on every call (a wrapper that takes
    look-back scratch asks twice)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(lib: ctypes.CDLL, fn: str, *args) -> None:
    """Call C entry point ``fn`` on the current CUDA stream; raise on a
    nonzero ``cudaError_t``.  The caller allocates outputs and scratch on
    that stream; scratch freed on return is safe, because the caching
    allocator hands its memory only to work queued later on the same
    stream."""
    import torch

    err = getattr(lib, fn)(*args, stream_handle())
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
