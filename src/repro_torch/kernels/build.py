"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The libraries go to ``build/kernels/<hash of the sources>/`` under the
repository root, so an edited source rebuilds and an unchanged one is
reused.  A missing ``nvcc`` or a
failed build raises: there is no fallback.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_REPO = Path(__file__).resolve().parents[3]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
build_info: dict = {}      # name -> {"seconds": ..., "ptxas": ...}; a library
                           # built earlier reports its saved ptxas log


CUDA_ROOTS = ("/usr/local/cuda",)   # searched after PATH and $CUDA_HOME


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME/bin or a CUDA_ROOTS bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc was not found on PATH (nor under $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "src/repro_torch/csrc at first use and have no fallback"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    cus, headers = _sources()
    h = hashlib.sha256()
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _REPO / "build" / "kernels" / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing library (one nvcc per source, in parallel);
    returns {name: path}."""
    nvcc = find_nvcc()
    cus, _ = _sources()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in cus:
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            log = lib.with_suffix(".ptxas.txt")
            build_info.setdefault(src.stem, {
                "seconds": 0.0, "cached": True,
                "ptxas": log.read_text() if log.exists() else ""})
            continue
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {src.stem: out / f"lib{src.stem}.so" for src in cus}


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "approx_topk_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P, _P, _P, _P, _P, _P],
    "persistent_round_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I,
                                _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L, _I,
                               ctypes.c_float, _P],
    "embedding_bag_launch": [_P, _P, _P, _I, _L, _I, _L, _I, _I, _I, _P],
    "embedding_bag_backward_launch": [_P, _I, _L, _L, _P, _L, _L, _P, _P, _L, _I, _L, _I,
                                      _I, _I, _P],
    "embedding_bag_backward_scratch": [_L, _L, _I],
}
_RESTYPES = {"embedding_bag_backward_scratch": _L}   # the others return a cudaError_t


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so`` (building all at first use)."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            lib = ctypes.CDLL(str(paths[name]))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def ptr(t) -> int | None:
    """A tensor's device pointer for ctypes (None for an absent operand)."""
    return None if t is None else t.data_ptr()
