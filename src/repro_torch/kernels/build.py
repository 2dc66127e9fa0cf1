"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The top-k sources are compiled more than once (``VARIANTS``), each build
instantiating part of the sweep's payload kinds into a library of its own
(``lib<name>.so``, ``lib<name>_coded.so``, ...): the longest nvcc sets
the build's time.

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

# sources built more than once: {source stem: {library: payload kinds}}, the
# kinds (topk_common.cuh's PayloadKind: 0 fp32, 1 int8, 2 bf16, 3 fp8, 4
# int4) a build instantiates (nvcc -DADACUR_KINDS=<bitmask>); the two-list
# persistent sweep, the slowest to compile, in three builds
_TWO = {"": (0, 1), "_coded": (2, 3, 4)}
VARIANTS = {"approx_topk": _TWO, "approx_topk_large": _TWO,
            "persistent_round": {"": (0, 1), "_coded": (2, 3), "_int4": (4,)}}
VARIANTS = {stem: {stem + suffix: kinds for suffix, kinds in v.items()}
            for stem, v in VARIANTS.items()}

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
    h.update(repr(VARIANTS).encode())
    return _REPO / "build" / "kernels" / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing library (one nvcc per source, in parallel);
    returns {name: path}."""
    nvcc = find_nvcc()
    cus, _ = _sources()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, name, flags in _libraries(cus):
        lib = out / f"lib{name}.so"
        if lib.exists():
            log = lib.with_suffix(".ptxas.txt")
            build_info.setdefault(name, {
                "seconds": 0.0, "cached": True,
                "ptxas": log.read_text() if log.exists() else ""})
            continue
        tmp = out / f".lib{name}.{os.getpid()}.so"
        log_path = out / f".lib{name}.{os.getpid()}.log"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", str(tmp), str(src)]
        with open(log_path, "w") as log_file:
            procs[name] = (subprocess.Popen(
                cmd, stdout=log_file, stderr=subprocess.STDOUT, text=True
            ), tmp, lib, log_path, time.perf_counter())
    ended = {}                      # each nvcc's own wall seconds
    while len(ended) < len(procs):
        for name, (proc, *_, t0) in procs.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter() - t0
        time.sleep(0.05)
    failed = []
    for name, (proc, tmp, lib, log_path, _) in procs.items():
        log = log_path.read_text()
        log_path.unlink()
        build_info[name] = {"seconds": ended[name], "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"--- lib{name} (exit {proc.returncode}) ---\n{log}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: out / f"lib{name}.so" for _, name, _ in _libraries(cus)}


def _libraries(cus):
    """(source, library name, extra nvcc flags) of every library to build."""
    out = []
    for src in cus:
        if src.stem not in VARIANTS:
            out.append((src, src.stem, []))
            continue
        for name, kinds in VARIANTS[src.stem].items():
            mask = sum(1 << k for k in kinds)
            out.append((src, name, [f"-DADACUR_KINDS={mask:#x}"]))
    return out


def topk_library(stem: str, kind: int) -> str:
    """The library of a top-k source (``VARIANTS``) built for payload kind
    ``kind``."""
    return next(name for name, kinds in VARIANTS[stem].items() if kind in kinds)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "approx_topk_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P, _P, _P, _P, _P, _P],
    "approx_topk_large_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
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
    "tensor_product_launch": [_P, _P, _P, _P, _P, _L, _I, _P],
    "tensor_product_backward_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P],
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
