"""Build the port's CUDA sources and load them with ctypes.

New in the port. Each `mscnn_torch/csrc/<name>.cu` has a plain C interface
and is compiled by `nvcc` alone into `mscnn_torch/build/<name>-<hash>.so`
(the directory is git-ignored), keyed by a hash of the source, the
headers of csrc/ and the flags, at first use. `build()` starts one `nvcc`
per source, all at once, and waits for them; `load(name)` builds if
needed and returns the `ctypes.CDLL`. Nothing here runs at import: the
CPU tests import every module of the port on machines with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("nms", "conv1_pool", "int8_gemm", "conv1_v5")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str):
    """(source, library): the library's name hashes the source, every
    header of csrc/ (a source may include any of them) and the flags."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"{name}-{tag}.so")
    return src, lib


def build(names=SOURCES) -> dict:
    """Compile every named source not yet built, in parallel.

    Returns {name: {"seconds": float, "cached": bool, "log": str}}; the
    log holds `ptxas -v` (registers, shared memory, spills). Raises with
    the compiler's output if any build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        src, lib = _paths(name)
        if os.path.exists(lib):
            info[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                      "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    with _lock:
        if name not in _libs:
            _, lib = _paths(name)
            if not os.path.exists(lib):
                build((name,))
            _libs[name] = ctypes.CDLL(lib)
        return _libs[name]
