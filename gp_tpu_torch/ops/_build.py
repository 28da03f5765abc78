"""Build and load the package's CUDA kernels.

Each source `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a)
into a shared library with a plain C interface, then loaded with ctypes.
Nothing is built at import: the first launch on a CUDA tensor builds what
it needs.  Libraries go to `gp_tpu_torch/_build/` (git-ignored), named by
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  `build()` starts one nvcc per source, all at
once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# every kernel source of the package
SOURCES = ("se_tile", "chol_block")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, ptxas_info: bool = False):
    """Compile every missing library of `names` in parallel.

    Returns (seconds, log): the wall time of the builds and, with
    ptxas_info, what `-Xptxas -v` printed (registers, shared memory and
    spills of each kernel).  Raises with nvcc's output if one fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_info:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info
                                      else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, out, tmp, p in procs:
        text, _ = p.communicate()
        logs.append(f"[{name}]\n{text}")
        if p.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    return time.perf_counter() - t0, "\n".join(logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
