"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process into a shared
library with a plain C interface, all processes started together, and
loaded with ``ctypes``.  Outputs go to ``_build/<hash of the sources and
flags>/`` inside the package (listed in ``.gitignore``), so a checkout
builds everything at first use and a changed source rebuilds.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
SOURCES = ("resample", "mix_mode_a")

# -fmad=false: the plain PyTorch twins round every product and sum on
# its own; FMA contraction would move the kernels off them by an ulp.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if nvcc is None and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (neither on PATH nor under {cuda_home}/bin): the "
            "port's CUDA kernels are built from csrc/ at first use and need "
            "the CUDA toolkit"
        )
    return nvcc


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built (in parallel); return the paths
    of the shared libraries.  The compiler's resource report (registers,
    spills) goes to ``<build dir>/<name>.log``."""
    out = _build_dir()
    libs = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not libs[n].exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, log,
        )
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n{(out / f'{name}.log').read_text()}")
        else:
            os.replace(tmp, libs[name])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one source, built on first use."""
    return ctypes.CDLL(str(build_all()[name]))


def build_seconds() -> float:
    """Build (or find) every kernel library; return the seconds it took."""
    t0 = time.perf_counter()
    for name in SOURCES:
        load_library(name)
    return time.perf_counter() - t0


def check_tensor(t, name, dtype, shape=None) -> None:
    """What a kernel takes: a contiguous CUDA tensor of `dtype` (and
    `shape`, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} (got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
