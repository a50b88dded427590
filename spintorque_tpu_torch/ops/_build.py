"""Build of the port's CUDA kernels into one shared library.

``csrc/*.cu`` (with the headers beside them) compile with ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/libspintorque_kernels_<sha>.so``
at the root of the checkout, where ``<sha>`` hashes the sources and the
flags, so an edit rebuilds and an unchanged tree reuses the library. The
library has a plain C interface and is loaded with ctypes; it does not
include PyTorch's headers, so the build takes seconds.

Flags: no ``--use_fast_math`` and ``--fmad=false``, because the kernels are
held to their plain PyTorch versions to a few ulps, and true division,
``sqrtf`` and unfused products are part of that.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


class KernelLibrary:
    """A loaded kernel library with its build record."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when the library was reused
        self.log = log  # nvcc's output, including ptxas register counts


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH; "
        "the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


_LIBRARY: Optional[KernelLibrary] = None


def load_library() -> KernelLibrary:
    """Build the library if needed (once per source digest) and load it."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out = BUILD_DIR / f"libspintorque_kernels_{source_digest()}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(CSRC))
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.is_file() else ""
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _LIBRARY = KernelLibrary(lib, out, seconds, log)
    return _LIBRARY


def _bind(lib: ctypes.CDLL) -> None:
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.spintorque_pulse_integrate.argtypes = [p] * 19 + [i] * 5 + [u, u, i, p]
    lib.spintorque_pulse_integrate.restype = i
    lib.spintorque_probe_add_one.argtypes = [p, p, i, p]
    lib.spintorque_probe_add_one.restype = i
