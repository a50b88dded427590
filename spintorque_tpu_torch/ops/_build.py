"""Build of the port's CUDA kernels into one shared library.

``csrc/*.cu`` (with the headers beside them) compile with ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/libspintorque_kernels_<sha>.so``
at the root of the checkout, where ``<sha>`` hashes the sources and the
flags, so an edit rebuilds and an unchanged tree reuses the library. Each
source compiles to an object in its own ``nvcc``, all started together,
and one ``nvcc`` links the objects. The library has a plain C interface and
is loaded with ctypes; it does not include PyTorch's headers, so the build
takes seconds.

Flags: no ``--use_fast_math`` and ``--fmad=false``, because the kernels are
held to their plain PyTorch versions to a few ulps, and true division,
``sqrtf`` and unfused products are part of that.

Every kernel wrapper (``ops.cuda_integrator``'s probe and pulse,
``ops.op_chain.op_chain``, ``ops.array_sweep.sequential_sweep``) calls its
C entry point through ``launch``, with the function ``kernel_fn`` binds
once, so that a call costs little more host time than a PyTorch op.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Collection, Dict, Optional

import torch

from ..utils.profiling import always_span, counter

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
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


def _sources(csrc: Path = CSRC):
    return sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))


def source_digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for p in _sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(CSRC))
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    return log


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel in ``nvcc -Xptxas -v`` output (the build log): its
    ``registers`` per thread, ``stack`` frame bytes and ``spill_stores`` /
    ``spill_loads`` bytes, keyed by mangled name. A spill is a register
    array or live value that ptxas moved to local memory."""
    out: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    return out


_LIBRARY: Optional[KernelLibrary] = None
# 1 where the process's library was compiled by nvcc at its load (its
# ``build_seconds`` nonzero), 0 where it was found on disk.
BUILDS = counter("kernels.builds")
# Held by the first build and load, and by the probe of
# ``ops.cuda_integrator.cuda_kernel_available``: threads of one process
# that reach the first launch together (a serving refresh thread and the
# main thread, a worker pool's drainer and its caller) build once.
BUILD_LOCK = threading.RLock()


def load_library() -> KernelLibrary:
    """Build the library if needed (once per source digest) and load it.
    Thread-safe: concurrent first calls build once and share the result."""
    if _LIBRARY is not None:
        return _LIBRARY
    with BUILD_LOCK:
        if _LIBRARY is None:
            _load_library()
        return _LIBRARY


def _load_library() -> None:
    global _LIBRARY
    with always_span("kernels.load"):  # once a process: recorded with tracing off too
        _LIBRARY = build_library()
    if _LIBRARY.build_seconds > 0:
        BUILDS.add()


def build_library(csrc: Optional[Path] = None, optional: Collection[str] = ()) -> KernelLibrary:
    """Build the sources of ``csrc`` (the checkout's when None) into
    ``BUILD_DIR`` if needed (once per source digest), load and bind the
    library. Other sources with the same C interface (a parent commit's)
    build beside the checkout's, and ``use_library`` puts them in its
    place; ``optional`` names the entry points they may lack."""
    csrc = CSRC if csrc is None else Path(csrc).resolve()
    out = BUILD_DIR / f"libspintorque_kernels_{source_digest(csrc)}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        # Named by process and thread: another process may build the same
        # digest into the same directory at the same time.
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        sources = [p for p in _sources(csrc) if p.suffix == ".cu"]
        objects = [tmp.with_suffix(f".{p.stem}.o") for p in sources]
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(len(sources)) as pool:
                logs = list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                                            for p, o in zip(sources, objects)]))
            logs.append(_run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objects)]))
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for o in objects:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log_path.write_text("".join(logs))
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.is_file() else ""
    lib = ctypes.CDLL(str(out))
    _bind(lib, optional)
    return KernelLibrary(lib, out, seconds, log)


_KERNEL_FNS: Dict[str, object] = {}


def use_library(library: KernelLibrary) -> None:
    """Make ``library`` the one every wrapper launches from (its entry
    points are bound anew at their next call)."""
    global _LIBRARY
    with BUILD_LOCK:
        _LIBRARY = library
        _KERNEL_FNS.clear()


def kernel_fn(name: str):
    """The library's C entry point ``name``, bound at first use (building
    and loading the library then if needed)."""
    fn = _KERNEL_FNS.get(name)
    if fn is None:
        fn = _KERNEL_FNS[name] = getattr(load_library().lib, name)
    return fn


def launch(fn, device, *args) -> int:
    """Calls the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream, entering a device guard only when ``device`` is not the current
    device, and returns its cudaError code. The stream is read as a raw
    handle by ``torch._C._cuda_getCurrentRawStream``, a private call: the
    public ``torch.cuda.current_stream`` builds a ``Stream`` object on every
    call."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _bind(lib: ctypes.CDLL, optional: Collection[str] = ()) -> None:
    """Sets the C types of the library's entry points. Each must be there
    but those named in ``optional``, which a library built from an older
    checkout's sources may lack (``kernel_fn`` raises for them at their
    first call)."""
    # A pointer or the stream is c_void_p: ctypes would pass a bare Python
    # int as a 32-bit int.
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    signatures = {
        # 19 pointers and the key's; batch, method, thermal, per_stage,
        # plus_z, bf16; env_offset; stream.
        "spintorque_pulse_integrate": [p] * 20 + [i] * 6 + [u, p],
        "spintorque_probe_add_one": [p, p, i, p],
        "spintorque_check_div6": [p, p],  # counts, stream
        "spintorque_check_bf16_ops": [p, p, p],  # counts, first, stream
        "spintorque_op_chain": [p, p, i, i, i, i, p],  # x, y, count, op, steps, block, stream
        # 11 pointers; batch, n; -gamma, mu0; stream.
        "spintorque_array_sweep": [p] * 11 + [i, i, f, f, p],
    }
    for name, argtypes in signatures.items():
        if name in optional and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)  # raises for a missing entry point
        fn.argtypes = argtypes
        fn.restype = i
