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
``ops.op_chain.op_chain``) calls its C entry point through ``launch``, with
the function ``kernel_fn`` binds once, so that a call costs little more host
time than a PyTorch op.
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
from typing import Dict, Optional

import torch

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


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
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
    out = BUILD_DIR / f"libspintorque_kernels_{source_digest()}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        # Named by process and thread: another process may build the same
        # digest into the same directory at the same time.
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        sources = [p for p in _sources() if p.suffix == ".cu"]
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
    _bind(lib)
    _LIBRARY = KernelLibrary(lib, out, seconds, log)


_KERNEL_FNS: Dict[str, object] = {}


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


def _bind(lib: ctypes.CDLL) -> None:
    # A pointer or the stream is c_void_p: ctypes would pass a bare Python
    # int as a 32-bit int.
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    # 19 pointers; batch, method, thermal, per_stage, plus_z, bf16; seed_lo,
    # seed_hi, env_offset; stream.
    lib.spintorque_pulse_integrate.argtypes = [p] * 19 + [i] * 6 + [u, u, u, p]
    lib.spintorque_pulse_integrate.restype = i
    lib.spintorque_probe_add_one.argtypes = [p, p, i, p]
    lib.spintorque_probe_add_one.restype = i
    # counts, stream.
    lib.spintorque_check_div6.argtypes = [p, p]
    lib.spintorque_check_div6.restype = i
    # x, y, count, op, steps, block, stream.
    lib.spintorque_op_chain.argtypes = [p, p, i, i, i, i, p]
    lib.spintorque_op_chain.restype = i
