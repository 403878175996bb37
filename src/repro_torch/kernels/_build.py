"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into a shared library with
a plain C interface for ``sm_90a`` (Hopper) and loaded with `ctypes`.  The
build runs at first use, from the sources in the package only, into
``build/`` next to this file (listed in ``.gitignore``); the library's name
carries a hash of its source, the shared headers in ``csrc/`` and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.  Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # each multiply and add rounds on its own, as in the plain versions
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}    # name -> wall seconds of its nvcc


class KernelUnavailable(RuntimeError):
    """A CUDA kernel could not be built or loaded."""


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelUnavailable("nvcc not found (CUDA toolkit required to build "
                            "the port's kernels)")


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of its source,
    every shared header in ``csrc/`` (``*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, float]:
    """Compile every named source that has no current library, one
    ``nvcc`` process per source, all started together.  Returns the build
    seconds of each source compiled now; the compiler's report (registers,
    shared memory, spills) is kept in ``build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    built = {}
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise KernelUnavailable(
                f"nvcc failed on {name}.cu (exit {rc}):\n"
                + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
        os.replace(tmp, out)
        built[name] = BUILD_SECONDS[name] = time.perf_counter() - t0
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(_target(name)))
        return lib


def launch_on(device: torch.device):
    """``(context, stream)`` for a launch on ``device``: a context that
    makes it the current device (none when it already is) and the raw
    handle of its current stream.  A launch through ctypes goes to the
    current device; this costs well under a microsecond where
    ``torch.cuda.device`` and ``torch.cuda.current_stream`` cost several
    a call on the host, and a kernel of a few microseconds is launched
    back to back."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    context = (contextlib.nullcontext() if index == current
               else torch.cuda.device(index))
    return context, torch._C._cuda_getCurrentRawStream(index)
