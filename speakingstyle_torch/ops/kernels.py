"""Builds and loads the hand-written CUDA kernels of ``speakingstyle_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``: that takes
seconds, where a source that includes PyTorch's headers takes minutes.
Nothing is built at import: the first wrapper call builds what it needs,
and ``build_all()`` builds every source at once, one ``nvcc`` process per
file, all started together.

Libraries land in ``speakingstyle_torch/build/`` (listed in .gitignore),
named by a hash of their source and flags, so an edited source rebuilds
and a stale library is never loaded. ``nvcc`` is looked up on ``PATH``,
then under ``$CUDA_HOME`` and ``/usr/local/cuda``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("fused_attention", "fused_conv")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()  # load() holds it around build_all()
# seconds each library took to build in this process (0.0 = found built)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start one nvcc process into a temporary file; None if already built."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, path, time.monotonic()


def _finish_build(name: str, job) -> None:
    proc, tmp, path, t0 = job
    out, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, path)  # atomic: a concurrent builder never loads half a file
    build_seconds[name] = time.monotonic() - t0


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every named library in parallel (one nvcc each); returns the
    per-library build seconds (0.0 for one that was already built)."""
    names = list(names)
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        for n, job in jobs.items():
            if job is None:
                build_seconds.setdefault(n, 0.0)
            else:
                _finish_build(n, job)
    return {n: build_seconds[n] for n in names}


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name`` in this checkout, or "" if it was not built here."""
    log = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return "".join(l for l in f if "ptxas info" in l or "spill" in l)


def load(name: str, signatures: Optional[Dict[str, tuple]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use).
    ``signatures`` maps each C function to its ctypes argument types; every
    entry point returns ``int`` (a ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in (signatures or {}).items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
