"""Build and runtime identity, and process gauges (JAX counterpart:
speakingstyle_tpu/obs/buildinfo.py).

``build_info()`` says what a process is running: the git SHA when the tree
is a checkout, the Python, torch and CUDA versions, and the device's name
and count, in place of the JAX package's jax / jaxlib / backend. The
server's ``/healthz`` and the trainer's ``train_start`` event carry it.

``process_rss_bytes()`` reads the resident set from ``/proc/self/status``
(peak RSS from ``resource`` elsewhere) for the ``process_rss_bytes`` gauge
of ``GET /metrics``.

``weights_digest()`` names the weights: one sha256 over sorted
``name=leaf_sha`` lines of a state dict (nested dicts and lists are
flattened to ``/``-joined names), so it does not depend on the order of
the leaves. It is the digest the checkpoint manifests carry
(training/checkpoint.py). It is not the JAX package's digest of the same
weights, whose leaf names and layouts differ; ``array_sha256`` of one
float32 leaf of one or more dimensions equals the JAX package's for the
same values (the JAX function hashes a 0-d array as shape (1,)).

Identity degrades to ``None`` rather than raise: no git or no card must
not take down a health endpoint.
"""

import hashlib
import os
import platform
import subprocess
from typing import Dict, Optional

__all__ = ["array_sha256", "build_info", "flatten", "git_sha", "process_rss_bytes",
           "weights_digest"]


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """HEAD commit of the tree holding this package, or None. Only a tree
    with its own ``.git`` answers: an exported copy that sits inside
    another repository must not report that repository's HEAD."""
    cwd = cwd or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not os.path.exists(os.path.join(cwd, ".git")):
        return None
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             timeout=5, cwd=cwd)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def build_info() -> Dict:
    """Identity dict for ``/healthz`` and the ``train_start`` event."""
    info: Dict = {"git_sha": git_sha(), "python": platform.python_version()}
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        cuda = torch.cuda.is_available()
        info["backend"] = "cuda" if cuda else "cpu"
        info["device_count"] = torch.cuda.device_count() if cuda else 1
        info["device_kind"] = torch.cuda.get_device_name(0) if cuda else platform.processor()
    except Exception as e:
        info["torch_error"] = f"{type(e).__name__}: {e}"
    return info


def array_sha256(arr) -> str:
    """sha256 of one array's dtype, shape and raw bytes (a torch tensor on
    any device, or anything numpy takes). A bfloat16 tensor is hashed
    through its int16 view under the name ``bfloat16``."""
    import numpy as np

    if hasattr(arr, "detach"):  # a torch tensor
        import torch

        t = arr.detach().cpu().contiguous()
        dtype = str(t.dtype).replace("torch.", "")
        a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    else:
        # np.ascontiguousarray would turn a 0-d array into shape (1,)
        a = np.asarray(arr)
        a = a if a.flags.c_contiguous else np.ascontiguousarray(a)
        dtype = str(a.dtype)
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(str(tuple(a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """``/``-joined leaf paths of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def weights_digest(state) -> Optional[str]:
    """One order-independent sha256 over a state dict (or a nested tree of
    tensors), or None for an empty one."""
    lines = sorted(f"{n}={array_sha256(t)}\n" for n, t in flatten(state).items())
    if not lines:
        return None
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
    return h.hexdigest()


def process_rss_bytes() -> Optional[float]:
    """Resident set size in bytes (Linux /proc; peak RSS through
    ``resource`` elsewhere), or None."""
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0
    except (ImportError, OSError, ValueError):
        return None
