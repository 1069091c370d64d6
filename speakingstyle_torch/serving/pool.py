"""Preallocated host staging buffers for the serve path (JAX counterpart:
speakingstyle_tpu/serving/pool.py).

Every dispatch stages its padded inputs in buffers of the lattice's own
shapes, a closed set fixed at start-up. ``BufferPool`` leases them per
``(shape, dtype)``: the first dispatch at a bucket allocates, every later
one reuses.

Ownership rules:

* ``acquire`` hands the caller an exclusively owned buffer, filled with
  ``fill``; nobody else sees it until it is released.
* With ``pin=True`` (the engine's choice on a CUDA device) the buffers are
  page-locked host tensors, so that the host -> device copy can be
  ``non_blocking``. Such a copy is still reading the buffer after the call
  returns, so the caller releases only after the stream has passed the
  copy: after a host readback of a later result on the same stream, or
  after an event recorded behind the copy has completed. Releasing at
  enqueue would let the next lease overwrite a copy in flight.
* Release rides ``try/finally`` on every path (a faulted dispatch, an
  abandoned stream). ``release`` raises on a double release or on a buffer
  the pool never leased, so a bookkeeping bug is loud, not a silent leak.

The pool reports itself through the owning registry:
``serve_pool_allocs_total`` (flat after warm-up: the allocation-free
steady state), ``serve_pool_reuses_total`` and the
``serve_pool_outstanding`` gauge (0 when idle: no leak).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from speakingstyle_torch.obs import MetricsRegistry, make_lock

__all__ = ["BufferPool"]

_Key = Tuple[Tuple[int, ...], torch.dtype]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


class BufferPool:
    """Thread-safe free list of host tensors keyed by (shape, dtype)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, pin: bool = False):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.pin = pin
        self._lock = make_lock("BufferPool._lock")
        self._free: Dict[_Key, List[torch.Tensor]] = {}
        # id(buf) -> (key, buf): holds the lease's reference (keeps the id
        # stable) and lets release() find the free list without trusting
        # the caller
        self._leased: Dict[int, Tuple[_Key, torch.Tensor]] = {}
        self._allocs = self.registry.counter(
            "serve_pool_allocs_total",
            help="staging buffers ever created (flat after warm-up = "
                 "allocation-free steady state)",
        )
        self._reuses = self.registry.counter(
            "serve_pool_reuses_total", help="staging buffer leases served from the free list",
        )
        self._outstanding_g = self.registry.gauge(
            "serve_pool_outstanding",
            help="staging buffers currently leased (0 when idle = no leak)",
        )

    def acquire(self, shape, dtype=torch.float32, fill: float = 0) -> torch.Tensor:
        """Lease a host tensor of ``shape``/``dtype`` (numpy or torch
        dtype) filled with ``fill``; reuses a free one when there is one,
        allocates and counts otherwise."""
        key = (tuple(int(s) for s in shape), _torch_dtype(dtype))
        with self._lock:
            stack = self._free.get(key)
            if stack:
                buf = stack.pop()
                self._reuses.inc()
            else:
                buf = torch.empty(key[0], dtype=key[1], pin_memory=self.pin)
                self._allocs.inc()
            self._leased[id(buf)] = (key, buf)
            self._outstanding_g.inc()
        buf.fill_(fill)  # exclusive lease: no lock needed for the fill
        return buf

    def release(self, buf: torch.Tensor) -> None:
        """Return a leased buffer. Raises on a double release or a foreign
        buffer."""
        with self._lock:
            entry = self._leased.pop(id(buf), None)
            if entry is None:
                raise ValueError(
                    "release of a buffer this pool has not leased "
                    "(double release, or a foreign tensor)"
                )
            self._free.setdefault(entry[0], []).append(buf)
            self._outstanding_g.dec()

    @property
    def allocated(self) -> int:
        """Total buffers ever created (free + leased)."""
        return int(self._allocs.value)

    @property
    def outstanding(self) -> int:
        """Buffers currently leased; 0 when the serve path is idle."""
        with self._lock:
            return len(self._leased)
