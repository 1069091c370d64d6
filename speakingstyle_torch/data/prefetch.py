"""Background-thread host -> device prefetch (JAX counterpart:
speakingstyle_tpu/data/prefetch.py).

A worker thread runs the host batch iterator (feature loads, collate),
fills pinned host buffers with the batch's tensors (ids and lengths as
int64, the rest float32) and copies them to the card on a side CUDA
stream, recording an event after the copies. ``__next__`` makes the
consumer's current stream wait on that event and calls ``record_stream``
on each tensor, so the caching allocator does not hand a batch's memory
to another tensor while the current stream may still read it. A step
therefore starts with its batch already on the card, and the step loop
never waits on a copy it could have overlapped. On the CPU the worker
hands over host tensors; on ``cuda`` it never does.

Shutdown contract (as in the JAX package): the worker only ever blocks on
a *stop-aware bounded put* (it polls the stop event while the queue is
full, so ``stop()`` can never strand it), and it enqueues exactly one
terminal item — either a clean end-of-stream or the error that killed
the source — never both. ``stop()`` drains, joins the worker, and is
idempotent; the class is also a context manager so short-lived
prefetchers (validation passes) cannot leak their thread.
"""

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from speakingstyle_torch.obs.registry import MetricsRegistry, get_registry
from speakingstyle_torch.training.resilience import retry_io

ARRAY_KEYS = ("speakers", "texts", "src_lens", "mels", "mel_lens", "pitches", "energies",
              "durations")
INT_KEYS = ("speakers", "texts", "src_lens", "mel_lens", "durations")


def host_tensors(arrays: Dict[str, np.ndarray], pin: bool = False) -> Dict[str, torch.Tensor]:
    """A batch's numpy arrays as tensors: ids and lengths int64, the rest
    float32, each in one copy (into page-locked memory with ``pin``)."""
    out = {}
    for k in ARRAY_KEYS:
        a = np.ascontiguousarray(arrays[k])
        dtype = torch.int64 if k in INT_KEYS else torch.float32
        t = torch.empty(a.shape, dtype=dtype, pin_memory=pin)
        t.copy_(torch.from_numpy(a))
        out[k] = t
    return out


class Terminal:
    """The single end-of-stream marker; ``error`` is None for a clean end."""

    __slots__ = ("error",)

    def __init__(self, error: Optional[BaseException] = None):
        self.error = error


def bounded_put(q: "queue.Queue", item, stopped: threading.Event,
                poll: float = 0.05) -> bool:
    """Bounded put that can never outlive a stop: polls ``stopped`` while
    the queue is full. Returns False if stopped before enqueueing."""
    while not stopped.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


class DevicePrefetcher:
    """Wrap a host batch iterator; yield (Batch, tensors on ``device``).
    ``mesh`` (a data-parallel ``parallel.mesh.Mesh``): the Batch stays the
    global one and only this rank's rows are copied, at the global batch's
    padded lengths (the JAX package's multi-host contract: every host cuts
    the same global batch and feeds its own shard)."""

    def __init__(
        self,
        batches: Iterator,
        device="cpu",
        depth: int = 2,
        transfer_retries: int = 0,
        transfer_backoff: float = 0.05,
        registry: Optional[MetricsRegistry] = None,
        mesh=None,
    ):
        self.batches = batches
        self.mesh = mesh if mesh is not None and mesh.dp > 1 else None
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:  # the worker thread sets it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.transfer_retries = transfer_retries
        self.transfer_backoff = transfer_backoff
        self.registry = registry if registry is not None else get_registry()
        # pinned at `depth`: the device is the bottleneck; at 0 the step
        # loop starves on data
        self._depth_gauge = self.registry.gauge(
            "data_prefetch_queue_depth",
            help="prefetch queue occupancy (0 = step loop is data-starved)",
        )
        self._batches_ctr = self.registry.counter(
            "data_prefetch_batches_total", help="batches handed to the step loop",
        )
        self._stopped = threading.Event()
        self._finished = False
        self.thread = threading.Thread(target=self._worker, name="prefetch-worker",
                                       daemon=True)
        self.thread.start()

    def _put(self, batch):
        from speakingstyle_torch.parallel.mesh import shard_batch

        host = host_tensors(shard_batch(batch.arrays(), self.mesh), pin=self.cuda)
        if not self.cuda:
            return batch, host, None
        with torch.cuda.stream(self.stream):
            dev = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return batch, dev, done

    def _transfer(self, batch):
        """Host -> device transfer with retry-with-backoff on transient
        errors (re-entrant, unlike the source iterator)."""
        if not self.transfer_retries:
            return self._put(batch)
        return retry_io(lambda: self._put(batch), retries=self.transfer_retries,
                        backoff=self.transfer_backoff, exceptions=(OSError, RuntimeError),
                        describe="device transfer")

    def _bounded_put(self, item) -> bool:
        ok = bounded_put(self.queue, item, self._stopped)
        if ok:
            self._depth_gauge.set(self.queue.qsize())
        return ok

    def _worker(self):
        terminal = Terminal()
        try:
            if self.cuda:
                torch.cuda.set_device(self.device)
            for batch in self.batches:
                if self._stopped.is_set():
                    return
                if not self._bounded_put(self._transfer(batch)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            terminal = Terminal(e)
        self._bounded_put(terminal)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self.queue.get()
        self._depth_gauge.set(self.queue.qsize())
        if isinstance(item, Terminal):
            self._finished = True
            if item.error is not None:
                raise item.error
            raise StopIteration
        batch, arrays, done = item
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in arrays.values():
                t.record_stream(current)
        self._batches_ctr.inc()
        return batch, arrays

    def stop(self):
        """Idempotent: unblock + join the worker and drain the queue."""
        self._stopped.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=5.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
