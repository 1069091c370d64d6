"""Fault-tolerance primitives for the training loop (JAX counterpart:
speakingstyle_tpu/training/resilience.py).

Four pillars, wired through ``run_training`` (config: ``train.resilience.*``, see configs/config.py:ResilienceConfig):

  1. preemption-safe checkpointing — async saves + a SIGTERM/SIGINT
     flush (``GracefulShutdown``), retention in training/checkpoint.py
  2. NaN/divergence sentinel — ``all_finite`` computed in the train step
     on the device, ``RollbackGuard`` bounding consecutive rollbacks
     host-side
  3. data-pipeline retry and quarantine — ``retry_io`` +
     ``Quarantine``, used by data/dataset.py and data/prefetch.py
  4. deterministic fault injection — training/faults.py exercises all
     of the above end-to-end

Everything here is host-side plain Python except ``all_finite``, a few
device launches whose one-element result the host reads only at the log
boundary, so it adds no synchronisation.
"""

import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from speakingstyle_torch.obs.locks import make_lock


class TrainingDivergedError(RuntimeError):
    """Raised when consecutive NaN rollbacks exceed train.resilience.max_rollbacks."""


class BadSampleBudgetError(RuntimeError):
    """Raised when distinct quarantined samples exceed train.resilience.bad_sample_budget."""


# ---------------------------------------------------------------------------
# retry + quarantine (data pipeline)
# ---------------------------------------------------------------------------


def retry_io(
    fn: Callable,
    retries: int = 3,
    backoff: float = 0.05,
    exceptions: Tuple = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
    describe: str = "",
):
    """Call ``fn()`` with up to ``retries`` retries on ``exceptions``,
    sleeping ``backoff * 2**(attempt-1)`` between attempts (exponential
    backoff). The final failure propagates unchanged."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            attempt += 1
            if attempt > retries:
                raise
            # telemetry: retries are the leading indicator of a sick
            # filesystem; counted in the default registry
            from speakingstyle_torch.obs.registry import get_registry

            get_registry().counter(
                "io_retries_total",
                help="transient I/O errors retried (loads + transfers)",
            ).inc()
            print(
                f"[resilience] transient {type(e).__name__} "
                f"{f'({describe}) ' if describe else ''}retry "
                f"{attempt}/{retries}: {e}"
            )
            sleep(backoff * (2 ** (attempt - 1)))


class Quarantine:
    """Per-sample quarantine list: samples that fail to load even after
    retries are logged and skipped instead of killing the worker thread;
    the run fails only past ``budget`` distinct bad samples."""

    def __init__(self, budget: int = 16):
        self.budget = budget
        self.bad: Dict[str, str] = {}  # sample id -> error summary
        self._lock = make_lock("Quarantine._lock")

    def add(self, sample_id: str, err: BaseException):
        with self._lock:
            self.bad[sample_id] = f"{type(err).__name__}: {err}"
            n = len(self.bad)
        from speakingstyle_torch.obs.registry import get_registry

        get_registry().counter(
            "quarantined_samples_total",
            help="distinct samples quarantined after exhausting retries",
        ).inc()
        print(
            f"[resilience] quarantined sample {sample_id!r} "
            f"({n}/{self.budget} budget): {type(err).__name__}: {err}"
        )
        if n > self.budget:
            raise BadSampleBudgetError(
                f"{n} quarantined samples exceed the bad-sample budget "
                f"({self.budget}); first failures: "
                f"{dict(list(self.bad.items())[:5])}"
            ) from err

    def __len__(self) -> int:
        return len(self.bad)

    def __contains__(self, sample_id: str) -> bool:
        return sample_id in self.bad


# ---------------------------------------------------------------------------
# graceful shutdown (preemption)
# ---------------------------------------------------------------------------


class GracefulShutdown:
    """Context manager: SIGTERM/SIGINT set ``.requested`` instead of
    killing the process, so the step loop can flush a final atomic
    checkpoint and exit cleanly (a preempted job gets SIGTERM).

    Installing a handler is only legal on the main thread; elsewhere
    (e.g. a loop run inside a worker thread) this degrades to a no-op
    with ``.installed == False`` and the default disposition intact."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, signals=SIGNALS):
        self.signals = signals
        self.requested = False
        self.signame: Optional[str] = None
        self.installed = False
        self._prev: Dict[int, object] = {}

    def _handler(self, signum, frame):
        self.requested = True
        self.signame = signal.Signals(signum).name

    def __enter__(self) -> "GracefulShutdown":
        self.requested = False
        self.signame = None
        for sig in self.signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
                self.installed = True
            except ValueError:
                # not the main thread: signals keep their default
                # disposition; the loop still works, just not preemptible
                print(
                    "[resilience] not on the main thread: "
                    f"{signal.Signals(sig).name} flush handler not installed"
                )
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self.installed = False
        return False


# ---------------------------------------------------------------------------
# NaN sentinel + rollback policy
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def all_finite(*trees) -> torch.Tensor:
    """Scalar bool tensor on the leaves' device: every floating-point leaf
    of every tree (a tensor, or dicts / lists / tuples of them) is finite.
    Nothing is read back: the host reads the flag only at the log
    boundary, where it syncs anyway.

    One ``_foreach_norm(..., inf)`` per device over every floating leaf,
    then one ``isfinite(...).all()``: a handful of launches, not two per
    leaf. The infinity norm is max |x|, non-finite exactly when some
    element is (NaN or inf), so this is the JAX package's
    ``all(isfinite(leaf))`` for every leaf; an L2 norm would overflow to
    inf on finite leaves near 1e19 and trip where that does not."""
    leaves = [t.detach() for tree in trees for t in _leaves(tree)
              if t.is_floating_point() and t.numel()]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    norms = torch._foreach_norm(leaves, float("inf"))
    return torch.isfinite(torch.stack([n.float() for n in norms])).all()


class RollbackGuard:
    """Counts CONSECUTIVE rollbacks; a finite check window resets the
    count, so a one-off bad batch costs one rollback while a genuinely
    diverged run aborts after ``max_rollbacks``."""

    def __init__(self, max_rollbacks: int = 3):
        self.max_rollbacks = max_rollbacks
        self.count = 0

    def ok(self):
        self.count = 0

    def trip(self, step: int) -> int:
        """Record a rollback at ``step``; returns the consecutive count
        or raises TrainingDivergedError past the budget."""
        self.count += 1
        if self.count > self.max_rollbacks:
            raise TrainingDivergedError(
                f"non-finite losses/grads persisted through "
                f"{self.max_rollbacks} consecutive rollbacks "
                f"(last trip at step {step}): the run has diverged"
            )
        return self.count
