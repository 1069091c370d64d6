"""The structured failure types the serving core raises, and the replica
circuit breaker (copied from speakingstyle_tpu/serving/resilience.py,
``:54-160``; plain Python). ``LeaseExpired`` and ``WireError`` are the
cluster's (serving/cluster.py): the lease sweeper and the wire dispatch
raise them into the fleet's ordinary replica-failure path.

Each terminal state has a fixed HTTP mapping in the server:
``DeadlineExceeded`` 504, ``ReplicaError`` 503, ``DispatchError`` 500;
``InjectedFault`` is what a ``SPEAKINGSTYLE_FAULTS`` serving fault point
raises (``replica_raise``, ``vocoder_raise``, ``style_encode_error``).

``CircuitBreaker`` is each fleet replica's closed -> open -> half-open
state with exponential backoff (serving/fleet.py owns the clock, the
re-warm thread and the ``serve_replica_breaker_state`` gauge).
"""

from speakingstyle_torch.obs import make_lock

__all__ = ["BREAKER_CODE", "CircuitBreaker", "DeadlineExceeded", "DispatchError",
           "InjectedFault", "LeaseExpired", "ReplicaError", "WireError"]

# serve_replica_breaker_state gauge values, mirroring fleet.STATE_CODE
BREAKER_CODE = {"closed": 0, "open": 1, "half_open": 2}


class InjectedFault(RuntimeError):
    """Raised by a SPEAKINGSTYLE_FAULTS serving fault point. Transient by
    construction: supervision treats it exactly like a real device error."""


class DeadlineExceeded(RuntimeError):
    """The request sat past its class deadline budget; resolved instead
    of dispatched late."""

    def __init__(self, message: str, klass: str = "", budget_ms: float = 0.0):
        super().__init__(message)
        self.klass = klass
        self.budget_ms = budget_ms


class ReplicaError(RuntimeError):
    """The request's replica failed and its retry budget is exhausted, or
    a stream continuation lost its replica (streams are never retried)."""


class DispatchError(RuntimeError):
    """An unexpected exception in a dispatch loop's bookkeeping (not the
    engine call itself)."""


class LeaseExpired(RuntimeError):
    """A remote replica missed its heartbeat lease's miss budget (process
    death, partition, a wedged host). The cluster router's lease sweeper
    raises it into the fleet's ``_replica_failed``: the breaker opens and
    the in-flight work requeues at its original deadline, as for an
    in-process raise."""

    def __init__(self, message: str, replica_id: str = "", age_s: float = 0.0):
        super().__init__(message)
        self.replica_id = replica_id
        self.age_s = age_s


class WireError(RuntimeError):
    """A dispatch over the wire failed for good within its class budget (a
    connect or read timeout after the retry, a partitioned host, a bad
    answer). The router requeues the batch as for an in-process raise."""


class CircuitBreaker:
    """Per-replica breaker: closed -> open (on failure, with exponential
    backoff) -> half-open (re-warm trial) -> closed (first success).

    Pure state; callers pass ``now`` explicitly (``time.monotonic()``) so
    tests can drive the clock. Thread-safe: the replica worker, the hang
    watchdog and the re-warm scheduler all touch it."""

    def __init__(self, backoff_s: float, backoff_max_s: float):
        if backoff_s <= 0 or backoff_max_s < backoff_s:
            raise ValueError(
                f"breaker backoff must satisfy 0 < backoff_s <= backoff_max_s; "
                f"got {backoff_s} / {backoff_max_s}")
        self._base = float(backoff_s)
        self._max = float(backoff_max_s)
        self._lock = make_lock("CircuitBreaker._lock")
        self._state = "closed"
        self._consecutive = 0
        self._retry_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def code(self) -> int:
        return BREAKER_CODE[self.state]

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def record_failure(self, now: float) -> float:
        """Open the breaker; returns the backoff applied (doubling per
        consecutive failure, capped at ``backoff_max_s``)."""
        with self._lock:
            backoff = min(self._max, self._base * (2.0 ** self._consecutive))
            self._consecutive += 1
            self._state = "open"
            self._retry_at = now + backoff
            return backoff

    def ready_to_trial(self, now: float) -> bool:
        """True when the breaker is open and the backoff has elapsed: the
        router may start a re-warm trial."""
        with self._lock:
            return self._state == "open" and now >= self._retry_at

    def begin_trial(self) -> None:
        with self._lock:
            self._state = "half_open"

    def record_success(self) -> None:
        """First successful dispatch after a trial: close and reset."""
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._retry_at = 0.0

    def retry_at(self) -> float:
        with self._lock:
            return self._retry_at
