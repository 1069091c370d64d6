"""The structured failure types the serving core raises (copied from
speakingstyle_tpu/serving/resilience.py; plain Python). The replica
circuit breaker and the cluster's lease and wire errors wait for the
fleet (ROADMAP.md queue A item 5).

Each terminal state has a fixed HTTP mapping in the JAX package's server:
``DeadlineExceeded`` 504, ``ReplicaError`` 503, ``DispatchError`` 500;
``InjectedFault`` is what a ``SPEAKINGSTYLE_FAULTS`` serving fault point
raises (``vocoder_raise``, ``style_encode_error``).
"""

__all__ = ["DeadlineExceeded", "DispatchError", "InjectedFault", "ReplicaError"]


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
