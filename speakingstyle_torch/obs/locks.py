"""Named locks (JAX counterpart: speakingstyle_tpu/obs/locks.py,
``make_lock``; plain Python, no torch).

Lock names are ``"ClassName._attr"``, the spelling the JAX package's static
lock-order model and its runtime witness use. The witness
(``TrackedLock`` under ``SPEAKINGSTYLE_CHECKS=1``) checks acquisitions
against a committed lock order, which the port does not have yet, so
``make_lock`` returns the plain ``threading`` primitive.
"""

import threading

__all__ = ["make_lock"]

_KINDS = {"lock": threading.Lock, "rlock": threading.RLock, "condition": threading.Condition}


def make_lock(name: str, kind: str = "lock"):
    """A ``threading`` lock, re-entrant lock or condition for ``name``."""
    if kind not in _KINDS:
        raise ValueError(f"unknown lock kind {kind!r}")
    return _KINDS[kind]()
