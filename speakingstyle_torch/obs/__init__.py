"""Observability for the port: the metrics registry, named locks and the
JSONL event log (copies of the JAX package's ``speakingstyle_tpu/obs``
modules of the same names; plain Python, no torch)."""

from speakingstyle_torch.obs.events import JsonlEventLog, read_events
from speakingstyle_torch.obs.locks import make_lock
from speakingstyle_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "JsonlEventLog", "MetricsRegistry",
           "get_registry", "make_lock", "read_events"]
