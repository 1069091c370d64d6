"""Observability for the port: the metrics registry, named locks, the
JSONL event log, build identity, trace spans and SLO burn rates (copies of
the JAX package's ``speakingstyle_tpu/obs`` modules of the same names;
plain Python, no torch at import)."""

from speakingstyle_torch.obs.buildinfo import (
    array_sha256,
    build_info,
    process_rss_bytes,
    weights_digest,
)
from speakingstyle_torch.obs.events import JsonlEventLog, read_events
from speakingstyle_torch.obs.locks import make_lock
from speakingstyle_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from speakingstyle_torch.obs.trace import Span

__all__ = ["Counter", "Gauge", "Histogram", "JsonlEventLog", "MetricsRegistry", "Span",
           "array_sha256", "build_info", "get_registry", "make_lock", "process_rss_bytes",
           "read_events", "weights_digest"]
