"""ProgramCard: the cost and memory card of one prepared program (JAX
counterpart: speakingstyle_tpu/obs/cost.py).

The JAX package reads XLA's ``cost_analysis()`` / ``memory_analysis()``
of each compiled executable. The port prepares a program by running it
once eagerly and, on the card, capturing it into a CUDA graph
(parallel/registry.py), so its card's fields come from there:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the warm-up
  run, plus the work of the hand-written kernels, which the flop counter
  cannot see through ctypes and which each kernel wrapper adds from its
  shapes (``ops.kernels.counting_flops``): attention 4 B H L^2 D forward
  and 10 B H L^2 D backward (S recomputed, dV, dP, dQ, dK), conv
  2 B T K Cin Cout. The kernel path and the library path therefore read
  the same FLOPs at the same bucket.
* ``peak_bytes``: the device memory the capture took (the peak allocated
  during the capture above what was allocated before it); ``None`` on the
  CPU, where nothing is captured.
* ``argument_bytes`` / ``output_bytes``: the program's inputs and outputs.

Fields without a counterpart (transcendentals, bytes accessed, temp,
alias, generated code) stay ``None``, so a CPU card is ``partial``, as a
JAX card degrades field by field.
"""

import dataclasses
from typing import Dict, Optional, Tuple

from speakingstyle_torch.obs.registry import MetricsRegistry

# Histogram edges for achieved-FLOP/s observations: 1 MFLOP/s .. 1 EFLOP/s
# in 1/2.5/5 decade steps.
FLOPS_PER_SEC_BUCKETS: Tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(6, 18) for m in (1.0, 2.5, 5.0)
) + (1e18,)


@dataclasses.dataclass(frozen=True)
class ProgramCard:
    """Static cost and memory metadata of one prepared program. Every
    numeric field is Optional: ``None`` means not measured (never zero)."""

    name: str
    flops: Optional[float] = None
    transcendentals: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[float] = None
    output_bytes: Optional[float] = None
    temp_bytes: Optional[float] = None
    alias_bytes: Optional[float] = None
    generated_code_bytes: Optional[float] = None
    peak_bytes: Optional[float] = None
    errors: Tuple[str, ...] = ()

    @property
    def partial(self) -> bool:
        """True when a core quantity is missing."""
        return self.flops is None or self.peak_bytes is None

    @property
    def arithmetic_intensity(self) -> Optional[float]:
        """FLOPs per device-memory byte, where both are known."""
        if self.flops is None or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def achieved_flops_per_sec(self, seconds: float) -> Optional[float]:
        """Card FLOPs over a measured wall time."""
        if self.flops is None or seconds <= 0:
            return None
        return self.flops / seconds

    def as_dict(self) -> Dict:
        """JSON-ready dict (the program table's spelling)."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if f.name != "errors"}
        out["partial"] = self.partial
        out["arithmetic_intensity"] = self.arithmetic_intensity
        if self.errors:
            out["errors"] = list(self.errors)
        return out


def publish_program_gauges(registry: MetricsRegistry, card: ProgramCard, prefix: str,
                           labels: Optional[Dict[str, str]] = None) -> None:
    """Export a card's headline numbers as ``<prefix>_program_flops`` /
    ``<prefix>_program_peak_bytes`` gauges (skipping missing fields)."""
    if card.flops is not None:
        registry.gauge(f"{prefix}_program_flops", labels=labels,
                       help="FLOPs of the prepared program (flop counter + kernel tallies)",
                       ).set(card.flops)
    if card.peak_bytes is not None:
        registry.gauge(f"{prefix}_program_peak_bytes", labels=labels,
                       help="device bytes the program's graph capture took",
                       ).set(card.peak_bytes)


def device_memory_watermarks(card: Optional[ProgramCard] = None) -> Dict[str, float]:
    """Per-device memory watermarks ``{"cuda:0": bytes, ...}``: each
    card's ``torch.cuda.memory_stats`` peak, else the card's argument +
    temp bytes; an empty dict without a CUDA device."""
    import torch

    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        v = device_memory_watermark(card, i)
        if v is not None:
            out[f"cuda:{i}"] = v
    return out


def device_memory_watermark(card: Optional[ProgramCard] = None, device: int = 0):
    """Device-memory watermark in bytes: ``torch.cuda.memory_stats``'
    peak (else current) allocated bytes where there is a card, else the
    card's argument + temp bytes, else ``None``."""
    import torch

    if torch.cuda.is_available():
        stats = torch.cuda.memory_stats(device)
        v = stats.get("allocated_bytes.all.peak") or stats.get("allocated_bytes.all.current")
        if isinstance(v, (int, float)) and v > 0:
            return float(v)
    if card is not None:
        parts = [card.argument_bytes, card.temp_bytes]
        if any(p is not None for p in parts):
            return sum(p for p in parts if p is not None)
    return None
