"""Audio-quality validators: the choke point every wav passes before it
leaves the process (copied from speakingstyle_tpu/obs/quality.py; plain
numpy).

``validate_wav`` is a cheap host-side check of one finished int16 (or
float) wav, and ``QualityGate`` the choke point the engine's two audio
paths call: the full-utterance batch path (``SynthesisEngine.run``) and
the streaming window path (``vocode_collect``).

Checks (all numpy over the emitted samples; one rFFT over a bounded
prefix is the most expensive):

  ``non_finite``   any NaN/Inf in the float wav *before* the int16
                   conversion clipped it away (callers pass the
                   pre-conversion ``finite=`` hint);
  ``clipping``     fraction of samples at >= ``CLIP_LEVEL`` of full
                   scale above ``clip_fraction_max``;
  ``silence``      longest exact-zero run above ``silence_run_ms_max``;
  ``dc_offset``    |mean| of the normalised wav above ``dc_offset_max``;
  ``flatness``     spectral flatness (geometric / arithmetic power
                   mean, DC bin excluded) above ``flatness_max``.

Verdicts land as ``serve_quality_*`` counters and histograms per class
and tier. ``trace`` stays duck-typed (anything with a ``trace_id``, or a
string): the fleet binds the trace ring and tail sampler the gate pins a
failing wav's trace in (``bind``, from ``serving/fleet.py`` when it warms a
replica), and a gate outside a fleet, unbound, pins nothing.
"""

import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CLIP_LEVEL",
    "QUALITY_REASONS",
    "QualityGate",
    "WavVerdict",
    "last_fail",
    "validate_wav",
]

# full-scale fraction at or above which a sample counts as clipped;
# an int16 rail (32767/32768 = 0.99997) always qualifies
CLIP_LEVEL = 0.999

# the bounded reason vocabulary (JL026: reasons are metric labels)
QUALITY_REASONS = (
    "non_finite", "clipping", "silence", "dc_offset", "flatness",
)

# histogram edges for fraction-valued observations (clip fraction,
# spectral flatness) — both live in [0, 1]
FRACTION_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)

# flatness is computed over at most this many leading samples: one
# bounded rFFT per wav regardless of utterance length
_FLATNESS_WINDOW = 8192


@dataclass
class WavVerdict:
    """One validated wav: the boolean plus the measured evidence."""

    ok: bool
    reasons: Tuple[str, ...]
    clip_fraction: float
    silence_run_ms: float
    dc_offset: float
    flatness: float

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "reasons": list(self.reasons),
            "clip_fraction": round(self.clip_fraction, 6),
            "silence_run_ms": round(self.silence_run_ms, 3),
            "dc_offset": round(self.dc_offset, 6),
            "flatness": round(self.flatness, 6),
        }


def _longest_zero_run(wav: np.ndarray) -> int:
    """Length in samples of the longest exact-zero run."""
    z = wav == 0
    if not z.any():
        return 0
    edged = np.concatenate(([False], z, [False]))
    flips = np.flatnonzero(edged[1:] != edged[:-1])
    return int((flips[1::2] - flips[0::2]).max())


def _spectral_flatness(x: np.ndarray) -> float:
    """Geometric / arithmetic mean of the power spectrum (DC bin
    excluded) over a bounded prefix: ~1.0 for a stuck-at-constant
    signal, ~0.56 for white noise, far lower for speech."""
    seg = x[:_FLATNESS_WINDOW]
    power = np.abs(np.fft.rfft(seg)) ** 2
    power = power[1:]  # DC carries the offset, not the spectrum shape
    if power.size == 0:
        return 0.0
    eps = 1e-12
    geo = float(np.exp(np.mean(np.log(power + eps))))
    arith = float(np.mean(power)) + eps
    return min(1.0, geo / arith)


def validate_wav(
    wav: np.ndarray,
    sample_rate: int,
    qcfg,
    finite: Optional[bool] = None,
) -> WavVerdict:
    """Validate one wav (int16 samples, or float in [-1, 1]) against
    the ``QualityConfig`` thresholds.

    ``finite`` is the caller's verdict on the *pre-conversion* float
    samples — ``np.clip(...).astype(np.int16)`` erases NaN/Inf
    evidence, so the engine computes ``np.isfinite(wav_f).all()``
    before converting and passes it down. ``None`` means "check here"
    (meaningful only for float input).
    """
    wav = np.asarray(wav)
    if wav.size == 0:
        return WavVerdict(True, (), 0.0, 0.0, 0.0, 0.0)
    if np.issubdtype(wav.dtype, np.integer):
        x = wav.astype(np.float32) / 32768.0
        is_finite = True if finite is None else bool(finite)
    else:
        x = wav.astype(np.float32)
        is_finite = (
            bool(np.isfinite(x).all()) if finite is None else bool(finite)
        )
        if not is_finite:
            x = np.nan_to_num(x, posinf=1.0, neginf=-1.0)

    reasons = []
    if not is_finite:
        reasons.append("non_finite")
    clip_fraction = float(np.mean(np.abs(x) >= CLIP_LEVEL))
    if clip_fraction > qcfg.clip_fraction_max:
        reasons.append("clipping")
    silence_run_ms = _longest_zero_run(wav) * 1e3 / float(sample_rate)
    if silence_run_ms > qcfg.silence_run_ms_max:
        reasons.append("silence")
    dc_offset = float(abs(x.mean()))
    if dc_offset > qcfg.dc_offset_max:
        reasons.append("dc_offset")
    if wav.size >= qcfg.flatness_min_samples:
        flatness = _spectral_flatness(x)
        if flatness > qcfg.flatness_max:
            reasons.append("flatness")
    else:
        flatness = 0.0  # too short for a meaningful spectrum
    return WavVerdict(
        ok=not reasons,
        reasons=tuple(reasons),
        clip_fraction=clip_fraction,
        silence_run_ms=silence_run_ms,
        dc_offset=dc_offset,
        flatness=flatness,
    )


# -- last-fail record (for /healthz) ----------------------------------------

_last_fail_lock = threading.Lock()
_last_fail: Optional[dict] = None


def last_fail() -> Optional[dict]:
    """The most recent validator failure in this process (any gate),
    or None — the ``/healthz`` quality block's "what broke last"."""
    with _last_fail_lock:
        return dict(_last_fail) if _last_fail is not None else None


def _note_fail(record: dict) -> None:
    global _last_fail
    with _last_fail_lock:
        _last_fail = record


class QualityGate:
    """The serving choke point: validate one wav, account the verdict.

    Constructed once per engine (and once in the HTTP server for
    boundary re-checks) from ``serve.quality``; the fleet binds the
    tier name, trace ring, and tail sampler after warm-up so failing
    wavs pin their traces exactly like latency incidents do.

    ``check`` cost is a few numpy passes over the emitted samples plus
    one bounded rFFT.
    """

    def __init__(
        self,
        qcfg,
        sample_rate: int,
        registry=None,
        events=None,
        tier: Optional[str] = None,
        trace_ring=None,
        tail_sampler=None,
    ):
        self.cfg = qcfg
        self.sample_rate = int(sample_rate)
        self.registry = registry
        self.events = events
        self.tier = tier
        self.trace_ring = trace_ring
        self.tail_sampler = tail_sampler
        self.checked = 0
        self.failed = 0
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.cfg is not None and bool(
            getattr(self.cfg, "enabled", True)
        )

    def bind(
        self, tier=None, trace_ring=None, tail_sampler=None, events=None,
    ) -> None:
        """Late-bind fleet context (tier name, trace plumbing): the
        engine exists before the router that owns these."""
        if tier is not None:
            self.tier = tier
        if trace_ring is not None:
            self.trace_ring = trace_ring
        if tail_sampler is not None:
            self.tail_sampler = tail_sampler
        if events is not None:
            self.events = events

    def check(
        self,
        wav: np.ndarray,
        klass: Optional[str] = None,
        tier: Optional[str] = None,
        source: str = "engine",
        finite: Optional[bool] = None,
        trace=None,
        req_id: Optional[str] = None,
        record: bool = True,
    ) -> WavVerdict:
        """Validate ``wav``; with ``record`` (the default) the verdict
        lands on the metrics/SLO/trace/event planes. ``record=False``
        is the HTTP boundary's re-check of an already-accounted wav."""
        if not self.enabled:
            return WavVerdict(True, (), 0.0, 0.0, 0.0, 0.0)
        verdict = validate_wav(wav, self.sample_rate, self.cfg, finite=finite)
        with self._lock:
            self.checked += 1
            if not verdict.ok:
                self.failed += 1
        if not record:
            return verdict
        klass = klass or "default"
        tier = tier or self.tier or "default"
        if self.registry is not None:
            self.registry.counter(
                "serve_quality_checks_total",
                labels={"class": klass, "tier": tier, "source": source},
                help="wavs through the quality choke point",
            ).inc()
            self.registry.histogram(
                "serve_quality_clip_fraction", edges=FRACTION_BUCKETS,
                labels={"tier": tier},
                help="fraction of samples at full scale, per wav",
            ).observe(verdict.clip_fraction)
            self.registry.histogram(
                "serve_quality_flatness", edges=FRACTION_BUCKETS,
                labels={"tier": tier},
                help="spectral flatness per wav (stuck signals -> 1.0)",
            ).observe(verdict.flatness)
            # the SLO engine's quality good/bad stream (obs/slo.py)
            self.registry.counter(
                "serve_quality_class_total", labels={"class": klass},
                help="quality SLO stream: validated wavs per class",
            ).inc()
            if not verdict.ok:
                for reason in verdict.reasons:
                    self.registry.counter(
                        "serve_quality_fail_total",
                        labels={
                            "class": klass, "tier": tier, "reason": reason,
                        },
                        help="validator failures by reason",
                    ).inc()
                self.registry.counter(
                    "serve_quality_class_fail_total", labels={"class": klass},
                    help="quality SLO stream: failed wavs per class",
                ).inc()
        if not verdict.ok:
            trace_id = getattr(trace, "trace_id", None) or (
                trace if isinstance(trace, str) else None
            )
            if (
                trace_id
                and self.tail_sampler is not None
                and self.trace_ring is not None
                and self.tail_sampler.keep(trace_id, "quality_fail")
            ):
                self.trace_ring.pin(trace_id)
            fail = {
                "ts": time.time(),
                "req_id": req_id,
                "trace_id": trace_id,
                "class": klass,
                "tier": tier,
                "source": source,
                **verdict.as_dict(),
            }
            _note_fail(fail)
            if self.events is not None:
                self.events.emit("quality_fail", **{
                    k: v for k, v in fail.items() if k != "ts"
                })
        return verdict

    def check_result(self, result, source: str = "server",
                     record: bool = False) -> Optional[WavVerdict]:
        """The HTTP boundary helper: reuse the engine's attached
        verdict when present, else validate the result's wav here.
        Returns None when the result carries no wav (mel-only)."""
        verdict = getattr(result, "quality", None)
        if verdict is not None:
            return verdict
        wav = getattr(result, "wav", None)
        if wav is None:
            return None
        return self.check(
            wav,
            klass=getattr(result, "priority", None),
            tier=getattr(result, "tier", None),
            source=source,
            trace=getattr(result, "trace", None),
            req_id=getattr(result, "id", None),
            record=record,
        )

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "checked": self.checked,
                "failed": self.failed,
            }
