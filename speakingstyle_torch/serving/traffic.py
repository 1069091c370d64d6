"""A seeded, deterministic traffic model (JAX counterpart:
speakingstyle_tpu/serving/traffic.py:63-235, copied whole).

Real load has a shape: a diurnal rate curve (a day compressed into the
run), flash crowds that multiply the rate about tenfold without warning, a
priority mix (interactive requests on the tight SLO class, batch and
long-form jobs on the loose one) and a zipf-skewed style population (a few
hot voices and a long tail that exercises the style cache).

``TrafficModel`` turns those knobs into an arrival schedule: ``schedule()``
returns ``TrafficEvent``s (arrival offset, kind, priority class, zipf style
rank, relative length) drawn by thinning an inhomogeneous Poisson process
from one seeded generator. The same arguments give the identical schedule
on every host, the JAX package's bit for bit, so a replay is reproducible
and a change in shed or scale behaviour cannot hide behind workload noise.
A long-form event's ``length_frac`` > 1 is a chapter past the interactive
lattice, for ``POST /synthesize/longform``.

Host only (numpy): building a schedule touches no device.
"""

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TrafficEvent", "TrafficModel", "DEFAULT_MIX", "DEFAULT_PRIORITY_MAP"]

# traffic kinds and the router's SLO classes they ride: long-form jobs are
# batch-class chapters (length_frac > 1: past the interactive lattice, for
# /synthesize/longform, where a chapter becomes a deadline-sharing chunk
# group), so the router needs no third class for them
DEFAULT_MIX: Dict[str, float] = {
    "interactive": 0.6,
    "batch": 0.3,
    "long_form": 0.1,
}
DEFAULT_PRIORITY_MAP: Dict[str, str] = {
    "interactive": "interactive",
    "batch": "batch",
    "long_form": "batch",
}
# relative utterance length per kind: (lo, hi) fractions of the longest
# interactively admissible request. Long-form draws REAL chapter
# lengths — multiples of the interactive ceiling — so a traffic replay
# exercises the long-form admission path instead of merely pinning the
# top interactive bucket
_LENGTH_RANGES: Dict[str, Tuple[float, float]] = {
    "interactive": (0.25, 0.5),
    "batch": (0.4, 0.8),
    "long_form": (2.0, 8.0),
}


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    """One synthetic arrival: offset from storm start plus request shape."""

    t: float            # seconds from schedule start
    kind: str           # interactive | batch | long_form
    priority: str       # the router SLO class the kind rides
    style: int          # zipf-ranked style index (0 = hottest voice)
    length_frac: float  # utterance length as a fraction of the max
                        # interactive request; > 1 = a long-form chapter


class TrafficModel:
    """Deterministic arrival-schedule generator.

    ``rate_at(t)`` is the instantaneous offered rate: a diurnal curve
    (one ``diurnal_period_s`` cycle rising from ``diurnal_floor`` *
    ``base_qps`` to ``base_qps`` and back) multiplied by
    ``flash_multiplier`` inside each ``flash_windows`` span. Arrivals
    are drawn by thinning a homogeneous Poisson stream at the peak rate,
    so the empirical rate tracks ``rate_at`` without any time-stepping
    artifacts.
    """

    def __init__(
        self,
        seed: int = 0,
        base_qps: float = 20.0,
        duration_s: float = 9.0,
        diurnal_period_s: Optional[float] = None,
        diurnal_floor: float = 0.5,
        flash_windows: Sequence[Tuple[float, float]] = (),
        flash_multiplier: float = 10.0,
        mix: Optional[Dict[str, float]] = None,
        priority_map: Optional[Dict[str, str]] = None,
        n_styles: int = 64,
        zipf_s: float = 1.2,
    ):
        if base_qps <= 0:
            raise ValueError(f"base_qps must be > 0, got {base_qps}")
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        if not (0.0 < diurnal_floor <= 1.0):
            raise ValueError(
                f"diurnal_floor must be in (0, 1], got {diurnal_floor}"
            )
        if flash_multiplier < 1.0:
            raise ValueError(
                f"flash_multiplier must be >= 1, got {flash_multiplier}"
            )
        if n_styles < 1:
            raise ValueError(f"n_styles must be >= 1, got {n_styles}")
        if zipf_s <= 0:
            raise ValueError(f"zipf_s must be > 0, got {zipf_s}")
        self.seed = int(seed)
        self.base_qps = float(base_qps)
        self.duration_s = float(duration_s)
        self.diurnal_period_s = float(
            diurnal_period_s if diurnal_period_s is not None else duration_s
        )
        self.diurnal_floor = float(diurnal_floor)
        self.flash_windows = tuple(
            (float(a), float(b)) for a, b in flash_windows
        )
        for a, b in self.flash_windows:
            if not (0.0 <= a < b <= self.duration_s):
                raise ValueError(
                    f"flash window ({a}, {b}) must satisfy 0 <= start < "
                    f"end <= duration_s ({self.duration_s})"
                )
        self.flash_multiplier = float(flash_multiplier)
        self.mix = dict(mix) if mix is not None else dict(DEFAULT_MIX)
        if not self.mix or any(w < 0 for w in self.mix.values()) \
                or sum(self.mix.values()) <= 0:
            raise ValueError(f"mix must have positive total weight: {self.mix}")
        unknown = set(self.mix) - set(_LENGTH_RANGES)
        if unknown:
            raise ValueError(
                f"unknown traffic kinds {sorted(unknown)}; known: "
                f"{sorted(_LENGTH_RANGES)}"
            )
        self.priority_map = dict(
            priority_map if priority_map is not None else DEFAULT_PRIORITY_MAP
        )
        missing = set(self.mix) - set(self.priority_map)
        if missing:
            raise ValueError(
                f"priority_map missing traffic kinds {sorted(missing)}"
            )
        self.n_styles = int(n_styles)
        self.zipf_s = float(zipf_s)
        # bounded zipf pmf over ranks 1..n_styles: p(k) proportional to
        # k^-s (numpy's rng.zipf is unbounded — a catalog is not)
        ranks = np.arange(1, self.n_styles + 1, dtype=np.float64)
        pmf = ranks ** -self.zipf_s
        self._style_pmf = pmf / pmf.sum()

    # -- rate curve ----------------------------------------------------------

    def diurnal_at(self, t: float) -> float:
        """The [floor, 1] diurnal factor: one raised-cosine cycle per
        period — trough at t=0 (night), peak mid-period (the day)."""
        phase = 0.5 * (1.0 - math.cos(
            2.0 * math.pi * (t % self.diurnal_period_s)
            / self.diurnal_period_s
        ))
        return self.diurnal_floor + (1.0 - self.diurnal_floor) * phase

    def flash_at(self, t: float) -> float:
        for a, b in self.flash_windows:
            if a <= t < b:
                return self.flash_multiplier
        return 1.0

    def rate_at(self, t: float) -> float:
        """Offered requests/second at offset ``t``."""
        return self.base_qps * self.diurnal_at(t) * self.flash_at(t)

    @property
    def peak_rate(self) -> float:
        """The thinning envelope: diurnal peak times the flash factor
        (only applied when a flash window exists)."""
        flash = self.flash_multiplier if self.flash_windows else 1.0
        return self.base_qps * flash

    # -- schedule ------------------------------------------------------------

    def schedule(self) -> List[TrafficEvent]:
        """The full deterministic arrival schedule, sorted by ``t``.

        A fresh generator is seeded per call, so repeated calls (and
        repeated processes) return the identical list.
        """
        rng = np.random.default_rng(self.seed)
        kinds = sorted(self.mix)
        weights = np.array([self.mix[k] for k in kinds], dtype=np.float64)
        weights /= weights.sum()
        events: List[TrafficEvent] = []
        peak = self.peak_rate
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= self.duration_s:
                break
            # thinning: accept with prob rate(t)/peak — the accepted
            # stream is inhomogeneous Poisson at exactly rate_at
            if float(rng.random()) * peak > self.rate_at(t):
                continue
            kind = kinds[int(rng.choice(len(kinds), p=weights))]
            lo, hi = _LENGTH_RANGES[kind]
            frac = lo if lo == hi else float(rng.uniform(lo, hi))
            events.append(TrafficEvent(
                t=t,
                kind=kind,
                priority=self.priority_map[kind],
                style=int(rng.choice(self.n_styles, p=self._style_pmf)),
                length_frac=frac,
            ))
        return events

    def describe(self) -> Dict:
        """The capacity artifact's workload-provenance block."""
        return {
            "seed": self.seed,
            "base_qps": self.base_qps,
            "duration_s": self.duration_s,
            "diurnal_period_s": self.diurnal_period_s,
            "diurnal_floor": self.diurnal_floor,
            "flash_windows": [list(w) for w in self.flash_windows],
            "flash_multiplier": self.flash_multiplier,
            "mix": dict(self.mix),
            "n_styles": self.n_styles,
            "zipf_s": self.zipf_s,
        }
