"""Golden probes: replay the seeded golden set through the live fleet and
account drift against anchors pinned on disk (JAX counterpart:
speakingstyle_tpu/serving/probes.py:70-526).

The validators (obs/quality.py) catch audio that is plainly broken. A
quantisation regression or a poisoned weight tree can ship audio that
passes every cheap check and is still garbage. The probes close that gap
as the rollout canary and the tier gate do: the seeded golden corpus
(``lifecycle.make_golden_set``) replayed through the live routers, its
mels compared with anchors pinned while the fleet was known to be healthy.

**Anchors** (``pin_anchors``): one ``<tier>/<golden id>.npz`` (key ``mel``)
per tier, one ``style/<golden id>.npz`` (``gamma``, ``beta``) when a
StyleService rides along, and a ``manifest.json`` of each array's sha256
(``obs.buildinfo.array_sha256``), every file written atomically (temp,
fsync, ``os.replace``). The layout and the digests are the JAX package's,
so either package reads the anchors the other pinned. ``load_anchors``
checks every digest: a corrupted or swapped anchor raises instead of
re-baselining the drift to zero.

**Probing** (``GoldenProber``): fresh copies of the golden set ride the
probe class (``serve.quality.probe_class``), which the fleet router keeps
out of its autoscaler signals, shed counts and latency SLO. Per tier it
publishes ``serve_probe_mel_drift{tier}`` (the worst RMS mel distance
against the anchor: the tier gate's arithmetic, non-finite reads as inf),
``serve_probe_total{tier,outcome}`` (ok / drift / error),
``serve_probe_style_drift`` (the worst FiLM (gamma, beta) RMS distance,
through the cache-bypassing ``StyleService.encode_live``) and
``serve_probe_last_unix_ts``; it feeds each comparison into the probe
class's quality SLO stream, and emits ``probe_drift_alert`` /
``probe_drift_resolved`` on each transition. Availability failures count
as probe errors and stay out of the quality stream.

The prober is a stop-aware background thread (``Event.wait`` is its
timer); tests and the chip phase build it with ``start=False`` and call
``probe_once()``.
"""

import io
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from speakingstyle_torch.obs import MetricsRegistry, make_lock
from speakingstyle_torch.obs.buildinfo import array_sha256
from speakingstyle_torch.serving.engine import SynthesisRequest
from speakingstyle_torch.serving.lifecycle import make_golden_set
from speakingstyle_torch.serving.tiers import parse_tier

__all__ = ["GoldenProber", "load_anchors", "pin_anchors", "probe_targets"]

MANIFEST = "manifest.json"


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Temp file, fsync, rename in the target directory: a reader sees the
    old anchor or the new one, never a torn write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _save_npz(path: str, **arrays) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_write_bytes(path, buf.getvalue())


def probe_targets(router) -> List[Tuple[str, object]]:
    """(tier name, tier router) pairs to probe. A TierRouter gives every
    registered tier, shipped or not (a tier out of the routing table may
    serve tomorrow); a plain FleetRouter is one target under its tier."""
    if hasattr(router, "tiers") and hasattr(router, "router_for"):
        return [(t, router.router_for(t)) for t in router.tiers()]
    return [(getattr(router, "tier", None) or "default", router)]


def _tier_precision(tier: str) -> Optional[str]:
    """The precision stamped on probes aimed at ``tier``; None for a label
    that is not a tier name (a bare FleetRouter's 'default')."""
    try:
        return parse_tier(tier).precision
    except ValueError:
        return None


def _mel_drift(mel, anchor) -> float:
    """RMS mel distance over the overlapping prefix (the tier gate's
    arithmetic): non-finite or empty output reads as infinite drift."""
    m = np.asarray(mel, dtype=np.float32)
    a = np.asarray(anchor, dtype=np.float32)
    if not np.all(np.isfinite(m)):
        return float("inf")
    t = min(m.shape[0], a.shape[0])
    if t == 0:
        return float("inf")
    return float(np.sqrt(np.mean(np.square(m[:t] - a[:t]))))


def _style_drift(gamma, beta, a_gamma, a_beta) -> float:
    """RMS distance of the concatenated FiLM (gamma, beta) against the
    pinned pair; non-finite reads as infinite drift."""
    live = np.concatenate([np.asarray(gamma, np.float32).ravel(),
                           np.asarray(beta, np.float32).ravel()])
    anchor = np.concatenate([np.asarray(a_gamma, np.float32).ravel(),
                             np.asarray(a_beta, np.float32).ravel()])
    if not np.all(np.isfinite(live)) or live.shape != anchor.shape:
        return float("inf")
    return float(np.sqrt(np.mean(np.square(live - anchor))))


def _mint_probes(cfg, tier: str, probe_class: str) -> List[SynthesisRequest]:
    """A fresh copy of the golden set aimed at one tier on the probe class
    (run() updates requests in place, so every round mints anew)."""
    tiers = cfg.serve.tiers
    precision = _tier_precision(tier)
    return [SynthesisRequest(id=g.id, sequence=g.sequence.copy(),
                             ref_mel=None if g.ref_mel is None else g.ref_mel.copy(),
                             priority=probe_class, precision=precision)
            for g in make_golden_set(cfg, tiers.golden_set_size, tiers.golden_seed)]


def pin_anchors(router, cfg, anchor_dir: str, style=None) -> Dict:
    """Replay the golden set through every live tier and pin the outputs
    in ``anchor_dir``; returns the manifest. Drift is measured against
    this moment: call it only on a fleet known to be healthy."""
    tiers_cfg = cfg.serve.tiers
    qcfg = cfg.serve.quality
    os.makedirs(anchor_dir, exist_ok=True)
    manifest: Dict = {"golden_seed": tiers_cfg.golden_seed,
                      "golden_size": tiers_cfg.golden_set_size,
                      "pinned_unix_ts": time.time(), "tiers": {}, "style": {}}
    for tier, target in probe_targets(router):
        reqs = _mint_probes(cfg, tier, qcfg.probe_class)
        futs = [target.submit(r) for r in reqs]
        results = [f.result(timeout=qcfg.probe_deadline_ms / 1e3 + 60.0) for f in futs]
        os.makedirs(os.path.join(anchor_dir, tier), exist_ok=True)
        entries = {}
        for req, res in zip(reqs, results):
            mel = np.asarray(res.mel, np.float32)[: int(res.mel_len)]
            fname = os.path.join(tier, f"{req.id}.npz")
            _save_npz(os.path.join(anchor_dir, fname), mel=mel)
            entries[req.id] = {"file": fname, "mel_sha256": array_sha256(mel)}
        manifest["tiers"][tier] = entries
    if style is not None:
        os.makedirs(os.path.join(anchor_dir, "style"), exist_ok=True)
        for g in make_golden_set(cfg, tiers_cfg.golden_set_size, tiers_cfg.golden_seed):
            if g.ref_mel is None:
                continue
            sv = style.encode_live(g.ref_mel)
            fname = os.path.join("style", f"{g.id}.npz")
            _save_npz(os.path.join(anchor_dir, fname), gamma=sv.gamma, beta=sv.beta)
            manifest["style"][g.id] = {"file": fname, "gamma_sha256": array_sha256(sv.gamma),
                                       "beta_sha256": array_sha256(sv.beta)}
    _atomic_write_bytes(os.path.join(anchor_dir, MANIFEST),
                        json.dumps(manifest, indent=2, sort_keys=True).encode())
    return manifest


def load_anchors(anchor_dir: str) -> Tuple[Dict, Dict, Dict]:
    """(manifest, {tier: {golden id: mel}}, {golden id: (gamma, beta)}),
    every array checked against its manifest digest."""
    with open(os.path.join(anchor_dir, MANIFEST)) as f:
        manifest = json.load(f)
    mels: Dict[str, Dict[str, np.ndarray]] = {}
    for tier, entries in manifest.get("tiers", {}).items():
        mels[tier] = {}
        for gid, entry in entries.items():
            with np.load(os.path.join(anchor_dir, entry["file"])) as z:
                mel = z["mel"]
            if array_sha256(mel) != entry["mel_sha256"]:
                raise ValueError(
                    f"anchor digest mismatch for tier {tier!r} golden {gid!r} "
                    f"({entry['file']}): refusing to probe against a corrupted baseline")
            mels[tier][gid] = mel
    styles: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for gid, entry in manifest.get("style", {}).items():
        with np.load(os.path.join(anchor_dir, entry["file"])) as z:
            gamma, beta = z["gamma"], z["beta"]
        if (array_sha256(gamma) != entry["gamma_sha256"]
                or array_sha256(beta) != entry["beta_sha256"]):
            raise ValueError(
                f"style anchor digest mismatch for golden {gid!r} ({entry['file']})")
        styles[gid] = (gamma, beta)
    return manifest, mels, styles


class GoldenProber:
    """A stop-aware background prober over a live router (a fleet or a
    tier router). ``start=False`` with ``probe_once()`` drives it by hand."""

    def __init__(self, router, cfg, style=None, registry=None, events=None,
                 anchor_dir: Optional[str] = None, start: bool = True):
        self.router = router
        self.cfg = cfg
        self.qcfg = cfg.serve.quality
        self.style = style
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events = events
        self.anchor_dir = anchor_dir or self.qcfg.anchor_dir
        if not self.anchor_dir:
            raise ValueError(
                "GoldenProber needs an anchor_dir (argument or serve.quality.anchor_dir)")
        self._manifest: Optional[Dict] = None
        self._anchor_mels: Dict[str, Dict[str, np.ndarray]] = {}
        self._anchor_styles: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._lock = make_lock("GoldenProber._lock")
        self._alerting: Dict[str, bool] = {}
        self._last: Dict[str, Dict] = {}
        self._style_drift: Optional[float] = None
        self._style_alerting = False
        self._rounds = 0
        self._last_ts: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._loop, name="golden-prober",
                                            daemon=True)
            self._thread.start()

    # -- anchors -------------------------------------------------------------

    @property
    def pinned(self) -> bool:
        return self._manifest is not None

    def pin(self) -> Dict:
        """Pin anchors from the fleet as it is now, and load them."""
        manifest = pin_anchors(self.router, self.cfg, self.anchor_dir, style=self.style)
        self._load()
        return manifest

    def _load(self) -> None:
        self._manifest, self._anchor_mels, self._anchor_styles = load_anchors(self.anchor_dir)

    def ensure_anchors(self) -> None:
        """Load the anchors pinned on disk, or pin them (the background
        loop's first step: at boot the fleet has just passed its warm-up)."""
        if self.pinned:
            return
        if os.path.exists(os.path.join(self.anchor_dir, MANIFEST)):
            self._load()
        else:
            self.pin()

    # -- one round -----------------------------------------------------------

    def _quality_stream(self, total: int, bad: int) -> None:
        """Golden comparisons into the probe class's quality SLO stream."""
        labels = {"class": self.qcfg.probe_class}
        if total:
            self.registry.counter(
                "serve_quality_class_total", labels=labels,
                help="per-class quality stream: audio outputs checked (validator verdicts + "
                     "probe comparisons)").inc(total)
        if bad:
            self.registry.counter(
                "serve_quality_class_fail_total", labels=labels,
                help="per-class quality stream: outputs judged bad").inc(bad)

    def _edge(self, label: str, firing: bool, **fields) -> None:
        """The drift alert of a tier (or 'style'), on its transitions only."""
        was = self._alerting.get(label, False)
        if firing == was:
            return
        self._alerting[label] = firing
        if firing:
            self.registry.counter("serve_probe_drift_alerts_total", labels={"tier": label},
                                  help="probe_drift_alert transitions fired per tier").inc()
        if self.events is not None:
            self.events.emit("probe_drift_alert" if firing else "probe_drift_resolved",
                             tier=label, **fields)

    def _probe_tier(self, tier: str, target, anchors: Dict[str, np.ndarray]) -> Dict:
        """Submit the golden set to one tier and compare with its anchors."""
        qcfg = self.qcfg
        outcomes = {"ok": 0, "drift": 0, "error": 0}
        worst = 0.0
        checked = bad = 0
        pending = []
        for r in _mint_probes(self.cfg, tier, qcfg.probe_class):
            try:
                pending.append((r, target.submit(r)))
            except Exception as e:
                outcomes["error"] += 1
                if self.events is not None:
                    self.events.emit("probe_error", tier=tier, golden=r.id, stage="submit",
                                     error=str(e))
        for r, fut in pending:
            try:
                res = fut.result(timeout=qcfg.probe_deadline_ms / 1e3 + 60.0)
            except Exception as e:
                # availability, not quality: a probe error, out of the
                # quality stream (liveness is the fleet's supervision's)
                outcomes["error"] += 1
                if self.events is not None:
                    self.events.emit("probe_error", tier=tier, golden=r.id, stage="result",
                                     error=str(e))
                continue
            anchor = anchors.get(r.id)
            if anchor is None:
                continue
            drift = _mel_drift(res.mel, anchor)
            worst = max(worst, drift)
            checked += 1
            if drift > qcfg.probe_mel_tolerance:
                outcomes["drift"] += 1
                bad += 1
            else:
                outcomes["ok"] += 1
        for outcome, n in outcomes.items():
            if n:
                self.registry.counter("serve_probe_total",
                                      labels={"tier": tier, "outcome": outcome},
                                      help="golden probe comparisons per tier and outcome").inc(n)
        self.registry.gauge("serve_probe_mel_drift", labels={"tier": tier},
                            help="worst golden-set RMS mel drift vs the pinned anchor, latest "
                                 "probe round").set(worst)
        self._quality_stream(checked, bad)
        self._edge(tier, bool(checked) and worst > qcfg.probe_mel_tolerance,
                   mel_drift=round(worst, 4) if np.isfinite(worst) else worst,
                   tolerance=qcfg.probe_mel_tolerance)
        with self._lock:
            self._last[tier] = {"mel_drift": worst, "outcomes": dict(outcomes)}
        return {"mel_drift": worst, "outcomes": dict(outcomes)}

    def _probe_style(self) -> float:
        """The golden references through ``encode_live`` against the pinned
        (gamma, beta)."""
        qcfg = self.qcfg
        worst = 0.0
        checked = bad = 0
        tiers = self.cfg.serve.tiers
        for g in make_golden_set(self.cfg, tiers.golden_set_size, tiers.golden_seed):
            anchor = self._anchor_styles.get(g.id)
            if anchor is None or g.ref_mel is None:
                continue
            sv = self.style.encode_live(g.ref_mel)
            drift = _style_drift(sv.gamma, sv.beta, *anchor)
            worst = max(worst, drift)
            checked += 1
            if drift > qcfg.probe_style_tolerance:
                bad += 1
        self.registry.gauge("serve_probe_style_drift",
                            help="worst golden-set FiLM (gamma, beta) RMS drift vs the pinned "
                                 "baseline, latest probe round").set(worst)
        self._quality_stream(checked, bad)
        self._edge("style", bool(checked) and worst > qcfg.probe_style_tolerance,
                   style_drift=round(worst, 4) if np.isfinite(worst) else worst,
                   tolerance=qcfg.probe_style_tolerance)
        with self._lock:
            self._style_drift = worst
            self._style_alerting = self._alerting.get("style", False)
        return worst

    def probe_once(self) -> Dict:
        """One round over every tier: submit, compare, publish. Returns the
        round's summary."""
        self.ensure_anchors()
        summary: Dict = {"tiers": {}, "style_drift": None}
        for tier, target in probe_targets(self.router):
            anchors = self._anchor_mels.get(tier)
            if anchors:
                summary["tiers"][tier] = self._probe_tier(tier, target, anchors)
        if self.style is not None and self._anchor_styles:
            summary["style_drift"] = self._probe_style()
        now = time.time()
        with self._lock:
            self._rounds += 1
            self._last_ts = now
            rounds = self._rounds
        self.registry.gauge("serve_probe_last_unix_ts",
                            help="wall-clock time of the last completed probe round (probe "
                                 "freshness for /healthz)").set(now)
        if self.events is not None:
            self.events.emit("probe_round", round=rounds,
                             tiers={t: s["mel_drift"] for t, s in summary["tiers"].items()},
                             style_drift=summary["style_drift"])
        summary["round"] = rounds
        return summary

    # -- surface -------------------------------------------------------------

    def alerting(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._alerting)

    def status(self) -> Dict:
        """The /healthz ``quality.probes`` block: freshness, drift per tier,
        style drift and the alert states."""
        with self._lock:
            return {
                "pinned": self.pinned,
                "anchor_dir": self.anchor_dir,
                "rounds": self._rounds,
                "last_unix_ts": self._last_ts,
                "interval_s": self.qcfg.probe_interval_s,
                "mel_tolerance": self.qcfg.probe_mel_tolerance,
                "style_tolerance": self.qcfg.probe_style_tolerance,
                "tiers": {t: {"mel_drift": s["mel_drift"], "outcomes": dict(s["outcomes"]),
                              "alerting": self._alerting.get(t, False)}
                          for t, s in self._last.items()},
                "style_drift": self._style_drift,
                "style_alerting": self._style_alerting,
            }

    # -- lifecycle -----------------------------------------------------------

    def _loop(self) -> None:
        # Event.wait is the interval timer, so close() wakes a parked prober
        while not self._stop.wait(self.qcfg.probe_interval_s):
            try:
                self.probe_once()
            except Exception as e:  # a failed round must not end the loop
                if self.events is not None:
                    self.events.emit("probe_error", error=str(e))

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
