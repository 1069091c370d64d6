"""The request frontend: G2P, the speaker registry, style resolution, and
the worker pool that overlaps them with the batcher's coalescing wait (JAX
counterparts: ``TextFrontend``, ``confined_ref_path`` and ``load_ref_mel``
of speakingstyle_tpu/serving/server.py, and
speakingstyle_tpu/serving/frontend.py).

``TextFrontend.request`` turns one JSON payload into a
``SynthesisRequest``: text through the G2P (per-word control lists through
the span-preserving English G2P of control.py), the speaker through
``speakers.json``, and the style in the order ``style_id`` (a cache lookup
in the engine's StyleService), then ``ref_audio`` (a path confined to
``serve.style.ref_dir``, content-addressed through the StyleService), then
the server's default reference. A style encoder failure (not a client
error) degrades the request to the default style with ``style_degraded``.

``FrontendPool`` runs ``TextFrontend.request`` on ``serve.frontend_workers``
threads. The HTTP handler mints a ``PendingRequest`` (id, arrival,
priority, stream flag: what admission needs before G2P), submits it to the
batcher, and only then enqueues the G2P, so the frontend's cost hides under
the coalescing wait. The dispatch thread resolves the handle before it
runs the batch; a frontend error resolves the request's future with the
same error the inline path raises. A style miss encodes on the pool's
thread through the StyleService (as the JAX frontend does); the server's
precompile covers the whole style lattice, so that encode replays a
prepared program and never prepares one under traffic.
"""

import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.obs import JsonlEventLog, MetricsRegistry, Span, make_lock
from speakingstyle_torch.serving.batcher import ShutdownError
from speakingstyle_torch.serving.engine import SynthesisRequest

__all__ = ["FrontendPool", "PendingRequest", "RESOLVE_TIMEOUT_S", "TextFrontend",
           "confined_ref_path", "load_ref_mel"]

# how long the dispatch thread waits for a frontend handle: far above any
# G2P time; it only keeps a wedged worker from wedging the dispatch thread
# (expiry resolves the request as TimeoutError, a 504)
RESOLVE_TIMEOUT_S = 10.0


class TextFrontend:
    """Host-side request preparation for one config: G2P, the speaker
    registry and style resolution through ``style`` (the engine's
    StyleService, which the server wires in)."""

    def __init__(self, cfg: Config, default_ref_mel: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.default_ref_mel = default_ref_mel
        self.style = None
        self._lexicon = None  # read on the first per-word-control request
        pp = cfg.preprocess
        self.lexicon_path = pp.path.lexicon_path or None
        speakers_path = os.path.join(pp.path.preprocessed_path or "", "speakers.json")
        self.speaker_map: Dict[str, int] = {}
        if pp.path.preprocessed_path and os.path.exists(speakers_path):
            with open(speakers_path) as f:
                self.speaker_map = json.load(f)

    def sequence(self, text: str) -> np.ndarray:
        from speakingstyle_torch.text.g2p import preprocess_text

        t = self.cfg.preprocess.preprocessing.text
        return np.asarray(preprocess_text(text, t.language, self.lexicon_path,
                                          list(t.text_cleaners)), np.int32)

    def speaker(self, spec) -> int:
        """A speaker name from speakers.json, or a numeric id, which must
        fall inside the registry when one is loaded (an unknown id would
        index an untrained embedding row): the id, or ValueError."""
        if isinstance(spec, int):
            idx = spec
        else:
            s = str(spec)
            if s in self.speaker_map:
                return self.speaker_map[s]
            if not s.lstrip("-").isdigit():
                raise ValueError(f"unknown speaker {spec!r}")
            idx = int(s)
        if self.speaker_map and not (
                0 <= idx < max(len(self.speaker_map), max(self.speaker_map.values()) + 1)):
            raise ValueError(
                f"speaker id {idx} outside the registry (0..{len(self.speaker_map) - 1})"
            )
        return idx

    def resolve_style(self, payload: Dict):
        """(style vectors | None, ref_mel | None, degraded) for one payload;
        at most one of the first two is set."""
        if not self.cfg.model.use_reference_encoder:
            return None, None, False
        style_id = payload.get("style_id")
        ref_audio = payload.get("ref_audio")
        if style_id is not None and ref_audio is not None:
            raise ValueError('pass "style_id" OR "ref_audio", not both')
        if style_id is not None:
            if self.style is None:
                raise ValueError(
                    "style_id requires a style service (the model has no reference encoder)")
            entry = self.style.get(str(style_id))
            if entry is None:
                raise ValueError(
                    f"unknown style_id {style_id!r} (upload the reference via POST /styles first)"
                )
            return entry, None, False
        if ref_audio is not None:
            path = confined_ref_path(self.cfg, str(ref_audio))
            if self.style is not None:
                with open(path, "rb") as f:
                    data = f.read()
                return self._encode(lambda: self.style.encode_wav_bytes(data))
            return None, load_ref_mel(self.cfg, path), False
        if self.default_ref_mel is None:
            raise ValueError(
                'no reference style: pass "style_id" (POST /styles), "ref_audio" (a '
                "serve.style.ref_dir path), or start the server with --ref_audio"
            )
        if self.style is not None:
            return self._encode(lambda: self.style.encode_mel(self.default_ref_mel))
        return None, self.default_ref_mel, False

    def _encode(self, encode):
        """Run a style encode; a malformed reference (ValueError) is the
        client's 400, any other failure degrades to the default style and
        is counted on the StyleService's registry."""
        try:
            return encode(), None, False
        except ValueError:
            raise
        except Exception as e:
            self.style.registry.counter(
                "serve_style_encode_failures_total", labels={"error": type(e).__name__},
                help="reference-encoder dispatch failures absorbed by the fallback",
            ).inc()
            return self.style.fallback_style(), None, True

    def controls_and_sequence(self, text: str, payload: Dict):
        """(sequence, [p, e, d] controls). Scalars ride the plain G2P; a
        per-WORD list needs English text and expands to a per-phoneme
        array through the span-preserving G2P."""
        keys = ("pitch_control", "energy_control", "duration_control")
        raw = {}
        for key in keys:
            v = payload.get(key, 1.0)
            if isinstance(v, bool) or not (
                    isinstance(v, (int, float))
                    or (isinstance(v, list) and v
                        and all(isinstance(x, (int, float)) for x in v))):
                raise ValueError(f"{key} must be a number or a per-word list of numbers")
            raw[key] = v
        if not any(isinstance(v, list) for v in raw.values()):
            return self.sequence(text), [float(raw[k]) for k in keys]
        if self.cfg.preprocess.preprocessing.text.language != "en":
            raise ValueError("per-word control lists require English text (word spans come "
                             "from the English G2P)")
        from speakingstyle_torch.control import (
            english_word_spans,
            expand_word_controls,
            spans_to_sequence,
        )
        from speakingstyle_torch.text.g2p import read_lexicon

        if self._lexicon is None:
            self._lexicon = read_lexicon(self.lexicon_path) if self.lexicon_path else {}
        spans = english_word_spans(text, self._lexicon)
        sequence = spans_to_sequence(spans, self.cfg.preprocess.preprocessing.text.text_cleaners)
        controls = []
        for key in keys:
            v = raw[key]
            if isinstance(v, list):
                if len(v) != len(spans):
                    raise ValueError(f"{key} lists one factor per word: got {len(v)} factors "
                                     f"for {len(spans)} words")
                controls.append(np.asarray(expand_word_controls(spans, [float(x) for x in v]),
                                           np.float32))
            else:
                controls.append(float(v))
        return sequence, controls

    def request(self, req_id: str, payload: Dict):
        """One payload -> a SynthesisRequest (ValueError for the client's
        mistakes: the HTTP layer's 400)."""
        text = payload.get("text")
        if not text or not isinstance(text, str):
            raise ValueError('payload must carry a non-empty "text" string')
        priority = payload.get("priority")
        if priority is not None and not isinstance(priority, str):
            raise ValueError("priority must be a string class name")
        style_vec, ref_mel, degraded = self.resolve_style(payload)
        spec = payload.get("speaker_id", payload.get("speaker"))
        speaker = self.speaker(spec) if spec is not None else 0
        # a style bound to a registry speaker drives that speaker and
        # refuses a different explicit one
        if style_vec is not None and style_vec.speaker is not None:
            bound = self.speaker(style_vec.speaker)
            if spec is None:
                speaker = bound
            elif speaker != bound:
                raise ValueError(
                    f"style {style_vec.key[:12]}... is bound to speaker {style_vec.speaker!r}; "
                    "request named a different speaker")
        sequence, (p_c, e_c, d_c) = self.controls_and_sequence(text, payload)
        return SynthesisRequest(
            id=req_id, sequence=sequence, ref_mel=ref_mel, style=style_vec, speaker=speaker,
            raw_text=text, p_control=p_c, e_control=e_c, d_control=d_c, priority=priority,
            style_degraded=degraded,
        )


def confined_ref_path(cfg: Config, path: str) -> str:
    """A request's server-side reference path resolved inside
    ``serve.style.ref_dir``. Absolute paths, ``..`` segments and symlink
    escapes raise ValueError (HTTP 400); with no ref_dir, path references
    are refused (uploads go through POST /styles)."""
    ref_dir = cfg.serve.style.ref_dir
    if not ref_dir:
        raise ValueError(
            'server-side "ref_audio" paths are disabled (serve.style.ref_dir is unset): '
            "upload the reference via POST /styles")
    norm = path.replace("\\", "/")
    if os.path.isabs(path) or ".." in norm.split("/"):
        raise ValueError(f"ref_audio path {path!r} escapes the reference directory")
    base = os.path.realpath(ref_dir)
    full = os.path.realpath(os.path.join(base, path))
    if os.path.commonpath([base, full]) != base:
        raise ValueError(f"ref_audio path {path!r} escapes the reference directory")
    if not os.path.isfile(full):
        raise ValueError(f"ref_audio path {path!r} does not exist")
    return full


def load_ref_mel(cfg: Config, wav_path: str) -> np.ndarray:
    """Reference wav -> [T, n_mels] normalised log-mel, the style encoder's
    input (resampled to the config's rate). A trusted-path helper: the
    HTTP layer reaches it only through ``confined_ref_path``."""
    from speakingstyle_torch.audio.tools import load_wav
    from speakingstyle_torch.serving.style import mel_from_wav_array

    wav, _ = load_wav(wav_path, target_sr=cfg.preprocess.preprocessing.audio.sampling_rate)
    return mel_from_wav_array(cfg, wav)


class PendingRequest:
    """Submit-time stand-in for a request still in the frontend: ``id``,
    ``arrival`` (the SLO clock's origin), ``priority`` (type-checked here,
    so a malformed class is still a 400 at submit) and ``stream``.
    ``resolve()`` blocks for the SynthesisRequest or re-raises the
    frontend's error. ``pending`` is the marker the batcher checks."""

    pending = True

    def __init__(self, req_id: str, payload: Dict, stream: bool = False):
        priority = payload.get("priority")
        if priority is not None and not isinstance(priority, str):
            raise ValueError(
                f"priority must be a class-name string, got {type(priority).__name__}")
        self.id = req_id
        self.payload = payload
        self.stream = bool(stream)
        self.priority = priority
        self.arrival = time.monotonic()
        # the handler's root TraceContext, carried onto the resolved request
        self.trace = None
        self._future: Future = Future()

    def resolve(self, timeout: Optional[float] = RESOLVE_TIMEOUT_S):
        """Block for the resolved SynthesisRequest (or the frontend's error)."""
        return self._future.result(timeout=timeout)


class FrontendPool:
    """``workers`` daemon threads running ``TextFrontend.request`` off the
    HTTP path. ``prepare()`` mints the handle, the caller submits it to the
    batcher, and only a successful submit is followed by ``dispatch()``, so
    no G2P is spent on a request the batcher refuses. ``close()`` flushes
    queued work, then fails anything that raced past the sentinels with
    ``ShutdownError``."""

    def __init__(self, frontend, workers: int, registry: Optional[MetricsRegistry] = None,
                 events: Optional[JsonlEventLog] = None):
        if workers < 1:
            raise ValueError(f"FrontendPool needs >= 1 worker, got {workers}")
        self.frontend = frontend
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events = events
        # bounded through the batcher: dispatch() follows an accepted
        # submit, and the batcher sheds at its own queue depth
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = False
        self._close_lock = make_lock("FrontendPool._close_lock")
        self._hist = self.registry.histogram(
            "serve_frontend_seconds",
            help="per-request frontend cost (normalize + G2P + style lookup) on the pool "
                 "worker, overlapped with serve_queue_wait_seconds")
        self._depth_gauge = self.registry.gauge(
            "serve_frontend_queue_depth", help="frontend handles awaiting a pool worker")
        self._errors_ctr = self.registry.counter(
            "serve_frontend_errors_total",
            help="frontend resolutions that raised (400/500 when the batcher pops the handle)")
        self._threads = [threading.Thread(target=self._worker, name=f"frontend-{i}", daemon=True)
                         for i in range(workers)]
        for t in self._threads:
            t.start()

    def prepare(self, req_id: str, payload: Dict, stream: bool = False) -> PendingRequest:
        """Mint the pending handle; enqueues nothing."""
        return PendingRequest(req_id, payload, stream=stream)

    def dispatch(self, pending: PendingRequest) -> None:
        """Enqueue the handle's frontend work; after close, resolve it with
        ShutdownError instead."""
        with self._close_lock:
            if self._closed:
                pending._future.set_exception(ShutdownError("frontend pool is closed"))
                return
            self._queue.put(pending)
        self._depth_gauge.set(self._queue.qsize())

    def _worker(self) -> None:
        while True:
            try:
                # a poll, not a bare wait: a lost sentinel cannot strand the thread
                item = self._queue.get(timeout=1.0)
            except queue.Empty:
                continue
            if item is None:  # the close sentinel
                return
            self._depth_gauge.set(self._queue.qsize())
            try:
                with Span("serve_frontend", registry=self.registry, events=self.events,
                          parent=item.trace, req_id=item.id):
                    request = self.frontend.request(item.id, item.payload)
                    # the SLO clock and stream flag are the handler's
                    request.stream = item.stream
                    request.arrival = item.arrival
                    request.trace = item.trace
            except BaseException as e:
                self._errors_ctr.inc()
                item._future.set_exception(e)
            else:
                item._future.set_result(request)
            finally:
                item.payload = None

    def close(self, timeout: float = 10.0) -> None:
        """Idempotent: flush queued work, stop the workers, fail any handle
        that raced in after the sentinels."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            for _ in self._threads:
                self._queue.put(None)
        for t in self._threads:
            t.join(timeout=timeout)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item._future.done():
                item._future.set_exception(ShutdownError("frontend pool closed"))

    def __enter__(self) -> "FrontendPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
