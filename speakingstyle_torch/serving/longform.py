"""Long-form (chapter-length) synthesis behind ``POST /synthesize/longform``,
the chunked tier (JAX counterpart: speakingstyle_tpu/serving/longform.py,
``:96-289`` and ``:563-941`` without the ring tier).

The interactive lattice admits at most ``serve.src_buckets[-1]`` phonemes
(and ``serve.mel_buckets[-1]`` frames) and answers 413 past them. This
module opens the request class above that ceiling:

* **Chunking.** ``split_sentences`` splits the chapter at sentence
  boundaries and ``plan_chunks`` packs the sentences' G2P sequences into
  utterances that each fit the interactive lattice (a chunk's sequence is
  the exact concatenation of its sentences', so the planned counts are the
  admitted ones; a sentence longer than the cap is hard-split).
* **A deadline-sharing group.** The chunks go through the batcher or the
  fleet router as requests of the lowest-urgency class configured
  (``long_form``, else ``batch``, else the default), each carrying the
  chapter's arrival and one ``deadline_ms`` override of ``n_chunks x
  serve.longform.deadline_ms_per_chunk`` clamped to
  ``serve.fleet.max_deadline_ms``: the EDF heap orders the chapter as one
  late unit that never starves interactive traffic.
* **Stitching.** The chapter's controls and resolved style are carried
  into every chunk, and the wavs are joined by an equal-power crossfade of
  ``serve.longform.crossfade_frames`` mel frames (``Stitcher``). At most
  ``serve.longform.group_depth`` chunks are in flight ahead of the stitch
  point and the stitcher holds one crossfade tail, so the chapter is never
  held whole in memory.

The ring tier (one chapter-length utterance as one ring-attention program
over a sequence mesh, ``serve.longform.mesh_seq > 1``) is ROADMAP.md queue A
item 6: ``LongformService`` refuses a ``ring=``, and ``tier: auto`` /
``tier: ring`` admit as chunked, as the JAX service does without a ring.
Metrics: ``serve_longform_requests_total{tier}``,
``serve_longform_chunks_total``, ``serve_longform_seam_rms``,
``serve_longform_ttfa_seconds`` and ``serve_longform_degraded_total``
(always 0 without a ring tier).
"""

import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.obs import MetricsRegistry
from speakingstyle_torch.serving.engine import SynthesisRequest
from speakingstyle_torch.serving.lattice import RequestTooLarge

__all__ = ["Chunk", "LongformPlan", "LongformService", "Stitcher", "plan_chunks",
           "split_sentences"]

RING_MISSING = ("serve.longform.mesh_seq > 1 asks for the ring long-form tier (one chapter as "
                "one ring-attention program over a sequence mesh), which is not ported yet "
                "(ROADMAP.md queue A item 6c); set mesh_seq to 0 or 1 to serve chapters on the "
                "chunked tier")

# sentence-final punctuation (ASCII, CJK, ellipsis) and the whitespace
# after it; the punctuation stays with its sentence
_SENTENCE_SPLIT = re.compile(r"(?<=[.!?…。！？])\s+")


def split_sentences(text: str) -> List[str]:
    """Break after ``.!?…。！？`` followed by whitespace, keep the
    punctuation, strip and drop empty pieces. Text without such
    punctuation is one sentence (``plan_chunks`` hard-splits it)."""
    if not text:
        return []
    return [p.strip() for p in _SENTENCE_SPLIT.split(text) if p.strip()]


@dataclass
class Chunk:
    """One lattice-sized utterance of the chapter."""

    index: int
    text: str
    sequence: np.ndarray  # [n] int32 phoneme ids, n <= the planned cap
    n_sentences: int = 1


def plan_chunks(text: str, encode: Callable[[str], np.ndarray], max_phonemes: int,
                max_chunks: int = 0) -> List[Chunk]:
    """Split ``text`` at sentence boundaries and pack sentences greedily
    into chunks of at most ``max_phonemes`` ids (one ``encode`` call per
    sentence; a chunk's sequence is its sentences' concatenated). A
    sentence longer than ``max_phonemes`` is hard-split into
    ``max_phonemes`` slices. Empty text plans no chunk. ``max_chunks > 0``
    bounds the chapter: past it, RequestTooLarge (the structured 413)."""
    if max_phonemes <= 0:
        raise ValueError(f"max_phonemes must be > 0, got {max_phonemes}")
    pieces: List[tuple] = []  # (sentence text, [ids])
    for sent in split_sentences(text):
        seq = np.asarray(encode(sent), np.int32)
        if seq.size == 0:
            continue
        if seq.size <= max_phonemes:
            pieces.append((sent, seq.tolist()))
        else:
            for off in range(0, seq.size, max_phonemes):
                pieces.append((sent, seq[off:off + max_phonemes].tolist()))
    chunks: List[Chunk] = []
    ids: List[int] = []
    texts: List[str] = []

    def flush():
        if ids:
            chunks.append(Chunk(index=len(chunks), text=" ".join(dict.fromkeys(texts)),
                                sequence=np.asarray(ids, np.int32), n_sentences=len(texts)))
            ids.clear()
            texts.clear()

    for sent, seq_ids in pieces:
        if ids and len(ids) + len(seq_ids) > max_phonemes:
            flush()
        ids.extend(seq_ids)
        texts.append(sent)
    flush()
    if max_chunks and len(chunks) > max_chunks:
        raise RequestTooLarge(
            f"chapter plans {len(chunks)} chunks, over the serve.longform.max_chunks="
            f"{max_chunks} admission cap ({max_phonemes * max_chunks} phonemes); split the "
            "request")
    return chunks


class Stitcher:
    """Equal-power crossfade joiner in bounded memory.

    ``feed`` one int16 chunk wav at a time; each call returns the pieces
    that can go out (all but the held-back crossfade tail), and ``finish``
    returns the last tail. Only that tail (at most ``fade`` samples) is
    kept between chunks. At each seam the old tail and the new head mix
    over a sin / cos ramp (cos^2 + sin^2 = 1: the energy stays flat), and
    ``seam_rms`` records per seam the RMS of the first difference across
    the join window, normalised to [-1, 1] (the click detector).
    ``quality_check`` (the server binds ``QualityGate.check``) sees every
    piece that goes out, the crossfade mixes included."""

    def __init__(self, fade_samples: int, quality_check=None):
        if fade_samples < 0:
            raise ValueError(f"fade_samples must be >= 0, got {fade_samples}")
        self.fade = int(fade_samples)
        self._tail: Optional[np.ndarray] = None
        self._last_emitted: float = 0.0  # the last sample before the seam
        self.seam_rms: List[float] = []
        self.quality_check = quality_check

    def _note_seam(self, prev: float, mixed: np.ndarray, nxt: float) -> None:
        window = np.empty(mixed.size + 2, np.float32)
        window[0] = prev
        window[1:-1] = mixed
        window[-1] = nxt
        d = np.diff(window / 32768.0)
        self.seam_rms.append(float(np.sqrt(np.mean(d * d))))

    def feed(self, wav: np.ndarray) -> List[np.ndarray]:
        wav = np.asarray(wav, np.int16)
        if wav.size == 0:
            return []
        out: List[np.ndarray] = []
        if self._tail is not None:
            f = min(self._tail.size, wav.size, self.fade)
            if f > 0:
                th = (np.arange(f, dtype=np.float32) + 0.5) * (np.pi / (2 * f))
                mixed_f = (self._tail[-f:].astype(np.float32) * np.cos(th)
                           + wav[:f].astype(np.float32) * np.sin(th))
                mixed = np.clip(mixed_f, -32768, 32767).astype(np.int16)
                if self._tail.size > f:
                    out.append(self._tail[:-f])
                    prev = float(self._tail[-f - 1])
                else:
                    prev = self._last_emitted
                nxt = float(wav[f]) if wav.size > f else float(mixed[-1])
                self._note_seam(prev, mixed_f, nxt)
                out.append(mixed)
                wav = wav[f:]
            else:
                # fade 0 (or an empty tail): a butt joint, still metered
                if self._tail.size:
                    out.append(self._tail)
                    prev = float(self._tail[-1])
                else:
                    prev = self._last_emitted
                if wav.size:
                    self._note_seam(prev, np.asarray([float(wav[0])], np.float32),
                                    float(wav[1]) if wav.size > 1 else float(wav[0]))
        # hold back the next seam's tail, emit the rest
        if wav.size > self.fade:
            out.append(wav[:wav.size - self.fade])
            self._tail = wav[wav.size - self.fade:]
        else:
            self._tail = wav
        for piece in reversed(out):
            if piece.size:
                self._last_emitted = float(piece[-1])
                break
        pieces = [p for p in out if p.size]
        if self.quality_check is not None:
            for p in pieces:
                self.quality_check(p)
        return pieces

    def finish(self) -> List[np.ndarray]:
        tail, self._tail = self._tail, None
        pieces = [tail] if tail is not None and tail.size else []
        if self.quality_check is not None:
            for p in pieces:
                self.quality_check(p)
        return pieces


@dataclass
class LongformPlan:
    """One admitted chapter: the chunk plan and what is resolved once for
    the whole of it (style, speaker, controls, tier)."""

    req_id: str
    chunks: List[Chunk]
    tier: str  # always "chunked" here (the ring tier is queue A item 6c)
    deadline_ms: float  # the group's shared budget, clamped
    total_phonemes: int
    speaker: int = 0
    style: object = None
    ref_mel: Optional[np.ndarray] = None
    style_degraded: bool = False
    p_control: float = 1.0
    e_control: float = 1.0
    d_control: float = 1.0
    arrival: float = field(default_factory=time.monotonic)

    def info(self) -> Dict:
        return {"tier": self.tier, "chunks": len(self.chunks), "phonemes": self.total_phonemes,
                "deadline_ms": self.deadline_ms}


class LongformService:
    """Admission and orchestration of ``POST /synthesize/longform``.

    ``admit`` checks the payload, plans the chunks and resolves style,
    speaker and controls once for the chapter; ``stream`` yields its int16
    wav pieces in order, in bounded memory. ``backend`` is anything with
    ``submit(request) -> Future``: the batcher or a (fleet or tier)
    router. The service prepares nothing: every chunk rides the
    interactive lattice. ``ring`` must be None (queue A item 6c); the
    metrics go to ``registry``, else ``engine``'s."""

    def __init__(self, cfg: Config, frontend, backend, engine=None, ring=None,
                 registry: Optional[MetricsRegistry] = None, events=None, quality=None):
        if ring is not None:
            raise NotImplementedError(RING_MISSING)
        self.cfg = cfg
        self.frontend = frontend
        self.backend = backend
        self.quality = quality
        if registry is not None:
            self.registry = registry
        elif engine is not None:
            self.registry = engine.registry
        else:
            self.registry = MetricsRegistry()
        self.events = events
        fleet = cfg.serve.fleet
        # the lowest-urgency class the deployment configures
        if "long_form" in fleet.class_deadline_ms:
            self.klass = "long_form"
        elif "batch" in fleet.class_deadline_ms:
            self.klass = "batch"
        else:
            self.klass = fleet.default_class
        self._chunks_ctr = self.registry.counter(
            "serve_longform_chunks_total", help="chapter chunks synthesized by the chunked tier")
        self._degraded_ctr = self.registry.counter(
            "serve_longform_degraded_total", help="ring-tier failures degraded to the chunked tier")
        self._seam_hist = self.registry.histogram(
            "serve_longform_seam_rms",
            help="per-seam RMS of the first difference across the stitched join window "
                 "(normalized; the click detector)")
        self._ttfa_hist = self.registry.histogram(
            "serve_longform_ttfa_seconds",
            help="chapter admission -> first stitched wav piece ready")

    # -- admission -----------------------------------------------------------

    @property
    def chunk_phoneme_cap(self) -> int:
        """The largest chunk the interactive lattice admits: bounded by the
        src axis and, through frames_per_phoneme, by the mel axis."""
        serve = self.cfg.serve
        return min(serve.src_buckets[-1], serve.mel_buckets[-1] // serve.frames_per_phoneme)

    def _controls(self, payload: Dict):
        vals = []
        for key in ("pitch_control", "energy_control", "duration_control"):
            v = payload.get(key, 1.0)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{key} must be a scalar on /synthesize/longform (per-word "
                                 "lists cannot span chapter chunks)")
            vals.append(float(v))
        return vals

    def admit(self, req_id: str, payload: Dict) -> LongformPlan:
        """Check and plan one chapter. Raises ValueError (400) on a bad
        payload and RequestTooLarge (413) past ``max_chunks``."""
        text = payload.get("text")
        if not text or not isinstance(text, str):
            raise ValueError('payload must carry a non-empty "text" string')
        lf = self.cfg.serve.longform
        want = payload.get("tier", lf.tier)
        if want not in ("auto", "chunked", "ring"):
            raise ValueError(f'tier must be "auto"|"chunked"|"ring", got {want!r}')
        p_c, e_c, d_c = self._controls(payload)
        style_vec, ref_mel, degraded = self.frontend.resolve_style(payload)
        spec = payload.get("speaker_id", payload.get("speaker"))
        speaker = self.frontend.speaker(spec) if spec is not None else 0
        if style_vec is not None and getattr(style_vec, "speaker", None) is not None:
            bound = self.frontend.speaker(style_vec.speaker)
            if spec is None:
                speaker = bound
            elif speaker != bound:
                raise ValueError(f"style is bound to speaker {style_vec.speaker!r}; request "
                                 "named a different speaker")
        chunks = plan_chunks(text, self.frontend.sequence, self.chunk_phoneme_cap,
                             lf.max_chunks)
        if not chunks:
            raise ValueError("text contains nothing synthesizable")
        total = int(sum(c.sequence.size for c in chunks))
        budget = min(len(chunks) * lf.deadline_ms_per_chunk, self.cfg.serve.fleet.max_deadline_ms)
        plan = LongformPlan(req_id=req_id, chunks=chunks, tier="chunked", deadline_ms=budget,
                            total_phonemes=total, speaker=speaker, style=style_vec,
                            ref_mel=ref_mel, style_degraded=degraded, p_control=p_c,
                            e_control=e_c, d_control=d_c)
        self.registry.counter("serve_longform_requests_total", labels={"tier": plan.tier},
                              help="long-form chapters admitted, by selected tier").inc()
        if self.events is not None:
            self.events.emit("longform_admit", req_id=req_id, **plan.info())
        return plan

    # -- synthesis -----------------------------------------------------------

    def stream(self, plan: LongformPlan) -> Iterator[np.ndarray]:
        """Yield the chapter's int16 wav pieces in order, in bounded
        memory. A fault after the first piece ends the stream (the chunked
        HTTP body then lacks its terminal chunk, as /synthesize/stream)."""
        lf = self.cfg.serve.longform
        hop = self.cfg.preprocess.preprocessing.stft.hop_length
        stitcher = Stitcher(lf.crossfade_frames * hop, quality_check=self._quality_check_for(plan))
        pending: "deque" = deque()  # submitted futures, not yet collected
        it = iter(plan.chunks)
        first = True
        n_seams_noted = 0
        try:
            exhausted = False
            while not exhausted or pending:
                while not exhausted and len(pending) < lf.group_depth:
                    c = next(it, None)
                    if c is None:
                        exhausted = True
                        break
                    pending.append(self.backend.submit(self._chunk_request(plan, c)))
                if not pending:
                    break
                result = pending.popleft().result(timeout=self._remaining(plan))
                if result.wav is None:
                    raise ValueError("long-form synthesis requires a vocoder engine")
                self._chunks_ctr.inc()
                for piece in stitcher.feed(result.wav):
                    if first:
                        self._ttfa_hist.observe(time.monotonic() - plan.arrival)
                        first = False
                    yield piece
                for rms in stitcher.seam_rms[n_seams_noted:]:
                    self._seam_hist.observe(rms)
                    n_seams_noted += 1
            for piece in stitcher.finish():
                yield piece
        finally:
            # the consumer hung up or a chunk failed: cancel what has not
            # dispatched, let the rest resolve unobserved
            while pending:
                pending.popleft().cancel()
        if self.events is not None:
            self.events.emit("longform_done", req_id=plan.req_id, tier="chunked",
                             chunks=len(plan.chunks), seams=n_seams_noted,
                             seam_rms_max=max(stitcher.seam_rms, default=0.0))

    def _remaining(self, plan: LongformPlan) -> float:
        fleet = self.cfg.serve.fleet
        deadline = plan.arrival + (plan.deadline_ms + fleet.deadline_grace_ms) / 1e3
        return max(0.001, deadline - time.monotonic())

    def _chunk_request(self, plan: LongformPlan, c: Chunk) -> SynthesisRequest:
        return SynthesisRequest(
            id=f"{plan.req_id}.c{c.index:03d}", sequence=c.sequence, ref_mel=plan.ref_mel,
            style=plan.style, speaker=plan.speaker, raw_text=c.text, p_control=plan.p_control,
            e_control=plan.e_control, d_control=plan.d_control,
            # the deadline-sharing group: the chapter's arrival and ONE
            # budget, so the EDF heap orders the chapter as a unit
            arrival=plan.arrival, priority=self.klass, deadline_ms=plan.deadline_ms,
            style_degraded=plan.style_degraded)

    def _quality_check_for(self, plan: LongformPlan):
        """Every stitched piece validated under the chapter's class; None
        when the service has no gate."""
        if self.quality is None:
            return None

        def check(wav):
            return self.quality.check(wav, klass=self.klass, source="longform",
                                      req_id=plan.req_id)

        return check
