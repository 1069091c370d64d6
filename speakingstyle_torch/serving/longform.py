"""Long-form (chapter-length) synthesis behind ``POST /synthesize/longform``
(JAX counterpart: speakingstyle_tpu/serving/longform.py).

The interactive lattice admits at most ``serve.src_buckets[-1]`` phonemes
(and ``serve.mel_buckets[-1]`` frames) and answers 413 past them. This
module opens the request class above that ceiling, with two tiers.

**Tier (a), chunked (always available).**

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

**Tier (b), ring (``serve.longform.mesh_seq > 1``).** One chapter-length
utterance is one program: ``RingTier`` prepares the acoustic free run of a
model at ``attention_impl="ring"`` (parallel/ring_attention.py: key /
value blocks rotate around a sequence mesh of ``mesh_seq`` ranks with a
streaming log-sum-exp merge) at the dedicated ``serve.longform.{src,mel}
_buckets`` above the interactive lattice, batch 1. The ranks are processes
(serving/ring_ranks.py: ``serve`` is rank 0 and starts the others), and
every layer but the attention runs whole on each. The program holds gloo
collectives, which no CUDA graph can capture, so the registry prepares it
without a capture (``ProgramRegistry.prepare(..., capture=False)``: counted,
carded, run eagerly). Its mel streams out through the engine's prepared
vocoder windows (``streaming.stream_wav``).

Tier selection happens at admission (``LongformService.admit``): ring when
a ring tier is attached and available, the engine has a vocoder and the
chapter fits a ring bucket; chunked otherwise. A ring failure before the
first sample degrades the chapter to the chunked tier (counted in
``serve_longform_degraded_total``, a ``longform_degraded`` event; the
``longform_ring_error@N`` fault drives it); a failure of the ring's group
also takes the tier out, so later chapters are admitted chunked.
Metrics: ``serve_longform_requests_total{tier}``,
``serve_longform_chunks_total``, ``serve_longform_seam_rms``,
``serve_longform_ttfa_seconds``, ``serve_longform_degraded_total`` and
``serve_longform_ring_seconds``.
"""

import dataclasses
import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.faults import FaultPlan
from speakingstyle_torch.obs import MetricsRegistry, make_lock
from speakingstyle_torch.serving import ring_ranks, streaming
from speakingstyle_torch.serving.engine import (
    SynthesisRequest, SynthesisResult, _fill_control, bucket_label,
)
from speakingstyle_torch.serving.lattice import BucketLattice, RequestTooLarge
from speakingstyle_torch.serving.resilience import InjectedFault

__all__ = ["Chunk", "LongformPlan", "LongformService", "RingTier", "Stitcher", "plan_chunks",
           "split_sentences"]

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


# ---------------------------------------------------------------------------
# tier (b): the ring-attention free run over a sequence mesh
# ---------------------------------------------------------------------------


class RingTier:
    """A chapter-length acoustic free run as one ring-attention program
    (JAX counterpart: ``RingTier``, ``serving/longform.py:290-562``).

    The model is ``model``'s weights at ``attention_impl="ring"`` with a
    float32 softmax (the ring's merge is float32; one model YAML serves both
    tiers), built through ``build_model`` with the tier's sequence mesh of
    ``serve.longform.mesh_seq`` ranks and a position table of
    ``max(max_mel, max_src, max_seq_len) + 1``, at its own lattice
    ``BucketLattice([1], src_buckets, mel_buckets)``: a chapter is never
    coalesced. Every preparation goes through the engine's ``ProgramRegistry`` without a
    capture and mints a card labelled ``kind=acoustic_ring``,
    ``bucket=b1.s{L}.m{T}``, ``mesh=seq{n}``; ``precompile()`` prepares
    every point (each run of rank 0 is matched by one on every helper).
    Staging, style resolution and the mel readback are the engine's: its
    pool, its StyleService. Chapters run one at a time on the ring.

    The tier starts its helper rank processes (serving/ring_ranks.py)
    unless ``store`` is given: then the caller runs ``ring_ranks.
    run_helper`` for ranks ``1 .. mesh_seq - 1`` over that store (the tests'
    thread ranks). ``timeout_s`` bounds each collective of the ring."""

    def __init__(self, cfg: Config, model, engine, program_registry=None, store=None,
                 timeout_s: Optional[float] = None):
        from speakingstyle_torch.models.factory import build_model
        lf = cfg.serve.longform
        if lf.mesh_seq < 2:
            raise ValueError(f"RingTier needs serve.longform.mesh_seq >= 2 (got {lf.mesh_seq}); "
                             "the chunked tier serves smaller deployments")
        self.cfg = cfg
        self.engine = engine
        self.registry = engine.registry
        self.program_registry = (program_registry if program_registry is not None
                                 else engine.program_registry)
        ring_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attention_impl="ring", attention_softmax_dtype="float32"))
        self.ring_cfg = ring_cfg
        self.lattice = BucketLattice([1], list(lf.src_buckets), list(lf.mel_buckets))
        n_position = max(self.lattice.max_mel, self.lattice.max_src, cfg.model.max_seq_len) + 1
        emb = model.speaker_emb
        n_speakers = 1 if emb is None else emb.weight.shape[0]
        t0 = time.monotonic()
        self.group = ring_ranks.start_ring_group(
            lf.mesh_seq, ring_ranks.job_of(ring_cfg, n_position, n_speakers), engine.device,
            store=store,
            timeout_s=ring_ranks.RING_TIMEOUT_S if timeout_s is None else timeout_s)
        self.mesh = self.group.mesh
        try:
            ring_model = build_model(ring_cfg, n_position=n_position, seq_mesh=self.mesh)
            with torch.no_grad():
                ring_model.load_state_dict(model.state_dict())
                for dst, src in zip(ring_ranks.ring_leaves(ring_model)[-2:],
                                    ring_ranks.ring_leaves(model)[-2:]):
                    dst.copy_(src)
            self.model = ring_model.to(engine.device).eval()
            self.digest = ring_ranks.share_weights(self.model, self.mesh)
        except BaseException:
            self.group.close()  # the helpers started above
            raise
        # spawn (or join) to every rank holding rank 0's weights
        self.startup_s = time.monotonic() - t0
        self._use_style = cfg.model.use_reference_encoder
        pp = cfg.preprocess.preprocessing
        self._pitch_axis = "src" if pp.pitch.feature == "phoneme_level" else "mel"
        self._energy_axis = "src" if pp.energy.feature == "phoneme_level" else "mel"
        self._programs: Dict[object, object] = {}
        # one chapter at a time on the ring: a run is a sequence of
        # collectives the helpers follow in order
        self._lock = make_lock("RingTier._lock")
        self._ring_hist = self.registry.histogram(
            "serve_longform_ring_seconds",
            help="wall time of one ring-attention chapter free-run "
                 "(staging + dispatch + mel host readback)")

    @property
    def max_src(self) -> int:
        return self.lattice.max_src

    @property
    def max_mel(self) -> int:
        return self.lattice.max_mel

    @property
    def available(self) -> bool:
        """False once the ring's group has failed (or was closed)."""
        return self.group.available

    def close(self) -> None:
        """Stop the helper ranks; the tier serves nothing after."""
        with self._lock:
            self.group.close()

    def _prepare(self, bucket, inputs: Dict[str, torch.Tensor]):
        """Prepare one point on ``inputs`` (the helpers run the same warm-up);
        returns the warm-up's outputs."""
        label = bucket_label(bucket)
        prog, first = self.program_registry.prepare(
            ring_ranks.ring_program(self.model, bucket.t_mel, self._use_style), inputs,
            name=f"acoustic_ring:{label}", device=self.engine.device, capture=False,
            labels={"kind": "acoustic_ring", "bucket": label,
                    "mesh": f"seq{self.cfg.serve.longform.mesh_seq}"})
        if first is None:  # the key was prepared, by another tier's model and mesh
            raise RuntimeError(
                f"{prog.name} is already prepared in this program registry by another "
                "RingTier; give this tier a program_registry of its own")
        self._programs[bucket] = prog
        return first

    def _run(self, bucket, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One run of ``bucket``'s program on every rank (caller holds the
        lock); a failure breaks the group."""
        if not self.group.available:
            raise RuntimeError(f"the ring's group is down ({self.group.broken})")
        try:
            self.group.announce(bucket.l_src, bucket.t_mel, inputs)
            first = self._prepare(bucket, inputs) if bucket not in self._programs else None
            return first if first is not None else self._programs[bucket](inputs)
        except BaseException as e:
            self.group.mark_broken(e)
            raise

    def precompile(self) -> float:
        """Prepare every long-form lattice point; returns wall seconds."""
        t0 = time.monotonic()
        for bucket in self.lattice.points():
            with self._lock:
                if bucket not in self._programs:
                    self._run(bucket, ring_ranks.ring_inputs(self.ring_cfg, bucket.l_src,
                                                             bucket.t_mel))
        return time.monotonic() - t0

    def synthesize(self, req: SynthesisRequest) -> SynthesisResult:
        """One chapter, one program: pad into the covering long-form bucket,
        run the ring free run, return a mel-only result (``wav=None``: the
        caller streams it through the engine's vocoder windows)."""
        n = int(len(req.sequence))
        need = n * self.cfg.serve.frames_per_phoneme
        bucket = self.lattice.cover(1, n, need)
        style = req.style
        if self._use_style and style is None:
            if req.ref_mel is None:
                raise ValueError(f"request {req.id!r} carries neither style vectors nor a "
                                 "ref_mel")
            if self.engine.style is None:
                raise ValueError(f"request {req.id!r} carries a ref_mel but the engine has no "
                                 "style service to encode it")
            # cache first through the shared StyleService
            style = self.engine.style.encode_mels([req.ref_mel])[0]
        t0 = time.monotonic()
        leases: List[torch.Tensor] = []
        synced = False

        def staging(shape, dtype=torch.float32, fill: float = 0) -> torch.Tensor:
            buf = self.engine.pool.acquire(shape, dtype, fill)
            leases.append(buf)
            return buf

        try:
            inputs = ring_ranks.ring_inputs(self.ring_cfg, bucket.l_src, bucket.t_mel, staging)
            inputs["speakers"].numpy()[0] = req.speaker
            texts = inputs["texts"].numpy()
            texts[0] = 0
            texts[0, :n] = req.sequence
            inputs["src_lens"].numpy()[0] = n
            for k in ("p", "e", "d"):
                _fill_control([getattr(req, f"{k}_control")], inputs[f"{k}_control"].numpy())
            if self._use_style:
                inputs["gammas"].numpy()[0, 0] = style.gamma
                inputs["betas"].numpy()[0, 0] = style.beta
            with self._lock, torch.no_grad():
                out = self._run(bucket, inputs)
                host = {k: out[k].cpu().numpy() for k in ring_ranks.KEEP}
            synced = True
        finally:
            if leases and not synced and self.engine.device.type == "cuda":
                torch.cuda.current_stream(self.engine.device).synchronize()
            for buf in leases:
                self.engine.pool.release(buf)
        mel_len = int(host["mel_lens"][0])
        self._ring_hist.observe(time.monotonic() - t0)
        p_len = n if self._pitch_axis == "src" else mel_len
        e_len = n if self._energy_axis == "src" else mel_len
        return SynthesisResult(
            id=req.id, raw_text=req.raw_text, mel=host["mel_postnet"][0, :mel_len],
            mel_len=mel_len, wav=None, durations=host["durations"][0, :n],
            pitch_prediction=host["pitch_prediction"][0, :p_len],
            energy_prediction=host["energy_prediction"][0, :e_len], src_len=n, bucket=bucket,
            batch_rows=1, style_degraded=req.style_degraded, trace=req.trace,
            priority=req.priority)


@dataclass
class LongformPlan:
    """One admitted chapter: the chunk plan and what is resolved once for
    the whole of it (style, speaker, controls, tier)."""

    req_id: str
    chunks: List[Chunk]
    tier: str  # "ring" | "chunked": set to "chunked" on a degradation
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

    ``admit`` checks the payload, plans the chunks, resolves style,
    speaker and controls once for the chapter and picks its tier;
    ``stream`` yields its int16 wav pieces in order, in bounded memory, on
    either tier. ``backend`` is anything with ``submit(request) -> Future``:
    the batcher or a (fleet or tier) router. ``engine`` (its vocoder
    windows) and ``ring`` (a ``RingTier``, or anything with ``max_src``,
    ``max_mel`` and ``synthesize``) make the ring tier; ``fault_plan``
    consumes ``longform_ring_error@N`` (the Nth ring attempt of this
    service, 1-based). The service prepares nothing on the request path:
    the ring's programs are prepared at start-up, chunks ride the
    interactive lattice. The metrics go to ``registry``, else
    ``engine``'s."""

    def __init__(self, cfg: Config, frontend, backend, engine=None, ring=None,
                 fault_plan: Optional[FaultPlan] = None,
                 registry: Optional[MetricsRegistry] = None, events=None, quality=None):
        self.cfg = cfg
        self.frontend = frontend
        self.backend = backend
        self.engine = engine
        self.ring = ring
        self.fault_plan = fault_plan
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
        self._ring_attempts = 0
        self._ring_lock = make_lock("LongformService._ring_lock")
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
        tier = "ring" if want in ("auto", "ring") and self._ring_fits(total) else "chunked"
        plan = LongformPlan(req_id=req_id, chunks=chunks, tier=tier, deadline_ms=budget,
                            total_phonemes=total, speaker=speaker, style=style_vec,
                            ref_mel=ref_mel, style_degraded=degraded, p_control=p_c,
                            e_control=e_c, d_control=d_c)
        self.registry.counter("serve_longform_requests_total", labels={"tier": plan.tier},
                              help="long-form chapters admitted, by selected tier").inc()
        if self.events is not None:
            self.events.emit("longform_admit", req_id=req_id, **plan.info())
        return plan

    def _ring_fits(self, total_phonemes: int) -> bool:
        """A ring tier is attached and up, the engine can vocode, and the
        chapter fits a ring bucket."""
        if self.ring is None or self.engine is None or self.engine.vocoder is None:
            return False
        if not getattr(self.ring, "available", True):
            return False
        fpp = self.cfg.serve.frames_per_phoneme
        return total_phonemes <= self.ring.max_src and total_phonemes * fpp <= self.ring.max_mel

    # -- synthesis -----------------------------------------------------------

    def stream(self, plan: LongformPlan) -> Iterator[np.ndarray]:
        """Yield the chapter's int16 wav pieces in order, in bounded
        memory. A ring failure before the first piece degrades the chapter
        to the chunked tier; a fault after the first piece ends the stream
        (the chunked HTTP body then lacks its terminal chunk, as
        /synthesize/stream)."""
        if plan.tier == "ring":
            try:
                result = self._ring_result(plan)
            except Exception as e:  # any ring failure costs the tier, not the chapter
                self._degraded_ctr.inc()
                self.registry.counter("serve_longform_requests_total", labels={"tier": "chunked"},
                                      help="long-form chapters admitted, by selected tier").inc()
                if self.events is not None:
                    self.events.emit("longform_degraded", req_id=plan.req_id,
                                     error=type(e).__name__)
                plan.tier = "chunked"
            else:
                yield from self._ring_stream(plan, result)
                return
        yield from self._chunked(plan)

    def _ring_result(self, plan: LongformPlan) -> SynthesisResult:
        with self._ring_lock:
            self._ring_attempts += 1
            attempt = self._ring_attempts
        if self.fault_plan is not None and self.fault_plan.fire("longform_ring_error", attempt):
            raise InjectedFault(f"injected longform_ring_error at ring attempt {attempt}")
        ids: List[int] = []
        for c in plan.chunks:
            ids.extend(c.sequence.tolist())
        req = SynthesisRequest(
            id=plan.req_id, sequence=np.asarray(ids, np.int32), ref_mel=plan.ref_mel,
            style=plan.style, speaker=plan.speaker, raw_text="", p_control=plan.p_control,
            e_control=plan.e_control, d_control=plan.d_control, arrival=plan.arrival,
            stream=True, style_degraded=plan.style_degraded)
        return self.ring.synthesize(req)

    def _ring_stream(self, plan: LongformPlan, result: SynthesisResult) -> Iterator[np.ndarray]:
        fleet = self.cfg.serve.fleet
        overlap = streaming.resolve_overlap(fleet.stream_overlap, self.engine.vocoder)
        # a ring chapter's mel dwarfs the interactive mel buckets, so every
        # overlap-padded vocoder window must itself fit the engine's vocoder
        # lattice: window + 2 * overlap <= max_mel
        window = min(fleet.stream_window, self.engine.lattice.max_mel - 2 * overlap)
        if window < 1:
            raise ValueError(
                f"ring stream overlap {overlap} leaves no room inside the largest vocoder "
                f"bucket {self.engine.lattice.max_mel}; enlarge serve.mel_buckets or set "
                "fleet.stream_overlap")
        first = True
        for wav in streaming.stream_wav(self.engine, result, window, overlap,
                                        fleet.stream_depth):
            if first:
                self._ttfa_hist.observe(time.monotonic() - plan.arrival)
                first = False
            yield wav
        if self.events is not None:
            self.events.emit("longform_done", req_id=plan.req_id, tier="ring",
                             chunks=len(plan.chunks), mel_len=result.mel_len)

    def _chunked(self, plan: LongformPlan) -> Iterator[np.ndarray]:
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
