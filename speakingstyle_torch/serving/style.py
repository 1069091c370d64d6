"""StyleService: the reference-encoder programs and the embedding cache
(JAX counterpart: speakingstyle_tpu/serving/style.py).

* **Its own lattice.** Reference mels ride a ``(batch, ref_len)`` bucket
  grid (``serve.style.ref_buckets``, lattice.StyleLattice), prepared
  ahead of time through the service's own ``ProgramRegistry`` (a CUDA
  graph per point on the card), so the style path has the engine's
  property: every encoder execution is a prepared program at a covered
  shape; a miss prepares once and is counted
  (``serve_style_compiles_total``).
* **A content-addressed LRU cache.** ``sha256(reference bytes)`` keys the
  FiLM ``(gamma, beta)`` vectors. A repeated style performs zero encoder
  dispatches (``serve_style_cache_hits_total`` against
  ``serve_style_dispatches_total``). The cache is bounded
  (``serve.style.cache_capacity``) with LRU eviction and an eviction
  counter.
* **One service, N consumers.** The engine resolves raw ``ref_mel``
  requests through it at dispatch, the CLI's batch mode encodes one shared
  reference once through it.

Parity note: the reference's mean-pool divides by the PADDED length
(models/reference_encoder.py), so (gamma, beta) depend on the ref bucket a
reference lands in; a given reference length always covers to the same
point, so the dependence is deterministic.

The encoder runs in f32 weights whatever the engine's precision tiers are,
as in the JAX package.
"""

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from speakingstyle_torch.audio.stft import MelExtractor, get_mel_from_wav
from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.device import resolve_device
from speakingstyle_torch.faults import FaultPlan
from speakingstyle_torch.obs import MetricsRegistry, make_lock
from speakingstyle_torch.ops.masking import length_to_mask
from speakingstyle_torch.parallel.registry import (
    DEVICE_GATE,
    Program,
    ProgramRegistry,
    dispatching,
)
from speakingstyle_torch.serving.lattice import StyleLattice
from speakingstyle_torch.serving.pool import BufferPool
from speakingstyle_torch.serving.resilience import InjectedFault

__all__ = ["StyleService", "StyleVectors", "mel_from_wav_array", "style_bucket_label"]


def mel_from_wav_array(cfg: Config, wav: np.ndarray) -> np.ndarray:
    """Float wav samples -> [T, n_mels] log-mel, the feature pipeline the
    preprocessor and the CLI use."""
    pp = cfg.preprocess.preprocessing
    mel, _ = get_mel_from_wav(
        np.asarray(wav, np.float32),
        MelExtractor(
            pp.stft.filter_length, pp.stft.hop_length, pp.stft.win_length,
            pp.mel.n_mel_channels, pp.audio.sampling_rate,
            pp.mel.mel_fmin, pp.mel.mel_fmax,
        ),
    )
    return np.asarray(mel.T, np.float32)


def style_bucket_label(point: Tuple[int, int]) -> str:
    """Metric-label spelling of a style lattice point: ``b4.r512``."""
    return f"b{point[0]}.r{point[1]}"


@dataclass(frozen=True)
class StyleVectors:
    """One encoded speaking style: the FiLM pair, each [d_model] float32.
    ``key`` is the content address (sha256 hex of the reference bytes),
    empty for vectors made elsewhere."""

    gamma: np.ndarray
    beta: np.ndarray
    key: str = ""
    ref_frames: int = 0
    speaker: Optional[str] = None
    created_seq: int = 0

    def as_dict(self) -> Dict:
        """JSON-ready metadata (the vectors themselves stay in the process)."""
        return {"style_id": self.key, "ref_frames": int(self.ref_frames),
                "speaker": self.speaker, "d_model": int(self.gamma.shape[-1])}


class StyleService:
    """Reference-encoder programs + the content-addressed (gamma, beta) cache.

    ``encoder`` is the acoustic model's ``reference_encoder`` module, so
    the engine and the service run the same weights. Pass a shared
    ``registry`` to aggregate metrics. ``fault_plan`` consumes
    ``style_encode_error@N`` (N = the Nth encoder dispatch attempt,
    1-based)."""

    def __init__(self, cfg: Config, encoder: nn.Module, device=None,
                 registry: Optional[MetricsRegistry] = None,
                 fault_plan: Optional[FaultPlan] = None):
        if not cfg.model.use_reference_encoder:
            raise ValueError("StyleService requires model.use_reference_encoder=true")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lattice = StyleLattice.from_config(cfg.serve)
        self.encoder = encoder.to(self.device).eval()
        self.d_model = cfg.model.reference_encoder.encoder_hidden
        self.n_mels = cfg.preprocess.preprocessing.mel.n_mel_channels

        self.registry = registry if registry is not None else MetricsRegistry()
        self._hits = self.registry.counter(
            "serve_style_cache_hits_total", help="style lookups served from the embedding cache")
        self._misses = self.registry.counter(
            "serve_style_cache_misses_total",
            help="style lookups that had to run the reference encoder")
        self._evictions = self.registry.counter(
            "serve_style_cache_evictions_total", help="LRU evictions from the embedding cache")
        self._entries_gauge = self.registry.gauge(
            "serve_style_cache_entries", help="styles resident in the embedding cache")
        self.program_registry = ProgramRegistry(
            self.registry, counter_name="serve_style_compiles_total", prefix="serve")
        self._dispatches = self.registry.counter(
            "serve_style_dispatches_total", help="reference-encoder device dispatches executed")

        self.fault_plan = fault_plan
        self._encode_attempts = 0
        self._attempts_lock = make_lock("StyleService._attempts_lock")
        self._capacity = cfg.serve.style.cache_capacity
        self._entries: "OrderedDict[str, StyleVectors]" = OrderedDict()
        self._seq = 0
        self._cache_lock = make_lock("StyleService._cache_lock")
        self._exe: Dict[Tuple[int, int], Program] = {}
        self._compile_lock = make_lock("StyleService._compile_lock")
        self.pool = BufferPool(registry=self.registry, pin=self.device.type == "cuda")

    # -- content addressing --------------------------------------------------

    @staticmethod
    def digest_bytes(data: bytes) -> str:
        """The content address of a reference: sha256 hex of its bytes."""
        return hashlib.sha256(data).hexdigest()

    @classmethod
    def digest_mel(cls, mel: np.ndarray) -> str:
        """Content address of an already-extracted [T, n_mels] mel."""
        m = np.ascontiguousarray(mel, np.float32)
        return cls.digest_bytes(repr(m.shape).encode() + m.tobytes())

    # -- programs ------------------------------------------------------------

    @property
    def compile_count(self) -> int:
        return self.program_registry.compile_count

    @property
    def dispatch_count(self) -> int:
        return int(self._dispatches.value)

    def programs(self) -> List[Dict]:
        return self.program_registry.programs()

    def _encode_fn(self, r: int):
        def fn(mels, mel_lens):
            gammas, betas = self.encoder(mels, length_to_mask(mel_lens, r))
            return {"gammas": gammas[:, 0, :].float(), "betas": betas[:, 0, :].float()}
        return fn

    def _compile_point(self, point: Tuple[int, int],
                       inputs: Optional[Dict[str, torch.Tensor]] = None) -> Optional[Dict]:
        """Prepare one point (on a dispatch's ``inputs``, or an example);
        returns the warm-up's outputs. Caller holds ``_compile_lock``."""
        b, r = point
        label = style_bucket_label(point)
        if inputs is None:
            inputs = {"mels": torch.zeros((b, r, self.n_mels)),
                      "mel_lens": torch.full((b,), r, dtype=torch.int64)}
        self._exe[point], first = self.program_registry.prepare(
            self._encode_fn(r), inputs, name=f"style:{label}", device=self.device,
            labels={"kind": "style", "bucket": label})
        return first

    def precompile(self) -> float:
        """Prepare every (batch, ref_len) point; returns wall seconds.
        Idempotent."""
        t0 = time.monotonic()
        with self._compile_lock:
            for point in self.lattice.points():
                if point not in self._exe:
                    self._compile_point(point)
        return time.monotonic() - t0

    @property
    def is_ready(self) -> bool:
        return len(self._exe) >= len(self.lattice)

    # -- cache ---------------------------------------------------------------

    def __len__(self) -> int:
        with self._cache_lock:
            return len(self._entries)

    def __bool__(self) -> bool:
        """A service with an empty cache is still a service."""
        return True

    def get(self, style_id: str) -> Optional[StyleVectors]:
        """Cache lookup by style_id; counts a hit (and refreshes the LRU
        order) or nothing."""
        return self._lookup([style_id])[0]

    def _lookup(self, keys: Sequence[str]) -> List[Optional[StyleVectors]]:
        """``get`` of several keys under one hold of the cache lock, so the
        entries one ``encode_mels`` call stores (``_insert_many``) are seen
        all or none: a caller racing it misses the same keys, and covers
        them with the same programs, or none."""
        out = []
        with self._cache_lock:
            for key in keys:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self._hits.inc()
                out.append(entry)
        return out

    def _insert_many(self, entries: Sequence[StyleVectors]) -> List[StyleVectors]:
        """Store ``entries`` under one hold of the cache lock; each key
        already present keeps (and returns) its entry."""
        out = []
        with self._cache_lock:
            for entry in entries:
                existing = self._entries.get(entry.key)
                if existing is not None:
                    self._entries.move_to_end(entry.key)
                    out.append(existing)
                    continue
                self._seq += 1
                entry = StyleVectors(gamma=entry.gamma, beta=entry.beta, key=entry.key,
                                     ref_frames=entry.ref_frames, speaker=entry.speaker,
                                     created_seq=self._seq)
                self._entries[entry.key] = entry
                out.append(entry)
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)
                self._evictions.inc()
            self._entries_gauge.set(len(self._entries))
        return out

    def clear(self) -> int:
        """Drop every cached style (weights that change under the service
        make its entries stale); returns how many were dropped. The next
        lookup of each reference encodes it afresh."""
        with self._cache_lock:
            n = len(self._entries)
            self._entries.clear()
            self._entries_gauge.set(0)
        return n

    def styles(self) -> List[Dict]:
        """Registration-ordered metadata of the resident styles (the
        ``GET /styles`` payload)."""
        with self._cache_lock:
            entries = sorted(self._entries.values(), key=lambda e: e.created_seq)
        return [e.as_dict() for e in entries]

    def fallback_style(self) -> StyleVectors:
        """The default style: all-zero (gamma, beta), the un-modulated
        decoder. Graceful degradation substitutes it when the encoder
        fails; never cached."""
        return StyleVectors(gamma=np.zeros((self.d_model,), np.float32),
                            beta=np.zeros((self.d_model,), np.float32), key="default")

    # -- encoding ------------------------------------------------------------

    def encode_mels(self, mels: Sequence[np.ndarray],
                    keys: Optional[Sequence[Optional[str]]] = None,
                    speaker: Optional[str] = None, eager: bool = False) -> List[StyleVectors]:
        """Resolve reference mels to StyleVectors, cache first: the distinct
        misses encode through the smallest covering ``(batch, ref_len)``
        programs, grouped by ref bucket and chunked at the lattice's largest
        batch. Duplicates within one call encode once. ``eager`` runs the
        programs eagerly instead of replaying their graphs."""
        keys = list(keys) if keys is not None else [None] * len(mels)
        keys = [keys[i] or self.digest_mel(mel) for i, mel in enumerate(mels)]
        resolved: Dict[int, StyleVectors] = {}
        pending: "OrderedDict[str, List[int]]" = OrderedDict()
        pending_mel: Dict[str, np.ndarray] = {}
        for i, (mel, key, entry) in enumerate(zip(mels, keys, self._lookup(keys))):
            if entry is not None:
                resolved[i] = entry
                continue
            self._misses.inc()
            pending.setdefault(key, []).append(i)
            pending_mel[key] = np.asarray(mel, np.float32)
        if pending:
            by_bucket: "OrderedDict[int, List[str]]" = OrderedDict()
            for key in pending:
                _, r = self.lattice.cover(1, pending_mel[key].shape[0])
                by_bucket.setdefault(r, []).append(key)
            cap = self.lattice.max_batch
            done: List[Tuple[str, StyleVectors]] = []
            try:
                for r, bucket_keys in by_bucket.items():
                    for at in range(0, len(bucket_keys), cap):
                        chunk = bucket_keys[at: at + cap]
                        encoded = self._encode_chunk([pending_mel[k] for k in chunk], r,
                                                     speaker, chunk, eager=eager)
                        done += zip(chunk, encoded)
            finally:  # what was encoded is cached, at once, even if a later chunk failed
                stored = self._insert_many([entry for _, entry in done])
            for (key, _), entry in zip(done, stored):
                for i in pending[key]:
                    resolved[i] = entry
        return [resolved[i] for i in range(len(mels))]

    def encode_mel(self, mel: np.ndarray, key: Optional[str] = None,
                   speaker: Optional[str] = None) -> StyleVectors:
        return self.encode_mels([mel], keys=[key], speaker=speaker)[0]

    def encode_live(self, mel: np.ndarray, speaker: Optional[str] = None) -> StyleVectors:
        """A single-reference encode that bypasses the cache: always one
        dispatch of the prepared ``(1, ref)`` program, never read from or
        inserted into the cache (JAX ``style.py:464-482``). It is the
        golden prober's style-drift path (serving/probes.py): a cached
        vector would hide the very encoder drift the probe looks for.
        Tenant traffic never uses it: it pays a dispatch on every call."""
        m = np.asarray(mel, np.float32)
        _, r = self.lattice.cover(1, m.shape[0])
        return self._encode_chunk([m], r, speaker, [self.digest_mel(m)])[0]

    def encode_wav_bytes(self, data: bytes, speaker: Optional[str] = None) -> StyleVectors:
        """Reference wav bytes -> StyleVectors, content-addressed by the
        bytes; a cache hit skips the mel extraction too."""
        key = self.digest_bytes(data)
        entry = self.get(key)
        if entry is not None:
            return entry
        import io

        from speakingstyle_torch.audio.tools import load_wav

        wav, _ = load_wav(io.BytesIO(data),
                          target_sr=self.cfg.preprocess.preprocessing.audio.sampling_rate)
        return self.encode_mel(mel_from_wav_array(self.cfg, wav), key=key, speaker=speaker)

    @dispatching
    def _encode_chunk(self, mels: List[np.ndarray], r: int, speaker: Optional[str],
                      chunk_keys: List[str], eager: bool = False) -> List[StyleVectors]:
        """One padded encoder dispatch: prepare on miss (counted; waiting
        for the compile lock with the device gate released), pad into pool
        leases, run, read back; the entries, not yet cached (the caller
        stores them). A failed encode never reaches the cache."""
        with self._attempts_lock:
            self._encode_attempts += 1
            attempt = self._encode_attempts
        if self.fault_plan is not None and self.fault_plan.fire("style_encode_error", attempt):
            raise InjectedFault(f"injected style_encode_error at encoder dispatch {attempt}")
        point = self.lattice.cover(len(mels), r)
        b, r = point
        t0 = time.monotonic()
        padded = self.pool.acquire((b, r, self.n_mels), torch.float32)
        lens = self.pool.acquire((b,), torch.int64)
        synced = False
        try:
            pad_np, lens_np = padded.numpy(), lens.numpy()
            for i, mel in enumerate(mels):
                pad_np[i, : mel.shape[0]] = mel
                lens_np[i] = mel.shape[0]
            inputs = {"mels": padded, "mel_lens": lens}
            out = None
            if point not in self._exe:
                with DEVICE_GATE.released(), self._compile_lock:
                    if point not in self._exe:
                        out = self._compile_point(point, inputs)
            if out is None:
                out = self._exe[point](inputs, eager=eager)
            # the readback is the sync that licenses the leases' release
            gammas = out["gammas"].cpu().numpy()
            betas = out["betas"].cpu().numpy()
            synced = True
        finally:
            if not synced and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self.pool.release(lens)
            self.pool.release(padded)
        self._dispatches.inc()
        self.registry.histogram(
            "serve_style_encode_seconds", labels={"bucket": style_bucket_label(point)},
            help="wall time of one padded reference-encoder dispatch",
        ).observe(time.monotonic() - t0)
        return [StyleVectors(gamma=gammas[i].copy(), beta=betas[i].copy(), key=key,
                             ref_frames=int(mel.shape[0]), speaker=speaker)
                for i, (key, mel) in enumerate(zip(chunk_keys, mels))]
