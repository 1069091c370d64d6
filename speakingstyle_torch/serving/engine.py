"""The synthesis engine: padded text batches -> mel -> int16 wav, with a
prepared program per lattice point (JAX counterpart:
speakingstyle_tpu/serving/engine.py).

The JAX engine compiles the free-running acoustic model for every lattice
point and the HiFi-GAN generator for every ``(batch, T_mel)`` pair ahead of
time, so a steady-state dispatch never compiles. The port prepares the same
programs through its ``ProgramRegistry`` (parallel/registry.py): on the
card each is a CUDA graph captured after one eager warm-up, which the
dispatch replays; on the CPU each is the eager callable, counted the same
way. ``precompile()`` prepares every ``(bucket, precision)`` acoustic
point, every ``(b, t)`` vocoder point and the style lattice; a dispatch at
a point not yet prepared prepares it once, under the engine's condition
lock, and counts it; the preparation holds the registry's device gate
exclusively, so the other threads' dispatches wait for it (every device
entry point of the engine holds the gate shared). Two counters back the zero-steady-state claim:
``serve_compiles_total`` (``engine.compile_count``) and
``serve_style_compiles_total`` (the StyleService's).

``SynthesisEngine.run``:

1. styles resolve through the ``StyleService`` (serving/style.py), cache
   first: requests carry precomputed vectors, or a raw ``ref_mel`` the
   service encodes through its own ``(batch, ref_len)`` programs; an
   encoder failure degrades the affected requests to the fallback style
   and flags them;
2. the batch is covered by its smallest ``(batch, L_src, T_mel)`` point
   and padded into pool-leased host buffers (page-locked on the card, so
   the copies in are ``non_blocking``; serving/pool.py);
3. the acoustic program runs at the request's precision tier
   (``f32`` / ``bf16`` / ``int8``, parallel/registry.py); the mel is read
   back, which is the sync that returns the leases;
4. the vocoder program turns the postnet mel into audio; the finite check
   and the int16 cast run on the host, outside the graph; every emitted wav
   passes the quality gate (obs/quality.py). ``stream=True`` rows stay
   mel-only: serving/streaming.py vocodes them window by window through
   ``vocode_dispatch`` / ``vocode_collect``.

Per-dispatch metrics live in the engine's ``MetricsRegistry``:
``serve_dispatch_seconds{bucket}``, ``serve_acoustic_seconds``,
``serve_vocoder_seconds``, ``serve_emit_seconds``, and
``serve_achieved_flops_per_sec{bucket}`` (the programs' card FLOPs over the
measured wall). The stages run under ``record_function`` ranges
(``synthesis.style``, ``.acoustic``, ``.vocoder``) that a
``torch.profiler`` trace attributes device time to. A request that carries
a trace context (``trace``, obs/trace.py) gets an ``engine_run`` span with
``engine_acoustic`` and ``engine_vocode`` children, one per trace in the
dispatch, recorded after the fact. On the card the host is past the
acoustic program once it is enqueued, so the two children's durations are
device times, read from CUDA events recorded on the dispatch stream around
each program and read after the readback that already syncs. With tracing
disarmed, or no traced request in the dispatch, no event is recorded.

``run(..., eager=True)`` runs one dispatch's prepared programs eagerly
instead of replaying their graphs: the smoke test's comparison of replay
against eager.

A fleet (serving/fleet.py) builds several engines over one model's
weights and hands each the same ``style=`` StyleService (JAX
``serving/engine.py:247``, ``:358``): one embedding cache and one set of
style programs for every replica. ``close()`` gives a retired engine's
graphs and buffers back.
"""

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.device import resolve_device
from speakingstyle_torch.faults import FaultPlan
from speakingstyle_torch.models.factory import build_model, init_weights
from speakingstyle_torch.obs import MetricsRegistry, make_lock
from speakingstyle_torch.obs.cost import FLOPS_PER_SEC_BUCKETS
from speakingstyle_torch.obs.trace import Span, tracing_enabled
from speakingstyle_torch.obs.quality import QualityGate
from speakingstyle_torch.parallel.registry import (
    DEVICE_GATE,
    Program,
    ProgramRegistry,
    carried_leaves,
    cast_params,
    dequant_params,
    dispatching,
)
from speakingstyle_torch.serving.lattice import Bucket, BucketLattice, StyleLattice
from speakingstyle_torch.serving.pool import BufferPool
from speakingstyle_torch.serving.resilience import InjectedFault
from speakingstyle_torch.serving.style import StyleService, StyleVectors

__all__ = ["StyleVectors", "SynthesisEngine", "SynthesisRequest", "SynthesisResult",
           "VocodeHandle", "bucket_label", "load_engine", "load_engine_parts"]

Control = Union[float, np.ndarray]  # scalar, or per-phoneme [src_len] array

# the acoustic program's outputs
_KEEP = ("mel_postnet", "mel_lens", "durations", "pitch_prediction", "energy_prediction")


def n_position_for(cfg: Config, lattice: Optional[BucketLattice] = None) -> int:
    """The position-table length a serving model needs: the lattice's
    longest mel and text, the style lattice's longest reference, or
    ``max_seq_len``, plus one."""
    lattice = lattice or BucketLattice.from_config(cfg.serve)
    return max(lattice.max_mel, lattice.max_src, StyleLattice.from_config(cfg.serve).max_ref,
               cfg.model.max_seq_len) + 1


def bucket_label(bucket: Bucket) -> str:
    """Metric-label spelling of a lattice point: ``b4.s64.m512``."""
    return f"b{bucket.b}.s{bucket.l_src}.m{bucket.t_mel}"


@dataclass
class SynthesisRequest:
    """One utterance with G2P done: phoneme ids plus either precomputed
    style vectors or a reference mel the engine resolves through its
    StyleService (content-addressed, so repeats skip the encoder)."""

    id: str
    sequence: np.ndarray                  # [src_len] int32 phoneme ids
    ref_mel: Optional[np.ndarray] = None  # [ref_len, n_mels] float32
    style: Optional[StyleVectors] = None
    speaker: int = 0
    raw_text: str = ""
    p_control: Control = 1.0
    e_control: Control = 1.0
    d_control: Control = 1.0
    arrival: float = field(default_factory=time.monotonic)
    # mel-only result from the dispatch; the wav is vocoded window by
    # window afterwards (serving/streaming.py)
    stream: bool = False
    # traffic class and budget of the fleet (ignored by the engine)
    priority: Optional[str] = None
    deadline_ms: Optional[float] = None
    # the style already degraded to the default upstream
    style_degraded: bool = False
    # precision tier (registry.PRECISIONS); None = the engine's default
    precision: Optional[str] = None
    # the request's trace context, carried through to the result
    trace: Optional[object] = None
    # run this request's wav through the quality gate
    quality_check: bool = True


@dataclass
class SynthesisResult:
    """Per-request slice of one padded dispatch."""

    id: str
    raw_text: str
    mel: np.ndarray               # [mel_len, n_mels] float32 (postnet mel)
    mel_len: int
    wav: Optional[np.ndarray]     # [mel_len * hop] int16, None without vocoder or streaming
    durations: np.ndarray         # [src_len] int32 predicted frame counts
    pitch_prediction: np.ndarray
    energy_prediction: np.ndarray
    src_len: int
    bucket: Bucket
    batch_rows: int               # real rows in the dispatch that served this
    wav_finite: bool = True       # this row's float wav was finite before the int16 cast
    replica: int = -1
    style_degraded: bool = False
    served_by: Optional[str] = None
    tier: Optional[str] = None
    trace: Optional[object] = None
    priority: Optional[str] = None
    precision: str = "f32"
    # the quality gate's verdict on this result's wav (obs/quality.WavVerdict)
    quality: Optional[object] = None


def _fill_control(rows: List[Control], out: np.ndarray) -> np.ndarray:
    """Per-request controls -> the padded [B, L] array ``out`` (pre-filled
    with the neutral 1.0)."""
    for i, c in enumerate(rows):
        if np.isscalar(c):
            out[i] = float(c)
        else:
            arr = np.asarray(c, np.float32)
            out[i, : arr.shape[0]] = arr
    return out


@dataclass
class VocodeHandle:
    """One in-flight vocoder window: the enqueued device result plus the
    pooled host buffer it was padded from. ``vocode_dispatch`` returns at
    enqueue; ``vocode_collect`` is the sync point and returns the buffer; a
    handle that will never be collected must go through ``vocode_abandon``
    so the buffer still comes back."""

    wav_dev: torch.Tensor          # [b, t * hop] float32 on the device
    t_w: int                       # real frames in the window
    hop: int
    buf: Optional[torch.Tensor]    # pooled input buffer; None once released
    klass: Optional[str] = None
    trace: Optional[object] = None
    done: Optional[object] = None  # CUDA event behind the window's work


class SynthesisEngine:
    """Owns the acoustic model, the vocoder, the lattice, the precision
    trees and the prepared programs, on one device.

    ``model`` / ``vocoder`` are the port's modules (weights loaded or
    initialised by the caller); without ``model`` the engine builds one from
    ``cfg`` with weights drawn from ``seed``. ``device`` defaults to
    ``cuda``; only an explicit ``"cpu"`` runs on the CPU. The bf16 and int8
    tiers are cast from the model's weights here, once (as the JAX engine
    casts its variables): set the weights before building the engine. ``fault_plan``
    consumes ``vocoder_raise@N`` (the Nth ``vocode_dispatch``, 1-based) and
    is handed to the StyleService (``style_encode_error@N``). ``style``
    injects a StyleService shared with other engines (built over the same
    model's reference encoder); without it the engine builds its own.

    The constructor's device work (moving the modules, casting the tier
    trees) holds ``DEVICE_GATE`` shared like a dispatch: an engine built
    while another one's program is captured (a fleet or a tier warming)
    would otherwise invalidate that capture."""

    @dispatching
    def __init__(self, cfg: Config, model=None, vocoder=None,
                 lattice: Optional[BucketLattice] = None, device=None, seed: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 style: Optional[StyleService] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lattice = lattice or BucketLattice.from_config(cfg.serve)
        if model is None:
            model = init_weights(build_model(cfg, n_position=n_position_for(cfg, self.lattice)),
                                 seed)
        self.model = model.to(self.device).eval()
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        pp = cfg.preprocess.preprocessing
        self.n_mels = pp.mel.n_mel_channels
        self.max_wav_value = pp.audio.max_wav_value
        self._use_style = cfg.model.use_reference_encoder
        self._film_dim = cfg.model.reference_encoder.encoder_hidden
        self._ctl_axis = {
            "p": "src" if pp.pitch.feature == "phoneme_level" else "mel",
            "e": "src" if pp.energy.feature == "phoneme_level" else "mel",
            "d": "src",
        }
        # the precision axis: one acoustic tree per tier, cast once here
        # (the reference encoder stays out: FiLM arrives precomputed, and
        # the StyleService runs the f32 encoder, as in the JAX package);
        # the vocoder stays f32
        self.precisions = tuple(self.lattice.precisions)
        self.default_precision = self.precisions[0]
        self._params_by_precision: Dict[str, Dict] = {
            p: {k: v for k, v in cast_params(self.model, p).items()
                if not k.startswith("reference_encoder.")}
            for p in self.precisions}
        carried = carried_leaves(self.model)
        # the constants the JAX package does not hold in its tree
        self._constants = {n: b for n, b in self.model.named_buffers() if n not in carried}
        self._tier_models: Dict[str, torch.nn.Module] = {}

        self.registry = registry if registry is not None else MetricsRegistry()
        self.program_registry = ProgramRegistry(
            self.registry, counter_name="serve_compiles_total", prefix="serve")
        if style is not None and not self._use_style:
            raise ValueError("style= needs model.use_reference_encoder=true")
        if style is None and self._use_style:
            style = StyleService(cfg, self.model.reference_encoder, device=self.device,
                                 registry=self.registry, fault_plan=fault_plan)
        self.style = style
        self._dispatches = self.registry.counter(
            "serve_dispatches_total", help="padded device dispatches executed")
        self._request_rows = self.registry.counter(
            "serve_requests_total", help="requests served through dispatches")
        self._acoustic: Dict[tuple, Program] = {}
        self._vocoder_exe: Dict[tuple, Program] = {}
        self._acoustic_flops: Dict[tuple, Optional[float]] = {}
        self._vocoder_flops: Dict[tuple, Optional[float]] = {}
        # guards the program tables and the ``_compiling`` set only; the
        # preparation itself runs off the lock (``_ensure_program``)
        self._lock = make_lock("SynthesisEngine._lock", kind="condition")
        self._compiling: set = set()
        self.fault_plan = fault_plan
        self._vocode_calls = 0
        self._vocode_calls_lock = make_lock("SynthesisEngine._vocode_calls_lock")
        self._style_degraded_ctr = self.registry.counter(
            "serve_style_degraded_total",
            help="requests whose style fell back to the default because the "
                 "reference encoder failed")
        self.pool = BufferPool(registry=self.registry, pin=self.device.type == "cuda")
        self._acoustic_hist = self.registry.histogram(
            "serve_acoustic_seconds",
            help="stage: acoustic dispatch incl. staging, transfer and the mel readback")
        self._vocoder_hist = self.registry.histogram(
            "serve_vocoder_seconds",
            help="stage: wall time blocked on a vocoder window's device result")
        self._emit_hist = self.registry.histogram(
            "serve_emit_seconds", help="stage: host wav conversion per window")
        self.quality = QualityGate(cfg.serve.quality, pp.audio.sampling_rate,
                                   registry=self.registry)

    # -- counters and views -------------------------------------------------

    @property
    def compile_count(self) -> int:
        """Programs prepared by this engine (``serve_compiles_total``)."""
        return self.program_registry.compile_count

    @property
    def dispatch_count(self) -> int:
        return int(self._dispatches.value)

    @property
    def dispatches(self) -> int:
        """``dispatch_count`` under the port's earlier name."""
        return self.dispatch_count

    @property
    def style_encodes(self) -> int:
        """Reference-encoder dispatches of the StyleService."""
        return 0 if self.style is None else self.style.dispatch_count

    @property
    def vocode_calls(self) -> int:
        with self._vocode_calls_lock:
            return self._vocode_calls

    @property
    def is_ready(self) -> bool:
        """True once the whole acoustic lattice is prepared."""
        return len(self._acoustic) >= len(self.lattice)

    def programs(self) -> List[Dict]:
        """The program registry's card table: one row per program."""
        return self.program_registry.programs()

    def close(self) -> None:
        """Give the engine's graphs, their memory pool and the staging
        buffers back (a fleet replica that was retired: drained, replaced
        by a rollout, or abandoned by the hang watchdog once its thread
        returned). Takes ``DEVICE_GATE`` exclusively, so nothing replays or
        captures meanwhile, and on the card returns the freed blocks to
        the device. A shared StyleService is not the engine's to close.
        The engine prepares again on its next dispatch."""
        with DEVICE_GATE.exclusive():
            with self._lock:
                self._acoustic.clear()
                self._vocoder_exe.clear()
            self.program_registry.close()
            self.pool = BufferPool(registry=self.registry, pin=self.device.type == "cuda")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()

    def encode_styles(self, mels: List[np.ndarray]) -> torch.Tensor:
        """Reference mels -> [n, 2, d_model] float32 FiLM (gamma, beta),
        through the StyleService (cache first)."""
        styles = self.style.encode_mels(mels)
        return torch.from_numpy(np.stack([np.stack([s.gamma, s.beta]) for s in styles]))

    @dispatching
    def poison_params(self, precision: Optional[str] = None, scale: float = 1e3) -> str:
        """Degrade one precision tier's acoustic weights in place (the
        ``tier_poison`` fault): every leaf scaled by ``scale`` in its own
        dtype (int8 leaves saturated to their range), same storage, so the
        captured graphs read the poisoned values and nothing is prepared
        again; the next dispatch produces audio only the quality gate sees
        is wrong."""
        prec = precision or self.default_precision
        with torch.no_grad():
            for v in self._params_by_precision[prec].values():
                for t in (v["int8_q"], v["int8_scale"]) if isinstance(v, dict) else (v,):
                    bad = t.float() * scale
                    if not t.is_floating_point():
                        info = torch.iinfo(t.dtype)
                        bad = bad.clamp(info.min, info.max)
                    t.copy_(bad.to(t.dtype))
        return prec

    def _dispatch_flops(self, bucket: Bucket, precision: str) -> Optional[float]:
        flops = [self._acoustic_flops.get((bucket, precision))]
        if self.vocoder is not None:
            flops.append(self._vocoder_flops.get((bucket.b, bucket.t_mel)))
        real = [f for f in flops if f]
        return sum(real) if real else None

    # -- program preparation ------------------------------------------------

    def _model_for(self, precision: str):
        """The module a tier runs: f32 the base module; bf16 and int8 a
        module of the same architecture built on the meta device (it holds
        no weights of its own and runs on the tier's tree through
        ``functional_call``), computing in bf16 for bf16. The base module,
        which fleet replicas share, is never re-bound."""
        if precision == "f32":
            return self.model
        if precision not in self._tier_models:
            from speakingstyle_torch.models.fastspeech2 import FastSpeech2

            dtype = "bfloat16" if precision == "bf16" else self.cfg.model.compute_dtype
            tier_cfg = dataclasses.replace(
                self.cfg, model=dataclasses.replace(self.cfg.model, compute_dtype=dtype))
            emb = self.model.speaker_emb
            with torch.device("meta"):
                self._tier_models[precision] = FastSpeech2(
                    tier_cfg, n_speakers=1 if emb is None else emb.weight.shape[0],
                    n_position=self.model.encoder.layer_stack.pe.shape[0]).eval()
        return self._tier_models[precision]

    def _acoustic_fn(self, t_mel: int, precision: str) -> Callable:
        module = self._model_for(precision)
        tree = self._params_by_precision[precision]
        use_style = self._use_style

        def fn(speakers, texts, src_lens, p_control, e_control, d_control,
               gammas=None, betas=None):
            args = (speakers, texts, src_lens)
            kwargs = dict(max_mel_len=t_mel, p_control=p_control, e_control=e_control,
                          d_control=d_control, gammas=gammas if use_style else None,
                          betas=betas if use_style else None)
            if precision == "f32":
                out = module(*args, **kwargs)
            else:
                # widen-on-read inside the program: the narrow tree stays
                # resident, the f32 weights exist only during the run
                weights = dict(self._constants, **dequant_params(tree))
                out = torch.func.functional_call(module, weights, args, kwargs)
            return {k: out[k] for k in _KEEP}
        return fn

    def _ctl_len(self, axis: str, bucket: Bucket) -> int:
        return bucket.l_src if axis == "src" else bucket.t_mel

    def _ensure_program(self, kind: str, key, table: Dict, compile_fn: Callable[[], Optional[Dict]]):
        """Prepare on a miss behind the warming-state guard (the JAX
        engine's discipline): the condition covers only the table lookup and
        the ``_compiling`` marker; the preparation runs with the lock
        released. A second thread needing the same program waits instead of
        preparing it again; a failed preparation clears the marker and wakes
        the waiters, the first of which retries. A miss waits and prepares
        with this thread's ``DEVICE_GATE`` holds released (the preparation
        takes the gate exclusively). Returns the preparation's warm-up
        outputs to the thread that prepared, None otherwise."""
        if key in table:  # the steady state: no lock, no gate
            return None
        mark = (kind, key)
        with DEVICE_GATE.released():
            with self._lock:
                while key not in table and mark in self._compiling:
                    self._lock.wait()
                if key in table:
                    return None
                self._compiling.add(mark)
            try:
                return compile_fn()
            finally:
                with self._lock:
                    self._compiling.discard(mark)
                    self._lock.notify_all()

    def precompile(self) -> float:
        """Prepare every acoustic ``(bucket, precision)`` point, every
        vocoder ``(b, t)`` point and the style lattice; returns wall
        seconds."""
        t0 = time.monotonic()
        for prec in self.precisions:
            for bucket in self.lattice.points():
                self._ensure_program(
                    "acoustic", (bucket, prec), self._acoustic,
                    lambda b=bucket, p=prec: self._compile_acoustic(b, p))
        if self.vocoder is not None:
            for b in self.lattice.batch_buckets:
                for t in self.lattice.mel_buckets:
                    self._ensure_program("vocoder", (b, t), self._vocoder_exe,
                                         lambda b=b, t=t: self._compile_vocoder(b, t))
        if self.style is not None:
            self.style.precompile()
        return time.monotonic() - t0

    def _acoustic_example(self, bucket: Bucket) -> Dict[str, torch.Tensor]:
        b, l = bucket.b, bucket.l_src
        ex = {
            "speakers": torch.zeros((b,), dtype=torch.int64),
            "texts": torch.ones((b, l), dtype=torch.int64),
            "src_lens": torch.full((b,), l, dtype=torch.int64),
        }
        for k in ("p", "e", "d"):
            ex[f"{k}_control"] = torch.ones((b, self._ctl_len(self._ctl_axis[k], bucket)))
        if self._use_style:
            ex["gammas"] = torch.zeros((b, 1, self._film_dim))
            ex["betas"] = torch.zeros((b, 1, self._film_dim))
        return ex

    def _compile_acoustic(self, bucket: Bucket, precision: str = "f32",
                          inputs: Optional[Dict[str, torch.Tensor]] = None) -> Optional[Dict]:
        """Prepare one acoustic point (on ``inputs``, a dispatch's own, or
        the example); returns the warm-up's outputs."""
        label = bucket_label(bucket)
        labels = {"kind": "acoustic", "bucket": label}
        if precision != "f32":
            label = f"{label}@{precision}"
            labels = {"kind": "acoustic", "bucket": label, "precision": precision}
        prog, first = self.program_registry.prepare(
            self._acoustic_fn(bucket.t_mel, precision),
            self._acoustic_example(bucket) if inputs is None else inputs,
            name=f"acoustic:{label}", device=self.device, labels=labels, precision=precision)
        self._acoustic_flops[(bucket, precision)] = prog.card.get("flops")
        self._acoustic[(bucket, precision)] = prog
        return first

    def _compile_vocoder(self, b: int, t: int,
                         inputs: Optional[Dict[str, torch.Tensor]] = None) -> Optional[Dict]:
        vocoder = self.vocoder

        def fn(mel):
            return {"wav": vocoder(mel)}

        prog, first = self.program_registry.prepare(
            fn, {"mel": torch.zeros((b, t, self.n_mels))} if inputs is None else inputs,
            name=f"vocoder:b{b}.m{t}", device=self.device,
            labels={"kind": "vocoder", "bucket": f"b{b}.m{t}"})
        self._vocoder_flops[(b, t)] = prog.card.get("flops")
        self._vocoder_exe[(b, t)] = prog
        return first

    def _run_program(self, kind: str, key, table: Dict, compile_fn: Callable, inputs: Dict,
                     eager: bool) -> Dict[str, torch.Tensor]:
        """One program run: a miss prepares the program on these inputs and
        returns the warm-up's outputs (each kernel launched once); a hit
        replays (or runs eagerly)."""
        first = self._ensure_program(kind, key, table, lambda: compile_fn(inputs))
        if first is not None:
            return first
        return self._call(table[key], inputs, eager)

    def acoustic_program(self, bucket: Bucket, precision: Optional[str] = None) -> Program:
        """The prepared acoustic program of a point (prepared on a miss, on
        the example inputs)."""
        prec = precision or self.default_precision
        self._ensure_program("acoustic", (bucket, prec), self._acoustic,
                             lambda: self._compile_acoustic(bucket, prec))
        return self._acoustic[(bucket, prec)]

    def _call(self, program: Program, inputs: Dict[str, torch.Tensor], eager: bool):
        """Run a program, retrying the transfer under ``serve.transfer_retries``."""
        serve = self.cfg.serve
        if not serve.transfer_retries:
            return program(inputs, eager=eager)
        from speakingstyle_torch.training.resilience import retry_io

        return retry_io(lambda: program(inputs, eager=eager), retries=serve.transfer_retries,
                        backoff=serve.transfer_backoff, exceptions=(OSError,),
                        describe="serve device transfer")

    # -- streaming window vocode ---------------------------------------------

    @dispatching
    def vocode_dispatch(self, mel: np.ndarray, klass: Optional[str] = None,
                        trace=None) -> VocodeHandle:
        """Enqueue one mel window ``[T_w, n_mels]`` on the prepared vocoder
        lattice and return without blocking: the window is padded into the
        smallest covering ``(batch, T_mel)`` point, in a pool-leased buffer.
        Every handle must reach ``vocode_collect`` or ``vocode_abandon``."""
        if self.vocoder is None:
            raise ValueError("vocode_dispatch requires a vocoder engine")
        if mel.ndim != 2 or mel.shape[1] != self.n_mels:
            raise ValueError(f"mel window must be [T, {self.n_mels}], got {mel.shape}")
        with self._vocode_calls_lock:
            self._vocode_calls += 1
            call = self._vocode_calls
        if self.fault_plan is not None and self.fault_plan.fire("vocoder_raise", call):
            raise InjectedFault(f"injected vocoder_raise at vocode_window call {call}")
        t_w = mel.shape[0]
        key = self.lattice.cover_window(t_w)
        padded = self.pool.acquire((key[0], key[1], self.n_mels), torch.float32)
        try:
            padded.numpy()[0, :t_w] = mel
            with torch.no_grad():
                wav_dev = self._run_program(
                    "vocoder", key, self._vocoder_exe,
                    lambda inputs: self._compile_vocoder(*key, inputs), {"mel": padded},
                    False)["wav"]
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        except BaseException:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self.pool.release(padded)
            raise
        return VocodeHandle(wav_dev=wav_dev, t_w=t_w, hop=self.vocoder.hop_factor, buf=padded,
                            klass=klass, trace=trace, done=done)

    def _release_handle(self, handle: VocodeHandle) -> None:
        if handle.buf is not None:
            self.pool.release(handle.buf)
            handle.buf = None

    @dispatching
    def vocode_collect(self, handle: VocodeHandle) -> np.ndarray:
        """Block on a dispatched window and convert it: int16 wav
        ``[t_w * hop]``. The readback is the sync point; the pooled buffer is
        released here, after it."""
        try:
            t0 = time.monotonic()
            wav_host = handle.wav_dev.cpu().numpy()  # <- the sync point
            t1 = time.monotonic()
            # slice the float row BEFORE converting: the finite check must
            # see NaN/Inf that the clip would erase
            wav_f = wav_host[0, : handle.t_w * handle.hop]
            finite = bool(np.isfinite(wav_f).all())
            if not finite:
                wav_f = np.nan_to_num(wav_f, posinf=1.0, neginf=-1.0)
            wav = np.clip(wav_f * self.max_wav_value, -self.max_wav_value,
                          self.max_wav_value - 1).astype(np.int16)
            self.quality.check(wav, klass=handle.klass, source="stream", finite=finite,
                               trace=handle.trace)
            self._vocoder_hist.observe(t1 - t0)
            self._emit_hist.observe(time.monotonic() - t1)
            return wav
        finally:
            self._release_handle(handle)

    @dispatching
    def vocode_abandon(self, handle: VocodeHandle) -> None:
        """Return an in-flight window's buffer without converting it (a
        stream that dies mid-pipeline): waits until the device has passed
        the window's work, then releases; never raises."""
        try:
            if handle.done is not None:
                handle.done.synchronize()
        except RuntimeError:
            pass  # a failed dispatch cannot still be reading the buffer
        self._release_handle(handle)

    def vocode_window(self, mel: np.ndarray) -> np.ndarray:
        """Vocode one mel window synchronously (dispatch + collect)."""
        return self.vocode_collect(self.vocode_dispatch(mel))

    # -- admission geometry -------------------------------------------------

    def required_mel(self, req: SynthesisRequest) -> int:
        """The T_mel a request needs: its phoneme count times
        ``frames_per_phoneme`` (longer predictions are truncated)."""
        return len(req.sequence) * self.cfg.serve.frames_per_phoneme

    def cover(self, requests: List[SynthesisRequest]) -> Bucket:
        return self.lattice.cover(
            len(requests),
            max(len(r.sequence) for r in requests),
            max(self.required_mel(r) for r in requests),
        )

    def admit(self, req: SynthesisRequest) -> None:
        """Raise now (RequestTooLarge / ValueError) for a request no bucket
        can serve; the reference against the style lattice's own axis."""
        if req.sequence.ndim != 1:
            raise ValueError(f"request {req.id!r}: sequence must be [L], got {req.sequence.shape}")
        if self._use_style and req.style is None:
            if req.ref_mel is None or req.ref_mel.ndim != 2 \
                    or req.ref_mel.shape[1] != self.n_mels:
                raise ValueError(
                    f"request {req.id!r}: pass style vectors or a [T, {self.n_mels}] ref_mel"
                )
            self.style.lattice.cover(1, req.ref_mel.shape[0])
        self.lattice.cover(1, len(req.sequence), self.required_mel(req))

    # -- dispatch -----------------------------------------------------------

    def _resolve_styles(self, requests: List[SynthesisRequest],
                        eager: bool = False) -> List[Optional[StyleVectors]]:
        """Per-request FiLM vectors: precomputed ones pass through, raw
        ``ref_mel``s resolve through the StyleService, cache first (one
        batched encoder dispatch covers the fresh references). An encoder
        failure falls back to the default style for the affected requests,
        which are flagged; the failed encode never reached the cache."""
        if not self._use_style:
            return [None] * len(requests)
        styles: List[Optional[StyleVectors]] = [r.style for r in requests]
        mels, idxs = [], []
        for i, r in enumerate(requests):
            if styles[i] is None:
                if r.ref_mel is None:
                    raise ValueError(f"request {r.id!r} carries neither style vectors nor a ref_mel")
                mels.append(r.ref_mel)
                idxs.append(i)
        if mels:
            try:
                with record_function("synthesis.style"):
                    encoded = self.style.encode_mels(mels, eager=eager)
            except Exception as e:  # degrade, count, carry on: the batch must not fail
                fallback = self.style.fallback_style()
                encoded = [fallback] * len(mels)
                self._style_degraded_ctr.inc(len(idxs))
                for i in idxs:
                    requests[i].style_degraded = True
                self.registry.counter(
                    "serve_style_encode_failures_total", labels={"error": type(e).__name__},
                    help="reference-encoder dispatch failures absorbed by the fallback",
                ).inc()
            for i, sv in zip(idxs, encoded):
                styles[i] = sv
        return styles

    @dispatching
    def run(self, requests: List[SynthesisRequest], eager: bool = False) -> List[SynthesisResult]:
        """Pad ``requests`` into their smallest covering bucket, run the
        prepared programs and slice per-request results. Prepares nothing
        when the point was prepared; a miss prepares once and counts it.
        ``eager`` runs this dispatch's programs eagerly (no graph replay)."""
        if not requests:
            return []
        for r in requests:
            self.admit(r)
        styles = self._resolve_styles(requests, eager)
        bucket = self.cover(requests)
        # one precision per dispatch: the first tagged request's
        prec = next((r.precision for r in requests if r.precision), self.default_precision)
        if prec not in self._params_by_precision:
            raise ValueError(
                f"request precision {prec!r} not in this engine's axis {self.precisions}")
        compiles = self.compile_count
        t_dispatch = time.monotonic()
        t_dispatch_wall = time.time()
        b, l, t = bucket.b, bucket.l_src, bucket.t_mel
        n = len(requests)
        traced = tracing_enabled() and any(r.trace is not None for r in requests)
        # device-side stage marks for the spans: acoustic start / end,
        # vocoder start / end
        marks = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
                 if traced and self.device.type == "cuda" else None)

        leases: List[torch.Tensor] = []
        synced = False

        def staging(shape, dtype=torch.float32, fill: float = 0) -> torch.Tensor:
            buf = self.pool.acquire(shape, dtype, fill)
            leases.append(buf)
            return buf

        try:
            arrays = {
                "speakers": staging((b,), torch.int64),
                "texts": staging((b, l), torch.int64),
                "src_lens": staging((b,), torch.int64),
            }
            speakers, texts, src_lens = (arrays[k].numpy() for k in ("speakers", "texts",
                                                                     "src_lens"))
            for i, r in enumerate(requests):
                speakers[i] = r.speaker
                texts[i, : len(r.sequence)] = r.sequence
                src_lens[i] = len(r.sequence)
            for k in ("p", "e", "d"):
                buf = staging((b, self._ctl_len(self._ctl_axis[k], bucket)), fill=1)
                _fill_control([getattr(r, f"{k}_control") for r in requests], buf.numpy())
                arrays[f"{k}_control"] = buf
            if self._use_style:
                gammas = staging((b, 1, self._film_dim))
                betas = staging((b, 1, self._film_dim))
                for i, sv in enumerate(styles):
                    gammas.numpy()[i, 0] = sv.gamma
                    betas.numpy()[i, 0] = sv.beta
                arrays["gammas"], arrays["betas"] = gammas, betas
            with torch.no_grad():
                with record_function("synthesis.acoustic"):
                    if marks:
                        marks[0].record()
                    out = self._run_program(
                        "acoustic", (bucket, prec), self._acoustic,
                        lambda inputs: self._compile_acoustic(bucket, prec, inputs), arrays,
                        eager)
                    if marks:
                        marks[1].record()
                mel_dev = out["mel_postnet"]
                host = {k: out[k].cpu().numpy() for k in _KEEP}  # the readback: the sync point
                synced = True
                acoustic_s = time.monotonic() - t_dispatch
                wavs, finite, hop = None, np.ones((b,), bool), 1
                t_vocode_wall = None
                if self.vocoder is not None and any(not r.stream for r in requests):
                    hop = self.vocoder.hop_factor
                    with record_function("synthesis.vocoder"):
                        t_vocode_wall = time.time()
                        if marks:
                            marks[2].record()
                        wav_dev = self._run_program(
                            "vocoder", (b, t), self._vocoder_exe,
                            lambda inputs: self._compile_vocoder(b, t, inputs), {"mel": mel_dev},
                            eager)["wav"]
                        if marks:
                            marks[3].record()
                        wav_f = wav_dev.cpu().numpy()
                    finite = np.isfinite(wav_f).all(axis=1)
                    if not finite.all():
                        wav_f = np.nan_to_num(wav_f, posinf=1.0, neginf=-1.0)
                    wavs = np.clip(wav_f * self.max_wav_value, -self.max_wav_value,
                                   self.max_wav_value - 1).astype(np.int16)
        finally:
            # the success path's readback proves the device is past the
            # copies; on a fault they may still be in flight
            if leases and not synced and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            for buf in leases:
                self.pool.release(buf)

        self._dispatches.inc()
        self._request_rows.inc(n)
        dur = time.monotonic() - t_dispatch
        # the histograms measure steady-state dispatches: one that prepared
        # a program on a miss is counted but not timed
        steady = self.compile_count == compiles
        label = bucket_label(bucket) if prec == "f32" else f"{bucket_label(bucket)}@{prec}"
        if steady:
            self._acoustic_hist.observe(acoustic_s)
            self.registry.histogram(
                "serve_dispatch_seconds", labels={"bucket": label},
                help="wall time of one padded device dispatch, per lattice bucket",
            ).observe(dur)
        flops = self._dispatch_flops(bucket, prec)
        if steady and flops is not None and dur > 0:
            self.registry.histogram(
                "serve_achieved_flops_per_sec", edges=FLOPS_PER_SEC_BUCKETS,
                labels={"bucket": label},
                help="ProgramCard FLOPs / measured dispatch seconds, per lattice bucket",
            ).observe(flops / dur)

        wavs_finite = bool(finite.all())
        results = []
        for i, r in enumerate(requests):
            mel_len = int(host["mel_lens"][i])
            src_len = int(src_lens[i])
            wav = verdict = None
            if wavs is not None and not r.stream:
                wav = wavs[i, : mel_len * hop]
                # the batch's finite verdict marks every row of a
                # non-finite batch suspect, as in the JAX engine
                if r.quality_check:
                    verdict = self.quality.check(wav, klass=r.priority, source="engine",
                                                 finite=wavs_finite, trace=r.trace, req_id=r.id)
            p_len = src_len if self._ctl_axis["p"] == "src" else mel_len
            e_len = src_len if self._ctl_axis["e"] == "src" else mel_len
            results.append(SynthesisResult(
                id=r.id, raw_text=r.raw_text,
                mel=host["mel_postnet"][i, :mel_len], mel_len=mel_len, wav=wav,
                durations=host["durations"][i, :src_len],
                pitch_prediction=host["pitch_prediction"][i, :p_len],
                energy_prediction=host["energy_prediction"][i, :e_len],
                src_len=src_len, bucket=bucket, batch_rows=n, wav_finite=bool(finite[i]),
                style_degraded=r.style_degraded, trace=r.trace, priority=r.priority,
                precision=prec, quality=verdict,
            ))
        if traced:
            self._record_spans(requests, t_dispatch_wall, dur, acoustic_s, t_vocode_wall,
                               marks, label)
        return results

    @staticmethod
    def _record_spans(requests, start_wall: float, dur: float, acoustic_s: float,
                      vocode_wall: Optional[float], marks, label: str) -> None:
        """One ``engine_run`` span per trace in the dispatch, with the
        acoustic / vocode split as children (the JAX engine's records).
        ``vocode_wall`` is the host's clock just before the vocoder was
        enqueued (None: no vocoder ran), so each child starts at a host
        time. ``marks`` (CUDA events, already passed by the readback) give
        the children device durations; without them the host's times
        stand."""
        vocoded = vocode_wall is not None
        vocode_s = max(0.0, dur - acoustic_s)
        if marks:
            acoustic_s = marks[0].elapsed_time(marks[1]) / 1e3
            if vocoded:
                vocode_s = marks[2].elapsed_time(marks[3]) / 1e3
        seen = set()
        for r in requests:
            ctx = r.trace
            if ctx is None or ctx.trace_id in seen:
                continue
            seen.add(ctx.trace_id)
            eng = Span.record("engine_run", start_wall, dur, parent=ctx, bucket=label,
                              rows=len(requests))
            if eng is None:
                continue
            Span.record("engine_acoustic", start_wall, acoustic_s, parent=eng,
                        clock="cuda_event" if marks else "host")
            if vocoded:
                Span.record("engine_vocode", vocode_wall, vocode_s, parent=eng,
                            clock="cuda_event" if marks else "host")


def load_engine_parts(cfg: Config, restore_step: int, vocoder_ckpt: Optional[str] = None,
                      griffin_lim: bool = False, device=None, vocoder_seed: int = 1):
    """Restore the acoustic checkpoint and the vocoder once (JAX
    counterpart: ``load_engine_parts`` of speakingstyle_tpu/cli/serve.py):
    (model, vocoder, lattice, {"step", "weights_digest"}), both modules on
    ``device``. The model is built at the lattices' n_position, its
    weights restored from ``cfg.train.path.ckpt_path`` at ``restore_step``
    (<= 0: the latest) after the manifest check, with
    ``train.ignore_layers`` keeping their values drawn from
    ``train.seed``; the vocoder from ``vocoder_ckpt`` (a ``.pth.tar`` or a
    Flax ``.msgpack``; weights from ``vocoder_seed`` without one), or none
    under ``griffin_lim``. Engines built over these share the f32 weights:
    one copy on the card for any number of fleet replicas."""
    from speakingstyle_torch.synthesis import get_vocoder
    from speakingstyle_torch.training.checkpoint import CheckpointManager

    dev = resolve_device(device)
    lattice = BucketLattice.from_config(cfg.serve)
    model = init_weights(build_model(cfg, n_position=n_position_for(cfg, lattice)),
                         cfg.train.seed)
    info = CheckpointManager(cfg.train.path.ckpt_path).restore_weights(
        model, step=restore_step if restore_step > 0 else None,
        ignore_layers=cfg.train.ignore_layers)
    vocoder = None if griffin_lim else get_vocoder(cfg, vocoder_ckpt, seed=vocoder_seed)
    model = model.to(dev).eval()
    if vocoder is not None:
        vocoder = vocoder.to(dev).eval()
    return model, vocoder, lattice, info


def load_engine(cfg: Config, restore_step: int, vocoder_ckpt: Optional[str] = None,
                griffin_lim: bool = False, device=None, vocoder_seed: int = 1, **engine_kwargs):
    """An engine over trained weights (JAX counterpart: ``load_engine`` of
    speakingstyle_tpu/cli/serve.py), from ``load_engine_parts``. Returns
    (engine, {"step", "weights_digest"})."""
    model, vocoder, lattice, info = load_engine_parts(
        cfg, restore_step, vocoder_ckpt=vocoder_ckpt, griffin_lim=griffin_lim, device=device,
        vocoder_seed=vocoder_seed)
    engine = SynthesisEngine(cfg, model=model, vocoder=vocoder, lattice=lattice, device=device,
                             **engine_kwargs)
    return engine, info
