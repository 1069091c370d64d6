"""The program registry: the one place where serving programs are prepared
(JAX counterpart: speakingstyle_tpu/parallel/registry.py), and the
precision casts of the serving tiers.

The JAX package compiles one XLA executable per lattice point ahead of
time, so a steady-state dispatch never compiles. On the card the port's
counterpart is a CUDA graph per point: ``ProgramRegistry.prepare`` runs the
program once eagerly (the warm-up, which also builds the hand-written
kernels with ``nvcc`` and sets their shared-memory limits, neither of which
may happen under a capture; a dispatch that misses is itself the warm-up
and takes its outputs), then on a CUDA device captures it into a
``torch.cuda.CUDAGraph`` with static input buffers, in one memory pool per
registry. On the CPU the program is the eager callable, counted the same
way, so the counting is testable without a card. CUDA graphs and not
``torch.compile``: dynamo cannot trace the kernels' ctypes calls and would
break the graph at each of them. A capture that fails raises; nothing falls
back to eager on the card.

What the registry does, uniformly for every consumer:

* **dedupe**: ``prepare`` keys on (name, input shape/dtype signature,
  precision); a repeat returns the same ``Program``;
* **count**: each preparation increments the consumer's counter
  (``serve_compiles_total``, ``serve_style_compiles_total``), the port's
  counterpart of the JAX package's compile counter;
* **card**: each preparation mints a ``ProgramCard`` (obs/cost.py) whose
  row also carries the precision, the labels and the kernel launches one
  replay makes.

**Launch counts under replay.** The kernel wrappers count their launches in
plain integers (``fused_mha.launches``, ``fused_conv1d.launches``, ...),
which move at the capture (where nothing is launched) and never at a
replay. The registry records each graph's counter deltas at the capture,
takes them back, refuses a capture whose deltas differ from the warm-up's,
and credits them on every replay, so each count is the launches the
device ran.

**Preparations and other threads.** A preparation measures launches and
FLOPs on process-wide counters, and its capture runs in CUDA's global
capture mode (PyTorch's default), in which CUDA work another thread issues
during the capture fails. So every device entry point holds the
``DEVICE_GATE`` shared (``dispatching``) and a preparation holds it
exclusively: a miss waits for the dispatches in flight and holds new ones
back until its capture is done, then the traffic resumes. (The JAX engine
lets other buckets dispatch while one compiles; here they wait.) The gate
is phase-fair: the dispatches that waited behind one preparation enter
before the next preparation does, so a replica warming program after
program (serving/fleet.py) holds another replica's dispatch back for at
most one capture each, never for the whole warm-up.

**Outputs of a shared pool.** Graphs of one registry share a memory pool
and replay in any order, so one graph's outputs can sit in memory another
graph uses for intermediates. Every replay therefore copies its outputs
out (a device-side clone on the same stream) before the next replay of the
registry is enqueued; the registry's replay lock orders the two.

**Precision.** ``cast_params`` / ``dequant_params`` convert a module's
weights between the serving precisions ``f32`` / ``bf16`` / ``int8`` with
the JAX package's arithmetic, leaf for leaf in the Flax layout, so that the
cast weights equal JAX's bit for bit.
"""

import contextlib
import functools
import threading
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from speakingstyle_torch.obs import MetricsRegistry, make_lock

__all__ = [
    "DEVICE_GATE",
    "DeviceGate",
    "PRECISIONS",
    "Program",
    "ProgramRegistry",
    "cast_params",
    "dequant_params",
    "dispatching",
    "read_launches",
]

# The serving precision axis, widest first: "f32" is the identity tier,
# "bf16" stores float leaves in bfloat16, "int8" per-channel symmetric
# quantized weights widened to f32 on read inside the program.
PRECISIONS = ("f32", "bf16", "int8")

_INT8_KEYS = frozenset(("int8_q", "int8_scale"))


class DeviceGate:
    """Device work against program preparations: any number of threads
    hold the gate shared (a dispatch), or one holds it exclusively (a
    preparation); a waiting preparation holds new shared entries back.

    Phase-fair: the shared entries waiting when an exclusive hold ends are
    admitted before the next exclusive entry, so back-to-back
    preparations cannot starve the dispatches.

    Shared holds nest per thread, and a thread holding the gate
    exclusively passes its own shared entries. ``exclusive`` and
    ``released`` drop the calling thread's shared holds for their block
    and take them back after it, so a dispatch that misses can prepare
    inside itself; a thread that waits for another thread's preparation
    (a condition, a compile lock) must wait inside ``released``, or the
    two would wait on each other."""

    def __init__(self):
        self._cond = make_lock("DeviceGate._cond", kind="condition")
        self._readers = 0
        self._writer: Optional[int] = None
        self._writers_waiting = 0
        # phase fairness: shared entries waiting, and of those waiting when
        # the last exclusive hold ended, how many are still to enter
        self._readers_waiting = 0
        self._admit = 0
        self._admit_gen = 0
        self._local = threading.local()

    def _holds(self) -> Tuple[int, int]:
        return getattr(self._local, "shared", 0), getattr(self._local, "exclusive", 0)

    def _enter_shared(self) -> None:
        with self._cond:
            self._readers_waiting += 1
            gen = self._admit_gen
            while True:
                if self._writer is None:
                    # waited through an exclusive hold: enters before the next
                    first = self._admit_gen != gen and self._admit > 0
                    if first or not self._writers_waiting:
                        self._admit -= int(first)
                        break
                self._cond.wait()
            self._readers_waiting -= 1
            self._readers += 1

    def _leave_shared(self) -> None:
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    @contextlib.contextmanager
    def shared(self):
        shared, exclusive = self._holds()
        if not shared and not exclusive:
            self._enter_shared()
        self._local.shared = shared + 1
        try:
            yield
        finally:
            self._local.shared = shared
            if not shared and not exclusive:
                self._leave_shared()

    @contextlib.contextmanager
    def released(self):
        shared, exclusive = self._holds()
        if not shared or exclusive:
            yield
            return
        self._local.shared = 0
        self._leave_shared()
        try:
            yield
        finally:
            self._enter_shared()
            self._local.shared = shared

    @contextlib.contextmanager
    def exclusive(self):
        _, exclusive = self._holds()
        if exclusive:
            self._local.exclusive = exclusive + 1
            try:
                yield
            finally:
                self._local.exclusive = exclusive
            return
        with self.released():
            me = threading.get_ident()
            with self._cond:
                self._writers_waiting += 1
                try:
                    while self._writer is not None or self._readers or self._admit:
                        self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = me
            self._local.exclusive = 1
            try:
                yield
            finally:
                self._local.exclusive = 0
                with self._cond:
                    self._writer = None
                    self._admit, self._admit_gen = self._readers_waiting, self._admit_gen + 1
                    self._cond.notify_all()


# one gate per process: the launch counters, the FLOP tallies and CUDA's
# capture mode are process-wide
DEVICE_GATE = DeviceGate()


def dispatching(fn: Callable) -> Callable:
    """Decorator for a device entry point: ``fn`` runs holding
    ``DEVICE_GATE`` shared."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with DEVICE_GATE.shared():
            return fn(*args, **kwargs)
    return wrapper


def _is_int8_leaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == set(_INT8_KEYS)


def carried_leaves(module: nn.Module) -> Dict[str, Tuple[torch.Tensor, Optional[tuple]]]:
    """State-dict name -> (tensor, permutation to the port's layout from
    the Flax one) of every parameter and statistic the Flax variable tree
    carries (compat/from_jax.py's leaf table). Buffers the JAX package
    holds as constants (the position tables ``pe``, ``pitch_bins``,
    ``energy_bins``) are not carried, so no precision touches them."""
    from speakingstyle_torch.compat.from_jax import expected_leaves

    by_id = {id(t): (t, perm) for t, perm in expected_leaves(module).values()}
    named = list(module.named_parameters()) + list(module.named_buffers())
    return {name: by_id[id(t)] for name, t in named if id(t) in by_id}


def _quantize_flax(arr: np.ndarray):
    """The JAX package's int8 rule on a Flax-layout f32 array: one scale
    ``amax / 127`` per output channel (the last axis, over all leading
    axes), 1 where a channel is all zeros, weights rounded and clipped."""
    axes = tuple(range(arr.ndim - 1))
    amax = np.max(np.abs(arr), axis=axes, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, np.float32(1.0), scale)
    q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
    return q, scale


def cast_params(module: nn.Module, precision: str) -> Dict:
    """One serving tree of ``module``'s carried leaves (state-dict name ->
    tensor, or an ``{"int8_q", "int8_scale"}`` pair):

    * ``"f32"``: the module's own tensors;
    * ``"bf16"``: each leaf rounded to bfloat16 (round to nearest even, as
      ``jnp.asarray(x, bfloat16)``);
    * ``"int8"``: each leaf of two or more axes quantized per output
      channel exactly as the JAX package does, in the Flax layout (Linear
      ``[out, in]`` is Flax ``[in, out]``, Conv1d keeps ``[K, Cin, Cout]``,
      Embedding ``[num, dim]`` gets one scale per ``dim`` column), then
      stored in the port's layout; smaller leaves stay f32 (copies).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    tree = {}
    for name, (t, perm) in carried_leaves(module).items():
        t = t.detach()
        if precision == "f32":
            tree[name] = t
        elif precision == "bf16" and t.is_floating_point():
            tree[name] = t.to(torch.bfloat16)
        elif t.dim() < 2 or not t.is_floating_point():
            # a tier owns its leaves: the f32 tree's tensors are the
            # module's own, which an in-place change of this tier must
            # not reach
            tree[name] = t.clone()
        else:
            flax = t.float().cpu().numpy()
            if perm is not None:
                flax = np.transpose(flax, np.argsort(perm))
            q, scale = _quantize_flax(flax)
            if perm is not None:
                q, scale = np.transpose(q, perm), np.transpose(scale, perm)
            tree[name] = {
                "int8_q": torch.from_numpy(np.ascontiguousarray(q)).to(t.device),
                "int8_scale": torch.from_numpy(np.ascontiguousarray(scale)).to(t.device),
            }
    return tree


def dequant_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A serving tree widened to f32 for the port's modules (which cast
    each weight to the compute dtype at use): int8 pairs become
    ``q.float() * scale`` (JAX's ``dequant_params``), bfloat16 leaves
    ``.float()`` (exact). Runs inside the program, so the narrow tree is
    what stays resident in device memory."""
    out = {}
    for name, v in tree.items():
        if _is_int8_leaf(v):
            out[name] = v["int8_q"].float() * v["int8_scale"]
        elif v.is_floating_point() and v.dtype != torch.float32:
            out[name] = v.float()
        else:
            out[name] = v
    return out


def _launch_counters():
    from speakingstyle_torch.ops.fused_attention import attention_delta, fused_mha, fused_mha_bwd
    from speakingstyle_torch.ops.fused_conv import fused_conv1d

    return ((fused_mha, "launches"), (fused_mha, "launches_bf16sm"),
            (fused_mha_bwd, "launches"), (fused_mha_bwd, "launches_bf16sm"),
            (attention_delta, "launches"), (fused_conv1d, "launches"),
            (fused_conv1d, "act_launches"))


def read_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count, as ``"fused_mha.launches"``."""
    return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in _launch_counters()}


_CREDIT_LOCK = make_lock("registry._CREDIT_LOCK")


def _credit(deltas: Mapping[str, int]) -> None:
    with _CREDIT_LOCK:  # replays of several threads credit the same counters
        for obj, attr in _launch_counters():
            n = deltas.get(f"{obj.__name__}.{attr}", 0)
            if n:
                setattr(obj, attr, getattr(obj, attr) + n)


def _delta(before: Mapping[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in read_launches().items() if v != before[k]}


def _signature(example: Mapping[str, torch.Tensor]) -> str:
    return repr(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in example.items()))


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


class Program:
    """One prepared program: ``fn`` at fixed input shapes on one device
    and, on a CUDA device, its captured graph.

    ``program(inputs)`` takes a dict of tensors (host or device, the shapes
    it was prepared at) and returns a dict of fresh device tensors. On the
    card it copies the inputs into the graph's static buffers (``non_blocking``
    from pinned host memory), replays, credits the launch counts and clones
    the outputs out, all on the current stream and under the registry's
    replay lock; it returns at enqueue. ``eager=True`` (and every call on
    the CPU) runs ``fn`` itself instead. Holds ``DEVICE_GATE`` shared."""

    def __init__(self, name: str, fn: Callable, device: torch.device, card: Dict,
                 launches: Dict[str, int], replay_lock, graph=None,
                 static_in: Optional[Dict[str, torch.Tensor]] = None,
                 static_out: Optional[Dict[str, torch.Tensor]] = None):
        self.name, self.fn, self.device, self.card = name, fn, device, card
        self.launches = launches
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self._replay_lock = replay_lock

    @dispatching
    def __call__(self, inputs: Mapping[str, torch.Tensor],
                 eager: bool = False) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            if self.graph is None or eager:
                return dict(self.fn(**{k: v.to(self.device, non_blocking=True)
                                       for k, v in inputs.items()}))
            with self._replay_lock:
                for k, buf in self.static_in.items():
                    buf.copy_(inputs[k], non_blocking=True)
                self.graph.replay()
                out = {k: v.clone() for k, v in self.static_out.items()}
            _credit(self.launches)
            return out


class ProgramRegistry:
    """Program preparation for one consumer (an engine, a style service).

    Owns the program and card tables, a preparation counter in the
    consumer's ``MetricsRegistry`` (``counter_name`` keeps the JAX
    package's per-subsystem names working) and, on a CUDA device, the
    graphs' capture stream and memory pool."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None, *,
                 counter_name: str = "program_registry_compiles_total",
                 prefix: str = "program"):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.prefix = prefix
        self._compiles = self.metrics.counter(
            counter_name, help="programs prepared (captured) through this ProgramRegistry")
        # this registry's own preparations (the counter may be shared by
        # several consumers of one MetricsRegistry, as a fleet's replicas)
        self._prepared = 0
        self._lock = make_lock("ProgramRegistry._lock", kind="rlock")
        self._replay_lock = make_lock("ProgramRegistry._replay_lock")
        self._programs: Dict[Tuple, Program] = {}
        self._cards: List[Dict] = []
        self._pool = None
        self._stream = None  # the capture stream, made at the first preparation

    @property
    def compile_count(self) -> int:
        """Programs this registry prepared (its share of the counter)."""
        with self._lock:
            return self._prepared

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def programs(self) -> List[Dict]:
        """The card table: one JSON-ready row per program, in preparation order."""
        with self._lock:
            return [dict(row) for row in self._cards]

    def close(self) -> None:
        """Drop every program, its graph and the graphs' memory pool (the
        card memory goes back to the caching allocator once nothing else
        holds the programs). The caller holds ``DEVICE_GATE`` exclusively,
        so no replay and no capture runs meanwhile. The card table stays."""
        with self._lock:
            self._programs.clear()
            self._pool = None
            self._stream = None

    def prepare(self, fn: Callable, example: Mapping[str, torch.Tensor], *, name: str,
                device, labels: Optional[Dict[str, str]] = None,
                precision: str = "f32",
                capture: bool = True) -> Tuple[Program, Optional[Dict[str, torch.Tensor]]]:
        """(callable, inputs, name) -> (the ``Program``, the warm-up's
        outputs), with the bookkeeping done; a key prepared before returns
        (its program, None). ``fn(**inputs)`` returns a dict of tensors.

        The warm-up runs ``fn`` once on ``example`` (a dispatch's own
        inputs, or any valid inputs at precompile: the capture records
        kernels, not data), so a dispatch that prepares on a miss takes the
        warm-up's outputs as its result and launches each kernel once. On
        the card the warm-up runs on the registry's capture stream (first
        use of the stream's library handles and workspaces happens there,
        never under the capture), then the capture follows; the capture
        launches nothing, so the counts its wrappers added are taken back
        (and credited on every replay). Counts one preparation per new key.
        A new key is prepared holding ``DEVICE_GATE`` exclusively.

        ``capture=False`` prepares a program that is never captured: one
        whose run holds host work a graph cannot record (a ring program's
        gloo collectives, serving/longform.py's ``RingTier``). Its
        preparation counts, mints its card and runs the warm-up on the
        caller's stream like the others; its calls run ``fn`` eagerly,
        holding the gate shared, and its kernels count their own launches
        as they happen. The preparation still holds the gate exclusively:
        the warm-up reads the launch counters and FLOP tallies, which are
        process-wide, and it runs once per point at start-up."""
        from torch.utils.flop_counter import FlopCounterMode

        from speakingstyle_torch.obs.cost import ProgramCard, publish_program_gauges
        from speakingstyle_torch.ops import kernels

        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        device = torch.device(device)
        key = (name, _signature(example), precision)
        with self._lock:
            prog = self._programs.get(key)
        if prog is not None:
            return prog, None
        with DEVICE_GATE.exclusive(), self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog, None
            dev_in = {k: v.to(device, non_blocking=True) for k, v in example.items()}
            cuda = device.type == "cuda" and capture
            stream = None
            if cuda:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(device)
                stream = self._stream
                stream.wait_stream(torch.cuda.current_stream(device))
            before = read_launches()
            with torch.no_grad(), kernels.counting_flops() as tally, \
                    FlopCounterMode(display=False) as counter, \
                    (torch.cuda.stream(stream) if cuda else contextlib.nullcontext()):
                out = dict(fn(**dev_in))
            flops = float(counter.get_total_flops() + tally[0])
            launches = _delta(before)
            graph = static_in = static_out = peak = None
            if cuda:
                torch.cuda.current_stream(device).wait_stream(stream)
                # hand the caller copies made on its own stream: the
                # originals belong to the capture stream's memory pool
                with torch.no_grad():
                    out = {k: v.clone() for k, v in out.items()}
                torch.cuda.synchronize(device)
                graph, static_in, static_out, peak = self._capture(
                    fn, dev_in, device, launches, name)
            card = ProgramCard(name=name, flops=flops, peak_bytes=peak,
                               argument_bytes=_nbytes(dev_in.values()),
                               output_bytes=_nbytes(out.values()))
            self._compiles.inc()
            self._prepared += 1
            publish_program_gauges(self.metrics, card, self.prefix, labels=labels or {})
            row = card.as_dict()
            row["precision"] = precision
            row["graph"] = graph is not None
            row["launches_per_replay"] = dict(launches)
            if labels:
                row.update({f"label_{k}": v for k, v in labels.items()})
            self._cards.append(row)
            prog = Program(name, fn, device, row, launches, self._replay_lock, graph,
                           static_in, static_out)
            self._programs[key] = prog
            return prog, out

    def _capture(self, fn, dev_in, device, launches, name):
        """Capture ``fn`` into a graph of this registry's pool on the
        capture stream; returns (graph, static inputs, static outputs, the
        capture's peak bytes). Raises if the capture fails or records other
        kernel launches than the warm-up made."""
        static_in = {k: v.clone() for k, v in dev_in.items()}
        torch.cuda.synchronize(device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = read_launches()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                static_out = dict(fn(**static_in))
        finally:
            captured = _delta(before)
            _credit({k: -n for k, n in captured.items()})  # recorded, not launched
        torch.cuda.synchronize(device)
        peak = float(torch.cuda.max_memory_allocated(device) - base)
        if captured != launches:
            raise RuntimeError(
                f"{name}: the capture recorded {captured} launches, the warm-up made {launches}")
        return graph, static_in, static_out, peak
