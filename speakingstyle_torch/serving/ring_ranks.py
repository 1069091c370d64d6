"""The ranks of a ring long-form tier's sequence group (serving/longform.py's
``RingTier``). The JAX package needs no counterpart: one JAX process drives
every device of its ``seq`` mesh. Here each rank of the ring is a process,
and ``serve`` is rank 0.

* **Rendezvous.** Rank 0 holds a ``TCPStore`` on a free port of 127.0.0.1
  and writes the job there (the config, the position-table length, the
  speaker count and the device kind); ``start_ring_group`` starts
  ``mesh_seq - 1`` helper processes (``python -m
  speakingstyle_torch.serving.ring_ranks``, through
  ``parallel/launch.py::start_workers``), each on ``cuda:{rank % cards}``.
  Each helper reads the job and sets ``ready/<rank>``; rank 0 waits for
  every helper (failing at once if one exits), then all ranks join the
  sequence group (``parallel.mesh.make_seq_mesh``, its short timeout).
* **Weights.** Each helper builds the ring model from the job;
  ``share_weights`` broadcasts rank 0's leaves (the state dict and the
  variance bins) and checks every rank's digest (``check_replicas``).
* **Serving.** For each run of a ring program rank 0 writes the bucket
  under ``req/<k>`` and broadcasts the padded inputs; each helper runs the
  same program on them (``ring_program``) and drops the output; ``stop``
  ends the loop. A helper exits when rank 0's process is gone.
* **Failure.** An error on rank 0 during a run leaves the helpers in an
  unknown place in the program: ``RingGroup.broken`` records it and the
  group is not used again (``available`` is False; chapters are then
  served chunked). Nothing is respawned, as the JAX package has no such
  behaviour.

``run_helper`` is a helper's whole life; the tests run it on threads of
one process over a ``HashStore`` (ranks as threads), the process entry
point over the TCP store.
"""

import dataclasses
import datetime
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from speakingstyle_torch.parallel.mesh import RING_TIMEOUT_S, SeqMesh, check_replicas, \
    make_seq_mesh

__all__ = ["RingGroup", "ring_inputs", "ring_leaves", "ring_model", "ring_program",
           "run_helper", "share_weights", "start_ring_group"]

# seconds the helpers get to read the job and report ready (on the card a
# process takes ~10-20 s to import torch and reach its device)
STARTUP_TIMEOUT_S = 600.0
# seconds between a waiting rank's looks at the store (a ring program's
# start waits up to this for the helpers)
POLL_S = 0.02
# seconds rank 0 waits for the helpers' stats of the programs announced
STATS_TIMEOUT_S = 30.0
# the acoustic program's outputs (serving/engine.py's)
KEEP = ("mel_postnet", "mel_lens", "durations", "pitch_prediction", "energy_prediction")


def ring_model(cfg, n_position: int, n_speakers: int, mesh: SeqMesh):
    """The acoustic model of a ring tier over ``mesh``: ``cfg`` at
    ``attention_impl="ring"`` (the caller's), uninitialised until
    ``share_weights``. A helper builds it here; rank 0 through
    ``models/factory.build_model``."""
    from speakingstyle_torch.models.fastspeech2 import FastSpeech2

    return FastSpeech2(cfg, n_speakers=n_speakers, n_position=n_position,
                       seq_mesh=mesh).to(mesh.device).eval()


def ring_leaves(model) -> List[torch.Tensor]:
    """What a ring rank needs of rank 0's model, in one order on every rank:
    the state dict and the variance bins (non-persistent buffers made from
    the dataset statistics)."""
    va = model.variance_adaptor
    return list(model.state_dict().values()) + [va.pitch_bins, va.energy_bins]


def _digest(tensors: Sequence[torch.Tensor]) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def share_weights(model, mesh: SeqMesh) -> str:
    """Rank 0's ``ring_leaves`` on every rank (a collective), then every
    rank's digest checked equal; returns the digest."""
    leaves = ring_leaves(model)
    with torch.no_grad():
        mesh.broadcast_(leaves)
    digest = _digest(leaves)
    check_replicas(digest, mesh, "ring tier weights")
    return digest


def ring_program(model, t_mel: int, use_style: bool) -> Callable:
    """The free run of one ring bucket, the function every rank runs."""
    def fn(speakers, texts, src_lens, p_control, e_control, d_control, gammas=None,
           betas=None):
        out = model(speakers, texts, src_lens, max_mel_len=t_mel, p_control=p_control,
                    e_control=e_control, d_control=d_control,
                    gammas=gammas if use_style else None, betas=betas if use_style else None)
        return {k: out[k] for k in KEEP}
    return fn


def ring_inputs(cfg, l_src: int, t_mel: int,
                alloc: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """The inputs of a ring bucket, in the order they are broadcast, each
    from ``alloc(shape, dtype, fill)`` (default: fresh host tensors; rank 0
    passes its pool leases): texts ones and controls one (a valid example),
    style zeros."""
    alloc = alloc or (lambda shape, dtype=torch.float32, fill=0:
                      torch.full(shape, fill, dtype=dtype))
    pp = cfg.preprocess.preprocessing
    ctl = {"p": pp.pitch.feature, "e": pp.energy.feature, "d": "phoneme_level"}
    out = {"speakers": alloc((1,), torch.int64, 0), "texts": alloc((1, l_src), torch.int64, 1),
           "src_lens": alloc((1,), torch.int64, l_src)}
    for k in ("p", "e", "d"):
        out[f"{k}_control"] = alloc((1, l_src if ctl[k] == "phoneme_level" else t_mel),
                                    torch.float32, 1)
    if cfg.model.use_reference_encoder:
        d = cfg.model.reference_encoder.encoder_hidden
        out["gammas"] = alloc((1, 1, d), torch.float32, 0)
        out["betas"] = alloc((1, 1, d), torch.float32, 0)
    return out


class RingGroup:
    """Rank 0's side of a ring tier's sequence group: the joined ``mesh``,
    the ``store`` of the request channel and the helper processes
    (``procs``; none where the helpers are threads)."""

    def __init__(self, mesh: SeqMesh, store, procs: Sequence = ()):
        self.mesh, self.store, self.procs = mesh, store, list(procs)
        self.broken: Optional[str] = None
        self._k = 0

    @property
    def available(self) -> bool:
        """The group can run a program: nothing broke it and no helper
        process has exited."""
        if self.broken is None:
            dead = [p.pid for p in self.procs if p.poll() is not None]
            if dead:
                self.broken = f"helper process(es) {dead} exited"
        return self.broken is None

    def announce(self, l_src: int, t_mel: int, inputs: Dict[str, torch.Tensor]) -> None:
        """Tell the helpers to run bucket ``(l_src, t_mel)`` and broadcast
        ``inputs`` (``ring_inputs``' order) to them."""
        self.store.set(f"req/{self._k}", json.dumps({"l_src": l_src, "t_mel": t_mel}))
        self._k += 1
        self.mesh.broadcast_(list(inputs.values()))

    def helper_stats(self) -> Dict[int, Dict]:
        """Each helper's ``stats/<rank>`` once it has finished every program
        announced so far, or as it stands ``STATS_TIMEOUT_S`` on (programs
        run, collective counters, memory, the sha256 of its last mel,
        ``mel_digest``)."""
        out, deadline = {}, time.monotonic() + STATS_TIMEOUT_S
        for r in range(1, self.mesh.n):
            while True:
                try:
                    out[r] = json.loads(self.store.get(f"stats/{r}")) if self.store.check(
                        [f"stats/{r}"]) else {"runs": 0}
                except RuntimeError as e:  # the store is gone with a failed group
                    out[r] = {"error": str(e)}
                    break
                if out[r].get("runs", 0) >= self._k or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        return out

    def mark_broken(self, err: BaseException) -> None:
        if self.broken is None:
            self.broken = f"{type(err).__name__}: {err}"

    def close(self) -> None:
        """Stop the helpers (a ``stop`` request, then the processes are
        waited for, or killed past the grace)."""
        from speakingstyle_torch.parallel.launch import stop_all

        try:
            self.store.set(f"req/{self._k}", json.dumps("stop"))
        except RuntimeError:  # the store is gone with a failed group
            pass
        deadline = time.monotonic() + 10.0
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:  # stopped below
                pass
        stop_all(self.procs)
        self.broken = self.broken or "closed"


def _wait_key(store, key: str, keep_waiting: Callable[[], bool], timeout_s: float) -> None:
    """Wait for ``key`` in ``store``, looking every ``POLL_S`` while
    ``keep_waiting()``; raises RuntimeError past ``timeout_s`` or when it
    says stop. (A look is ``check``, which returns at once: a store's timed
    ``wait`` logs a warning each time it runs out, every few seconds of an
    idle helper.)"""
    deadline = time.monotonic() + timeout_s
    while not store.check([key]):
        if not keep_waiting():
            raise RuntimeError(f"stopped waiting for {key!r}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"{key!r} did not arrive within {timeout_s:.0f} s")
        time.sleep(POLL_S)


def start_ring_group(n: int, job: Dict, device, store=None,
                     timeout_s: float = RING_TIMEOUT_S) -> RingGroup:
    """Rank 0 of an ``n``-rank ring: write ``job`` to ``store``, wait for
    the helpers (``STARTUP_TIMEOUT_S``, or until a helper process exits)
    and join the group. Without ``store`` the function makes a ``TCPStore``
    on a free port and starts the ``n - 1`` helper processes; with one the
    caller runs ``run_helper`` for each helper rank. On a failure the
    helpers started are stopped."""
    import torch.distributed as dist

    from speakingstyle_torch.parallel.launch import free_port, start_workers, stop_all

    device = torch.device(device)
    procs = []
    try:
        if store is None:
            port = free_port()
            store = dist.TCPStore("127.0.0.1", port, n, True,
                                  datetime.timedelta(seconds=STARTUP_TIMEOUT_S),
                                  wait_for_workers=False)
            if device.type == "cuda":
                from speakingstyle_torch.ops import kernels

                kernels.build_all()  # the helpers load what this built
            procs = start_workers(["-m", "speakingstyle_torch.serving.ring_ranks"],
                                  range(1, n), n, port)
        store.set("job", json.dumps(dict(job, device=device.type, timeout_s=timeout_s)))
        alive = lambda: all(p.poll() is None for p in procs)  # noqa: E731
        for r in range(1, n):
            try:
                _wait_key(store, f"ready/{r}", alive, STARTUP_TIMEOUT_S)
            except RuntimeError as e:
                exited = {p.pid: p.returncode for p in procs if p.poll() is not None}
                if exited:
                    raise RuntimeError(f"ring helper process(es) exited before joining "
                                       f"(pid: exit code) {exited}") from e
                raise
        mesh = make_seq_mesh(n, store, 0, device, timeout_s)
    except BaseException:
        stop_all(procs)
        raise
    return RingGroup(mesh, store, procs)


def run_helper(store, rank: int, keep_waiting: Callable[[], bool] = lambda: True) -> int:
    """A helper rank's life: read the job, report ready, join the group
    (with rank 0's collective timeout), build the ring model and take rank
    0's weights, then run each announced program until ``stop``; returns
    the programs run."""
    from speakingstyle_torch.configs.config import config_from_dict

    _wait_key(store, "job", keep_waiting, STARTUP_TIMEOUT_S)
    job = json.loads(store.get("job"))
    cfg = config_from_dict(job["config"])
    timeout_s = job["timeout_s"]
    device = torch.device("cpu")
    if job["device"] == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    store.set(f"ready/{rank}", "1")
    mesh = make_seq_mesh(job["n"], store, rank, device, timeout_s)
    model = ring_model(cfg, job["n_position"], job["n_speakers"], mesh)
    share_weights(model, mesh)
    use_style = cfg.model.use_reference_encoder
    runs = 0
    while True:
        key = f"req/{runs}"
        _wait_key(store, key, keep_waiting, float("inf"))
        msg = json.loads(store.get(key))
        if msg == "stop":
            return runs
        inputs = ring_inputs(cfg, msg["l_src"], msg["t_mel"])
        mesh.broadcast_(list(inputs.values()))
        with torch.no_grad():
            out = ring_program(model, msg["t_mel"], use_style)(
                **{k: v.to(device) for k, v in inputs.items()})
        runs += 1
        mel = out["mel_postnet"][0, :int(out["mel_lens"][0])]
        store.set(f"stats/{rank}", json.dumps(dict(_rank_stats(mesh, runs),
                                                   mel_digest=_digest([mel]))))


def _rank_stats(mesh: SeqMesh, runs: int) -> Dict:
    """A rank's programs run, its collectives' counters and, on the card,
    its memory (with the digest of its last program's mel, in
    ``stats/<rank>``)."""
    out = dict(mesh.stats, runs=runs)
    if mesh.device.type == "cuda":
        out.update(memory_reserved_bytes=torch.cuda.memory_reserved(mesh.device),
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(mesh.device))
    return out


def job_of(cfg, n_position: int, n_speakers: int) -> Dict:
    """The job rank 0 writes for its helpers."""
    return {"config": dataclasses.asdict(cfg), "n": cfg.serve.longform.mesh_seq,
            "n_position": n_position, "n_speakers": n_speakers}


def main() -> int:
    """A helper process: the rendezvous of its environment
    (``parallel/launch.py::worker_env``), then ``run_helper``."""
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    parent = os.getppid()
    store = dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]), world,
                          False, datetime.timedelta(seconds=STARTUP_TIMEOUT_S))
    t0 = time.monotonic()
    print(f"[ring {rank}] joined the store", flush=True)
    try:
        runs = run_helper(store, rank, keep_waiting=lambda: os.getppid() == parent)
    except RuntimeError as e:
        print(f"[ring {rank}] stopped: {e}", flush=True)
        return 1
    print(f"[ring {rank}] stopped after {runs} program(s), {time.monotonic() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
