"""The rank processes of a (data, model) mesh (JAX counterpart:
speakingstyle_tpu/parallel/mesh.py).

The JAX package drives every device of a ``Mesh`` from one process and lets
GSPMD insert the collectives. The port runs one process a rank, each with
its own CUDA context, joined in a ``torch.distributed`` process group: the
``Mesh`` here is that group's description, ``dp`` ranks on the ``data``
axis times ``tp`` on the ``model`` axis, laid out as the JAX package's
``devices.reshape(data, model)``: ``dp_rank = rank // tp``, ``tp_rank =
rank % tp``. The global batch is split by rows over ``dp_rank`` (every tp
rank of a data-parallel group sees the same rows), the JAX package's
``P("data")``; the parameters are replicated, or split over ``tp`` by
``parallel/partition.py``'s layout.

* Groups: ``"world"``; ``"dp"``, the ranks of one ``tp_rank`` (the
  gradient and BatchNorm all-reduces); ``"tp"``, the ranks of one
  ``dp_rank`` (``parallel/tensor.py``'s collectives). Each has a CPU gloo
  host twin where the device backend is NCCL.

* ``init_distributed`` joins the rendezvous torchrun (or
  ``parallel/launch.py``) describes in the environment: ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``. A rank's device is ``cuda:{LOCAL_RANK % cards}``, and the
  CPU only when the caller asks for it.
* The backend is chosen from the counts before the group starts and never
  switched after a failure: ``nccl`` when every local rank has a card of
  its own, ``gloo`` when local ranks share a card (NCCL refuses two ranks
  on one device) or on the CPU.
* On the step's path the data collectives are ``all_reduce`` and
  ``broadcast`` only: gloo runs both on CUDA tensors, so one code path
  serves NCCL and a shared card. Host values (flags, counts, gauges) go
  over a CPU gloo group (the device group itself under gloo).

The sequence axis is a mesh of its own, as in the JAX package
(``make_seq_mesh``: a 1-D ``("seq",)`` mesh beside the ``(data, model)``
one): ``SeqMesh``, ``n`` ranks each holding block ``rank`` of a sequence,
joined in a gloo group that is not the process's default group (a server
keeps serving on its own when the group breaks), with a short timeout of
its own (``RING_TIMEOUT_S``). Its collectives stage every tensor through
host memory (pinned where it comes from the card): ``rotate`` is JAX's
``ppermute`` with ``perm = [(i, (i + 1) % n)]`` as a gloo send to the next
rank and a receive from the previous one, which gloo runs on CPU tensors
only; ``gather`` is the whole sequence from every rank's block by ``n - 1``
rotations (exact: nothing is summed); ``broadcast_`` sends rank 0's
values.
"""

import dataclasses
import datetime
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

AXIS_NAMES = ("data", "model")
# the rendezvous variables torchrun sets (and parallel/launch.py sets for
# the workers it starts)
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT")
# gradient buckets of an all-reduce: a few large collectives instead of
# one per parameter
BUCKET_BYTES = 64 << 20
# seconds a collective waits for the other ranks before the group fails
GROUP_TIMEOUT_S = 1800.0
# the same for a sequence group: a ring rank that does not answer within
# this fails the ring program (a server then serves without the ring)
RING_TIMEOUT_S = 60.0


class BatchShardingError(ValueError):
    """Global batch size incompatible with the mesh's ``data`` axis.

    Raised at startup, before any worker starts or any tensor moves, so a
    bad ``train.optimizer.batch_size`` / data-parallel pairing fails with
    the fix in the message."""


@dataclass
class Mesh:
    """A process group as the trainers see it: ``dp`` x ``tp`` ranks, this
    process's ``rank`` and ``local_rank``, its ``device`` and the group's
    ``backend``. An unjoined mesh (``make_mesh``, ``resolve_mesh``) only
    describes the shape; ``init_distributed`` returns a joined one."""

    dp: int = 1
    tp: int = 1
    rank: int = 0
    local_rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: Optional[str] = None
    backend_reason: str = ""
    host_group: object = None  # the CPU gloo group (None: the world, under gloo)
    # "dp" / "tp" -> (device group, host group, its global ranks); a group
    # of None is the world
    groups: Dict[str, tuple] = field(default_factory=dict)

    axis_names = AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.tp}

    @property
    def joined(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of ``global_batch`` rows."""
        b = local_batch_size(global_batch, self)
        return slice(self.dp_rank * b, (self.dp_rank + 1) * b)

    def ranks(self, group: str = "world") -> List[int]:
        """The global ranks of this rank's ``group``, in group order."""
        if group == "world":
            return list(range(self.world))
        if group in self.groups:
            return list(self.groups[group][2])
        if group == "dp":
            return [d * self.tp + self.tp_rank for d in range(self.dp)]
        return [self.dp_rank * self.tp + t for t in range(self.tp)]

    def _alone(self, group: str) -> bool:
        """This rank is all of ``group`` within a larger mesh (a collective
        over it is the identity and is skipped; at world size 1 the
        collectives still run)."""
        return self.world > 1 and len(self.ranks(group)) == 1

    def _groups(self, group: str):
        """(device group, host group) of ``group``."""
        if group == "world" or group not in self.groups:
            if group != "world" and len(self.ranks(group)) != self.world:
                raise RuntimeError(f"the mesh has no {group!r} group")
            return None, self.host_group
        return self.groups[group][:2]

    # -- collectives --------------------------------------------------------

    def _check(self) -> None:
        if not self.joined:
            raise RuntimeError("the mesh has no process group: call init_distributed()")

    def all_reduce_(self, tensors: Sequence[torch.Tensor], group: str = "dp") -> None:
        """Sum ``tensors`` over ``group``'s ranks in place, in flat buckets
        (one collective a bucket), inside a ``<group>.all_reduce`` profiler
        range."""
        import torch.distributed as dist
        from torch.profiler import record_function

        self._check()
        if self._alone(group):
            return
        g = self._groups(group)[0]
        with record_function(f"{group}.all_reduce"):
            _bucketed(tensors, lambda flat: dist.all_reduce(flat, group=g))

    def broadcast_(self, tensors: Sequence[torch.Tensor], group: str = "dp") -> None:
        """Broadcast ``tensors`` in place from the first rank of ``group``
        (data-parallel rank 0 of this tp rank, by default), in flat
        buckets."""
        import torch.distributed as dist

        self._check()
        ranks = self.ranks(group)
        if self._alone(group):
            return
        g = self._groups(group)[0]
        _bucketed(tensors, lambda flat: dist.broadcast(flat, src=ranks[0], group=g))

    def host_all_reduce(self, values: Sequence[float], op: str = "sum",
                        group: str = "world") -> List[float]:
        """All-reduce a few host numbers (float64) over ``group``'s CPU
        group."""
        import torch.distributed as dist

        self._check()
        t = torch.tensor(list(values), dtype=torch.float64)
        if self._alone(group):
            return t.tolist()
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, op=red, group=self._groups(group)[1])
        return t.tolist()

    def host_gather(self, values: Sequence[float], group: str = "world") -> List[List[float]]:
        """Every rank's ``values`` of ``group`` (the same count on each), in
        group order."""
        k, ranks = len(values), self.ranks(group)
        at = ranks.index(self.rank)
        rows = [0.0] * (len(ranks) * k)
        rows[at * k: (at + 1) * k] = [float(v) for v in values]
        flat = self.host_all_reduce(rows, "sum", group)
        return [flat[r * k: (r + 1) * k] for r in range(len(ranks))]

    def host_broadcast(self, value: float) -> float:
        """Rank 0's ``value`` on every rank."""
        import torch.distributed as dist

        self._check()
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.host_group)
        return float(t[0])

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any."""
        return self.host_all_reduce([1.0 if flag else 0.0], "max")[0] > 0

    def barrier(self) -> None:
        import torch.distributed as dist

        self._check()
        dist.barrier(group=self.host_group)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Consecutive runs of ``tensors`` of one dtype and device, each at most
    ``BUCKET_BYTES`` (a larger tensor is a bucket of its own)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def _bucketed(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective(flat)`` in place on each bucket of ``tensors``,
    flattened, and the result copied back (a contiguous tensor alone in its
    bucket is its own flat buffer)."""
    for bucket in _buckets(tensors):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            collective(bucket[0].view(-1))
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def _mesh_shape_str(mesh: Mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows a rank takes of a ``data``-sharded global batch; a batch that
    ``dp`` does not divide raises naming the batch, the mesh shape and the
    two nearest valid batch sizes."""
    n_data = mesh.shape["data"]
    if global_batch % n_data:
        lo = (global_batch // n_data) * n_data
        hi = lo + n_data
        nearest = f"{lo} or {hi}" if lo > 0 else str(hi)
        raise BatchShardingError(
            f"global batch {global_batch} is not divisible by the mesh's "
            f"data axis dp={n_data} (mesh {_mesh_shape_str(mesh)} over axes "
            f"{tuple(mesh.axis_names)}); nearest valid batch sizes: {nearest}"
        )
    return global_batch // n_data


def visible_devices(device=None) -> int:
    """What ``dp = -1`` resolves to for a run on ``device`` (None: the
    card): the world of a started rendezvous (torchrun's ``WORLD_SIZE``),
    else 1 on the CPU, else the cards on this host."""
    if os.environ.get("WORLD_SIZE"):
        return int(os.environ["WORLD_SIZE"])
    if torch.device("cuda" if device is None else device).type != "cuda":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def make_mesh(data: int = -1, model: int = 1, n_devices: Optional[int] = None) -> Mesh:
    """An unjoined (data, model) mesh; ``data = -1`` takes every device not
    claimed by ``model``."""
    n = visible_devices() if n_devices is None else n_devices
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = max(1, n // model)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    return Mesh(dp=data, tp=model)


def resolve_mesh(parallel, n_devices: Optional[int] = None) -> Optional[Mesh]:
    """``train.parallel.*`` -> an unjoined ``Mesh``, or None for the one-device
    path (``mesh = [1, 1]``, ``seq = 1``). ``dp = -1`` takes every visible
    device not claimed by ``tp``. Unlike the JAX package, more ranks than
    cards is allowed: ranks then share a card over gloo."""
    if parallel.is_single():
        return None
    dp, tp = parallel.mesh
    return make_mesh(data=dp, model=tp, n_devices=n_devices)


def choose_backend(device_type: str, local_world: int, n_cards: int):
    """(backend, why): ``nccl`` when every local rank has a card of its own,
    ``gloo`` when local ranks share a card or on the CPU."""
    if device_type != "cuda":
        return "gloo", "CPU ranks"
    if local_world <= n_cards:
        return "nccl", f"{local_world} local rank(s) on {n_cards} card(s), one card each"
    return "gloo", (f"{local_world} local ranks share {n_cards} card(s); NCCL refuses two "
                    "ranks on one device")


def rendezvous_env() -> Optional[Dict[str, str]]:
    """The rendezvous variables of this process, or None outside one."""
    if not os.environ.get("WORLD_SIZE"):
        return None
    return {k: os.environ[k] for k in ENV_KEYS if k in os.environ}


def init_distributed(device="cuda", dp: Optional[int] = None, tp: int = 1,
                     verbose: bool = True) -> Mesh:
    """Join the rendezvous of the environment; returns the joined Mesh of
    ``WORLD_SIZE / tp`` data-parallel by ``tp`` tensor-parallel ranks.
    ``device`` "cpu" runs the rank on the CPU; otherwise (None too) the rank takes
    ``cuda:{LOCAL_RANK % cards}`` and raises where there is no card.
    ``dp``, when given, times ``tp`` must equal ``WORLD_SIZE``."""
    import datetime

    import torch.distributed as dist

    env = rendezvous_env()
    if env is None:
        raise RuntimeError("no rendezvous in the environment (WORLD_SIZE is not set): "
                           "start the ranks with torchrun or the train command")
    world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    if world % tp or (dp is not None and dp * tp != world):
        raise ValueError(f"the mesh asks for dp={dp} x tp={tp} but the rendezvous has "
                         f"WORLD_SIZE={world}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device is available; pass "
                               "--device cpu to train on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    else:
        n_cards = 0
    backend, why = choose_backend(dev.type, local_world, n_cards)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    host_group = dist.new_group(backend="gloo") if backend == "nccl" else None
    dp = world // tp
    mesh = Mesh(dp=dp, tp=tp, rank=rank, local_rank=local_rank, device=dev,
                backend=backend, backend_reason=why, host_group=host_group,
                groups=_subgroups(rank, dp, tp, backend) if tp > 1 else {})
    if verbose and rank == 0:
        tensor = f" x tensor parallel over {tp}" if tp > 1 else ""
        print(f"[parallel] data parallel over {dp} rank(s){tensor}: backend {backend} ({why})",
              flush=True)
    return mesh


def regroup(mesh: Mesh, tp: int) -> Mesh:
    """The ranks of a joined mesh re-formed as ``world / tp`` data-parallel
    by ``tp`` tensor-parallel ranks: new ``dp`` and ``tp`` groups over the
    process group already started (every rank calls it, in one order)."""
    if mesh.world % tp:
        raise ValueError(f"{mesh.world} ranks do not divide into tp={tp}")
    dp = mesh.world // tp
    return dataclasses.replace(mesh, dp=dp, tp=tp, groups=_subgroups(
        mesh.rank, dp, tp, mesh.backend) if tp > 1 else {})


def _subgroups(rank: int, dp: int, tp: int, backend: str) -> Dict[str, tuple]:
    """This rank's "tp" and "dp" groups of a dp x tp mesh (every rank
    creates every group, in one order, as ``new_group`` requires)."""
    import torch.distributed as dist

    out = {}
    for kind, members in (("tp", [[d * tp + t for t in range(tp)] for d in range(dp)]),
                          ("dp", [[d * tp + t for d in range(dp)] for t in range(tp)])):
        for ranks in members:
            g = dist.new_group(ranks)
            host = dist.new_group(ranks, backend="gloo") if backend == "nccl" else g
            if rank in ranks:
                out[kind] = (g, host, ranks)
    return out


def check_replicas(digest: str, mesh: Optional[Mesh], what: str, group: str = "world") -> None:
    """Raise unless every rank of ``group`` has this rank's ``digest`` (a
    hex sha256 of its state): the first 48 bits of each, gathered over the
    host group."""
    if mesh is None or len(mesh.ranks(group)) == 1:
        return
    seen = [int(v[0]) for v in mesh.host_gather([float(int(digest[:12], 16))], group)]
    if len(set(seen)) != 1:
        raise RuntimeError(f"{what}: the ranks' states differ (digest prefixes "
                           f"{[f'{v:012x}' for v in seen]})")


def leave_group() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(arrays: Dict, mesh: Optional[Mesh]) -> Dict:
    """This rank's rows of every array of a global batch (numpy arrays or
    tensors, batch-leading); the padded lengths stay the global batch's."""
    if mesh is None or mesh.dp == 1:
        return arrays
    rows = mesh.rows(next(iter(arrays.values())).shape[0])
    return {k: v[rows] for k, v in arrays.items()}


class SeqMesh:
    """The ranks of a sequence axis (JAX counterpart: ``make_seq_mesh``'s
    1-D ``("seq",)`` mesh): ``n`` ranks, this one ``rank``, joined in the
    gloo ``group``; ``device`` is where this rank computes. The ring's
    collectives stage through host memory (module docstring) and add their
    host wall seconds and calls to ``stats``."""

    def __init__(self, n: int, rank: int, group, device=None,
                 timeout_s: float = RING_TIMEOUT_S):
        self.n, self.rank, self.group = n, rank, group
        self.device = torch.device("cpu" if device is None else device)
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.stats = {"rotate_s": 0.0, "rotations": 0, "gather_s": 0.0, "gathers": 0,
                      "bytes_sent": 0}

    def ranks(self, group: str = "seq") -> List[int]:
        return list(range(self.n))

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` (pinned when ``t`` is on the card)."""
        if t.device.type == "cpu":
            return t.detach().contiguous().clone()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t.detach())
        return buf

    def _empty_host(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda")

    def _wait(self, works) -> None:
        for w in works:
            w.wait(self.timeout)

    def rotate(self, tensors: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        """JAX's ``ppermute(x, "seq", [(i, (i + 1) % n)])`` on each tensor
        (None passes): this rank's tensors go to the next rank, and the
        previous rank's come back, on this rank's device."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        nxt, prv = (self.rank + 1) % self.n, (self.rank - 1) % self.n
        out: List[Optional[torch.Tensor]] = []
        with record_function("seq.rotate"):
            works, pairs = [], []
            for tag, t in enumerate(tensors):
                if t is None:
                    pairs.append(None)
                    continue
                send, recv = self._host(t), self._empty_host(t)
                works.append(self.group.send([send], nxt, tag))
                works.append(self.group.recv([recv], prv, tag))
                pairs.append((send, recv, t.device))
                self.stats["bytes_sent"] += send.numel() * send.element_size()
            self._wait(works)
            for pair in pairs:
                out.append(None if pair is None else
                           pair[1].to(pair[2], non_blocking=pair[2].type == "cuda"))
        self.stats["rotate_s"] += time.perf_counter() - t0
        self.stats["rotations"] += 1
        return out

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block along
        ``dim``, on every rank: ``n - 1`` rotations of the block, each
        received block written at its rank's place."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function("seq.gather"):
            shape = list(t.shape)
            m = shape[dim]
            shape[dim] = m * self.n
            whole = torch.empty(shape, dtype=t.dtype, device=t.device)
            whole.narrow(dim, self.rank * m, m).copy_(t)
            block = t
            for s in range(1, self.n):
                block = self.rotate([block])[0]
                whole.narrow(dim, ((self.rank - s) % self.n) * m, m).copy_(block)
        self.stats["gather_s"] += time.perf_counter() - t0
        self.stats["gathers"] += 1
        return whole

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values of ``tensors`` on every rank, in place."""
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        for t in tensors:
            host = self._host(t)
            self._wait([self.group.broadcast([host], opts)])
            if self.rank:
                t.copy_(host)

    def host_gather(self, values: Sequence[float], group: str = "seq") -> List[List[float]]:
        """Every rank's ``values`` (the same count on each), in rank order."""
        k = len(values)
        rows = torch.zeros(self.n * k, dtype=torch.float64)
        rows[self.rank * k: (self.rank + 1) * k] = torch.tensor([float(v) for v in values],
                                                                dtype=torch.float64)
        self._wait([self.group.allreduce([rows])])
        flat = rows.tolist()
        return [flat[r * k: (r + 1) * k] for r in range(self.n)]


def make_seq_mesh(seq: int, store, rank: int = 0, device=None,
                  timeout_s: float = RING_TIMEOUT_S) -> SeqMesh:
    """Join the ``seq``-rank sequence group of ``store`` (a
    ``torch.distributed`` store every rank reaches: a ``TCPStore`` across
    processes, a ``HashStore`` across threads) as ``rank``, over
    127.0.0.1; every rank calls it, and it returns once all have."""
    import torch.distributed as dist

    if seq < 2:
        raise ValueError(f"a sequence mesh needs seq >= 2, got {seq}")
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    group = dist.ProcessGroupGloo(dist.PrefixStore("seq", store), rank, seq, opts)
    return SeqMesh(seq, rank, group, device, timeout_s)
