"""Data-parallel rank processes (JAX counterpart:
speakingstyle_tpu/parallel/mesh.py).

The JAX package drives every device of a ``Mesh`` from one process and lets
GSPMD insert the collectives. The port runs one process a rank, each with
its own CUDA context, joined in a ``torch.distributed`` process group: the
``Mesh`` here is that group's description (``dp`` ranks on the ``data``
axis; ``tp``, the ``model`` axis, is 1 until ROADMAP.md queue A item 6b).
The state is replicated and the global batch is split by rows over the
ranks, which is the JAX package's pure-DP layout (``P("data")`` for the
batch, ``P()`` for the state).

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
  over a CPU gloo group (the world itself under gloo).
"""

import os
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


class BatchShardingError(ValueError):
    """Global batch size incompatible with the mesh's ``data`` axis.

    Raised at startup, before any worker starts or any tensor moves, so a
    bad ``train.optimizer.batch_size`` / data-parallel pairing fails with
    the fix in the message."""


@dataclass
class Mesh:
    """A data-parallel process group as the trainers see it: ``dp`` ranks,
    this process's ``rank`` and ``local_rank``, its ``device`` and the
    group's ``backend``. An unjoined mesh (``make_mesh``,
    ``resolve_mesh``) only describes the shape; ``init_distributed``
    returns a joined one."""

    dp: int = 1
    tp: int = 1
    rank: int = 0
    local_rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: Optional[str] = None
    backend_reason: str = ""
    host_group: object = None  # the CPU gloo group (None: the world, under gloo)

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

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of ``global_batch`` rows."""
        b = local_batch_size(global_batch, self)
        return slice(self.rank * b, (self.rank + 1) * b)

    # -- collectives --------------------------------------------------------

    def _check(self) -> None:
        if not self.joined:
            raise RuntimeError("the mesh has no process group: call init_distributed()")

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum ``tensors`` over the ranks in place, in flat buckets (one
        collective a bucket), inside a ``dp.all_reduce`` profiler range."""
        import torch.distributed as dist
        from torch.profiler import record_function

        self._check()
        with record_function("dp.all_reduce"):
            _bucketed(tensors, dist.all_reduce)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Broadcast ``tensors`` from rank 0 in place, in flat buckets."""
        import torch.distributed as dist

        self._check()
        _bucketed(tensors, lambda flat: dist.broadcast(flat, src=0))

    def host_all_reduce(self, values: Sequence[float], op: str = "sum") -> List[float]:
        """All-reduce a few host numbers (float64) over the CPU group."""
        import torch.distributed as dist

        self._check()
        t = torch.tensor(list(values), dtype=torch.float64)
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, op=red, group=self.host_group)
        return t.tolist()

    def host_gather(self, values: Sequence[float]) -> List[List[float]]:
        """Every rank's ``values`` (the same count on each), by rank."""
        k = len(values)
        rows = [0.0] * (self.dp * k)
        rows[self.rank * k: (self.rank + 1) * k] = [float(v) for v in values]
        flat = self.host_all_reduce(rows, "sum")
        return [flat[r * k: (r + 1) * k] for r in range(self.dp)]

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
    flattened, and the result copied back."""
    for bucket in _buckets(tensors):
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


def init_distributed(device="cuda", dp: Optional[int] = None, verbose: bool = True) -> Mesh:
    """Join the rendezvous of the environment; returns the joined Mesh.
    ``device`` "cpu" runs the rank on the CPU; otherwise (None too) the rank takes
    ``cuda:{LOCAL_RANK % cards}`` and raises where there is no card.
    ``dp``, when given, must equal ``WORLD_SIZE``."""
    import datetime

    import torch.distributed as dist

    env = rendezvous_env()
    if env is None:
        raise RuntimeError("no rendezvous in the environment (WORLD_SIZE is not set): "
                           "start the ranks with torchrun or the train command")
    world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    if dp is not None and dp != world:
        raise ValueError(f"the mesh asks for dp={dp} but the rendezvous has "
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
    mesh = Mesh(dp=world, tp=1, rank=rank, local_rank=local_rank, device=dev,
                backend=backend, backend_reason=why, host_group=host_group)
    if verbose and rank == 0:
        print(f"[parallel] data parallel over {world} rank(s): backend {backend} ({why})",
              flush=True)
    return mesh


def check_replicas(digest: str, mesh: Optional[Mesh], what: str) -> None:
    """Raise unless every rank's ``digest`` (a hex sha256 of its state)
    equals this rank's: the first 48 bits of each, gathered over the host
    group."""
    if mesh is None or mesh.dp == 1:
        return
    seen = [int(v[0]) for v in mesh.host_gather([float(int(digest[:12], 16))])]
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
