"""Inverted dropout with the three mask impls of ``ModelConfig.dropout_impl``
(JAX counterpart: speakingstyle_tpu/ops/dropout.py).

The math is the JAX package's: ``where(keep, x / (1 - rate), 0)`` with
P(keep) = 1 - rate, and ``rate >= 1`` drops everything exactly. Only the
mask's bits differ by impl:

* ``"hash"``: the murmur3 finalizer ``fmix32`` of the flat element index,
  salted per call; bit for bit the JAX package's mask given the same salt
  (32-bit arithmetic carried in int64 and masked to 32 bits). The salt is
  drawn from a CPU ``torch.Generator``, so drawing one never waits on the
  card.
* ``"bits16"``: 16 random bits per element against an integer threshold;
* ``"bernoulli"``: uniform floats against 1 - rate.

The last two draw from a ``torch.Generator`` on the tensor's device and
cannot give JAX's bits: their tests compare statistics.

Data parallelism (``parallel/mesh.py``): a rank holds rows ``[r b, (r + 1)
b)`` of the global batch (r its data-parallel rank: the tensor-parallel
ranks of a group share r, so they draw the same bits), and its
``DropoutRNG`` carries ``row_offset = r b``. The hash mask of a batch-leading tensor then hashes the flat index of
the GLOBAL layout (``offset + arange(n)``, offset = ``row_offset`` times the
elements of a row), so rank r's mask is those rows of the one-process mask
bit for bit, as the JAX package's GSPMD step hashes the global shape; the
salts are the same on every rank (one CPU generator seeded alike). The
random-bit impls draw per rank from a device generator seeded by (seed,
rank).
"""

from typing import Optional

import torch

DROPOUT_IMPLS = ("bernoulli", "bits16", "hash")
_M32 = 0xFFFFFFFF


class DropoutRNG:
    """Where a training step's dropout masks come from: a CPU generator for
    the hash salts, seeded from ``seed``, and one on ``device`` for the
    random bits, seeded from (``seed``, ``rank``). ``row_offset``: the
    global batch row of this rank's first row (0 without data
    parallelism)."""

    def __init__(self, seed: int, device=None, rank: int = 0, row_offset: int = 0):
        device = torch.device("cpu" if device is None else device)
        self.row_offset = row_offset
        self.cpu = torch.Generator().manual_seed(seed)
        dseed = seed if rank == 0 else (seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)
        self.device = torch.Generator(device=device).manual_seed(dseed)

    def salt(self) -> int:
        """A fresh uint32 salt, drawn on the host."""
        return int(torch.randint(0, 1 << 32, (1,), generator=self.cpu, dtype=torch.int64)[0])


class ReplayRNG:
    """The dropout draws of one region that runs twice: a block under
    activation checkpointing, whose backward recomputes its forward. The
    first run draws from ``rng`` (so the step's stream advances exactly as
    without checkpointing) and records each hash salt; every later run
    (``start()`` marks one) replays those salts in order and draws its
    random bits from a generator restarted at the state ``rng.device`` had
    before the first run. The recompute thus sees the masks the forward
    used, as JAX's functional keys give under ``nn.remat``;
    ``torch.utils.checkpoint`` restores only the default generators."""

    def __init__(self, rng: DropoutRNG):
        self.rng = rng
        self.salts: list = []
        self.device = getattr(rng, "device", None)  # a stand-in may give salts only
        self.row_offset = getattr(rng, "row_offset", 0)
        self.device_state = None if self.device is None else self.device.get_state()
        self.runs = self.pos = 0

    def start(self) -> "ReplayRNG":
        self.runs += 1
        self.pos = 0
        if self.runs > 1 and self.device_state is not None:
            self.device = torch.Generator(device=self.rng.device.device)
            self.device.set_state(self.device_state)
        return self

    def salt(self) -> int:
        if self.runs == 1:
            self.salts.append(self.rng.salt())
            return self.salts[-1]
        self.pos += 1
        return self.salts[self.pos - 1]


def _mul32(h, c: int):
    """(h * c) mod 2^32 for 0 <= h < 2^32, without overflowing int64."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """murmur3 32-bit finalizer (``ops/dropout.py:40-47`` of the JAX package)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_mask(rate: float, shape, impl: str = "bernoulli",
              rng: Optional[DropoutRNG] = None, device=None,
              salt: Optional[int] = None, row_offset: int = 0):
    """Boolean keep mask with P(True) = 1 - rate. ``"hash"`` takes ``salt``
    or draws one from ``rng``, and hashes the flat index of rows
    ``[row_offset, row_offset + shape[0])`` of the global batch; the other
    impls draw bits from ``rng.device``."""
    if impl not in DROPOUT_IMPLS:
        raise ValueError(f"dropout impl must be one of {DROPOUT_IMPLS}, got {impl!r}")
    shape = tuple(shape)
    if rate >= 1.0:
        # drop everything, exactly: the thresholds below clamp and would
        # keep a 2^-16 / 2^-32 sliver
        return torch.zeros(shape, dtype=torch.bool, device=device)
    n = 1
    for d in shape:
        n *= d
    if impl == "hash":
        if salt is None:
            salt = rng.salt()
        offset = row_offset * (n // shape[0]) if shape and shape[0] else 0
        idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
        bits = _fmix32(_mul32(idx, 0x9E3779B9) ^ (salt & _M32))
        return (bits >= min(_M32, int(round(rate * 2 ** 32)))).reshape(shape)
    gen = rng.device
    if impl == "bits16":
        thresh = min(0xFFFF, int(round(rate * 65536)))
        bits = torch.randint(0, 1 << 16, shape, generator=gen, device=device, dtype=torch.int32)
        return bits >= thresh
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout(x, rate: float, rng: Optional[DropoutRNG], impl: str = "bernoulli"):
    """Inverted dropout: zero with probability ``rate``, survivors scaled by
    1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if rng is None:
        raise ValueError("dropout with rate > 0 needs a DropoutRNG")
    mask = keep_mask(rate, x.shape, impl, rng, x.device,
                     row_offset=getattr(rng, "row_offset", 0))
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def maybe_dropout(x, rate: float, deterministic: bool, rng: Optional[DropoutRNG],
                  impl: str):
    """Flax ``Dropout(rate)(x, deterministic=...)``: the identity when
    deterministic."""
    if deterministic or rate == 0.0:
        return x
    return dropout(x, rate, rng, impl)
