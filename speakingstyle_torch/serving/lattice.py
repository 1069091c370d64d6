"""The shape-bucket lattice (copied from speakingstyle_tpu/serving/lattice.py).

Every dispatch runs at a ``(batch, L_src, T_mel)`` drawn from a small cross
product of per-axis buckets, each prepared ahead of time (a captured CUDA
graph per point on the card, parallel/registry.py); references ride their
own ``(batch, ref_len)`` grid. Because each lattice is a full cross
product, the elementwise-smallest covering point exists and is unique:
``cover`` rounds each axis up independently. The precision axis
(``serve.tiers.precisions``) multiplies the programs a ready engine holds,
not the geometry.
"""

import bisect
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from speakingstyle_torch.configs.config import ServeConfig


class RequestTooLarge(ValueError):
    """A request exceeds the lattice's largest bucket on some axis."""


@dataclass(frozen=True, order=True)
class Bucket:
    """One lattice point: the padded dispatch shape."""

    b: int       # batch rows
    l_src: int   # padded phoneme-sequence length
    t_mel: int   # padded mel length: the free-run output buffer

    @property
    def volume(self) -> int:
        return self.b * self.l_src * self.t_mel


def _cover_axis(values: Sequence[int], n: int, axis: str) -> int:
    """Smallest bucket >= n on one (ascending) axis."""
    i = bisect.bisect_left(values, n)
    if i == len(values):
        raise RequestTooLarge(
            f"{axis}={n} exceeds the largest serve bucket {values[-1]}; "
            f"enlarge serve.{axis}_buckets or reject the request upstream"
        )
    return values[i]


def _check(name: str, vals: Sequence[int]) -> None:
    if not vals or sorted(vals) != list(vals) or min(vals) <= 0:
        raise ValueError(f"{name} buckets must be non-empty ascending positive, got {list(vals)}")


class BucketLattice:
    """The cross product of batch/src/mel buckets, plus covering lookup."""

    def __init__(self, batch_buckets: Sequence[int], src_buckets: Sequence[int],
                 mel_buckets: Sequence[int], precisions: Sequence[str] = ("f32",)):
        from speakingstyle_torch.parallel.registry import PRECISIONS

        for name, vals in (("batch", batch_buckets), ("src", src_buckets),
                           ("mel", mel_buckets)):
            _check(name, vals)
        if not precisions or any(p not in PRECISIONS for p in precisions) \
                or len(set(precisions)) != len(precisions):
            raise ValueError(
                f"precisions must be a non-empty unique subset of {PRECISIONS}, "
                f"got {list(precisions)}"
            )
        self.batch_buckets = list(batch_buckets)
        self.src_buckets = list(src_buckets)
        self.mel_buckets = list(mel_buckets)
        self.precisions = list(precisions)

    @classmethod
    def from_config(cls, serve: ServeConfig) -> "BucketLattice":
        precisions = tuple(serve.tiers.precisions) if serve.tiers.enabled else ("f32",)
        return cls(serve.batch_buckets, serve.src_buckets, serve.mel_buckets,
                   precisions=precisions)

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @property
    def max_src(self) -> int:
        return self.src_buckets[-1]

    @property
    def max_mel(self) -> int:
        return self.mel_buckets[-1]

    def points(self) -> List[Bucket]:
        """All geometry points, smallest volume first (the cheap points are
        prepared first, so a failing start-up fails fast)."""
        pts = [Bucket(b, l, t) for b in self.batch_buckets for l in self.src_buckets
               for t in self.mel_buckets]
        return sorted(pts, key=lambda p: (p.volume, p))

    def __len__(self) -> int:
        return self.geometry_count() * len(self.precisions)

    def geometry_count(self) -> int:
        """Shape points only (``len(points())``); ``len(self)`` is this
        times the precision axis's length."""
        return len(self.batch_buckets) * len(self.src_buckets) * len(self.mel_buckets)

    def cover(self, n: int, l_src: int, t_mel: int) -> Bucket:
        """The unique elementwise-smallest point covering the request
        geometry; raises RequestTooLarge when some axis cannot cover."""
        return Bucket(
            _cover_axis(self.batch_buckets, n, "batch"),
            _cover_axis(self.src_buckets, l_src, "src"),
            _cover_axis(self.mel_buckets, t_mel, "mel"),
        )

    def cover_window(self, t_mel: int) -> Tuple[int, int]:
        """The ``(batch, T_mel)`` vocoder-program key covering one
        single-row mel window: the streaming path rides these prepared
        pairs, never ad-hoc shapes."""
        return (_cover_axis(self.batch_buckets, 1, "batch"),
                _cover_axis(self.mel_buckets, t_mel, "mel"))


class StyleLattice:
    """The style encoder's ``(batch, ref_len)`` bucket grid."""

    def __init__(self, batch_buckets: Sequence[int], ref_buckets: Sequence[int]):
        _check("style batch", batch_buckets)
        _check("style ref", ref_buckets)
        self.batch_buckets = list(batch_buckets)
        self.ref_buckets = list(ref_buckets)

    @classmethod
    def from_config(cls, serve: ServeConfig) -> "StyleLattice":
        """``serve.style.batch_buckets`` empty means the serve batch
        buckets: a dispatch's fresh references then encode in one pass."""
        return cls(serve.style.batch_buckets or serve.batch_buckets, serve.style.ref_buckets)

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @property
    def max_ref(self) -> int:
        return self.ref_buckets[-1]

    def points(self) -> List[Tuple[int, int]]:
        """All ``(batch, ref_len)`` points, smallest volume first."""
        pts = [(b, r) for b in self.batch_buckets for r in self.ref_buckets]
        return sorted(pts, key=lambda p: (p[0] * p[1], p))

    def __len__(self) -> int:
        return len(self.batch_buckets) * len(self.ref_buckets)

    def cover(self, n: int, ref_len: int) -> Tuple[int, int]:
        return (
            _cover_axis(self.batch_buckets, n, "style.batch"),
            _cover_axis(self.ref_buckets, ref_len, "style.ref"),
        )
