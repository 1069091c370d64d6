"""The shape-bucket lattice (copied from speakingstyle_tpu/serving/lattice.py,
without the precision axis, which the port has not taken over).

Every dispatch runs at a ``(batch, L_src, T_mel)`` drawn from a small cross
product of per-axis buckets; references ride their own ``(batch, ref_len)``
grid. Because each lattice is a full cross product, the elementwise-smallest
covering point exists and is unique: ``cover`` rounds each axis up
independently.
"""

import bisect
from dataclasses import dataclass
from typing import Sequence, Tuple

from speakingstyle_torch.configs.config import ServeConfig


class RequestTooLarge(ValueError):
    """A request exceeds the lattice's largest bucket on some axis."""


@dataclass(frozen=True, order=True)
class Bucket:
    """One lattice point: the padded dispatch shape."""

    b: int       # batch rows
    l_src: int   # padded phoneme-sequence length
    t_mel: int   # padded mel length: the free-run output buffer


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
                 mel_buckets: Sequence[int]):
        for name, vals in (("batch", batch_buckets), ("src", src_buckets),
                           ("mel", mel_buckets)):
            _check(name, vals)
        self.batch_buckets = list(batch_buckets)
        self.src_buckets = list(src_buckets)
        self.mel_buckets = list(mel_buckets)

    @classmethod
    def from_config(cls, serve: ServeConfig) -> "BucketLattice":
        return cls(serve.batch_buckets, serve.src_buckets, serve.mel_buckets)

    @property
    def max_src(self) -> int:
        return self.src_buckets[-1]

    @property
    def max_mel(self) -> int:
        return self.mel_buckets[-1]

    def cover(self, n: int, l_src: int, t_mel: int) -> Bucket:
        """The unique elementwise-smallest point covering the request
        geometry; raises RequestTooLarge when some axis cannot cover."""
        return Bucket(
            _cover_axis(self.batch_buckets, n, "batch"),
            _cover_axis(self.src_buckets, l_src, "src"),
            _cover_axis(self.mel_buckets, t_mel, "mel"),
        )


class StyleLattice:
    """The style encoder's ``(batch, ref_len)`` bucket grid."""

    def __init__(self, batch_buckets: Sequence[int], ref_buckets: Sequence[int]):
        _check("style batch", batch_buckets)
        _check("style ref", ref_buckets)
        self.batch_buckets = list(batch_buckets)
        self.ref_buckets = list(ref_buckets)

    @classmethod
    def from_config(cls, serve: ServeConfig) -> "StyleLattice":
        return cls(serve.batch_buckets, serve.style.ref_buckets)

    @property
    def max_ref(self) -> int:
        return self.ref_buckets[-1]

    def cover(self, n: int, ref_len: int) -> Tuple[int, int]:
        return (
            _cover_axis(self.batch_buckets, n, "style.batch"),
            _cover_axis(self.ref_buckets, ref_len, "style.ref"),
        )
