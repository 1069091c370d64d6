"""Rotating JSONL event log: the structured record of a run (a copy of the
JAX package's ``speakingstyle_tpu/obs/events.py``; plain Python, no torch).
Same schema, so one reader parses both packages' ``events.jsonl``.

One line per event, append-only, size-rotated — greppable next to
``log.txt`` and machine-readable without it. The stable schema every
consumer can rely on:

  * every record carries ``ts`` (unix seconds, float — a *timestamp*;
    durations inside records are always measured with the monotonic
    clock and named ``*_s``) and ``event`` (the record type);
  * training emits (trainer.py): ``train_start`` (one per run: step,
    total_step + the runtime identity: torch and CUDA versions, device
    name, device_count), ``train_step`` (step, per-loss fields,
    ``lr``, ``step_time_s``, ``data_wait_s``, ``steps_per_sec``,
    ``mel_frames_per_sec``), ``val`` (step + per-loss fields),
    ``checkpoint_save`` (step), ``rollback`` (step, ``rollback_n``,
    ``restore_step``), ``fault_fire`` (kind, step), ``preempt_flush``
    (signal, step), ``quarantine`` (sample ids), ``note`` (msg),
    ``ckpt_corrupt_skipped`` (step, reason, error; training/checkpoint.py),
    and in the port ``train_end`` (step, the registry's ``counters``, the
    run's ``kernel_launches`` per hand-written kernel).

Rotation: when ``events.jsonl`` would exceed ``max_bytes`` the file
shifts to ``events.jsonl.1`` (older files shift up, ``keep`` retained),
so a long run's telemetry is bounded. ``read_events`` yields parsed
records oldest-first across the rotated set, skipping malformed lines
(a run killed mid-write leaves at most one).
"""

import json
import os
import threading
import time
from typing import Dict, Iterator, Optional


def _jsonable(obj):
    """Last-resort JSON coercion: numpy scalars/arrays and other
    non-JSON types (torch tensors too) become Python floats/lists/strings."""
    for attr in ("tolist", "item"):  # tolist covers arrays AND np scalars
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except (TypeError, ValueError):
                continue
    return str(obj)


class JsonlEventLog:
    """Thread-safe append-only JSONL writer with size rotation."""

    def __init__(
        self,
        log_dir: str,
        name: str = "events.jsonl",
        max_bytes: int = 8_000_000,
        keep: int = 3,
    ):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, name)
        self.max_bytes = max_bytes
        self.keep = keep
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, event: str, **fields) -> Dict:
        """Append one record; returns the dict that was written."""
        record = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(record, default=_jsonable) + "\n"
        with self._lock:
            if self._fh.tell() + len(line) > self.max_bytes:
                self._rotate()
            self._fh.write(line)
            self._fh.flush()
        return record

    def _rotate(self) -> None:
        # caller holds the lock
        self._fh.close()
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "JsonlEventLog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def read_events(
    path: str, event: Optional[str] = None, rotated: bool = True
) -> Iterator[Dict]:
    """Parse an event log oldest-first; ``path`` is the live file (or a
    directory containing ``events.jsonl``). ``event`` filters by type;
    ``rotated`` includes the ``.N`` rotated files before the live one."""
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    files = []
    if rotated:
        i = 1
        while os.path.exists(f"{path}.{i}"):
            files.append(f"{path}.{i}")
            i += 1
        files.reverse()  # .2 is older than .1
    if os.path.exists(path):
        files.append(path)
    for f in files:
        with open(f, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail from a killed writer
                if event is None or rec.get("event") == event:
                    yield rec
