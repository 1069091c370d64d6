"""Deterministic fault injection (a copy of the JAX package's
``speakingstyle_tpu/faults.py``: the same grammar and kinds, so a spec one
package takes the other takes too).

Every recovery path is exercised end-to-end by injecting the fault it
guards against at an exact, named point. In the port, the training kinds
and the checkpoint kinds fire (training/trainer.py, data/dataset.py,
training/checkpoint.py); the serving kinds parse, for the serving planes
still to be ported.  The ``SPEAKINGSTYLE_FAULTS`` environment variable
holds a spec like

    loader_ioerror@7;nan_grads@12;sigterm@20
    replica_raise@40;style_encode_error@2

meaning each named site's counter tripping the named value fires the
fault once.  Each entry fires exactly once — a retried load, a replayed
step after rollback, or a requeued request does NOT re-trip the same
entry, which is what makes recovery observable.  Duplicate entries are
allowed (``nan_grads@3;nan_grads@3`` poisons the replay too — how the
consecutive-rollback abort is tested).

Counter semantics per kind:

  training (consumed via training/faults.py, which re-exports this plan):

  ``loader_ioerror@N``  Nth call of ``SpeechDataset._feature`` (1-based,
                        counted per dataset instance)
  ``nan_grads@N``       the batch consumed by the train step whose
                        post-increment step counter is N
  ``sigterm@N``         delivered after step N completes

  serving (serving/resilience.py; the chaos drills):

  ``replica_raise@N``       the fleet router's Nth coalesced dispatch
                            (router-global, 1-based) raises InjectedFault
                            before touching the replica engine
  ``replica_hang@N``        same counter; the dispatch stalls past the
                            hang watchdog instead of raising
  ``style_encode_error@N``  the StyleService's Nth reference-encoder
                            dispatch attempt raises before device work
  ``vocoder_raise@N``       the engine's Nth ``vocode_window`` call
                            (per engine instance) raises — a streaming
                            continuation fault
  ``longform_ring_error@N`` the LongformService's Nth ring-tier
                            synthesis attempt (per service instance,
                            1-based) raises InjectedFault before device
                            work — drives the tier-b→tier-a
                            (ring→chunked) degradation drill
  ``replica_proc_kill@N``   the fleet router's Nth coalesced dispatch
                            (the replica_raise counter) SIGKILLs the
                            target replica's *process* before the wire
                            call — the cluster tier's hard-death drill
                            (in-process routers treat it as a raise)
  ``net_partition@N``       same counter; the router↔replica link for
                            the target replica drops every packet from
                            here on (dispatches fail fast, heartbeats
                            stop renewing the lease) until the drill
                            heals it — the partition-grade chaos drill
  ``tier_poison@N``         same counter; the Nth coalesced dispatch
                            poisons the target replica engine's param
                            tree host-side (same shapes/dtypes — zero
                            compiles, no errors) so it keeps serving
                            GARBAGE audio — the quality-plane
                            degradation drill: only the validators
                            (obs/quality.py) and the golden probes
                            (serving/probes.py) can see it

  checkpoint (training/checkpoint.py; the lifecycle drills):

  ``checkpoint_corrupt@N``  the CheckpointManager's Nth restore
                            verification (per manager instance, 1-based)
                            reports the step corrupt — raises
                            CheckpointCorruptError before materializing
  ``manifest_missing@N``    same counter; the Nth verification behaves
                            as if the step's manifest.json were absent
                            (legacy-tolerant unless restoring strictly)

The plan is plain Python state constructed per run (``FaultPlan.from_env``)
and threaded explicitly into the sites — no module globals, so tests can
run many faulted loops in one process.  ``fire`` is thread-safe (serving
sites race from replica workers) and ``arm`` appends entries to a live
plan.
"""

import dataclasses
import os
from typing import List, Sequence, Tuple
from speakingstyle_torch.obs.locks import make_lock

ENV_VAR = "SPEAKINGSTYLE_FAULTS"

TRAINING_KINDS = ("loader_ioerror", "nan_grads", "sigterm")
SERVING_KINDS = (
    "replica_raise", "replica_hang", "style_encode_error", "vocoder_raise",
    "longform_ring_error", "replica_proc_kill", "net_partition",
    "tier_poison",
)
CHECKPOINT_KINDS = ("checkpoint_corrupt", "manifest_missing")
KINDS = TRAINING_KINDS + SERVING_KINDS + CHECKPOINT_KINDS


@dataclasses.dataclass
class _Fault:
    kind: str
    at: int
    fired: bool = False


class FaultPlan:
    """A parsed fault spec; each entry fires at most once."""

    def __init__(self, faults: Sequence[_Fault] = ()):
        self._faults: List[_Fault] = list(faults)
        self._lock = make_lock("FaultPlan._lock")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, sep, at = part.partition("@")
            kind = kind.strip()
            if not sep or kind not in KINDS:
                raise ValueError(
                    f"bad fault spec entry {part!r}: expected <kind>@<step> "
                    f"with kind in {KINDS}"
                )
            try:
                step = int(at)
            except ValueError:
                raise ValueError(
                    f"bad fault spec entry {part!r}: step {at!r} is not an int"
                ) from None
            faults.append(_Fault(kind, step))
        return cls(faults)

    @classmethod
    def from_env(cls) -> "FaultPlan":
        return cls.parse(os.environ.get(ENV_VAR, ""))

    def __bool__(self) -> bool:
        return bool(self._faults)

    def arm(self, kind: str, at: int) -> None:
        """Append one entry to a live plan (at a counter value that has
        not happened yet)."""
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; kinds: {KINDS}")
        with self._lock:
            self._faults.append(_Fault(kind, int(at)))

    def fire(self, kind: str, at: int) -> bool:
        """True exactly once per matching entry when the site's counter
        hits the named value; False forever after."""
        with self._lock:
            for f in self._faults:
                if f.kind == kind and f.at == at and not f.fired:
                    f.fired = True
                    return True
        return False

    def pending(self) -> List[Tuple[str, int]]:
        with self._lock:
            return [(f.kind, f.at) for f in self._faults if not f.fired]


def dp_poison_rows(batch_rows: int, dp: int) -> int:
    """The ``nan_grads``-under-DP drill: how many leading batch rows to
    poison so the NaN lands on exactly ONE data-parallel shard.

    A ``data``-sharded batch of ``batch_rows`` rows over a ``dp``-way mesh
    gives each shard ``batch_rows // dp`` contiguous rows; poisoning just
    the first shard's slice makes the drill adversarial — the sentinel's
    ``_finite`` flag is only safe if its dp-axis all-reduce makes every
    device (and every host) see the one bad shard.  Returns the full batch
    when it cannot be split (dp <= 1 or fewer rows than shards): the
    single-chip drill poisons everything, as before.

    Pure host arithmetic; ``training/faults.py::poison_batch`` applies it.
    """
    if dp <= 1 or batch_rows < dp:
        return batch_rows
    return batch_rows // dp
