"""Training-side fault injection (JAX counterpart:
speakingstyle_tpu/training/faults.py).

Re-exports the ``FaultPlan`` core of ``speakingstyle_torch/faults.py`` (the
spec grammar and the counter semantics of every kind) and keeps the two
faults whose implementation is training-specific: NaN batch poisoning and
real SIGTERM delivery.
"""

import os
import signal

from speakingstyle_torch.faults import (  # noqa: F401  (re-export)
    CHECKPOINT_KINDS,
    ENV_VAR,
    KINDS,
    SERVING_KINDS,
    TRAINING_KINDS,
    FaultPlan,
    dp_poison_rows,
)


def poison_batch(arrays: dict, dp: int = 1, rank=None) -> dict:
    """NaN-poison a training batch (the ``nan_grads`` fault): multiplying
    the mel targets by NaN drives every loss and every gradient non-finite
    through the real loss and gradient path, as a diverged model or a
    corrupt feature file would. The input dict and its tensors are left
    as they are. ``dp`` > 1 poisons only the first data shard's rows
    (``dp_poison_rows``) of a global batch, for a data-parallel drill.
    ``rank`` (not None): ``arrays`` are that data-parallel rank's rows, the
    shard the drill poisons on rank 0 and leaves alone elsewhere."""
    if rank is not None and rank != 0:
        return arrays
    out = dict(arrays)
    mels = out["mels"]
    rows = dp_poison_rows(mels.shape[0], dp)
    poisoned = mels.clone()
    poisoned[:rows] *= float("nan")
    out["mels"] = poisoned
    return out


def deliver_sigterm():
    """Deliver a real SIGTERM to this process (the ``sigterm`` fault), so
    the installed handler itself, not a shortcut, is exercised."""
    os.kill(os.getpid(), signal.SIGTERM)
