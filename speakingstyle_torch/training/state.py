"""Train state: the step counter, the model (parameters and the postnet's
BatchNorm statistics) and the optimizer's moments as one object (JAX
counterpart: speakingstyle_tpu/training/state.py, a pytree there).

The optimizer updates the model's parameters in place; ``state_dict`` is
what a checkpoint stores and ``load_state_dict`` what a restore fills.
Under tensor parallelism (``layout``, ``parallel/partition.py``) the model
and the moments hold this rank's shards: ``state_dict`` is the local
state, and ``load_state_dict`` takes a WHOLE state (a checkpoint's, a
fresh init's) and keeps this rank's shards of it.
"""

from dataclasses import dataclass
from typing import Dict, Optional

from torch import nn

from speakingstyle_torch.training.optim import Optimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    layout: Optional[object] = None  # parallel.partition.TPLayout

    def local(self, state: Dict) -> Dict:
        """A whole state dict cut to this rank's shards (as it is without
        a layout)."""
        return state if self.layout is None else self.layout.local_state(state)

    def state_dict(self, copy: bool = True) -> Dict:
        """``copy=False``: the live tensors (the model's state dict holds
        them anyway; the optimizer's moments are cloned only with copy)."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(copy)}

    def load_state_dict(self, state: Dict) -> None:
        state = self.local(state)
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
