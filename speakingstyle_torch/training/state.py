"""Train state: the step counter, the model (parameters and the postnet's
BatchNorm statistics) and the optimizer's moments as one object (JAX
counterpart: speakingstyle_tpu/training/state.py, a pytree there).

The optimizer updates the model's parameters in place; ``state_dict`` is
what a checkpoint stores and ``load_state_dict`` what a restore fills.
"""

from dataclasses import dataclass
from typing import Dict

from torch import nn

from speakingstyle_torch.training.optim import Optimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer

    def state_dict(self, copy: bool = True) -> Dict:
        """``copy=False``: the live tensors (the model's state dict holds
        them anyway; the optimizer's moments are cloned only with copy)."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(copy)}

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
