"""Optimizer: grad clip -> (L2) -> Adam -> -lr, with the ramp-then-step
schedule and gradient accumulation (JAX counterpart:
speakingstyle_tpu/training/optim.py).

The update is the JAX package's optax chain, step for step:

* ``clip_by_global_norm(grad_clip_thresh)``: the gradients are scaled by
  clip / norm only when the global norm is at least clip. (Not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm and
  scales whenever the norm exceeds clip.) The scale is applied as one
  factor, where optax divides by the norm and multiplies by clip: the two
  differ by an f32 rounding.
* ``add_decayed_weights(weight_decay)`` when it is set: L2 into the
  gradient, before the moments (torch Adam's semantics, not AdamW's).
* ``scale_by_adam(b1, b2, eps)``: moments in f32, bias correction with
  the incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``.
* ``scale_by_learning_rate(schedule)``: the lr is read at the count
  before the increment, and the update is ``-lr`` times the Adam step.
* ``grad_acc_step = k > 1`` is ``optax.MultiSteps``: the running mean of k
  micro-batch gradients (``acc + (g - acc) / (n + 1)``), then one update;
  the other k - 1 calls leave the parameters as they are.
* ``shard(sharded, tp_sum)`` (tensor parallelism, ``training/trainer.py``):
  the slots that hold a rank's shard of a split leaf. The clip's global
  norm then counts each logical parameter once: ``tp_sum`` (an all-reduce
  over ``tp``) of the shards' sums of squares, plus the replicated leaves'
  sum, taken once. Adam and the L2 term are elementwise and run on the
  shards and their moments as they are.
* ``update(grads, reduce)``: a data-parallel rank passes its all-reduce,
  which the update applies to the gradients it is about to clip: this
  call's with k = 1, the accumulated mean at the last micro-step with k > 1
  (the ranks' accumulators are local until then; they sum to the global
  one, which is what a checkpoint stores: ``training/trainer.py``).

``train.fused_optimizer`` names three layouts of this one update in the
JAX package (the per-leaf optax chain, a flat raveled vector, per-leaf
fused expressions) whose updates are identical; the port serves all four
values with this one implementation, which runs ``torch._foreach_*`` ops
over the parameter list.

The schedule and the counts live on the host: no step reads anything back
from the card.
"""

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from speakingstyle_torch.configs.config import TrainConfig


def make_lr_schedule(train_cfg: TrainConfig) -> Callable[[int], float]:
    """The lr of optimizer step ``step`` (``optim.py:34-49`` of the JAX
    package, in its float32 arithmetic): with ``current = step + 1``, a
    linear ramp init_lr -> anneal_lr over ``loss.anneal_steps`` steps, then
    anneal_lr times anneal_rate per milestone of ``optimizer.anneal_steps``
    passed."""
    opt = train_cfg.optimizer
    f32 = np.float32
    ramp_steps = train_cfg.loss.anneal_steps
    init_lr, anneal_lr = opt.init_lr, opt.anneal_lr
    milestones = np.asarray(opt.anneal_steps, np.float32)

    def schedule(step: int) -> float:
        current = f32(step) + f32(1.0)
        if current > f32(ramp_steps):
            n_passed = int(np.sum(current > milestones))
            return float(f32(anneal_lr) * np.power(f32(opt.anneal_rate), f32(n_passed)))
        return float(f32(init_lr) + (current / f32(ramp_steps)) * f32(anneal_lr - init_lr))

    return schedule


class Optimizer:
    """clip -> (L2) -> Adam -> -lr over ``params`` (a fixed, ordered list),
    with k-step gradient accumulation. ``update(grads)`` applies one call's
    gradients in place and returns whether the parameters moved."""

    def __init__(self, params: Sequence[torch.Tensor], train_cfg: TrainConfig):
        opt = train_cfg.optimizer
        self.params: List[torch.Tensor] = list(params)
        self.schedule = make_lr_schedule(train_cfg)
        self.b1, self.b2 = opt.betas
        self.eps, self.clip, self.wd = opt.eps, opt.grad_clip_thresh, opt.weight_decay
        self.k = opt.grad_acc_step
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.k > 1 else None
        self.count = 0      # inner (Adam) updates taken
        self.mini_step = 0  # micro-batches accumulated toward the next update
        self.sharded: List[int] = []  # slots of split leaves (tensor parallelism)
        self.tp_sum = None

    def shard(self, sharded: Sequence[bool], tp_sum: Callable) -> None:
        """Mark the slots that hold a shard of a split leaf; ``tp_sum(t)``
        sums a device scalar over the tensor-parallel ranks in place."""
        self.sharded = [i for i, s in enumerate(sharded) if s]
        self.tp_sum = tp_sum if self.sharded else None

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the logical gradient: each parameter once."""
        norms = torch.stack(torch._foreach_norm(grads))
        if self.tp_sum is None:
            return torch.linalg.vector_norm(norms)
        sq = norms.square()
        split = torch.zeros(len(grads), dtype=torch.bool, device=sq.device)
        split[self.sharded] = True
        shards = sq[split].sum().reshape(1)
        self.tp_sum(shards)
        return torch.sqrt(shards[0] + sq[~split].sum())

    def lr(self) -> float:
        """The lr the next update applies."""
        return self.schedule(self.count)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], reduce=None) -> bool:
        grads = [g.float() for g in grads]
        if self.k > 1:
            n = self.mini_step
            # optax.MultiSteps: Welford running mean of the micro-batch grads
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (n + 1) % self.k
            if self.mini_step != 0:
                return False
            grads, self.acc = self.acc, [torch.zeros_like(a) for a in self.acc]
        if reduce is not None:
            reduce(grads)
        norm = self.global_norm(grads)
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        grads = torch._foreach_mul(grads, scale)
        if self.wd:
            torch._foreach_add_(grads, [p.float() for p in self.params], alpha=self.wd)
        self.count += 1
        lr = self.schedule(self.count - 1)
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(self.params, step)
        return True

    def state_dict(self, copy: bool = True) -> Dict:
        """The counts and moments; ``copy=False`` hands out the live
        tensors (the checkpoint's snapshot copies them itself)."""
        c = (lambda ts: [t.clone() for t in ts]) if copy else list
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": c(self.mu), "nu": c(self.nu),
                "acc": None if self.acc is None else c(self.acc)}

    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu"), (self.acc, "acc")):
            if dst is None:
                continue
            src = state[key]
            if len(src) != len(dst):
                raise ValueError(f"optimizer state {key}: {len(src)} tensors, want {len(dst)}")
            for d, s in zip(dst, src):
                d.copy_(s)
