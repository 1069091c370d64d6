"""Gradient reversal: identity forward, -alpha-scaled gradient backward
(JAX counterpart: speakingstyle_tpu/ops/grad_reverse.py, a ``custom_vjp``
there).

The reference's GradientReversalLayer/RevGrad (reference:
model/blocks.py:7-40): off the main training path, part of its public
surface for adversarial speaker/style disentanglement experiments.

    x = grad_reverse(x, alpha=0.5)
"""

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha: float):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return _GradReverse.apply(x, alpha)
