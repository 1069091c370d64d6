"""PostNet mel refiner: 5 conv1d(512, k=5) + BatchNorm, tanh on all but the
last, dropout 0.5 after each (JAX counterpart:
speakingstyle_tpu/models/postnet.py)."""

import torch
from torch import nn

from speakingstyle_torch.ops.conv import Conv1d
from speakingstyle_torch.ops.dropout import maybe_dropout
from speakingstyle_torch.parallel.tensor import param


class BatchNorm(nn.Module):
    """Channel-last BatchNorm with Flax's semantics, which are not
    ``torch.nn.BatchNorm1d``'s. Parameters ``scale``/``bias``, buffers
    ``mean``/``var``: the JAX package's names.

    * ``deterministic=True`` (``use_running_average``): the running
      statistics.
    * ``deterministic=False``: the batch's statistics in float32 over every
      (B, T) position, padding included; the biased variance as
      E[x^2] - E[x]^2, clipped at 0; the running statistics updated in
      place as ``0.9 * old + 0.1 * batch`` (Flax's ``batch_stats``
      collection after a ``mutable=["batch_stats"]`` apply).

    Both normalise in float32 and cast the output to the compute dtype.

    ``sync`` (a joined ``parallel.mesh.Mesh`` with ``dp > 1``, set by the
    trainer): train-mode statistics over the GLOBAL batch, the JAX
    package's GSPMD semantics. The per-channel sum, sum of squares and count
    of the rank's rows are all-reduced over the mesh's ``dp`` group inside
    the graph (``AllReduceSum``, whose backward all-reduces the incoming
    gradient), so the running statistics are the same on every rank and the
    backward is the global batch's. (The ``tp`` ranks of a data-parallel
    group hold the same rows: a sum over the world would count each row
    ``tp`` times.) Without it (one rank) the code path is the one above.
    """

    MOMENTUM = 0.9

    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.sync = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, deterministic: bool = True):
        xf = x.float()
        if deterministic:
            mean, var = self.mean, self.var
        else:
            if self.sync is not None and self.sync.dp > 1:
                count = torch.full_like(xf[0, 0], float(xf.shape[0] * xf.shape[1]))
                sums = AllReduceSum.apply(torch.stack(
                    [xf.sum(dim=(0, 1)), (xf * xf).sum(dim=(0, 1)), count]), self.sync)
                mean = sums[0] / sums[2]
                var = torch.clamp(sums[1] / sums[2] - mean * mean, min=0.0)
            else:
                mean = xf.mean(dim=(0, 1))
                var = torch.clamp((xf * xf).mean(dim=(0, 1)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.MOMENTUM).add_((1 - self.MOMENTUM) * mean)
                self.var.mul_(self.MOMENTUM).add_((1 - self.MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * param(self, "scale")
        return ((xf - mean) * mul + param(self, "bias")).to(self.dtype)


class AllReduceSum(torch.autograd.Function):
    """The sum over the mesh's data-parallel ranks of a tensor,
    differentiable: the gradient of each rank's input is the sum of every
    rank's output gradient (each rank's loss reads the global sums)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        mesh.all_reduce_([out], group="dp")
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.mesh.all_reduce_([grad], group="dp")
        return grad, None


def sync_batch_stats(model: nn.Module, mesh) -> None:
    """Point every ``BatchNorm`` of ``model`` at ``mesh`` (None: local
    statistics again)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = mesh if mesh is not None and mesh.dp > 1 else None


class PostNet(nn.Module):
    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5, conv_impl: str = "xla",
                 dtype=torch.float32, dropout: float = 0.5, dropout_impl: str = "hash"):
        super().__init__()
        self.n, self.dtype = n_convolutions, dtype
        self.dropout, self.dropout_impl = dropout, dropout_impl
        for i in range(n_convolutions):
            cin = n_mel_channels if i == 0 else embedding_dim
            cout = n_mel_channels if i == n_convolutions - 1 else embedding_dim
            self.add_module(f"conv_{i}", Conv1d(cin, cout, kernel_size, impl=conv_impl, dtype=dtype))
            self.add_module(f"bn_{i}", BatchNorm(cout, dtype=dtype))

    def forward(self, mel, keep_mask=None, deterministic: bool = True, rng=None):
        """mel [B, T, n_mels] -> residual [B, T, n_mels]. ``keep_mask``
        ([T] or [B, T], True = real frame) re-zeroes every layer's output at
        masked frames: the free-running parity rule of the JAX package."""
        x = mel.to(self.dtype)
        if keep_mask is not None and keep_mask.dim() == 1:
            keep_mask = keep_mask[None, :]
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x), deterministic)
            if i < self.n - 1:
                x = torch.tanh(x)
            x = maybe_dropout(x, self.dropout, deterministic, rng, self.dropout_impl)
            if keep_mask is not None:
                x = x.masked_fill(~keep_mask[..., None], 0.0)
        return x
