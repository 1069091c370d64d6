"""The collectives of tensor parallelism, written out (JAX counterpart: what
GSPMD inserts for ``parallel/partition.py``'s shardings).

Every activation outside a column / row pair is replicated on the ``tp``
ranks of a data-parallel group, so each rank computes the same replicated
gradients; the three autograd Functions keep it so:

* ``copy_to_tp``: identity forward; backward all-reduces the gradient over
  ``tp`` (each rank's local branch contributes part of the input's);
* ``reduce_from_tp``: all-reduce over ``tp`` forward (the row-parallel
  partial sums), identity backward;
* ``gather_param(w, dim, mesh)``: the whole leaf from each rank's slice
  along ``dim``; backward takes this rank's slice of the whole gradient,
  which every rank computes alike from replicated activations (a
  reduce-scatter would count it ``tp`` times).

A gather is an all-reduce of a zero-filled buffer into which each rank
writes its slice (x + 0 = x: exact): gloo, which two ranks sharing one card
use, runs ``all_reduce`` but not ``all_gather`` on CUDA tensors, and one
code path serves NCCL too.

``param(module, name)`` is how the model reads a leaf: the whole leaf,
gathered where the layout splits it. The column / row pairs
(``pair_mesh``) instead compute on their local shards.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def gather_whole(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this tp rank's slice along
    ``dim`` (no autograd)."""
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * mesh.tp
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(dim, mesh.tp_rank * n, n).copy_(t)
    mesh.all_reduce_([full], group="tp")
    return full


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh.all_reduce_([g], group="tp")
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        out = x.contiguous().clone()
        mesh.all_reduce_([out], group="tp")
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, w.shape[dim]
        return gather_whole(w.detach(), dim, mesh)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.tp_rank
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, mesh)


def gather_param(w: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    return _GatherParam.apply(w, dim, mesh)


def split_of(module: nn.Module, name: str) -> Optional[int]:
    """The dimension the layout splits ``module.<name>`` on, or None."""
    return module.__dict__.get("tp_split", {}).get(name)


def param(module: nn.Module, name: str):
    """``module.<name>`` whole: gathered over tp where the layout splits it."""
    t = getattr(module, name)
    dim = split_of(module, name)
    return t if dim is None or t is None else gather_param(t, dim, module.tp_mesh)


def pair_mesh(columns: Sequence[Tuple[nn.Module, str, int]], row: Tuple[nn.Module, str, int]):
    """The mesh when the layout makes a Megatron pair of these leaves: each
    ``(module, weight, dim)`` of ``columns`` split on its output dimension
    ``dim`` with its bias (if any) split too, and ``row``'s weight split on
    its input dimension with its bias replicated; else None (the modules
    then gather what is split and compute as one device)."""
    for mod, w, dim in columns:
        if split_of(mod, w) != dim or (getattr(mod, "bias", None) is not None
                                       and split_of(mod, "bias") != 0):
            return None
    mod, w, dim = row
    if split_of(mod, w) != dim or split_of(mod, "bias") is not None:
        return None
    return mod.tp_mesh
