"""Ring attention: sequence-parallel exact attention over a sequence mesh
(JAX counterpart: speakingstyle_tpu/parallel/ring_attention.py).

Queries stay on their rank while the key / value blocks (and the key-pad
bias) rotate around the ``seq`` ranks (``SeqMesh.rotate``, JAX's
``ppermute``); a streaming log-sum-exp merge makes the result that of one
softmax over the whole sequence, and no rank holds more than an
``[L / n, L / n]`` block of logits.

Layout (a rank's blocks):
  q, k, v : [B, H, L / n, D]   (block ``rank`` of the sequence)
  bias    : [B, 1, 1, L / n]   additive key-padding bias, blocked like k

``ring_attention`` is the ring on a rank's blocks; ``ring_self_attention``
takes the whole (replicated) tensors, runs the ring on this rank's block
and gives the whole output back on every rank, as the JAX ``shard_map``'s
``out_specs`` and the replicated layers after it do. The arithmetic is in
the dtype it is given (the model passes float32). Inference only: the
backward through the ring is not ported, and a call that autograd would
record raises.

``ring_attention_reference`` runs the same block passes and merges in one
process, block by block: the plain version the ring is held to.
"""

from typing import List, Optional

import torch

BACKWARD_MISSING = ("the backward through ring attention is ROADMAP.md queue A item 6c-ii "
                    "(no JAX path trains through the ring either); run the ring under "
                    "torch.no_grad()")


def _block_attn(q, k, v, bias, scale):
    """One q-block x kv-block pass -> (unnormalized out, row max, row sumexp)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    m = torch.amax(logits, dim=-1, keepdim=True)  # [B, H, Lq, 1]
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m, l


def _merge(acc, new):
    """The streaming softmax merge of two (out, max, sumexp) partials."""
    o, m, l = acc
    o_new, m_new, l_new = new
    m_tot = torch.maximum(m, m_new)
    alpha = torch.exp(m - m_tot)
    beta = torch.exp(m_new - m_tot)
    return o * alpha + o_new * beta, m_tot, l * alpha + l_new * beta


def _check_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(BACKWARD_MISSING)


def ring_attention(q, k, v, bias=None, mesh=None, scale: Optional[float] = None):
    """Exact attention of this rank's query block against every rank's
    key / value block, the blocks rotating ``n - 1`` times around ``mesh``
    (a ``parallel.mesh.SeqMesh``); returns [B, H, L / n, D]."""
    _check_no_grad(q, k, v, bias)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = _block_attn(q, k, v, bias, scale)
    for _ in range(mesh.n - 1):
        k, v, bias = mesh.rotate([k, v, bias])
        acc = _merge(acc, _block_attn(q, k, v, bias, scale))
    o, _, l = acc
    return o / torch.clamp(l, min=1e-30)


def ring_self_attention(q, k, v, bias=None, mesh=None):
    """q / k / v [B, H, L, D] and bias [B, 1, 1, L], whole on every rank:
    this rank's block of L through the ring, then the whole [B, H, L, D]
    output gathered on every rank. L must divide by ``mesh.n``."""
    if mesh is None:
        raise ValueError("ring_self_attention requires a mesh")
    L = q.shape[2]
    if L % mesh.n:
        raise ValueError(f"sequence length {L} does not divide over the seq mesh of {mesh.n}")
    m = L // mesh.n
    lo = mesh.rank * m
    block = lambda t, dim: None if t is None else t.narrow(dim, lo, m).contiguous()  # noqa: E731
    out = ring_attention(block(q, 2), block(k, 2), block(v, 2), block(bias, 3), mesh)
    return mesh.gather(out, 2)


def ring_attention_reference(q, k, v, bias=None, n: int = 2,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The ring of ``n`` ranks in one process: for each query block ``r``,
    the block passes against key blocks ``r, r - 1, ..., r - n + 1`` (mod
    ``n``: the order the rotations bring them), merged as the ring merges;
    the blocks concatenated. q / k / v [B, H, L, D], bias [B, 1, 1, L]."""
    L = q.shape[2]
    if L % n:
        raise ValueError(f"sequence length {L} does not divide into {n} blocks")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    m = L // n
    blk = lambda t, dim, i: None if t is None else t.narrow(dim, i * m, m)  # noqa: E731
    outs: List[torch.Tensor] = []
    for r in range(n):
        qr = blk(q, 2, r)
        acc = None
        for s in range(n):
            j = (r - s) % n
            part = _block_attn(qr, blk(k, 2, j), blk(v, 2, j), blk(bias, 3, j), scale)
            acc = part if acc is None else _merge(acc, part)
        o, _, l = acc
        outs.append(o / torch.clamp(l, min=1e-30))
    return torch.cat(outs, dim=2)
