"""Tensor-parallel parameter layout over the mesh's ``model`` axis (JAX
counterpart: speakingstyle_tpu/parallel/partition.py).

The rules are the JAX package's, matched (first ``re.match`` wins, default
replicate) against each parameter's Flax path, the name
``compat/from_jax.py::flax_param_names`` gives it, so one YAML's
``train.parallel.partition_rules`` picks the same leaves in both packages:

* attention q/k/v column parallel (heads split), ``fc`` row parallel;
* the conv FFN's ``w_1`` column parallel over its filters, ``w_2`` row
  parallel;
* the reference encoder's mel convs output-channel parallel,
  ``fftb_linear`` row parallel.

A spec names a Flax dimension; ``tp_layout`` turns it into the dimension of
the port's tensor (an ``nn.Linear`` stores its kernel transposed) and keeps
the JAX package's divisibility fallback: a leaf whose split dimension
``tp`` does not divide stays replicated. A spec naming an axis the
``(data, model)`` mesh lacks (``seq``: the trainer builds no sequence axis)
raises the JAX package's error where its sharding would. The BatchNorm statistics and
every leaf no rule picks are replicated. The Adam moments follow their
parameters (``training/optim.py`` builds them from the local shards).

There is no GSPMD here: ``apply_layout`` replaces each split parameter of
the model by this rank's slice and marks its module, and the modules write
the collectives themselves (``parallel/tensor.py``).
"""

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from speakingstyle_torch.parallel.mesh import AXIS_NAMES

Spec = Tuple[Optional[str], ...]

# (path regex, spec): specs name the "model" mesh axis per Flax dimension
DEFAULT_TP_RULES: List[Tuple[str, Spec]] = [
    # attention: column-parallel QKV, row-parallel output projection
    (r".*slf_attn/(w_qs|w_ks|w_vs)/kernel$", (None, "model")),
    (r".*slf_attn/(w_qs|w_ks|w_vs)/bias$", ("model",)),
    (r".*slf_attn/fc/kernel$", ("model", None)),
    # conv FFN: column-parallel w_1, row-parallel w_2 (kernel [K, Cin, Cout])
    (r".*pos_ffn/w_1/kernel$", (None, None, "model")),
    (r".*pos_ffn/w_1/bias$", ("model",)),
    (r".*pos_ffn/w_2/kernel$", (None, "model", None)),
    # reference-encoder mel conv stack: output-channel parallel
    (r".*reference_encoder/conv_\d+/conv/kernel$", (None, None, "model")),
    (r".*reference_encoder/conv_\d+/conv/bias$", ("model",)),
    (r".*reference_encoder/fftb_linear/kernel$", ("model", None)),
]


def parse_rule_overrides(overrides) -> List[Tuple[str, Spec]]:
    """``train.parallel.partition_rules`` -> the rule list: each override
    ``[path_regex, axes]`` (``axes`` a comma-separated per-dimension list of
    mesh axis names or ``none``) PREPENDED to ``DEFAULT_TP_RULES`` so it
    wins first match; none given returns the defaults."""
    if not overrides:
        return DEFAULT_TP_RULES
    rules: List[Tuple[str, Spec]] = []
    for pattern, axes in overrides:
        spec = tuple(
            None if tok.strip().lower() in ("", "none") else tok.strip()
            for tok in str(axes).split(",")
        )
        rules.append((pattern, spec))
    return rules + DEFAULT_TP_RULES


def _spec_for(path: str, rules) -> Spec:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return spec
    return ()


def tp_layout(model: nn.Module, tp: int, rules=None) -> Dict[str, Optional[int]]:
    """Each parameter's state-dict key -> the dimension of the port's
    tensor it is split on over ``model`` (tp ranks), or None (replicated):
    the rule's spec for its Flax path, replicated where ``tp`` does not
    divide a split dimension or the spec is longer than the leaf."""
    from speakingstyle_torch.compat.from_jax import expected_leaves

    rules = DEFAULT_TP_RULES if rules is None else rules
    flax = {id(t): ("/".join(path[1:]), perm)
            for path, (t, perm) in expected_leaves(model, ["params"]).items()}
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        path, perm = flax.get(id(p), (None, None))
        spec = _spec_for(path, rules) if path is not None else ()
        # torch dimension i holds Flax dimension perm[i]
        to_torch = list(range(p.dim())) if perm is None else [list(perm).index(f)
                                                               for f in range(p.dim())]
        split = None
        # the JAX package's fallback: replicated unless tp divides every
        # named dimension
        if all(axis is None or (f < p.dim() and p.shape[to_torch[f]] % tp == 0)
               for f, axis in enumerate(spec)):
            for f, axis in enumerate(spec):
                if axis is None:
                    continue
                if axis not in AXIS_NAMES:  # JAX's NamedSharding error, word for word
                    raise ValueError(f"Resource axis: {axis} of PartitionSpec{spec!r} is not "
                                     f"found in mesh: {AXIS_NAMES}.")
                if axis != "model":
                    raise ValueError(f"partition rule for {path}: axis {axis!r}; the port "
                                     "splits parameters over the mesh's model axis only")
                split = to_torch[f]
        out[name] = split
    return out


def count_sharded(model: nn.Module, tp: int, rules=None) -> int:
    """How many parameters the layout splits (introspection)."""
    return sum(d is not None for d in tp_layout(model, tp, rules).values())


def local_slice(t: torch.Tensor, dim: int, tp: int, tp_rank: int) -> torch.Tensor:
    """Rank ``tp_rank``'s contiguous slice of ``t`` along ``dim`` (a copy)."""
    n = t.shape[dim] // tp
    return t.narrow(dim, tp_rank * n, n).contiguous()


class TPLayout:
    """A model's split leaves on one rank of a ``tp``-wide mesh: ``dims``
    (state-dict key -> split dimension or None) and the trainable
    parameters' keys in optimizer order, so that whole state dicts (a
    checkpoint's, a fresh init's) can be cut to this rank's shards."""

    def __init__(self, dims: Dict[str, Optional[int]], tp: int, tp_rank: int,
                 param_names: Sequence[str]):
        self.dims, self.tp, self.tp_rank = dims, tp, tp_rank
        self.param_names = list(param_names)

    def dim(self, name: str) -> Optional[int]:
        return self.dims.get(name)

    @property
    def opt_dims(self) -> List[Optional[int]]:
        """The split dimension of each optimizer slot (trainable order)."""
        return [self.dims.get(n) for n in self.param_names]

    def local(self, name: str, t):
        d = self.dims.get(name)
        return t if d is None or not isinstance(t, torch.Tensor) else \
            local_slice(t, d, self.tp, self.tp_rank)

    def local_state(self, state: Dict) -> Dict:
        """A whole TrainState state dict -> this rank's (model leaves and
        Adam moments / accumulator cut to their shards)."""
        out = dict(state)
        out["model"] = {k: self.local(k, v) for k, v in state["model"].items()}
        opt = dict(state["optimizer"])
        for key in ("mu", "nu", "acc"):
            if opt.get(key) is not None:
                opt[key] = [self.local(n, t) for n, t in zip(self.param_names, opt[key])]
        out["optimizer"] = opt
        return out


def apply_layout(model: nn.Module, dims: Dict[str, Optional[int]], mesh) -> None:
    """Replace every split parameter of ``model`` by this rank's slice (a
    new ``nn.Parameter``; build the optimizer after this) and mark its
    module: ``tp_split`` {attribute: dimension} and ``tp_mesh``."""
    modules = dict(model.named_modules())
    for name, dim in dims.items():
        if dim is None:
            continue
        mod_name, _, attr = name.rpartition(".")
        mod = modules[mod_name]
        old = getattr(mod, attr)
        new = nn.Parameter(local_slice(old.detach(), dim, mesh.tp, mesh.tp_rank),
                           requires_grad=old.requires_grad)
        mod._parameters[attr] = new
        mod.__dict__.setdefault("tp_split", {})[attr] = dim
        mod.__dict__["tp_mesh"] = mesh
