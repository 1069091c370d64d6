"""The weight carrier between the JAX package's Flax variables and the
port's modules, both ways.

``load_flax_variables(module, variables)`` takes a Flax variable tree
(``{"params": ..., "batch_stats": ...}``) as nested dicts of numpy arrays
or tensors (``jax.device_get`` of the tree, a Flax msgpack file read by
``compat/flax_msgpack.py``, or a reference PyTorch checkpoint converted by
``compat/torch_convert.py``) and fills the module in place. It imports no JAX. The port's submodules carry the Flax
tree's names, so each leaf's path is its module path plus a leaf rule:

* ``nn.Linear``: ``kernel`` [in, out] -> ``weight`` [out, in], ``bias``;
* ``nn.Embedding``: ``embedding`` -> ``weight``;
* ``nn.LayerNorm``: ``scale`` -> ``weight``, ``bias``;
* a port module with ``FLAX_LEAVES`` names its own leaves: Conv1d keeps
  ``kernel`` [K, Cin, Cout] as stored, HiFi-GAN's convs transpose it to
  torch's [Cout, Cin, K], FiLM has ``s_gamma``/``s_beta``, the postnet
  BatchNorm ``scale``/``bias`` and, in ``batch_stats``, ``mean``/``var``.
  A rule's third element, where given, names its collection: Flax's
  spectral-norm state is ``batch_stats`` of ``SpectralNorm_<i>``, leaves
  named ``"<layer>/kernel/u"`` and ``"<layer>/kernel/sigma"`` (one key each).

Every expected leaf must be present with its exact shape and no other
leaf may be: a missing, extra or misshapen leaf raises and names itself,
so a renamed module cannot load silently.

``to_flax_tree(module)`` is the inverse: the module's parameters and
BatchNorm statistics as Flax-named numpy trees, so that gradients and
updated parameters compare leaf by leaf against the JAX package
(``load_flax_variables`` then ``to_flax_tree`` gives back the same bits).
``flax_param_names`` maps the module's state-dict keys to those paths.
"""

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from speakingstyle_torch.models.postnet import BatchNorm

# leaf rules of torch's own modules: flax leaf -> (torch attribute, permutation)
_BUILTIN_LEAVES = {
    nn.Linear: {"kernel": ("weight", (1, 0)), "bias": ("bias", None)},
    nn.Embedding: {"embedding": ("weight", None)},
    nn.LayerNorm: {"scale": ("weight", None), "bias": ("bias", None)},
}
_BATCH_STATS = {"mean", "var"}


def _leaf_rules(mod: nn.Module) -> Dict[str, Tuple[str, object]]:
    if type(mod) in _BUILTIN_LEAVES:
        return _BUILTIN_LEAVES[type(mod)]
    rules = dict(getattr(mod, "FLAX_LEAVES", {}))
    if isinstance(mod, BatchNorm):
        rules = {n: (n, None) for n in ("scale", "bias", "mean", "var")}
    if not rules:
        # a module whose own parameters keep their Flax names (Conv1d, FiLM)
        rules = {n: (n, None) for n, _ in mod.named_parameters(recurse=False)}
    return rules


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        elif isinstance(value, torch.Tensor):  # e.g. a bf16 leaf of a msgpack file
            out[path] = value.detach().float().cpu().numpy()
        else:
            out[path] = np.asarray(value)
    return out


def expected_leaves(module: nn.Module, collections: Optional[Sequence[str]] = None
                    ) -> Dict[Tuple[str, ...], Tuple[torch.Tensor, object]]:
    """``(collection, *module path, flax leaf)`` -> (the port tensor,
    permutation), for the leaves of ``collections`` (default all)."""
    expected = {}
    for mod_name, mod in module.named_modules():
        path = tuple(mod_name.split(".")) if mod_name else ()
        for leaf, (attr, perm, *coll) in _leaf_rules(mod).items():
            tensor = getattr(mod, attr, None)
            if tensor is None:
                continue  # e.g. a bias-free Linear
            if coll:
                collection = coll[0]
            elif isinstance(mod, BatchNorm) and leaf in _BATCH_STATS:
                collection = "batch_stats"
            else:
                collection = "params"
            if collections is None or collection in collections:
                expected[(collection,) + path + (leaf,)] = (tensor, perm)
    return expected


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables: Mapping,
                        tensors: Optional[Mapping[int, torch.Tensor]] = None,
                        collections: Optional[Sequence[str]] = None) -> nn.Module:
    """Fill ``module``'s parameters and BatchNorm statistics (only
    ``collections``, where given) from a Flax variable tree of numpy
    arrays; raises on any missing, extra or misshapen leaf. ``tensors``
    (``id(parameter) -> tensor``) writes each leaf into another tensor of
    its parameter's shape (an optimizer moment, say) instead."""
    given = _flatten(variables)
    expected = expected_leaves(module, collections)
    missing = sorted("/".join(p) for p in expected.keys() - given.keys())
    extra = sorted("/".join(p) for p in given.keys() - expected.keys())
    if missing or extra:
        raise ValueError(
            f"Flax variables do not match {type(module).__name__}: "
            f"missing {missing[:8]}{' ...' if len(missing) > 8 else ''} "
            f"({len(missing)}), extra {extra[:8]}{' ...' if len(extra) > 8 else ''} "
            f"({len(extra)})"
        )
    for path, (tensor, perm) in expected.items():
        value = given[path]
        if perm is not None:
            value = np.transpose(value, perm)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{'/'.join(path)}: Flax shape {tuple(given[path].shape)} does not "
                f"fit the port's {tuple(tensor.shape)}"
            )
        if tensors is not None:
            tensor = tensors.get(id(tensor), tensor)
        tensor.copy_(torch.from_numpy(np.array(value, np.float32)))
    return module


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def to_flax_tree(module: nn.Module, tensors: Optional[Mapping[int, torch.Tensor]] = None,
                 collections: Optional[Sequence[str]] = None) -> Dict:
    """``{"params": ..., "batch_stats": ...}`` of float32 numpy arrays in
    the Flax layout (only ``collections``, where given). ``tensors``
    (``id(parameter) -> tensor``) substitutes other tensors of the same
    shapes for the parameters, e.g. their gradients."""
    flat = {}
    for path, (tensor, perm) in expected_leaves(module, collections).items():
        t = tensor if tensors is None else tensors.get(id(tensor), tensor)
        value = t.detach().float().cpu().numpy()
        if perm is not None:
            value = np.transpose(value, np.argsort(perm))
        flat[path] = np.array(value, order="C")
    return _nest(flat)


def flax_param_names(module: nn.Module) -> Dict[str, str]:
    """The module's state-dict key -> its '/'-joined Flax path (without
    the collection), for every carried parameter and statistic."""
    by_id = {id(t): "/".join(path[1:]) for path, (t, _) in expected_leaves(module).items()}
    named = list(module.named_parameters()) + list(module.named_buffers())
    return {name: by_id[id(t)] for name, t in named if id(t) in by_id}
