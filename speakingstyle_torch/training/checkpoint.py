"""Step-named checkpoints with an integrity manifest (JAX counterpart:
speakingstyle_tpu/training/checkpoint.py, minimal).

``save(step, state)`` writes ``<directory>/<step>/state.pt`` (``torch.save``
of the train state's ``state_dict`` on the host) and
``<step>/manifest.json``: the step, the sha256 of every leaf (dtype, shape
and bytes, as the JAX package hashes them) and ``weights_digest``, one
order-independent sha256 over the model's parameters. The step directory
is written under a temporary name and renamed into place, so a step
directory exists only once it is complete. ``max_to_keep`` prunes the
oldest steps after each save. ``restore`` checks every leaf against the
manifest before it fills the state and raises ``CheckpointCorruptError``
on a mismatch; ``restore_weights`` does the same for inference, filling a
model's parameters and BatchNorm statistics without an optimizer. A step
directory of the JAX package (an Orbax checkpoint: no ``state.pt``) is
refused with ``ForeignCheckpointError``, which names the ``convert``
route.

Not ported yet (ROADMAP.md): async saves, keep-best retention, and the
newest-first walk past a corrupt step.
"""

import hashlib
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

import torch

MANIFEST_NAME = "manifest.json"
STATE_NAME = "state.pt"
MANIFEST_FORMAT = 1


class ForeignCheckpointError(RuntimeError):
    """A step directory that is not the port's: the JAX package's Orbax
    checkpoints, which the port does not read."""

    def __init__(self, path: str):
        super().__init__(
            f"{path} holds no {STATE_NAME}: it is not a checkpoint of this package (an "
            "Orbax checkpoint of the JAX package?). The port reads its own checkpoints "
            "and, through `python -m speakingstyle_torch convert --kind fastspeech2 "
            "--ckpt <step>.pth.tar`, the reference PyTorch checkpoints"
        )


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists but failed verification (distinct from absent)."""

    def __init__(self, step: int, reason: str, detail: str = ""):
        self.step, self.reason = step, reason
        super().__init__(f"checkpoint step {step} is corrupt ({reason})"
                         + (f": {detail}" if detail else ""))


def tensor_sha256(t: torch.Tensor) -> str:
    """sha256 of one tensor's dtype + shape + raw bytes."""
    t = t.detach().cpu().contiguous()
    a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    h = hashlib.sha256()
    h.update(str(t.dtype).replace("torch.", "").encode())
    h.update(str(tuple(a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """'/'-joined leaf paths of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def weights_digest(model_state: Dict) -> Optional[str]:
    """One sha256 over sorted ``name=leaf_sha`` lines of the model's state."""
    lines = sorted(f"{n}={tensor_sha256(t)}\n" for n, t in flatten(model_state).items())
    if not lines:
        return None
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
    return h.hexdigest()


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep or None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state) -> str:
        """Write ``state`` (a TrainState) under ``step``; returns its directory."""
        host = _to_host(state.state_dict())
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_NAME))
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": int(step),
            "weights_digest": weights_digest(host["model"]),
            "leaves": {n: {"sha256": tensor_sha256(t), "shape": list(t.shape)}
                       for n, t in flatten(host).items() if isinstance(t, torch.Tensor)},
        }
        with open(os.path.join(tmp, MANIFEST_NAME), "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._prune()
        return final

    def all_steps(self) -> List[int]:
        """The steps saved by this package (a manifest and a state.pt)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and all(os.path.isfile(os.path.join(self.directory, name, f))
                                      for f in (MANIFEST_NAME, STATE_NAME)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        if not self.max_to_keep:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _resolve(self, step: Optional[int]) -> int:
        """``step``, or the latest of this package's steps if None; raises
        FileNotFoundError where there is none, ForeignCheckpointError where
        the step directory is not one of this package's."""
        if step is None:
            step = self.latest_step()
            if step is None:
                foreign = sorted((n for n in os.listdir(self.directory) if n.isdigit()), key=int)
                if foreign:
                    raise ForeignCheckpointError(self._step_dir(int(foreign[-1])))
                raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = self._step_dir(step)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint step {step} under {self.directory}")
        if not os.path.isfile(os.path.join(path, STATE_NAME)):
            raise ForeignCheckpointError(path)
        return step

    def load_verified(self, step: Optional[int] = None):
        """(step, the saved state dict on the host, its manifest), every
        leaf checked against the manifest; ``step`` None is the latest."""
        step = self._resolve(step)
        path = self._step_dir(step)
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.isfile(mpath):
            raise CheckpointCorruptError(step, "manifest_missing")
        with open(mpath, encoding="utf-8") as fh:
            try:
                manifest = json.load(fh)
            except json.JSONDecodeError as e:
                raise CheckpointCorruptError(step, "manifest_malformed", str(e)) from e
        loaded = torch.load(os.path.join(path, STATE_NAME), map_location="cpu",
                            weights_only=True)
        leaves = {n: t for n, t in flatten(loaded).items() if isinstance(t, torch.Tensor)}
        want = manifest["leaves"]
        if set(leaves) != set(want):
            raise CheckpointCorruptError(step, "leaf_set_mismatch",
                                         f"{sorted(set(leaves) ^ set(want))[:8]}")
        for name, t in leaves.items():
            if tensor_sha256(t) != want[name]["sha256"]:
                raise CheckpointCorruptError(step, "leaf_hash_mismatch", name)
        return step, loaded, manifest

    def restore(self, state, step: Optional[int] = None, ignore_layers: Sequence[str] = ()):
        """Fill ``state`` from ``step`` (the latest if None), after checking
        every leaf against the manifest. ``ignore_layers``: regexes matched
        against the parameters' '/'-joined Flax paths (as the JAX package
        names them); a matching parameter keeps its fresh value and the
        optimizer starts anew, as in the JAX package."""
        _, loaded, _ = self.load_verified(step)
        if ignore_layers:
            _fill_model(state.model, loaded["model"], ignore_layers)
            state.step = int(loaded["step"])
        else:
            state.load_state_dict(loaded)
        return state

    def restore_weights(self, model, step: Optional[int] = None,
                        ignore_layers: Sequence[str] = ()):
        """Inference restore: fill ``model``'s parameters and BatchNorm
        statistics from ``step`` (the latest if None) after the manifest
        check, without building an optimizer; ``ignore_layers`` as in
        ``restore``. Returns {"step", "weights_digest"} of the checkpoint."""
        step, loaded, manifest = self.load_verified(step)
        _fill_model(model, loaded["model"], ignore_layers)
        return {"step": step, "weights_digest": manifest.get("weights_digest")}


def _fill_model(model, saved: Dict, ignore_layers: Sequence[str]) -> None:
    """Load ``saved`` (a model state dict) into ``model``; a parameter whose
    Flax path matches one of the ``ignore_layers`` regexes keeps its value."""
    if ignore_layers:
        from speakingstyle_torch.compat.from_jax import flax_param_names

        patterns = [re.compile(p) for p in ignore_layers]
        fresh = model.state_dict()
        names = flax_param_names(model)
        saved = dict(saved)
        for key in list(saved):
            if any(p.search(names[key]) for p in patterns):
                saved[key] = fresh[key]
    model.load_state_dict(saved)
