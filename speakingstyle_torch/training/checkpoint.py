"""Step-named checkpoints with an integrity manifest (JAX counterpart:
speakingstyle_tpu/training/checkpoint.py).

``save(step, state)`` writes ``<directory>/<step>/state.pt`` (``torch.save``
of the train state on the host) and ``<step>/manifest.json``: the step, the
sha256 of every leaf (dtype, shape and bytes, as the JAX package hashes
them), ``weights_digest`` (one order-independent sha256 over the model's
parameters) and the step's ``val_loss`` when one was given. The step
directory is written under a temporary name and renamed into place, so a
step directory exists only once it is complete.

* **Async saves** (``async_save``): ``save()`` takes a snapshot of the state
  into host memory before it returns and hands the hashing and the write to
  a background thread; ``wait()`` joins it and re-raises its error. The
  optimizer updates the parameters and moments in place, so a writer that
  read the live tensors while the next step runs would write a torn
  checkpoint (half step s, half s + 1, hashed as it read them). The
  snapshot therefore copies every tensor into page-locked host buffers
  with a non-blocking copy on the current stream, which stream order puts
  before the next step's update, and records an event; the writer waits
  on that event before it hashes or writes. A second ``save()`` waits for
  the first before it reuses the buffers.
* **Retention**: ``max_to_keep`` keeps the newest steps, and ``keep_best``
  also the step with the lowest ``val_loss``, read from the manifests, so
  the best step survives a restart.
* **Restore**: every leaf is checked against the manifest before the state
  is filled (``CheckpointCorruptError`` on a mismatch). ``step=None`` walks
  the steps newest-first past one that is damaged; each corrupt step
  skipped (not one merely absent) is noted in ``skipped``, the
  ``ckpt_corrupt_skipped_total`` counter and a ``ckpt_corrupt_skipped``
  event. The ``checkpoint_corrupt@N`` and ``manifest_missing@N`` fault
  kinds drill both, counted on the manager's 1-based ``verify_count``.

* **Data and tensor parallelism** (``mesh``): a checkpoint is always the
  whole, one-process state (the trainer gathers split leaves and moments
  over ``tp`` before a save, ``training/trainer.py::_SavedState``), so a
  step saved at one (dp, tp) restores at any other bit for bit: ``restore``
  cuts the whole state to the target's layout (``TrainState.local``).
  Rank 0 alone writes; before any rank reads a step (a restore, the
  sentinel's rollback) every rank waits on a barrier until rank 0's writes
  are in place.

``restore_weights`` does the same for inference, filling a model's
parameters and BatchNorm statistics without an optimizer. A step
directory of the JAX package (an Orbax checkpoint: no ``state.pt``) is
refused with ``ForeignCheckpointError``, which names the ``convert``
route.
"""

import json
import os
import re
import shutil
import threading
from typing import Dict, List, Optional, Sequence

import torch

from speakingstyle_torch.obs.buildinfo import array_sha256 as tensor_sha256
from speakingstyle_torch.obs.buildinfo import flatten, weights_digest

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


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return tree


class _Snapshot:
    """The host copy of a state: page-locked buffers (for card tensors)
    reused from one save to the next, filled by non-blocking copies on the
    current stream, and the event that marks their end."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event = None

    def take(self, live: Dict) -> Dict:
        flat = flatten(live)
        cuda = [t for t in flat.values() if isinstance(t, torch.Tensor) and t.is_cuda]
        host = {}
        for name, t in flat.items():
            if not isinstance(t, torch.Tensor):
                host[name] = t
                continue
            t = t.detach()
            buf = self.buffers.get(name)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                self.buffers[name] = buf
            buf.copy_(t, non_blocking=t.is_cuda)
            host[name] = buf
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(cuda[0].device))
        return _unflatten(live, host)

    def ready(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _unflatten(template, flat: Dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(template)]
    return flat[prefix]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 async_save: bool = False, keep_best: bool = False, fault_plan=None,
                 events=None, registry=None, mesh=None):
        self.directory = os.path.abspath(directory)
        # a rank other than 0 writes nothing
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.writer = self.mesh is None or self.mesh.is_main
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep or None
        self.async_save, self.keep_best = async_save, keep_best
        self.fault_plan, self.events, self.registry = fault_plan, events, registry
        self.verify_count = 0  # 1-based fault-site counter (per instance)
        self.skipped: List[CheckpointCorruptError] = []  # corrupt steps the walk passed
        self.last_restored_step: Optional[int] = None
        # the restored step's manifest digest (None for a fresh run or an
        # unverified restore)
        self.last_weights_digest: Optional[str] = None
        self._snapshot = _Snapshot()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    # -- saving -------------------------------------------------------------

    def save(self, step: int, state, val_loss: Optional[float] = None,
             block: bool = False) -> str:
        """Save ``state`` (a TrainState) under ``step``; returns its
        directory. With ``async_save`` (and not ``block``) this returns once
        the host snapshot is taken, and the write finishes on a background
        thread. ``val_loss`` goes into the manifest for keep-best. On a
        rank other than 0 of a mesh this writes nothing."""
        if not self.writer:
            return self._step_dir(step)
        self.wait()  # one write in flight; its buffers are the snapshot's
        host = self._snapshot.take(state.state_dict(copy=False))
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, val_loss),
                name=f"ckpt-save-{step}", daemon=True)
            self._thread.start()
        else:
            self._write(step, host, val_loss)
        return self._step_dir(step)

    def _write_guarded(self, step: int, host: Dict, val_loss) -> None:
        try:
            self._write(step, host, val_loss)
        except BaseException as e:  # surfaced by the next wait()/save()
            self._error = e

    def _write(self, step: int, host: Dict, val_loss) -> None:
        self._snapshot.ready()
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_NAME))
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": int(step),
            "val_loss": None if val_loss is None else float(val_loss),
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

    def save_in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def wait(self) -> None:
        """Join any in-flight async write; re-raise its error, if any."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        try:
            self.wait()
        except BaseException as e:
            # close() runs in ``finally`` blocks: surface, don't mask
            print(f"[checkpoint] in-flight save failed during close: {e}")

    # -- retention ----------------------------------------------------------

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

    def val_losses(self) -> Dict[int, float]:
        """{step: val_loss} of the saved steps whose manifest records one."""
        out = {}
        for step in self.all_steps():
            try:
                with open(os.path.join(self._step_dir(step), MANIFEST_NAME),
                          encoding="utf-8") as fh:
                    v = json.load(fh).get("val_loss")
            except (OSError, ValueError):
                continue
            if v is not None:
                out[step] = float(v)
        return out

    def best_step(self) -> Optional[int]:
        """The saved step with the lowest recorded val loss."""
        losses = self.val_losses()
        return min(losses, key=losses.get) if losses else None

    def _prune(self) -> None:
        if not self.max_to_keep:
            return
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:])
        best = self.best_step() if self.keep_best else None
        if best is not None:
            keep.add(best)
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # -- reading ------------------------------------------------------------

    def _resolve(self, step: int) -> int:
        """Raise FileNotFoundError where ``step`` has no directory,
        ForeignCheckpointError where it is not one of this package's."""
        path = self._step_dir(step)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint step {step} under {self.directory}")
        if not os.path.isfile(os.path.join(path, STATE_NAME)):
            raise ForeignCheckpointError(path)
        return step

    def _load_step(self, step: int, strict: bool = True):
        """(the saved state dict on the host, its manifest) of ``step``,
        every leaf checked against the manifest. A missing manifest is
        corrupt under ``strict``; otherwise the state loads unverified."""
        self._resolve(step)
        path = self._step_dir(step)
        self.verify_count += 1
        n, plan = self.verify_count, self.fault_plan
        if plan is not None and plan.fire("checkpoint_corrupt", n):
            raise CheckpointCorruptError(step, "injected", "fault drill")
        mpath = os.path.join(path, MANIFEST_NAME)
        missing = not os.path.isfile(mpath) or (
            plan is not None and plan.fire("manifest_missing", n))
        manifest = None
        if missing and strict:
            raise CheckpointCorruptError(step, "manifest_missing")
        if not missing:
            with open(mpath, encoding="utf-8") as fh:
                try:
                    manifest = json.load(fh)
                except json.JSONDecodeError as e:
                    raise CheckpointCorruptError(step, "manifest_malformed", str(e)) from e
        try:
            loaded = torch.load(os.path.join(path, STATE_NAME), map_location="cpu",
                                weights_only=True)
        except Exception as e:
            raise CheckpointCorruptError(step, "state_unreadable",
                                         f"{type(e).__name__}: {e}") from e
        if manifest is not None:
            leaves = {n: t for n, t in flatten(loaded).items() if isinstance(t, torch.Tensor)}
            want = manifest["leaves"]
            if set(leaves) != set(want):
                raise CheckpointCorruptError(step, "leaf_set_mismatch",
                                             f"{sorted(set(leaves) ^ set(want))[:8]}")
            for name, t in leaves.items():
                if tensor_sha256(t) != want[name]["sha256"]:
                    raise CheckpointCorruptError(step, "leaf_hash_mismatch", name)
        self.last_restored_step = step
        self.last_weights_digest = (manifest or {}).get("weights_digest")
        return loaded, manifest or {}

    def load_verified(self, step: Optional[int] = None, strict: bool = True):
        """(step, the saved state dict on the host, its manifest), every
        leaf checked against the manifest. ``step`` None walks the steps
        newest-first past absent and corrupt ones (each corrupt one noted);
        an explicit step fails loudly."""
        self.wait()  # never read around an in-flight write
        if self.mesh is not None:
            self.mesh.barrier()  # nor around rank 0's
        if step is not None:
            return (step, *self._load_step(step, strict))
        names = sorted((int(n) for n in os.listdir(self.directory) if n.isdigit()),
                       reverse=True)
        foreign = None
        for s in names:
            try:
                return (s, *self._load_step(s, strict))
            except ForeignCheckpointError as e:
                foreign = foreign or e
            except FileNotFoundError:
                pass
            except Exception as e:
                self._note_corrupt_skip(s, e)
        if foreign is not None:
            raise foreign
        raise FileNotFoundError(f"no restorable checkpoint under {self.directory}")

    def _note_corrupt_skip(self, step: int, error: BaseException) -> None:
        if not isinstance(error, CheckpointCorruptError):
            error = CheckpointCorruptError(step, type(error).__name__, str(error))
        self.skipped.append(error)
        print(f"[checkpoint] {error}; trying the previous step")
        if self.registry is not None:
            self.registry.counter(
                "ckpt_corrupt_skipped_total",
                help="corrupt (not absent) checkpoints skipped by the newest-first "
                     "restore walk",
            ).inc()
        if self.events is not None:
            self.events.emit("ckpt_corrupt_skipped", step=int(step), reason=error.reason,
                             error=str(error))

    def restore(self, state, step: Optional[int] = None, ignore_layers: Sequence[str] = (),
                strict: bool = True):
        """Fill ``state`` in place from ``step`` (the latest restorable if
        None), after checking every leaf against the manifest.
        ``ignore_layers``: regexes matched against the parameters'
        '/'-joined Flax paths (as the JAX package names them); a matching
        parameter keeps its fresh value and the optimizer starts anew, as in
        the JAX package. A tensor-parallel state keeps its shards of the
        saved leaves."""
        _, loaded, _ = self.load_verified(step, strict)
        if ignore_layers:
            local = getattr(state, "local", lambda d: d)(loaded)
            _fill_model(state.model, local["model"], ignore_layers)
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
