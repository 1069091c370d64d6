"""Data- and tensor-parallel rank processes for the port's tests, over gloo
on the CPU.

``run_ranks(fn, world, tmp_path, **kwargs)`` starts ``world`` processes of
this file (``parallel/launch.py::run_workers``: a free port of 127.0.0.1,
so xdist's parallel workers cannot collide), each of which joins the
process group (``tp`` of the kwargs: the tensor-parallel ranks, 1 by
default), calls ``fn(mesh, **kwargs)`` of this module and saves what it
returns to ``tmp_path``; the caller gets the ranks' results in rank order.
The module imports torch and the port only (no JAX), so a rank starts in a
few seconds; TensorFlow is blocked in the ranks, as the ``no_tensorflow``
fixture blocks it in the test process.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def no_tensorflow_dir(root) -> str:
    """A directory whose ``tensorflow`` package refuses to import: on a
    child's ``PYTHONPATH`` it keeps ``torch.utils.tensorboard`` off
    TensorFlow (seconds and much memory per process)."""
    d = os.path.join(str(root), "no_tf", "tensorflow")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "__init__.py"), "w") as fh:
        fh.write("raise ImportError('tensorflow is blocked in the port tests')\n")
    return os.path.dirname(d)


def child_env(tmp_path, **extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (no_tensorflow_dir(tmp_path), REPO, env.get("PYTHONPATH")) if p)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def run_ranks(fn: str, world: int, tmp_path, env_extra=None, **kwargs):
    """``fn(mesh, **kwargs)`` on ``world`` gloo ranks; their results."""
    import torch

    from speakingstyle_torch.parallel.launch import run_workers

    job = os.path.join(str(tmp_path), f"{fn}.job.json")
    with open(job, "w") as fh:
        json.dump(kwargs, fh)
    run_workers([os.path.abspath(__file__), fn, job], world,
                env=child_env(tmp_path, **(env_extra or {})))
    return [torch.load(f"{job}.rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- rank functions


def _cfg(paths, **train):
    import dataclasses

    from speakingstyle_torch.configs.config import load_config

    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train)) \
        if train else cfg


def _state(cfg, variables, device="cpu", mesh=None):
    """A TrainState on ``device`` from a Flax variables file (numpy pickle)
    or, without one, from ``train.seed``; this rank's shards on a mesh of
    tp > 1."""
    import pickle

    import torch

    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.training.trainer import build_state, shard_model

    if variables is None:
        return build_state(cfg, torch.device(device), mesh)
    with open(variables, "rb") as fh:
        model = load_flax_variables(build_model(cfg), pickle.load(fh))
    model.postnet.dropout = 0.0
    return shard_model(model.to(device), cfg, mesh)


def whole_model(cfg, state, mesh):
    """A one-device model holding ``state``'s weights gathered whole over
    tp (the state's own model without a layout)."""
    from speakingstyle_torch.models.factory import build_model

    if state.layout is None:
        return state.model
    model = build_model(cfg)
    model.postnet.dropout = state.model.postnet.dropout
    model.load_state_dict(whole_tensors(state.model.state_dict(), state.layout, mesh))
    return model


def whole_tensors(named, layout, mesh):
    """{name: tensor} of this rank's shards -> the whole tensors."""
    from speakingstyle_torch.parallel.tensor import gather_whole

    return {k: v if layout is None or layout.dim(k) is None
            else gather_whole(v.detach(), layout.dim(k), mesh) for k, v in named.items()}


def _host_tree(model, grads=None, state=None, mesh=None):
    """The Flax tree of ``model`` (whole) or, with ``grads`` (``state``'s
    optimizer order, this rank's shards), of the gathered gradients."""
    from speakingstyle_torch.compat.from_jax import to_flax_tree

    if grads is not None:
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        whole = whole_tensors(dict(zip(names, grads)), state.layout, mesh)
        by_name = dict(model.named_parameters())
        tree = to_flax_tree(model, {id(by_name[n]): g for n, g in whole.items()})
        return {"params": _numpy(tree["params"])}
    return _numpy(to_flax_tree(model))


def tiny_configs(root, corpus, **model):
    """-p / -m / -t yamls of a tiny model (two-head attention, 16 wide) on
    ``corpus``, batch 4, a log line every step; ``model`` overrides."""
    import yaml

    docs = {
        "preprocess": {"path": {"preprocessed_path": str(corpus)},
                       "preprocessing": {"pitch": {"feature": "phoneme_level"},
                                         "energy": {"feature": "phoneme_level"}}},
        "model": dict({
            "transformer": {"encoder_layer": 1, "decoder_layer": 2, "encoder_hidden": 16,
                            "decoder_hidden": 16, "encoder_head": 2, "decoder_head": 2,
                            "conv_filter_size": 32},
            "reference_encoder": {"encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 16,
                                  "conv_layer": 2, "conv_filter_size": 16},
            "variance_predictor": {"filter_size": 16}, "variance_embedding": {"n_bins": 16},
            "postnet_embedding_dim": 16, "postnet_layers": 3, "max_seq_len": 64,
            "compute_dtype": "float32", "dropout_impl": "hash"}, **model),
        "train": {"path": {"ckpt_path": os.path.join(str(root), "ckpt"),
                           "log_path": os.path.join(str(root), "log")},
                  "optimizer": {"batch_size": 4, "grad_clip_thresh": 1.0},
                  "step": {"total_step": 100, "log_step": 1, "val_step": 1000,
                           "save_step": 1000}},
    }
    paths = {}
    for name, doc in docs.items():
        paths[name] = os.path.join(str(root), f"{name}.yaml")
        with open(paths[name], "w") as fh:
            yaml.safe_dump(doc, fh)
    return paths


def _numpy(tree):
    import numpy as np

    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.array(tree)


def train_steps(mesh, paths, steps=3, variables=None, poison_at=None, device="cpu",
                clip_norm=False):
    """``steps`` chained data- (and tensor-) parallel train steps
    (``make_train_step`` with the mesh) on the global batches
    ``run_training`` cuts at dp: per step the global losses, the
    sentinel's agreed flag, the gradients the update applied, the
    parameters and BatchNorm statistics after it (gathered whole over tp),
    and the weights digest of the whole state. ``poison_at``: the step
    whose batch the ``nan_grads`` drill poisons (rank 0's rows).
    ``clip_norm``: also the optimizer's global norm of each step's
    gradients."""
    import torch

    from speakingstyle_torch.models.loss import loss_counts
    from speakingstyle_torch.models.postnet import sync_batch_stats
    from speakingstyle_torch.obs.buildinfo import weights_digest
    from speakingstyle_torch.parallel.mesh import shard_batch
    from speakingstyle_torch.training import faults
    from speakingstyle_torch.training.trainer import (
        broadcast_state, global_losses, kernel_launches, make_train_step, to_device,
        train_batcher,
    )

    if device != "cpu":  # full float32 (cuDNN defaults to TF32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = _cfg(paths)
    state = _state(cfg, variables, device, mesh)
    sync_batch_stats(state.model, mesh)
    broadcast_state(state, mesh)
    step = make_train_step(cfg, mesh)
    batches = iter(train_batcher(cfg, pad_multiple=mesh.dp))
    out = []
    for i in range(steps):
        batch = next(batches)
        arrays = to_device(shard_batch(batch.arrays(), mesh), mesh.device)
        if poison_at == i + 1:
            arrays = faults.poison_batch(arrays, rank=mesh.dp_rank)
        before = kernel_launches()
        losses, grads = step(state, arrays, loss_counts(batch.arrays()))
        host, finite = global_losses(losses, mesh)
        launches = {k: v - before[k] for k, v in kernel_launches().items()}
        whole = whole_model(cfg, state, mesh)
        out.append({"losses": host, "finite": finite, "local_finite": bool(losses["_finite"]),
                    "rows": int(arrays["texts"].shape[0]),
                    "grads": _host_tree(whole, grads, state, mesh), "after": _host_tree(whole),
                    "digest": weights_digest(whole.state_dict()),
                    "local_digest": weights_digest(state.model.state_dict()),
                    "mel_frames": float(arrays["mel_lens"].sum()), "launches": launches})
        if clip_norm:
            out[-1]["clip_norm"] = float(state.optimizer.global_norm(
                [g.float() for g in grads]))
    return out


def run(mesh, paths, max_steps, faults=None, restore_step=None, **train):
    """``run_training`` as this rank, on a ``train.parallel.mesh`` of the
    group's ranks (with ``train`` overrides of the train config): the final
    step, the weights digest, rank 0's registry gauges."""
    import dataclasses

    import torch

    from speakingstyle_torch import obs
    from speakingstyle_torch.configs.config import ParallelConfig
    from speakingstyle_torch.obs.buildinfo import weights_digest
    from speakingstyle_torch.training.trainer import run_training

    if faults:
        os.environ["SPEAKINGSTYLE_FAULTS"] = faults
    cfg = _cfg(paths)
    tr = dataclasses.replace(cfg.train, parallel=ParallelConfig(
        mesh=[mesh.dp, mesh.tp], partition_rules=cfg.train.parallel.partition_rules))
    if train:
        tr = dataclasses.replace(
            tr, step=dataclasses.replace(tr.step, **train.get("step", {})),
            resilience=dataclasses.replace(tr.resilience, **train.get("resilience", {})))
    cfg = dataclasses.replace(cfg, train=tr)
    registry = obs.MetricsRegistry()
    state = run_training(cfg, device=torch.device("cpu"), max_steps=max_steps,
                         restore_step=restore_step, registry=registry)
    return {"step": state.step,
            "digest": weights_digest(whole_model(cfg, state, mesh).state_dict()),
            "gauges": registry.snapshot()["gauges"]}


def restored(mesh, paths, step):
    """A fresh state restored from ``step`` as ``run_training`` restores it
    at this (dp, tp) (the barrier, the broadcast, the accumulator rule): every
    leaf of its state dict, flattened, gathered whole over tp as a
    checkpoint gathers it."""
    import torch

    from speakingstyle_torch.obs.buildinfo import flatten
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import (
        _SavedState, broadcast_state, build_state, local_accumulator,
    )

    cfg = _cfg(paths)
    state = build_state(cfg, torch.device("cpu"), mesh)
    CheckpointManager(cfg.train.path.ckpt_path, mesh=mesh).restore(state, step=step)
    broadcast_state(state, mesh)
    local_accumulator(state, mesh)
    return {"state": {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                      for k, v in flatten(_SavedState(state, mesh).state_dict()).items()}}


def tp_collectives(mesh, seed=0):
    """``parallel/tensor.py`` on this rank of a tp group: a split tensor
    gathered whole, ``gather_param``'s gradient (this rank's slice of the
    whole gradient), ``copy_to_tp``'s (summed over tp) and
    ``reduce_from_tp``'s forward (summed) and gradient (as it came)."""
    import torch

    from speakingstyle_torch.parallel.partition import local_slice
    from speakingstyle_torch.parallel.tensor import copy_to_tp, gather_param, reduce_from_tp

    g = torch.Generator().manual_seed(seed)
    whole = torch.randn(6, 4 * mesh.tp, 3, generator=g)
    upstream = torch.randn(whole.shape, generator=g)
    w = local_slice(whole, 1, mesh.tp, mesh.tp_rank).requires_grad_()
    got = gather_param(w, 1, mesh)
    (got * upstream).sum().backward()
    x = torch.randn(5, 7, generator=g).requires_grad_()
    part = torch.randn(5, 7, generator=g) * (mesh.tp_rank + 1)
    (copy_to_tp(x, mesh) * part).sum().backward()
    y = torch.randn(5, 7, generator=g).mul(mesh.tp_rank + 1).requires_grad_()
    red = reduce_from_tp(y, mesh)
    (red * part).sum().backward()
    return {"whole": whole, "gathered": got.detach(), "w_grad": w.grad,
            "slice": local_slice(upstream, 1, mesh.tp, mesh.tp_rank), "x_grad": x.grad,
            "part": part, "reduced": red.detach(), "y": y.detach(), "y_grad": y.grad}


def vocoder_steps(mesh, wav_dir, steps, batch_size, segment, learning_rates):
    """``train_vocoder`` with the mesh (small networks), once a learning
    rate: the final step, the last metrics, the state's digest and the
    gradients each update applied (the ranks' mean), in call order (the
    discriminators', then the generator's, a step)."""
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.data.mel_dataset import scan_wavs
    from speakingstyle_torch.training import vocoder_trainer as vt

    out, update = [], vt.AdamW.update
    for lr in learning_rates:
        applied = []
        vt.AdamW.update = lambda opt, grads: (applied.append([g.clone() for g in grads]),
                                              update(opt, grads))[1]
        gen, mpd, msd = small_vocoder()
        hp = vt.VocoderHParams(learning_rate=lr, segment_size=segment)
        try:
            state, metrics = vt.train_vocoder(
                load_config(preset="LJSpeech"), scan_wavs(wav_dir), hp=hp, max_steps=steps,
                batch_size=batch_size, log_every=1, gen=gen, mpd=mpd, msd=msd, device="cpu",
                mesh=mesh)
        finally:
            vt.AdamW.update = update
        out.append({"step": state.step, "metrics": {k: float(v) for k, v in metrics.items()},
                    "digest": vt.vocoder_digest(state),
                    "grads": [[g.numpy() for g in gs] for gs in applied]})
    return out


def vocoder_gan_step(mesh, state_path, batch_path, gen, periods, n_scales, segment):
    """One GAN step (``make_vocoder_train_step`` with the mesh) from the
    vocoder state saved at ``state_path``, on this rank's rows of the
    global batch at ``batch_path``: the ranks' mean metrics and the state
    tree after the step."""
    import numpy as np
    import torch

    from speakingstyle_torch.configs.config import Config
    from speakingstyle_torch.models.hifigan import Generator
    from speakingstyle_torch.models.hifigan_disc import (
        PERIOD_CHANNELS, MultiPeriodDiscriminator, MultiScaleDiscriminator,
    )
    from speakingstyle_torch.training import vocoder_trainer as vt

    hp = vt.VocoderHParams(segment_size=segment)
    state = vt.init_vocoder_state(
        Config(), hp, 0, gen=Generator(**gen),
        mpd=MultiPeriodDiscriminator(tuple(periods), PERIOD_CHANNELS),
        msd=MultiScaleDiscriminator(n_scales=n_scales), device="cpu")
    state = vt.restore_vocoder(state_path, state)
    batch = np.load(batch_path)
    rows = mesh.rows(batch["wavs"].shape[0])
    metrics = vt.make_vocoder_train_step(Config(), hp, mesh)(
        state, torch.from_numpy(batch["wavs"][rows]), torch.from_numpy(batch["mels"][rows]))
    names = sorted(metrics)
    means = mesh.host_all_reduce([float(metrics[k]) for k in names])
    return {"metrics": {k: v / mesh.dp for k, v in zip(names, means)},
            "tree": vt.state_tree(state), "digest": vt.vocoder_digest(state)}


def small_vocoder(channels=32, periods=(2, 3), mpd_channels=(8, 16, 32, 32, 32), scales=1):
    """A small generator and discriminators (tests/test_torch_vocoder.py's
    loop sizes)."""
    from speakingstyle_torch.models.hifigan import Generator
    from speakingstyle_torch.models.hifigan_disc import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator,
    )

    return (Generator(n_mels=80, upsample_rates=(8, 8, 2, 2),
                      upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=channels),
            MultiPeriodDiscriminator(tuple(periods), tuple(mpd_channels)),
            MultiScaleDiscriminator(n_scales=scales))


def _worker(fn: str, job: str) -> None:
    sys.modules.setdefault("tensorflow", None)
    import torch

    from speakingstyle_torch.parallel.mesh import init_distributed, leave_group

    torch.set_num_threads(1)
    with open(job) as fh:
        kwargs = json.load(fh)
    mesh = init_distributed(kwargs.get("device", "cpu"), tp=kwargs.pop("tp", 1))
    try:
        result = globals()[fn](mesh, **kwargs)
        torch.save(result, f"{job}.rank{mesh.rank}.pt")
    finally:
        leave_group()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
