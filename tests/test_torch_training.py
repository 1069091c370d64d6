"""PyTorch port, the training path: each piece against its JAX twin on
identical numpy inputs, and three chained train steps of the whole slice.

The JAX side runs its Pallas kernels in interpret mode (the fused-MHA
forward and backward through ``FORCE_INTERPRET``, the fused conv because
the CPU forces it); the port runs its kernels' plain versions, forward and
backward, through the same ``torch.autograd.Function``s the card uses.
Tolerances: losses 1e-5 relative, gradients 1e-4 absolute, parameters and
BatchNorm statistics 1e-5 after each step; the loss, the schedule and one
optimizer update 1e-6. One exception, stated and checked where it is
made: the parameters whose gradient is zero in exact arithmetic.
"""

import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from speakingstyle_torch.compat.from_jax import load_flax_variables, to_flax_tree

from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)
from torch_threads import no_tensorflow  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("no_tensorflow")

MODEL_YAML = {
    "transformer": {
        "encoder_layer": 1, "decoder_layer": 2, "encoder_hidden": 16,
        "decoder_hidden": 16, "encoder_head": 2, "decoder_head": 2,
        "conv_filter_size": 32, "encoder_dropout": 0.0, "decoder_dropout": 0.0,
    },
    "reference_encoder": {
        "encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 16,
        "conv_layer": 2, "conv_filter_size": 16, "dropout": 0.0,
    },
    "variance_predictor": {"filter_size": 16, "dropout": 0.0},
    "variance_embedding": {"n_bins": 16},
    "postnet_embedding_dim": 16,
    "postnet_layers": 3,
    "max_seq_len": 64,
    "compute_dtype": "float32",
    "conv_impl": "pallas",
    "attention_kernel": "fused",
    "dropout_impl": "hash",
}


# the tiny model on the library path (einsum attention, XLA / cuDNN convs):
# the tests of the loop, where the JAX side would otherwise run its Pallas
# kernels in interpret mode
LIBRARY_MODEL = dict(MODEL_YAML, attention_kernel="einsum", conv_impl="xla")


def write_configs(root, corpus, model=None, **train_overrides):
    pre = {"path": {"preprocessed_path": str(corpus)},
           "preprocessing": {"pitch": {"feature": "phoneme_level"},
                             "energy": {"feature": "phoneme_level"}}}
    train = {
        "path": {"ckpt_path": str(root / "ckpt"), "log_path": str(root / "log")},
        "optimizer": {"batch_size": 3, "grad_clip_thresh": 1.0},
        "step": {"total_step": 100, "log_step": 1, "val_step": 2, "save_step": 100},
        "loss": {"lambda_f": 0.01},
    }
    for k, v in train_overrides.items():
        train[k] = dict(train.get(k, {}), **v)
    paths = {}
    for name, data in (("preprocess", pre), ("model", model or MODEL_YAML), ("train", train)):
        paths[name] = root / f"{name}.yaml"
        paths[name].write_text(yaml.safe_dump(data))
    return {k: str(v) for k, v in paths.items()}


def load_both(paths):
    from speakingstyle_tpu.configs.config import load_config as j_load
    from speakingstyle_torch.configs.config import load_config as t_load

    args = (paths["preprocess"], paths["model"], paths["train"])
    return j_load(*args), t_load(*args)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from speakingstyle_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("corpus")
    return generate_corpus(str(root), n_utts=14, val_utts=3, n_phones_per_utt=(6, 11),
                           duration_range=(1, 3), seed=5)


# ---------------------------------------------------------------- the pieces


def test_corpus_and_batches_match_jax(tmp_path, corpus):
    """The copied corpus generator writes the JAX package's files, and the
    copied batcher cuts the same batches from the same seed."""
    from speakingstyle_tpu.data.dataset import BucketedBatcher as JB, SpeechDataset as JD
    from speakingstyle_tpu.data.synthetic import generate_corpus as j_gen
    from speakingstyle_torch.data.dataset import BucketedBatcher as TB, SpeechDataset as TD

    other = j_gen(str(tmp_path / "j"), n_utts=14, val_utts=3, n_phones_per_utt=(6, 11),
                  duration_range=(1, 3), seed=5)
    for name in ("train.txt", "val.txt", "stats.json", "mel/SYNTH-mel-synth00004.npy"):
        with open(f"{corpus}/{name}", "rb") as a, open(f"{other}/{name}", "rb") as b:
            assert a.read() == b.read(), name
    jcfg, tcfg = load_both(write_configs(tmp_path, corpus))
    jb = iter(JB(JD("train.txt", jcfg, sort=True, drop_last=True), max_src=64, max_mel=64, seed=9))
    tb = iter(TB(TD("train.txt", tcfg, sort=True, drop_last=True), max_src=64, max_mel=64, seed=9))
    for _ in range(5):
        j, t = next(jb), next(tb)
        assert j.ids == t.ids
        for k, v in j.arrays().items():
            np.testing.assert_array_equal(t.arrays()[k], v, err_msg=k)


def test_lr_schedule_breakpoints_match_jax():
    from speakingstyle_tpu.configs.config import TrainConfig as JT
    from speakingstyle_tpu.training.optim import make_lr_schedule as j_sched
    from speakingstyle_torch.configs.config import TrainConfig as TT
    from speakingstyle_torch.training.optim import make_lr_schedule as t_sched

    js, ts = j_sched(JT()), t_sched(TT())
    for step in (0, 1, 4998, 9998, 9999, 10000, 299998, 299999, 300000, 399999, 400000,
                 499999, 500000, 900000):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, err_msg=str(step))
    assert ts(0) == pytest.approx(1e-4 + 1e-4 * 0.9e-3 / 1e-4 / 1e4, rel=1e-6)
    assert ts(10000) == pytest.approx(1e-3, rel=1e-6)
    assert ts(300000) == pytest.approx(3e-4, rel=1e-6)


@pytest.mark.parametrize("grad_acc", [1, 2])
@pytest.mark.parametrize("clipped", [False, True])
def test_optimizer_update_matches_optax_chain(grad_acc, clipped):
    """clip -> Adam -> -lr (and MultiSteps accumulation) against the JAX
    package's optax chain: three calls, parameters after each."""
    from speakingstyle_tpu.configs.config import (
        OptimizerConfig as JO, TrainConfig as JT, LossConfig as JL,
    )
    from speakingstyle_tpu.training.optim import make_optimizer
    from speakingstyle_torch.configs.config import (
        OptimizerConfig as TO, TrainConfig as TT, LossConfig as TL,
    )
    from speakingstyle_torch.training.optim import Optimizer

    rng = np.random.default_rng(grad_acc + 2 * clipped)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # the global norm of a call's grads is ~0.1 or ~30 against clip 1.0
    scale = 10.0 if clipped else 0.03
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for _ in range(3)]
    opt_kw = dict(grad_acc_step=grad_acc, weight_decay=0.01)
    tx = make_optimizer(JT(optimizer=JO(**opt_kw), loss=JL(anneal_steps=5)))
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = Optimizer(tp, TT(optimizer=TO(**opt_kw), loss=TL(anneal_steps=5)))
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update([torch.from_numpy(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    assert topt.count == 3 // grad_acc


def test_fastspeech2_loss_matches_jax():
    from speakingstyle_tpu.models.loss import fastspeech2_loss as j_loss
    from speakingstyle_torch.models.layers import FiLM
    from speakingstyle_torch.models.loss import fastspeech2_loss as t_loss

    rng = np.random.default_rng(0)
    B, L, T = 3, 7, 12
    src_pad = np.arange(L)[None] >= np.array([7, 4, 5])[:, None]
    mel_pad = np.arange(T)[None] >= np.array([12, 8, 3])[:, None]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    preds = {"mel": f(B, T, 80), "mel_postnet": f(B, T, 80), "pitch_prediction": f(B, L),
             "energy_prediction": f(B, L), "log_duration_prediction": f(B, L),
             "src_pad_mask": src_pad, "mel_pad_mask": mel_pad}
    targets = (f(B, T, 80), f(B, L), f(B, L), rng.integers(0, 5, (B, L)).astype(np.int32))
    gates = {"a": {"film": {"s_gamma": f(1), "s_beta": f(1)}},
             "b": {"film": {"s_gamma": f(1), "s_beta": f(1)}, "other": {"kernel": f(2)}}}
    module = torch.nn.ModuleDict({k: FiLM() for k in gates})
    with torch.no_grad():
        for k, v in gates.items():
            module[k].s_gamma.copy_(torch.from_numpy(v["film"]["s_gamma"]))
            module[k].s_beta.copy_(torch.from_numpy(v["film"]["s_beta"]))
    want = j_loss({k: jnp.asarray(v) for k, v in preds.items()},
                  *(jnp.asarray(t) for t in targets), gates, lambda_f=0.3)
    got = t_loss({k: torch.from_numpy(np.asarray(v)) for k, v in preds.items()},
                 *(torch.from_numpy(t) for t in targets), module, lambda_f=0.3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-6, err_msg=k)


def test_batchnorm_train_mode_matches_flax():
    """Flax's train-mode BatchNorm: biased stats over every (B, T), the
    output, and the running update 0.9 old + 0.1 batch."""
    import flax.linen as fnn

    from speakingstyle_torch.models.postnet import BatchNorm

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 11, 6)) * 2 + 0.5).astype(np.float32)
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, upd = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         mutable=["batch_stats"])
    tbn = BatchNorm(6)
    with torch.no_grad():
        for name, v in {**params, **stats}.items():
            getattr(tbn, name).copy_(torch.from_numpy(v))
    got = tbn(torch.from_numpy(x), deterministic=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(), np.asarray(upd["batch_stats"][k]),
                                   atol=1e-5, err_msg=k)


def test_unported_settings_raise(monkeypatch):
    """Only partition rules over ``data`` are refused now; data parallelism
    (any dp, and ``sharding.data_axis = -1`` on several devices), tensor
    parallelism (``mesh: [dp, tp]``, ``sharding.model_axis``), the sequence
    axis (``seq > 1`` trains on the (dp, tp) mesh, as the JAX trainer
    does), remat, fault injection and the resilience defaults (the JAX
    package's) are ported."""
    from speakingstyle_torch.configs.config import (
        ParallelConfig, ResilienceConfig, ShardingConfig, TrainConfig, check_train_supported,
    )
    from speakingstyle_tpu.configs.config import ResilienceConfig as JResilience

    assert ResilienceConfig() == ResilienceConfig(**dataclasses.asdict(JResilience()))
    monkeypatch.setenv("SPEAKINGSTYLE_FAULTS", "nan_grads@3")
    for ok in (TrainConfig(), TrainConfig(sharding=ShardingConfig(remat=True)),
               TrainConfig(resilience=ResilienceConfig(nan_sentinel=True, keep_best=True,
                                                       async_checkpointing=True)),
               TrainConfig(parallel=ParallelConfig(mesh=[2, 1])),
               TrainConfig(parallel=ParallelConfig(mesh=[2, 2])),
               TrainConfig(sharding=ShardingConfig(model_axis=2)),
               TrainConfig(parallel=ParallelConfig(seq=2))):
        check_train_supported(ok)
    check_train_supported(TrainConfig(), n_devices=4)
    for bad in (TrainConfig(parallel=ParallelConfig(partition_rules=[["a/kernel$", "data"]])),):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 6[cd]"):
            check_train_supported(bad)


def test_train_yaml_asking_for_the_nan_sentinel_raises(tmp_path, corpus):
    """A train.yaml that both packages load, asking for the NaN sentinel and
    keep-best retention: once refused by the port, it now trains in both
    packages (2 steps each), with the sentinel's flag in the port's step
    and never in its log."""
    from speakingstyle_tpu.training.trainer import run_training as j_run
    from speakingstyle_torch.training.trainer import run_training

    logs = []
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        jcfg, tcfg = load_both(write_configs(tmp_path / side, corpus, LIBRARY_MODEL,
                                             step={"val_step": 1000},
                                             obs={"program_card": False},
                                             resilience={"nan_sentinel": True,
                                                         "keep_best": True}))
        assert jcfg.train.resilience.nan_sentinel and tcfg.train.resilience.nan_sentinel
        if side == "torch":
            assert run_training(tcfg, device="cpu", max_steps=2).step == 2
        else:
            with jax.default_prng_impl("threefry2x32"):
                assert int(j_run(dataclasses.replace(jcfg, train=dataclasses.replace(
                    jcfg.train, fast_prng=False)), max_steps=2).step) == 2
        logs.append((tmp_path / side / "log" / "log.txt").read_text())
    assert all("_finite" not in log and "[train] Step 2," in log for log in logs)


def test_remat_keeps_the_gradients_with_dropout_on(tmp_path, corpus):
    """``sharding.remat`` checkpoints the encoder's and decoder's blocks:
    with hash dropout on, one step's gradients equal those without remat,
    because the recompute replays the forward's masks; a recompute that
    drew fresh salts gives other gradients (so the recompute does run)."""
    from speakingstyle_torch.ops import dropout
    from speakingstyle_torch.training.trainer import (
        batch_streams, build_state, make_train_step, to_device,
    )

    paths = write_configs(tmp_path, corpus)
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(dict(MODEL_YAML, transformer=dict(
        MODEL_YAML["transformer"], encoder_dropout=0.2, decoder_dropout=0.2))))
    cfg = load_both(paths)[1]
    arrays = to_device(next(batch_streams(cfg)[0]).arrays(), torch.device("cpu"))

    def grads(remat):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, sharding=dataclasses.replace(cfg.train.sharding, remat=remat)))
        state = build_state(c, torch.device("cpu"))
        assert state.model.decoder.layer_stack.remat == remat
        return make_train_step(c)(state, arrays)[1]

    plain, remat = grads(False), grads(True)
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))
    fresh = dropout.ReplayRNG.salt
    try:
        dropout.ReplayRNG.salt = lambda self: self.rng.salt()
        assert not all(torch.equal(a, b) for a, b in zip(plain, grads(True)))
    finally:
        dropout.ReplayRNG.salt = fresh


# ---------------------------------------------------------------- the whole slice


@pytest.fixture
def no_jax_postnet_dropout(monkeypatch):
    """The JAX postnet's dropout is a fixed 0.5 that no config reaches; the
    whole-slice comparison runs with every dropout off."""
    from speakingstyle_tpu.models import postnet
    from speakingstyle_tpu.ops import pallas_attention
    from speakingstyle_tpu.ops.dropout import Dropout

    monkeypatch.setattr(postnet, "Dropout", lambda rate, impl: Dropout(0.0, impl=impl))
    monkeypatch.setattr(pallas_attention, "FORCE_INTERPRET", True)


# Adam's first step moves a parameter by lr g / (|g| + 1e-9): by +-lr
# wherever |g| is far above 1e-9, of g's sign. Where g is at rounding
# level, the two sides' float32 sums may give it either sign, or a size
# near Adam's eps, and the step differs by up to 2 lr. That holds whole
# leaves whose gradient is zero in exact arithmetic (the key projection's
# bias adds q.b to every score of a query row, which the softmax cancels;
# a postnet conv's is cancelled by the train-mode BatchNorm after it) and
# single elements of others. The JAX gradient tells them: |g| > 0 and at
# most NOISE_SHARE of the step's largest (the rule and the constant of
# chip_smoke.py's gradient parity). On this config's two init draws those
# leaves' max |g| is <= 3e-8 of the largest and every other leaf's >= 3.5e-4
# (at the LJSpeech_paper width on the H100: <= 7.9e-10 and >= 2.3e-6).
# Besides those leaves' 176 elements, 3 and 8 of the ~46k nonzero ones lie
# below 3e-7
NOISE_SHARE = 3e-7


def three_train_steps(tmp_path, corpus, prng_impl):
    """Three chained train steps of the tiny config on weights carried from
    a JAX init drawn with ``prng_impl`` and batches from the synthetic
    corpus, with the fused attention and the fused conv on both sides:
    losses per step, per-leaf gradients, and the parameters and BatchNorm
    statistics after each."""
    from speakingstyle_tpu.data.dataset import BucketedBatcher, SpeechDataset
    from speakingstyle_tpu.models.factory import build_model as j_build, init_variables
    from speakingstyle_tpu.models.loss import fastspeech2_loss as j_loss
    from speakingstyle_tpu.training.optim import make_optimizer
    from speakingstyle_tpu.training.trainer import _model_kwargs
    from speakingstyle_torch.models.factory import build_model as t_build
    from speakingstyle_torch.training.optim import Optimizer
    from speakingstyle_torch.training.state import TrainState
    from speakingstyle_torch.training.trainer import make_train_step, to_device, trainable

    jcfg, tcfg = load_both(write_configs(tmp_path, corpus))
    jmodel = j_build(jcfg)
    # the impl is pinned: the JAX trainer sets the process-wide default
    # (``train.fast_prng``), so a test run earlier would change the draw
    with jax.default_prng_impl(prng_impl):
        variables = jax.device_get(init_variables(jmodel, jcfg, jax.random.PRNGKey(3)))
    tx = make_optimizer(jcfg.train)

    def j_step(params, batch_stats, opt_state, arrays, key):
        def loss_fn(p):
            out, upd = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                    **_model_kwargs(arrays, teacher_forced=True),
                                    deterministic=False,
                                    rngs={"dropout": key},
                                    mutable=["batch_stats"])
            losses = j_loss(out, arrays["mels"], arrays["pitches"], arrays["energies"],
                            arrays["durations"], p, lambda_f=jcfg.train.loss.lambda_f)
            return losses["total_loss"], (losses, upd["batch_stats"])

        (_, (losses, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, losses, grads

    j_step = jax.jit(j_step, donate_argnums=(0, 1, 2))

    tmodel = load_flax_variables(t_build(tcfg), copy.deepcopy(variables))
    tmodel.postnet.dropout = 0.0
    state = TrainState(0, tmodel, Optimizer(trainable(tmodel), tcfg.train))
    t_step = make_train_step(tcfg)

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    batches = iter(BucketedBatcher(SpeechDataset("train.txt", jcfg, sort=True, drop_last=True),
                                   max_src=64, max_mel=64, seed=jcfg.train.seed))
    leaf = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]
    # {leaf: elements whose gradient was at rounding level in some step},
    # held to 2 lr a step; and the running mean of the BatchNorm after a
    # postnet conv (0.1 x the batch mean per step), in the channels where
    # the conv's bias is such an element, to 0.2 lr a step
    noise = {}
    lr_sum = 0.0
    bn_mean = re.compile(r"\['bn_(\d+)'\]\['mean'\]$")
    for step in range(3):
        lr_sum += state.optimizer.lr()
        batch = next(batches)
        params, stats, opt_state, j_losses, j_grads = j_step(
            params, stats, opt_state, batch.arrays(), jax.random.PRNGKey(step))
        t_losses, t_grads = t_step(state, to_device(batch.arrays(), torch.device("cpu")))
        for k, v in j_losses.items():
            np.testing.assert_allclose(float(t_losses[k]), float(v), rtol=1e-5,
                                       err_msg=f"step {step} {k}")
        j_abs = {jax.tree_util.keystr(p): np.abs(np.asarray(v)) for p, v in leaf(j_grads)}
        top = max(a.max() for a in j_abs.values())
        for k, a in j_abs.items():
            noise[k] = noise.get(k, False) | ((a > 0) & (a <= NOISE_SHARE * top))
        assert any(m.all() for m in noise.values()), "the rule finds no zero-gradient leaf"
        grads_tree = to_flax_tree(
            tmodel, {id(p): g for p, g in zip(trainable(tmodel), t_grads)})["params"]
        got = to_flax_tree(tmodel)
        for name, tree, want in (("grad", grads_tree, j_grads), ("param", got["params"], params),
                                 ("batch_stats", got["batch_stats"], stats)):
            tol = dict(atol=1e-4) if name == "grad" else dict(atol=1e-5, rtol=1e-5)
            flat_got = dict((jax.tree_util.keystr(p), v) for p, v in leaf(tree))
            flat_want = dict((jax.tree_util.keystr(p), v) for p, v in leaf(want))
            assert flat_got.keys() == flat_want.keys()
            for k, v in flat_want.items():
                g, w = np.asarray(flat_got[k]), np.asarray(v)
                msg = f"step {step} {name} {k}"
                mask, allowance = None, None
                if name == "param":
                    mask, allowance = noise[k], 2 * lr_sum
                elif name == "batch_stats" and bn_mean.search(k):
                    mask = noise[bn_mean.sub(r"['conv_\1']['bias']", k)]
                    allowance = 1e-5 + 0.2 * lr_sum
                if mask is not None and np.any(mask):
                    mask = np.broadcast_to(mask, w.shape)
                    np.testing.assert_allclose(g[mask], w[mask], atol=allowance,
                                               err_msg=msg + " (rounding-level gradient)")
                    g, w = g[~mask], w[~mask]
                np.testing.assert_allclose(g, w, **tol, err_msg=msg)
    assert state.step == 3


def test_three_train_steps_match_jax(tmp_path, corpus, no_jax_postnet_dropout):
    three_train_steps(tmp_path, corpus, "threefry2x32")


def test_three_train_steps_match_jax_rbg_draw(tmp_path, corpus, no_jax_postnet_dropout):
    """The same comparison on another init draw (the ``rbg`` PRNG's)."""
    three_train_steps(tmp_path, corpus, "rbg")


def test_train_cli_saves_and_resumes(tmp_path, corpus):
    """``train --device cpu --max_steps 2`` writes a step-2 checkpoint with
    its manifest; ``--restore_step -1`` resumes there and goes on."""
    import json
    import os

    from speakingstyle_torch.__main__ import main

    paths = write_configs(tmp_path, corpus)
    args = ["train", "-p", paths["preprocess"], "-m", paths["model"], "-t", paths["train"],
            "--device", "cpu"]
    state = main(args + ["--max_steps", "2"])
    assert state.step == 2
    manifest = json.load(open(tmp_path / "ckpt" / "2" / "manifest.json"))
    assert manifest["step"] == 2 and manifest["weights_digest"]
    assert any(k.startswith("model/") for k in manifest["leaves"])
    assert any(k.startswith("optimizer/mu/") for k in manifest["leaves"])
    resumed = main(args + ["--max_steps", "3", "--restore_step", "-1"])
    assert resumed.step == 3 and resumed.optimizer.count == 3
    assert os.path.isfile(tmp_path / "ckpt" / "3" / "manifest.json")
    log = open(tmp_path / "log" / "log.txt").read().splitlines()
    steps = [l.split(",")[0] for l in log if l.startswith("[train]")]
    assert steps == ["[train] Step 1", "[train] Step 2", "[train] Step 3"]
    assert all("step_time_s" in l and "data_wait_s" in l and "mel_frames_per_sec" in l
               for l in log if l.startswith("[train]"))
    assert any(l.startswith("[val] Step 2") for l in log)


def test_train_cli_drills_faults_and_writes_samples_and_a_trace(tmp_path, corpus, monkeypatch):
    """``train --faults 'nan_grads@2,loader_ioerror@3' --synth --profile_at 1
    --deterministic``:
    the loader error is retried, step 2 rolls back to a fresh init (no
    checkpoint yet) and the run completes; the ground-truth vs predicted
    sample lands in TensorBoard every synth_step; steps [1, 11) of the run
    are traced into ``<log_path>/profile``."""
    import os

    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.obs import read_events

    from speakingstyle_torch.device import use_deterministic

    paths = write_configs(tmp_path, corpus, step={"synth_step": 2, "val_step": 1000})
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # restored after the test
    try:
        state = main(["train", "-p", paths["preprocess"], "-m", paths["model"], "-t",
                      paths["train"], "--device", "cpu", "--max_steps", "3", "--synth",
                      "--profile_at", "1", "--faults", "nan_grads@2,loader_ioerror@3",
                      "--deterministic"])
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        use_deterministic(False)
    assert state.step == 3 and os.environ.pop("SPEAKINGSTYLE_FAULTS") == (
        "nan_grads@2;loader_ioerror@3")
    events = list(read_events(str(tmp_path / "log")))
    fired = [(e["kind"], e["step"]) for e in events if e["event"] == "fault_fire"]
    assert fired == [("nan_grads", 2)]
    assert [e["restore_step"] for e in events if e["event"] == "rollback"] == [None]
    assert [e["step"] for e in events if e["event"] == "train_step"] == [1, 1, 2, 3]
    assert os.listdir(tmp_path / "log" / "profile") == ["trace_to_step3.json"]
    tb = [f for f in os.listdir(tmp_path / "log") if f.startswith("events.out.tfevents")]
    assert tb and os.path.getsize(tmp_path / "log" / tb[0]) > 10_000  # scalars, figure, audio


def test_checkpoint_detects_a_flipped_leaf(tmp_path, corpus):
    import json

    from speakingstyle_torch.training.checkpoint import CheckpointCorruptError, CheckpointManager
    from speakingstyle_torch.training.trainer import build_state

    _, tcfg = load_both(write_configs(tmp_path, corpus))
    state = build_state(tcfg, torch.device("cpu"))
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    for step in (1, 2, 3):
        state.step = step
        mgr.save(step, state)
    assert mgr.all_steps() == [2, 3]
    path = tmp_path / "c" / "3" / "manifest.json"
    manifest = json.load(open(path))
    name = sorted(manifest["leaves"])[0]
    manifest["leaves"][name]["sha256"] = "0" * 64
    path.write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError, match="leaf_hash_mismatch"):
        mgr.restore(build_state(tcfg, torch.device("cpu")), step=3)
    # the latest restorable step: the walk passes the corrupt one, noted
    restored = mgr.restore(build_state(tcfg, torch.device("cpu")))
    assert restored.step == 2 and [e.reason for e in mgr.skipped] == ["leaf_hash_mismatch"]


def test_restore_with_ignore_layers_keeps_fresh_parameters(tmp_path, corpus):
    """``ignore_layers`` regexes match the Flax paths: a matching parameter
    keeps its fresh value, the rest load, and the optimizer starts anew."""
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import build_state

    _, tcfg = load_both(write_configs(tmp_path, corpus))
    state = build_state(tcfg, torch.device("cpu"))
    state.step, state.optimizer.count = 5, 5
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(5, state)
    fresh = build_state(tcfg, torch.device("cpu"))
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.zero_()
    mgr.restore(fresh, ignore_layers=["^encoder/src_word_emb/"])
    assert fresh.step == 5 and fresh.optimizer.count == 0
    assert not fresh.model.encoder.src_word_emb.weight.any()
    torch.testing.assert_close(fresh.model.mel_linear.weight, state.model.mel_linear.weight)


def test_train_start_identity_and_program_card(tmp_path, corpus):
    """``train_start`` carries ``build_info()`` and the restored step's
    ``weights_digest`` (None on a fresh run, the manifest's on a resume);
    ``train.obs.program_card`` adds one ``program_card`` event, counted on
    the first step, whose FLOPs over each step's wall time feed
    ``train_achieved_flops_per_sec``; with the key off there is neither."""
    import json

    from speakingstyle_torch import obs
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.trainer import run_training

    paths = write_configs(tmp_path, corpus)
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    reg = obs.MetricsRegistry()
    run_training(cfg, device="cpu", max_steps=2, registry=reg)
    run_training(cfg, device="cpu", max_steps=3, restore_step=-1, registry=reg)
    events = list(obs.read_events(str(tmp_path / "log")))
    starts = [e for e in events if e["event"] == "train_start"]
    assert [s["weights_digest"] for s in starts] == [
        None, json.load(open(tmp_path / "ckpt" / "2" / "manifest.json"))["weights_digest"]]
    info = obs.build_info()
    for s in starts:
        assert {k: s[k] for k in ("python", "torch", "backend", "device_kind")} == \
            {k: info[k] for k in ("python", "torch", "backend", "device_kind")}
        assert s["device"] == "cpu" and s["device_count"] == 1 and "git_sha" in s
    cards = [e for e in events if e["event"] == "program_card"]
    assert len(cards) == 2 and all(c["name"] == "train_step" for c in cards)
    for c in cards:
        assert c["flops"] > 0 and c["argument_bytes"] > 0
        assert c["peak_bytes"] is None and c["partial"] is True  # no capture on the CPU
    assert reg.histogram("train_achieved_flops_per_sec").count == 3

    (tmp_path / "off").mkdir()
    off = write_configs(tmp_path / "off", corpus, obs={"program_card": False})
    cfg = load_config(off["preprocess"], off["model"], off["train"])
    reg = obs.MetricsRegistry()
    run_training(cfg, device="cpu", max_steps=1, registry=reg)
    assert not [e for e in obs.read_events(str(tmp_path / "off" / "log"))
                if e["event"] == "program_card"]
    assert reg.histogram("train_achieved_flops_per_sec").count == 0
