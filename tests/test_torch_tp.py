"""PyTorch port, tensor-parallel training over the mesh's ``model`` axis:
rank processes over gloo on the CPU (``tests/torch_dp.py``) against the
JAX package's GSPMD steps on meshes of the conftest's virtual CPU devices,
and against the port's one-process step.

* The layout: the JAX rules pick the same leaves by Flax path
  (``count_sharded`` >= 8, ``tests/test_parallel.py:162``'s check), an
  override is prepended (``tests/test_multichip.py:86``'s twin).
* The collectives: ``gather_param``'s backward is this rank's slice of the
  whole gradient, ``copy_to_tp`` / ``reduce_from_tp`` sum where they should.
* A (dp, tp) = (1, 2) step and a (2, 2) step against the JAX package's
  ``make_mesh(data, model=2)`` steps built with ``train_state_shardings``
  (the library path: the JAX side's Pallas kernels would run interpreted
  under GSPMD), the gradients against the JAX loss's on one device (the
  math GSPMD keeps): losses within rtol 2e-4 (``tests/test_parallel.py:162``'s
  bound), the gathered gradients, parameters and BatchNorm statistics
  within ``tests/test_torch_dp_parity.py``'s bounds.
* The kernel path (the kernels' plain versions on the CPU) with hash
  dropout, against one process: the tp ranks draw the same masks, and the
  clip's global norm counts each split leaf once; at tp = 4 (the encoder's
  and decoder's 2 heads do not split, so they gather; the reference
  encoder's 4 split one a rank) under remat, through the collectives; and
  with an override that splits q/k/v by input, not a column / row pair.

The model: 2 encoder and 2 decoder layers of d_model 64 with 2 heads (the
preset's), the reference encoder's one layer with 4 heads, 128 filters.
* Checkpoints stay whole: (2, 2) -> (1, 1) and (1, 2) -> (2, 1) resume
  every leaf and Adam moment bit for bit (``tests/test_multichip.py:148``'s
  twin).
"""

import copy
import pickle

import jax
import numpy as np
import pytest
import torch

from test_torch_dp_parity import STEPS, assert_steps_match, rank_steps
from test_torch_multichip import assert_bit_identical, flat_state
from test_torch_training import (  # noqa: F401 (corpus: a fixture)
    MODEL_YAML, corpus, load_both, no_jax_postnet_dropout, write_configs,
)
from torch_dp import run_ranks
from torch_threads import no_tensorflow, one_cpu_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("no_tensorflow")

# tests/test_parallel.py:162: TP losses against DP's
TP_LOSS_RTOL = 2e-4
TP_MODEL = dict(
    MODEL_YAML,
    transformer=dict(MODEL_YAML["transformer"], encoder_layer=2, decoder_layer=2,
                     encoder_hidden=64, decoder_hidden=64, encoder_head=2, decoder_head=2,
                     conv_filter_size=128),
    reference_encoder=dict(MODEL_YAML["reference_encoder"], encoder_layer=1, encoder_head=4,
                           encoder_hidden=64, conv_filter_size=128),
    variance_predictor=dict(MODEL_YAML["variance_predictor"], filter_size=64))
TP_LIBRARY = dict(TP_MODEL, attention_kernel="einsum", conv_impl="xla")


def lrs_of(tcfg):
    from speakingstyle_torch.training.optim import make_lr_schedule

    return [make_lr_schedule(tcfg.train)(s) for s in range(STEPS)]


# ---------------------------------------------------------------- the layout


def test_layout_picks_the_jax_leaves(tmp_path, corpus):
    """The port's layout of the test model splits exactly the leaves the JAX
    package's ``tp_shardings`` shards, each on the dimension its Flax spec
    names (an nn.Linear kernel transposed), at model = 2 and, with the
    divisibility fallback, at model = 4; at least 8 of them at model = 2."""
    from flax.traverse_util import flatten_dict
    from jax.sharding import PartitionSpec as P

    from speakingstyle_torch.compat.from_jax import expected_leaves, flax_param_names
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.parallel.partition import count_sharded, tp_layout
    from speakingstyle_tpu.models.factory import build_model as j_build, init_variables
    from speakingstyle_tpu.parallel import make_mesh
    from speakingstyle_tpu.parallel.partition import tp_shardings

    jcfg, tcfg = load_both(write_configs(tmp_path, corpus, TP_LIBRARY))
    params = jax.eval_shape(lambda: init_variables(j_build(jcfg), jcfg,
                                                   jax.random.PRNGKey(0)))["params"]
    model = build_model(tcfg)
    paths = flax_param_names(model)
    perms = {"/".join(path[1:]): perm
             for path, (_, perm) in expected_leaves(model, ["params"]).items()}
    for tp in (2, 4):
        mesh = make_mesh(data=1, model=tp, devices=jax.devices()[:tp])
        specs = {k: v.spec for k, v in flatten_dict(tp_shardings(params, mesh), sep="/").items()}
        dims = tp_layout(model, tp)
        assert {paths[n] for n in dims} == set(specs)
        for name, dim in dims.items():
            spec, perm = specs[paths[name]], perms[paths[name]]
            want = None
            if spec != P():
                f = list(spec).index("model")
                want = f if perm is None else list(perm).index(f)
            assert dim == want, (tp, name, spec)
        assert count_sharded(model, tp) == sum(v != P() for v in specs.values())
    assert count_sharded(model, 2) >= 8


def test_parse_rule_overrides_prepend():
    """An override goes first and wins; the defaults follow unchanged, and
    its leaf is split where the defaults would replicate it."""
    from speakingstyle_torch.models.factory import build_model
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.parallel.partition import (
        DEFAULT_TP_RULES, parse_rule_overrides, tp_layout,
    )

    rules = parse_rule_overrides([["foo/kernel", "none,model"]])
    assert rules[0] == ("foo/kernel", (None, "model")) and rules[1:] == DEFAULT_TP_RULES
    assert parse_rule_overrides([]) is DEFAULT_TP_RULES
    model = build_model(load_config(preset="LJSpeech"))
    rules = parse_rule_overrides([[r"mel_linear/kernel$", "none,model"]])
    assert tp_layout(model, 2)["mel_linear.weight"] is None
    assert tp_layout(model, 2, rules)["mel_linear.weight"] == 0  # [80, 256]: out is dim 0


def test_tp_collectives_on_two_ranks(tmp_path):
    """``gather_param`` gathers exactly and its gradient is this rank's
    slice of the whole one (not a sum over tp); ``copy_to_tp``'s gradient
    and ``reduce_from_tp``'s output are the sums over the ranks,
    ``reduce_from_tp``'s gradient passes as it came."""
    ranks = run_ranks("tp_collectives", 2, tmp_path, tp=2)
    for r in ranks:
        assert torch.equal(r["gathered"], r["whole"])
        assert torch.equal(r["w_grad"], r["slice"])
        torch.testing.assert_close(r["x_grad"], ranks[0]["part"] + ranks[1]["part"])
        torch.testing.assert_close(r["reduced"], ranks[0]["y"] + ranks[1]["y"])
        assert torch.equal(r["y_grad"], r["part"])
    assert not torch.equal(ranks[0]["w_grad"], ranks[1]["w_grad"])


# ---------------------------------------------------------------- against the JAX mesh


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, corpus):
    """The library-path configs, seeded weights as a Flax variable tree
    (the port's init, carried by ``to_flax_tree``: no JAX init to compile;
    pickled for the ranks) and the JAX loss's gradient on one device,
    jitted once for both meshes."""
    from speakingstyle_torch.compat.from_jax import to_flax_tree
    from speakingstyle_torch.models.factory import build_model, init_weights
    from speakingstyle_tpu.models.factory import build_model as j_build
    from speakingstyle_tpu.models.loss import fastspeech2_loss as j_loss
    from speakingstyle_tpu.training.trainer import _model_kwargs

    root = tmp_path_factory.mktemp("tp_jax")
    paths = write_configs(root, corpus, TP_LIBRARY, optimizer={"batch_size": 4})
    jcfg, tcfg = load_both(paths)
    jmodel = j_build(jcfg)
    variables = to_flax_tree(init_weights(build_model(tcfg), 3))
    with open(root / "variables.pkl", "wb") as fh:
        pickle.dump(variables, fh)

    @jax.jit
    def grads_of(params, batch_stats, arrays, key):
        def loss_fn(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                  **_model_kwargs(arrays, teacher_forced=True),
                                  deterministic=False, rngs={"dropout": key},
                                  mutable=["batch_stats"])
            return j_loss(out, arrays["mels"], arrays["pitches"], arrays["energies"],
                          arrays["durations"], p, lambda_f=jcfg.train.loss.lambda_f)["total_loss"]
        return jax.grad(loss_fn)(params)

    return {"paths": paths, "jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "variables": variables, "pickle": str(root / "variables.pkl"), "grads": grads_of}


def jax_tp_steps(side, dp, tp):
    """STEPS of the JAX package's ``make_train_step`` on a (dp, tp) mesh of
    virtual CPU devices, the state laid out by ``train_state_shardings``,
    the batches as ``run_training`` cuts them at dp; and the gradient each
    step applies."""
    from speakingstyle_tpu.data.dataset import BucketedBatcher, SpeechDataset
    from speakingstyle_tpu.parallel import make_mesh
    from speakingstyle_tpu.parallel.partition import count_sharded, train_state_shardings
    from speakingstyle_tpu.training import TrainState, make_optimizer, make_train_step

    jcfg = side["jcfg"]
    mesh = make_mesh(data=dp, model=tp, devices=jax.devices()[:dp * tp])
    tx = make_optimizer(jcfg.train)
    state = TrainState.create(copy.deepcopy(side["variables"]), tx)
    sh = train_state_shardings(state, mesh)
    assert count_sharded(state.params, mesh) >= 8
    state = jax.tree_util.tree_map(jax.device_put, state, sh)
    step = make_train_step(side["jmodel"], tx, jcfg, mesh=mesh, state_shardings=sh)
    batches = iter(BucketedBatcher(SpeechDataset("train.txt", jcfg, sort=True, drop_last=True),
                                   max_src=64, max_mel=64, batch_pad_multiple=dp,
                                   seed=jcfg.train.seed))
    one = jax.devices()[0]
    want = []
    for _ in range(STEPS):
        arrays = next(batches).arrays()
        host = jax.device_get(state)
        grads = jax.device_get(side["grads"](*jax.device_put(
            (host.params, host.batch_stats, arrays, jax.random.PRNGKey(1)), one)))
        state, losses = step(state, arrays, jax.random.PRNGKey(1))
        assert bool(losses["_finite"])
        assert any("model" in str(v.sharding.spec)
                   for v in jax.tree_util.tree_leaves(state.params))
        host = jax.device_get(state)
        want.append({"losses": {k: float(v) for k, v in losses.items() if k != "_finite"},
                     "grads": grads, "params": host.params, "batch_stats": host.batch_stats})
    return want


@pytest.mark.parametrize("dp", [1, 2])
def test_tp_step_equals_the_jax_model_mesh_step(tmp_path, jax_side, no_jax_postnet_dropout, dp):
    """Three chained steps of dp x 2 port ranks from seeded weights
    against the JAX package's step on a (data = dp, model = 2) mesh: the
    losses within TP_LOSS_RTOL, the gradients (gathered whole over tp),
    the parameters and BatchNorm statistics after each step within the
    data-parallel parity's bounds; every rank holds the same whole state,
    and its own shards."""
    ranks = run_ranks("train_steps", 2 * dp, tmp_path, paths=jax_side["paths"], steps=STEPS,
                      variables=jax_side["pickle"], tp=2)
    want = jax_tp_steps(jax_side, dp, 2)
    for s in range(STEPS):
        assert len({r[s]["digest"] for r in ranks}) == 1, s
        assert ranks[0][s]["local_digest"] != ranks[1][s]["local_digest"], s
        assert [r[s]["rows"] for r in ranks] == [4 // dp] * 2 * dp
    assert_steps_match(rank_steps(ranks[0]), want, lrs_of(jax_side["tcfg"]),
                       loss_rtol=TP_LOSS_RTOL)


# ---------------------------------------------------------------- against one process


def dropout_configs(root, corpus, **train):
    """TP_MODEL (the kernels' path) with hash dropout 0.2 in the encoder
    and the decoder and 0.1 in the reference encoder, batch 4."""
    model = dict(TP_MODEL, transformer=dict(TP_MODEL["transformer"], encoder_dropout=0.2,
                                            decoder_dropout=0.2),
                 reference_encoder=dict(TP_MODEL["reference_encoder"], dropout=0.1))
    return write_configs(root, corpus, model, optimizer={"batch_size": 4}, **train)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, corpus):
    """The one-process steps of ``dropout_configs`` (what every case of
    the tp mesh is held to: at tp = 1 the partition rules and remat leave
    the numbers as they are)."""
    root = tmp_path_factory.mktemp("tp_one")
    paths = dropout_configs(root, corpus)
    return run_ranks("train_steps", 1, root, paths=paths, steps=STEPS, clip_norm=True)[0]


@pytest.mark.parametrize("case", ["tp2", "tp4_remat", "qkv_split_by_input"])
def test_tp_step_equals_the_one_process_step(tmp_path, corpus, one_process, case):
    """Ranks of a tp mesh against one process from the same seeded weights,
    on the kernels' path with hash dropout: every tp rank draws the one
    process's masks, and the clip's global norm of each step is the one
    process's. ``tp4_remat``: 4 ranks, so the encoder's and decoder's 2
    heads gather their split leaves while the reference encoder's 4 heads
    split one a rank and the FFN pairs split, with the FFT stacks
    recomputed in the backward through the collectives;
    ``qkv_split_by_input``: an override splits q/k/v by input, not a
    column / row pair, so every attention gathers."""
    train, tp = {}, 2
    if case == "tp4_remat":
        train["sharding"], tp = {"remat": True}, 4
    if case == "qkv_split_by_input":
        train["parallel"] = {"partition_rules": [[r".*slf_attn/(w_qs|w_ks|w_vs)/kernel$",
                                                  "model,none"]]}
    paths = dropout_configs(tmp_path, corpus, **train)
    ranks = run_ranks("train_steps", tp, tmp_path, paths=paths, steps=STEPS, tp=tp,
                      clip_norm=True)
    tcfg = load_both(paths)[1]
    assert tcfg.model.dropout_impl == "hash"
    for s in range(STEPS):
        assert len({r[s]["digest"] for r in ranks}) == 1, s
        for r in ranks:
            np.testing.assert_allclose(r[s]["clip_norm"], one_process[s]["clip_norm"],
                                       rtol=1e-6)
    assert_steps_match(rank_steps(ranks[0]), rank_steps(one_process), lrs_of(tcfg),
                       loss_rtol=TP_LOSS_RTOL)


# ---------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("src,dst", [((2, 2), (1, 1)), ((1, 2), (2, 1))])
def test_cross_mesh_resume_bit_identical(tmp_path, corpus, src, dst):
    """Two steps at (dp, tp) = ``src`` save step 2, whole; restored at
    ``dst`` every leaf and Adam moment is as saved, bit for bit (gathered
    whole again where ``dst`` splits them), and at (1, 1) a step runs from
    it."""
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import build_state, run_training

    paths = write_configs(tmp_path, corpus, TP_MODEL, optimizer={"batch_size": 4},
                          step={"val_step": 1000, "save_step": 2})
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    ranks = run_ranks("run", src[0] * src[1], tmp_path, paths=paths, max_steps=2, tp=src[1])
    assert len({r["digest"] for r in ranks}) == 1 and ranks[0]["step"] == 2
    saved = CheckpointManager(cfg.train.path.ckpt_path)
    want = flat_state(saved.restore(build_state(cfg, torch.device("cpu")), step=2))
    assert want["step"] == 2 and want["optimizer/count"] == 2
    if dst == (1, 1):
        got = [flat_state(saved.restore(build_state(cfg, torch.device("cpu")), step=2))]
        assert run_training(cfg, device="cpu", max_steps=3, restore_step=2).step == 3
    else:
        (tmp_path / "dst").mkdir()
        got = [r["state"] for r in run_ranks("restored", dst[0] * dst[1], tmp_path / "dst",
                                             paths=paths, step=2, tp=dst[1])]
    for state in got:
        assert_bit_identical(state, want)
