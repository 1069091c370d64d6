"""PyTorch port, data-parallel training: a 2-rank step (two processes over
gloo on the CPU, ``tests/torch_dp.py``) against the JAX package's step on a
``data = 2`` mesh of two of the conftest's virtual CPU devices, and against
the port's one-process step; the ranks' hash-dropout masks against the JAX
mask of the global shape; the vocoder's 2-rank GAN step against the JAX
package's GAN step on the same ``data = 2`` mesh (at
``tests/test_torch_vocoder.py``'s tolerances) and, through the loop, against
its one-process step.

The batch is cut as ``run_training`` cuts it at dp = 2 (``batch_pad_multiple
= 2``), and its two halves hold different numbers of valid frames, so a
step that averaged the ranks' own masked means (what DDP's averaging gives)
would fail the loss and gradient bounds. Tolerances are those of
``tests/test_torch_training.py::three_train_steps``: losses 1e-5 relative,
gradients 1e-4 absolute, parameters and BatchNorm statistics 1e-5 with the
rounding-level allowance stated there.
"""

import copy
import pickle
import re

import jax
import numpy as np
import pytest
import yaml

from test_torch_training import (  # noqa: F401 (corpus: a fixture)
    MODEL_YAML, NOISE_SHARE, corpus, load_both, no_jax_postnet_dropout, write_configs,
)
from test_torch_vocoder import (  # noqa: F401 (wav_dir: a fixture)
    PERIODS, SEG, SMALL_GEN, assert_gan_step_matches, configs, jax_tree, jax_vocoder,
    port_vocoder, wav_dir, wave,
)
from torch_dp import run_ranks
from torch_threads import no_tensorflow, one_cpu_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("no_tensorflow")

STEPS = 3


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_steps_match(got_steps, want_steps, lrs, loss_rtol=1e-5):
    """three_train_steps' bounds, step by step: ``want_steps`` are dicts of
    host trees (``losses``, ``grads``, ``params``, ``batch_stats``), the
    reference side; ``got_steps`` the port rank's. ``loss_rtol``: the
    losses' bound (1e-5 unless a caller states its own)."""
    noise, lr_sum = {}, 0.0
    bn_mean = re.compile(r"\['bn_(\d+)'\]\['mean'\]$")
    for step, (got, want) in enumerate(zip(got_steps, want_steps)):
        lr_sum += lrs[step]
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=loss_rtol,
                                       err_msg=f"step {step} {k}")
        # the rounding-level gradients (three_train_steps' rule), here
        # including an exact 0: one side's sum of float32 terms may cancel
        # exactly where the other's, in another order, leaves ~1e-9
        w_abs = {k: np.abs(v) for k, v in leaves(want["grads"]).items()}
        top = max(a.max() for a in w_abs.values())
        for k, a in w_abs.items():
            noise[k] = noise.get(k, False) | (a <= NOISE_SHARE * top)
        for name, tol in (("grads", dict(atol=1e-4)), ("params", dict(atol=1e-5, rtol=1e-5)),
                          ("batch_stats", dict(atol=1e-5, rtol=1e-5))):
            g_flat, w_flat = leaves(got[name]), leaves(want[name])
            assert g_flat.keys() == w_flat.keys(), name
            for k, w in w_flat.items():
                g, msg = g_flat[k], f"step {step} {name} {k}"
                mask = allowance = None
                if name == "params":
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


def rank_steps(result):
    """A rank's ``train_steps`` records as the comparison's dicts."""
    return [{"losses": r["losses"], "grads": r["grads"]["params"],
             "params": r["after"]["params"], "batch_stats": r["after"]["batch_stats"]}
            for r in result]


def check_replicas_and_halves(ranks):
    """Both ranks hold the same weights after every step, and the halves of
    the first batch hold different numbers of valid frames."""
    for s in range(STEPS):
        assert ranks[0][s]["digest"] == ranks[1][s]["digest"], s
        assert ranks[0][s]["rows"] == ranks[1][s]["rows"] == 2
    assert ranks[0][0]["mel_frames"] != ranks[1][0]["mel_frames"]


def test_two_rank_step_equals_the_jax_mesh_step(tmp_path, corpus, no_jax_postnet_dropout):
    """The headline: three chained steps of two port ranks from the JAX
    init's weights against the JAX package's ``make_train_step`` on a
    ``make_mesh(data=2, model=1)`` of two virtual CPU devices (losses, the
    parameters and BatchNorm statistics after each step), and against the
    gradients of the same loss under the same shardings (GSPMD: the state
    replicated, the batch over ``data``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from speakingstyle_tpu.data.dataset import BucketedBatcher, SpeechDataset
    from speakingstyle_tpu.models.factory import build_model as j_build, init_variables
    from speakingstyle_tpu.models.loss import fastspeech2_loss as j_loss
    from speakingstyle_tpu.parallel import make_mesh
    from speakingstyle_tpu.training import TrainState, make_optimizer, make_train_step
    from speakingstyle_tpu.training.trainer import _model_kwargs
    from speakingstyle_torch.training.optim import make_lr_schedule

    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4})
    jcfg, tcfg = load_both(paths)
    jmodel = j_build(jcfg)
    with jax.default_prng_impl("threefry2x32"):
        variables = jax.device_get(init_variables(jmodel, jcfg, jax.random.PRNGKey(3)))
    with open(tmp_path / "variables.pkl", "wb") as fh:
        pickle.dump(jax.tree_util.tree_map(np.asarray, variables), fh)
    ranks = run_ranks("train_steps", 2, tmp_path, paths=paths, steps=STEPS,
                      variables=str(tmp_path / "variables.pkl"))

    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    tx = make_optimizer(jcfg.train)

    def grads_of(params, batch_stats, arrays, key):
        def loss_fn(p):
            out, upd = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                    **_model_kwargs(arrays, teacher_forced=True),
                                    deterministic=False, rngs={"dropout": key},
                                    mutable=["batch_stats"])
            return j_loss(out, arrays["mels"], arrays["pitches"], arrays["energies"],
                          arrays["durations"], p, lambda_f=jcfg.train.loss.lambda_f)["total_loss"]
        return jax.grad(loss_fn)(params)

    grads_of = jax.jit(grads_of, in_shardings=(repl, repl, data, repl), out_shardings=repl)
    step = make_train_step(jmodel, tx, jcfg, mesh=mesh)
    state = jax.device_put(TrainState.create(copy.deepcopy(variables), tx), repl)
    batches = iter(BucketedBatcher(SpeechDataset("train.txt", jcfg, sort=True, drop_last=True),
                                   max_src=64, max_mel=64, batch_pad_multiple=2,
                                   seed=jcfg.train.seed))
    want = []
    for s in range(STEPS):
        arrays = next(batches).arrays()
        grads = jax.device_get(grads_of(state.params, state.batch_stats, arrays,
                                        jax.random.PRNGKey(1)))
        state, losses = step(state, arrays, jax.random.PRNGKey(1))
        assert bool(losses["_finite"])
        host = jax.device_get(state)
        want.append({"losses": {k: float(v) for k, v in losses.items() if k != "_finite"},
                     "grads": grads, "params": host.params, "batch_stats": host.batch_stats})
    check_replicas_and_halves(ranks)
    lrs = [make_lr_schedule(tcfg.train)(s) for s in range(STEPS)]
    assert_steps_match(rank_steps(ranks[0]), want, lrs)


def test_two_rank_step_equals_the_one_process_step(tmp_path, corpus):
    """Two ranks against one process (``make_train_step`` without a mesh)
    from the same seeded weights, with hash dropout at 0.2 in the encoder,
    the decoder and the postnet: the ranks' masks are the global batch's
    rows, their BatchNorm statistics the global batch's."""
    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4})
    model = dict(MODEL_YAML, transformer=dict(MODEL_YAML["transformer"], encoder_dropout=0.2,
                                              decoder_dropout=0.2))
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(model))
    ranks = run_ranks("train_steps", 2, tmp_path, paths=paths, steps=STEPS)
    (tmp_path / "one").mkdir()
    one = run_ranks("train_steps", 1, tmp_path / "one", paths=paths, steps=STEPS)[0]
    check_replicas_and_halves(ranks)
    from speakingstyle_torch.training.optim import make_lr_schedule

    tcfg = load_both(paths)[1]
    assert tcfg.model.dropout_impl == "hash"
    lrs = [make_lr_schedule(tcfg.train)(s) for s in range(STEPS)]
    assert_steps_match(rank_steps(ranks[0]), rank_steps(one), lrs)


@pytest.mark.parametrize("shape,rate", [((4, 7, 16), 0.2), ((6, 5), 0.5), ((2, 3, 4, 9), 0.1)])
def test_rank_slices_of_the_hash_mask_are_the_jax_global_mask(shape, rate, monkeypatch):
    """Rank r's mask of its rows (``row_offset = r * b``) is rows [r b, (r +
    1) b) of the JAX package's hash mask of the global shape, for one salt
    (JAX's salt draw replaced by it), at dp 2 and (where the rows divide) 3."""
    import jax.numpy as jnp

    from speakingstyle_tpu.ops import dropout as j_dropout
    from speakingstyle_torch.ops.dropout import keep_mask

    salt = int(np.random.default_rng(sum(shape)).integers(0, 1 << 32))
    monkeypatch.setattr(j_dropout.jax.random, "bits",
                        lambda key, shape=(), dtype=None: jnp.uint32(salt))
    want = np.asarray(j_dropout.keep_mask(jax.random.PRNGKey(0), rate, shape, "hash"))
    for dp in (d for d in (2, 3) if shape[0] % d == 0):
        b = shape[0] // dp
        for r in range(dp):
            got = keep_mask(rate, (b, *shape[1:]), "hash", salt=salt, row_offset=r * b)
            np.testing.assert_array_equal(got.numpy(), want[r * b:(r + 1) * b],
                                          err_msg=f"dp {dp} rank {r}")
    assert 0 < want.mean() < 1


def test_vocoder_two_rank_step_equals_the_one_process_step(tmp_path, wav_dir):
    """``train_vocoder`` with a 2-rank mesh (the global batch's crops, each
    rank its rows, both updates' gradients averaged over the ranks) against
    one process on the same seed, two steps at lr 0: the metrics of each
    step and every gradient an update applied, within 1e-5 of the update's
    largest element (a leaf whose gradient cancels to ~1e-6 of that, as the
    generator's first conv's, carries the rounding of its larger terms).
    At lr 0 the weights the gradients are taken at stay equal; at a real lr
    Adam moves a rounding-level gradient's parameter by up to 2 lr either
    way, and the GAN's later gradients follow those moves. Then two steps at
    the recipe's lr: the ranks' states are equal."""
    kw = dict(wav_dir=str(wav_dir), steps=2, batch_size=2, segment=SEG)
    two = run_ranks("vocoder_steps", 2, tmp_path, learning_rates=[0.0, 2e-4], **kw)
    (tmp_path / "one").mkdir()
    one = run_ranks("vocoder_steps", 1, tmp_path / "one", learning_rates=[0.0], **kw)[0][0]
    frozen, trained = two[0]
    assert frozen["digest"] == two[1][0]["digest"] and trained["digest"] == two[1][1]["digest"]
    assert frozen["step"] == trained["step"] == one["step"] == 2
    assert trained["digest"] != frozen["digest"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(frozen["metrics"][k], v, rtol=1e-5, err_msg=k)
    assert len(frozen["grads"]) == len(one["grads"]) == 4  # disc, gen per step
    for call, (got, want) in enumerate(zip(frozen["grads"], one["grads"])):
        top = max(np.abs(w).max() for w in want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, atol=1e-5 * top, err_msg=f"update {call} tensor {i}")


def test_vocoder_two_rank_step_equals_the_jax_mesh_step(tmp_path):
    """One GAN step of two port ranks (each its two rows of a global batch
    of four, both updates' gradients averaged over the ranks) against the
    JAX package's ``make_vocoder_train_step`` on a ``make_mesh(data=2,
    model=1)`` of two virtual CPU devices (the state replicated, the wavs
    and mels over ``data``), from the same weights: the metrics (the ranks'
    mean), every updated parameter, the optimizer moments and counts and
    the spectral-norm state, as ``test_one_gan_step_matches_jax`` holds one
    process. Both ranks end with equal states."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from speakingstyle_torch.training.vocoder_trainer import save_vocoder, state_tree
    from speakingstyle_tpu.parallel import make_mesh
    from speakingstyle_tpu.training.vocoder_trainer import (
        VocoderHParams, make_vocoder_train_step as j_make,
    )

    jcfg, _ = configs()
    hp = VocoderHParams(segment_size=SEG)
    t_state = port_vocoder(seed=9)
    save_vocoder(str(tmp_path / "vocoder.msgpack"), t_state)
    rng = np.random.default_rng(10)
    wavs = wave(rng, 4)
    mels = rng.standard_normal((4, SEG // 256, 80)).astype(np.float32) - 4.0
    np.savez(tmp_path / "batch.npz", wavs=wavs, mels=mels)
    ranks = run_ranks("vocoder_gan_step", 2, tmp_path, state_path=str(tmp_path / "vocoder.msgpack"),
                      batch_path=str(tmp_path / "batch.npz"), gen=SMALL_GEN, periods=PERIODS,
                      n_scales=2, segment=SEG)
    assert ranks[0]["digest"] == ranks[1]["digest"]

    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    j_state, gen, mpd, msd, gen_tx, disc_tx = jax_vocoder(state_tree(t_state))
    before = jax_tree(j_state)
    j_state = jax.device_put(j_state, NamedSharding(mesh, P()))
    data = NamedSharding(mesh, P("data"))
    j_step = j_make(jcfg, hp, gen, mpd, msd, gen_tx, disc_tx, mesh=mesh)
    j_state, j_metrics = j_step(j_state, jax.device_put(wavs, data), jax.device_put(mels, data))
    assert_gan_step_matches(ranks[0]["metrics"], ranks[0]["tree"], j_metrics,
                            jax_tree(j_state), before, hp)
