"""PyTorch port, one train step with hash dropout on, against the JAX
package.

The JAX package draws each dropout site's salt from its module's
``make_rng("dropout")``. An eager (unjitted) forward records those salts
in call order; the port's model, whose dropout sites run in the same
order, takes them from a stand-in for ``DropoutRNG``. With the same
salts the hash masks are the same bits (tests/test_torch_ops.py), so the
step's losses and per-leaf gradients agree as in the dropout-off
comparison of tests/test_torch_training.py: losses 1e-5 relative,
gradients 1e-4. The paper preset's rates are used (0.2 / 0.1 / 0.5, and
the postnet's fixed 0.5).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_training import MODEL_YAML, load_both, write_configs
from test_torch_models import one_cpu_thread  # noqa: F401 (an autouse fixture)

DROPOUT_MODEL = dict(
    MODEL_YAML, attention_kernel="einsum", conv_impl="xla",
    transformer=dict(MODEL_YAML["transformer"], encoder_dropout=0.2, decoder_dropout=0.2),
    reference_encoder=dict(MODEL_YAML["reference_encoder"], dropout=0.1),
    variance_predictor=dict(MODEL_YAML["variance_predictor"], dropout=0.5),
)


class RecordedSalts:
    """Stands in for ``DropoutRNG``: hands out the JAX package's salts in
    the order they were drawn."""

    def __init__(self, salts):
        self.salts = list(salts)

    def salt(self) -> int:
        return self.salts.pop(0)


def test_train_step_with_hash_dropout_matches_jax(tmp_path, monkeypatch):
    hash_dropout_step(tmp_path, monkeypatch, remat=False)


def test_remat_train_step_with_hash_dropout_matches_jax_remat(tmp_path, monkeypatch):
    """The same step with ``sharding.remat`` on both sides: the port's
    checkpointed FFT blocks recompute their forward in the backward with
    the forward's dropout masks (``ops.dropout.ReplayRNG``), and the JAX
    package's ``nn.remat`` blocks draw theirs from the same keys. The salts
    are recorded from the JAX model without remat (a remat block traces
    its body, so no salt can be read from it); the same sites draw the
    same salts, which the matching gradients confirm."""
    hash_dropout_step(tmp_path, monkeypatch, remat=True)


def hash_dropout_step(tmp_path, monkeypatch, remat: bool):
    from speakingstyle_tpu.data.dataset import BucketedBatcher, SpeechDataset
    from speakingstyle_tpu.models.factory import build_model as j_build, init_variables
    from speakingstyle_tpu.models.loss import fastspeech2_loss as j_loss
    from speakingstyle_tpu.ops import dropout as j_dropout
    from speakingstyle_tpu.training.trainer import _model_kwargs
    from speakingstyle_torch.compat.from_jax import load_flax_variables, to_flax_tree
    from speakingstyle_torch.data.synthetic import generate_corpus
    from speakingstyle_torch.models.factory import build_model as t_build
    from speakingstyle_torch.training.trainer import compute_losses, to_device, trainable

    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=8, val_utts=2,
                             n_phones_per_utt=(6, 11), duration_range=(1, 3), seed=6)
    paths = write_configs(tmp_path, corpus, sharding={"remat": remat})
    (tmp_path / "model.yaml").write_text(__import__("yaml").safe_dump(DROPOUT_MODEL))
    jcfg, tcfg = load_both(paths)
    assert tcfg.model.dropout_impl == "hash" and tcfg.model.transformer.encoder_dropout == 0.2
    assert jcfg.train.sharding.remat == tcfg.train.sharding.remat == remat
    jmodel = j_build(jcfg)
    plain = dataclasses.replace(jcfg.train, sharding=dataclasses.replace(jcfg.train.sharding,
                                                                         remat=False))
    recorder = j_build(dataclasses.replace(jcfg, train=plain))
    variables = jax.device_get(init_variables(jmodel, jcfg, jax.random.PRNGKey(4)))
    batch = next(iter(BucketedBatcher(SpeechDataset("train.txt", jcfg, sort=True,
                                                    drop_last=True),
                                      max_src=64, max_mel=64, seed=1)))
    arrays = batch.arrays()
    key = jax.random.PRNGKey(11)

    def j_losses(params, model=jmodel):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              **_model_kwargs(arrays, teacher_forced=True),
                              deterministic=False, rngs={"dropout": key},
                              mutable=["batch_stats"])
        losses = j_loss(out, arrays["mels"], arrays["pitches"], arrays["energies"],
                        arrays["durations"], params, lambda_f=jcfg.train.loss.lambda_f)
        return losses["total_loss"], losses

    salts = []
    keep_mask = j_dropout.keep_mask

    def recording(rng, rate, shape, impl="bernoulli"):
        # the salt keep_mask draws from this key (ops/dropout.py:74)
        salts.append(int(jax.random.bits(rng, (), jnp.uint32)))
        return keep_mask(rng, rate, shape, impl)  # jaxlint: disable=JL006

    monkeypatch.setattr(j_dropout, "keep_mask", recording)
    j_losses(variables["params"], recorder)  # eager: records every site's salt
    monkeypatch.setattr(j_dropout, "keep_mask", keep_mask)
    # (1 + 1 + 2) FFT blocks x 2 sites, 2 reference convs, 3 predictors x 2,
    # 3 postnet layers
    assert len(salts) == 2 * (1 + 1 + 2) + 2 + 6 + 3
    (_, want), grads = jax.jit(jax.value_and_grad(j_losses, has_aux=True))(variables["params"])

    tmodel = load_flax_variables(t_build(tcfg), copy.deepcopy(variables))
    got = compute_losses(tmodel, tcfg, to_device(arrays, torch.device("cpu")),
                         deterministic=False, rng=RecordedSalts(salts))
    t_grads = torch.autograd.grad(got["total_loss"], trainable(tmodel))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v), rtol=1e-5, err_msg=k)
    tree = to_flax_tree(tmodel, {id(p): g for p, g in zip(trainable(tmodel), t_grads)})["params"]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat_got) == len(flat_want)
    for path, g in flat_want:
        np.testing.assert_allclose(flat_got[path], np.asarray(g), atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
