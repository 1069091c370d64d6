"""HiFi-GAN vocoder training: a discriminator step, then a generator step
(JAX counterpart: speakingstyle_tpu/training/vocoder_trainer.py).

Reference: hifigan/train.py:24-267. Each step:

1. the generator runs once on the batch's mels; the discriminators (MPD,
   MSD) score the real wavs and the detached generated ones, and the
   discriminator loss (LSGAN) updates them (``update_stats``: the first MSD
   scale's spectral-norm ``u`` moves on the real pass, then on the
   generated one);
2. the generator loss is scored against the UPDATED discriminators:
   adversarial + feature matching + 45 x mel-L1 through
   ``differentiable_mel`` (the MSD's ``u`` moves twice more, so four times
   a step, in the JAX package's order). The discriminators' parameters are
   frozen for this pass. The generated wav is the forward of step 1 (the
   JAX package applies the generator a second time on the same parameters:
   the same values).

The optimizers are ``optax.adamw(exponential_decay(2e-4, 1000, 0.999,
staircase=True), b1=0.8, b2=0.99, weight_decay=0.01)``, update for update
(``AdamW``). Checkpoints are the JAX package's files: ``save_vocoder``
writes ``flax.serialization.to_bytes`` of its ``VocoderState`` (parameters,
spectral-norm state and the optax states in their ``to_state_dict``
layout) through compat/flax_msgpack.py, and a generator-only
``.generator.msgpack`` beside it; ``restore_vocoder`` reads either
package's.

Data parallelism (``mesh``: a joined ``parallel.mesh.Mesh``, one rank a
process) is the JAX step with a replicated state and data-sharded wavs and
mels: every rank draws the same global batch of crops and takes its rows,
and each of the two updates all-reduces its gradients into the global
batch's mean (every loss is a mean over equal shards) before it applies
them, so the discriminators the generator step scores against, and the
spectral-norm state, are the same on every rank. Rank 0 alone logs and
writes checkpoints; the ranks agree on the logged metrics, a rollback and
a SIGTERM stop, and check at the end that their states are equal.
"""

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from speakingstyle_torch.configs.config import Config
from speakingstyle_torch.models.hifigan import Generator
from speakingstyle_torch.models.hifigan_disc import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    init_spectral_stats,
)


class VocoderHParams(NamedTuple):
    """Training hyperparameters (reference: hifigan/config.json:2-13)."""

    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    lr_decay_steps: int = 1000  # decay interval in steps (torch decays per epoch)
    segment_size: int = 8192
    mel_loss_weight: float = 45.0


WEIGHT_DECAY = 0.01  # torch AdamW's default, as the reference recipe has it


def exponential_decay(hp: VocoderHParams) -> Callable[[int], float]:
    """optax ``exponential_decay(lr, lr_decay_steps, lr_decay,
    staircase=True)`` in its float32 arithmetic: lr * decay^floor(count /
    steps)."""
    f32 = np.float32

    def schedule(count: int) -> float:
        p = np.floor(f32(count) / f32(hp.lr_decay_steps))
        return float(f32(hp.learning_rate) * np.power(f32(hp.lr_decay), f32(p)))

    return schedule


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay)`` over a fixed,
    ordered list of parameters, updated in place: Adam's bias-corrected
    step, plus weight_decay times the pre-update parameter, times -lr (the
    lr read at the count before the increment)."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 b1: float, b2: float, eps: float = 1e-8, weight_decay: float = WEIGHT_DECAY):
        self.params: List[torch.Tensor] = list(params)
        self.schedule, self.b1, self.b2, self.eps, self.wd = schedule, b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(step, self.params, alpha=self.wd)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(self.params, step)


@dataclass
class VocoderState:
    """The GAN's state: the three networks (the MSD holding its
    spectral-norm state as buffers) and the two optimizers, updated in place."""

    step: int
    gen: Generator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    gen_opt: AdamW
    disc_opt: AdamW


def differentiable_mel(cfg: Config):
    """wav [B, T] -> log-mel [B, n_frames, n_mels], differentiable: the
    port's ``stft_magnitude`` (unfold + rfft + abs), the mel filterbank and
    ``dynamic_range_compression``, the transform of the preprocessor and
    ``MelExtractor``."""
    from speakingstyle_torch.audio.mel import mel_filterbank
    from speakingstyle_torch.audio.stft import dynamic_range_compression, stft_magnitude

    pp = cfg.preprocess.preprocessing
    fb = torch.from_numpy(mel_filterbank(pp.audio.sampling_rate, pp.stft.filter_length,
                                         pp.mel.n_mel_channels, pp.mel.mel_fmin,
                                         pp.mel.mel_fmax))

    def mel_fn(wav):
        mag = stft_magnitude(wav, pp.stft.filter_length, pp.stft.hop_length,
                             pp.stft.win_length)  # [B, F, T]
        mel = torch.einsum("mf,bft->btm", fb.to(wav.device), mag)
        return dynamic_range_compression(mel)

    return mel_fn


def init_vocoder_state(cfg: Config, hp: VocoderHParams = VocoderHParams(), seed: int = 0,
                       gen_params: Optional[Dict] = None, gen: Optional[Generator] = None,
                       mpd: Optional[MultiPeriodDiscriminator] = None,
                       msd: Optional[MultiScaleDiscriminator] = None,
                       device=None) -> VocoderState:
    """Models and optimizers on ``device`` (default ``cuda``), weights drawn
    from ``seed``. ``gen_params`` (a Flax params tree) warm-starts the
    generator; ``gen`` (e.g. ``generator_from_config`` of a checkpoint's
    config.json) sets its topology, ``mpd`` / ``msd`` the discriminators'
    (the defaults are the reference recipe)."""
    from speakingstyle_torch.compat.from_jax import load_flax_variables
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.models.factory import init_weights

    device = resolve_device(device)
    n_mels = cfg.preprocess.preprocessing.mel.n_mel_channels
    gen = gen if gen is not None else Generator(n_mels=n_mels)
    mpd = mpd if mpd is not None else MultiPeriodDiscriminator()
    msd = msd if msd is not None else MultiScaleDiscriminator()
    if gen_params is None:
        init_weights(gen, seed)
    else:
        load_flax_variables(gen, {"params": gen_params})
    init_weights(mpd, seed + 1)
    init_spectral_stats(init_weights(msd, seed + 2), seed + 3)
    gen, mpd, msd = (m.to(device).train() for m in (gen, mpd, msd))
    schedule = exponential_decay(hp)
    mk_opt = lambda params: AdamW(params, schedule, hp.adam_b1, hp.adam_b2)
    return VocoderState(step=0, gen=gen, mpd=mpd, msd=msd, gen_opt=mk_opt(gen.parameters()),
                        disc_opt=mk_opt(list(mpd.parameters()) + list(msd.parameters())))


@contextlib.contextmanager
def frozen(*modules: nn.Module):
    """The modules' parameters out of the autograd graph for the block."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _global_mean(grads, mesh):
    """The ranks' mean gradients (in place, flat buckets) where ``mesh``
    has more than one rank."""
    if mesh is not None and mesh.dp > 1:
        grads = list(grads)
        mesh.all_reduce_(grads)
        torch._foreach_div_(grads, float(mesh.dp))
    return grads


def make_vocoder_train_step(cfg: Config, hp: VocoderHParams = VocoderHParams(), mesh=None):
    """fn(state, wavs [B, S], mels [B, S / hop, M]) -> metrics: one GAN
    step in place on ``state``; the metrics stay on the device (a rank's
    under data parallelism, where ``wavs`` and ``mels`` are its rows)."""
    mel_fn = differentiable_mel(cfg)

    def step(state: VocoderState, wavs: torch.Tensor, mels: torch.Tensor) -> Dict:
        mpd, msd = state.mpd, state.msd
        y_hat = state.gen(mels)[:, : wavs.shape[1]]

        # the discriminator step, on the detached generated wav
        y_d = y_hat.detach()
        pr, pg, _, _ = mpd(wavs, y_d)
        sr, sg, _, _ = msd(wavs, y_d, update_stats=True)
        d_loss = discriminator_loss(pr, pg) + discriminator_loss(sr, sg)
        state.disc_opt.update(_global_mean(
            torch.autograd.grad(d_loss, state.disc_opt.params), mesh))

        # the generator step, against the updated discriminators
        with frozen(mpd, msd):
            mel_g = mel_fn(y_hat)
            mel_r = mel_fn(wavs)
            T = min(mel_g.shape[1], mels.shape[1])
            loss_mel = torch.mean(torch.abs(mel_r[:, :T] - mel_g[:, :T]))
            _, pg, pf_r, pf_g = mpd(wavs, y_hat)
            _, sg, sf_r, sf_g = msd(wavs, y_hat, update_stats=True)
            loss_adv = generator_adversarial_loss(pg) + generator_adversarial_loss(sg)
            loss_fm = feature_matching_loss(pf_r, pf_g) + feature_matching_loss(sf_r, sf_g)
            g_loss = loss_adv + loss_fm + hp.mel_loss_weight * loss_mel
            g_grads = torch.autograd.grad(g_loss, state.gen_opt.params)
        state.gen_opt.update(_global_mean(g_grads, mesh))
        state.step += 1
        return {"disc_loss": d_loss.detach(), "gen_loss": g_loss.detach(),
                "mel_l1": loss_mel.detach(), "adv_loss": loss_adv.detach(),
                "fm_loss": loss_fm.detach()}

    return step


# ---------------------------------------------------------------- checkpoints


def _params_of(module: nn.Module, tensors=None) -> Dict:
    from speakingstyle_torch.compat.from_jax import to_flax_tree

    return to_flax_tree(module, tensors, collections=("params",))["params"]


def _opt_tree(opt: AdamW, modules: Dict[str, nn.Module]) -> Dict:
    """optax's adamw state in its ``to_state_dict`` layout: (ScaleByAdamState,
    EmptyState of the decayed weights, ScaleByScheduleState). ``modules``
    names the parameter trees ({"": gen} for one tree, else the keys of a
    dict of trees)."""
    count = np.asarray(opt.count, np.int32)
    trees = {}
    for name, moments in (("mu", opt.mu), ("nu", opt.nu)):
        by_param = dict(zip(map(id, opt.params), moments))
        t = {k: _params_of(m, by_param) for k, m in modules.items()}
        trees[name] = t[""] if "" in t else t
    return {"0": {"count": count, "mu": trees["mu"], "nu": trees["nu"]}, "1": {},
            "2": {"count": count}}


def state_tree(state: VocoderState) -> Dict:
    """The Flax state dict of the JAX package's VocoderState for ``state``:
    numpy arrays, float32 leaves and int32 counts."""
    from speakingstyle_torch.compat.from_jax import to_flax_tree

    msd = to_flax_tree(state.msd)
    return {
        "step": np.asarray(state.step, np.int32),
        "gen_params": _params_of(state.gen),
        "mpd_params": _params_of(state.mpd),
        "msd_params": msd["params"],
        "msd_stats": msd["batch_stats"],
        "gen_opt": _opt_tree(state.gen_opt, {"": state.gen}),
        "disc_opt": _opt_tree(state.disc_opt, {"mpd": state.mpd, "msd": state.msd}),
    }


def save_vocoder(path: str, state: VocoderState) -> str:
    """``path`` (the whole VocoderState) and ``path + ".generator.msgpack"``
    (the generator's params), both in Flax's msgpack format (reference:
    hifigan/train.py:158-176). Returns the generator file's path."""
    import os

    from speakingstyle_torch.compat.flax_msgpack import to_bytes

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = state_tree(state)
    with open(path, "wb") as f:
        f.write(to_bytes(tree))
    gen_path = path + ".generator.msgpack"
    with open(gen_path, "wb") as f:
        f.write(to_bytes(tree["gen_params"]))
    return gen_path


def _load_params(module: nn.Module, tree, collection: str = "params") -> None:
    from speakingstyle_torch.compat.from_jax import load_flax_variables

    load_flax_variables(module, {collection: tree}, collections=(collection,))


def _load_opt(opt: AdamW, modules: Dict[str, nn.Module], tree: Dict) -> None:
    from speakingstyle_torch.compat.from_jax import load_flax_variables

    adam = tree["0"]
    for name, moments in (("mu", opt.mu), ("nu", opt.nu)):
        by_param = dict(zip(map(id, opt.params), moments))
        for key, m in modules.items():
            sub = adam[name] if key == "" else adam[name][key]
            load_flax_variables(m, {"params": sub}, by_param, collections=("params",))
    if set(tree) != {"0", "1", "2"}:
        raise ValueError(f"optimizer state has entries {sorted(tree)}, want 0, 1, 2")
    opt.count = int(np.asarray(adam["count"]))


def load_state_tree(state: VocoderState, tree: Dict, where: str = "the tree",
                    tolerated=frozenset()) -> List:
    """Fill ``state`` in place from a VocoderState state dict, field by
    field. A field in ``tolerated`` that fails keeps its current value and
    is returned as (field, error); any other failure raises ValueError."""
    loaders = {
        "step": lambda t: setattr(state, "step", int(np.asarray(t))),
        "gen_params": lambda t: _load_params(state.gen, t),
        "mpd_params": lambda t: _load_params(state.mpd, t),
        "msd_params": lambda t: _load_params(state.msd, t),
        "msd_stats": lambda t: _load_params(state.msd, t, "batch_stats"),
        "gen_opt": lambda t: _load_opt(state.gen_opt, {"": state.gen}, t),
        "disc_opt": lambda t: _load_opt(state.disc_opt, {"mpd": state.mpd,
                                                          "msd": state.msd}, t),
    }
    kept_fresh = []
    for name, load in loaders.items():
        fresh = {id(t): t.detach().clone() for t in _field_tensors(state, name)}
        try:
            if tree.get(name) is None:
                raise KeyError(f"no {name!r} in the checkpoint")
            load(tree[name])
        except (ValueError, KeyError, TypeError) as e:
            for t in _field_tensors(state, name):  # undo a partial load
                t.detach().copy_(fresh[id(t)])
            if name not in tolerated:
                raise ValueError(
                    f"checkpoint {where} does not match the current VocoderState layout: "
                    f"field {name!r} failed to restore ({type(e).__name__}: {e}). This is "
                    "not a pre-r4 checkpoint (msd_stats "
                    f"{'missing' if tolerated else 'present'}), so no tolerant fallback "
                    "applies.") from e
            kept_fresh.append((name, f"{type(e).__name__}: {e}"))
    return kept_fresh


def _field_tensors(state: VocoderState, name: str) -> List[torch.Tensor]:
    if name == "msd_stats":
        return list(state.msd.buffers())
    if name.endswith("_params"):
        return list(getattr(state, name[: -len("_params")]).parameters())
    if name.endswith("_opt"):
        opt = getattr(state, name)
        return opt.mu + opt.nu
    return []


def restore_vocoder(path: str, state: VocoderState) -> VocoderState:
    """Fill ``state`` from a full-state checkpoint (either package's).

    Tolerant of exactly one kind of structure drift: checkpoints saved
    before the r4 spectral-norm addition, recognised by ``msd_stats``
    being absent. For those, ``msd_stats``, ``msd_params`` and ``disc_opt``
    keep their fresh values where they fail, with a warning naming each
    field and its error. Any other mismatch raises: a fresh discriminator
    trained against a restored generator under a restored step counter
    would pass for a resume."""
    from speakingstyle_torch.compat.flax_msgpack import msgpack_restore

    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    if not isinstance(raw, dict) or "gen_params" not in raw:
        raise ValueError(f"{path} is not a full VocoderState checkpoint")
    pre_r4 = "msd_stats" not in raw
    tolerated = {"msd_stats", "msd_params", "disc_opt"} if pre_r4 else set()
    kept_fresh = load_state_tree(state, {k: raw.get(k) for k in (
        "step", "gen_params", "mpd_params", "msd_params", "msd_stats", "gen_opt",
        "disc_opt")}, path, tolerated)
    for name, err in kept_fresh:
        print(f"[restore_vocoder] {path}: field {name!r} kept freshly-initialized ({err})")
    if pre_r4:
        print(f"[restore_vocoder] checkpoint {path} predates the r4 MSD spectral-norm state; "
              f"kept fresh: {[n for n, _ in kept_fresh]}")
    return state


# ---------------------------------------------------------------- the loop


def vocoder_tensors(state: VocoderState) -> List[torch.Tensor]:
    """Every tensor of the GAN state in a fixed order: the networks'
    parameters and buffers (the spectral-norm state), the optimizers'
    moments."""
    out = []
    for m in (state.gen, state.mpd, state.msd):
        out += list(m.parameters()) + list(m.buffers())
    for opt in (state.gen_opt, state.disc_opt):
        out += opt.mu + opt.nu
    return out


def vocoder_digest(state: VocoderState) -> str:
    """One sha256 over the networks' parameters and buffers."""
    from speakingstyle_torch.obs.buildinfo import weights_digest

    return weights_digest({k: m.state_dict() for k, m in
                           (("gen", state.gen), ("mpd", state.mpd), ("msd", state.msd))})


def train_vocoder(cfg: Config, wav_paths, hp: VocoderHParams = VocoderHParams(),
                  max_steps: int = 1000, batch_size: int = 16,
                  ckpt_path: Optional[str] = None, save_every: int = 1000,
                  log_every: int = 100, fine_tune_mel_dir: Optional[str] = None,
                  gen_params: Optional[Dict] = None, seed: int = 1234,
                  restore_path: Optional[str] = None, gen: Optional[Generator] = None,
                  mpd: Optional[MultiPeriodDiscriminator] = None,
                  msd: Optional[MultiScaleDiscriminator] = None, device=None, mesh=None):
    """The vocoder GAN loop (reference: hifigan/train.py:24-267); returns
    (state, the last step's metrics: the global batch's under data
    parallelism).

    ``restore_path`` resumes from a full-state checkpoint up to
    ``max_steps`` in all. The batch stream's seed is ``seed + step + 7919
    * retry``: a resumed run draws a fresh stream, a rolled-back one
    diverges past the window that tripped the sentinel. Resilience
    (``cfg.train.resilience``): SIGTERM/SIGINT end the loop with a flushed
    checkpoint, a final save always lands, non-finite metrics at a log
    boundary roll back to the last saved ``.msgpack`` (or the initial
    state, kept on the host) and raise past ``max_rollbacks`` consecutive
    trips; ``SPEAKINGSTYLE_FAULTS`` drills ``nan_grads`` (the step's wavs
    poisoned: rank 0's rows under data parallelism) and ``sigterm``. Each
    log line carries ``step_ms``, the mean wall time of the steps since the
    last line. ``mesh``: a joined data-parallel ``parallel.mesh.Mesh``
    (``batch_size`` is the global batch; the module docstring)."""
    from speakingstyle_torch.data.mel_dataset import MelWavDataset
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.parallel.mesh import check_replicas
    from speakingstyle_torch.training import faults, resilience

    mesh = mesh if mesh is not None and mesh.dp > 1 else None
    rows = slice(None)
    if mesh is not None:
        device = mesh.device
        rows = mesh.rows(batch_size)
    else:
        device = resolve_device(device)
    main = mesh is None or mesh.is_main
    say = print if main else (lambda *a, **k: None)
    res = cfg.train.resilience
    plan = faults.FaultPlan.from_env()
    state = init_vocoder_state(cfg, hp, seed, gen_params=gen_params, gen=gen, mpd=mpd,
                               msd=msd, device=device)
    if restore_path:
        restore_vocoder(restore_path, state)
        say(f"[vocoder] restored step {state.step} from {restore_path}")
    if mesh is not None:
        with torch.no_grad():
            mesh.broadcast_(vocoder_tensors(state))
    template = state_tree(state)  # the host copy a rollback without a checkpoint returns to
    train_step = make_vocoder_train_step(cfg, hp, mesh)

    def make_stream(retry: int):
        return iter(MelWavDataset(wav_paths, cfg, segment_size=hp.segment_size,
                                  batch_size=batch_size, fine_tune_mel_dir=fine_tune_mel_dir,
                                  seed=seed + state.step + 7919 * retry))

    def stop(shutdown) -> bool:
        return mesh.any(shutdown.requested) if mesh is not None else shutdown.requested

    def save(path: str) -> None:
        if main:
            save_vocoder(path, state)

    def restore(path: str) -> None:
        if mesh is not None:
            mesh.barrier()  # rank 0's write is in place
        restore_vocoder(path, state)

    stream = make_stream(0)
    guard = resilience.RollbackGuard(res.max_rollbacks)
    last_ckpt_file = restore_path
    last_saved_step = state.step if restore_path else None
    step = state.step
    metrics: Dict = {}
    t_window, n_window = time.perf_counter(), 0
    with resilience.GracefulShutdown() as shutdown:
        while step < max_steps and not stop(shutdown):
            try:
                wavs, mels = next(stream)
            except StopIteration:
                break
            wavs = torch.from_numpy(wavs[rows]).to(device)
            if plan.fire("nan_grads", step + 1) and main:
                wavs = wavs * float("nan")
            metrics = train_step(state, wavs, torch.from_numpy(mels[rows]).to(device))
            step = state.step
            n_window += 1
            if plan.fire("sigterm", step):
                faults.deliver_sigterm()
            if step % log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}  # syncs
                if mesh is not None:
                    keys = sorted(vals)
                    vals = {k: v / mesh.dp for k, v in zip(
                        keys, mesh.host_all_reduce([vals[k] for k in keys], "sum"))}
                step_ms = (time.perf_counter() - t_window) * 1e3 / n_window
                if res.nan_sentinel and not all(np.isfinite(v) for v in vals.values()):
                    n = guard.trip(step)  # raises past max_rollbacks
                    say(f"[vocoder] non-finite metrics at step {step}; rollback "
                        f"{n}/{res.max_rollbacks} to "
                        + (last_ckpt_file or "fresh init (no checkpoint yet)"))
                    if last_ckpt_file:
                        restore(last_ckpt_file)
                    else:
                        load_state_tree(state, template)
                    step = state.step
                    stream = make_stream(guard.count)
                    t_window, n_window = time.perf_counter(), 0
                    continue
                guard.ok()
                msg = ", ".join(f"{k}: {v:.4f}" for k, v in vals.items())
                say(f"[vocoder] step {step}: {msg}, step_ms: {step_ms:.6g}", flush=True)
                if mesh is not None:
                    metrics = vals
                t_window, n_window = time.perf_counter(), 0
            if ckpt_path and step % save_every == 0:
                last_ckpt_file = f"{ckpt_path}/vocoder_{step:08d}.msgpack"
                save(last_ckpt_file)
                last_saved_step = step
        # always flush a final checkpoint: the tail steps past the last
        # save, and the SIGTERM/SIGINT preemption path
        if ckpt_path and step > 0 and last_saved_step != step:
            last_ckpt_file = f"{ckpt_path}/vocoder_{step:08d}.msgpack"
            save(last_ckpt_file)
            last_saved_step = step
        if stop(shutdown):
            say(f"[vocoder] {shutdown.signame or 'SIGTERM'}: checkpoint flushed at step "
                f"{step} ({last_ckpt_file or 'no ckpt_path set'}); exiting", flush=True)
    if mesh is not None:
        digest = vocoder_digest(state)
        check_replicas(digest, mesh, f"vocoder step {step}")
        print(f"[vocoder] rank {mesh.rank}: step {step}, weights_digest {digest}", flush=True)
    return state, metrics
