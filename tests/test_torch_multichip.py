"""PyTorch port, data-parallel training on rank processes (gloo on the CPU;
``tests/torch_dp.py``): the port's twins of ``tests/test_multichip.py``'s
pure-DP cases (config validation, ``resolve_mesh``, the batch gate's
message, cross-mesh resume bit for bit, the shard-local poison against the
agreed sentinel, the rollback drill with a gauge a rank), the ``train``
command's ``--data_parallel`` and ``--model_parallel`` (its ranks, a killed
rank, the refusals of ``seq`` and of partition rules over ``seq`` or
``data``), and the kernel build's lock. The tensor-parallel steps are
``tests/test_torch_tp.py``'s.
"""

import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_training import corpus, write_configs  # noqa: F401 (corpus: a fixture)
from torch_dp import REPO, child_env, run_ranks
from torch_threads import no_tensorflow, one_cpu_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("no_tensorflow")


# ---------------------------------------------------------------- config -> mesh


def test_parallel_config_validation():
    from speakingstyle_torch.configs.config import ParallelConfig

    ParallelConfig(mesh=[4, 2], seq=1, partition_rules=[["a/kernel$", "none,model"]])
    for bad in (dict(mesh=[8]), dict(mesh=[4, 0]), dict(mesh=[-2, 1]), dict(seq=0),
                dict(partition_rules=[["kernel"]]),
                dict(partition_rules=[["a/kernel$", "none,modle"]]),
                dict(partition_rules=[["a/(kernel$", "none,model"]])):
        with pytest.raises(ValueError):
            ParallelConfig(**bad)


def test_resolve_mesh_single_device_is_none():
    from speakingstyle_torch.configs.config import ParallelConfig
    from speakingstyle_torch.parallel import resolve_mesh

    assert resolve_mesh(ParallelConfig()) is None
    assert resolve_mesh(ParallelConfig(mesh=[1, 1])) is None


def test_resolve_mesh_shapes():
    """dp = -1 takes every device not claimed by tp; more ranks than cards
    is allowed (they share a card over gloo)."""
    from speakingstyle_torch.configs.config import ParallelConfig
    from speakingstyle_torch.parallel import resolve_mesh
    from speakingstyle_torch.parallel.mesh import choose_backend

    mesh = resolve_mesh(ParallelConfig(mesh=[8, 1]), n_devices=8)
    assert mesh.shape == {"data": 8, "model": 1} and not mesh.joined
    mesh = resolve_mesh(ParallelConfig(mesh=[-1, 2]), n_devices=8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert resolve_mesh(ParallelConfig(mesh=[4, 1]), n_devices=1).dp == 4
    assert choose_backend("cuda", 2, 1)[0] == "gloo"   # two ranks on one card
    assert choose_backend("cuda", 4, 4)[0] == "nccl"   # a card each
    assert choose_backend("cpu", 2, 0)[0] == "gloo"


def test_local_batch_size_structured_error():
    from speakingstyle_torch.parallel import BatchShardingError, local_batch_size, make_mesh

    assert local_batch_size(16, make_mesh(data=8)) == 2
    with pytest.raises(BatchShardingError) as exc:
        local_batch_size(12, make_mesh(data=8))  # 12 over dp=8
    msg = str(exc.value)
    assert "12" in msg and "dp=8" in msg and "8x1" in msg
    assert "8 or 16" in msg  # the two nearest valid batch sizes


def test_check_train_supported_names_6b_and_6c():
    """Tensor parallelism (item 6b) is admitted, with partition rules over
    ``model``, and so are the sequence axis and a rule naming it (item
    6c-i: the JAX trainer builds no sequence axis, so ``seq > 1`` trains on
    the (dp, tp) mesh and the rule fails where its sharding fails,
    ``partition.tp_layout``); a rule naming ``data`` (GSPMD shards
    parameters over it) names item 6d."""
    from speakingstyle_torch.configs.config import (
        ParallelConfig, ShardingConfig, TrainConfig, check_train_supported,
    )

    for ok in (TrainConfig(parallel=ParallelConfig(mesh=[2, 1])),
               TrainConfig(parallel=ParallelConfig(mesh=[2, 2])),
               TrainConfig(sharding=ShardingConfig(model_axis=2)),
               TrainConfig(parallel=ParallelConfig(
                   mesh=[1, 2], partition_rules=[["mel_linear/kernel$", "none,model"]])),
               TrainConfig(parallel=ParallelConfig(seq=2)),
               TrainConfig(parallel=ParallelConfig(
                   mesh=[1, 2], partition_rules=[["mel_linear/kernel$", "seq,none"]]))):
        check_train_supported(ok)
    check_train_supported(TrainConfig(), n_devices=4)
    with pytest.raises(NotImplementedError, match="queue A item 6d"):
        check_train_supported(TrainConfig(parallel=ParallelConfig(
            mesh=[2, 2], partition_rules=[["mel_linear/kernel$", "data,model"]])))


# ---------------------------------------------------------------- cross-mesh resume


def flat_state(state):
    from speakingstyle_torch.obs.buildinfo import flatten

    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in flatten(state.state_dict()).items()}


def assert_bit_identical(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g == w, k


@pytest.mark.parametrize("src,dst", [(2, 1), (1, 2)])
def test_cross_mesh_resume_bit_identical(tmp_path, corpus, src, dst):
    """Two steps at dp = ``src`` save step 2; a restore at dp = ``dst`` holds
    every leaf of it bit for bit (parameters, Adam moments, counts, step,
    BatchNorm statistics), on every rank, and one step runs from it."""
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import build_state, run_training

    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4},
                          step={"val_step": 1000, "save_step": 2})
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    if src == 2:
        ranks = run_ranks("run", 2, tmp_path, paths=paths, max_steps=2)
        assert ranks[0]["digest"] == ranks[1]["digest"] and ranks[0]["step"] == 2
    else:
        run_training(cfg, device="cpu", max_steps=2)
    saved = CheckpointManager(cfg.train.path.ckpt_path)
    want = flat_state(saved.restore(build_state(cfg, torch.device("cpu")), step=2))
    if dst == 1:
        got = [flat_state(saved.restore(build_state(cfg, torch.device("cpu")), step=2))]
        assert run_training(cfg, device="cpu", max_steps=3, restore_step=2).step == 3
    else:
        (tmp_path / "dst").mkdir()
        got = [r["state"] for r in run_ranks("restored", 2, tmp_path / "dst", paths=paths,
                                             step=2)]
        ranks = run_ranks("run", 2, tmp_path / "dst", paths=paths, max_steps=3, restore_step=2)
        assert [r["step"] for r in ranks] == [3, 3] and ranks[0]["digest"] == ranks[1]["digest"]
    assert want["step"] == 2 and want["optimizer/count"] == 2
    for state in got:
        assert_bit_identical(state, want)


def test_gradient_accumulation_over_two_ranks_resumes_mid_accumulation(tmp_path, corpus):
    """``grad_acc_step: 2`` over two ranks: the gradients are reduced at the
    last micro-step only, so a checkpoint taken between micro-steps stores
    the ranks' accumulators summed. That checkpoint's accumulator is the one
    process's (the global micro-batch gradient), and a resume from it at
    dp = 1 applies the update the one process applies from its own step-1
    checkpoint (Adam's first moment after it, within 1e-5 of its largest
    element)."""
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import run_training

    def configs(root):
        root.mkdir()
        return write_configs(root, corpus, optimizer={"batch_size": 4, "grad_acc_step": 2},
                             step={"val_step": 1000, "save_step": 1})

    dp2, one = configs(tmp_path / "dp2"), configs(tmp_path / "one")
    run_ranks("run", 2, tmp_path / "dp2", paths=dp2, max_steps=1)
    cfg_one = load_config(one["preprocess"], one["model"], one["train"])
    run_training(cfg_one, device="cpu", max_steps=1)
    saved = {name: CheckpointManager(str(tmp_path / name / "ckpt")).load_verified(1)[1]
             for name in ("dp2", "one")}
    assert saved["dp2"]["optimizer"]["mini_step"] == saved["one"]["optimizer"]["mini_step"] == 1
    top = max(a.abs().max().item() for a in saved["one"]["optimizer"]["acc"])
    for got, want in zip(saved["dp2"]["optimizer"]["acc"], saved["one"]["optimizer"]["acc"]):
        torch.testing.assert_close(got, want, atol=1e-5 * top, rtol=0)

    cfg_dp2 = load_config(dp2["preprocess"], dp2["model"], dp2["train"])
    resumed = run_training(cfg_dp2, device="cpu", max_steps=2, restore_step=1)
    straight = run_training(cfg_one, device="cpu", max_steps=2, restore_step=1)
    assert resumed.optimizer.count == straight.optimizer.count == 1
    top = max(m.abs().max().item() for m in straight.optimizer.mu)
    for got, want in zip(resumed.optimizer.mu, straight.optimizer.mu):
        torch.testing.assert_close(got, want, atol=1e-5 * top, rtol=0)


# ---------------------------------------------------------------- the sentinel


def test_shard_local_poison_trips_the_flag_on_both_ranks(tmp_path, corpus):
    """``nan_grads`` at step 2 poisons rank 0's rows only; the agreed flag
    (the MIN over the ranks) is False on both ranks at step 2 and True at
    step 1, and the update spreads the NaN to both replicas alike."""
    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4})
    ranks = run_ranks("train_steps", 2, tmp_path, paths=paths, steps=2, poison_at=2)
    assert [r[0]["finite"] for r in ranks] == [True, True]
    assert [r[1]["finite"] for r in ranks] == [False, False]
    assert ranks[0][1]["local_finite"] is False
    assert np.isnan(ranks[0][1]["losses"]["total_loss"])
    assert ranks[0][1]["digest"] == ranks[1][1]["digest"]


def test_run_training_rejects_indivisible_batch(tmp_path, corpus, monkeypatch):
    """The startup gate: batch 3 over dp = 2 is a structured error naming the
    two nearest valid sizes, from ``run_training`` and from the ``train``
    command, before any rank process starts."""
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.configs.config import ParallelConfig, load_config
    from speakingstyle_torch.parallel import BatchShardingError, launch
    from speakingstyle_torch.training.trainer import run_training

    paths = write_configs(tmp_path, corpus)  # batch 3
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, parallel=ParallelConfig(mesh=[2, 1])))
    with pytest.raises(BatchShardingError, match="2 or 4"):
        run_training(cfg, device="cpu", max_steps=1)

    def started(*a, **k):
        raise AssertionError("a rank process started")

    monkeypatch.setattr(launch, "run_workers", started)
    with pytest.raises(SystemExit, match="2 or 4"):
        main(["train", "-p", paths["preprocess"], "-m", paths["model"], "-t", paths["train"],
              "--device", "cpu", "--data_parallel", "2"])
    assert not os.path.exists(tmp_path / "log" / "log.txt")


def test_nan_rollback_over_two_ranks_and_gauges_a_rank(tmp_path, corpus):
    """``nan_grads@3`` over two ranks (rank 0's rows poisoned): both ranks
    roll back to the step-2 checkpoint at step 3 and finish step 5 with
    equal weights; rank 0 alone writes log.txt, where the rollback is
    logged; rank 0's registry has the achieved FLOP/s and the memory
    watermark of each rank under its ``device`` label."""
    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4},
                          step={"val_step": 1000, "save_step": 2})
    ranks = run_ranks("run", 2, tmp_path, paths=paths, max_steps=5, faults="nan_grads@3")
    assert [r["step"] for r in ranks] == [5, 5] and ranks[0]["digest"] == ranks[1]["digest"]
    log = (tmp_path / "log" / "log.txt").read_text()
    assert "non-finite losses/grads at step 3" in log
    assert "rollback 1/3 to checkpoint step 2" in log
    assert log.count("[train] Step 1,") == 1  # one writer
    gauges = ranks[0]["gauges"]
    for r in range(2):
        for name in ("train_achieved_flops_per_sec", "device_memory_watermark_bytes"):
            key = f'{name}{{device="rank{r}/cpu"}}'
            assert gauges.get(key, 0) > 0, sorted(gauges)
    assert not [k for k in ranks[1]["gauges"] if k.startswith("train_achieved")]


# ---------------------------------------------------------------- the command


def train_args(paths, *extra):
    return ["train", "-p", paths["preprocess"], "-m", paths["model"], "-t", paths["train"],
            "--device", "cpu", *extra]


def test_train_command_data_parallel_on_the_cpu(tmp_path, corpus, monkeypatch):
    """``train --device cpu --data_parallel 2`` starts two rank processes,
    which train over gloo and exit 0: one log.txt with each step once, the
    checkpoint of the last step; a ``train.parallel.mesh: [2, 1]`` yaml does
    the same without the flag."""
    from speakingstyle_torch.__main__ import main

    for k, v in child_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4},
                          step={"val_step": 2, "save_step": 100})
    assert main(train_args(paths, "--data_parallel", "2", "--max_steps", "2")) is None
    log = (tmp_path / "log" / "log.txt").read_text().splitlines()
    assert [l.split(",")[0] for l in log if l.startswith("[train]")] == [
        "[train] Step 1", "[train] Step 2"]
    assert [l.split(",")[0] for l in log if l.startswith("[val]")] == ["[val] Step 2"]
    assert os.path.isfile(tmp_path / "ckpt" / "2" / "manifest.json")

    (tmp_path / "yaml").mkdir()
    paths = write_configs(tmp_path / "yaml", corpus, optimizer={"batch_size": 4},
                          step={"val_step": 1000}, parallel={"mesh": [2, 1]})
    assert main(train_args(paths, "--max_steps", "1")) is None
    assert os.path.isfile(tmp_path / "yaml" / "ckpt" / "1" / "manifest.json")


def test_a_killed_rank_fails_the_command_naming_it(tmp_path, corpus):
    """SIGKILL to rank 1 of ``train --data_parallel 2``: the other rank is
    stopped and the command exits non-zero naming rank 1."""
    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4},
                          step={"total_step": 10 ** 6, "val_step": 10 ** 6})
    proc = subprocess.Popen([sys.executable, "-m", "speakingstyle_torch",
                             *train_args(paths, "--data_parallel", "2")],
                            cwd=REPO, env=child_env(tmp_path), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    import threading
    import time

    watchdog = threading.Timer(180, proc.kill)  # a hung command fails the test
    watchdog.start()
    try:
        pids = {}
        for line in proc.stdout:
            if "rank 1 pid" in line:
                pids = {int(r): int(p) for r, p in (
                    part.split(" pid ") for part in line.split("] ", 1)[1].replace(
                        "rank ", "").split(", "))}
            if line.startswith("[parallel] data parallel over 2"):
                break  # both ranks joined the group: training
        time.sleep(1.0)
        os.kill(pids[1], signal.SIGKILL)
        rest, _ = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode != 0
    assert "rank 1 exited with code -9" in rest, rest[-2000:]
    for pid in pids.values():
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_sigterm_to_the_command_stops_both_ranks_at_one_step(tmp_path, corpus):
    """SIGTERM to ``train --data_parallel 2`` is forwarded to both ranks,
    which agree on the step to stop at; rank 0 flushes that step's
    checkpoint and the command exits 0."""
    import re
    import threading
    import time

    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4},
                          step={"total_step": 10 ** 6, "val_step": 10 ** 6,
                                "save_step": 10 ** 6})
    proc = subprocess.Popen([sys.executable, "-m", "speakingstyle_torch",
                             *train_args(paths, "--data_parallel", "2")],
                            cwd=REPO, env=child_env(tmp_path), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(180, proc.kill)  # a hung command fails the test
    watchdog.start()
    try:
        log = tmp_path / "log" / "log.txt"
        while proc.poll() is None and not (log.exists() and "[train] Step 2," in log.read_text()):
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-2000:]
    flushed = re.findall(r"\[rank 0\] \[resilience\] SIGTERM: checkpoint flushed at step (\d+)",
                         out)
    stopped = re.findall(r"\[rank 1\] stopped at step (\d+)", out)
    assert flushed and flushed == stopped, out[-2000:]
    assert os.path.isfile(tmp_path / "ckpt" / flushed[0] / "manifest.json")


def test_the_cpu_is_one_device_whatever_cards_the_host_has(tmp_path, corpus, monkeypatch):
    """``train.sharding.data_axis: -1`` (every device, the default) on a
    host with two cards: ``--device cpu`` resolves to one process, in the
    command and in ``run_training``; the card's default takes both cards."""
    from speakingstyle_torch.cli.train import build_parser, resolve_dp
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.parallel.mesh import visible_devices
    from speakingstyle_torch.training.trainer import resolve_run_mesh

    for k in ("WORLD_SIZE", "SPEAKINGSTYLE_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    paths = write_configs(tmp_path, corpus, optimizer={"batch_size": 4})
    cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
    assert cfg.train.sharding.data_axis == -1 and cfg.train.parallel.is_single()
    args = build_parser().parse_args(train_args(paths)[1:])
    assert resolve_dp(args, cfg) == 1
    assert resolve_run_mesh(cfg, "cpu") is None
    assert visible_devices("cpu") == visible_devices(torch.device("cpu")) == 1
    assert visible_devices(None) == visible_devices("cuda") == 2
    args = build_parser().parse_args(train_args(paths)[1:-2])  # no --device: the card
    assert resolve_dp(args, cfg) == 2


def test_a_rank_without_a_card_raises(monkeypatch):
    """A rank asked for the card finds none: it raises, naming --device
    cpu, and never joins the group on the CPU."""
    from speakingstyle_torch.parallel.mesh import init_distributed

    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*--device cpu"):
        init_distributed("cuda")


def test_model_parallel_and_seq_exit_naming_6b_and_6c(tmp_path, corpus, monkeypatch):
    """``train --model_parallel 2`` and ``--data_parallel 2 --model_parallel
    2`` train on the CPU as 2 and 4 rank processes over gloo (one log.txt,
    each step once, the last step's checkpoint whole: one process restores
    it); ``train.parallel.mesh: [1, 2]`` and ``sharding.model_axis: 2``
    resolve to the same mesh. ``seq`` and a partition rule naming ``seq``
    resolve to the (dp, tp) mesh of ``parallel.mesh`` (item 6c-i: the JAX
    trainer builds no sequence axis; what the rule then does is
    ``tests/test_torch_cli.py::test_seq_axis_in_training_does_what_the_jax_trainer_does``);
    a rule naming ``data`` exits naming item 6d, before any rank starts.
    The name is kept from when ``seq`` exited naming item 6c."""
    from speakingstyle_torch.__main__ import main
    from speakingstyle_torch.cli.train import build_parser, resolve_shape
    from speakingstyle_torch.configs.config import load_config
    from speakingstyle_torch.training.checkpoint import CheckpointManager
    from speakingstyle_torch.training.trainer import build_state

    for k, v in child_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    for name, flags, steps in (("tp", ["--model_parallel", "2"], 2),
                               ("dptp", ["--data_parallel", "2", "--model_parallel", "2"], 1)):
        (tmp_path / name).mkdir()
        paths = write_configs(tmp_path / name, corpus, optimizer={"batch_size": 4},
                              step={"val_step": 1000, "save_step": 100})
        assert main(train_args(paths, *flags, "--max_steps", str(steps))) is None
        log = (tmp_path / name / "log" / "log.txt").read_text().splitlines()
        assert [l.split(",")[0] for l in log if l.startswith("[train]")] == [
            f"[train] Step {s + 1}" for s in range(steps)]
        cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
        state = CheckpointManager(cfg.train.path.ckpt_path).restore(
            build_state(cfg, torch.device("cpu")), step=steps)
        assert state.step == steps and state.optimizer.count == steps
    for name, train in (("mesh", {"parallel": {"mesh": [1, 2]}}),
                        ("axis", {"sharding": {"model_axis": 2, "data_axis": 1}})):
        (tmp_path / name).mkdir()
        paths = write_configs(tmp_path / name, corpus, optimizer={"batch_size": 4}, **train)
        cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
        assert resolve_shape(build_parser().parse_args(train_args(paths)[1:]), cfg) == (1, 2)
    for name, parallel, shape in (
            ("seq", {"seq": 2}, (1, 1)),
            ("seq_rule", {"mesh": [1, 2], "partition_rules": [["mel_linear/kernel$",
                                                               "seq,none"]]}, (1, 2))):
        (tmp_path / name).mkdir()
        paths = write_configs(tmp_path / name, corpus, optimizer={"batch_size": 4},
                              parallel=parallel)
        cfg = load_config(paths["preprocess"], paths["model"], paths["train"])
        assert resolve_shape(build_parser().parse_args(train_args(paths)[1:]), cfg) == shape
    (tmp_path / "data_rule").mkdir()
    paths = write_configs(tmp_path / "data_rule", corpus, parallel={
        "mesh": [2, 2], "partition_rules": [["mel_linear/kernel$", "data,model"]]})
    with pytest.raises(SystemExit, match="queue A item 6d"):
        main(train_args(paths))


def test_the_kernel_build_holds_the_build_directory_lock(tmp_path, monkeypatch):
    """``build_all`` builds under an exclusive lock on the build directory:
    a second process waits until the first one's build is done (the rank
    processes of a run never compile into it at once)."""
    import fcntl
    import time

    from speakingstyle_torch.ops import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(kernels, "_start_build", lambda name: seen.append(name))
    assert kernels.build_all(["a"]) == {"a": 0.0} and seen == ["a"]
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from speakingstyle_torch.ops import kernels as k;"
            "k.BUILD_DIR = sys.argv[2]; k._start_build = lambda n: None;"
            "print('waiting', flush=True); k.build_all(['a']); print('built', flush=True)")
    with open(tmp_path / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        child = subprocess.Popen([sys.executable, "-c", code, REPO, str(tmp_path)],
                                 stdout=subprocess.PIPE, text=True)
        assert child.stdout.readline().strip() == "waiting"
        time.sleep(1.0)
        assert child.poll() is None  # blocked on the lock this process holds
    assert child.stdout.readline().strip() == "built"
    assert child.wait(timeout=60) == 0
