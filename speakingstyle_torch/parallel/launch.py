"""Start the rank processes of a data- or tensor-parallel command on this
host (the port's counterpart of the JAX package's one process driving every
device).

``train`` and ``train_vocoder`` call ``launch_if_needed(dp, device, tp=...)``
once they have resolved the mesh. Outside a rendezvous (no ``WORLD_SIZE``,
no ``SPEAKINGSTYLE_MULTIHOST``) and with ``dp x tp > 1`` it builds the
kernels once (on the card), then starts ``dp x tp`` workers of the same
command with
``subprocess.Popen`` (fork and exec: nothing is forked after CUDA is up),
each with torchrun's variables and a rendezvous on a free port of
127.0.0.1, and returns their exit code; the command then exits with it.
Inside a rendezvous (torchrun across hosts, or the pod switch
``SPEAKINGSTYLE_MULTIHOST``) it returns None and the process trains as its
rank.

* SIGTERM and SIGINT are forwarded to every worker (each flushes at the
  same step as the others: the trainers agree on a stop over the group).
* A worker that exits non-zero stops the others; the command exits
  non-zero naming that rank (``WorkerFailed``).

``start_workers`` starts some ranks and returns at once: ``serve`` starts
the helper ranks of its ring long-form tier with it (it is rank 0 itself,
serving/ring_ranks.py).
"""

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

MULTIHOST_ENV = "SPEAKINGSTYLE_MULTIHOST"
# seconds a worker gets to exit after the others were told to stop (a
# rank whose peer died may be blocked in a collective: it is then killed)
STOP_GRACE_S = 5.0
# seconds between two looks at the workers' exit codes
POLL_S = 0.1


class WorkerFailed(RuntimeError):
    """A rank process exited non-zero."""

    def __init__(self, rank: int, code: int):
        self.rank, self.code = rank, code
        super().__init__(f"rank {rank} exited with code {code}; "
                         "the other ranks were stopped")


def free_port() -> int:
    """A free TCP port of 127.0.0.1."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def in_rendezvous() -> bool:
    """True inside torchrun's (or this module's) rendezvous, or under the
    pod switch."""
    return bool(os.environ.get("WORLD_SIZE")) or bool(os.environ.get(MULTIHOST_ENV))


def worker_env(rank: int, world: int, port: int, base: Optional[Dict] = None) -> Dict[str, str]:
    env = dict(os.environ if base is None else base)
    # the workers import this package from the checkout this process uses
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def start_workers(argv: Sequence[str], ranks: Sequence[int], world: int, port: int,
                  env: Optional[Dict] = None) -> List[subprocess.Popen]:
    """Start ``[python, *argv]`` once for each of ``ranks`` of a ``world``-rank
    rendezvous on ``port`` of 127.0.0.1 and return the processes (the
    caller waits for them, or stops them with ``stop_all``)."""
    procs = [subprocess.Popen([sys.executable, *argv], env=worker_env(r, world, port, env))
             for r in ranks]
    print("[parallel] " + ", ".join(f"rank {r} pid {p.pid}" for r, p in zip(ranks, procs)),
          flush=True)
    return procs


def run_workers(argv: Sequence[str], world: int, env: Optional[Dict] = None) -> int:
    """Run ``[python, *argv]`` as ``world`` ranks on this host and wait for
    them; returns 0, or raises ``WorkerFailed`` for the first rank that
    exited non-zero (the others are stopped). SIGTERM / SIGINT received
    meanwhile are forwarded to every worker."""
    procs = start_workers(argv, range(world), world, free_port(), env)

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, forward)
        except ValueError:  # not the main thread: the signals keep their handlers
            pass
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                return 0
            time.sleep(POLL_S)
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        if failed is not None or any(p.poll() is None for p in procs):
            stop_all(procs)
    raise WorkerFailed(*failed)


def stop_all(procs: Sequence[subprocess.Popen]) -> None:
    """SIGTERM every live worker, then SIGKILL what is left after
    ``STOP_GRACE_S``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_if_needed(dp: int, device, argv: Optional[Sequence[str]] = None,
                     tp: int = 1) -> Optional[int]:
    """Start ``dp x tp`` rank processes of this command when that is more
    than one and this process is not already a rank; returns their exit
    code (0), or None when this process should train itself. ``argv``
    defaults to ``python -m speakingstyle_torch`` and this process's
    arguments (a command run in-process passes its own)."""
    world = dp * tp
    if world <= 1 or in_rendezvous():
        return None
    if str(device).startswith("cuda"):
        from speakingstyle_torch.ops import kernels

        # one build before any rank starts: the ranks load what it made
        kernels.build_all()
    if argv is None:
        argv = ["-m", "speakingstyle_torch", *sys.argv[1:]]
    print(f"[parallel] starting {world} rank processes", flush=True)
    return run_workers(argv, world)
