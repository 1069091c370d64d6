"""``replica`` command: one replica process of the cluster (JAX counterpart:
speakingstyle_tpu/cli/replica.py).

The worker half of serving/cluster.py: restores the checkpoint, prepares
the whole lattice (the engine ``serve`` builds: a CUDA graph a point on the
card, the hand-written kernels loaded from ``speakingstyle_torch/build/``
or built there), then registers with a ``ClusterRouter``'s control server
and serves

  POST /dispatch       one coalesced batch over the wire (idempotency-keyed:
                       a hedge or a retry of an executed batch answers from
                       a bounded cache)
  GET  /healthz        the ready flag, the compile and dispatch counters,
                       ``memory_reserved`` and the kernels' build seconds
                       on the card, the last profile window's summary
  POST /drain          stop admitting, finish the dispatch in flight
  GET  /metrics        the registry's raw state (the router federates it)
  GET  /debug/spans    this process's span ring
  POST /debug/profile  one torch.profiler capture (the router's fan-out)

Liveness is a heartbeat lease: the process beats every
``serve.cluster.heartbeat_interval_s``; a router that misses the budget
expires the lease and requeues the in-flight work. A beat answered 409 or
410 (a healed partition, a new router) re-registers with a bumped epoch.
``serve.trace`` sizes the span ring and arms recording, as in ``serve``;
``SPEAKINGSTYLE_FAULTS`` arms the engine's fault points. SIGTERM stops
admitting, lets the dispatch in flight finish (at most
``serve.fleet.drain_timeout_s``) and exits 0.

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card: it never registers, and the router's spawn fails on
``serve.cluster.spawn_grace_s``. A replica spanning hosts
(``--coordinator_address`` / ``--num_processes`` / ``--process_id``) is
ROADMAP.md queue A item 6c-ii (``torch.distributed``): the command exits
non-zero when they are set, as it does for ``serve.parallel`` past ``mesh:
[1, 1]``. Usually ``serve --cluster`` spawns it:

    python -m speakingstyle_torch replica --preset LJSpeech --restore_step 900000 \\
        --replica_id r1 --router 127.0.0.1:41234
"""

import argparse
import os
import signal
import threading

from speakingstyle_torch.cli import add_config_args, config_from_args

MULTIHOST_MISSING = ("a replica spanning hosts (--coordinator_address, --num_processes, "
                     "--process_id: one replica as a torch.distributed process group) is "
                     "multi-device serving, ROADMAP.md queue A item 6c-ii; run one process a replica")


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--restore_step", type=int, required=True,
                        help="checkpoint step under train.path.ckpt_path (<= 0: the latest)")
    parser.add_argument("--replica_id", required=True,
                        help="the lease identity the router assigned (e.g. r3)")
    parser.add_argument("--router", required=True,
                        help="the ClusterRouter's control server, host:port")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder checkpoint (.pth.tar or .msgpack)")
    parser.add_argument("--griffin_lim", action="store_true",
                        help="no neural vocoder: results carry the mel only")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address of the replica's HTTP server")
    parser.add_argument("--port", type=int, default=0, help="bind port (0: a free one)")
    parser.add_argument("--coordinator_address", default=None,
                        help="a replica spanning hosts (ROADMAP.md queue A item 6c-ii: refused)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="with --coordinator_address (refused)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="with --coordinator_address (refused)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the vocoder's weights when no --vocoder_ckpt is given "
                             "(serve's own --seed)")
    return parser


def main(args):
    if (args.coordinator_address is not None or args.num_processes is not None
            or args.process_id is not None):
        raise SystemExit(MULTIHOST_MISSING)
    from speakingstyle_torch.configs.config import check_serve_supported
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.obs.trace import configure_span_ring, set_tracing_enabled
    from speakingstyle_torch.serving.cluster import ReplicaServer
    from speakingstyle_torch.serving.engine import load_engine

    cfg = config_from_args(args)
    try:
        check_serve_supported(cfg.serve)
    except NotImplementedError as e:
        raise SystemExit(f"replica: {e}") from e
    # the replica's half of the trace plane: the router's serve.trace block
    tcfg = cfg.serve.trace
    configure_span_ring(tcfg.ring_capacity, keep_traces=tcfg.keep_traces)
    set_tracing_enabled(tcfg.enabled)
    device = resolve_device(args.device)
    fault_plan = FaultPlan.from_env() or None
    if fault_plan:
        print(f"[{args.replica_id}] fault injection armed: {fault_plan.pending()}", flush=True)
    registry = MetricsRegistry()
    engine, info = load_engine(cfg, args.restore_step, vocoder_ckpt=args.vocoder_ckpt,
                               griffin_lim=args.griffin_lim, device=device,
                               vocoder_seed=args.seed + 1, registry=registry,
                               fault_plan=fault_plan)
    print(f"[{args.replica_id}] precompiling {len(engine.lattice)} lattice points on {device} "
          f"(step {info.get('step')}) before registering ...", flush=True)
    secs = engine.precompile()
    print(f"[{args.replica_id}] {engine.compile_count} programs in {secs:.1f}s; registering "
          f"with {args.router}", flush=True)
    server = ReplicaServer(engine, args.replica_id, args.router, cfg.serve.cluster,
                           registry=registry, host=args.host, port=args.port, pid=os.getpid())
    server.start()
    print(f"[{args.replica_id}] serving on http://{server.host}:{server.port} (lease ttl "
          f"{cfg.serve.cluster.lease_ttl_s:g}s)", flush=True)

    # SIGTERM: stop admitting (beats report not-ready, dispatches answer
    # 503); this thread then lets the dispatches admitted finish and closes
    # the server before the process exits
    stop = threading.Event()

    def _sigterm(signum, frame):
        print(f"[{args.replica_id}] SIGTERM: draining ...", flush=True)
        server.drain()
        stop.set()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        stop.wait()
        drained = server.wait_idle(cfg.serve.fleet.drain_timeout_s)
        print(f"[{args.replica_id}] {'drained' if drained else 'drain timed out'}; stopping",
              flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    print(f"[{args.replica_id}] replica stopped", flush=True)
    return 0


if __name__ == "__main__":
    main(build_parser().parse_args())
