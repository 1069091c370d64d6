"""``serve`` command: the text -> wav HTTP server, on one engine behind the
continuous batcher, on a fleet of replica engines, or on a cluster of
replica processes (JAX counterpart: speakingstyle_tpu/cli/serve.py, its
fleet branch ``:229-380`` with the cluster ``:262-305``).

Restores the acoustic model from ``train.path.ckpt_path`` at
``--restore_step`` (<= 0: the latest; the port's own checkpoints, or a
reference ``<step>.pth.tar`` through ``convert``) and the vocoder from
``--vocoder_ckpt`` (weights from ``--seed`` without one), prepares the
whole lattice (every acoustic point at every precision tier, every
vocoder point and every style-encoder point: a CUDA graph each on the
card) before the socket binds, then serves the API of
serving/server.py:

  POST /synthesize, POST /synthesize/stream, POST /synthesize/longform,
  POST /styles, GET /styles, GET /healthz, GET /metrics,
  GET /debug/programs, POST /debug/profile?seconds=N

``POST /synthesize/longform`` serves chapters on the chunked long-form tier
(serving/longform.py) over the same backend, on one engine or behind
``--replicas N``. On one engine ``serve.longform.mesh_seq > 1`` adds the
ring tier (JAX ``cli/serve.py:413-430``): after the server is built the
command starts the ring's ``mesh_seq - 1`` helper rank processes
(serving/ring_ranks.py; this process is rank 0), prepares every ring point
(``serve.longform.{src,mel}_buckets``), prints the count and the seconds
and attaches the tier, so a chapter that fits a ring bucket is one
ring-attention free run (``X-Longform-Tier: ring``); a ring that does not
start (a helper that exits or never joins, a failed preparation) ends the
command with a non-zero exit, not a chunked-only server. A fleet serves the
chunked tier only, as the JAX command does. ``serve.parallel`` past
``mesh: [1, 1]`` (one replica across devices) exits non-zero naming
ROADMAP.md queue A item 6c-ii.

``serve.trace`` sizes the span ring and arms span recording,
``serve.slo.enabled`` starts the SLO burn-rate engine, and one
``SPEAKINGSTYLE_FAULTS`` plan is shared by every component. SIGTERM stops
accepting, drains in-flight streams (``serve.fleet.drain_timeout_s``),
flushes admitted requests and exits 0.

``--replicas N`` > 1 (or ``serve.fleet.replicas``) serves through the
fleet router (serving/fleet.py): the checkpoint is loaded once and every
replica's engine shares its f32 weights (one copy on the card) and one
StyleService; the socket binds at once and ``/healthz`` answers 503 until
the first replica has prepared its lattice on its background thread. On
one card the replicas share the device: each holds its own CUDA graphs
(memory grows with N) and a replica's warm-up holds the others' dispatches
back for one capture at a time. ``--enable_rollout`` (or
``serve.rollout.enabled``) arms ``POST /admin/rollout``;
``serve.autoscale.enabled`` arms the autoscaler. ``--cluster`` and
``--enable_rollout`` without a fleet print the JAX command's warnings and
are ignored.

``--cluster`` (or ``serve.cluster.enabled``) with a fleet serves through
the cluster (serving/cluster.py): the router runs here, with the
StyleService (styles resolve here and cross the wire as gamma / beta), and
each replica is a ``python -m speakingstyle_torch replica`` process that
restores the same checkpoint (``--device``, the config files,
``--vocoder_ckpt``, ``--griffin_lim`` and ``--seed`` passed on) and
prepares its own lattice; it registers with a heartbeat lease and is
dispatched to over HTTP, hedged. ``/healthz`` answers 503 until
``serve.cluster.quorum`` replicas are READY. On one card each process owns
a CUDA context and its graphs, and the card time-slices between them. A
rollout's canary is a replica process restoring the candidate step, after
the candidate's verify load here. Streams need a vocoder in this process
and answer 400 in cluster mode, as in the JAX package.

Runs on ``cuda`` unless ``--device cpu`` is given, and fails rather than
fall back when no card is present.

    python -m speakingstyle_torch serve --preset LJSpeech --restore_step 900000 \\
        --ref_audio ref.wav --port 8400 [--replicas 2 --enable_rollout]
"""

import argparse
import dataclasses
import signal
import threading

import os
import subprocess
import sys

from speakingstyle_torch.cli import add_config_args, config_from_args
from speakingstyle_torch.configs.config import check_serve_supported


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--restore_step", type=int, required=True,
                        help="checkpoint step under train.path.ckpt_path (<= 0: the latest)")
    parser.add_argument("--ref_audio", default=None,
                        help="default style-reference wav used when a request carries none")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder checkpoint (.pth.tar or .msgpack)")
    parser.add_argument("--griffin_lim", action="store_true",
                        help="no neural vocoder: /synthesize returns the mel as JSON")
    parser.add_argument("--host", default=None, help="override serve.host")
    parser.add_argument("--port", type=int, default=None, help="override serve.port")
    parser.add_argument("--replicas", type=int, default=None,
                        help="override serve.fleet.replicas: > 1 serves through the fleet "
                             "router (replica engines, EDF dispatch, load shedding)")
    parser.add_argument("--ref_dir", default=None,
                        help='override serve.style.ref_dir: the allowlist directory of request '
                             '"ref_audio" paths (unset = uploads via POST /styles only)')
    parser.add_argument("--cluster", action="store_true",
                        help="serve the fleet through the cluster (overrides "
                             "serve.cluster.enabled): each replica a separate process spawned "
                             "as `python -m speakingstyle_torch replica`, registered with a "
                             "heartbeat lease, dispatched to with hedged retries (fleet mode "
                             "only: needs --replicas > 1)")
    parser.add_argument("--enable_rollout", action="store_true",
                        help="enable POST /admin/rollout (canary-gated rolling model upgrade; "
                             "fleet mode only, overrides serve.rollout.enabled)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the vocoder's weights when no --vocoder_ckpt is given")
    return parser


def model_version_string(info) -> str:
    """``<step>:<digest prefix>``, the X-Model-Version wire format."""
    digest = info.get("weights_digest") or "unverified"
    return f"{info.get('step')}:{digest[:12]}"


def replica_spawner(args):
    """The cluster's spawn callable: ``spawn(replica_id, router_addr,
    extra)`` starts ``python -m speakingstyle_torch replica`` with
    ``subprocess.Popen`` (fork and exec: this process holds a CUDA context)
    on the serve command's ``--preset`` / ``-p`` / ``-m`` / ``-t``,
    ``--device``, ``--vocoder_ckpt``, ``--griffin_lim``, ``--seed`` and the
    restore step (``extra["restore_step"]``, a rollout canary's, else
    ``--restore_step``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cfg_args = []
    for flag, value in (("--preset", args.preset), ("-p", args.preprocess_config),
                        ("-m", args.model_config), ("-t", args.train_config)):
        if value:
            cfg_args += [flag, value]

    def spawn(replica_id, router_addr, extra):
        step = (extra or {}).get("restore_step", args.restore_step)
        cmd = [sys.executable, "-m", "speakingstyle_torch", "replica", *cfg_args,
               "--replica_id", replica_id, "--router", router_addr, "--restore_step", str(step),
               "--device", args.device, "--seed", str(args.seed)]
        if args.vocoder_ckpt:
            cmd += ["--vocoder_ckpt", args.vocoder_ckpt]
        if args.griffin_lim:
            cmd += ["--griffin_lim"]
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=root + (os.pathsep + path if path else ""))
        return subprocess.Popen(cmd, env=env)

    return spawn


def build_fleet(cfg, args, replicas: int, device, fault_plan=None, events=None,
                cluster: bool = False):
    """The fleet branch's backend (JAX ``cli/serve.py:229-380``): the
    checkpoint loaded once, one StyleService, a ``FleetRouter`` of
    ``replicas`` engines over a factory that shares the loaded weights, the
    model version published, and the rollout manager (``--enable_rollout``
    / ``serve.rollout.enabled``) and autoscaler (``serve.autoscale.enabled``)
    when armed. With ``cluster`` a ``ClusterRouter`` of ``replica``
    processes instead (``replica_spawner``), spawned first, so that their
    start-up runs beside this process's load: the checkpoint is loaded here
    for the model's identity and the StyleService only, without a vocoder,
    and the style lattice is prepared here. Returns (router, lifecycle or
    None, autoscaler or None). The replicas warm in the background."""
    from speakingstyle_torch.obs import MetricsRegistry
    from speakingstyle_torch.serving.engine import SynthesisEngine, load_engine_parts
    from speakingstyle_torch.serving.fleet import FleetRouter
    from speakingstyle_torch.serving.style import StyleService

    registry = MetricsRegistry()
    router = None
    if cluster:
        from speakingstyle_torch.serving.cluster import ClusterRouter

        router = ClusterRouter(replica_spawner(args), cfg, replicas=replicas, registry=registry,
                               events=events, fault_plan=fault_plan)
        ccfg = cfg.serve.cluster
        print(f"cluster control plane on http://{router.control_addr} (lease ttl "
              f"{ccfg.lease_ttl_s:g}s, quorum {ccfg.quorum})", flush=True)
    try:
        model, vocoder, lattice, info = load_engine_parts(
            cfg, args.restore_step, vocoder_ckpt=args.vocoder_ckpt,
            griffin_lim=args.griffin_lim or cluster, device=device, vocoder_seed=args.seed + 1)
        # one style service for every replica: one embedding cache, one set
        # of style programs (the first replica's warm-up prepares them; in a
        # cluster, where styles resolve here, this process does)
        style = (StyleService(cfg, model.reference_encoder, device=device, registry=registry,
                              fault_plan=fault_plan)
                 if cfg.model.use_reference_encoder else None)
        if cluster and style is not None:
            style.precompile()
    except BaseException:
        if router is not None:
            router.close(flush=False)
        raise

    def factory_for(model, vocoder, lattice):
        def factory(reg):
            return SynthesisEngine(cfg, model=model, vocoder=vocoder, lattice=lattice,
                                   device=device, registry=reg, fault_plan=fault_plan,
                                   style=style)
        return factory

    if cluster:
        router.style = style
    else:
        router = FleetRouter(factory_for(model, vocoder, lattice), cfg, replicas=replicas,
                             registry=registry, events=events, style=style,
                             fault_plan=fault_plan)
    router.set_model_version(model_version_string(info), info.get("step"),
                             info.get("weights_digest"))
    autoscaler = None
    if cfg.serve.autoscale.enabled:
        from speakingstyle_torch.serving.autoscale import Autoscaler

        acfg = cfg.serve.autoscale
        autoscaler = Autoscaler(router, acfg)
        print(f"autoscaler armed: [{acfg.min_replicas}, {acfg.max_replicas}] replicas, tick "
              f"{acfg.interval_s}s (serve_autoscale_target tracks decisions)", flush=True)
    lifecycle = None
    if args.enable_rollout or cfg.serve.rollout.enabled:
        from speakingstyle_torch.serving.lifecycle import RolloutManager

        def verify_and_build(step: int):
            # the verify gate: the manifest-checked restore of the candidate;
            # a corrupt one aborts here, before any replica is touched. The
            # style service keeps encoding with the live weights' encoder,
            # as the JAX fleet's shared service does.
            m2, v2, l2, info2 = load_engine_parts(
                cfg, step, vocoder_ckpt=args.vocoder_ckpt, griffin_lim=args.griffin_lim or cluster,
                device=device, vocoder_seed=args.seed + 1)
            if cluster:
                # the canary is a replica process restoring the candidate;
                # the load above stays the verify gate
                del m2, v2
                return (router.remote_factory({"restore_step": step}),
                        model_version_string(info2), info2)
            return factory_for(m2, v2, l2), model_version_string(info2), info2

        lifecycle = RolloutManager(router, verify_and_build, autoscaler=autoscaler,
                                   events=events)
        print('rollout enabled: POST /admin/rollout {"step": N}', flush=True)
    return router, lifecycle, autoscaler


def main(args):
    from speakingstyle_torch.device import resolve_device
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.obs import JsonlEventLog
    from speakingstyle_torch.obs.slo import SloEngine
    from speakingstyle_torch.obs.trace import (
        configure_span_ring,
        get_span_ring,
        set_tracing_enabled,
    )
    from speakingstyle_torch.serving.engine import load_engine
    from speakingstyle_torch.serving.frontend import TextFrontend, load_ref_mel
    from speakingstyle_torch.serving.server import SynthesisServer

    cfg = config_from_args(args)
    replicas = args.replicas if args.replicas is not None else cfg.serve.fleet.replicas
    cluster = replicas > 1 and (args.cluster or cfg.serve.cluster.enabled)
    try:
        check_serve_supported(cfg.serve)
    except NotImplementedError as e:
        raise SystemExit(f"serve: {e}") from e
    if replicas <= 1 and args.enable_rollout:
        print("warning: --enable_rollout needs fleet mode (--replicas > 1); ignoring", flush=True)
    if replicas <= 1 and args.cluster:
        print("warning: --cluster needs fleet mode (--replicas > 1); ignoring", flush=True)
    device = resolve_device(args.device)
    # size the span ring and arm (or disarm) recording before any serving
    # component starts
    tcfg = cfg.serve.trace
    configure_span_ring(tcfg.ring_capacity, keep_traces=tcfg.keep_traces)
    set_tracing_enabled(tcfg.enabled)
    # one plan for every component keeps the @N counters exact
    fault_plan = FaultPlan.from_env() or None
    if fault_plan:
        print(f"fault injection armed: {fault_plan.pending()}", flush=True)
    if args.ref_dir:
        cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
            cfg.serve, style=dataclasses.replace(cfg.serve.style, ref_dir=args.ref_dir)))
    default_ref = load_ref_mel(cfg, args.ref_audio) if args.ref_audio else None
    events = None
    if cfg.serve.log_events:
        events = JsonlEventLog(cfg.train.path.log_path, max_bytes=cfg.train.obs.events_max_bytes,
                               keep=cfg.train.obs.events_keep)

    router = autoscaler = None
    if replicas > 1:
        router, lifecycle, autoscaler = build_fleet(cfg, args, replicas, device,
                                                    fault_plan=fault_plan, events=events,
                                                    cluster=cluster)
        what = "replica processes" if cluster else "replicas"
        ready = f"a quorum of {cfg.serve.cluster.quorum} is" if cluster else "one is"
        print(f"warming {replicas} {what} x {len(router.lattice)} lattice points on {device} "
              f"in the background (healthz: 503 until {ready} ready) ...", flush=True)
        registry = router.registry
        server_kwargs = dict(router=router, lifecycle=lifecycle)
    else:
        engine, info = load_engine(cfg, args.restore_step, vocoder_ckpt=args.vocoder_ckpt,
                                   griffin_lim=args.griffin_lim, device=device,
                                   vocoder_seed=args.seed + 1, fault_plan=fault_plan)
        style_points = len(engine.style.lattice) if engine.style is not None else 0
        print(f"precompiling {len(engine.lattice)} lattice points + {style_points} style-encoder "
              f"points on {device} ...", flush=True)
        secs = engine.precompile()
        style_n = engine.style.compile_count if engine.style is not None else 0
        print(f"precompiled {engine.compile_count} synthesis + {style_n} style programs in "
              f"{secs:.1f}s; steady-state serving prepares nothing", flush=True)
        registry = engine.registry
        server_kwargs = dict(engine=engine,
                             model_info=dict(info, version=model_version_string(info)))
    slo = None
    if cfg.serve.slo.enabled:
        scfg = cfg.serve.slo
        slo = SloEngine(registry, scfg, events=events, trace_ring=get_span_ring())
        print(f"SLO engine armed: objectives {dict(scfg.objectives)}, windows "
              f"{scfg.fast_window_s:g}s/{scfg.slow_window_s:g}s", flush=True)
    server = SynthesisServer(frontend=TextFrontend(cfg, default_ref), host=args.host,
                             port=args.port, events=events, slo=slo, **server_kwargs)
    ring = None
    if replicas <= 1 and cfg.serve.longform.mesh_seq > 1:
        # the ring tier: one program set over its own sequence mesh,
        # prepared now (start-up, not the request path) and attached to the
        # server's LongformService, so both tiers share the one engine
        from speakingstyle_torch.serving.longform import RingTier

        lf = cfg.serve.longform
        print(f"starting the ring's {lf.mesh_seq - 1} helper rank process(es) and preparing "
              f"{len(lf.src_buckets) * len(lf.mel_buckets)} ring-attention long-form points "
              f"(seq mesh of {lf.mesh_seq}) ...", flush=True)
        try:
            ring = RingTier(cfg, engine.model, engine)
            ring_secs = ring.precompile()
        except BaseException as e:
            # no fallback to the chunked tier: a ring that does not start
            # (a helper that never joins, a failed preparation) ends the
            # command, its helpers stopped and its socket closed
            if ring is not None:
                ring.close()
            server.shutdown()
            if isinstance(e, Exception):
                raise SystemExit(f"serve: the ring long-form tier did not start: "
                                 f"{type(e).__name__}: {e}") from e
            raise
        print(f"ring tier ready in {ring.startup_s + ring_secs:.1f}s ({ring.startup_s:.1f}s to "
              f"join its {lf.mesh_seq} ranks, {ring_secs:.1f}s preparing)", flush=True)
        server.longform.ring = ring

    # SIGTERM: stop accepting, drain in-flight streams, flush admitted
    # requests, exit; shutdown() must run off the serve_forever thread
    def _sigterm(signum, frame):
        print("SIGTERM: draining in-flight streams ...", flush=True)
        threading.Thread(target=server.shutdown, name="server-shutdown", daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    host, port = server.address[:2]
    print(f"latency pipeline: frontend_workers={cfg.serve.frontend_workers} (0 = inline G2P), "
          f"stream_depth={cfg.serve.fleet.stream_depth} (1 = sequential vocode)", flush=True)
    print(f"serving on http://{host}:{port} (POST /synthesize, POST /synthesize/stream, "
          "POST /synthesize/longform, POST /styles, GET /styles, GET /healthz, GET /metrics, "
          "GET /debug/programs, POST /debug/profile?seconds=N"
          + (", POST /admin/rollout" if server.lifecycle is not None else "") + ")", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down (flushing admitted requests) ...", flush=True)
    finally:
        if autoscaler is not None:
            autoscaler.close()
        if slo is not None:
            slo.close()
        server.shutdown()
        if ring is not None:
            ring.close()
        if events is not None:
            events.close()
    print("server stopped", flush=True)


if __name__ == "__main__":
    main(build_parser().parse_args())
