"""``serve`` command: the continuous-batching text -> wav HTTP server on one
engine (JAX counterpart: the single-engine branch of
speakingstyle_tpu/cli/serve.py).

Restores the acoustic model from ``train.path.ckpt_path`` at
``--restore_step`` (<= 0: the latest; the port's own checkpoints, or a
reference ``<step>.pth.tar`` through ``convert``) and the vocoder from
``--vocoder_ckpt`` (weights from ``--seed`` without one), prepares the
whole lattice (every acoustic point at every precision tier, every
vocoder point and every style-encoder point: a CUDA graph each on the
card) before the socket binds, then serves the API of
serving/server.py:

  POST /synthesize, POST /synthesize/stream, POST /styles, GET /styles,
  GET /healthz, GET /metrics, GET /debug/programs,
  POST /debug/profile?seconds=N

``serve.trace`` sizes the span ring and arms span recording,
``serve.slo.enabled`` starts the SLO burn-rate engine, and one
``SPEAKINGSTYLE_FAULTS`` plan is shared by every component. SIGTERM stops
accepting, drains in-flight streams (``serve.fleet.drain_timeout_s``),
flushes admitted requests and exits 0.

``--replicas`` > 1 (the fleet router) is ROADMAP.md queue A item 5b and
exits non-zero; ``--cluster`` and ``--enable_rollout`` without a fleet
print the JAX command's warnings and are ignored.

Runs on ``cuda`` unless ``--device cpu`` is given, and fails rather than
fall back when no card is present.

    python -m speakingstyle_torch serve --preset LJSpeech --restore_step 900000 \\
        --ref_audio ref.wav --port 8400
"""

import argparse
import dataclasses
import signal
import threading

from speakingstyle_torch.cli import add_config_args, config_from_args

FLEET_MISSING = ("--replicas > 1 serves through the fleet router, which is not ported yet "
                 "(ROADMAP.md queue A item 5b); run one engine with --replicas 1")


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
                        help="override serve.fleet.replicas; > 1 needs the fleet router "
                             "(ROADMAP.md queue A item 5b) and exits non-zero")
    parser.add_argument("--ref_dir", default=None,
                        help='override serve.style.ref_dir: the allowlist directory of request '
                             '"ref_audio" paths (unset = uploads via POST /styles only)')
    parser.add_argument("--cluster", action="store_true",
                        help="the distributed control plane (fleet mode only; ignored here)")
    parser.add_argument("--enable_rollout", action="store_true",
                        help="POST /admin/rollout (fleet mode only; ignored here)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the vocoder's weights when no --vocoder_ckpt is given")
    return parser


def model_version_string(info) -> str:
    """``<step>:<digest prefix>``, the X-Model-Version wire format."""
    digest = info.get("weights_digest") or "unverified"
    return f"{info.get('step')}:{digest[:12]}"


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
    if replicas > 1:
        raise SystemExit(FLEET_MISSING)
    if args.enable_rollout:
        print("warning: --enable_rollout needs fleet mode (--replicas > 1); ignoring", flush=True)
    if args.cluster:
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
    slo = None
    if cfg.serve.slo.enabled:
        scfg = cfg.serve.slo
        slo = SloEngine(engine.registry, scfg, events=events, trace_ring=get_span_ring())
        print(f"SLO engine armed: objectives {dict(scfg.objectives)}, windows "
              f"{scfg.fast_window_s:g}s/{scfg.slow_window_s:g}s", flush=True)
    server = SynthesisServer(engine, TextFrontend(cfg, default_ref), host=args.host,
                             port=args.port, events=events, slo=slo,
                             model_info=dict(info, version=model_version_string(info)))

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
          "POST /styles, GET /styles, GET /healthz, GET /metrics, GET /debug/programs, "
          "POST /debug/profile?seconds=N)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down (flushing admitted requests) ...", flush=True)
    finally:
        if slo is not None:
            slo.close()
        server.shutdown()
        if events is not None:
            events.close()
    print("server stopped", flush=True)


if __name__ == "__main__":
    main(build_parser().parse_args())
