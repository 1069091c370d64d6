"""``python -m speakingstyle_torch.obs.cli <log_dir-or-events.jsonl>`` (a copy
of speakingstyle_tpu/obs/cli.py: the same text for the same events file)

Summarize (or filter) a run's JSONL event log (obs/events.py schema):

  default        per-event-type counts + the training progress tail
                 (last step, last losses, mean step-time / data-wait)
  --event NAME   dump matching records as JSONL to stdout (jq-friendly)
  --tail N       dump the last N records as JSONL

``programs`` subcommand — pretty-print the run's ProgramCard records
(the one-time ``program_card`` event the trainer emits; obs/cost.py) and
compute roofline numbers from the recorded step times:

  python -m speakingstyle_torch.obs.cli programs LOG_DIR [--peak-flops F]

  prints each card's FLOPs / bytes-accessed / arithmetic intensity and
  memory breakdown, then divides card FLOPs by the mean recorded
  ``step_time_s`` into achieved FLOP/s and bytes/s; ``--peak-flops``
  (the card's peak, e.g. 989e12 for the H100's dense bf16 tensor cores,
  ``chip_smoke.PEAK_FLOPS``) adds a model-FLOPs utilization percentage.

``trace`` subcommand — assemble and pretty-print distributed trace
spans (obs/trace.py records, the fleet observability plane):

  python -m speakingstyle_torch.obs.cli trace SPANS [TRACE_ID]

  SPANS is a ``GET /debug/spans`` dump (JSON object with ``spans`` +
  ``kept``), a bare JSON list of span records, or a JSONL file (one
  span per line).  With no TRACE_ID it lists the traces in the file;
  with one it prints the span tree — per-span durations, fields, span
  events — with the critical path (the last-exit chain that gated
  end-to-end latency) marked ``*`` and summarized at the bottom.

``quality`` subcommand — summarize the audio-quality plane's JSONL
events (validator failures, golden-probe rounds, drift + quality-SLO
pages; obs/quality.py, serving/probes.py, obs/slo.py):

  python -m speakingstyle_torch.obs.cli quality LOG_DIR

  prints the validator failure tally by (tier, reason) with the worst
  offenders first and the most recent failure's identity, each tier's
  probe drift trajectory (rounds, first/last/worst mel drift, style
  drift), and the chronological page timeline — probe_drift_alert /
  slo_quality_alert transitions with their resolutions and exemplar
  trace ids.

No torch import: safe to run on a login node against a live run's logs.
"""

import argparse
import collections
import json
import sys

from speakingstyle_torch.obs.events import read_events


def build_parser(parser=None):
    parser = parser or argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "path", help="train.path.log_path directory or an events.jsonl file"
    )
    parser.add_argument(
        "--event", default=None,
        help="dump records of this event type as JSONL instead of summarizing",
    )
    parser.add_argument(
        "--tail", type=int, default=None,
        help="dump the last N records as JSONL instead of summarizing",
    )
    return parser


def summarize(path, out=sys.stdout):
    counts = collections.Counter()
    last_train = None
    step_time_sum = data_wait_sum = 0.0
    n_train = 0
    for rec in read_events(path):
        counts[rec.get("event", "?")] += 1
        if rec.get("event") == "train_step":
            last_train = rec
            n_train += 1
            step_time_sum += rec.get("step_time_s") or 0.0
            data_wait_sum += rec.get("data_wait_s") or 0.0
    if not counts:
        print(f"no events found under {path}", file=out)
        return 1
    print("events:", file=out)
    for name, n in counts.most_common():
        print(f"  {name:20s} {n}", file=out)
    if last_train is not None:
        losses = {
            k: v for k, v in last_train.items()
            if isinstance(v, (int, float)) and k.endswith("loss")
        }
        print(f"last train_step: step={last_train.get('step')}", file=out)
        for k, v in sorted(losses.items()):
            print(f"  {k:20s} {v:.4f}", file=out)
        if n_train:
            print(
                f"mean step_time_s={step_time_sum / n_train:.4f} "
                f"data_wait_s={data_wait_sum / n_train:.4f} "
                f"(over {n_train} logged windows)",
                file=out,
            )
    return 0


def _fmt_quantity(v, unit=""):
    """Human-scaled number: 6.55e12 -> '6.55 T'."""
    if v is None:
        return "?"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {suffix}{unit}"
    return f"{v:.2f} {unit}".rstrip()


def build_programs_parser(parser=None):
    parser = parser or argparse.ArgumentParser(
        prog="python -m speakingstyle_torch.obs.cli programs",
        description="pretty-print program_card records + roofline ratios",
    )
    parser.add_argument(
        "path", help="train.path.log_path directory or an events.jsonl file"
    )
    parser.add_argument(
        "--peak-flops", type=float, default=None,
        help="hardware peak FLOP/s; adds a model-FLOPs utilization row",
    )
    return parser


def programs(path, peak_flops=None, out=None):
    """Pretty-print every recorded ProgramCard and, where the log also
    holds ``train_step`` records, the achieved-FLOP/s roofline numbers
    the card + the measured step times imply."""
    out = out if out is not None else sys.stdout  # late-bound: capturable
    cards = list(read_events(path, event="program_card"))
    if not cards:
        print(f"no program_card events under {path}", file=out)
        return 1
    step_times = [
        rec["step_time_s"]
        for rec in read_events(path, event="train_step")
        if isinstance(rec.get("step_time_s"), (int, float))
        and rec["step_time_s"] > 0
    ]
    mean_step = sum(step_times) / len(step_times) if step_times else None
    for card in cards:
        print(f"program {card.get('name', '?')}"
              + (" (partial)" if card.get("partial") else ""), file=out)
        print(f"  flops            {_fmt_quantity(card.get('flops'), 'FLOP')}",
              file=out)
        print("  bytes accessed   "
              f"{_fmt_quantity(card.get('bytes_accessed'), 'B')}", file=out)
        ai = card.get("arithmetic_intensity")
        print(f"  intensity        "
              f"{ai:.1f} FLOP/B" if ai else "  intensity        ?", file=out)
        print("  memory           "
              f"args {_fmt_quantity(card.get('argument_bytes'), 'B')}, "
              f"out {_fmt_quantity(card.get('output_bytes'), 'B')}, "
              f"temp {_fmt_quantity(card.get('temp_bytes'), 'B')}, "
              f"peak {_fmt_quantity(card.get('peak_bytes'), 'B')}", file=out)
        for err in card.get("errors", []):
            print(f"  degraded         {err}", file=out)
        flops = card.get("flops")
        if mean_step and flops:
            achieved = flops / mean_step
            print(f"  achieved         {_fmt_quantity(achieved, 'FLOP/s')} "
                  f"(mean step {mean_step * 1e3:.1f} ms over "
                  f"{len(step_times)} logged windows)", file=out)
            ba = card.get("bytes_accessed")
            if ba:
                print("  achieved bytes   "
                      f"{_fmt_quantity(ba / mean_step, 'B/s')}", file=out)
            if peak_flops:
                print(f"  utilization      {100 * achieved / peak_flops:.1f}% "
                      f"of {_fmt_quantity(peak_flops, 'FLOP/s')} peak",
                      file=out)
        print(file=out)
    return 0


def build_trace_parser(parser=None):
    parser = parser or argparse.ArgumentParser(
        prog="python -m speakingstyle_torch.obs.cli trace",
        description="assemble + pretty-print distributed trace spans",
    )
    parser.add_argument(
        "path",
        help="a GET /debug/spans dump (JSON), a bare JSON list of span "
             "records, or a JSONL file with one span per line",
    )
    parser.add_argument(
        "trace_id", nargs="?", default=None,
        help="trace to render; omitted = list the traces in the file",
    )
    return parser


def _load_spans(path):
    """Span records from a ``/debug/spans`` dump (object with
    ``spans`` + ``kept``), a bare JSON list, or a JSONL file."""
    with open(path) as fh:
        text = fh.read()
    spans = []
    try:
        doc = json.loads(text)
    except ValueError:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a JSONL log may interleave non-span lines
            if isinstance(rec, dict):
                spans.append(rec)
    else:
        if isinstance(doc, list):
            spans = [s for s in doc if isinstance(s, dict)]
        elif isinstance(doc, dict):
            spans = [s for s in doc.get("spans", []) if isinstance(s, dict)]
            for kept in (doc.get("kept") or {}).values():
                spans.extend(s for s in kept if isinstance(s, dict))
    # dedup by span_id: a tail-kept trace's spans also sit in the ring
    seen, out = set(), []
    for s in spans:
        sid = s.get("span_id")
        if sid in seen:
            continue
        if sid:
            seen.add(sid)
        out.append(s)
    return out


def _fields_text(fields):
    return " ".join(f"{k}={v}" for k, v in sorted(fields.items()))


def trace(path, trace_id=None, out=None):
    """Render one assembled trace as a stage tree (or, with no
    ``trace_id``, list the traces a span dump holds)."""
    from speakingstyle_torch.obs.trace import assemble_trace

    out = out if out is not None else sys.stdout  # late-bound: capturable
    spans = [s for s in _load_spans(path) if s.get("trace_id")]
    if not spans:
        print(f"no span records under {path}", file=out)
        return 1
    if trace_id is None:
        by_trace = collections.defaultdict(list)
        for s in spans:
            by_trace[s["trace_id"]].append(s)
        print(f"{len(by_trace)} trace(s) in {path}:", file=out)
        for tid, group in sorted(
            by_trace.items(), key=lambda kv: (-len(kv[1]), kv[0])
        ):
            root = next(
                (s.get("name") for s in group
                 if not s.get("parent_span_id")), "?",
            )
            span_s = sum(s.get("duration_s") or 0.0 for s in group)
            print(f"  {tid}  {len(group):3d} span(s)  "
                  f"{span_s * 1e3:9.1f} ms span time  root={root}", file=out)
        return 0
    view = assemble_trace(spans, trace_id)
    if not view["span_count"]:
        print(f"trace {trace_id} not found in {path}", file=out)
        return 1
    print(f"trace {trace_id}: {view['span_count']} span(s), "
          f"{view['total_s'] * 1e3:.1f} ms end-to-end "
          "(* = critical path)", file=out)

    def render(node, depth):
        mark = "*" if node["on_critical_path"] else " "
        dur = (node.get("duration_s") or 0.0) * 1e3
        label = "  " * depth + str(node.get("name"))
        line = f"  {mark} {label:<40s} {dur:9.1f} ms"
        extra = _fields_text(node.get("fields") or {})
        if extra:
            line += f"  {extra}"
        if not node.get("ok", True):
            line += "  ERROR"
        print(line, file=out)
        for ev in node.get("events") or []:
            detail = _fields_text(
                {k: v for k, v in ev.items() if k not in ("name", "ts")}
            )
            print("    " + "  " * depth + f"· {ev.get('name')}"
                  + (f" {detail}" if detail else ""), file=out)
        for child in node["children"]:
            render(child, depth + 1)

    for root in view["roots"]:
        render(root, 0)
    cp = view["critical_path"]
    if cp:
        chain = " > ".join(str(s.get("name")) for s in cp)
        gate = cp[-1]
        print(f"critical path: {chain}", file=out)
        print(f"  gated by {gate.get('name')} "
              f"({(gate.get('duration_s') or 0.0) * 1e3:.1f} ms"
              + (f"; {_fields_text(gate.get('fields') or {})}"
                 if gate.get("fields") else "") + ")", file=out)
    return 0


def build_quality_parser(parser=None):
    parser = parser or argparse.ArgumentParser(
        prog="python -m speakingstyle_torch.obs.cli quality",
        description="summarize audio-quality validator/probe/SLO events",
    )
    parser.add_argument(
        "path", help="train.path.log_path directory or an events.jsonl file"
    )
    return parser


_QUALITY_EVENTS = (
    "quality_fail",
    "probe_round",
    "probe_drift_alert", "probe_drift_resolved",
    "slo_quality_alert", "slo_quality_resolved",
    "probe_error",
)


def quality(path, out=None):
    """Summarize the quality plane's event stream: validator failures
    by (tier, reason), per-tier probe drift trajectory, and the page
    timeline (drift + quality-SLO alert transitions)."""
    out = out if out is not None else sys.stdout  # late-bound: capturable
    fails = []
    rounds = []
    timeline = []
    errors = collections.Counter()
    for rec in read_events(path):
        event = rec.get("event")
        if event not in _QUALITY_EVENTS:
            continue
        if event == "quality_fail":
            fails.append(rec)
        elif event == "probe_round":
            rounds.append(rec)
        elif event == "probe_error":
            errors[
                f"{rec.get('tier', '?')}/{rec.get('stage', '?')}"
            ] += 1
        else:
            timeline.append(rec)
    if not (fails or rounds or timeline or errors):
        print(f"no quality-plane events under {path}", file=out)
        return 1

    t0 = min(
        (rec.get("ts") for rec in fails + rounds + timeline
         if isinstance(rec.get("ts"), (int, float))),
        default=None,
    )

    def rel(ts):
        if t0 is None or not isinstance(ts, (int, float)):
            return "      ?"
        return f"{ts - t0:+8.1f}s"

    # -- validator failures: worst offenders first ---------------------------
    by_offender = collections.Counter()
    for rec in fails:
        tier = rec.get("tier", "?")
        for reason in rec.get("reasons") or ("?",):
            by_offender[(tier, reason)] += 1
    print(f"validator failures: {len(fails)}", file=out)
    for (tier, reason), n in by_offender.most_common():
        print(f"  {tier:16s} {reason:12s} {n}", file=out)
    if fails:
        last = fails[-1]
        print(
            f"  last: {rel(last.get('ts'))}  tier={last.get('tier')} "
            f"class={last.get('class')} source={last.get('source')} "
            f"reasons={','.join(last.get('reasons') or ())} "
            f"req_id={last.get('req_id')} trace_id={last.get('trace_id')}",
            file=out,
        )

    # -- probe drift trajectory per tier -------------------------------------
    print(f"probe rounds: {len(rounds)}", file=out)
    trajectory = collections.defaultdict(list)
    style_drifts = []
    for rec in rounds:
        for tier, drift in (rec.get("tiers") or {}).items():
            if isinstance(drift, (int, float)):
                trajectory[tier].append(drift)
        sd = rec.get("style_drift")
        if isinstance(sd, (int, float)):
            style_drifts.append(sd)
    for tier, drifts in sorted(trajectory.items()):
        print(
            f"  {tier:16s} rounds={len(drifts)} "
            f"first={drifts[0]:.4g} last={drifts[-1]:.4g} "
            f"worst={max(drifts):.4g}",
            file=out,
        )
    if style_drifts:
        print(
            f"  {'(style)':16s} rounds={len(style_drifts)} "
            f"first={style_drifts[0]:.4g} last={style_drifts[-1]:.4g} "
            f"worst={max(style_drifts):.4g}",
            file=out,
        )
    for key, n in errors.most_common():
        print(f"  probe errors {key}: {n}", file=out)

    # -- page timeline --------------------------------------------------------
    print(f"page timeline: {len(timeline)} transition(s)", file=out)
    for rec in timeline:
        event = rec.get("event")
        if event.startswith("probe_"):
            drift = rec.get("mel_drift", rec.get("style_drift"))
            detail = (
                f"tier={rec.get('tier')} drift={drift} "
                f"tolerance={rec.get('tolerance')}"
            )
        else:
            detail = (
                f"class={rec.get('klass')} "
                f"fast_burn={rec.get('fast_burn')} "
                f"slow_burn={rec.get('slow_burn')} "
                f"trace_id={rec.get('trace_id')}"
            )
        print(f"  {rel(rec.get('ts'))}  {event:22s} {detail}", file=out)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "trace":
        args = build_trace_parser().parse_args(argv[1:])
        return trace(args.path, trace_id=args.trace_id)
    if argv and argv[0] == "quality":
        args = build_quality_parser().parse_args(argv[1:])
        return quality(args.path)
    if argv and argv[0] == "programs":
        args = build_programs_parser().parse_args(argv[1:])
        return programs(args.path, peak_flops=args.peak_flops)
    args = build_parser().parse_args(argv)
    if args.event is not None:
        for rec in read_events(args.path, event=args.event):
            print(json.dumps(rec))
        return 0
    if args.tail is not None:
        records = list(read_events(args.path))
        for rec in records[-args.tail:]:
            print(json.dumps(rec))
        return 0
    return summarize(args.path)


if __name__ == "__main__":
    sys.exit(main())
