"""Run-report rendering: `run.jsonl` -> the human-readable operator view.

Answers the questions a BENCH round needs answered without re-running
anything: where did wall time go (per-phase table, input-wait vs device
split), did anything recompile after steady state (retrace counters), what
did serving look like (queue depth, degradation, padding waste).  Pure
parsing, so the CLI runs anywhere.

Port of `multihop_offload_tpu/obs/report.py`, over the port's
`obs.events.read_events`: the same log renders to the same text.  The
sections of JAX's compile counters, the prof layer's program table and
memory watermarks render what the log holds: the port's logs carry the
program table (`obs.prof`), the watermarks of a card (`obs.memwatch`) and
no compile events, so the compile section reads zeros.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from multihop_offload_tpu_torch.obs.events import read_events

# phase-name classification for the input-wait vs device split; host-input
# phases end in /build or /prefetch (the drivers' convention), device-side
# phases are the dispatch+block windows
_INPUT_SUFFIXES = ("/build", "/prefetch", "/pack")
_DEVICE_SUFFIXES = ("/step", "/tick", "/replay", "/timed", "/warmup")


def classify_phase(name: str) -> str:
    if name.endswith(_INPUT_SUFFIXES):
        return "input-wait"
    if name.endswith(_DEVICE_SUFFIXES):
        return "device"
    if "compile" in name:
        return "compile"
    return "other"


# low-volume health events retained in full by load_run (an alert history
# is only useful complete); absent in pre-health logs — every consumer
# degrades to "no section" on an empty list.  watermark / prof_capture are
# the prof layer's additions (memory high-water marks, profiler bundles)
_HEALTH_EVENTS = ("alert", "drift", "flight_record", "watermark",
                  "prof_capture")


def load_run(path: str) -> dict:
    """Parse a run.jsonl into {manifest, counts, phases, metrics, events}."""
    manifest: Optional[dict] = None
    counts: Dict[str, int] = {}
    phases: Dict[str, dict] = {}
    metrics: Dict[str, dict] = {}
    programs: Dict[str, dict] = {}
    last_of: Dict[str, dict] = {}
    health: Dict[str, List[dict]] = {k: [] for k in _HEALTH_EVENTS}
    first_ts = last_ts = None
    for ev in read_events(path):
        et = ev.get("event", "?")
        if et in health:
            health[et].append(ev)
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            first_ts = ts if first_ts is None else first_ts
            last_ts = ts
        if et == "manifest" and manifest is None:
            manifest = ev
            continue
        counts[et] = counts.get(et, 0) + 1
        last_of[et] = ev
        if et == "phase":
            # standalone phase rows (bench legs) aggregate like span stats
            p = phases.setdefault(ev.get("name", "?"), {
                "count": 0, "total_s": 0.0, "min_s": None, "max_s": None,
            })
            d = float(ev.get("duration_s", 0.0))
            p["count"] += 1
            p["total_s"] += d
            p["min_s"] = d if p["min_s"] is None else min(p["min_s"], d)
            p["max_s"] = d if p["max_s"] is None else max(p["max_s"], d)
        elif et == "summary":
            for name, s in (ev.get("phases") or {}).items():
                phases[name] = dict(s)
            metrics = ev.get("metrics") or metrics
            # prof-layer snapshot ({program: facts}); absent in pre-prof
            # logs — consumers degrade to "no performance section"
            programs = ev.get("programs") or programs
    for p in phases.values():
        p.setdefault("mean_s", p["total_s"] / max(p.get("count", 1), 1))
    return {
        "manifest": manifest or {},
        "counts": counts,
        "phases": phases,
        "metrics": metrics,
        "programs": programs,
        "last": last_of,
        "health": health,
        "wall_s": (last_ts - first_ts) if first_ts is not None else None,
    }


def _counter_total(metrics: dict, name: str) -> float:
    m = metrics.get(name)
    if not m:
        return 0.0
    return float(sum(v for v in m["series"].values()
                     if isinstance(v, (int, float))))


def _counter_by_label(metrics: dict, name: str) -> Dict[str, float]:
    m = metrics.get(name)
    if not m:
        return {}
    return {k or "(total)": float(v) for k, v in m["series"].items()
            if isinstance(v, (int, float))}


def _fmt_opt(v, fmt: str) -> str:
    """Format an optional numeric cell; None (backend did not report the
    fact) renders as '-'."""
    return fmt.format(float(v)) if isinstance(v, (int, float)) else "-"


def _program_gauge(metrics: dict, name: str) -> Dict[str, float]:
    """{program: value} from a per-program gauge's summary snapshot."""
    m = metrics.get(name)
    out: Dict[str, float] = {}
    for labels, v in ((m or {}).get("series") or {}).items():
        if not isinstance(v, (int, float)):
            continue
        # label strings render as {program="name"} (registry convention)
        key = str(labels)
        pre = 'program="'
        i = key.find(pre)
        if i >= 0:
            j = key.find('"', i + len(pre))
            if j > 0:
                out[key[i + len(pre):j]] = float(v)
    return out


def _fmt_row(cells: Iterable[str], widths: List[int]) -> str:
    return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()


def _table(header: List[str], rows: List[List[str]]) -> List[str]:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              if rows else len(str(h)) for i, h in enumerate(header)]
    out = [_fmt_row(header, widths),
           _fmt_row(["-" * w for w in widths], widths)]
    out += [_fmt_row(r, widths) for r in rows]
    return out


def render_report(path: str) -> str:
    run = load_run(path)
    man, phases, metrics = run["manifest"], run["phases"], run["metrics"]
    lines: List[str] = []

    lines.append(f"run report — {path}")
    lines.append("")
    lines.append("manifest")
    for key in ("role", "git_sha", "jax_version", "platform", "device_kind",
                "device_count", "config_hash", "hostname"):
        if key in man and man[key] not in (None, ""):
            lines.append(f"  {key:<13} {man[key]}")
    if run["wall_s"] is not None:
        lines.append(f"  {'wall_s':<13} {run['wall_s']:.3f}")
    ev_counts = ", ".join(f"{k}={v}" for k, v in sorted(run["counts"].items()))
    lines.append(f"  {'events':<13} {ev_counts or '(none)'}")
    lines.append("")

    if phases:
        lines.append("per-phase time")
        total = sum(p.get("total_s", 0.0) for p in phases.values()) or 1.0
        rows = []
        split: Dict[str, float] = {}
        for name in sorted(phases, key=lambda n: -phases[n].get("total_s", 0)):
            p = phases[name]
            split[classify_phase(name)] = (
                split.get(classify_phase(name), 0.0) + p.get("total_s", 0.0)
            )
            rows.append([
                name, p.get("count", 0),
                f"{p.get('total_s', 0.0):.3f}",
                f"{1e3 * p.get('mean_s', 0.0):.2f}",
                f"{1e3 * (p.get('min_s') or 0.0):.2f}",
                f"{1e3 * (p.get('max_s') or 0.0):.2f}",
                f"{100.0 * p.get('total_s', 0.0) / total:.1f}%",
            ])
        lines += [
            "  " + ln for ln in
            _table(["phase", "count", "total_s", "mean_ms", "min_ms",
                    "max_ms", "share"], rows)
        ]
        acc = " | ".join(
            f"{k} {100.0 * v / total:.1f}% ({v:.3f}s)"
            for k, v in sorted(split.items(), key=lambda kv: -kv[1])
        )
        lines.append(f"  split: {acc}")
        lines.append("")

    retr = _counter_total(metrics, "jax_retraces_total")
    unexp = _counter_total(metrics, "jax_unexpected_retraces_total")
    compiles = _counter_total(metrics, "jax_compiles_total")
    lines.append("compilation")
    lines.append(f"  jaxpr traces (cache misses)  {int(retr)}")
    lines.append(f"  backend compiles             {int(compiles)}")
    flag = "  <-- PERF BUG: recompile after steady state" if unexp else ""
    lines.append(f"  unexpected retraces          {int(unexp)}{flag}")
    by_phase = _counter_by_label(metrics, "jax_unexpected_retraces_total")
    if unexp and by_phase:
        for lab, v in sorted(by_phase.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {lab} {int(v)}")
    lines.append("")

    # prof layer: per-program cost/MFU attribution (summary `programs=`
    # snapshot + the live utilization gauges).  Pre-prof logs have neither
    # — the section is omitted, not rendered empty.
    programs = run.get("programs") or {}
    if programs:
        lines.append("performance (per program)")
        mfu = _program_gauge(metrics, "mho_program_mfu")
        hbm = _program_gauge(metrics, "mho_program_hbm_frac")
        rows = []
        for name in sorted(programs):
            p = programs[name]
            rows.append([
                name,
                p.get("calls", 0),
                _fmt_opt(p.get("device_s"), "{:.3f}"),
                _fmt_opt(p.get("compile_s"), "{:.2f}"),
                _fmt_opt(p.get("flops_corrected"), "{:.3e}"),
                _fmt_opt(p.get("bytes_accessed"), "{:.3e}"),
                _fmt_opt(p.get("arithmetic_intensity"), "{:.3f}"),
                _fmt_opt(mfu.get(name), "{:.4f}"),
                _fmt_opt(hbm.get(name), "{:.4f}"),
            ])
        lines += ["  " + ln for ln in _table(
            ["program", "calls", "device_s", "compile_s", "flops",
             "bytes", "AI", "mfu", "hbm_frac"], rows)]
        lines.append("")
    watermarks = (run.get("health") or {}).get("watermark") or []
    captures = (run.get("health") or {}).get("prof_capture") or []
    if watermarks or captures:
        lines.append("memory watermarks & profiler captures")
        seen: Dict[str, dict] = {}
        for w in watermarks:  # keep only each device's final high-water mark
            seen[str(w.get("device", "?"))] = w
        for dev, w in sorted(seen.items()):
            lines.append(
                f"  watermark {dev:<14} {int(w.get('bytes', 0))} bytes"
                + (f" (phase {w['phase']})" if w.get("phase") else "")
            )
        for c in captures:
            lines.append(
                f"  profiler capture: {c.get('path') or '(failed)'}"
                + (f" — {c['error']}" if c.get("error") else "")
            )
        lines.append("")

    serve_counters = {
        name: _counter_by_label(metrics, name) for name in metrics
        if name.startswith("mho_serve_")
    }
    if serve_counters:
        lines.append("serving")
        for name in sorted(serve_counters):
            for lab, v in sorted(serve_counters[name].items()):
                tag = f"{name}{'' if lab == '(total)' else lab}"
                val = int(v) if float(v) == int(v) else round(v, 4)
                lines.append(f"  {tag:<42} {val}")
        # serve-side histograms (latency, per-bucket occupancy): the
        # counter view above drops dict-valued series, so render them as
        # count/sum/mean rows — mean occupancy per bucket is the signal
        # the width ladder and the `ragged` bench leg act on
        hist_rows = []
        for name in sorted(serve_counters):
            m = metrics.get(name) or {}
            if m.get("kind") != "histogram":
                continue
            for lab, s in sorted((m.get("series") or {}).items()):
                if not isinstance(s, dict):
                    continue
                cnt = int(s.get("count") or 0)
                hist_rows.append([
                    f"{name}{'' if not lab else lab}", cnt,
                    _fmt_opt(s.get("sum"), "{:.4g}"),
                    _fmt_opt((s.get("sum") or 0.0) / cnt if cnt else None,
                             "{:.4g}"),
                    _fmt_opt(s.get("min"), "{:.4g}"),
                    _fmt_opt(s.get("max"), "{:.4g}"),
                ])
        if hist_rows:
            lines += ["  " + ln for ln in _table(
                ["histogram", "count", "sum", "mean", "min", "max"],
                hist_rows)]
        last_tick = run["last"].get("tick")
        if last_tick and "queue_depth" in last_tick:
            lines.append(f"  {'queue_depth (last tick)':<42} "
                         f"{last_tick['queue_depth']}")
        lines.append("")

    # device-native telemetry (obs/devmetrics): in-program accumulators
    # flushed into the registry — absent entirely in runs without
    # instrumented hot loops, so the section degrades to nothing
    dev_names = sorted(n for n in metrics if n.startswith("mho_dev_"))
    if dev_names:
        lines.append("device metrics (in-program)")
        hist_rows = []
        for name in dev_names:
            m = metrics[name]
            if m.get("kind") == "histogram":
                for lab, s in sorted((m.get("series") or {}).items()):
                    if not isinstance(s, dict):
                        continue
                    cnt = int(s.get("count") or 0)
                    hist_rows.append([
                        f"{name}{'' if not lab else lab}", cnt,
                        _fmt_opt(s.get("sum"), "{:.4g}"),
                        _fmt_opt((s.get("sum") or 0.0) / cnt if cnt else None,
                                 "{:.4g}"),
                        _fmt_opt(s.get("min"), "{:.4g}"),
                        _fmt_opt(s.get("max"), "{:.4g}"),
                    ])
            else:
                for lab, v in sorted(_counter_by_label(metrics, name).items()):
                    tag = f"{name}{'' if lab == '(total)' else lab}"
                    val = int(v) if float(v) == int(v) else round(v, 4)
                    lines.append(f"  {tag:<58} {val}")
        if hist_rows:
            lines += ["  " + ln for ln in _table(
                ["histogram", "count", "sum", "mean", "min", "max"],
                hist_rows)]
        lines.append("")

    loop_counters = {
        name: _counter_by_label(metrics, name) for name in metrics
        if name.startswith("mho_loop_")
    }
    last_reload = run["last"].get("hot_reload")
    if loop_counters or last_reload:
        lines.append("continual learning")
        for name in sorted(loop_counters):
            for lab, v in sorted(loop_counters[name].items()):
                tag = f"{name}{'' if lab == '(total)' else lab}"
                val = int(v) if float(v) == int(v) else round(v, 4)
                lines.append(f"  {tag:<42} {val}")
        if last_reload:
            lin = ", ".join(
                f"{k}={last_reload[k]}"
                for k in ("step", "source", "parent_step", "git_sha")
                if last_reload.get(k) not in (None, "")
            )
            lines.append(f"  {'serving weights (last hot_reload)':<42} {lin}")
        for et in ("promotion", "rollback", "rejection"):
            ev = run["last"].get(et)
            if ev:
                detail = ", ".join(
                    f"{k}={ev[k]}" for k in ("step", "reason", "failed_step")
                    if ev.get(k) not in (None, "")
                )
                lines.append(f"  {f'last {et}':<42} {detail or '(recorded)'}")
        lines.append("")

    health = run.get("health") or {}
    alerts = health.get("alert") or []
    drifts = health.get("drift") or []
    flights = health.get("flight_record") or []
    if alerts or drifts or flights:
        lines.append("alerts & drift")
        if alerts:
            rows = [[
                a.get("name", "?"), a.get("state", "?"),
                f"{a.get('at', 0.0):.3f}" if isinstance(
                    a.get("at"), (int, float)) else "-",
                a.get("burn_short", "-"), a.get("burn_long", "-"),
            ] for a in alerts]
            lines += ["  " + ln for ln in _table(
                ["slo", "state", "at", "burn_short", "burn_long"], rows)]
            firing = {a.get("name") for a in alerts
                      if a.get("state") == "firing"}
            firing -= {a.get("name") for a in alerts
                       if a.get("state") == "resolved"}
            lines.append("  still firing at log end: "
                         + (", ".join(sorted(x for x in firing if x))
                            or "(none)"))
        for d in drifts:
            lines.append(
                f"  drift trip: {d.get('signal', '?')} via "
                f"{d.get('detector', '?')} after {d.get('samples', '?')} "
                f"samples (stat={d.get('stat', '?')})"
            )
        for fr in flights:
            lines.append(
                f"  flight bundle: {fr.get('path', '?')} "
                f"({fr.get('records', '?')} records, "
                f"reason={fr.get('reason', '?')})"
            )
        lines.append("")

    mem = _counter_by_label(metrics, "mho_device_peak_bytes_in_use")
    if mem:
        lines.append("device memory (peak bytes)")
        for lab, v in sorted(mem.items()):
            lines.append(f"  {lab:<20} {int(v)}")
        lines.append("")

    return "\n".join(lines).rstrip() + "\n"
