"""Run-report CLI: render a `run.jsonl` into the operator view.

Port of `multihop_offload_tpu/cli/obs.py` (`mho-obs`):

    python -m multihop_offload_tpu_torch.cli.obs out/run.jsonl
        # human-readable report
    ... out/run.jsonl --json       # parsed {manifest, phases, metrics}
    ... out/run.jsonl --prom FILE  # the final metric snapshot as Prometheus
                                   # text exposition ('-' for stdout)
    ... out/run.jsonl --trace 42   # one request's end-to-end hop chain
                                   # (rotated segments included)

Pure parsing: it touches no device, so it is safe on any host (including
one whose card is wedged: that is exactly when you want to read the log).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", help="path to a run.jsonl written via --obs_log")
    p.add_argument("--json", action="store_true",
                   help="emit the parsed run as JSON instead of the report")
    p.add_argument("--prom", default=None, metavar="FILE",
                   help="also write the run's final metric snapshot as "
                        "Prometheus text exposition ('-' for stdout)")
    p.add_argument("--trace", default=None, type=int, metavar="REQUEST_ID",
                   help="reconstruct one request's journey from the run "
                        "log's trace hops instead of the report")
    args = p.parse_args(argv)

    if args.trace is not None:
        from multihop_offload_tpu_torch.obs.trace import render_trace

        print(render_trace(args.path, args.trace), end="")
        return 0

    from multihop_offload_tpu_torch.obs.report import load_run, render_report

    if args.json:
        run = load_run(args.path)
        run.pop("last", None)
        print(json.dumps(run, indent=1, default=str))
    else:
        print(render_report(args.path), end="")

    if args.prom is not None:
        text = _snapshot_to_prometheus(load_run(args.path)["metrics"])
        if args.prom == "-":
            sys.stdout.write(text)
        else:
            with open(args.prom, "w") as f:
                f.write(text)
            print(f"wrote {args.prom}")
    return 0


def _snapshot_to_prometheus(metrics: dict) -> str:
    """Re-render a summary event's metric snapshot (plain dicts — the live
    registry is gone by the time the report runs) as exposition text.
    Histogram snapshots carry only count/sum/min/max, so they render as
    `_count`/`_sum` pairs without buckets."""
    lines = []
    for name in sorted(metrics):
        m = metrics[name]
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m.get('kind', 'untyped')}")
        for labels, v in sorted((m.get("series") or {}).items()):
            if isinstance(v, dict):  # histogram snapshot
                lines.append(f"{name}_count{labels} {v.get('count', 0)}")
                lines.append(f"{name}_sum{labels} {v.get('sum', 0.0)}")
            else:
                fv = float(v)
                sv = repr(int(fv)) if fv == int(fv) else repr(fv)
                lines.append(f"{name}{labels} {sv}")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    sys.exit(main())
