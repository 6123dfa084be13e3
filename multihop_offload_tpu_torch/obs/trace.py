"""Request-scoped end-to-end tracing: one request's journey as hop events.

Port of `multihop_offload_tpu/obs/trace.py` (standard library only).

Every stage that touches a batch of requests emits ONE ``trace`` event
carrying the batch's `request_ids` plus the active span's trace id
(`obs.spans.current_trace_id`), so the per-request cost is amortized over
the batch.  The hop chain across the whole system:

    submit -> pack -> dispatch -> decision -> capture      (serve tick)
           -> sim_outcome                                  (A/B validation)
           -> refit_batch -> promotion                     (flywheel)

Per-request detail rides in list-valued fields aligned with `request_ids`
(e.g. ``latency_s=[...]``): `reconstruct` picks out this request's element
by position, so a hop event stores N scalars once instead of N events.

`reconstruct(path, request_id)` walks the rotated run-log chain through
`obs.events.read_events` (segment boundaries are transparent) and returns
the request's hops in emission order.  Emission is a no-op without an
active run log — the hot path pays one `is None` check.  `render_trace`
is the `cli/obs.py --trace` view.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs import spans as obs_spans

# event fields that are structural, never per-request payload
_META_FIELDS = ("event", "ts", "hop", "request_ids", "trace_id")


def hop(name: str, request_ids: Iterable[int], **fields) -> None:
    """Emit one batched trace hop for `request_ids` (no-op without an
    active run log).  List-valued fields of the same length as
    `request_ids` are treated as per-request columns by `reconstruct`."""
    log = obs_events.get_run_log()
    if log is None:
        return
    ids = [int(r) for r in request_ids]
    if not ids:
        return
    log.emit("trace", hop=str(name), request_ids=ids,
             trace_id=obs_spans.current_trace_id(), **fields)


def reconstruct(path: str, request_id: int) -> List[dict]:
    """This request's hops, in emission order, each flattened to scalars:
    {hop, ts, trace_id, **fields} with aligned list columns reduced to the
    request's own element."""
    rid = int(request_id)
    out: List[dict] = []
    for ev in obs_events.read_events(path):
        if ev.get("event") != "trace":
            continue
        ids = ev.get("request_ids") or []
        if rid not in ids:
            continue
        i = ids.index(rid)
        rec = {
            "hop": ev.get("hop", "?"),
            "ts": ev.get("ts"),
            "trace_id": ev.get("trace_id"),
            "batch": len(ids),
        }
        for k, v in ev.items():
            if k in _META_FIELDS:
                continue
            if isinstance(v, list) and len(v) == len(ids):
                rec[k] = v[i]
            else:
                rec[k] = v
        out.append(rec)
    return out


def render_trace(path: str, request_id: int) -> str:
    """The `cli/obs.py --trace` view: relative-time hop table for one request."""
    hops = reconstruct(path, request_id)
    lines = [f"trace — request {int(request_id)} ({path})"]
    if not hops:
        lines.append("  no trace events for this request "
                     "(tracing off, or the log rotated past them)")
        return "\n".join(lines) + "\n"
    t0: Optional[float] = None
    for h in hops:
        if isinstance(h.get("ts"), (int, float)):
            t0 = h["ts"] if t0 is None else min(t0, h["ts"])
    trace_ids = {h.get("trace_id") for h in hops if h.get("trace_id")}
    lines.append(f"  {len(hops)} hops, {len(trace_ids)} span trace id(s)")
    for h in hops:
        ts = h.get("ts")
        rel = (f"+{ts - t0:9.3f}s" if isinstance(ts, (int, float))
               and t0 is not None else " " * 11)
        detail = ", ".join(
            f"{k}={_fmt(v)}" for k, v in h.items()
            if k not in ("hop", "ts", "trace_id") and v is not None
        )
        lines.append(f"  {rel}  {h['hop']:<12} {detail}")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
