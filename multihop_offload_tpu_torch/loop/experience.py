"""Experience capture: serve outcomes -> JSONL -> replay batches.

Port of `multihop_offload_tpu/loop/experience.py`.  The serving tick emits
one "outcome" event per sampled answered request -- the full request (so
training can rebuild the exact instance), the decision taken, and the
measured result (tau, wall latency, degradation).  This module owns both
directions of that boundary:

- `sampled` + `outcome_record`: what `serve.service` calls at capture
  time.  Sampling is a deterministic hash of the request id, not an RNG --
  whether a request is captured never depends on process history, so a
  replayed workload captures the identical subset (the JAX package's
  subset: the hash is the same).
- `read_outcomes` + `replay_batches`: what `loop.refit` and
  `loop.validate` consume.  An `Outcome` wraps a reconstructed
  `OffloadRequest`, so the replay path reuses `serve.bucketing.pack_bucket`
  verbatim -- experience batches are bit-compatible with what the service
  itself would pack.

Everything in a record is JSON-native (lists, not arrays): the run log
serializes unknown types through `str`, which would silently garble numpy
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch.graphs.instance import PadSpec
from multihop_offload_tpu_torch.graphs.topology import build_topology
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import cf_nnz_count, ext_nnz_count
from multihop_offload_tpu_torch.obs.events import read_events
from multihop_offload_tpu_torch.serve.bucketing import pack_bucket
from multihop_offload_tpu_torch.serve.request import OffloadRequest, OffloadResponse


def _hash01(x: int, salt: int = 0) -> float:
    """Deterministic uniform-ish [0, 1) from an integer id (Knuth
    multiplicative + an xor-shift finalizer); `salt` decorrelates
    independent uses (capture sampling vs holdout split)."""
    h = (int(x) * 2654435761 + salt * 40503) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 2246822519) & 0xFFFFFFFF
    h ^= h >> 13
    return h / 2.0**32


def sampled(request_id: int, rate: float) -> bool:
    """Capture decision for one request id at sampling rate `rate`."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return _hash01(request_id, salt=1) < rate


def outcome_record(req: OffloadRequest, resp: OffloadResponse) -> dict:
    """JSON-safe fields of one captured outcome (the "outcome" event body)."""
    from multihop_offload_tpu_torch.obs.spans import current_trace_id

    job_total = np.asarray(resp.job_total, np.float64)
    topo = req.topo
    return {
        "request_id": int(req.request_id),
        # the serving tick's span trace id: links this outcome to the
        # request's trace hops (obs.trace)
        "trace_id": current_trace_id(),
        # topology as its edge list: adjacency (and everything derived)
        # rebuilds exactly via build_topology at read time
        "n": int(topo.n),
        "link_ends": np.asarray(topo.link_ends).tolist(),
        "pos": None if topo.pos is None else np.asarray(topo.pos).tolist(),
        "cf_radius": float(topo.cf_radius),
        "roles": np.asarray(req.roles).tolist(),
        "proc_bws": np.asarray(req.proc_bws, np.float64).tolist(),
        "link_rates": np.asarray(req.link_rates, np.float64).tolist(),
        "job_src": np.asarray(req.job_src).tolist(),
        "job_rate": np.asarray(req.job_rate, np.float64).tolist(),
        "ul": float(req.ul),
        "dl": float(req.dl),
        "t_max": float(req.t_max),
        "topo_key": None if req.topo_key is None else str(req.topo_key),
        # the decision and its measured outcome
        "dst": np.asarray(resp.dst).tolist(),
        "is_local": np.asarray(resp.is_local, bool).tolist(),
        "job_total": job_total.tolist(),
        "tau": float(job_total.mean()) if job_total.size else 0.0,
        "latency_s": float(resp.latency_s),
        "served_by": resp.served_by,
        "bucket": int(resp.bucket),
        "degraded": resp.served_by != "gnn",
    }


@dataclasses.dataclass(frozen=True)
class Outcome:
    """One captured (request, decision, measurement) triple, reconstructed."""

    request: OffloadRequest
    dst: np.ndarray          # (j,) int32 chosen compute node per job
    is_local: np.ndarray     # (j,) bool
    job_total: np.ndarray    # (j,) measured/empirical per-job delay
    tau: float               # mean job_total over the request's real jobs
    latency_s: float
    served_by: str
    bucket: int
    degraded: bool


def outcome_from_event(ev: dict) -> Outcome:
    """Rebuild an `Outcome` (including its full `OffloadRequest`) from one
    "outcome" event row."""
    n = int(ev["n"])
    adj = np.zeros((n, n), np.uint8)
    ends = np.asarray(ev["link_ends"], np.int32).reshape(-1, 2)
    adj[ends[:, 0], ends[:, 1]] = 1
    adj[ends[:, 1], ends[:, 0]] = 1
    pos = None if ev.get("pos") is None else np.asarray(ev["pos"], np.float64)
    topo = build_topology(adj, pos=pos, cf_radius=float(ev.get("cf_radius", 0.0)))
    req = OffloadRequest(
        request_id=int(ev["request_id"]),
        topo=topo,
        roles=np.asarray(ev["roles"], np.int32),
        proc_bws=np.asarray(ev["proc_bws"], np.float64),
        link_rates=np.asarray(ev["link_rates"], np.float64),
        job_src=np.asarray(ev["job_src"], np.int32),
        job_rate=np.asarray(ev["job_rate"], np.float64),
        ul=float(ev["ul"]),
        dl=float(ev["dl"]),
        t_max=float(ev["t_max"]),
        topo_key=ev.get("topo_key"),
    )
    return Outcome(
        request=req,
        dst=np.asarray(ev["dst"], np.int32),
        is_local=np.asarray(ev["is_local"], bool),
        job_total=np.asarray(ev["job_total"], np.float64),
        tau=float(ev["tau"]),
        latency_s=float(ev["latency_s"]),
        served_by=str(ev["served_by"]),
        bucket=int(ev["bucket"]),
        degraded=bool(ev["degraded"]),
    )


def read_outcomes(path: str, include_degraded: bool = False) -> List[Outcome]:
    """All captured outcomes in a (possibly rotated) run log.  Degraded
    (baseline-served) outcomes are excluded by default: they carry no
    signal about the GNN policy being refit."""
    out = []
    for ev in read_events(path):
        if ev.get("event") != "outcome":
            continue
        o = outcome_from_event(ev)
        if include_degraded or not o.degraded:
            out.append(o)
    return out


def split_holdout(
    outcomes: Sequence[Outcome], frac: float
) -> Tuple[List[Outcome], List[Outcome]]:
    """(train, holdout) split, deterministic per request id -- re-reading a
    grown log never moves a request across the boundary (the validator must
    not score the candidate on its own training data)."""
    train, hold = [], []
    for o in outcomes:
        (hold if _hash01(o.request.request_id, salt=2) < frac else train).append(o)
    return train, hold


def pad_for_outcomes(
    outcomes: Sequence[Outcome], round_to: int = 8, layout=None
) -> PadSpec:
    """One pad shape covering every captured request (the refit/validate
    fleet is a single bucket).  Under the sparse layout the edge-list pads
    are sized from the requests too, rounded up to 128, as
    `graphs.cases.request_batch` sizes them."""
    pad = PadSpec.for_cases([o.request.sizes for o in outcomes], round_to=round_to)
    if resolve_layout(layout).sparse:
        reqs = [o.request for o in outcomes]
        enn = max(ext_nnz_count(r.topo, np.asarray(r.roles) < 2) for r in reqs)
        cnn = max(cf_nnz_count(r.topo) for r in reqs)
        pad = dataclasses.replace(pad, enn=PadSpec.round_up(enn, 128),
                                  cnn=PadSpec.round_up(cnn, 128))
    return pad


def replay_batches(
    outcomes: Sequence[Outcome],
    pad: PadSpec,
    slots: int,
    dtype=torch.float32,
    hop_cache: Optional[dict] = None,
    layout=None,
    device="cpu",
) -> Iterator[Tuple]:
    """Yield `(binst, bjobs)` batches of `slots` lanes on `device` -- the
    service's own packer over the logged requests, so refit trains on
    exactly the padded layout that served them.  The final partial batch
    pads by repetition (pack_bucket's rule), same as a partially filled
    serving tick."""
    reqs = [o.request for o in outcomes]
    for i in range(0, len(reqs), slots):
        yield pack_bucket(reqs[i:i + slots], pad, slots, dtype=dtype,
                          hop_cache=hop_cache, layout=layout, device=device)
