"""Admission guards: semantic validation of OffloadRequests at submit time.

Port of `multihop_offload_tpu/serve/guards.py` (host numpy): the same
reasons, checked in the same order.

The bucketer protects *shapes*, but nothing between the client and the
batched decision path validates *meaning*: an out-of-range `job_src`, a NaN
rate, or a rho>=1 task stream would come back as silently-wrong numbers.  `validate_request` closes that hole on the host,
before a request ever touches a bucket — malformed requests get an honest
typed `Rejection` (mirrored into `mho_serve_rejected_total{reason=}`), never
a response.

Checks run cheapest-first and first-failure-wins, so each `reason` is a
stable contract:

  bad_shape         array lengths disagree with the instance sizes
  bad_node_id       job_src outside [0, n)
  bad_role          job sourced at a non-mobile node, or no server present
  nonfinite         any NaN/Inf rate, bandwidth, or scalar
  nonpositive_rate  rates/bandwidths/scalars that must be > 0 are not
  saturated         aggregate offered load >= max_rho * compute capacity
  disconnected      topology sizes inconsistent or graph not connected

The saturation check is deliberately aggregate and lenient (sum of
job demand vs sum of compute capacity): it rejects only streams the
queueing model cannot serve at any placement (rho >= 1 globally), never
merely-congested ones — the empirical model's congestion fallback handles
those honestly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from multihop_offload_tpu_torch.serve.request import OffloadRequest

# The closed vocabulary of rejection reasons — label values of
# `mho_serve_rejected_total{reason=}`.
REASONS = (
    "bad_shape",
    "bad_node_id",
    "bad_role",
    "nonfinite",
    "nonpositive_rate",
    "saturated",
    "disconnected",
)


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed admission refusal: a stable `reason` plus a human detail."""

    reason: str
    detail: str

    def __post_init__(self):
        if self.reason not in REASONS:
            raise ValueError(f"unknown rejection reason '{self.reason}'")


def _finite(*arrays) -> bool:
    return all(bool(np.isfinite(np.asarray(a, dtype=np.float64)).all())
               for a in arrays)


def validate_request(
    req: OffloadRequest, max_rho: float = 1.0
) -> Optional[Rejection]:
    """None iff `req` is semantically servable; else the first failure.

    Host-side numpy only — runs at submit time on true-size (unpadded)
    arrays, so the cost is microseconds per request.
    """
    n = int(req.topo.n)
    roles = np.asarray(req.roles)
    proc_bws = np.asarray(req.proc_bws, dtype=np.float64)
    link_rates = np.asarray(req.link_rates, dtype=np.float64)
    job_src = np.asarray(req.job_src)
    job_rate = np.asarray(req.job_rate, dtype=np.float64)

    # -- bad_shape: every array must agree with the instance sizes --------
    if roles.ndim != 1 or roles.shape[0] != n:
        return Rejection("bad_shape", f"roles shape {roles.shape} != ({n},)")
    if proc_bws.ndim != 1 or proc_bws.shape[0] != n:
        return Rejection(
            "bad_shape", f"proc_bws shape {proc_bws.shape} != ({n},)")
    if link_rates.ndim != 1 or link_rates.shape[0] != req.topo.num_links:
        return Rejection(
            "bad_shape",
            f"link_rates shape {link_rates.shape} != ({req.topo.num_links},)",
        )
    if (job_src.ndim != 1 or job_rate.ndim != 1
            or job_src.shape[0] != job_rate.shape[0] or job_src.shape[0] < 1):
        return Rejection(
            "bad_shape",
            f"jobs src {job_src.shape} / rate {job_rate.shape} "
            "(must be equal-length, >= 1)",
        )

    # -- bad_node_id: sources must name real nodes ------------------------
    if bool((job_src < 0).any()) or bool((job_src >= n).any()):
        bad = job_src[(job_src < 0) | (job_src >= n)]
        return Rejection("bad_node_id", f"job_src {bad.tolist()} not in [0, {n})")

    # -- bad_role: valid role vocabulary, mobile sources, >=1 server ------
    if not bool(np.isin(roles, (0, 1, 2)).all()):
        return Rejection("bad_role", "roles outside {0 mobile, 1 server, 2 relay}")
    if not bool((roles == 1).any()):
        return Rejection("bad_role", "no server in instance")
    if bool((roles[job_src] != 0).any()):
        bad = job_src[roles[job_src] != 0]
        return Rejection("bad_role", f"jobs sourced at non-mobile nodes {bad.tolist()}")

    # -- nonfinite: before positivity, so NaN reads as nonfinite ----------
    if not _finite(proc_bws, link_rates, job_rate, req.ul, req.dl, req.t_max):
        return Rejection("nonfinite", "non-finite rate/bandwidth/scalar")

    # -- nonpositive_rate: the queueing model needs strictly positive -----
    if bool((job_rate <= 0.0).any()):
        return Rejection("nonpositive_rate", "job_rate must be > 0")
    if bool((link_rates <= 0.0).any()):
        return Rejection("nonpositive_rate", "link_rates must be > 0")
    # relays carry no compute, so only mobile/server bandwidths must be > 0
    if bool((proc_bws[roles != 2] <= 0.0).any()):
        return Rejection("nonpositive_rate", "compute proc_bws must be > 0")
    if not (req.ul > 0.0 and req.dl > 0.0 and req.t_max > 0.0):
        return Rejection("nonpositive_rate", "ul/dl/t_max must be > 0")

    # -- saturated: aggregate offered load vs aggregate compute capacity --
    offered = float(job_rate.sum()) * float(req.ul)
    capacity = float(proc_bws[roles != 2].sum())
    # capacity > 0: the nonpositive_rate check above
    rho = offered / capacity
    if rho >= max_rho:
        return Rejection(
            "saturated",
            f"offered load rho={rho:.3f} >= {max_rho:g} "
            f"(sum(job_rate)*ul={offered:.3f}, capacity={capacity:.3f})",
        )

    # -- disconnected: topology must be internally consistent + connected -
    if req.topo.adj.shape != (n, n):
        return Rejection(
            "disconnected", f"topology adj {req.topo.adj.shape} != ({n}, {n})")
    if not req.topo.connected:
        return Rejection("disconnected", "topology is not connected")

    return None
