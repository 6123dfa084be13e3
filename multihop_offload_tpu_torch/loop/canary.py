"""Semantic checkpoint canary: golden-probe decisions gate every swap.

Port of `multihop_offload_tpu/loop/canary.py`.
`train.checkpoints.tree_checksum` proves a candidate's BYTES are what was
written; `serve.executor.param_signature` proves its SHAPES fit the live
model.  Neither proves the weights *mean* anything -- a refit that
overflowed to NaN, or a scale-poisoned tree, is checksum-valid and
signature-valid and would serve garbage.  The canary closes that hole
semantically: a small frozen probe set (synthetic requests off the serving
pool, packed ONCE into the service's own bucket layouts) is run through any
candidate before it may replace the champion, and the candidate is refused
when

  * any live probe output (delay estimate / empirical score) is NaN/Inf, or
  * its decisions (dst, is_local) agree with the champion's recorded golden
    answers on less than `min_agreement` of probe jobs -- the decision-
    collapse signature of weight poisoning that finiteness alone misses.

A probe is the executor's own GNN decision pass (`gnn_step`: K1 and K2 on
the card, K1, K4 and K6 under the sparse layout) on a copy of the serving
model that carries the candidate's weights, so probe decisions and serving
decisions are the same code at the same pad shapes.  Wired into
`loop.promote` (journaled "canarying" state) and the executor's weight
swaps (`serve.executor.load_params`, pre-swap check via
`executor.canary`); rejection means the champion simply keeps serving --
it is not corruption, so nothing is quarantined.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from multihop_offload_tpu_torch.serve.bucketing import pack_bucket
from multihop_offload_tpu_torch.serve.workload import request_stream

# probe ids live far above any real traffic so trace/experience streams
# can never collide with a client request id
PROBE_ID_OFFSET = 900_000


class CheckpointCanary:
    """Frozen golden-probe gate bound to one service's executor."""

    def __init__(
        self,
        service,
        pool: Sequence,
        count: int = 8,
        seed: int = 123,
        min_agreement: float = 0.7,
    ):
        self.service = service
        self.min_agreement = float(min_agreement)
        self.golden: Optional[list] = None
        # pack once: per-bucket (batch, request ids, live-mask rows) in the
        # exact layout the serving tick uses
        self._batches = []
        by_bucket: dict = {}
        for req in request_stream(pool, count, seed=seed, id_offset=PROBE_ID_OFFSET):
            b = service.buckets.bucket_for(*req.sizes)
            if b is not None and service.layout.sparse:
                b = service._sparse_fit(req, b)
            if b is None:
                continue
            by_bucket.setdefault(b, []).append(req)
        if not by_bucket:
            raise ValueError("no probe request fits any bucket")
        hop_cache: dict = {}
        for b, reqs in sorted(by_bucket.items()):
            reqs = reqs[: service.slots]
            pad = service.buckets[b]
            binst, bjobs = pack_bucket(
                reqs, pad, service.slots, dtype=service.dtype, hop_cache=hop_cache,
                layout=service.layout, device=service.device,
            )
            ids = [r.request_id for r in reqs]
            ids += [ids[-1]] * (service.slots - len(ids))
            # live (slot, job) entries: real request rows, true job counts
            live = np.zeros((service.slots, pad.j), dtype=bool)
            for i, r in enumerate(reqs):
                live[i, : r.num_jobs] = True
            self._batches.append((b, binst, bjobs, ids, live))
        self._model = copy.deepcopy(service.executor.model)

    # ---- probe execution -------------------------------------------------

    @torch.no_grad()
    def _probe(self, params: dict) -> list:
        """Run every probe batch through the executor's GNN decision pass
        with `params` (a state dict); host (dst, is_local, delay_est,
        job_total, live) per batch."""
        ex = self.service.executor
        for k, p in self._model.named_parameters():
            p.copy_(params[k].to(p.device, p.dtype))
        out_rows = []
        for _b, binst, bjobs, ids, live in self._batches:
            gens = None
            if ex.prob:
                gens = [self.service.request_generator(i) for i in ids]
            out = ex.gnn_step(binst, bjobs, gens, model=self._model)
            host = tuple(t.detach().cpu().double().numpy() if t.is_floating_point()
                         else t.detach().cpu().numpy() for t in out)
            out_rows.append((*host, live))
        return out_rows

    def record_champion(self) -> None:
        """Snapshot the CURRENT champion's probe answers as the golden set."""
        self.golden = [
            (dst.copy(), is_local.copy())
            for dst, is_local, _d, _t, _live in self._probe(
                self.service.executor.model.state_dict())
        ]

    # ---- the gate --------------------------------------------------------

    def check(self, candidate_variables) -> Optional[str]:
        """None iff the candidate (`{"params": state_dict}`) passes; else a
        typed refusal reason."""
        rows = self._probe(candidate_variables["params"])
        for _dst, _is_local, delay_est, job_total, live in rows:
            bad = (~np.isfinite(delay_est) | ~np.isfinite(job_total)) & live
            if bool(bad.any()):
                return "nonfinite_probe_outputs"
        if self.golden is None:
            return None  # no champion recorded yet: finiteness-only gate
        agree = 0
        total = 0
        for (gdst, glocal), (dst, is_local, _d, _t, live) in zip(self.golden, rows):
            total += int(live.sum())
            agree += int(((dst == gdst) & (is_local == glocal) & live).sum())
        frac = agree / max(total, 1)
        if frac < self.min_agreement:
            # typed tag first (the counter label), detail after the colon
            return (f"decision_collapse:agreement {frac:.3f} < "
                    f"{self.min_agreement:g}")
        return None
