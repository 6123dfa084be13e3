"""The input-fuzzing smoke: semantic garbage in, typed rejections out.

Port of `multihop_offload_tpu/chaos/fuzz.py`.  One `FuzzSmoke` run builds
a single tiny service and throws the whole `faults.REQUEST_MUTATIONS`
catalogue at its front door -- NaN and negative rates, out-of-range and
wrong-role sources, length mismatches, non-finite bandwidths, saturating
load -- across several seeds each, interleaved with valid traffic.  The
invariants that make it a guardrail proof rather than a crash hunt:

- zero uncontained faults: no fuzzed input raises out of `submit` or
  reaches a decision pass; every one is refused at admission with the
  typed `reason` its mutation predicts (`serve.guards`);
- valid traffic unperturbed: the same valid request ids served before,
  among and after the garbage keep bit-identical decisions -- the guards
  veto, they never perturb;
- conservation: every admitted request is answered exactly once and
  every fuzzed one is counted in `rejected_invalid` /
  `mho_serve_rejected_total`;
- no live non-finite output (`mho_dev_serve_nonfinite_total` stays 0).

JAX's fourth, zero unexpected retraces, is a compile property: the record
reports it as not applicable (`obs.NOT_APPLICABLE_RETRACES`).  Two
weight-surface legs ride along: a checksum-valid NaN-poisoned checkpoint
refused by the semantic canary at hot reload, and byte-corrupt
checkpoints quarantined by verification.  On the card the service runs
K1 and K2 (two dense buckets).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np

from multihop_offload_tpu_torch.chaos import faults
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs import NOT_APPLICABLE_RETRACES

FUZZ_SEEDS = (0, 1, 2)


def fuzz_config(cfg: Config, tmp: str) -> Config:
    """Tiny two-bucket service shared by every leg (JAX's), two buckets so
    routing stays exercised."""
    return dataclasses.replace(
        cfg,
        serve_sizes="10,14", serve_buckets=2, serve_slots=4,
        serve_queue_cap=64, serve_deadline_s=60.0,
        model_root=os.path.join(tmp, "model"),
        obs_log=os.path.join(tmp, "fuzz_run.jsonl"),
        loop_capture_sample=0.0,
        io_retries=3, io_backoff_s=0.0,
    )


class FuzzSmoke:
    """State shared across the legs: ONE service, one registry.  `device`
    (default CUDA) is where it serves; `model` its weights (default: the
    fresh init of `cfg.seed`)."""

    def __init__(self, cfg: Config, tmp: str, device=None, model=None):
        from multihop_offload_tpu_torch._device import resolve_device
        from multihop_offload_tpu_torch.cli.serve import build_service

        self.tmp = tmp
        self.device = resolve_device(device)
        self.base = fuzz_config(cfg, tmp)
        self.t = {"now": 0.0}
        self.clock: Callable[[], float] = lambda: self.t["now"]
        self.service, self.pool = build_service(self.base, clock=self.clock,
                                                device=self.device, model=model)
        self.legs: list = []
        self.served: dict = {}   # every valid response, by leg

    # ---- shared plumbing ---------------------------------------------------

    def _stream(self, count: int, id_offset: int) -> list:
        from multihop_offload_tpu_torch.serve.workload import request_stream

        cfg = self.base
        return list(request_stream(
            self.pool, count, seed=cfg.seed + 1 + id_offset,
            arrival_scale=cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data,
            t_max=float(cfg.T), id_offset=id_offset,
        ))

    def _serve(self, reqs: list) -> dict:
        """Closed loop over `reqs`; {request_id: response}.  Only
        backpressure is retried: any other refusal is the drop a leg
        asserts on."""
        pending = list(reqs)
        pending.reverse()
        out = {}
        while pending or self.service.queue_depth:
            while pending:
                req = pending.pop()
                if not self.service.submit(req):
                    if self.service.last_submit_outcome == "backpressure":
                        pending.append(req)
                    break
            for r in self.service.tick():
                out[r.request_id] = r
        return out

    def _finish(self, rec: dict) -> dict:
        rec["ok"] = all(v for v in rec["checks"].values() if isinstance(v, bool))
        self.legs.append(rec)
        return rec

    # ---- legs --------------------------------------------------------------

    def run_typed_rejections(self) -> dict:
        """Every mutation family x seed: refused with exactly the reason the
        catalogue predicts, through the pure validator and through
        `submit`."""
        from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
        from multihop_offload_tpu_torch.serve.guards import validate_request

        reg = obs_registry()
        before = reg.counter("mho_serve_rejected_total").total()
        invalid_before = self.service.stats.invalid
        cases = []
        uncontained = 0
        for i, (mutation, want) in enumerate(faults.REQUEST_MUTATIONS):
            for seed in FUZZ_SEEDS:
                base = self._stream(1, id_offset=200_000 + 100 * i + seed)[0]
                assert validate_request(base) is None
                try:
                    bad = faults.fuzz_request(base, mutation, seed=seed)
                    rej = validate_request(bad)
                    admitted = self.service.submit(bad)
                except Exception as e:  # an escape IS the recorded failure
                    uncontained += 1
                    cases.append({"mutation": mutation, "seed": seed, "error": repr(e)})
                    continue
                cases.append({
                    "mutation": mutation, "seed": seed, "want": want,
                    "got": rej.reason if rej is not None else None,
                    "submit_refused": not admitted,
                    "outcome": self.service.last_submit_outcome,
                })
        n = len(faults.REQUEST_MUTATIONS) * len(FUZZ_SEEDS)
        after = reg.counter("mho_serve_rejected_total").total()
        rec = {
            "name": "typed_rejections",
            "injected": f"{n} fuzzed requests ({len(faults.REQUEST_MUTATIONS)} mutation "
                        f"families x {len(FUZZ_SEEDS)} seeds)",
            "cases": cases,
            "checks": {
                "zero_uncontained": uncontained == 0,
                "all_refused": all(c.get("submit_refused") for c in cases),
                "typed_reasons_match": all(c.get("got") == c.get("want") for c in cases),
                "outcome_recorded": all(c.get("outcome") == "rejected_invalid"
                                        for c in cases),
                "stats_counted": self.service.stats.invalid - invalid_before == n,
                "registry_counted": int(after - before) == n,
            },
        }
        return self._finish(rec)

    def run_valid_bit_parity(self) -> dict:
        """The SAME valid request ids served clean, then again with fuzzed
        garbage interleaved: decisions bit-identical (keyed by request id)."""
        reqs = self._stream(8, id_offset=210_000)
        control = self._serve(list(reqs))
        mixed, garbage = [], 0
        for k, req in enumerate(reqs):
            mixed.append(req)
            mutation = faults.REQUEST_MUTATIONS[k % len(faults.REQUEST_MUTATIONS)][0]
            mixed.append(faults.fuzz_request(req, mutation, seed=k))
            garbage += 1
        replay = self._serve(mixed)
        self.served["valid_bit_parity"] = replay
        parity = {rid: bool(np.array_equal(replay[rid].dst, control[rid].dst)
                            and np.array_equal(replay[rid].is_local, control[rid].is_local))
                  for rid in control if rid in replay}
        rec = {
            "name": "valid_bit_parity",
            "injected": f"{garbage} fuzzed requests interleaved with {len(reqs)} valid "
                        "replays",
            "checks": {
                "all_valid_served": len(parity) == len(control) == len(reqs),
                "decisions_bit_identical": bool(parity) and all(parity.values()),
                "all_gnn": all(r.served_by == "gnn" for r in replay.values()),
            },
        }
        return self._finish(rec)

    def run_conservation(self) -> dict:
        """Across everything the smoke threw: every admitted request
        answered once, the queue drained, every fuzzed one counted."""
        s = self.service.stats.summary()
        rec = {
            "name": "conservation",
            "injected": None,
            "summary": {k: s[k] for k in ("admitted", "served", "rejected_invalid",
                                          "rejected_backpressure", "rejected_too_large")},
            "checks": {
                "admitted_eq_served": s["admitted"] == s["served"],
                "queue_drained": self.service.queue_depth == 0,
                "rejections_counted": s["rejected_invalid"] > 0,
            },
        }
        return self._finish(rec)

    def run_poisoned_checkpoint(self) -> dict:
        """The weight surface: a checksum-valid NaN-poisoned checkpoint is
        refused at hot reload (the semantic gate), the champion untouched
        and still serving."""
        from multihop_offload_tpu_torch.loop.canary import CheckpointCanary
        from multihop_offload_tpu_torch.loop.refit import SERVING_SUBDIR
        from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

        cfg = self.base
        directory = os.path.join(cfg.model_dir(), SERVING_SUBDIR)
        ex = self.service.executor
        host = {k: v.detach().cpu().clone() for k, v in ex.model.state_dict().items()}
        ckpt_lib.save_checkpoint(directory, 1, {"params": host},
                                 lineage=ckpt_lib.make_lineage("offline"))
        champion = self.service.hot_reload(cfg.model_dir())
        canary = CheckpointCanary(self.service, self.pool, count=6, seed=cfg.seed + 77)
        canary.record_champion()
        ex.canary = canary
        try:
            poisoned = faults.poison_checkpoint(directory, mode="nan", seed=cfg.seed)
            checksum_valid = ckpt_lib.has_verified(directory, poisoned)
            step = self.service.hot_reload(cfg.model_dir())
            served = self._serve(self._stream(4, id_offset=220_000))
        finally:
            ex.canary = None
            ex._canary_rejected.clear()
        rec = {
            "name": "poisoned_checkpoint",
            "injected": f"checksum-valid NaN poison at step {poisoned}",
            "checks": {
                "champion_loaded": champion == 1,
                "poison_passes_checksum": checksum_valid,
                "reload_refused": step is None and ex.loaded_step == 1,
                "champion_still_serving": len(served) == 4 and all(
                    r.served_by == "gnn" for r in served.values()),
            },
        }
        return self._finish(rec)

    def run_corrupt_bytes(self) -> dict:
        """The other half of the weight surface: byte corruption (a
        truncated step) is caught by integrity verification and
        quarantined; the canary never runs."""
        from multihop_offload_tpu_torch.loop.refit import SERVING_SUBDIR
        from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

        cfg = self.base
        directory = os.path.join(cfg.model_dir(), SERVING_SUBDIR)
        ex = self.service.executor
        host = {k: v.detach().cpu().clone() for k, v in ex.model.state_dict().items()}
        step = (ckpt_lib.latest_step(directory) or 0) + 1
        ckpt_lib.save_checkpoint(directory, step, {"params": host},
                                 lineage=ckpt_lib.make_lineage("refit"))
        n = 0
        for root, _, files in os.walk(os.path.join(directory, str(step))):
            for f in files:
                p = os.path.join(root, f)
                if os.path.getsize(p) > 0:
                    faults.truncate_file(p, keep_fraction=0.3)
                    n += 1
        got = self.service.hot_reload(cfg.model_dir())
        served = self._serve(self._stream(4, id_offset=230_000))
        qdir = os.path.join(directory, "quarantine")
        rec = {
            "name": "corrupt_bytes",
            "injected": f"{n} files truncated at step {step}",
            "checks": {
                "stayed_on_last_good": got in (None, 1) and ex.loaded_step == 1,
                "quarantine_dir_populated": os.path.isdir(qdir) and bool(os.listdir(qdir)),
                "kept_serving": len(served) == 4,
            },
        }
        return self._finish(rec)

    # ---- the matrix --------------------------------------------------------

    def run_all(self) -> dict:
        from multihop_offload_tpu_torch.obs.registry import registry as obs_registry

        # the non-finite sentinel counts from here (the registry is the
        # process's); one clean window first, as JAX's warms its programs
        nonfinite0 = obs_registry().counter("mho_dev_serve_nonfinite_total").total()
        self.served["warmup"] = self._serve(self._stream(4, id_offset=190_000))
        self.run_typed_rejections()
        self.run_valid_bit_parity()
        self.run_poisoned_checkpoint()
        self.run_corrupt_bytes()
        self.run_conservation()
        reg = obs_registry()

        def total(name):
            return int(reg.counter(name).total())

        record = {
            "device": str(self.device),
            "legs": self.legs,
            "counters": {
                "rejected_invalid": total("mho_serve_rejected_total"),
                "canary_rejections": total("mho_canary_rejections_total"),
                "quarantined": total("mho_ckpt_quarantined_total"),
                "serve_nonfinite": total("mho_dev_serve_nonfinite_total"),
            },
            "checks": {
                "all_legs_ok": all(leg["ok"] for leg in self.legs),
                "leg_count": len(self.legs),
                "zero_unexpected_retraces": {"ok": None,
                                             "not_applicable": NOT_APPLICABLE_RETRACES},
                "zero_live_nonfinite":
                    reg.counter("mho_dev_serve_nonfinite_total").total() == nonfinite0,
            },
        }
        record["ok"] = all(v for v in record["checks"].values() if isinstance(v, bool))
        return record


def run_smoke(cfg: Config, device=None, tmp=None) -> dict:
    """The full fuzz matrix in one temporary tree (`tmp` keeps it);
    asserts every leg's checks."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="mho_fuzz_smoke_") as own:
        harness = FuzzSmoke(cfg, tmp or own, device=device)
        record = harness.run_all()
    failed = [leg["name"] for leg in record["legs"] if not leg["ok"]]
    assert record["ok"], f"fuzz smoke failed: {failed or record['checks']}"
    return record
