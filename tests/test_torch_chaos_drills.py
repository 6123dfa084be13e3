"""PyTorch port of the chaos drill matrix (`chaos/drills.py`, `cli/chaos.py`)
on the CPU, with the JAX package as the reference for the decisions.

One module-scoped `ChaosSmoke` serves every drill, in float64, with the
JAX service's fresh-init weights (carried over by `params_from_jax`): the
golden decisions its baseline captures on the champion the rollback
re-pins equal JAX's service at the same weights and requests.  Every drill
of JAX's matrix has its test here, the ten-site kill matrix as one
parametrised test; the drills' checks are JAX's, and JAX's retrace checks
are reported as not applicable, never as passed.  JAX's own host-loss
drill fails its retrace check on the CPU (ROADMAP.md Queue 3); the port's
holds every other check it makes.
"""

import jax
import numpy as np
import pytest
import torch

from multihop_offload_tpu.chaos import drills as j_drills
from multihop_offload_tpu.cli import chaos as j_chaos_cli
from multihop_offload_tpu.cli.serve import build_service as j_build_service
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.serve import workload as jwork
from multihop_offload_tpu_torch.chaos import drills
from multihop_offload_tpu_torch.cli import chaos as chaos_cli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.obs import NOT_APPLICABLE_RETRACES
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

GOLDEN_IDS = 50_000   # the baseline drill's golden window


def _closed_loop(svc, reqs) -> dict:
    pending = list(reqs)
    pending.reverse()
    out = {}
    while pending or svc.queue_depth:
        while pending:
            req = pending.pop()
            if not svc.submit(req):
                pending.append(req)
                break
        for r in svc.tick():
            out[r.request_id] = r
    return out


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The port's drill harness at the JAX service's weights, the baseline
    cycle run, and the JAX service's answers to the golden window."""
    obs_registry().reset()
    tmp = str(tmp_path_factory.mktemp("chaos"))
    jcfg = j_drills.smoke_config(JConfig(seed=0, dtype="float64"), tmp + "/jax")
    t = {"now": 0.0}
    jsvc, jpool = j_build_service(jcfg, clock=lambda: t["now"])
    cfg = Config(seed=0, dtype="float64")
    model = tcheb.make_model(drills.smoke_config(cfg, tmp), dtype=torch.float64)
    model.load_state_dict(tcheb.params_from_jax(jax.device_get(jsvc.executor.variables)))
    harness = drills.ChaosSmoke(cfg, tmp + "/port", device="cpu", model=model)
    rec = harness.run_baseline()
    assert rec["ok"], rec
    reqs = jwork.request_stream(jpool, 6, seed=jcfg.seed + 1 + GOLDEN_IDS,
                                arrival_scale=jcfg.arrival_scale, ul=jcfg.ul_data,
                                dl=jcfg.dl_data, t_max=float(jcfg.T), id_offset=GOLDEN_IDS)
    harness.jax_golden = _closed_loop(jsvc, reqs)
    return harness


def _ok(rec) -> None:
    """Every check that applies passed; the others say why they do not."""
    failed = [k for k, v in rec["checks"].items() if v is not True
              and not (isinstance(v, dict) and v.get("not_applicable"))]
    assert rec["ok"] and not failed, (rec["name"], failed, rec)


def _not_applicable(rec, key: str) -> None:
    """JAX's retrace check: reported as not applicable, never passed."""
    assert rec["checks"][key] == {"ok": None, "not_applicable": NOT_APPLICABLE_RETRACES}
    assert key in rec["not_applicable"]


def test_baseline_golden_decisions_equal_jax(smoke):
    """The champion the rollback re-pins answers the golden window as the
    JAX service does at the same weights: every request, `dst` and
    `is_local` bit for bit, all by the GNN."""
    assert smoke.baseline_terminal == {"final_state": "rolled_back", "final_loaded_step": 3,
                                       "lineage_source": "rollback",
                                       "lineage_parent_step": 2}
    assert set(smoke.golden) == set(smoke.jax_golden) and len(smoke.golden) == 6
    for rid, want in smoke.jax_golden.items():
        got = smoke.golden[rid]
        assert got.served_by == want.served_by == "gnn"
        np.testing.assert_array_equal(got.dst, want.dst)
        np.testing.assert_array_equal(got.is_local, want.is_local)


@pytest.mark.parametrize("site", drills.KILL_SITES)
def test_kill_and_resume_reaches_baseline_terminal(smoke, site):
    rec = smoke.run_kill(site)
    _ok(rec)
    assert rec["terminal"] == smoke.baseline_terminal
    assert rec["resumed_from"] is not None, f"{site}: journal not consulted"


@pytest.mark.parametrize("drill", ["run_ckpt_truncation", "run_ckpt_bitflip"])
def test_corrupt_checkpoint_quarantined_last_good_serves(smoke, drill):
    rec = getattr(smoke, drill)()
    _ok(rec)
    assert rec["checks"]["stayed_on_last_good"] and rec["checks"]["quarantine_event"]


def test_weight_poison_hot_reload_drill(smoke):
    rec = smoke.run_weight_poison_hot_reload()
    _ok(rec)
    assert rec["checks"]["poison_passes_checksum"] and rec["checks"]["no_quarantine"]


def test_weight_poison_promotion_drill(smoke):
    rec = smoke.run_weight_poison_promotion()
    _ok(rec)
    assert rec["checks"]["typed_reason"] and rec["checks"]["canarying_journaled"]


@pytest.mark.parametrize("drill", ["run_log_torn_record", "run_log_missing_segment"])
def test_event_log_drills(smoke, drill):
    _ok(getattr(smoke, drill)())


def test_stuck_tick_degrades_then_recovers(smoke):
    rec = smoke.run_stuck_tick()
    _ok(rec)
    assert rec["checks"]["degraded_not_wrong"] and rec["checks"]["gnn_restored_after_recovery"]


def test_clock_skew_drill(smoke):
    _ok(smoke.run_clock_skew())


def test_transient_io_absorbed(smoke):
    rec = smoke.run_transient_io()
    _ok(rec)


def test_cooldown_survives_restart(smoke):
    _ok(smoke.run_cooldown_restart())


def test_candidate_gc_bounded(smoke):
    _ok(smoke.run_candidate_gc())


def test_device_loss_drill_replaces_and_recovers(smoke):
    """A fleet of four (`[cpu] * 4`) loses a member: forced re-placement,
    the same decisions for the same ids, conservation, restoration."""
    rec = smoke.run_device_loss()
    _ok(rec)
    assert "skipped" not in rec and rec["checks"]["multi_device_before_loss"]


def test_host_loss_drill_replans_and_conserves(smoke):
    """The two-level plan over two pseudo-hosts of two members: every
    check of JAX's drill that applies to eager torch holds; its retrace
    check (the one JAX's own drill fails) is not applicable."""
    rec = smoke.run_host_loss()
    _ok(rec)
    for key in ("plan_spans_hosts_before_loss", "forced_replan_excludes_victim",
                "decisions_never_wrong", "conservation", "host_restored"):
        assert rec["checks"][key] is True, key
    _not_applicable(rec, "zero_unexpected_retraces")


def test_no_retrace_after_recovery_reports_not_applicable(smoke):
    rec = smoke.run_no_retrace_after_recovery()
    _ok(rec)
    _not_applicable(rec, "zero_unexpected_retraces")


def test_every_jax_drill_has_a_port_counterpart():
    """The matrix's drills and the CLI's fault sites are JAX's."""
    port = {n for n in dir(drills.ChaosSmoke) if n.startswith("run_")}
    jax = {n for n in dir(j_drills.ChaosSmoke) if n.startswith("run_")}
    assert port == jax
    assert drills.KILL_SITES == j_drills.KILL_SITES
    assert [(s, k) for s, k, _ in chaos_cli.FAULT_SITES] == \
        [(s, k) for s, k, _ in j_chaos_cli.FAULT_SITES]
    assert "run the drill matrix" in chaos_cli.render_sites()
