"""PyTorch port of the input-fuzzing smoke (`chaos/fuzz.py`, `cli/fuzz.py`)
on the CPU, with the JAX package as the reference.

One module-scoped `FuzzSmoke` (float64, the JAX service's fresh-init
weights) runs every leg.  Each mutation's typed reason, for the same base
request and seed, equals the one JAX's `serve/guards` gives; the valid
requests served among the garbage keep the decisions the JAX service gives
them at the same weights; the weight-surface legs refuse the poisoned
checkpoint and quarantine the corrupt one; JAX's retrace check is
reported as not applicable.
"""

import jax
import numpy as np
import pytest
import torch

from multihop_offload_tpu.chaos import faults as j_faults
from multihop_offload_tpu.chaos import fuzz as j_fuzz
from multihop_offload_tpu.cli import fuzz as j_fuzz_cli
from multihop_offload_tpu.cli.serve import build_service as j_build_service
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.serve import guards as j_guards
from multihop_offload_tpu.serve import workload as jwork
from multihop_offload_tpu_torch.chaos import faults, fuzz
from multihop_offload_tpu_torch.cli import fuzz as fuzz_cli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.obs import NOT_APPLICABLE_RETRACES
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401


def _jstream(jcfg, pool, count, id_offset):
    return list(jwork.request_stream(pool, count, seed=jcfg.seed + 1 + id_offset,
                                     arrival_scale=jcfg.arrival_scale, ul=jcfg.ul_data,
                                     dl=jcfg.dl_data, t_max=float(jcfg.T),
                                     id_offset=id_offset))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's fuzz matrix at the JAX service's weights, and the JAX
    service and config for the references."""
    tmp = str(tmp_path_factory.mktemp("fuzz"))
    jcfg = j_fuzz.fuzz_config(JConfig(seed=0, dtype="float64"), tmp + "/jax")
    t = {"now": 0.0}
    jsvc, jpool = j_build_service(jcfg, clock=lambda: t["now"])
    cfg = Config(seed=0, dtype="float64")
    model = tcheb.make_model(fuzz.fuzz_config(cfg, tmp), dtype=torch.float64)
    model.load_state_dict(tcheb.params_from_jax(jax.device_get(jsvc.executor.variables)))
    harness = fuzz.FuzzSmoke(cfg, tmp + "/port", device="cpu", model=model)
    record = harness.run_all()
    return {"h": harness, "record": record, "jcfg": jcfg, "jsvc": jsvc, "jpool": jpool}


def _leg(run, name):
    return next(leg for leg in run["record"]["legs"] if leg["name"] == name)


def test_the_matrix_passes(run):
    rec = run["record"]
    assert rec["ok"] and rec["checks"]["all_legs_ok"] and rec["checks"]["leg_count"] == 5
    assert rec["checks"]["zero_live_nonfinite"] is True
    assert rec["checks"]["zero_unexpected_retraces"] == {
        "ok": None, "not_applicable": NOT_APPLICABLE_RETRACES}
    assert [leg["name"] for leg in rec["legs"]] == [
        "typed_rejections", "valid_bit_parity", "poisoned_checkpoint", "corrupt_bytes",
        "conservation"]


@pytest.mark.parametrize("mutation", [m for m, _ in faults.REQUEST_MUTATIONS])
def test_each_mutation_refused_with_jax_guards_reason(run, mutation):
    """For the leg's own base requests (same id offset and seed), JAX's
    `fuzz_request` + `validate_request` give the reason the port's leg
    recorded, the catalogue's, and the port's submit refused each."""
    cases = [c for c in _leg(run, "typed_rejections")["cases"] if c["mutation"] == mutation]
    assert len(cases) == len(fuzz.FUZZ_SEEDS)
    i = [m for m, _ in faults.REQUEST_MUTATIONS].index(mutation)
    for c in cases:
        base = _jstream(run["jcfg"], run["jpool"], 1, 200_000 + 100 * i + c["seed"])[0]
        want = j_guards.validate_request(j_faults.fuzz_request(base, mutation, seed=c["seed"]))
        assert c["got"] == want.reason == c["want"]
        assert c["submit_refused"] and c["outcome"] == "rejected_invalid"
    assert faults.REQUEST_MUTATIONS == j_faults.REQUEST_MUTATIONS


def test_valid_traffic_keeps_jax_decisions(run):
    """The valid ids replayed among the garbage: bit-identical to their
    clean run, and to the JAX service's answers at the same weights."""
    leg = _leg(run, "valid_bit_parity")
    assert leg["ok"] and leg["checks"]["decisions_bit_identical"]
    jsvc = run["jsvc"]
    pending = _jstream(run["jcfg"], run["jpool"], 8, 210_000)
    pending.reverse()
    want = {}
    while pending or jsvc.queue_depth:
        while pending:
            req = pending.pop()
            if not jsvc.submit(req):
                pending.append(req)
                break
        for r in jsvc.tick():
            want[r.request_id] = r
    got = run["h"].served["valid_bit_parity"]
    assert set(got) == set(want) and len(got) == 8
    for rid, w in want.items():
        assert got[rid].served_by == w.served_by == "gnn"
        np.testing.assert_array_equal(got[rid].dst, w.dst)
        np.testing.assert_array_equal(got[rid].is_local, w.is_local)


@pytest.mark.parametrize("name", ["poisoned_checkpoint", "corrupt_bytes", "conservation"])
def test_weight_surface_and_conservation_legs(run, name):
    leg = _leg(run, name)
    assert leg["ok"], leg


def test_catalogue_lists_jax_mutations_and_reasons():
    text = fuzz_cli.render_catalogue()
    assert text.splitlines()[1:-1] == j_fuzz_cli.render_catalogue().splitlines()[1:-1]
    assert fuzz.FUZZ_SEEDS == j_fuzz.FUZZ_SEEDS
