"""PyTorch port of `graphs/mobility.py` and `unit_disk_adjacency` against
the JAX package's functions: under the same `np.random.Generator` the
same positions, adjacencies, topologies and link maps, bit for bit."""

import dataclasses

import numpy as np
import pytest

from multihop_offload_tpu.graphs import generators as jgen
from multihop_offload_tpu.graphs import mobility as jmob
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu_torch.graphs import generators as tgen
from multihop_offload_tpu_torch.graphs import mobility as tmob
from multihop_offload_tpu_torch.graphs import topology as ttopo


def _eq_topo(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed,radius", [(0, 1.0), (1, 0.7), (2, 1.5), (3, 0.0)])
def test_unit_disk_adjacency_matches_jax(seed, radius):
    pos = np.random.default_rng(seed).uniform(0, 3, (25, 2))
    got = tgen.unit_disk_adjacency(pos, radius)
    want = jgen.unit_disk_adjacency(pos, radius)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_random_walk_and_topology_update_match_jax(seed):
    """Three mobility steps from a connected Poisson graph: the same moved
    positions and adjacency each step, the same rebuilt topology and link
    map, and per-link state carried the same way."""
    adj, pos, _ = jgen.connected_poisson_disk(16, seed=seed)
    jt, tt = jtopo.build_topology(adj, pos=pos), ttopo.build_topology(adj, pos=pos)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jpos, tpos = pos, pos.copy()
    for _ in range(3):
        jpos, jadj = jmob.random_walk(jpos, n_moving=5, step_std=0.3, rng=jr)
        tpos, tadj = tmob.random_walk(tpos, n_moving=5, step_std=0.3, rng=tr)
        np.testing.assert_array_equal(tpos, jpos)
        np.testing.assert_array_equal(tadj, jadj)
        jnew, jmap = jmob.topology_update(jt, jadj, pos=jpos)
        tnew, tmap = tmob.topology_update(tt, tadj, pos=tpos)
        _eq_topo(tnew, jnew)
        np.testing.assert_array_equal(tmap, jmap)
        state = np.random.default_rng(seed).uniform(size=(jt.num_links, 3))
        np.testing.assert_array_equal(tmob.migrate_link_state(tmap, state, fill=-1.0),
                                      jmob.migrate_link_state(jmap, state, fill=-1.0))
        jt, tt = jnew, tnew


def test_random_walk_degenerate_inputs_match_jax():
    """No movers, no step, no nodes: the positions come back unchanged;
    a disconnected input raises in both packages."""
    pos = np.random.default_rng(1).uniform(0, 2, (9, 2))
    for kw in ({"n_moving": 0}, {"step_std": 0.0}):
        got = tmob.random_walk(pos, rng=np.random.default_rng(0), **kw)
        want = jmob.random_walk(pos, rng=np.random.default_rng(0), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    empty = np.zeros((0, 2))
    assert tmob.random_walk(empty)[1].shape == jmob.random_walk(empty)[1].shape == (0, 0)
    far = np.array([[0.0, 0.0], [10.0, 10.0], [20.0, 0.0]])
    for mod in (tmob, jmob):
        with pytest.raises(RuntimeError, match="no connected perturbation"):
            mod.random_walk(far, n_moving=1, step_std=0.01, max_tries=3,
                            rng=np.random.default_rng(0))


# ---- the mobility rollout (`scripts/mobility_rollout.py`) ----------------------


ROLLOUT = dict(n=12, steps=2, rounds=2, slots=150)


@pytest.fixture(scope="module")
def rollouts():
    """The JAX script and the port's `mobility_rollout.rollout` at n = 12,
    2 steps, both float64 (the JAX run's Config and FleetSim widened by
    patching their dtype defaults), the port under the JAX run's own
    simulator uniforms (rebuilt from its keys `fold_in(PRNGKey(2), 1000 +
    8 step + policy)`) and its initial parameters.  Each run's topology
    updates, and the JAX run's analytic totals and composed taus, are
    recorded as they are made."""
    import contextlib
    import functools
    import importlib.util
    import io
    import json
    import os
    import sys

    import jax
    import jax.numpy as jnp
    import torch

    import multihop_offload_tpu.config as jconfig
    import multihop_offload_tpu.sim as jsim
    from multihop_offload_tpu.models import make_model as j_make_model
    from multihop_offload_tpu.sim import fidelity as jfid
    from multihop_offload_tpu_torch import mobility_rollout as tmr
    from multihop_offload_tpu_torch.models.chebconv import params_from_jax
    from multihop_offload_tpu_torch.sim.runner import InjectedDraws
    from tests.test_torch_scenarios import _draw_fn

    from multihop_offload_tpu.obs.registry import registry as j_registry
    from multihop_offload_tpu_torch.obs.registry import registry

    # a process keeps one queue-depth histogram cap: this module's
    # simulators must neither meet an earlier test's cap nor leave theirs
    # to a later test
    registry().reset()
    j_registry().reset()
    seen = {"j_topo": [], "t_topo": [], "j_ana": [], "j_tau": []}

    def recorder(fn, into):
        def call(*a, **k):
            out = fn(*a, **k)
            seen[into].append((out[0].adj.copy(), np.asarray(out[1]).copy()))
            return out
        return call

    def ana(inst, outcome):
        seen["j_ana"].append(np.asarray(outcome.job_total))
        return jfid_ana(inst, outcome)

    def tau(*a):
        out = jfid_tau(*a)
        seen["j_tau"].append(np.asarray(out))
        return out

    jfid_ana, jfid_tau = jfid.analytic_link_delay, jfid.composed_job_tau
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                        "mobility_rollout.py")
    spec = importlib.util.spec_from_file_location("jax_mobility_rollout", path)
    script = importlib.util.module_from_spec(spec)
    argv = ["mobility_rollout.py"] + [f"--{k}={v}" for k, v in ROLLOUT.items()]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "Config", functools.partial(jconfig.Config, dtype="float64"))
        mp.setattr(jsim, "FleetSim", functools.partial(jsim.FleetSim, dtype=jnp.float64))
        mp.setattr(jmob, "topology_update", recorder(jmob.topology_update, "j_topo"))
        mp.setattr(jfid, "analytic_link_delay", ana)
        mp.setattr(jfid, "composed_job_tau", tau)
        mp.setattr(sys, "argv", argv)
        spec.loader.exec_module(script)
        with contextlib.redirect_stdout(out):
            assert script.main() == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]

    # the JAX run's initial parameters, drawn as the script draws them
    e = 8 * 2 + 8 * 8  # any E: the parameters' shapes do not depend on it
    variables = j_make_model(jconfig.Config(cheb_k=1, dtype="float64")).init(
        jax.random.PRNGKey(1), jnp.zeros((e, 4)), jnp.zeros((e, e)))

    def draws(step, pi, sim):
        keys = jax.random.fold_in(jax.random.PRNGKey(2), 1000 + 8 * step + pi)[None]
        sp = sim.spec
        widths = (sp.num_links, sp.num_links, sp.num_nodes, sp.num_streams)
        u = _draw_fn(widths, sim.rounds, sim.slots_per_round)(keys)
        return InjectedDraws(*[torch.from_numpy(np.array(x)) for x in u])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmob, "topology_update", recorder(tmob.topology_update, "t_topo"))
        got = tmr.rollout(ROLLOUT, variables=params_from_jax(jax.device_get(variables)),
                          draws=draws, device="cpu", dtype=torch.float64, verbose=False)
    yield got, lines, seen
    registry().reset()
    j_registry().reset()


def test_rollout_topologies_and_link_maps_match_jax(rollouts):
    got, lines, seen = rollouts
    assert len(seen["t_topo"]) == len(seen["j_topo"]) == ROLLOUT["steps"]
    for (ta, tm), (ja, jm) in zip(seen["t_topo"], seen["j_topo"]):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tm, jm)
    for row, want in zip(got["per_step"], lines):
        assert (row["step"], row["links"], row["new_links"]) == (
            want["step"], want["links"], want["new_links"])


def test_rollout_taus_and_delivery_match_jax(rollouts):
    """Analytic taus within 1e-9 of the JAX run's (its recorded job
    totals); simulated taus within 1e-9 of its composed taus; delivered
    ratios and the summary's conservation as the JAX run prints them."""
    from multihop_offload_tpu_torch.mobility_rollout import POLICIES

    got, lines, seen = rollouts
    rows, summary = lines[:-1], lines[-1]
    i = 0
    for row, want in zip(got["per_step"], rows):
        for name in POLICIES:
            total, tau_j = seen["j_ana"][i], seen["j_tau"][i]
            mask = total != 0
            assert row[f"{name}_analytic"] == pytest.approx(total[mask].mean(), rel=1e-9)
            assert row[name] == pytest.approx(np.nanmean(np.where(mask, tau_j, np.nan)),
                                              rel=1e-9)
            assert round(row[f"{name}_delivered"], 3) == want[f"{name}_delivered"]
            assert round(row[name], 2) == want[name]
            i += 1
    assert got["summary"]["conservation_ok"] == summary["conservation_ok"] is True
    assert set(got["summary"]) == set(summary)
    assert got["summary"]["link_churn_per_step"] == summary["link_churn_per_step"]
