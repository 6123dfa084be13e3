"""PyTorch port of `scenarios/`, the energy objective and `loop/drift.py`,
against the JAX package on the CPU, float64.

The presets' canonical JSON and hashes, the realizations, failure
schedules and mobility re-wirings (numpy draws in both packages) must be
bit-identical; so must the objective-weighted decisions, and three matrix
legs (`grid_energy`, `ba_blast`, `poisson_mobility`) run under the JAX
legs' own uniforms (rebuilt from its key tree and injected): conservation
counts equal, taus and delivered ratios within 1e-9.  The JAX legs run
in float64 as its own `_run_leg` does, with the realizations and the
simulators widened by patching their dtype defaults.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu import scenarios as jsc
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.env import offloading as joff
from multihop_offload_tpu.env import policies as jenv
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.loop.drift import shift_campaign as j_shift_campaign
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.obs.registry import registry as j_registry
from multihop_offload_tpu.scenarios import build as jbuild
from multihop_offload_tpu.scenarios import matrix as jmatrix
from multihop_offload_tpu.sim import runner as jrun
from multihop_offload_tpu.sim import state as jstate
from multihop_offload_tpu_torch import scenarios as tsc
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env import offloading as toff
from multihop_offload_tpu_torch.env import policies as tenv
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.loop.drift import shift_campaign
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.obs.registry import registry
from multihop_offload_tpu_torch.scenarios import build as tbuild
from multihop_offload_tpu_torch.scenarios import matrix as tmatrix
from multihop_offload_tpu_torch.sim import state as tstate
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from multihop_offload_tpu_torch.sim.runner import InjectedDraws

F64 = torch.float64
# one preset per topology family (JAX `tests/test_scenarios.py:FAMILY_REPS`)
FAMILY_REPS = {
    "ba": "ba_blast", "ws": "ws_diurnal", "er": "er_hetero", "grp": "grp_flash",
    "poisson": "poisson_mobility", "grid": "grid_poisson",
    "corridor": "corridor_links_fail", "two_tier": "two_tier_poisson",
}
LEGS = {"grid_energy": 1, "ba_blast": 1, "poisson_mobility": 2}   # name: segments
LEG_FLEET, LEG_SLOTS = 2, 100
TOTAL_SLOTS = 400
WEIGHTS = (0.5, 0.2)


def _pads(specs, fleet=1, spare_links=0):
    t = tmatrix.shared_pad(specs, fleet, 8)
    t = dataclasses.replace(t, l=t.l + spare_links)
    return jinst.PadSpec(n=t.n, l=t.l, s=t.s, j=t.j), t


def _eq(t, j, msg=""):
    got = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(got, np.asarray(j), err_msg=msg)


def _eq_record(t, j):
    for f in dataclasses.fields(t):
        got = getattr(t, f.name)
        if isinstance(got, torch.Tensor):
            _eq(got, getattr(j, f.name), f.name)


# ---------------------------------------------------------------------------
# spec: JSON round-trip, hash, validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jsc.preset_names())
def test_preset_round_trips_and_hashes_as_jax(name):
    s = tsc.preset(name)
    assert tsc.from_json(tsc.to_json(s)) == s
    assert tsc.to_json(s) == jsc.to_json(jsc.preset(name))
    assert tsc.spec_hash(s) == jsc.spec_hash(jsc.preset(name))
    assert tsc.spec_hash(dataclasses.replace(s, seed=s.seed + 1)) != tsc.spec_hash(s)


def test_registry_matches_jax():
    assert tsc.preset_names() == jsc.preset_names()
    assert tsc.NEW_FAMILIES == jsc.NEW_FAMILIES
    assert tsc.spec.GEOMETRIC_FAMILIES == jsc.spec.GEOMETRIC_FAMILIES
    assert any(not s.objective.is_null for s in tsc.PRESETS.values())


BAD_WORLDS = [
    dict(family="smallworld"), dict(util=1.5), dict(n_nodes=3), dict(num_servers=0),
    dict(num_jobs=0), dict(mu_spread=-1.0), dict(link_rate=0.0),
    dict(family="ba", mobility="mob"), dict(topo_params=((1, 2),)),
]


@pytest.mark.parametrize("kw", BAD_WORLDS, ids=lambda kw: next(iter(kw)))
def test_spec_validation_errors_are_jax_errors(kw):
    def err(mod):
        kw_ = {k: (mod.MobilitySpec() if v == "mob" else v) for k, v in kw.items()}
        with pytest.raises(ValueError) as e:
            mod.ScenarioSpec(name="x", **kw_)
        return str(e.value)

    assert err(tsc) == err(jsc)


def test_sub_spec_and_preset_errors_are_jax_errors():
    cases = [lambda m: m.FailureEvent(kind="flood"), lambda m: m.FailureEvent(at_frac=1.0),
             lambda m: m.FailureEvent(count=0), lambda m: m.MobilitySpec(step_std=0.0)]
    for make in cases:
        msgs = []
        for mod in (tsc, jsc):
            with pytest.raises(ValueError) as e:
                make(mod)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for mod in (tsc, jsc):
        with pytest.raises(KeyError) as e:
            mod.preset("nope")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# build: realizations, failure schedules, mobility steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILY_REPS))
def test_realization_failures_and_mobility_are_jax_bit_for_bit(family):
    name = FAMILY_REPS[family]
    ts, js = tsc.preset(name), jsc.preset(name)
    jpad, tpad = _pads([ts], fleet=2, spare_links=32)   # room for re-wired links
    lane = 1
    tr = tbuild.realize(ts, tpad, lane=lane, dtype=F64, device="cpu")
    jr = jbuild.realize(js, jpad, lane=lane, dtype=np.float64)
    _eq(tr.topo.adj, jr.topo.adj)
    _eq(tr.topo.link_ends, jr.topo.link_ends)
    if jr.pos is None:
        assert tr.pos is None
    else:
        _eq(tr.pos, jr.pos)
    _eq(tr.servers, jr.servers)
    _eq(tr.proc_bws, jr.proc_bws)
    _eq_record(tr.inst, jr.inst)
    _eq_record(tr.jobs, jr.jobs)

    tf = tbuild.failure_schedules(ts, tr, tpad, TOTAL_SLOTS, lane=lane)
    jf = jbuild.failure_schedules(js, jr, jpad, TOTAL_SLOTS, lane=lane)
    for a, b in zip(tf, jf):
        _eq(a, b)
        assert a.dtype == b.dtype
    if ts.failures:
        assert (np.concatenate(tf) >= 0).any()

    if jr.pos is not None:
        mob = dataclasses.replace(ts, mobility=ts.mobility or tsc.MobilitySpec(radius=1.5))
        jmob = dataclasses.replace(js, mobility=js.mobility or jsc.MobilitySpec(radius=1.5))
        try:
            jnew, jmap = jbuild.mobility_step(jmob, jr, jpad, dtype=np.float64,
                                              rng=np.random.default_rng(5))
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match=str(e)):
                tbuild.mobility_step(mob, tr, tpad, rng=np.random.default_rng(5))
            return
        tnew, tmap = tbuild.mobility_step(mob, tr, tpad, rng=np.random.default_rng(5))
        _eq(tmap, jmap)
        _eq(tnew.pos, jnew.pos)
        _eq_record(tnew.inst, jnew.inst)


# ---------------------------------------------------------------------------
# the energy-weighted objective
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("weights", [WEIGHTS, (0.0, 0.0)], ids=["energy", "null"])
def test_objective_weighted_decisions_are_jax_bit_for_bit(layout, weights):
    """`offload_decide` under `ObjectiveWeights(0.5, 0.2)` and the null
    weights, on the same shortest paths (the baseline's), two lanes of
    `grid_energy`; and the whole `baseline_policy` chain under them."""
    ts, js = tsc.preset("grid_energy"), jsc.preset("grid_energy")
    jpad, tpad = _pads([ts], fleet=2)
    treals = [tbuild.realize(ts, tpad, lane=i, dtype=F64, layout=layout, device="cpu")
              for i in range(2)]
    jreals = [jbuild.realize(js, jpad, lane=i, dtype=np.float64, layout=layout)
              for i in range(2)]
    tinsts = tinst.stack_instances([r.inst for r in treals])
    tjobs = tinst.stack_instances([r.jobs for r in treals])
    jinsts = jinst.stack_instances([r.inst for r in jreals])
    jjobs = jinst.stack_instances([r.jobs for r in jreals])
    tobj, jobj = toff.ObjectiveWeights(*weights), joff.ObjectiveWeights(*weights)

    tout = tenv.baseline_policy(tinsts, tjobs, layout=layout, objective=tobj)
    jout = jax.jit(jax.vmap(lambda i, j: jenv.baseline_policy(
        i, j, jax.random.PRNGKey(0), layout=layout, objective=jobj)))(jinsts, jjobs)
    sp = tenv.shortest_paths(tinsts, 1.0 / tinsts.link_rates, layout)
    unit = 1.0 / tinsts.proc_bws
    tdec = toff.offload_decide(tinsts, tjobs, sp, tinsts.hop, unit, objective=tobj)
    jdec = jax.vmap(lambda i, j, s, u: joff.offload_decide(
        i, j, s, i.hop, u, jax.random.PRNGKey(0), objective=jobj))(
        jinsts, jjobs, jnp.asarray(sp.numpy()), jnp.asarray(unit.numpy()))
    for t, j in ((tdec, jdec), (tout.decision, jout.decision)):
        _eq(t.dst, j.dst)
        _eq(t.is_local, j.is_local)
        np.testing.assert_allclose(t.costs.numpy(), np.asarray(j.costs), rtol=1e-12)
        np.testing.assert_allclose(t.delay_est.numpy(), np.asarray(j.delay_est), rtol=1e-12)
    null = toff.offload_decide(tinsts, tjobs, sp, tinsts.hop, unit)
    if weights == (0.0, 0.0):
        assert torch.equal(null.costs, tdec.costs)
    else:
        # the weights price every server option up; local is unpenalized
        srv = null.costs[..., :-1].isfinite()
        assert (tdec.costs[..., :-1][srv] > null.costs[..., :-1][srv]).all()
        assert torch.equal(tdec.costs[..., -1], null.costs[..., -1])
        assert (tdec.dst != null.dst)[tjobs.mask].any()


# ---------------------------------------------------------------------------
# matrix legs under JAX's draws
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _draw_fn(widths, rounds, slots):
    """JAX's runner key tree for lane keys (B, 2) -> the four slot
    uniforms (B, R, K, width) (`tests/test_torch_sim.py:_run_draws`),
    jitted once per shape."""
    def slot(kk):
        return tuple(jax.random.uniform(k, (w,), jnp.float64)
                     for k, w in zip(jax.random.split(kk, 4), widths))

    def lane(key):
        rnd = jax.vmap(lambda kr: jax.random.split(jax.random.split(kr)[1], slots))
        return jax.vmap(jax.vmap(slot))(rnd(jax.random.split(key, rounds)))

    return jax.jit(jax.vmap(lane))


def _jax_draws(spec, kind, seg, sim, fleet, segments):
    """The uniforms JAX's `_run_leg` draws for (policy, segment)."""
    p_idx = jmatrix.POLICY_KINDS.index(kind)
    keys = jax.random.split(jax.random.PRNGKey(spec.seed + 7919 * (p_idx + 1)),
                            segments * fleet).reshape(segments, fleet, -1)[seg]
    sp = sim.spec
    widths = (sp.num_links, sp.num_links, sp.num_nodes, sp.num_streams)
    u = _draw_fn(widths, sim.rounds, sim.slots_per_round)(keys)
    return InjectedDraws(*[torch.from_numpy(np.array(x)) for x in u])


@pytest.fixture(scope="module")
def legs():
    """Each leg of `LEGS` through the JAX `_run_leg` and the port's, both
    float64, the port under the JAX legs' uniforms; two lanes, one round
    of `LEG_SLOTS` slots a segment."""
    registry().reset()
    j_registry().reset()
    specs = [tsc.preset(n) for n in LEGS]
    jpad, tpad = _pads(specs, fleet=LEG_FLEET)
    shapes = dict(scenario_fleet=LEG_FLEET, scenario_rounds=1, scenario_slots=LEG_SLOTS)
    jcfg = JConfig(dtype="float64", precision="fp32", **shapes)
    tcfg = Config(dtype="float64", **shapes)

    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                       tcheb.load_weights("SCRATCH800_decay0.99"))
    jmodel = JChebNet(num_layer=5, hidden=32, k=1, param_dtype=jnp.float64)
    tmodel = tcheb.make_model(tcfg, dtype=F64)
    tmodel.load_state_dict(tcheb.params_from_jax(variables))

    jprobe = jbuild.realize(jsc.preset("ba_blast"), jpad, dtype=np.float64)
    jspec = jstate.spec_for(jprobe.inst, jprobe.jobs, cap=jcfg.scenario_cap)
    tspec = tstate.SimSpec(*dataclasses.astuple(jspec))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbuild, "realize", functools.partial(jbuild.realize, dtype=np.float64))
        mp.setattr(jbuild, "mobility_step",
                   functools.partial(jbuild.mobility_step, dtype=np.float64))
        mp.setattr(jrun, "FleetSim", functools.partial(jrun.FleetSim, dtype=jnp.float64))
        jprog = jmatrix._Programs(jcfg, jpad, jspec, jmodel, {"params": variables["params"]})
        jpin = jax.jit(lambda i, j, k: jenv.baseline_policy(i, j, k))
        tprog = tmatrix._Programs(tcfg, tspec, tmodel, "cpu", dtype=F64)

        def tpin(i, j, g=None):
            return tenv.baseline_policy(i, j, g)

        for name, segments in LEGS.items():
            jc = dataclasses.replace(jcfg, scenario_segments=segments)
            tc = dataclasses.replace(tcfg, scenario_segments=segments)
            draws = functools.partial(_jax_draws, segments=segments)
            out[name] = (
                tmatrix._run_leg(tsc.preset(name), tc, tpad, tspec, tprog, tpin, draws=draws),
                jmatrix._run_leg(jsc.preset(name), jc, jpad, jspec, jprog, jpin))
    return out


@pytest.mark.parametrize("name", list(LEGS))
def test_matrix_leg_matches_jax_under_its_draws(legs, name):
    got, want = legs[name]
    for key in ("name", "hash", "family", "n_nodes", "axes", "util", "lanes", "slots",
                "segments", "conservation_ok"):
        assert got[key] == want[key], key
    assert got["conservation_ok"]
    for kind in tmatrix.POLICY_KINDS:
        g, w = got["sim"][kind], want["sim"][kind]
        for key in ("generated", "delivered", "dropped", "in_flight", "conservation_gap",
                    "conservation_ok", "migration_drops"):
            assert g[key] == w[key], (kind, key)
        assert g["delivered_ratio"] == pytest.approx(w["delivered_ratio"], rel=1e-9)
        if w["mean_packet_delay"] is None:
            assert g["mean_packet_delay"] is None
        else:
            assert g["mean_packet_delay"] == pytest.approx(w["mean_packet_delay"], rel=1e-9)
        assert g["generated"] > 0
        ga, wa = got["analytic"][kind], want["analytic"][kind]
        assert ga["tau"] == pytest.approx(wa["tau"], rel=1e-9)
        np.testing.assert_allclose(ga["tau_per_lane"], wa["tau_per_lane"], rtol=1e-9)
    for key, v in want["deltas"].items():
        assert got["deltas"][key] == pytest.approx(v, rel=1e-9, abs=1e-12), key
    if name == "poisson_mobility":
        assert got["segments"] == 2


# ---------------------------------------------------------------------------
# shift injectors + drift campaign
# ---------------------------------------------------------------------------


SHIFTS = [("ba_poisson", "grp_flash", 32, 96), ("grid_poisson", "grid_energy", 32, 96),
          ("ba_poisson", "ba_poisson", 48, 96), ("ba_poisson", "grp_flash", 8, 48)]


@pytest.mark.parametrize("a,b,at,ticks", SHIFTS)
def test_shift_campaign_reports_equal_jax(a, b, at, ticks):
    got = shift_campaign(tsc.shift(tsc.preset(a), tsc.preset(b), at), ticks)
    want = j_shift_campaign(jsc.shift(jsc.preset(a), jsc.preset(b), at), ticks)
    assert got == want
    sched = tsc.shift(tsc.preset(a), tsc.preset(b), at)
    assert sched.outcome_events(ticks, seed=3) == jsc.shift(
        jsc.preset(a), jsc.preset(b), at).outcome_events(ticks, seed=3)


def test_shift_rows_and_preset_table_match_jax():
    from multihop_offload_tpu.cli.scenarios import list_presets as j_list
    from multihop_offload_tpu_torch.cli.scenarios import list_presets

    assert list_presets() == j_list()
    specs = {n: tsc.preset(n) for n in tsc.preset_names()}
    jspecs = {n: jsc.preset(n) for n in jsc.preset_names()}
    assert tmatrix._shift_drift_rows(specs) == jmatrix._shift_drift_rows(jspecs)
    with pytest.raises(ValueError, match="at_tick"):
        tsc.shift(specs["ba_poisson"], specs["grp_flash"], 0)
