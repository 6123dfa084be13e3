"""PyTorch port of `sim/`, against the JAX simulator on the CPU, float64.

The same numpy-seeded cases go through both packages, and the port's
draws are the JAX run's own uniforms, rebuilt from its key tree
(`sim/runner.py:92,116,130` and `sim/step.py:115`) and injected
(`sim.runner.InjectedDraws`).  The MWIS, the slot step and the fleet runs
must be bit-identical (ring buffers compared on rows [:Q]: the scratch
row's content is unspecified); the GNN policy's `dst` identical every
round; the device-metric flush identical; the fidelity helpers within
1e-9.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.env.policies import baseline_policy as j_baseline
from multihop_offload_tpu.env.scheduling import local_greedy_mwis as j_mwis
from multihop_offload_tpu.graphs import generators as jgen
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu.graphs.mobility import topology_update as j_topology_update
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.sim import fidelity as jfid
from multihop_offload_tpu.sim import policies as jpol
from multihop_offload_tpu.sim import runner as jrun
from multihop_offload_tpu.sim import state as jstate
from multihop_offload_tpu.sim import step as jstep
from multihop_offload_tpu_torch.env.scheduling import local_greedy_mwis
from multihop_offload_tpu_torch.graphs import generators as tgen
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.graphs.mobility import topology_update
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.sim import fidelity as tfid
from multihop_offload_tpu_torch.sim import policies as tpol
from multihop_offload_tpu_torch.sim import runner as trun
from multihop_offload_tpu_torch.sim import state as tstate
from multihop_offload_tpu_torch.sim import step as tstep

PAD = (16, 32, 8, 8)   # the JAX sim tests' PadSpec(n, l, s, j)
FAIL_SLOT = 300
ROUNDS, SLOTS = 3, 400
F64 = torch.float64
STATE_ROWS = ("buf_stream", "buf_birth", "buf_enq", "head", "count", "q_sojourn",
              "q_served", "q_busy", "q_arrived")


def _pads():
    return jinst.PadSpec(*PAD), tinst.PadSpec(*PAD)


def _case_pair(seed, num_jobs=4, layout=None):
    """(JAX topo, JAX inst, JAX jobs, port topo, port inst, port jobs) of
    `make_case` on BA(10, seed), float64."""
    jpad, tpad = _pads()
    jt = jtopo.build_topology(jgen.barabasi_albert(10, seed=seed)[0])
    tt = ttopo.build_topology(tgen.barabasi_albert(10, seed=seed)[0])
    ji, jj = jfid.make_case(seed, jt, jpad, num_jobs=num_jobs, dtype=np.float64)
    ti, tj = tfid.make_case(seed, tt, tpad, num_jobs=num_jobs, dtype=F64, device="cpu",
                            layout=layout)
    return jt, ji, jj, tt, ti, tj


def _slot_draws(keys, spec, dtype=jnp.float64):
    """The four uniforms of `sim_slot_step` for keys (..., 2), as JAX's
    `split(key, 4)` makes them: each (..., width)."""
    def one(kk):
        a, b, c, d = jax.random.split(kk, 4)
        return (jax.random.uniform(a, (spec.num_links,), dtype),
                jax.random.uniform(b, (spec.num_links,), dtype),
                jax.random.uniform(c, (spec.num_nodes,), dtype),
                jax.random.uniform(d, (spec.num_streams,), dtype))

    f = one
    for _ in range(keys.ndim - 1):
        f = jax.vmap(f)
    return jax.jit(f)(keys)


def _run_draws(keys, spec, rounds, slots):
    """`InjectedDraws` of the JAX runner's key tree for lane keys (B, 2):
    split(key, rounds), each round's split(kr) into (k_dec, k_slots),
    split(k_slots, slots); draws (B, R, K, width)."""
    def lane(key):
        def rnd(kr):
            return jax.random.split(jax.random.split(kr)[1], slots)
        return jax.vmap(rnd)(jax.random.split(key, rounds))

    slot_keys = jax.vmap(lane)(keys)                       # (B, R, K, 2)
    return trun.InjectedDraws(*[torch.from_numpy(np.array(x))
                                for x in _slot_draws(slot_keys, spec)])


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.detach().cpu().numpy(), np.asarray(j), err_msg=msg)


def _eq_state(t, j, q):
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), np.asarray(getattr(j, f.name))
        if f.name in STATE_ROWS:  # the scratch row Q is never read
            got, want = got[:, :q], want[:, :q]
        _eq(got, want, f.name)


def _eq_flush(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def fleet():
    """The two-lane fixture of `tests/test_sim.py`: lane 1 loses its
    busiest link and a non-server, non-source node at slot 300."""
    pairs = [_case_pair(s) for s in (1, 2)]
    jt1, ji1, jj1 = pairs[1][:3]
    out1 = j_baseline(ji1, jj1, jax.random.PRNGKey(0))
    lam1 = np.array(out1.delays.link_lambda, np.float64)
    lam1[~np.asarray(ji1.link_mask)] = -1.0
    kill_link = int(np.argmax(lam1))
    srcs = np.asarray(jj1.src)[np.asarray(jj1.mask)]
    servers = np.asarray(ji1.servers)[np.asarray(ji1.server_mask)]
    kill_node = int(np.setdiff1d(np.arange(jt1.n), np.concatenate([srcs, servers]))[0])
    jparams, tparams = [], []
    for i, p in enumerate(pairs):
        fl = np.full((PAD[1],), -1, np.int32)
        fn = np.full((PAD[0],), -1, np.int32)
        if i == 1:
            fl[kill_link] = FAIL_SLOT
            fn[kill_node] = FAIL_SLOT
        jparams.append(jstate.build_sim_params(p[1], p[2], margin=4.0,
                                               fail_link_slot=fl, fail_node_slot=fn))
        tparams.append(tstate.build_sim_params(p[4], p[5], margin=4.0,
                                               fail_link_slot=fl, fail_node_slot=fn))
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    jspec = jstate.spec_for(pairs[0][1], pairs[0][2], cap=64)
    return {
        "pairs": pairs,
        "j": (jinst.stack_instances([p[1] for p in pairs]),
              jinst.stack_instances([p[2] for p in pairs]),
              jinst.stack_instances(jparams)),
        "t": (tinst.stack_instances([p[4] for p in pairs]),
              tinst.stack_instances([p[5] for p in pairs]),
              tinst.stack_instances(tparams)),
        "jparams": jparams, "tparams": tparams,
        "jspec": jspec, "tspec": tstate.SimSpec(*dataclasses.astuple(jspec)),
        "keys": keys, "draws": _run_draws(keys, jspec, ROUNDS, SLOTS),
    }


def _models():
    params = tcheb.load_weights("SCRATCH800_decay0.99")
    jmodel = JChebNet(num_layer=5, hidden=32, k=1, param_dtype=jnp.float64)
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
    tmodel = tcheb.load_model("SCRATCH800_decay0.99", dtype=F64, device="cpu")
    return jmodel, variables, tmodel


def _policies(kind):
    if kind != "gnn":
        return jpol.make_policy(kind), tpol.make_policy(kind)
    jmodel, variables, tmodel = _models()
    return (jpol.make_policy("gnn", model=jmodel, variables=variables),
            tpol.make_policy("gnn", model=tmodel))


@pytest.fixture(scope="module")
def runs(fleet):
    """Each policy's 3 x 400-slot run in both packages (schedule traced),
    the port's `dst` of every round and both flushed device metrics."""
    out = {}
    for kind in ("baseline", "local", "gnn"):
        jfn, tfn = _policies(kind)
        dsts = []

        def recording(inst, jobs_est, node_up, link_up, gen=None, _fn=tfn):
            routes = _fn(inst, jobs_est, node_up, link_up, gen)
            dsts.append(routes.dst.clone())
            return routes

        jsim = jrun.FleetSim(fleet["jspec"], jfn, rounds=ROUNDS, slots_per_round=SLOTS,
                             collect_schedule=True, dtype=jnp.float64)
        tsim = trun.FleetSim(fleet["tspec"], recording, rounds=ROUNDS,
                             slots_per_round=SLOTS, collect_schedule=True, dtype=F64)
        jinsts, jjobs, jparams = fleet["j"]
        tinsts, tjobs, tparams = fleet["t"]
        jr = jsim.run(jinsts, jjobs, jparams, fleet["keys"], init_rates=jjobs.rate)
        tr = tsim.run(tinsts, tjobs, tparams, fleet["draws"], init_rates=tjobs.rate)
        out[kind] = {"j": jr, "t": tr, "dsts": torch.stack(dsts, dim=1), "jfn": jfn,
                     "jflush": jsim.last_devmetrics, "tflush": tsim.last_devmetrics}
    return out


def test_local_greedy_mwis_matches_jax():
    """Random conflict graphs with small integer weights (ties everywhere),
    masked, batched: the same sets and total weights."""
    rng = np.random.default_rng(5)
    b, n = 12, 40
    a = np.triu(rng.uniform(size=(b, n, n)) < 0.15, 1)
    adj = (a | np.swapaxes(a, 1, 2)).astype(np.float64)
    wts = rng.integers(0, 4, (b, n)).astype(np.float64)
    mask = rng.uniform(size=(b, n)) < 0.8
    want_set, want_w = jax.jit(jax.vmap(j_mwis))(adj, wts, mask)
    got_set, got_w = local_greedy_mwis(torch.from_numpy(adj), torch.from_numpy(wts),
                                       torch.from_numpy(mask))
    _eq(got_set, want_set)
    _eq(got_w, want_w)
    assert not (got_set & ~torch.from_numpy(mask)).any()
    # no two chosen vertices conflict, and no mask means every vertex counts
    s = got_set.double()
    assert torch.einsum("bi,bij,bj->b", s, torch.from_numpy(adj), s).eq(0).all()
    want_all, _ = jax.jit(jax.vmap(j_mwis))(adj, wts)
    _eq(local_greedy_mwis(torch.from_numpy(adj), torch.from_numpy(wts))[0], want_all)


def test_sim_slot_step_matches_jax_through_a_failure(fleet):
    """330 slots of `sim_slot_step` from the same state, params, routes and
    draws, with lane 1's failures at slot 300: every state field, the
    schedule and the device metrics identical."""
    jspec, tspec = fleet["jspec"], fleet["tspec"]
    jinsts, jjobs, jparams = fleet["j"]
    tinsts, tjobs, tparams = fleet["t"]
    slots = 330
    jroutes = jax.vmap(jpol.make_policy("baseline"))(
        jinsts, jjobs, jnp.ones(jinsts.node_mask.shape, bool),
        jnp.ones(jinsts.link_mask.shape, bool), jax.random.split(jax.random.PRNGKey(0), 2))
    troutes = tstate.SimRoutes(**{f: torch.from_numpy(np.array(getattr(jroutes, f)))
                                  for f in ("dst", "next_hop", "reach")})
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * slots).reshape(2, slots, 2)
    draws = [torch.from_numpy(np.array(x)) for x in _slot_draws(keys, jspec)]
    jdm = jstep.sim_devmetrics(jspec)
    tdm = tstep.sim_devmetrics(tspec)

    def jstep_lane(inst, params, routes, jobs, key):
        def body(carry, kk):
            st, dev = carry
            st, sched, dev = jstep.sim_slot_step(inst, jspec, params, routes, jobs, st, kk,
                                                 dm=jdm, dev=dev)
            return (st, dev), sched
        return jax.lax.scan(body, (jstate.init_state(jspec, jnp.float64), jdm.init()), key)

    (jst, jdev), jsched = jax.jit(jax.vmap(jstep_lane))(jinsts, jparams, jroutes, jjobs, keys)
    tst = tstate.init_state(tspec, 2, F64)
    tdev = tdm.init((2,))
    scheds = []
    for k in range(slots):
        tst, sched, tdev = tstep.sim_slot_step(tinsts, tspec, tparams, troutes, tjobs, tst,
                                               [d[:, k] for d in draws], dm=tdm, dev=tdev)
        scheds.append(sched)
    _eq_state(tst, jst, tspec.num_queues)
    _eq(torch.stack(scheds, dim=1), jsched)
    assert (tst.delivered.sum(dim=1) > 0).all()
    _eq(tstate.conservation_gap(tst), jax.vmap(jstate.conservation_gap)(jst))
    assert (tstate.conservation_gap(tst) == 0).all()
    from multihop_offload_tpu.obs.registry import MetricRegistry as JRegistry
    from multihop_offload_tpu_torch.obs.registry import MetricRegistry

    _eq_flush(tdm.flush(tdev, reg=MetricRegistry()), jdm.flush(jdev, reg=JRegistry()))


@pytest.mark.parametrize("kind", ["baseline", "local", "gnn"])
def test_fleet_run_matches_jax(fleet, runs, kind):
    """3 rounds x 400 slots with lane 1's failures: the final state, the
    per-round rate estimates, the schedule trace, the last routes and the
    flushed device metrics identical; every round's `dst` equals the JAX
    policy's on the JAX run's own estimates and liveness."""
    jr, tr = runs[kind]["j"], runs[kind]["t"]
    _eq_state(tr.state, jr.state, fleet["tspec"].num_queues)
    _eq(tr.est_rates, jr.est_rates)
    _eq(tr.sched, jr.sched)
    for f in ("dst", "next_hop", "reach"):
        _eq(getattr(tr.routes, f), getattr(jr.routes, f), f)
    _eq_flush(runs[kind]["tflush"], runs[kind]["jflush"])
    assert (tstate.conservation_gap(tr.state) == 0).all()
    assert (tr.state.delivered.sum(dim=1) > 0).all()
    # the decision of every round, on the JAX side outside its scan
    jinsts, jjobs, jparams = fleet["j"]
    jfn = runs[kind]["jfn"]
    for r in range(ROUNDS):
        t = jnp.full((2,), r * SLOTS, jnp.int32)
        up = jax.vmap(jstate.liveness_masks)(jinsts, jparams, t)
        est = jjobs.replace(rate=jr.est_rates[:, r])
        routes = jax.jit(jax.vmap(jfn))(jinsts, est, up[0], up[1],
                                        jax.random.split(jax.random.PRNGKey(0), 2))
        _eq(runs[kind]["dsts"][:, r], routes.dst, f"round {r}")
    if kind == "local":
        _eq(runs[kind]["dsts"][:, 0], fleet["t"][1].src.int())
    if kind == "gnn":
        # the decisions compared are real ones: jobs leave their source in
        # every round
        tjobs = fleet["t"][1]
        for r in range(ROUNDS):
            assert ((runs[kind]["dsts"][:, r] != tjobs.src) & tjobs.mask).any(), r


def test_failure_takes_the_link_down_in_the_port(fleet, runs):
    """The failed link transmits before slot 300 and never after."""
    sched = runs["baseline"]["t"].sched.reshape(2, -1, fleet["tspec"].num_links)
    link = int(np.flatnonzero(fleet["tparams"][1].fail_link_slot.numpy() >= 0)[0])
    assert sched[1, :FAIL_SLOT, link].any()
    assert not sched[1, FAIL_SLOT:, link].any()


def test_sparse_layout_routes_equal_dense():
    """The policies decide the same routes on the sparse layout (W from the
    link list, `next_hop_from_edges`) as on the dense one."""
    dense = [_case_pair(s)[3:] for s in (1, 2)]
    sparse = [_case_pair(s, layout="sparse")[3:] for s in (1, 2)]
    for kind in ("baseline", "gnn"):
        model = tcheb.load_model("SPECTRAL_K2", dtype=F64, device="cpu")
        smodel = tcheb.load_model("SPECTRAL_K2", dtype=F64, device="cpu", layout="sparse")
        got = []
        for cases, lay, m in ((dense, None, model), (sparse, "sparse", smodel)):
            insts = tinst.stack_instances([c[1] for c in cases])
            jobs = tinst.stack_instances([c[2] for c in cases])
            fn = tpol.make_policy(kind, model=m, layout=lay)
            got.append(fn(insts, jobs, insts.node_mask, insts.link_mask))
        for f in ("dst", "next_hop", "reach"):
            _eq(getattr(got[1], f), getattr(got[0], f).numpy(), f"{kind} {f}")


def test_decisions_at_the_full_width_cell_match_jax():
    """At the cell `chip_smoke.py` runs the simulator on (BA(110) networks
    of graph seeds 0 and 100, 100 jobs at the baseline's utilization 0.7,
    pads N 112, L 216), float64, on the same rates: the gnn policy with
    the model of record and the baseline give the JAX policies' `dst`
    (the model keeps every job local here in both packages, the baseline
    offloads every one)."""
    from multihop_offload_tpu.graphs.instance import PadSpec as JPad
    from multihop_offload_tpu_torch.cli.sim import build_scenarios
    from multihop_offload_tpu_torch.config import Config

    cfg = Config(sim_policy="baseline", sim_fleet=2, sim_nodes=110, sim_jobs=100,
                 sim_util=0.7, sim_rounds=1, sim_slots=1, dtype="float64")
    scen = build_scenarios(cfg, "cpu")
    jpad = JPad(n=112, l=216, s=8, j=100)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    cases = []
    for i in range(2):
        jt = jtopo.build_topology(jgen.barabasi_albert(110, seed=100 * i)[0])
        ji, jj = jfid.make_case(100 * i, jt, jpad, 100, dtype=np.float64)
        jj, _ = jfid.scale_to_util(ji, jj, keys[i], 0.7,
                                   policy_fn=jax.jit(lambda a, b, k: j_baseline(a, b, k)))
        cases.append((ji, jj))
    jinsts = jinst.stack_instances([c[0] for c in cases])
    jjobs = jinst.stack_instances([c[1] for c in cases])
    tinsts = scen["insts"]
    tjobs = dataclasses.replace(scen["jobss"], rate=torch.from_numpy(np.array(jjobs.rate)))
    np.testing.assert_allclose(scen["jobss"].rate.numpy(), np.array(jjobs.rate), rtol=1e-12)
    up = (jnp.ones(jinsts.node_mask.shape, bool), jnp.ones(jinsts.link_mask.shape, bool))
    shares = {}
    for kind in ("gnn", "baseline"):
        jfn, tfn = _policies(kind)
        want = jax.jit(jax.vmap(jfn))(jinsts, jjobs, *up, keys).dst
        got = tfn(tinsts, tjobs, torch.ones_like(tinsts.node_mask),
                  torch.ones_like(tinsts.link_mask)).dst
        _eq(got, want, kind)
        shares[kind] = float((got != tjobs.src)[tjobs.mask].double().mean())
    assert shares == {"gnn": 0.0, "baseline": 1.0}


def test_policy_refuses_other_precisions():
    # fp32, bf16 and auto run (`tests/test_torch_precision.py`); others raise
    with pytest.raises(ValueError, match="unsupported precision"):
        tpol.make_policy("baseline", precision="fp16")
    with pytest.raises(ValueError, match="unknown sim policy"):
        tpol.make_policy("oracle")


def test_lane_draws_do_not_depend_on_the_fleet(fleet):
    """A lane's run under `LaneDraws` is the same alone as beside another
    lane (one generator per lane)."""
    tinsts, tjobs, tparams = fleet["t"]
    sim = trun.FleetSim(fleet["tspec"], tpol.make_policy("baseline"), rounds=1,
                        slots_per_round=120, dtype=F64)
    both = sim.run(tinsts, tjobs, tparams, [11, 12], init_rates=tjobs.rate)

    def lane1(rec):
        return dataclasses.replace(rec, **{
            f.name: getattr(rec, f.name)[1:] for f in dataclasses.fields(rec)
            if isinstance(getattr(rec, f.name), torch.Tensor)})

    alone = sim.run(lane1(tinsts), lane1(tjobs), lane1(tparams), [12],
                    init_rates=tjobs.rate[1:])
    for f in dataclasses.fields(alone.state):
        assert torch.equal(getattr(alone.state, f.name)[0], getattr(both.state, f.name)[1])


def test_migrate_sim_state_matches_jax(fleet, runs):
    """Lane 0's final baseline state carried across a re-wiring that drops
    one link and adds another: the same migrated state in both packages,
    stranded packets counted as drops (conservation gap 0 across the
    boundary), and the next segment on the new topology identical."""
    pair = fleet["pairs"][0]
    jt, tt = pair[0], pair[3]
    adj = jt.adj.copy()
    u, v = jt.link_ends[0]
    adj[u, v] = adj[v, u] = 0
    free = np.argwhere(np.triu(1 - adj, 1) & np.triu(np.ones_like(adj), 1))
    a, b = free[len(free) // 2]
    adj[a, b] = adj[b, a] = 1
    jnew, jmap = j_topology_update(jt, adj)
    tnew, tmap = topology_update(tt, adj)
    np.testing.assert_array_equal(tmap, jmap)
    assert (tmap == -1).sum() == 1
    jst0 = jax.tree_util.tree_map(lambda x: np.asarray(x)[0], runs["baseline"]["j"].state)
    tst0 = dataclasses.replace(runs["baseline"]["t"].state, **{
        f.name: getattr(runs["baseline"]["t"].state, f.name)[0]
        for f in dataclasses.fields(tstate.SimState)})
    jm = jstate.migrate_sim_state(jst0, jmap, fleet["jspec"])
    tm = tstate.migrate_sim_state(tst0, tmap, fleet["tspec"])
    q = fleet["tspec"].num_queues
    for f in dataclasses.fields(tm):
        got, want = getattr(tm, f.name), np.asarray(getattr(jm, f.name))
        if f.name in STATE_ROWS:
            got, want = got[:q], want[:q]
        _eq(got, want, f.name)
    assert int(tstate.conservation_gap(tm)) == 0
    assert int(tm.dropped.sum()) >= int(tst0.dropped.sum())

    # the next segment: lane 0 on the new topology from the migrated state
    jpad, tpad = _pads()
    rates = pair[1].link_rates[:jt.num_links]
    new_rates = np.asarray(rates)[np.maximum(jmap, 0)]
    new_rates[jmap < 0] = 50.0
    roles, bws = np.asarray(pair[1].roles)[:10], np.asarray(pair[1].proc_bws)[:10]
    ji = jinst.build_instance(jnew, roles, bws, new_rates, 1000.0, jpad, dtype=np.float64)
    ti = tinst.build_instance(tnew, roles, bws, new_rates, 1000.0, tpad, dtype=F64,
                              device="cpu")
    jp = jstate.build_sim_params(ji, pair[2], margin=4.0)
    tp = tstate.build_sim_params(ti, pair[5], margin=4.0)
    keys = jax.random.split(jax.random.PRNGKey(9), 1)
    jsim = jrun.FleetSim(fleet["jspec"], jpol.make_policy("baseline"), rounds=1,
                         slots_per_round=150, dtype=jnp.float64)
    tsim = trun.FleetSim(fleet["tspec"], tpol.make_policy("baseline"), rounds=1,
                         slots_per_round=150, dtype=F64)
    batch = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], (ji, pair[2], jp, jm))
    jr = jsim.run(*batch[:3], keys, states=batch[3], init_rates=batch[1].rate)
    tb = [tinst.stack_instances([x]) for x in (ti, pair[5], tp, tm)]
    tr = tsim.run(*tb[:3], _run_draws(keys, fleet["jspec"], 1, 150), states=tb[3],
                  init_rates=tb[1].rate)
    _eq_state(tr.state, jr.state, q)
    assert (tstate.conservation_gap(tr.state) == 0).all()


def test_fidelity_helpers_match_jax(fleet, runs):
    """`build_sim_params`, `make_case`, `scale_to_util` (rates within
    1e-9), `max_busyness`, `analytic_*`, `empirical_queue_delays` and
    `composed_job_tau` equal the JAX helpers lane by lane."""
    for p, jp, tp in zip(fleet["pairs"], fleet["jparams"], fleet["tparams"]):
        for f in dataclasses.fields(tp):
            _eq(getattr(tp, f.name), getattr(jp, f.name), f.name)
        _, ji, jj, _, ti, tj = p
        for f in ("adj", "link_rates", "proc_bws", "roles", "servers", "hop"):
            _eq(getattr(ti, f), getattr(ji, f), f)
        for f in ("src", "rate", "mask"):
            _eq(getattr(tj, f), getattr(jj, f), f)
    tinsts, tjobs, _ = fleet["t"]
    scaled, out = tfid.scale_to_util(tinsts, tjobs, None, 0.35)
    run = runs["baseline"]
    emp_l, emp_s = tfid.empirical_queue_delays(run["t"].state, fleet["tspec"],
                                               fleet["t"][2].dt.numpy(), min_served=20)
    tau = tfid.composed_job_tau(tinsts, scaled, out.routes, np.nan_to_num(emp_l, nan=0.1),
                                np.nan_to_num(emp_s, nan=0.01))
    for i, p in enumerate(fleet["pairs"]):
        ji, jj = p[1], p[2]
        jjobs, jout = jfid.scale_to_util(ji, jj, jax.random.PRNGKey(i), 0.35)
        np.testing.assert_allclose(scaled.rate[i].numpy(), np.asarray(jjobs.rate), rtol=1e-9)
        assert tfid.max_busyness(tinsts, scaled, out)[i] == pytest.approx(
            jfid.max_busyness(ji, jjobs, jout), rel=1e-9)
        np.testing.assert_allclose(tfid.analytic_link_delay(tinsts, out)[i],
                                   jfid.analytic_link_delay(ji, jout), rtol=1e-9)
        np.testing.assert_allclose(tfid.analytic_server_delay(tinsts, out)[i],
                                   jfid.analytic_server_delay(ji, jout), rtol=1e-9)
        assert tfid.analytic_mean_in_flight(tinsts, out)[i] == pytest.approx(
            jfid.analytic_mean_in_flight(ji, jout), rel=1e-9)
        jst = jax.tree_util.tree_map(lambda x: np.asarray(x)[i], run["j"].state)
        jl, js = jfid.empirical_queue_delays(jst, fleet["jspec"],
                                             float(fleet["jparams"][i].dt), min_served=20)
        np.testing.assert_array_equal(emp_l[i], jl)
        np.testing.assert_array_equal(emp_s[i], js)
        jtau = jfid.composed_job_tau(
            ji, jjobs, jax.tree_util.tree_map(lambda x: x, jout.routes),
            np.nan_to_num(jl, nan=0.1), np.nan_to_num(js, nan=0.01))
        np.testing.assert_allclose(tau[i], jtau, rtol=1e-9)


def test_fidelity_sweep_runs_and_conserves():
    """A short sweep on the CPU: the record's schema, a conserving run at
    each utilization, and a gate value where links were compared."""
    rec = tfid.fidelity_sweep(utils=(0.3,), fleet=2, n_nodes=8, num_jobs=3, rounds=1,
                              slots_per_round=300, cap=64, min_served=10, device="cpu")
    assert set(rec) == {"config", "sweep", "acceptance"}
    row = rec["sweep"][0]
    assert row["generated"] == row["delivered"] + row["dropped"] + row["in_flight"] > 0
    assert row["devmetrics"]["queue_depth"]["mean_in_flight_emp"] > 0
    assert rec["acceptance"]["threshold"] == 0.10
    json.dumps(rec)


def test_fidelity_sweep_rows_equal_each_utilization_run_alone():
    """The sweep runs its utilizations side by side as one fleet; each
    utilization's row is the row of a sweep of that utilization alone."""
    kw = dict(fleet=2, n_nodes=8, num_jobs=3, rounds=1, slots_per_round=200, cap=64,
              min_served=10, device="cpu")
    both = tfid.fidelity_sweep(utils=(0.3, 0.6), **kw)
    for row, u in zip(both["sweep"], (0.3, 0.6)):
        assert row == tfid.fidelity_sweep(utils=(u,), **kw)["sweep"][0]
    assert both["sweep"][0]["generated"] < both["sweep"][1]["generated"]


def test_cli_smoke_and_scenarios(capsys, tmp_path):
    """`main --device cpu --smoke` returns 0 and reports ok; `run_scenarios`
    conserves with device counters equal to the state's under every
    policy; `--fidelity` without `--sim_out` is refused."""
    from multihop_offload_tpu_torch.cli import sim as cli_sim
    from multihop_offload_tpu_torch.config import Config

    assert cli_sim.main(["--device", "cpu", "--smoke"]) == 0
    assert '"ok": true' in capsys.readouterr().out
    cfg = Config(sim_fleet=2, sim_nodes=8, sim_jobs=3, sim_rounds=2, sim_slots=100,
                 sim_util=0.5, sim_cap=64, sim_fail_links=1, sim_fail_nodes=1,
                 model_root=str(tmp_path))
    for kind in ("baseline", "local", "gnn"):
        s = cli_sim.run_scenarios(dataclasses.replace(cfg, sim_policy=kind), "cpu")
        assert s["conservation_ok"] and s["devmetrics"]["matches_state"], kind
        assert s["generated"] > 0 and s["device"] == "cpu"
    with pytest.raises(SystemExit):
        cli_sim.main(["--device", "cpu", "--fidelity"])
    with pytest.raises(ValueError, match="sim_policy"):
        Config(sim_policy="oracle")


def test_sparse_scenarios_size_nnz_pads_from_the_data():
    """Under the sparse layout `build_scenarios` sizes the edge-list pads
    from the networks: BA(110) graphs 200 and 400 have 3,470 and 3,594
    conflict entries, above the heuristic pad (16 L = 3,456), on which the
    JAX builder raises."""
    from multihop_offload_tpu_torch.cli import sim as cli_sim
    from multihop_offload_tpu_torch.config import Config

    # cap 64 as in this file's other runs: the process-wide registry keeps
    # the queue-depth histogram's first boundaries (pow2 up to the cap), as
    # the JAX registry does
    cfg = Config(sim_policy="baseline", layout="sparse", sim_fleet=5, sim_nodes=110,
                 sim_jobs=20, sim_rounds=1, sim_slots=3, sim_cap=64)
    scen = cli_sim.build_scenarios(cfg, "cpu")
    assert scen["insts"].sparse.cf.rows.shape == (5, 3712)
    run = scen["sim"].run(scen["insts"], scen["jobss"], scen["paramss"], scen["seeds"])
    assert cli_sim.summarize(cfg, scen, run)["conservation_ok"]
