"""PyTorch port, `parallel/` and the drivers' data-parallel path against the
JAX package, in float64 on the CPU.  The port's meshes are `[cpu] * k`
(a repeated device), JAX's the virtual CPU devices of `tests/conftest.py`
under `shard_map`; the same numpy inputs go through both:

* `make_mesh` over 1, 2, 4 and 8 devices has JAX's shapes, and its
  fallback JAX's warning; with no device given and no card it raises;
* the ring (`sharded_apsp`) equals JAX's at graph 2 and 4, N 32 and 112,
  bit for bit, infinities included;
* the halo fixed point and `sharded_spectral_forward` within 1e-12;
* the `mean` step at data 4, graph 2 within 1e-9 of JAX's and of the
  port's 1 x 1 mesh; replicas on two distinct devices get the new
  parameters; the `replay` buffer (count, gradients in order, losses)
  within 1e-12 of JAX's, and the file step's `valid` mask keeps pads out;
* `make_dp_eval_step`'s totals within 1e-12 of JAX's;
* the Trainer at `mesh_data = 2` and the Evaluator at `mesh_data = 2,
  file_batch = 2`: their CSV rows against JAX's drivers at the same
  settings (1e-9, `runtime` excluded) and against the port's
  `mesh_data = 1` run; `mesh_graph > 1` and an oversized `mesh_data`
  raise JAX's errors.
"""

import dataclasses
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from multihop_offload_tpu.agent import replay as jreplay
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.models.chebconv import ChebNet as JChebNet
from multihop_offload_tpu.models.chebconv import chebyshev_support as j_cheb_support
from multihop_offload_tpu.parallel import data_parallel as jdp
from multihop_offload_tpu.parallel import make_mesh as j_make_mesh
from multihop_offload_tpu.parallel import partition as jpart
from multihop_offload_tpu.parallel import ring as jring
from multihop_offload_tpu.parallel.compat import shard_map
from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch.agent import replay as treplay
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.parallel import collectives as coll
from multihop_offload_tpu_torch.parallel import data_parallel as tdp
from multihop_offload_tpu_torch.parallel import global_batch, make_mesh
from multihop_offload_tpu_torch.parallel import partition as tpart
from multihop_offload_tpu_torch.parallel import ring as tring
from multihop_offload_tpu_torch.train import driver as td
from tests.test_torch_drivers import assert_rows_equal, common, read_rows, tiny  # noqa: F401
from tests.test_torch_layouts import FP_FN, models, paired_batch, synthetic
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_trainer import TRAIN, jax_indices

CPU = torch.device("cpu")
NETS = [(14, 1), (18, 2), (22, 3), (26, 4)]


def cpus(k):
    return [CPU] * k


def _jax_leaf(tree, name):
    _, i, leaf = name.split(".")
    return np.asarray(tree[f"cheb_{i}"][leaf])


# ---- meshes -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_match_jax(n):
    assert make_mesh(devices=cpus(n)).shape == dict(j_make_mesh(devices=jax.devices()[:n]).shape)
    g = 2 if n > 1 else 1
    mesh = make_mesh(data=n // g, graph=g, devices=cpus(n))
    assert mesh.shape == dict(j_make_mesh(data=n // g, graph=g,
                                          devices=jax.devices()[:n]).shape)
    assert mesh.devices.shape == (n // g, g) and all(d == CPU for d in mesh.devices.ravel())
    assert mesh.data_devices() == cpus(n // g) and mesh.graph_devices(0) == cpus(g)


def test_make_mesh_fallback_warns_as_jax_and_never_picks_the_cpu():
    for kw, k in (({"data": 2, "graph": 2}, 3), ({"graph": 16}, 8)):
        with pytest.warns(RuntimeWarning, match="falling back") as got:
            mesh = make_mesh(devices=cpus(k), **kw)
        with pytest.warns(RuntimeWarning, match="falling back") as want:
            jmesh = j_make_mesh(devices=jax.devices()[:k], **kw)
        assert str(got[0].message) == str(want[0].message)
        assert mesh.shape == dict(jmesh.shape) == {"data": k, "graph": 1}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_mesh(data=2, graph=2, devices=cpus(4)).shape == {"data": 2, "graph": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_global_batch_splits_the_local_batch(dp_setup):
    """One process: the local batch laid out over `data`, one equal slice
    per index on its first device, records and tensors alike."""
    _, _, ti, tj, _, _, _, _ = dp_setup
    mesh = make_mesh(data=4, graph=2, devices=cpus(8))
    shards = global_batch(mesh, tj)
    assert len(shards) == 4 and all(s.src.shape[0] == 2 for s in shards)
    assert torch.equal(torch.cat([s.rate for s in shards]), tj.rate)
    insts = global_batch(mesh, {"adj": ti.adj})
    assert torch.equal(torch.cat([d["adj"] for d in insts]), ti.adj)
    assert len(global_batch(mesh, ti.adj, axis="graph")) == 2
    with pytest.raises(ValueError, match="does not split"):
        global_batch(make_mesh(data=3, devices=cpus(3)), tj)


def test_collectives_copy_nothing_on_a_repeated_device():
    xs = [torch.full((2, 3), float(i)) for i in range(4)]
    outs = coll.all_gather(xs, axis=0, tiled=True)
    assert all(o is outs[0] for o in outs)  # one result for the one device
    np.testing.assert_array_equal(outs[0].numpy(), torch.cat(xs).numpy())
    perm = coll.ppermute(xs, [(i, (i - 1) % 4) for i in range(4)])
    assert all(perm[(i - 1) % 4] is xs[i] for i in range(4))  # no copy
    assert torch.equal(coll.ppermute(xs, [(0, 1)])[2], torch.zeros(2, 3))
    means = coll.pmean(xs)
    assert all(m is means[0] for m in means) and torch.equal(means[0], torch.full((2, 3), 1.5))


def test_lockstep_gathers_under_contention_and_stops_on_a_failure():
    """16 shards (more threads than cores) at a short switch interval, each
    gathering 20 times: every gather sees every shard's value of that
    round, so a lost or stale slot would show; a shard that raises stops
    the others."""
    n, rounds = 16, 20
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        step = coll.Lockstep(n, timeout=60)

        def body(i):
            seen = []
            for r in range(rounds):
                got = step.all_gather(torch.tensor([float(100 * r + i)]), tiled=True)
                seen.append(got.tolist())
            return seen

        out = step.run(body)
    finally:
        sys.setswitchinterval(old)
    for seen in out:
        assert seen == [[float(100 * r + j) for j in range(n)] for r in range(rounds)]

    bad = coll.Lockstep(4, timeout=60)

    def fails(i):
        if i == 2:
            raise KeyError("shard 2")
        return bad.all_gather(torch.zeros(1))

    with pytest.raises(KeyError, match="shard 2"):
        bad.run(fails)
    assert threading.active_count() < 50


# ---- the ring ---------------------------------------------------------------


def _weights(n, seed):
    """Symmetric one-hop weights with two components (unreachable pairs stay
    infinite), +inf off the edges."""
    rng = np.random.default_rng(seed)
    w = np.full((n, n), np.inf)
    half = n // 2
    for lo, hi in ((0, half), (half, n)):
        iu, ju = np.where(np.triu(rng.uniform(size=(hi - lo, hi - lo)) < 6.0 / n, 1))
        w[lo + iu, lo + ju] = w[lo + ju, lo + iu] = rng.uniform(0.5, 3.0, iu.size)
    return w


@pytest.mark.parametrize("graph", [2, 4])
@pytest.mark.parametrize("n", [32, 112])
def test_ring_apsp_equals_jax_bit_for_bit(graph, n):
    w = _weights(n, n + graph)
    jmesh = j_make_mesh(data=1, graph=graph, devices=jax.devices()[:graph])
    f = jax.jit(shard_map(lambda x: jring.sharded_apsp(x, "graph"), mesh=jmesh,
                          in_specs=P(), out_specs=P(), check_vma=False))
    want = np.asarray(f(jnp.asarray(w)))
    got = tring.sharded_apsp(torch.from_numpy(w), cpus(graph)).numpy()
    assert np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(got, want)
    # a batch ring equals its instances one by one; the row chunks of the
    # block product give the same bits
    w2 = torch.from_numpy(np.stack([w, _weights(n, n + 7)]))
    batched = tring.sharded_apsp(w2, cpus(graph))
    assert torch.equal(batched[0], torch.from_numpy(got))
    assert torch.equal(batched[1], tring.sharded_apsp(w2[1], cpus(graph)))
    a, b = w2[0, :, : n // 2], w2[1, : n // 2]
    assert torch.equal(tring.block_minplus(a, b, cap=n), tring.block_minplus(a, b))
    with pytest.raises(ValueError, match="not divisible"):
        tring.sharded_apsp(torch.from_numpy(w), cpus(3))


# ---- the halo partition ---------------------------------------------------------


def test_sharded_fixed_point_matches_jax():
    rng = np.random.default_rng(21)
    l, g = 48, 4
    a = np.triu((rng.uniform(size=(l, l)) < 0.1).astype(np.float64), 1)
    a = a + a.T
    rates, lam = rng.uniform(30, 70, l), rng.uniform(0.0, 40.0, l)
    cf = a.sum(1)
    jmesh = j_make_mesh(data=1, graph=g, devices=jax.devices()[:g])
    f = jax.jit(shard_map(
        lambda a_, r_, c_, l_: jpart.sharded_interference_fixed_point(a_, r_, c_, l_, "graph"),
        mesh=jmesh, in_specs=(P("graph", None), P("graph"), P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=False))
    want = np.asarray(f(a, rates, cf, lam))
    rows = l // g
    split = lambda x: [torch.from_numpy(x[i * rows:(i + 1) * rows]) for i in range(g)]
    got = torch.cat(tpart.sharded_interference_fixed_point(
        split(a), split(rates), split(cf), split(lam))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("graph", [2, 4])
def test_sharded_spectral_forward_matches_jax(graph):
    rng = np.random.default_rng(5)
    e = 64
    adj = np.triu((rng.uniform(size=(e, e)) < 0.15).astype(np.float64), 1)
    adj = adj + adj.T
    feats = rng.normal(size=(e, 4))
    support = np.array(j_cheb_support(jnp.asarray(adj), jnp.ones((e,), bool)))
    jmodel = JChebNet(num_layer=3, hidden=8, k=3, param_dtype=jnp.float64)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(support))
    jmesh = j_make_mesh(data=1, graph=graph, devices=jax.devices()[:graph])
    f = jax.jit(shard_map(
        lambda v, x, s: jpart.sharded_spectral_forward(jmodel, v, x, s, "graph"),
        mesh=jmesh, in_specs=(P(), P(), P()), out_specs=P(), check_vma=False))
    want = np.asarray(f(variables, jnp.asarray(feats), jnp.asarray(support)))
    tmodel = tcheb.ChebNet(num_layer=3, hidden=8, k=3, dtype=torch.float64)
    tmodel.load_state_dict(tcheb.params_from_jax(jax.device_get(variables)))
    got = tpart.sharded_spectral_forward(tmodel, torch.from_numpy(feats),
                                         torch.from_numpy(support), cpus(graph))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12, atol=1e-12)
    assert tmodel.layers[0].propagate is None  # the caller's model is untouched
    with pytest.raises(ValueError, match="not divisible by axis 'graph'"):
        tpart.sharded_spectral_forward(tmodel, torch.from_numpy(feats[:63]),
                                       torch.from_numpy(support[:63, :63]), cpus(2))


# ---- the data-parallel steps ----------------------------------------------------


@pytest.fixture(scope="module")
def dp_setup():
    bi, bj, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in NETS], "dense",
                                       per_network=2, seed=4)
    jmodel, variables, tmodel = models(2, 3, 8, pad, "dense")
    keys = jax.random.split(jax.random.PRNGKey(1), ti.adj.shape[0])
    return bi, bj, ti, tj, jmodel, variables, tmodel, keys


def _port_model(variables):
    m = tcheb.ChebNet(num_layer=3, hidden=8, k=2, dtype=torch.float64)
    m.load_state_dict(tcheb.params_from_jax(variables))
    return m


def test_mean_step_matches_jax_and_the_one_device_mesh(dp_setup):
    """4-way data parallelism with the graph=2 ring == JAX's same step ==
    the port's 1 x 1 mesh, to 1e-9 (only the order of the mean differs)."""
    bi, bj, ti, tj, jmodel, variables, _, keys = dp_setup
    cfg = JConfig(learning_rate=1e-2)
    opt = jreplay.make_optimizer(cfg)
    jstep = jdp.make_dp_train_step(jmodel, opt, j_make_mesh(data=4, graph=2), mode="mean",
                                   fp_fn=FP_FN)
    v_j, _, m_j = jstep(variables, opt.init(variables["params"]), bi, bj, keys,
                        jnp.asarray(0.0, jnp.float64))

    topt = treplay.make_optimizer(Config(learning_rate=1e-2))
    results = {}
    for name, mesh in (("4x2", make_mesh(data=4, graph=2, devices=cpus(8))),
                       ("1x1", make_mesh(data=1, graph=1, devices=cpus(1)))):
        model = _port_model(variables)
        step = tdp.make_dp_train_step(model, topt, mesh, mode="mean")
        state = topt.init({k: p.detach() for k, p in model.named_parameters()})
        params, state, metrics = step(model, state, ti, tj, None, 0.0)
        assert state.count == 1
        for k, p in model.named_parameters():
            assert torch.equal(p.detach(), params[k])
        results[name] = (params, metrics)
    for name, (params, metrics) in results.items():
        for k, p in params.items():
            want = _jax_leaf(v_j["params"], k)
            np.testing.assert_allclose(p.numpy(), want, rtol=1e-9,
                                       atol=1e-9 * np.abs(want).max(), err_msg=(name, k))
            one = results["1x1"][0][k].numpy()
            np.testing.assert_allclose(p.numpy(), one, rtol=1e-9, atol=1e-9 * np.abs(one).max())
        np.testing.assert_allclose(float(metrics["loss_critic"]), float(m_j["loss_critic"]),
                                   rtol=1e-9)
        np.testing.assert_allclose(float(metrics["loss_mse"]), float(m_j["loss_mse"]),
                                   rtol=1e-9)
        np.testing.assert_allclose(metrics["job_total"].numpy(), np.asarray(m_j["job_total"]),
                                   rtol=1e-9)
    moved = [not torch.equal(results["1x1"][0][k], torch.from_numpy(
        np.array(_jax_leaf(variables["params"], k)))) for k in results["1x1"][0]]
    assert all(moved)


def test_mean_step_refreshes_replicas_on_distinct_devices(dp_setup):
    """`cpu` and `cpu:0` are distinct mesh devices (two replica objects, one
    memory): after each mean update the copy holds the model's new
    parameters, and two steps give the one-replica mesh's parameters bit
    for bit."""
    _, _, ti, tj, _, variables, _, _ = dp_setup
    topt = treplay.make_optimizer(Config(learning_rate=1e-2))
    runs = {}
    for name, devs in (("two", [CPU, torch.device("cpu", 0)]), ("one", cpus(2))):
        model = _port_model(variables)
        step = tdp.make_dp_train_step(model, topt, make_mesh(data=2, devices=devs))
        state = topt.init({k: p.detach() for k, p in model.named_parameters()})
        for _ in range(2):
            _, state, _ = step(model, state, ti, tj, None, 0.0)
            copies = list(step.replicas._copies.values())
            assert len(copies) == (1 if name == "two" else 0)
            for rep in copies:
                assert rep is not model
                for p, q in zip(rep.parameters(), model.parameters()):
                    assert torch.equal(p, q)
        runs[name] = {k: p.detach().clone() for k, p in model.named_parameters()}
    for k in runs["one"]:
        assert torch.equal(runs["two"][k], runs["one"][k])


def test_replay_step_buffer_matches_jax(dp_setup):
    bi, bj, ti, tj, jmodel, variables, tmodel, keys = dp_setup
    b = ti.adj.shape[0]
    opt = jreplay.make_optimizer(JConfig())
    jmem = jreplay.replay_init(variables["params"], 16)
    jstep = jdp.make_dp_train_step(jmodel, opt, j_make_mesh(data=4, graph=1), mode="replay",
                                   fp_fn=FP_FN)
    jmem, jm = jstep(variables, jmem, bi, bj, keys, jnp.asarray(0.0, jnp.float64))
    mesh = make_mesh(data=4, devices=cpus(4))
    step = tdp.make_dp_train_step(tmodel, treplay.make_optimizer(Config()), mesh, mode="replay")
    mem = treplay.replay_init({k: p.detach() for k, p in tmodel.named_parameters()}, 16)
    mem, m = step(tmodel, mem, ti, tj, [0, 1, 2, 3], 0.0)
    assert mem.count == int(jmem.count) == b and mem.ptr == int(jmem.ptr)
    for k, buf in mem.grads.items():
        want = _jax_leaf(jmem.grads, k)
        np.testing.assert_allclose(buf.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(), err_msg=k)
    for f in ("loss_critic", "loss_mse"):
        np.testing.assert_allclose(getattr(mem, f).numpy(), np.asarray(getattr(jmem, f)),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(m[f].numpy(), np.asarray(jm[f]), rtol=1e-12, atol=0)
    np.testing.assert_allclose(m["job_total"].numpy(), np.asarray(jm["job_total"]),
                               rtol=1e-12)


def _take(rec, idx):
    """Episodes `idx` of a batched dense record."""
    idx = torch.tensor(idx)
    return dataclasses.replace(rec, **{
        f.name: getattr(rec, f.name)[idx] for f in dataclasses.fields(rec)
        if isinstance(getattr(rec, f.name), torch.Tensor)})


def test_file_step_keeps_pad_episodes_out_as_jax(dp_setup):
    """One network's 3 job sets padded to 4 (the last repeated) over data 2:
    the buffer holds the 3 real episodes in order, as JAX's
    `make_file_dp_train_step` keeps them."""
    bi, bj, ti, tj, jmodel, variables, tmodel, keys = dp_setup
    jobs_idx = [0, 1, 0, 0]  # episodes 0 and 1 are network 0's job sets
    valid = np.array([True, True, True, False])
    jmem = jreplay.replay_init(variables["params"], 8)
    jstep = jdp.make_file_dp_train_step(jmodel, j_make_mesh(data=2, graph=1), fp_fn=FP_FN)
    jmem, jtot, jlc, _ = jstep(
        variables, jmem, jax.tree_util.tree_map(lambda x: x[0], bi),
        jax.tree_util.tree_map(lambda x: x[np.asarray(jobs_idx)], bj), keys[:4],
        jnp.asarray(valid), jnp.asarray(0.0, jnp.float64))
    step = tdp.make_file_dp_train_step(tmodel, make_mesh(data=2, devices=cpus(2)))
    mem = treplay.replay_init({k: p.detach() for k, p in tmodel.named_parameters()}, 8)
    mem, tot, lc, _ = step(tmodel, mem, _take(ti, [0] * 4), _take(tj, jobs_idx), None,
                           torch.from_numpy(valid), 0.0)
    assert mem.count == int(jmem.count) == 3 and mem.ptr == int(jmem.ptr)
    for k, buf in mem.grads.items():
        want = _jax_leaf(jmem.grads, k)
        np.testing.assert_allclose(buf.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(mem.loss_critic.numpy(), np.asarray(jmem.loss_critic),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(lc.numpy(), np.asarray(jlc), rtol=1e-12)
    np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), rtol=1e-12)


def test_dp_eval_step_totals_match_jax(dp_setup):
    bi, bj, ti, tj, jmodel, variables, tmodel, keys = dp_setup
    jstep = jdp.make_dp_eval_step(jmodel, j_make_mesh(data=2, graph=2))
    want = np.asarray(jstep(variables, bi, bj, keys))
    step = tdp.make_dp_eval_step(tmodel, make_mesh(data=2, graph=2, devices=cpus(4)))
    got = step(tmodel, ti, tj, None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    one = forward_env(tmodel, ti, tj, device="cpu")[0].job_total
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-12)
    assert np.isfinite(got.numpy()[tj.mask.numpy()]).all()


# ---- the drivers -------------------------------------------------------------------


def _jax_trainer_rows(kw, keys):
    jt = jd.Trainer(JConfig(**kw, fp_impl="pallas", mesh_data=2))
    assert jt.n_dp == 2
    inner = jt._replay

    def recording(mem, params, opt_state, key):
        keys.append((np.asarray(key), int(mem.count)))
        return inner(mem, params, opt_state, key=key)

    recording.account = inner.account
    jt._replay = recording
    p0 = jax.device_get(jt.variables["params"])
    return jt, p0, read_rows(jt.run(verbose=False))


def test_trainer_data_parallel_matches_jax_and_one_device(tiny, tmp_path, monkeypatch):
    """3 job sets a file, padded to 4 over `mesh_data = 2`, replay indices
    injected from JAX's keys."""
    kw = {**common(tiny, tmp_path, **{**TRAIN, "batch": 4}), "num_instances": 3}
    keys = []
    jt, p0, want = _jax_trainer_rows(kw, keys)
    rows = {}
    for n_dp in (2, 1):
        indices = iter([jax_indices(k, c, TRAIN["memory_size"], 4) for k, c in keys])
        monkeypatch.setattr(treplay, "sample_indices",
                            lambda mem, batch, gen=None: torch.tensor(next(indices)))
        tt = td.Trainer(Config(**{**kw, "mesh_data": n_dp, "out": str(tmp_path / f"p{n_dp}"),
                                  "model_root": str(tmp_path / f"m{n_dp}")}),
                        device="cpu", devices=cpus(2))
        assert tt.n_dp == n_dp and tt.mesh.shape == {"data": n_dp, "graph": 1}
        tt.model.load_state_dict(tcheb.params_from_jax(p0))
        rows[n_dp] = read_rows(tt.run(verbose=False))
        assert next(indices, None) is None
        np.testing.assert_allclose(tt.replay_losses, jt.replay_losses, rtol=1e-6, atol=0)
        assert tt.state.mem.count == min(4 * 3, TRAIN["memory_size"])
        final = tcheb.params_from_jax(jax.device_get(jt.variables["params"]))
        for k, v in tt.params().items():
            np.testing.assert_allclose(v.numpy(), final[k].numpy(), rtol=1e-9,
                                       atol=1e-9 * float(final[k].abs().max()))
    assert len(rows[2]) == 4 * 3 * 4
    assert_rows_equal(rows[2], want)
    assert_rows_equal(rows[2], rows[1])


def test_evaluator_file_sharding_matches_jax_and_one_device(tiny, tmp_path):
    kw = common(tiny, tmp_path, file_batch=2)
    jev = jd.Evaluator(JConfig(**kw, fp_impl="pallas", mesh_data=2))
    assert jev.eval_chunk == 4
    want = read_rows(jev.run(verbose=False))
    jparams = jax.device_get(jev.variables["params"])
    rows = {}
    for n_dp, fb in ((2, 2), (1, 1)):
        ev = td.Evaluator(Config(**{**kw, "mesh_data": n_dp, "file_batch": fb,
                                    "out": str(tmp_path / f"p{n_dp}")}),
                          device="cpu", devices=cpus(2))
        assert ev.eval_chunk == n_dp * fb
        ev.model.load_state_dict(tcheb.params_from_jax(jparams))
        rows[n_dp] = read_rows(ev.run(verbose=False))
    assert len(rows[2]) == 4 * 4 * 3
    assert_rows_equal(rows[2], want)
    assert_rows_equal(rows[2], rows[1])


def test_driver_mesh_settings_raise_jax_errors(tiny, tmp_path):
    kw = common(tiny, tmp_path)
    for cls in (td.Evaluator, td.Trainer):
        with pytest.raises(ValueError, match="exceeds the 2 local devices"):
            cls(Config(**kw, mesh_data=3), device="cpu", devices=cpus(2))
        with pytest.raises(ValueError, match="mesh_graph>1"):
            cls(Config(**kw, mesh_graph=2), device="cpu")
        # on the CPU with no device list the mesh is the one CPU device
        assert cls(Config(**kw), device="cpu").n_dp == 1
