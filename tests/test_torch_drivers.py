"""PyTorch port, the Evaluator driver and the pieces the drivers add,
against the JAX package on the CPU in float64, on a tiny dataset written
by the JAX `generate_dataset` (n = 20, 30; two seeds):

* the Evaluator's CSV rows equal the JAX Evaluator's (params carried from
  the JAX harness), dense and sparse, at 1 and 2 pad buckets: strings and
  integers exact, floats within rtol 1e-9, `runtime` excluded;
* `file_batch=2` gives the rows of `file_batch=1`; `prob=True` is
  deterministic per seed, independent of `file_batch`, and decides validly;
* the fresh-init probes and `ensure_alive_output_multi` equal JAX's;
* `forward_backward(compat_diagonal_bug=True)` equals JAX's (losses and
  gradients 1e-12), `episode_grad_norms` to float32 rounding (both
  accumulate in float32), `instance_metrics` within 1e-12;
* every refused setting raises (a fixed-point route other than `auto`
  already in `Config`, and from the command line), `mesh_graph > 1` raises
  JAX's `ValueError`, a TF-format checkpoint in the model directory is
  loaded, and `mesh_data > 1` and `csv_write_all_hosts` run;
  `cli.test.main` runs with `--device cpu` and raises without it on a
  machine with no CUDA.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.agent.actor import build_ext_features as j_features
from multihop_offload_tpu.agent.train_step import episode_grad_norms as j_grad_norms
from multihop_offload_tpu.agent.train_step import forward_backward as j_forward_backward
from multihop_offload_tpu.cli.datagen import generate_dataset
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.layouts import SparseSupport as JSparseSupport
from multihop_offload_tpu.layouts import zeros_support
from multihop_offload_tpu.models.chebconv import ensure_alive_output_multi as j_alive
from multihop_offload_tpu.train import data as jdata
from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu.train.metrics import instance_metrics as j_metrics
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.agent.train_step import episode_grad_norms, forward_backward
from multihop_offload_tpu_torch.cli import test as cli_test
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models.chebconv import ensure_alive_output_multi
from multihop_offload_tpu_torch.models.chebconv import params_from_jax
from multihop_offload_tpu_torch.models.tf_import import save_reference_checkpoint
from multihop_offload_tpu_torch.train import driver as td
from multihop_offload_tpu_torch.train.metrics import instance_metrics
from tests.test_torch_layouts import FP_FN, eq, models, paired_batch, synthetic

FLOAT_COLUMNS = ("tau", "gnn_bl_ratio", "gap_2_bl")
MODEL = dict(cheb_k=2, hidden=8, num_layer=3)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data") / "aco_data_ba_tiny")
    generate_dataset(d, gtype="ba", size=2, seed0=500, graph_sizes=[20, 30], verbose=False)
    return d


def common(datapath, tmp_path, **kw):
    return dict(datapath=datapath, out=str(tmp_path / "out"),
                model_root=str(tmp_path / "model"), T=1000, arrival_scale=0.15,
                dtype="float64", num_instances=4, seed=3, training_set="TEST",
                **{**MODEL, **kw})


def jax_config(**kw) -> JConfig:
    """The JAX drivers' config for a parity run: one device, and the
    fixed-point core the port runs (K1's dense-matrix scan)."""
    return JConfig(**kw, fp_impl="pallas", mesh_data=1)


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def assert_rows_equal(got, want, rtol=1e-9):
    """CSV rows: the same columns and count; strings and integers exact,
    floats within `rtol` (NaN where NaN), `runtime` excluded."""
    assert len(got) == len(want) > 0
    assert list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for k in g:
            if k == "runtime":
                continue
            if k in FLOAT_COLUMNS:
                a, b = float(g[k] or "nan"), float(w[k] or "nan")
                assert np.isnan(a) == np.isnan(b), (k, g, w)
                if not np.isnan(b):
                    np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=k)
            else:
                assert g[k] == w[k], (k, g, w)


def port_evaluator(cfg: Config, jparams=None):
    ev = td.Evaluator(cfg, device="cpu")
    if jparams is not None:
        ev.model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return ev


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("buckets", [1, 2])
def test_evaluator_matches_jax(tiny, tmp_path, layout, buckets):
    kw = common(tiny, tmp_path, layout=layout, pad_buckets=buckets)
    jev = jd.Evaluator(jax_config(**kw))
    want = read_rows(jev.run(verbose=False))
    tkw = {**kw, "out": str(tmp_path / "port")}
    ev = port_evaluator(Config(**tkw), jev.variables["params"])
    assert [p.n for p in ev.data.pads] == [p.n for p in jev.data.pads]
    got = read_rows(ev.run(verbose=False))
    assert len(got) == 4 * 4 * 3
    assert list(got[0]) == td.TEST_COLUMNS == jd.TEST_COLUMNS
    assert_rows_equal(got, want)


@pytest.mark.parametrize("prob", [False, True])
def test_file_batch_gives_the_sequential_rows(tiny, tmp_path, prob):
    """Two files per call (same bucket) write the rows of one file per
    call; under `prob=True` each file still draws from its own generator."""
    kw = common(tiny, tmp_path, layout="sparse", pad_buckets=2, prob=prob)
    one = read_rows(port_evaluator(Config(**kw)).run(verbose=False))
    kw2 = {**kw, "out": str(tmp_path / "b2"), "file_batch": 2}
    two = read_rows(port_evaluator(Config(**kw2)).run(verbose=False))
    assert_rows_equal(two, one)


def test_prob_is_deterministic_per_seed_and_valid(tiny, tmp_path):
    kw = common(tiny, tmp_path, prob=True)
    a = read_rows(port_evaluator(Config(**kw)).run(verbose=False))
    b = read_rows(port_evaluator(Config(**{**kw, "out": str(tmp_path / "b")})).run(
        verbose=False))
    assert_rows_equal(a, b, rtol=0)
    greedy = read_rows(port_evaluator(Config(**{**kw, "prob": False,
                                                "out": str(tmp_path / "g")})).run(
        verbose=False))
    gnn = [(float(x["tau"]), float(y["tau"])) for x, y in zip(a, greedy) if x["Algo"] == "GNN"]
    assert any(x != y for x, y in gnn)  # the sampled decisions are used
    # the decisions themselves: a server or the job's own source, on real jobs
    ev = port_evaluator(Config(**kw))
    (rec, inst, jobs, _), _ = ev._build_file(0)
    inst_b, jobs_b = ev._on_device([(rec, inst, jobs, None)])
    out, _ = forward_env(ev.model, inst_b, jobs_b, ev._file_gen(0), prob=True, device="cpu")
    dst = out.decision.dst
    srv = inst_b.servers.unsqueeze(1) == dst.unsqueeze(2)
    ok = (srv & inst_b.server_mask.unsqueeze(1)).any(dim=2) | (dst == jobs_b.src)
    assert bool(ok[jobs_b.mask].all())
    again, _ = forward_env(ev.model, inst_b, jobs_b, ev._file_gen(0), prob=True, device="cpu")
    assert torch.equal(again.decision.dst, dst)


def _jax_probes(jc, cfg: JConfig, layout):
    """The probes of the JAX harness (`train/driver.py:134-159`)."""
    probe_rng = np.random.default_rng(cfg.seed)
    n = len(jc)
    probes = []
    for fid in sorted({0, n // 3, 2 * n // 3, n - 1}):
        inst = jc.instance(fid, probe_rng)
        js, _ = jdata.sample_jobsets(jc.records[fid], jc.pad_of(fid), 1, probe_rng,
                                     cfg.arrival_scale, dtype=np.float64,
                                     index_dtype=np.int16 if layout == "sparse" else np.int32)
        jb = jax.tree_util.tree_map(lambda x: x[0], js)
        if layout == "sparse":
            sup = JSparseSupport(edges=inst.sparse.ext,
                                 diag=jnp.zeros((inst.ext_mask.shape[0],), jnp.float64))
        else:
            sup = inst.adj_ext
        probes.append((j_features(inst, jb), sup, inst.ext_mask))
    return probes


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_fresh_init_probes_and_alive_fixup_match_jax(tiny, tmp_path, layout):
    kw = common(tiny, tmp_path, layout=layout)
    jcfg = jax_config(**kw)
    jev = jd.Evaluator(jcfg)
    ev = port_evaluator(Config(**kw))
    jprobes = _jax_probes(jev.data, jcfg, layout)
    tprobes = ev._probes()
    assert len(tprobes) == len(jprobes) == 4
    for (tf, ts, tm), (jf, js, jm) in zip(tprobes, jprobes):
        np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
        if layout == "sparse":
            for f in ("rows", "cols", "vals"):
                eq(getattr(ts.edges, f)[0], getattr(js.edges, f))
        else:
            eq(ts[0], js)
    pad = jev.data.pad
    flips = 0
    for seed in range(4):
        raw = jev.model.init(jax.random.PRNGKey(seed), jnp.zeros((pad.e, 4), jnp.float64),
                             zeros_support(pad, jnp.float64, layout))
        last = f"cheb_{MODEL['num_layer'] - 1}"
        neg = {"params": {**raw["params"], last: jax.tree_util.tree_map(
            lambda w: -w, raw["params"][last])}}
        for init in (raw, neg):
            want = jax.device_get(j_alive(jev.model, init, jprobes)["params"])
            ev.model.load_state_dict(params_from_jax(jax.device_get(init)))
            ensure_alive_output_multi(ev.model, tprobes)
            got = ev.model.state_dict()
            for k, v in params_from_jax(want).items():
                torch.testing.assert_close(got[k], v, rtol=0, atol=0)
            flips += not np.array_equal(np.asarray(want[last]["bias"]),
                                        np.asarray(init["params"][last]["bias"]))
    assert flips > 0


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_compat_diagonal_bug_step_and_grad_norms_match_jax(layout):
    bi, bj, ti, tj, pad = paired_batch([synthetic(n, s) for n, s in ((16, 4), (26, 5))],
                                       layout, seed=11)
    jmodel, variables, tmodel = models(2, 2, 8, pad, layout)
    key = jax.random.PRNGKey(0)
    jout = jax.jit(jax.vmap(lambda i, j: j_forward_backward(
        jmodel, variables, i, j, key, fp_fn=FP_FN, layout=layout,
        compat_diagonal_bug=True)))(bi, bj)
    tout = forward_backward(tmodel, ti, tj, layout=layout, device="cpu",
                            compat_diagonal_bug=True)
    plain = forward_backward(tmodel, ti, tj, layout=layout, device="cpu")
    eq(tout.dst, jout.dst)
    assert not torch.equal(tout.dst, plain.dst)  # the cycled diagonal decides
    np.testing.assert_allclose(tout.loss_critic.numpy(), np.asarray(jout.loss_critic),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(tout.loss_mse.numpy(), np.asarray(jout.loss_mse),
                               rtol=1e-12, atol=0)
    for name, g in tout.grads.items():
        _, i, leaf = name.split(".")
        j = np.asarray(jout.grads["params"][f"cheb_{i}"][leaf])
        assert np.abs(g.numpy() - j).max() <= 1e-12 * max(np.abs(j).max(), 1e-300)
    # both accumulate the norms in float32: equal to float32 rounding
    np.testing.assert_allclose(episode_grad_norms(tout.grads).numpy(),
                               np.asarray(j_grad_norms(jout.grads["params"])), rtol=1e-6)


def test_instance_metrics_match_jax():
    rng = np.random.default_rng(5)
    tot = rng.uniform(0.5, 2000.0, (6, 9))
    base = rng.uniform(0.5, 2000.0, (6, 9))
    mask = rng.uniform(size=(6, 9)) < 0.7
    mask[0] = False  # an instance with no job
    t = instance_metrics(torch.from_numpy(tot), torch.from_numpy(base),
                         torch.from_numpy(mask), 1000.0)
    j = jax.vmap(lambda a, b, m: j_metrics(a, b, m, 1000.0))(tot, base, mask)
    for f in ("tau", "congest_jobs", "gap_2_bl", "ratio_2_bl"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-12, atol=0, err_msg=f)


@pytest.mark.parametrize("setting,waits", [
    ({"mesh_data": 2}, "item 7"), ({"dropout": 0.1}, "item 3"),
    ({"tb_logdir": "tb"}, "item 3"), ({"precision": "bf16"}, "item 10"),
    ({"tf_checkpoint": True}, "item 4"), ({"csv_write_all_hosts": True}, "item 7"),
    ({"apsp_impl": "xla"}, "only 'auto'"), ({"fp_impl": "pallas"}, "only 'auto'"),
    ({"mesh_graph": 2}, "mesh_graph>1"),
])
def test_unported_settings_are_refused(tiny, tmp_path, setting, waits):
    kw = common(tiny, tmp_path)
    if "tb_logdir" in setting:
        setting = {"tb_logdir": str(tmp_path / setting["tb_logdir"])}
    # a TF-format checkpoint in the model directory waited on item 4, which
    # is done: both drivers load it (its weights, no alive-flip)
    if setting.pop("tf_checkpoint", False):
        model_dir = Config(**kw).model_dir()
        rng = np.random.default_rng(0)
        dims = [4] + [MODEL["hidden"]] * (MODEL["num_layer"] - 1) + [1]
        tree = {"params": {f"cheb_{i}": {"kernel": rng.normal(size=(MODEL["cheb_k"], a, b)),
                                         "bias": rng.normal(size=(b,))}
                           for i, (a, b) in enumerate(zip(dims, dims[1:]))}}
        save_reference_checkpoint(os.path.join(model_dir, "cp-0000.ckpt"), tree)
        with open(os.path.join(model_dir, "checkpoint"), "w") as f:
            f.write('model_checkpoint_path: "cp-0000.ckpt"\n')
        for cls in (td.Evaluator, td.Trainer):
            params = cls(Config(**kw), device="cpu").params()
            for k, v in params_from_jax(tree).items():
                assert torch.equal(params[k], v), k
        return
    # apsp_impl takes JAX's values: xla, JAX's default, squares at every N
    if "apsp_impl" in setting:
        for cls in (td.Evaluator, td.Trainer):
            assert cls(Config(**kw, **setting), device="cpu").apsp_path == "squaring"
        return
    # the Trainer under bf16 waited on item 10, which is done: both drivers
    # now run under it
    if "precision" in setting:
        for cls in (td.Evaluator, td.Trainer):
            assert cls(Config(**kw, **setting), device="cpu").precision.mixed
        return
    # the data mesh waited on item 7, which is done for the drivers: both
    # shard over the devices they are given, and every process may write
    # its own CSV
    if "mesh_data" in setting:
        for cls in (td.Evaluator, td.Trainer):
            h = cls(Config(**kw, **setting), device="cpu", devices=[torch.device("cpu")] * 2)
            assert h.n_dp == 2 and h.mesh.shape == {"data": 2, "graph": 1}
        return
    if "csv_write_all_hosts" in setting:
        ev = td.Evaluator(Config(**kw, **setting), device="cpu")
        assert ev.is_host0 and len(read_rows(ev.run(files_limit=1, verbose=False))) == 4 * 3
        return
    # JAX's drivers shard only the data axis
    if "mesh_graph" in setting:
        for cls in (td.Evaluator, td.Trainer):
            with pytest.raises(ValueError, match=waits):
                cls(Config(**kw, **setting), device="cpu")
        return
    # item 3's exceptions are done: fp_impl takes JAX's values and reports
    # JAX's path, the Trainer trains with dropout and writes TensorBoard
    # scalars
    if "fp_impl" in setting:
        for cls in (td.Evaluator, td.Trainer):
            assert cls(Config(**kw, **setting), device="cpu").fp_path == "pallas"
        return
    tr = td.Trainer(Config(**kw, **setting, batch=2), device="cpu")
    rows = read_rows(tr.run(epochs=1, files_limit=1, verbose=False))
    assert len(rows) == 4 * 4 and all(np.isfinite(float(r["tau"])) for r in rows)
    assert np.isfinite(tr.replay_losses).all() and len(tr.replay_losses) == 1
    if "tb_logdir" in setting:
        assert any(f.startswith("events.out.tfevents.")
                   for f in os.listdir(setting["tb_logdir"]))
    else:
        assert tr.model.dropout == setting["dropout"]


def test_cli_test_runs_on_the_cpu_and_refuses_a_missing_card(tiny, tmp_path, capsys):
    args = ["--datapath", tiny, "--out", str(tmp_path / "out"), "--model_root",
            str(tmp_path / "model"), "--num_instances", "2", "--arrival_scale", "0.15"]
    path = cli_test.main(args + ["--device", "cpu"])
    rows = read_rows(path)
    assert os.path.basename(path) == "Adhoc_test_data_aco_data_ba_tiny_load_0.15_T_1000.csv"
    assert len(rows) == 4 * 2 * 3 and list(rows[0]) == td.TEST_COLUMNS
    assert "test results written to" in capsys.readouterr().out
    for flag, err in ((["--apsp_impl", "bogus"], ValueError),
                      (["--fp_impl", "bogus"], ValueError),
                      (["--mesh_graph", "2"], ValueError)):
        with pytest.raises(err):
            cli_test.main(args + ["--device", "cpu"] + flag)
    # fp_impl takes JAX's values; on the dense layout every core computes
    # the one fixed point, K1's plain version here
    assert_rows_equal(read_rows(cli_test.main(args + ["--device", "cpu", "--fp_impl",
                                                      "pallas"])), rows)
    again = cli_test.main(args + ["--device", "cpu", "--csv_write_all_hosts", "true"])
    assert_rows_equal(read_rows(again), rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_test.main(args)
