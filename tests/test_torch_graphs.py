"""PyTorch port, graphs/: the tensor builders against the JAX builders.

Every field of `Instance` / `JobSet` must equal the JAX builder's output
exactly (values and dtypes), and the committed cases file must equal a
fresh `cli/datagen.generate_dataset` run.  Also holds the import rule of the
port: no module of it (nor `chip_smoke.py`) imports jax, flax, networkx,
orbax or the JAX package.
"""

import ast
import os

import numpy as np
import pytest
import torch

from multihop_offload_tpu.graphs import generators
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.graphs import cases as tcases
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "multihop_offload_tpu_torch")


def _case(n, seed):
    """A BA network with random roles, capacities and mean link rates."""
    adj, _ = generators.barabasi_albert(n, m=2, seed=seed)
    rng = np.random.default_rng(seed)
    roles = np.zeros(n, dtype=np.int32)
    picks = rng.permutation(n)
    roles[picks[: max(2, n // 6)]] = 1
    roles[picks[max(2, n // 6): max(2, n // 6) + 2]] = 2
    bws = np.where(roles == 1, rng.uniform(100, 300, n),
                   np.where(roles == 0, rng.uniform(5, 15, n), 0.0)).round()
    links = int(np.triu(adj, 1).sum())
    return adj, roles, bws, rng.uniform(30, 70, links)


def _assert_same(t, j):
    """A torch tensor equals a JAX/numpy array exactly, dtype included (an
    absent optional field, such as `sparse` under dense, on both sides)."""
    if j is None or t is None:
        assert j is None and t is None, (t, j)
        return
    a = np.asarray(j)
    b = t.numpy()
    assert b.dtype == a.dtype, (b.dtype, a.dtype)
    assert b.shape == a.shape, (b.shape, a.shape)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n,seed", [(12, 1), (25, 2), (40, 3)])
def test_topology_matches_jax(n, seed):
    adj, *_ = _case(n, seed)
    tj, tt = jtopo.build_topology(adj), ttopo.build_topology(adj)
    for f in ("adj", "link_ends", "link_index", "adj_lg", "adj_conflict", "cf_degs"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
        assert getattr(tt, f).dtype == getattr(tj, f).dtype
    assert tt.adj_conflict.dtype == np.uint8
    r1 = jtopo.sample_link_rates(tj, 50.0, rng=np.random.default_rng(7))
    r2 = ttopo.sample_link_rates(tt, 50.0, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(r1, r2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_instance_and_jobset_fields_exact(dtype):
    cases = [_case(12, 4), _case(30, 5)]
    pad = jinst.PadSpec.for_cases(
        [(len(r), int(np.triu(a, 1).sum()), int((r == 1).sum()), 8)
         for a, r, _, _ in cases])
    tpad = tinst.PadSpec(pad.n, pad.l, pad.s, pad.j)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    js, ts = [], []
    for adj, roles, bws, mean in cases:
        topo_j, topo_t = jtopo.build_topology(adj), ttopo.build_topology(adj)
        rates = jtopo.sample_link_rates(topo_j, mean, rng=np.random.default_rng(0))
        ij = jinst.build_instance(topo_j, roles, bws, rates, 1000.0, pad,
                                  dtype=dtype, device=False)
        it = tinst.build_instance(topo_t, roles, bws, rates, 1000.0, tpad,
                                  dtype=tdt, device="cpu")
        for f in tinst.Instance.__dataclass_fields__:
            _assert_same(getattr(it, f), getattr(ij, f))
        js.append(ij)
        ts.append(it)
    bj, bt = jinst.stack_instances(js), tinst.stack_instances(ts)
    for f in tinst.Instance.__dataclass_fields__:
        _assert_same(getattr(bt, f), getattr(bj, f))

    src = np.array([3, 0, 7])
    rate = np.array([0.02, 0.05, 0.01])
    jj = [jinst.build_jobset(src, rate, 8, dtype=dtype, device=False),
          jinst.build_jobset(src[:1], rate[:1], 8, dtype=dtype, device=False)]
    jt = [tinst.build_jobset(src, rate, 8, dtype=tdt, device="cpu"),
          tinst.build_jobset(src[:1], rate[:1], 8, dtype=tdt, device="cpu")]
    for a, b in zip(jj + [jinst.stack_instances(jj)],
                    jt + [tinst.stack_instances(jt)]):
        for f in tinst.JobSet.__dataclass_fields__:
            _assert_same(getattr(b, f), getattr(a, f))


def test_hop_matrix_matches_jax():
    adj, *_ = _case(25, 8)
    tj, tt = jtopo.build_topology(adj), ttopo.build_topology(adj)
    np.testing.assert_array_equal(tinst.compute_hop_matrix(tt, 32),
                                  jinst.compute_hop_matrix(tj, 32))


def test_entry_points_default_to_cuda():
    """Builders run on CUDA unless the caller asks for the CPU."""
    adj, roles, bws, mean = _case(12, 9)
    topo = ttopo.build_topology(adj)
    pad = tinst.PadSpec(16, 24, 8, 8)
    if torch.cuda.is_available():
        assert tinst.build_jobset([1], [0.1], 8).src.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tinst.build_instance(topo, roles, bws, mean, 1000.0, pad)
    assert tinst.build_jobset([1], [0.1], 8, device="cpu").src.device.type == "cpu"
    with pytest.raises(ValueError):
        tinst.build_jobset([1], [0.1], 8, device="meta")


def test_committed_cases_equal_fresh_datagen():
    """`data/cases.npz` is what `cli/datagen.generate_dataset` writes for
    the same seeds (scripts/export_torch_port_data.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_torch_port_data",
        os.path.join(ROOT, "scripts", "export_torch_port_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(tcases.CASES_PATH) as z:
        committed = {k: z[k] for k in z.files}
    fresh = mod.large_arrays()
    for group in mod.CASE_GROUPS:
        fresh.update(mod.case_arrays(group))
    assert sorted(fresh) == sorted(committed)
    for key, val in fresh.items():
        assert committed[key].dtype == val.dtype, key
        np.testing.assert_array_equal(committed[key], val, err_msg=key)
    recs = tcases.load_cases("paper")
    assert [r.topo.n for r in recs[:3]] == [100, 110, 20]
    assert len(tcases.load_cases("rung256")) == 4


def test_request_batch_follows_bench_workload():
    """`request_batch` draws link rates and job sets as `bench.py` does."""
    recs = tcases.load_cases("paper")[2:4]
    cfg = Config(arrival_scale=0.15)
    inst, jobs, pad = tcases.request_batch(recs, per_network=2, seed=3, cfg=cfg,
                                           dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    for c, rec in enumerate(recs):
        rates = ttopo.sample_link_rates(rec.topo, rec.link_rates, rng=rng)
        np.testing.assert_array_equal(
            inst.link_rates[2 * c, : rec.topo.num_links].numpy(), rates)
        for k in range(2):
            mobile = rng.permutation(rec.mobile_nodes)
            nj = int(rng.integers(max(int(0.3 * mobile.size), 1), mobile.size))
            row = 2 * c + k
            np.testing.assert_array_equal(jobs.src[row, :nj].numpy(), mobile[:nj])
            np.testing.assert_array_equal(
                jobs.rate[row, :nj].numpy(), 0.15 * rng.uniform(0.1, 0.5, nj))
            assert int(jobs.mask[row].sum()) == nj
    assert inst.adj.shape == (4, pad.n, pad.n)
    assert (inst.T == 1000.0).all() and (jobs.ul == 100.0).all()


_BANNED = ("jax", "flax", "optax", "networkx", "orbax", "multihop_offload_tpu", "pandas",
           "tensorflow", "ml_dtypes", "google.protobuf")


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_side():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    assert len(files) > 15
    rel = {os.path.relpath(f, PORT) for f in files}
    for module in ("ops/sparse.py", "ops/chebconv.py", "layouts/policy.py",
                   "layouts/compact.py", "layouts/sparse.py", "agent/train_step.py",
                   "agent/replay.py", "_records.py", "large_scale.py",
                   "graphs/generators.py", "obs/registry.py", "obs/events.py",
                   "obs/spans.py", "obs/trace.py", "obs/flightrec.py", "train/metrics.py",
                   "serve/request.py", "serve/guards.py", "serve/bucketing.py",
                   "serve/workload.py", "serve/metrics.py", "serve/executor.py",
                   "serve/watchdog.py", "serve/service.py", "cli/serve.py",
                   "graphs/matio.py", "train/data.py", "train/checkpoints.py",
                   "train/driver.py", "utils/durable.py", "cli/train.py", "cli/test.py",
                   "env/scheduling.py", "graphs/mobility.py", "obs/devmetrics.py",
                   "sim/__init__.py", "sim/state.py", "sim/step.py", "sim/policies.py",
                   "sim/runner.py", "sim/fidelity.py", "cli/sim.py", "precision.py",
                   "graphs/cuts.py", "cli/datagen.py", "utils/signals.py",
                   "obs/__init__.py", "models/tf_bundle.py", "models/tf_import.py",
                   "train/analysis.py", "utils/visualization.py", "cli/plot.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
                   "parallel/ring.py", "parallel/partition.py", "parallel/data_parallel.py",
                   "multihost/__init__.py", "multihost/runtime.py",
                   "serve/placement.py", "serve/sharded.py", "obs/slo.py",
                   "multihost/plan.py", "multihost/federation.py", "loadgen/__init__.py",
                   "loadgen/arrivals.py", "loadgen/driver.py", "loadgen/search.py",
                   "cli/mesh.py"):
        assert module in rel, module
    for path in files:
        for mod in _imports(path):
            assert not any(mod == b or mod.startswith(b + ".") for b in _BANNED), \
                f"{path} imports {mod}"
            # the process group is brought up in one place
            if mod == "torch.distributed" or mod.startswith("torch.distributed."):
                assert os.path.relpath(path, PORT) == "multihost/runtime.py", path
