"""PyTorch port, the dataset generator (`cli/datagen.py`) and the large
demo's network draw (`large_scale.build_case`) on the CPU.

- `assign_roles` against the JAX function (networkx's cuts) on BA, WS, ER
  and Poisson graphs under the same numpy generator: roles and
  capacities identical, and the generator left in the same state;
- `generate_dataset` for `ba`, `poisson` and `er` at ``size=1``: the same
  file names, and every `.mat` field equal to the JAX generator's (`pos`
  within 1e-12, the rest exactly);
- with no JAX, networkx or JAX package importable, in a subprocess: the
  ``paper`` and ``rung256`` groups of `data/cases.npz` regenerated bit for
  bit (adjacency, link rates, `nodes_info`), the ``paper`` files' `pos`
  within 1e-12 of the committed `.mat` dataset, and the committed
  ``large`` case from `build_case()`;
- `build_case` against the JAX demo's `build_case` and job draw
  (`scripts/large_scale_demo.py`) for each of its families.
"""

import importlib.util
import os
import subprocess
import sys
import warnings

import networkx as nx
import numpy as np
import pytest
import scipy.io as sio

from multihop_offload_tpu.cli import datagen as jdatagen
from multihop_offload_tpu_torch.cli import datagen as tdatagen
from multihop_offload_tpu_torch.graphs import generators as tgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS_TOL = 1e-12


@pytest.mark.parametrize("family", ("ba", "ws", "er", "poisson"))
def test_assign_roles_equal_jax(family):
    for i, n in enumerate((20, 45, 80, 110)):
        adj, _ = tgen.generate(family, n, 30 + i)
        if not tgen._is_connected(adj):
            continue
        for num_servers in (2, n // 5, n // 2):
            r1 = np.random.default_rng(i)
            r2 = np.random.default_rng(i)
            got = tdatagen.assign_roles(adj, num_servers, r1)
            want = jdatagen.assign_roles(nx.from_numpy_array(adj), num_servers, r2)
            np.testing.assert_array_equal(got, want)
            assert r1.integers(1 << 30) == r2.integers(1 << 30)


def _mat(path):
    m = sio.loadmat(path)
    net = m["network"][0, 0]
    return {"adj": m["adj"].toarray(), "link_rate": m["link_rate"],
            "nodes_info": m["nodes_info"], "pos_c": m["pos_c"],
            "network": {k: np.asarray(net[k]).ravel().tolist() for k in net.dtype.names}}


@pytest.mark.parametrize("gtype", ("ba", "poisson", "er"))
def test_generate_dataset_equals_jax(gtype, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tdatagen.generate_dataset(str(tmp_path / "port"), gtype, size=1, seed0=11,
                                        verbose=False)
        want = jdatagen.generate_dataset(str(tmp_path / "jax"), gtype, size=1, seed0=11,
                                         verbose=False)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == len(tdatagen.GRAPH_SIZES)
    for a, b in zip(got, want):
        ma, mb = _mat(a), _mat(b)
        for key in ("adj", "link_rate", "nodes_info"):
            np.testing.assert_array_equal(ma[key], mb[key], err_msg=f"{a} {key}")
            assert ma[key].dtype == mb[key].dtype
        assert ma["network"] == mb["network"]
        np.testing.assert_allclose(ma["pos_c"], mb["pos_c"], rtol=0, atol=POS_TOL)


def test_datagen_cli(tmp_path):
    d = str(tmp_path / "cli")
    paths = tdatagen.main(["--datapath", d, "--gtype", "BA", "--size", "1", "--seed", "3",
                           "--m", "3"])
    assert len(paths) == len(tdatagen.GRAPH_SIZES)
    assert sorted(os.listdir(d)) == sorted(os.path.basename(p) for p in paths)
    assert all("_m3_" in p for p in paths)


NO_JAX = r"""
import importlib.abc, os, sys, tempfile

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "networkx", "multihop_offload_tpu"):
            raise ImportError(f"{name} is not importable here")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import scipy.io as sio
from multihop_offload_tpu_torch.cli.datagen import generate_dataset
from multihop_offload_tpu_torch.graphs.cases import CASES_PATH, load_large_case
from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET, list_dataset, load_case_mat
from multihop_offload_tpu_torch.large_scale import build_case

z = np.load(CASES_PATH)
for group, kw in (("paper", {}), ("rung256", {"size": 4, "graph_sizes": [250]})):
    d = tempfile.mkdtemp()
    generate_dataset(d, "ba", **{"size": 2, "seed0": 500, "verbose": False, **kw})
    names = list_dataset(d)
    assert names == [str(x) for x in z[f"{group}/names"]], names
    for i, name in enumerate(names):
        rec = load_case_mat(os.path.join(d, name))
        assert np.array_equal(rec.topo.adj, z[f"{group}/{i}/adj"]), name
        assert np.array_equal(rec.link_rates, z[f"{group}/{i}/link_rates"]), name
        info = np.stack([rec.roles.astype(np.int64), rec.proc_bws.astype(np.int64)], 1)
        assert np.array_equal(info, z[f"{group}/{i}/nodes_info"]), name
        assert rec.seed == int(z[f"{group}/{i}/seed"])
        if group == "paper":
            got = sio.loadmat(os.path.join(d, name))["pos_c"]
            want = sio.loadmat(os.path.join(PAPER_DATASET, name))["pos_c"]
            assert np.abs(got - want).max() <= %r, name
case, ref = build_case(), load_large_case()
assert np.array_equal(case.rec.topo.link_ends, ref.rec.topo.link_ends)
for k in ("roles", "proc_bws", "link_rates"):
    assert np.array_equal(getattr(case.rec, k), getattr(ref.rec, k)), k
assert np.array_equal(case.job_src, ref.job_src)
assert np.array_equal(case.job_rate, ref.job_rate)
assert (case.T, case.gtype) == (ref.T, ref.gtype)
assert not any(m.split(".")[0] in ("jax", "networkx", "multihop_offload_tpu")
               for m in sys.modules)
print("OK")
""" % POS_TOL


def test_committed_data_regenerated_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


def _demo():
    spec = importlib.util.spec_from_file_location(
        "large_scale_demo", os.path.join(ROOT, "scripts", "large_scale_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


@pytest.mark.parametrize("gtype", ("er", "ba", "ws", "poisson"))
def test_build_case_equals_demo(gtype):
    from multihop_offload_tpu_torch.large_scale import build_case

    n, seed, load = 120, 5, 0.15
    case = build_case(n, gtype, seed, load)
    rng = np.random.default_rng(seed)
    topo, roles, proc_bws, link_rates = _demo().build_case(n, gtype, seed, rng)
    mobile = np.flatnonzero(roles == 0)
    nj = int(0.5 * mobile.size)
    job_src = rng.permutation(mobile)[:nj]
    job_rate = load * rng.uniform(0.1, 0.5, nj)
    np.testing.assert_array_equal(case.rec.topo.adj, topo.adj)
    np.testing.assert_array_equal(case.rec.topo.link_ends, topo.link_ends)
    np.testing.assert_array_equal(case.rec.roles, roles)
    np.testing.assert_array_equal(case.rec.proc_bws, proc_bws)
    np.testing.assert_array_equal(case.rec.link_rates, link_rates)
    np.testing.assert_array_equal(case.job_src, job_src)
    np.testing.assert_array_equal(case.job_rate, job_rate)
