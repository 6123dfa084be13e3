"""PyTorch port, the paper's tables and figures without pandas or
networkx (`train/analysis.py`, `utils/visualization.py`, `cli/plot.py`,
`env/routing.link_incidence`), against the JAX package on the CPU:

* `read_csv` types and parses each column as pandas does (its float
  parser's bits, not Python's), and `summarize_test` and
  `overall_table` equal the JAX DataFrames (keys, row order, columns;
  values to rtol 1e-12) on the port Evaluator's CSV, on a reference-schema
  `Algo` CSV with NaN `gnn_bl_ratio` and `tau` cells and `num_jobs = 0`
  rows, and on a training CSV with tied `fid`s;
* the training monitor's and the Fig. 2 panels' plotted series equal
  JAX's (captured by wrapping `matplotlib.axes.Axes.plot`);
* `layout_positions` equals JAX's (1e-12), and each package reads the
  other's cache file;
* `draw_network` hands its drawing the colours, sizes, widths and edge
  colours (and edges, in order) JAX hands `networkx.draw`;
* `cli.plot.route_sums` equals the JAX route demo's link and node sums in
  float64 (1e-12), `link_incidence` is equal, and `cli.plot.main` writes
  the JAX CLI's file names.
"""

import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import multihop_offload_tpu.graphs.instance as jinst
import multihop_offload_tpu.utils.visualization as jvis
from multihop_offload_tpu.cli import plot as jplot
from multihop_offload_tpu.env.routing import link_incidence as j_link_incidence
from multihop_offload_tpu.graphs.matio import load_case_mat as j_load_case_mat
from multihop_offload_tpu.train import analysis as ja
from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch.cli import plot as tplot
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env.routing import link_incidence
from multihop_offload_tpu_torch.graphs import generators
from multihop_offload_tpu_torch.graphs.matio import load_case_mat
from multihop_offload_tpu_torch.train import analysis as ta
from multihop_offload_tpu_torch.train import driver as td
from multihop_offload_tpu_torch.utils import visualization as tvis
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER = os.path.join(ROOT, "multihop_offload_tpu_torch", "data", "aco_data_ba_paper")
CASE = os.path.join(PAPER, "aco_case_seed500_m2_n20_s4.mat")


# ---- CSVs ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def evaluator_csv(tmp_path_factory):
    """The port Evaluator's test CSV on two paper files."""
    tmp = tmp_path_factory.mktemp("eval")
    data = tmp / "aco_data_ba_two"
    data.mkdir()
    for name in ("aco_case_seed500_m2_n20_s4.mat", "aco_case_seed500_m2_n30_s7.mat"):
        shutil.copy(os.path.join(PAPER, name), data / name)
    cfg = Config(datapath=str(data), out=str(tmp / "out"), model_root=str(tmp / "model"),
                 T=1000, arrival_scale=0.15, dtype="float64", num_instances=4, seed=3)
    return td.Evaluator(cfg, device="cpu").run(verbose=False)


def write_reference_csv(path: str, seed: int = 0) -> str:
    """A reference-schema test CSV (`Algo`): three methods over four sizes,
    some `gnn_bl_ratio` and `tau` cells empty, some `num_jobs` 0."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(120):
        n = int(rng.choice([20, 50, 80, 110]))
        jobs = int(rng.integers(0, 12)) if i % 9 else 0
        row = {"filename": f"aco_case_seed{500 + i}_m2_n{n}_s3.mat", "seed": 500 + i,
               "num_nodes": n, "m": 2, "num_mobile": n // 2, "num_servers": 3,
               "num_relays": n - n // 2 - 3, "num_jobs": jobs, "n_instance": i % 10,
               "Algo": ["baseline", "local", "GNN"][i % 3],
               "runtime": rng.uniform(1e-3, 1e-1), "tau": rng.lognormal(3.0, 1.0),
               "congest_jobs": int(rng.integers(0, jobs + 1)),
               "gnn_bl_ratio": rng.uniform(0.5, 2.0), "gap_2_bl": rng.normal()}
        if i % 7 == 0:
            row["gnn_bl_ratio"] = np.nan
        if i % 11 == 0:
            row["tau"] = np.nan
        rows.append(row)
    pd.DataFrame(rows, columns=jd.TEST_COLUMNS).to_csv(path, index=False)
    return path


def write_training_csv(path: str, seed: int = 1) -> str:
    """A training CSV (`method`): four methods over 150 files, each `fid`
    appearing several times per method in a shuffled order (ties), some
    `tau` cells empty."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(600):
        fid = int(rng.integers(0, 150))
        rows.append({"fid": fid, "filename": f"f{fid}.mat", "seed": fid, "num_nodes":
                     int(rng.choice([20, 60, 110])), "m": 2, "num_mobile": 10,
                     "num_servers": 3, "num_relays": 5, "num_jobs": int(rng.integers(1, 9)),
                     "n_instance": i % 10, "method": ["baseline", "local", "GNN", "GNN_test"][
                         i % 4], "runtime": rng.uniform(1e-3, 1e-1),
                     "gap_2_bl": rng.normal(), "gnn_bl_ratio": rng.uniform(0.5, 2.0),
                     "tau": np.nan if i % 13 == 0 else rng.lognormal(3.0, 1.0),
                     "congest_jobs": int(rng.integers(0, 3))})
    pd.DataFrame(rows, columns=jd.TRAIN_COLUMNS).to_csv(path, index=False)
    return path


@pytest.fixture(scope="module")
def csvs(evaluator_csv, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("csvs")
    return {"evaluator": evaluator_csv,
            "reference": write_reference_csv(str(tmp / "Adhoc_test_data_ref.csv")),
            "training": write_training_csv(str(tmp / "aco_training_data_ref.csv"))}


def assert_table_equal(got: dict, want: pd.DataFrame):
    """A port table against a DataFrame (its index a column): the same
    columns and rows in order, integers and strings exact, floats within
    rtol 1e-12 (NaN where NaN)."""
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
        g = got[name]
        assert len(g) == len(w), name
        if w.dtype.kind == "f":
            assert g.dtype == np.float64, name
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True, err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            assert list(g) == list(w), name


@pytest.mark.parametrize("which", ["evaluator", "reference", "training"])
def test_tables_match_pandas(csvs, which):
    path = csvs[which]
    df = pd.read_csv(path)
    table = ta.read_csv(path)
    assert list(table) == list(df.columns)
    for name in df.columns:  # pandas' dtypes and its float parser's bits
        want = df[name].to_numpy()
        assert table[name].dtype == want.dtype, name
        if want.dtype.kind == "f":
            assert table[name].tobytes() == want.tobytes(), name
    assert_table_equal(ta.summarize_test(table), ja.summarize_test(df))
    assert_table_equal(ta.overall_table(table), ja.overall_table(df).reset_index())
    if which == "reference":
        assert np.isnan(df["gnn_bl_ratio"]).any() and (df["num_jobs"] == 0).any()
    text = ta.format_table(ta.overall_table(table))
    assert text.splitlines()[0].split() == list(ja.overall_table(df).reset_index().columns)


def test_parse_float_is_pandas(tmp_path):
    rng = np.random.default_rng(0)
    cells = []
    for _ in range(5000):
        x = rng.lognormal(0, 8) * (-1 if rng.uniform() < 0.3 else 1)
        cells.append([repr(x), f"{x:.20e}", f"{x:.25f}", f"{x:.3g}", f"{x:.8E}",
                      "0.000" + str(rng.integers(1, 10 ** 18)),
                      str(rng.integers(1, 10 ** 18)) + "123.5e-7"][rng.integers(0, 7)])
    path = tmp_path / "x.csv"
    path.write_text("x\n" + "\n".join(cells) + "\n")
    want = pd.read_csv(path)["x"].to_numpy()
    got = np.asarray([ta.parse_float(c) for c in cells])
    assert got.tobytes() == want.tobytes()
    assert sum(float(c) != w for c, w in zip(cells, want)) > 0  # not Python's parse
    for bad in ("", "1.5x", "e5", "--1", "abc"):
        with pytest.raises(ValueError):
            ta.parse_float(bad)


def test_rolling_mean_is_pandas():
    rng = np.random.default_rng(4)
    x = rng.lognormal(2.0, 1.5, 400)
    x[rng.uniform(size=400) < 0.1] = np.nan
    x[100:140] = 3.0  # a run of equal values
    x[200:230] = -x[200:230]
    for window in (1, 5, 50, 500):
        want = pd.Series(x).rolling(window, min_periods=1).mean().to_numpy()
        np.testing.assert_array_equal(ta.rolling_mean(x, window), want)


# ---- figures -------------------------------------------------------------------


def plotted(monkeypatch, fn, *args, **kw) -> list:
    """(label, x, y) of every `Axes.plot` call `fn` makes."""
    import matplotlib.axes

    calls = []
    inner = matplotlib.axes.Axes.plot

    def plot(self, x, y, *a, **k):
        calls.append((k.get("label"), np.asarray(x), np.asarray(y, dtype=np.float64)))
        return inner(self, x, y, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(matplotlib.axes.Axes, "plot", plot)
        fn(*args, **kw)
    return calls


@pytest.mark.parametrize("window", [50, 7])
def test_training_monitor_plots_jax_series(csvs, tmp_path, monkeypatch, window):
    pytest.importorskip("matplotlib")
    path = csvs["training"]
    want = plotted(monkeypatch, ja.plot_training_monitor, path, str(tmp_path / "j"), window)
    got = plotted(monkeypatch, ta.plot_training_monitor, path, str(tmp_path / "t"), window)
    assert [c[0] for c in got] == [c[0] for c in want] == ["GNN", "GNN_test", "baseline",
                                                          "local"]
    for (_, gx, gy), (_, wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("which", ["evaluator", "reference"])
def test_test_figures_plot_jax_series(csvs, tmp_path, monkeypatch, which):
    pytest.importorskip("matplotlib")
    path = csvs[which]
    want = plotted(monkeypatch, ja.plot_test_figures, path, str(tmp_path / "j"))
    got = plotted(monkeypatch, ta.plot_test_figures, path, str(tmp_path / "t"))
    assert len(got) == len(want) > 0
    for (gl, gx, gy), (wl, wx, wy) in zip(got, want):
        assert gl == wl
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_allclose(gy, wy, rtol=1e-12, atol=0, equal_nan=True)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


def test_layout_positions_match_jax_and_share_the_cache(tmp_path, monkeypatch):
    pytest.importorskip("networkx")
    rec = load_case_mat(CASE)
    jrec = j_load_case_mat(CASE)
    want = jvis.layout_positions(jrec.topo)
    np.testing.assert_allclose(tvis.layout_positions(rec.topo), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tvis.layout_positions(rec.topo, pos="new"), want, rtol=0,
                               atol=1e-12)
    given = np.arange(2.0 * rec.topo.n).reshape(-1, 2)
    np.testing.assert_array_equal(tvis.layout_positions(rec.topo, pos=given), given)
    with pytest.raises(ValueError):
        tvis.layout_positions(rec.topo, pos="old")
    # each package's cache file, read by the other with its own layout off
    jdir, tdir = str(tmp_path / "jax_pos"), str(tmp_path / "port_pos")
    jcached = jvis.layout_positions(jrec.topo, case_name="c", cache_dir=jdir, seed=3)
    tcached = tvis.layout_positions(rec.topo, case_name="c", cache_dir=tdir, seed=5)
    assert os.listdir(jdir) == os.listdir(tdir) == ["graph_c_pos_c.npy"]

    def off(*a, **k):
        raise AssertionError("the cache was not read")

    import networkx

    monkeypatch.setattr(generators, "_spring_layout", off)
    monkeypatch.setattr(networkx, "spring_layout", off)
    np.testing.assert_array_equal(tvis.layout_positions(rec.topo, case_name="c",
                                                        cache_dir=jdir), jcached)
    np.testing.assert_array_equal(jvis.layout_positions(jrec.topo, case_name="c",
                                                        cache_dir=tdir), tcached)


@pytest.mark.parametrize("weighted", [False, True])
def test_draw_network_styles_as_jax(tmp_path, monkeypatch, weighted):
    networkx = pytest.importorskip("networkx")
    pytest.importorskip("matplotlib")
    rec = load_case_mat(CASE)
    rng = np.random.default_rng(2)
    weights = nodes = None
    if weighted:
        weights = rng.uniform(0, 30, rec.topo.num_links)
        weights[::4] = 0.0
        nodes = rng.uniform(0, 200, rec.topo.n)
    srcs, dsts = list(rec.mobile_nodes), list(np.flatnonzero(rec.roles == 1))
    pos = tvis.layout_positions(rec.topo)
    seen = {}

    def j_draw(g, **kw):
        seen["jax"] = dict(kw, edges=list(g.edges()))

    def t_draw(pos, edges, **kw):
        seen["port"] = dict(kw, edges=[tuple(e) for e in edges.tolist()])

    with monkeypatch.context() as m:
        m.setattr(networkx, "draw", j_draw)
        m.setattr(tvis, "_draw", t_draw)
        jvis.draw_network(j_load_case_mat(CASE).topo, pos, srcs, dsts, weights, nodes)
        tvis.draw_network(rec.topo, pos, srcs, dsts, weights, nodes)
    j, t = seen["jax"], seen["port"]
    assert t["edges"] == j["edges"] and len(t["edges"]) == rec.topo.num_links
    for key in ("node_color", "node_size", "width", "edge_color", "with_labels"):
        assert t[key] == j[key], key
    if weighted:  # the reference's widths: every weighted edge is green
        assert set(t["edge_color"]) == {"g"}
    # and drawn for real
    out = tvis.plot_routes(rec.topo, pos, dsts, srcs, weights if weighted else
                           np.zeros(rec.topo.num_links), np.zeros(rec.topo.n),
                           str(tmp_path / "r.png"))
    assert os.path.getsize(out) > 0


# ---- the route demo ---------------------------------------------------------------


def test_route_sums_match_jax_route_demo(tmp_path, monkeypatch):
    pytest.importorskip("networkx")
    seen = {}

    def capture(topo, pos, servers, job_srcs, link_sums, node_sums, out_path,
                with_labels=True):
        seen.update(pos=pos, servers=servers, srcs=job_srcs, link=link_sums,
                    node=node_sums, path=out_path)
        return out_path

    b_inst, b_jobs = jinst.build_instance, jinst.build_jobset
    monkeypatch.setattr(jvis, "plot_routes", capture)
    monkeypatch.setattr(jinst, "build_instance",
                        lambda *a, **k: b_inst(*a, **{**k, "dtype": np.float64}))
    monkeypatch.setattr(jinst, "build_jobset",
                        lambda *a, **k: b_jobs(*a, **{**k, "dtype": np.float64}))
    jplot.route_demo(CASE, str(tmp_path / "j"))
    rec = load_case_mat(CASE)
    got = tplot.route_sums(rec, device="cpu", dtype=torch.float64)
    assert got["link_sums"].shape == (rec.topo.num_links,) and (got["link_sums"] > 0).any()
    assert got["node_sums"].shape == (rec.topo.n,) and (got["node_sums"] > 0).any()
    np.testing.assert_allclose(got["link_sums"], seen["link"], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got["node_sums"], seen["node"], rtol=1e-12, atol=0)
    # the per-link uses are the incidence's row sums; the demo's own run
    # (float32, the figure drawn) gives the JAX file name and positions
    np.testing.assert_array_equal(got["incidence"].sum(1) > 0, got["link_sums"] > 0)
    path = tplot.route_demo(CASE, str(tmp_path / "t"), device="cpu")
    assert os.path.basename(path) == os.path.basename(seen["path"])
    assert os.path.getsize(path) > 0
    np.testing.assert_allclose(tvis.layout_positions(rec.topo), seen["pos"], atol=1e-12)


def test_link_incidence_matches_jax():
    rng = np.random.default_rng(0)
    inc = (rng.uniform(size=(3, 40, 9)) < 0.3).astype(np.float64)
    got = link_incidence(types.SimpleNamespace(inc_ext=torch.from_numpy(inc)), 31)
    assert got.shape == (3, 31, 9)
    for b in range(3):
        want = j_link_incidence(types.SimpleNamespace(inc_ext=jnp.asarray(inc[b])), 31)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_cli_plot_writes_jax_file_names(csvs, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    pytest.importorskip("networkx")
    args = [csvs["reference"], csvs["training"], csvs["evaluator"], "--route-demo", CASE]
    jplot.main(args + ["--out", str(tmp_path / "j"), "--pos-cache", str(tmp_path / "jp")])
    capsys.readouterr()
    tplot.main(args + ["--out", str(tmp_path / "t"), "--pos-cache", str(tmp_path / "tp"),
                       "--device", "cpu"])
    out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert len(names) == 1 + 1 + 2 * 3  # route, monitor, two CSVs' Fig. 2(a-c)
    assert os.listdir(tmp_path / "tp") == os.listdir(tmp_path / "jp")
    assert out.count("wrote ") == len(names) and "congest_ratio" in out
    with pytest.raises(SystemExit):
        tplot.main([])
