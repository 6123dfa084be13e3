"""PyTorch port, the `.mat` reader/writer and the drivers' data layer
against the JAX package on the CPU: `load_case_mat` field by field and
exactly, on the committed paper dataset and on a tiny dataset written by
the JAX `generate_dataset`; `reference_link_order` against networkx's
line-graph order; `save_case_mat` read back through the JAX loader; the
committed dataset against `cases.npz`'s ``paper`` group; and
`DatasetCache` pads and buckets, `instance(fid, rng)` and
`sample_jobsets`, equal under the same seeds (float64).
"""

import os

import networkx as nx
import numpy as np
import pytest
import torch

from multihop_offload_tpu.cli.datagen import generate_dataset
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.graphs import generators
from multihop_offload_tpu.graphs import matio as jmatio
from multihop_offload_tpu.train import data as jdata
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.graphs import matio as tmatio
from multihop_offload_tpu_torch.graphs.cases import load_cases
from multihop_offload_tpu_torch.train import data as tdata

PAPER = tmatio.PAPER_DATASET
TOPO_FIELDS = ("adj", "link_ends", "link_index", "adj_lg", "adj_conflict", "cf_degs", "pos")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data") / "aco_data_ba_tiny")
    generate_dataset(d, gtype="ba", size=2, seed0=500, graph_sizes=[20, 30], verbose=False)
    return d


def _datasets(tiny):
    return {"paper": PAPER, "tiny": tiny}


def _record_equal(t, j, filename=True):
    assert t.topo.n == j.topo.n and t.topo.cf_radius == j.topo.cf_radius
    for f in TOPO_FIELDS:
        a, b = getattr(t.topo, f), getattr(j.topo, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("roles", "proc_bws", "link_rates"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (t.seed, t.m, t.gtype) == (j.seed, j.m, j.gtype)
    assert t.sizes == j.sizes
    assert (t.num_servers, t.num_relays) == (j.num_servers, j.num_relays)
    if filename:
        assert t.filename == j.filename


@pytest.mark.parametrize("which", ["paper", "tiny"])
def test_load_case_mat_equals_jax(tiny, which):
    d = _datasets(tiny)[which]
    names = tmatio.list_dataset(d)
    assert names == jmatio.list_dataset(d)
    assert len(names) == (20 if which == "paper" else 4)
    for name in names:
        path = os.path.join(d, name)
        _record_equal(tmatio.load_case_mat(path), jmatio.load_case_mat(path))


def test_reference_link_order_equals_networkx(tiny):
    """The pure-Python line-graph order equals networkx's on every case of
    both datasets and on BA and ER graphs of many sizes and seeds."""
    import scipy.io as sio

    adjs = []
    for d in (PAPER, tiny):
        for name in tmatio.list_dataset(d):
            adjs.append((sio.loadmat(os.path.join(d, name))["adj"].toarray() != 0)
                        .astype(np.uint8))
    for seed in range(12):
        for gtype, n in (("ba", 5 + 9 * seed), ("er", 8 + 7 * seed)):
            adjs.append(generators.generate(gtype, n, seed=seed)[0])
    for adj in adjs:
        np.testing.assert_array_equal(tmatio.reference_link_order(adj),
                                      jmatio.reference_link_order(adj))
        want = list(nx.line_graph(nx.from_numpy_array(adj)).nodes)
        assert tmatio._line_graph_node_order(adj) == want


def test_committed_dataset_is_the_paper_group():
    """`data/aco_data_ba_paper/` holds the cases of `cases.npz`'s paper
    group, by file name and content."""
    group = load_cases("paper")
    names = tmatio.list_dataset(PAPER)
    assert names == [c.name for c in group]
    for name, case in zip(names, group):
        rec = tmatio.load_case_mat(os.path.join(PAPER, name))
        np.testing.assert_array_equal(rec.topo.adj, case.topo.adj)
        np.testing.assert_array_equal(rec.link_rates, case.link_rates)
        np.testing.assert_array_equal(rec.roles, case.roles)
        np.testing.assert_array_equal(rec.proc_bws, case.proc_bws)
        assert rec.seed == case.seed


def test_save_case_mat_reads_back_through_jax(tiny, tmp_path):
    for name in tmatio.list_dataset(tiny):
        src = os.path.join(tiny, name)
        rec = tmatio.load_case_mat(src)
        info = np.stack([rec.roles, rec.proc_bws.astype(np.int64)], 1)
        out = str(tmp_path / name)
        tmatio.save_case_mat(out, rec.topo.adj, rec.link_rates, info, rec.topo.pos,
                             seed=rec.seed, m=rec.m, gtype=rec.gtype)
        _record_equal(jmatio.load_case_mat(out), jmatio.load_case_mat(src))
        _record_equal(tmatio.load_case_mat(out), rec)


def _configs(datapath, **kw):
    common = dict(datapath=datapath, dtype="float64", seed=3, T=1000, arrival_scale=0.15,
                  **kw)
    return JConfig(**common), Config(**common)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("buckets", [1, 2, 3])
def test_dataset_cache_pads_and_buckets(layout, buckets):
    jcfg, tcfg = _configs(PAPER, layout=layout, pad_buckets=buckets)
    jc, tc = jdata.DatasetCache.load(jcfg), tdata.DatasetCache.load(tcfg)
    assert len(tc) == len(jc) == 20
    assert tc.bucket_of == jc.bucket_of
    key = lambda p: (p.n, p.l, p.s, p.j, p.enn, p.cnn)
    assert [key(p) for p in tc.pads] == [key(p) for p in jc.pads]
    assert key(tc.pad) == key(jc.pad)
    assert all(key(tc.pad_of(i)) == key(jc.pad_of(i)) for i in range(len(tc)))
    if layout == "sparse":
        assert all(p.enn % 128 == 0 and p.cnn % 128 == 0 and p.enn > 0 for p in tc.pads)


def _instance_equal(t, j):
    for f in t.__dataclass_fields__:
        if f == "sparse":
            continue
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if t.sparse is not None:
        for part in ("ext", "cf"):
            tc, jc = getattr(t.sparse, part), getattr(j.sparse, part)
            for f in ("rows", "cols", "vals"):
                np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                              np.asarray(getattr(jc, f)))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_instances_and_jobsets_equal_jax(tiny, layout):
    """Two visits of every file, interleaved with job-set draws, from one
    generator per package: the same instances, job sets and counts, and
    the generators left in the same state."""
    jcfg, tcfg = _configs(tiny, layout=layout, pad_buckets=2)
    jc, tc = jdata.DatasetCache.load(jcfg), tdata.DatasetCache.load(tcfg)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    idt = np.int16 if layout == "sparse" else np.int32
    for fid in list(range(len(tc))) * 2:
        _instance_equal(tc.instance(fid, trng), jc.instance(fid, jrng))
        tj, tcounts = tdata.sample_jobsets(tc.records[fid], tc.pad_of(fid), 5, trng, 0.15,
                                           dtype=torch.float64, index_dtype=idt)
        jj, jcounts = jdata.sample_jobsets(jc.records[fid], jc.pad_of(fid), 5, jrng, 0.15,
                                           dtype=np.float64, index_dtype=idt)
        np.testing.assert_array_equal(tcounts, jcounts)
        for f in ("src", "rate", "ul", "dl", "mask"):
            a, b = getattr(tj, f).numpy(), np.asarray(getattr(jj, f))
            assert a.dtype == b.dtype and a.shape == (5, tc.pad_of(fid).j), f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert trng.integers(1 << 30) == jrng.integers(1 << 30)
