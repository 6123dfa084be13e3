"""PyTorch port, the APSP route of `apsp_impl` against the JAX package on
the CPU, at a padded N of 384: BA(300, m=2) networks of graph seeds 0-2
(pad N = 304, which the blocked Floyd-Warshall pads to 384).

* `Config().apsp_impl` is JAX's default `'xla'`, and `shortest_paths` on
  it, dense and from the link list, equals JAX's `env/apsp.py:
  apsp_minplus` (its default route) bit for bit, in float32 and float64;
* the `'pallas'` route equals `apsp_minplus_pallas(interpret=True)` bit
  for bit there, and the two routes differ by ulps;
* `resolve_apsp` and `resolve_coo_apsp` compute what JAX's resolve to
  for each `apsp_impl` either side of a padded 256;
* under the default Config the Evaluator's CSV rows equal the JAX
  Evaluator's on a dataset of 300-node BA networks, and the simulator's
  routes (`decide_routes`) equal JAX's;
* `Config(apsp_impl='bogus')` raises JAX's error.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_offload_tpu.cli.datagen import generate_dataset
from multihop_offload_tpu.env import apsp as japsp
from multihop_offload_tpu.env.baseline import baseline_unit_delays as j_unit_delays
from multihop_offload_tpu.graphs import generators as jgen
from multihop_offload_tpu.graphs import instance as jinst
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu.layouts import sparse as jsparse
from multihop_offload_tpu.ops import minplus as jmp
from multihop_offload_tpu.sim import fidelity as jfid
from multihop_offload_tpu.sim import policies as jpol
from multihop_offload_tpu.train import driver as jd
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env import apsp as tapsp
from multihop_offload_tpu_torch.env.baseline import baseline_unit_delays
from multihop_offload_tpu_torch.env.policies import shortest_paths
from multihop_offload_tpu_torch.graphs import generators as tgen
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.ops import minplus as tmp
from multihop_offload_tpu_torch.sim import fidelity as tfid
from multihop_offload_tpu_torch.sim import policies as tpol
from tests.test_torch_drivers import assert_rows_equal, common, jax_config, port_evaluator
from tests.test_torch_drivers import read_rows

SEEDS = (0, 1, 2)
DTYPES = {"float32": (torch.float32, np.float32), "float64": (torch.float64, np.float64)}


@functools.lru_cache(maxsize=None)
def _case(seed: int, dtype: str):
    """(port inst, port jobs, JAX inst, JAX jobs) of `make_case` on
    BA(300, m=2) of graph seed `seed`, in `dtype`, unbatched on the JAX
    side and a batch of one on the port's."""
    jt = jtopo.build_topology(jgen.barabasi_albert(300, seed=seed)[0])
    tt = ttopo.build_topology(tgen.barabasi_albert(300, seed=seed)[0])
    pad = (304, -(-jt.num_links // 8) * 8, 8, 8)
    tdt, ndt = DTYPES[dtype]
    ji, jj = jfid.make_case(seed, jt, jinst.PadSpec(*pad), 8, dtype=ndt)
    ti, tj = tfid.make_case(seed, tt, tinst.PadSpec(*pad), 8, dtype=tdt, device="cpu")
    return tinst.stack_instances([ti]), tinst.stack_instances([tj]), ji, jj


def _bits(x) -> np.ndarray:
    return np.asarray(x)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_default_route_squares_as_jax_at_padded_384(seed, dtype):
    ti, _, ji, _ = _case(seed, dtype)
    assert (ti.num_pad_nodes, tmp.padded_n(ti.num_pad_nodes)) == (304, 384)
    cfg = Config()
    assert cfg.apsp_impl == "xla" == jax_config().apsp_impl
    link_d, _ = baseline_unit_delays(ti)
    want = japsp.apsp_minplus(japsp.weight_matrix_from_link_delays(
        ji.adj, ji.link_index, j_unit_delays(ji)[0]))
    np.testing.assert_array_equal(link_d[0].numpy(), np.asarray(j_unit_delays(ji)[0]))
    for layout in ("dense", "sparse"):
        got = shortest_paths(ti, link_d, layout, apsp_impl=cfg.apsp_impl)
        assert got.dtype == DTYPES[dtype][0]
        np.testing.assert_array_equal(got[0].numpy(), _bits(want), err_msg=layout)
    assert torch.equal(tapsp.apsp_minplus(tapsp.weight_matrix_from_link_delays(
        ti.adj, ti.link_index, link_d)), got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_pallas_route_equals_jax_kernel_at_padded_384(seed, dtype):
    ti, _, ji, _ = _case(seed, dtype)
    link_d, _ = baseline_unit_delays(ti)
    w = tapsp.weight_matrix_from_link_delays(ti.adj, ti.link_index, link_d)
    want = jmp.apsp_minplus_pallas(jnp.asarray(w[0].numpy()), interpret=True)
    for layout in ("dense", "sparse"):
        got = shortest_paths(ti, link_d, layout, apsp_impl="pallas")
        np.testing.assert_array_equal(got[0].numpy(), _bits(want), err_msg=layout)
    squared = shortest_paths(ti, link_d, apsp_impl="xla")
    assert not torch.equal(squared, got)
    finite = torch.isfinite(got)
    torch.testing.assert_close(squared[finite], got[finite], rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [100, 300])
@pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
def test_resolve_apsp_computes_what_jax_resolves_to(impl, n):
    """Both packages' resolutions of `apsp_impl` at N give the same
    distances on the same matrix (JAX's None is its XLA squaring), dense
    and from the link list; the port's path names what runs."""
    rng = np.random.default_rng(n)
    adj, _ = tgen.barabasi_albert(n, seed=n)
    ends = np.stack(np.nonzero(np.triu(adj, 1)), 1).astype(np.int32)
    delays = rng.uniform(0.1, 5.0, len(ends))
    w = np.full((n, n), np.inf)
    w[ends[:, 0], ends[:, 1]] = w[ends[:, 1], ends[:, 0]] = delays
    jfn, jpath = jmp.resolve_apsp(impl, n, interpret=True)
    want = np.asarray((jfn or japsp.apsp_minplus)(jnp.asarray(w)))
    fn, path = tmp.resolve_apsp(impl, n)
    assert path == {"xla": "squaring", "squaring": "squaring",
                    "blocked-fw": "blocked-fw"}[jpath]
    np.testing.assert_array_equal(fn(torch.from_numpy(w)[None])[0].numpy(), want)
    jedges, _ = jmp.resolve_coo_apsp(impl, n, interpret=True)
    if jedges is None:
        jedges = lambda e, m, d, nn: japsp.apsp_minplus_blocked(  # noqa: E731
            jsparse.weight_matrix_from_edges(e, m, d, nn))
    want_coo = np.asarray(jedges(jnp.asarray(ends), jnp.ones(len(ends), bool),
                                 jnp.asarray(delays), n))
    edges_fn, coo_path = tmp.resolve_coo_apsp(impl, n)
    assert coo_path == path
    got = edges_fn(torch.from_numpy(ends)[None], torch.ones((1, len(ends)), dtype=torch.bool),
                   torch.from_numpy(delays)[None], n)
    np.testing.assert_array_equal(got[0].numpy(), want_coo)


@pytest.fixture(scope="module")
def ba300(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data") / "aco_data_ba_300")
    generate_dataset(d, gtype="ba", size=1, seed0=700, graph_sizes=[300], verbose=False)
    return d


def test_evaluator_rows_match_jax_under_the_default_config(ba300, tmp_path):
    kw = {**common(ba300, tmp_path), "num_instances": 2}
    jev = jd.Evaluator(jax_config(**kw))
    assert jev.apsp_path == "xla"
    want = read_rows(jev.run(verbose=False))
    ev = port_evaluator(Config(**{**kw, "out": str(tmp_path / "port")}),
                        jev.variables["params"])
    assert (ev.data.pad.n, tmp.padded_n(ev.data.pad.n), ev.apsp_path) == (304, 384, "squaring")
    got = read_rows(ev.run(verbose=False))
    assert len(got) == 2 * 3
    assert_rows_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_simulator_routes_match_jax_at_padded_384(seed):
    """`decide_routes` under the baseline's delays squares at every N in
    both packages: `dst`, the forwarding table and reachability equal."""
    ti, tj, ji, jj = _case(seed, "float64")
    jd_, jn = j_unit_delays(ji)
    want = jpol.decide_routes(ji, jj, jd_, jn, jnp.ones(ji.node_mask.shape, bool),
                              jnp.ones(ji.link_mask.shape, bool), jax.random.PRNGKey(0))
    td_, tn = baseline_unit_delays(ti)
    got = tpol.decide_routes(ti, tj, td_, tn, torch.ones_like(ti.node_mask),
                             torch.ones_like(ti.link_mask))
    np.testing.assert_array_equal(got.dst[0].numpy(), np.asarray(want.dst))
    np.testing.assert_array_equal(got.next_hop[0].numpy(), np.asarray(want.next_hop))
    np.testing.assert_array_equal(got.reach[0].numpy(), np.asarray(want.reach))


def test_bogus_apsp_impl_raises_as_jax():
    with pytest.raises(ValueError) as jerr:
        jmp.resolve_apsp("bogus", 300)
    with pytest.raises(ValueError) as err:
        Config(apsp_impl="bogus")
    assert str(err.value) == str(jerr.value)
    for fn in (tmp.resolve_apsp, tmp.resolve_coo_apsp):
        with pytest.raises(ValueError, match="xla|pallas|auto"):
            fn("bogus", 300)
