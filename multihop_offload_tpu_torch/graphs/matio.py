"""Reader/writer for the reference's `.mat` case schema.

Port of `multihop_offload_tpu/graphs/matio.py` with scipy and no networkx.
Schema (written by the reference's `data_generation_offloading.py:136-144`):
  network    (1,1) struct {num_nodes, seed, m, gtype}
  adj        sparse float (N, N)
  link_rate  (1, L) float
  nodes_info (N, 2) int   [role, proc_bw]
  pos_c      (N, 2) float

The `link_rate` vector is ordered by the NetworkX line-graph node order of
`nx.from_numpy_array(adj)` (the reference's `link_list`).  Links are kept
in canonical sorted order (`graphs/topology.py`), so the loader permutes the
rates onto canonical link ids with `reference_link_order`, which rebuilds
that line-graph order without networkx.

`data/aco_data_ba_paper/` holds the paper dataset in this schema: the 20
cases of the JAX `cli/datagen.generate_dataset(d, "ba", size=2,
seed0=500)` (BA m=2, n = 20..110), written by
`scripts/export_torch_port_data.py --mat`; the port's own
`cli/datagen.generate_dataset` writes the same files again (`pos` within
1e-12, the rest bit for bit).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import scipy.io as sio
import scipy.sparse as sp

from multihop_offload_tpu_torch.graphs.topology import Topology, build_topology

PAPER_DATASET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                             "aco_data_ba_paper")


@dataclasses.dataclass
class CaseRecord:
    """One dataset case: topology + roles/resources, before padding."""

    topo: Topology
    roles: np.ndarray        # (n,) int
    proc_bws: np.ndarray     # (n,) float
    link_rates: np.ndarray   # (L,) float, canonical link order
    seed: int
    m: int
    gtype: str
    filename: str = ""

    @property
    def num_servers(self) -> int:
        return int((self.roles == 1).sum())

    @property
    def num_relays(self) -> int:
        return int((self.roles == 2).sum())

    @property
    def mobile_nodes(self) -> np.ndarray:
        return np.flatnonzero(self.roles == 0)

    @property
    def sizes(self):
        """(n, l, s, j_max) for PadSpec computation; j_max = mobile count."""
        return (self.topo.n, self.topo.num_links, self.num_servers,
                self.mobile_nodes.size)


def _line_graph_node_order(adj: np.ndarray) -> list:
    """The node order of `nx.line_graph(nx.from_numpy_array(adj))`, built
    as networkx's `_lg_undirected` builds it: walk the nodes u in order
    with their neighbours in ascending column order (the insertion order
    `from_numpy_array` gives); a node of degree 1 adds its one edge as a
    line-graph node; every pair of u's edges, each a sorted tuple, goes
    into one Python `set`, and the set's iteration order then adds the
    remaining nodes.  That iteration order follows CPython's hashing of
    tuples of ints, which is deterministic (no hash randomization for
    ints), so the same updates in the same order give the same order on
    any 64-bit CPython 3.12."""
    n = adj.shape[0]
    order: dict = {}
    pairs: set = set()
    for u in range(n):
        edges = [(u, v) if u < v else (v, u)
                 for v in np.flatnonzero(adj[u]).tolist() if v != u]
        if len(edges) == 1:
            order.setdefault(edges[0], None)
        for i, a in enumerate(edges):
            pairs.update([tuple(sorted((a, b))) for b in edges[i + 1:]])
    for a, b in pairs:
        order.setdefault(a, None)
        order.setdefault(b, None)
    return list(order)


def reference_link_order(adj: np.ndarray) -> np.ndarray:
    """Map reference link positions -> canonical link ids.

    Returns `perm` with `perm[k]` = canonical id of the k-th link in the
    reference's `link_list` (NetworkX line-graph node order).
    """
    adj = np.asarray(adj)
    iu, ju = np.nonzero(np.triu(adj, k=1))
    order = np.lexsort((ju, iu))
    canon = {(int(iu[o]), int(ju[o])): k for k, o in enumerate(order)}
    link_list = _line_graph_node_order(adj)
    return np.asarray([canon[e] for e in link_list], dtype=np.int64)


def load_case_mat(path: str, cf_radius: float = 0.0) -> CaseRecord:
    """Load one `.mat` case (reference load path: `AdHoc_train.py:84-110`)."""
    m = sio.loadmat(path, spmatrix=False)
    adj = np.asarray(m["adj"].toarray() if sp.issparse(m["adj"]) else m["adj"])
    adj = (adj != 0).astype(np.uint8)
    pos = np.asarray(m["pos_c"], dtype=np.float64)
    nodes_info = np.asarray(m["nodes_info"])
    link_rate = np.asarray(m["link_rate"]).flatten().astype(np.float64)
    net = m["network"][0, 0]
    seed = int(np.asarray(net["seed"]).flatten()[0])
    m_attach = int(np.asarray(net["m"]).flatten()[0])
    gtype = (str(np.asarray(net["gtype"]).flatten()[0])
             if "gtype" in net.dtype.names else "ba")

    topo = build_topology(adj, pos=pos, cf_radius=cf_radius)
    if link_rate.shape[0] != topo.num_links:
        raise ValueError(
            f"{path}: link_rate has {link_rate.shape[0]} entries, "
            f"graph has {topo.num_links} links"
        )
    rates_canon = np.empty_like(link_rate)
    rates_canon[reference_link_order(adj)] = link_rate
    return CaseRecord(
        topo=topo,
        roles=nodes_info[:, 0].astype(np.int32),
        proc_bws=nodes_info[:, 1].astype(np.float64),
        link_rates=rates_canon,
        seed=seed,
        m=m_attach,
        gtype=gtype,
        filename=os.path.basename(path),
    )


def save_case_mat(path: str, adj: np.ndarray, link_rates_canon: np.ndarray,
                  nodes_info: np.ndarray, pos: np.ndarray, seed: int, m: int,
                  gtype: str) -> None:
    """Write a case in the reference schema (readable by both packages).

    `link_rates_canon` is in canonical order; it is permuted back to the
    reference's line-graph order on disk."""
    perm = reference_link_order(adj)
    link_rate_ref = np.asarray(link_rates_canon, dtype=np.float64)[perm]
    sio.savemat(path, {
        "network": {"num_nodes": int(adj.shape[0]), "seed": int(seed),
                    "m": int(m), "gtype": gtype},
        "adj": sp.csc_matrix(np.asarray(adj, dtype=np.float64)),
        "link_rate": link_rate_ref.reshape(1, -1),
        "nodes_info": np.asarray(nodes_info, dtype=np.int64),
        "pos_c": np.asarray(pos, dtype=np.float64),
    })


def list_dataset(datapath: str):
    """Sorted case filenames, as the drivers do (`AdHoc_train.py:39`)."""
    return sorted(f for f in os.listdir(datapath) if f.endswith(".mat"))
