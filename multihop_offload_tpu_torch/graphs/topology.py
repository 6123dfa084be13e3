"""Topology: the host-side structural precompute.

Everything the reference derives with NetworkX object graphs —
line graph / conflict graph (`offloading_v3.py:65-77`), link index maps
(`link_mapping`, `:226-241`), physical-distance conflict augmentation
(`add_conflict_relations`, `:193-224`) — is computed here once per network,
vectorized in NumPy, and frozen into plain arrays.  Downstream tensor code
never touches a graph object.

A copy of `multihop_offload_tpu/graphs/topology.py` (NumPy/SciPy only), kept
in the port so that it never imports the JAX package.

Canonical orderings (a deliberate departure from the reference, which orders
links by NetworkX line-graph node insertion order): links are the edges
``(u, v), u < v`` sorted lexicographically.  Link ordering is unobservable in
the model — loads, delays, and decisions attach to physical links — so the
canonical order only permutes i.i.d. random link rates, which is
distribution-preserving.  See PARITY.md.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.spatial import distance_matrix


@dataclasses.dataclass
class Topology:
    """Structural arrays for one connectivity graph (unpadded, host-side)."""

    n: int                      # number of nodes
    adj: np.ndarray             # (n, n) uint8 symmetric adjacency, zero diag
    link_ends: np.ndarray       # (L, 2) int32, u < v, lexicographic order
    link_index: np.ndarray      # (n, n) int32: edge -> link id, -1 elsewhere
    adj_lg: np.ndarray          # (L, L) uint8 line-graph adjacency
    adj_conflict: np.ndarray    # (L, L) uint8 conflict adjacency (>= adj_lg)
    cf_degs: np.ndarray         # (L,) int32 conflict degree per link
    pos: Optional[np.ndarray]   # (n, 2) float positions or None
    cf_radius: float = 0.0

    @property
    def num_links(self) -> int:
        return int(self.link_ends.shape[0])

    @property
    def mean_conflict_degree(self) -> float:
        # reference `offloading_v3.py:77`
        return float(self.cf_degs.mean()) if self.num_links else 0.0

    @property
    def connected(self) -> bool:
        """BFS connectivity check (reference uses `nx.is_connected`, `:60`)."""
        if self.n == 0:
            return False
        seen = np.zeros(self.n, dtype=bool)
        frontier = np.zeros(self.n, dtype=bool)
        frontier[0] = True
        while frontier.any():
            seen |= frontier
            frontier = (self.adj[frontier].any(axis=0)) & ~seen
        return bool(seen.all())


def _line_graph_adjacency(link_ends: np.ndarray, n: int) -> np.ndarray:
    """Links are adjacent iff they share an endpoint (nx.line_graph semantics,
    reference `offloading_v3.py:65`).  Vectorized via the node-link incidence
    matrix: A_lg = B @ B.T with shared-endpoint count, minus self-loops."""
    num_links = link_ends.shape[0]
    # float32 so the product runs through BLAS; entries are 0/1/2, exact
    inc = np.zeros((num_links, n), dtype=np.float32)
    rows = np.arange(num_links)
    inc[rows, link_ends[:, 0]] = 1
    inc[rows, link_ends[:, 1]] = 1
    shared = inc @ inc.T
    np.fill_diagonal(shared, 0)
    return (shared > 0).astype(np.uint8)


def _conflict_extra(
    link_ends: np.ndarray,
    adj_lg: np.ndarray,
    pos: np.ndarray,
    cf_radius: float,
) -> np.ndarray:
    """Physical-interference conflicts: two links conflict when any endpoint of
    one is within `cf_radius x median link distance` of an endpoint of the
    other.  Behavioral equivalent of `add_conflict_relations`
    (`offloading_v3.py:193-224`), vectorized."""
    d = distance_matrix(pos, pos)
    link_dist = d[link_ends[:, 0], link_ends[:, 1]]
    finite = link_dist[np.isfinite(link_dist)]
    if finite.size == 0:
        # linkless (or NaN-positioned) graph after a mobility step: no
        # distance scale exists, so no physical conflicts beyond adj_lg —
        # np.nanmedian would warn and poison `thresh` with NaN here
        return adj_lg.copy()
    thresh = cf_radius * np.median(finite)
    # near[l, v]: link l has an endpoint within thresh of node v
    near = (d[link_ends[:, 0], :] < thresh) | (d[link_ends[:, 1], :] < thresh)
    # links k whose some endpoint is a node near link l
    touches = near[:, link_ends[:, 0]] | near[:, link_ends[:, 1]]  # (L, L)
    conflict = (touches | touches.T).astype(np.uint8)
    np.fill_diagonal(conflict, 0)
    return np.maximum(conflict, adj_lg)


def build_topology(
    adj: np.ndarray,
    pos: Optional[np.ndarray] = None,
    cf_radius: float = 0.0,
) -> Topology:
    """Derive all structural arrays from a dense adjacency matrix."""
    adj = np.asarray(adj)
    n = adj.shape[0]
    iu, ju = np.nonzero(np.triu(adj, k=1))
    order = np.lexsort((ju, iu))
    link_ends = np.stack([iu[order], ju[order]], axis=1).astype(np.int32)
    num_links = link_ends.shape[0]

    link_index = -np.ones((n, n), dtype=np.int32)
    link_index[link_ends[:, 0], link_ends[:, 1]] = np.arange(num_links)
    link_index[link_ends[:, 1], link_ends[:, 0]] = np.arange(num_links)

    adj_lg = _line_graph_adjacency(link_ends, n)
    if cf_radius > 0.5:
        # reference gate `offloading_v3.py:72-75`
        if pos is None:
            raise ValueError("cf_radius interference needs node positions")
        adj_conflict = _conflict_extra(link_ends, adj_lg, np.asarray(pos), cf_radius)
    else:
        adj_conflict = adj_lg
    cf_degs = adj_conflict.sum(axis=0).astype(np.int32)

    return Topology(
        n=n,
        adj=adj.astype(np.uint8),
        link_ends=link_ends,
        link_index=link_index,
        adj_lg=adj_lg,
        adj_conflict=adj_conflict,
        cf_degs=cf_degs,
        pos=None if pos is None else np.asarray(pos, dtype=np.float64),
        cf_radius=float(cf_radius),
    )


def sample_link_rates(
    topo: Topology,
    rates,
    std: float = 2.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Per-link capacities: round(clip(N(rate, std), 0, rate + 3*std)).

    Mirrors `links_init` (`offloading_v3.py:252-260`).  `rates` is a scalar or
    an (L,)-vector in canonical link order.
    """
    rng = rng or np.random.default_rng()  # nondet-ok(explicit caller opt-in: no rng passed)
    rates = np.asarray(rates, dtype=np.float64)
    if rates.ndim == 1:
        assert rates.shape[0] == topo.num_links
    noisy = rng.normal(rates, std, size=(topo.num_links,))
    return np.round(np.clip(noisy, 0.0, rates + 3.0 * std))
