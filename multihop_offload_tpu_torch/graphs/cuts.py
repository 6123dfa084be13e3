"""Minimum node cut and Stoer-Wagner minimum edge cut, without networkx.

The dataset generator places relays on a minimum node cut and servers on
one side of a minimum edge cut (`cli/datagen.py:assign_roles`).  JAX's
generator calls `nx.minimum_node_cut` and `nx.stoer_wagner` on
`nx.from_numpy_array(adj)`; when several cuts are minimal, which one comes
back depends on the order in which networkx visits nodes, neighbours and
augmenting paths, and the roles depend on that cut and on the order of
the partition lists.  So this module follows networkx 3.6.1 step by step
on plain dicts (insertion-ordered, as networkx's adjacency is) and Python
sets of node ids (iterated as networkx's sets are):

- `minimum_node_cut` (`algorithms/connectivity/cuts.py:310`): the
  auxiliary node-split digraph (`build_auxiliary_node_connectivity`, node
  i as 2i -> 2i+1), one residual network reused by every s-t cut
  (`build_residual_network`), the default Edmonds-Karp flow with its
  bidirectional BFS, and `minimum_cut`'s removal and re-insertion of the
  saturated residual edges, which moves them to the end of their
  adjacency dicts for the next s-t cut;
- `stoer_wagner` (`algorithms/connectivity/stoerwagner.py:17`): the
  phases on a copy of the graph with `utils.BinaryHeap`'s tie-breaking
  (insertion count), the contractions, and the final BFS partition.

Both return what networkx returns on the same graph: the same cut set, and
the same partition lists in the same order.
"""

from __future__ import annotations

import itertools
from heapq import heappop, heappush
from typing import Dict, List, Set, Tuple

import numpy as np

from multihop_offload_tpu_torch.graphs.generators import _is_connected


def _adjacency(adj: np.ndarray) -> Dict[int, Dict[int, dict]]:
    """`nx.from_numpy_array(adj)`'s adjacency: node i's neighbours in
    ascending order, each edge one shared attribute dict."""
    a = np.asarray(adj)
    g: Dict[int, Dict[int, dict]] = {i: {} for i in range(a.shape[0])}
    for u, v in zip(*np.nonzero(a)):
        u, v = int(u), int(v)
        if u <= v:
            d = {"weight": int(a[u, v])}
            g[u][v] = d
            g[v][u] = d
    return g


def _edges(g: Dict[int, Dict[int, dict]]):
    """Undirected edges in networkx's `Graph.edges` order."""
    seen = set()
    for n, nbrs in g.items():
        for nbr, d in nbrs.items():
            if nbr not in seen:
                yield n, nbr, d
        seen.add(n)


class _Residual:
    """The residual digraph of the auxiliary network: `succ` / `pred`
    dict-of-dicts sharing one attribute dict per arc, as `nx.DiGraph`."""

    def __init__(self, nodes, inf: int):
        self.succ: Dict[int, Dict[int, dict]] = {u: {} for u in nodes}
        self.pred: Dict[int, Dict[int, dict]] = {u: {} for u in nodes}
        self.inf = inf  # 3 x the summed capacities: bounds an augmenting path

    def add_edge(self, u: int, v: int, d: dict) -> None:
        self.succ[u][v] = d
        self.pred[v][u] = d


def _auxiliary(g: Dict[int, Dict[int, dict]]):
    """(H's arcs in `H.edges` order, H's nodes): node i split into
    2i -> 2i+1 (capacity 1), edge (s, t) as 2s+1 -> 2t and 2t+1 -> 2s."""
    nodes = []
    succ: Dict[int, List[int]] = {}
    for i in g:
        nodes += [2 * i, 2 * i + 1]
        succ[2 * i] = [2 * i + 1]
        succ[2 * i + 1] = []
    for s, t, _ in _edges(g):
        succ[2 * s + 1].append(2 * t)
        succ[2 * t + 1].append(2 * s)
    return [(u, v) for u in nodes for v in succ[u]], nodes


def _residual_network(arcs, nodes) -> _Residual:
    """`build_residual_network(H, "capacity")`, every capacity 1."""
    r = _Residual(nodes, 3 * sum(1 for u, v in arcs if u != v) or 1)
    for u, v in arcs:
        if u == v:
            continue
        if v not in r.succ[u]:
            r.add_edge(u, v, {"capacity": 1})
            r.add_edge(v, u, {"capacity": 0})
        else:
            r.succ[u][v]["capacity"] = 1
    return r


def _edmonds_karp(r: _Residual, s: int, t: int) -> int:
    """networkx's `edmonds_karp_core` with no cutoff: the flow value, the
    arcs' `flow` left in `r`."""
    for u in r.succ:
        for e in r.succ[u].values():
            e["flow"] = 0
    succ_, pred_ = r.succ, r.pred

    def bidirectional_bfs():
        pred = {s: None}
        q_s = [s]
        succ = {t: None}
        q_t = [t]
        while True:
            q = []
            if len(q_s) <= len(q_t):
                for u in q_s:
                    for v, attr in succ_[u].items():
                        if v not in pred and attr["flow"] < attr["capacity"]:
                            pred[v] = u
                            if v in succ:
                                return v, pred, succ
                            q.append(v)
                if not q:
                    return None, None, None
                q_s = q
            else:
                for u in q_t:
                    for v, attr in pred_[u].items():
                        if v not in succ and attr["flow"] < attr["capacity"]:
                            succ[v] = u
                            if v in pred:
                                return v, pred, succ
                            q.append(v)
                if not q:
                    return None, None, None
                q_t = q

    flow_value = 0
    while True:
        v, pred, succ = bidirectional_bfs()
        if pred is None:
            break
        path = [v]
        u = v
        while u != s:
            u = pred[u]
            path.append(u)
        path.reverse()
        u = v
        while u != t:
            u = succ[u]
            path.append(u)
        flow = r.inf
        for a, b in zip(path, path[1:]):
            attr = succ_[a][b]
            flow = min(flow, attr["capacity"] - attr["flow"])
        for a, b in zip(path, path[1:]):
            succ_[a][b]["flow"] += flow
            succ_[b][a]["flow"] -= flow
        flow_value += flow
    return flow_value


def _st_node_cut(g, h_succ, r: _Residual, s: int, t: int) -> Set[int]:
    """`minimum_st_node_cut(G, s, t, auxiliary=H, residual=R)`."""
    if t in g[s]:
        return set()
    hs, ht = 2 * s + 1, 2 * t
    _edmonds_karp(r, hs, ht)
    # minimum_cut: drop the saturated arcs, find what still reaches t, put
    # the arcs back (at the end of their adjacency dicts)
    cutset = [(u, v, d) for u in r.succ for v, d in r.succ[u].items()
              if d["flow"] == d["capacity"]]
    for u, v, _ in cutset:
        del r.succ[u][v]
        del r.pred[v][u]
    non_reachable = {ht}
    frontier = [ht]
    while frontier:
        nxt = []
        for v in frontier:
            for w in r.pred[v]:
                if w not in non_reachable:
                    non_reachable.add(w)
                    nxt.append(w)
        frontier = nxt
    for u, v, d in cutset:
        r.add_edge(u, v, d)
    node_cut = {x // 2 for u in h_succ if u not in non_reachable
                for v in h_succ[u] if v in non_reachable for x in (u, v)}
    return node_cut - {s, t}


def minimum_node_cut(adj: np.ndarray) -> Set[int]:
    """The global minimum node cut of the connected graph of `adj`, as
    `nx.minimum_node_cut(nx.from_numpy_array(adj))` finds it."""
    g = _adjacency(adj)
    if not _is_connected(np.asarray(adj)):
        raise ValueError("Input graph is not connected")
    arcs, nodes = _auxiliary(g)
    h_succ: Dict[int, List[int]] = {u: [] for u in nodes}
    for u, v in arcs:
        h_succ[u].append(v)
    r = _residual_network(arcs, nodes)
    v = min(g, key=lambda x: len(g[x]))
    min_cut = set(g[v])
    for w in set(g) - set(g[v]) - {v}:
        this_cut = _st_node_cut(g, h_succ, r, v, w)
        if len(min_cut) >= len(this_cut):
            min_cut = this_cut
    for x, y in itertools.combinations(g[v], 2):
        if y in g[x]:
            continue
        this_cut = _st_node_cut(g, h_succ, r, x, y)
        if len(min_cut) >= len(this_cut):
            min_cut = this_cut
    return min_cut


class _BinaryHeap:
    """networkx's `utils.BinaryHeap`: a min-heap keyed by value, ties by
    insertion count, stale entries skipped lazily."""

    def __init__(self):
        self._dict: dict = {}
        self._heap: list = []
        self._count = itertools.count()

    def min(self):
        while True:
            value, _, key = self._heap[0]
            if key in self._dict and value == self._dict[key]:
                return key, value
            heappop(self._heap)

    def pop(self):
        while True:
            value, _, key = self._heap[0]
            heappop(self._heap)
            if key in self._dict and value == self._dict[key]:
                break
        del self._dict[key]
        return key, value

    def get(self, key, default=None):
        return self._dict.get(key, default)

    def insert(self, key, value) -> None:
        if key in self._dict and not value < self._dict[key]:
            return
        self._dict[key] = value
        heappush(self._heap, (value, next(self._count), key))


def stoer_wagner(adj: np.ndarray) -> Tuple[int, Tuple[list, list]]:
    """``(cut_value, (side_a, side_b))`` of the graph of `adj`, as
    `nx.stoer_wagner(nx.from_numpy_array(adj))` returns them."""
    g0 = _adjacency(adj)
    n = len(g0)
    if n < 2:
        raise ValueError("graph has less than two nodes.")
    if not _is_connected(np.asarray(adj)):
        raise ValueError("graph is not connected.")
    # nx.Graph(edge list): nodes in order of first appearance
    g: Dict[int, Dict[int, dict]] = {}
    for u, v, e in _edges(g0):
        if u == v:
            continue
        g.setdefault(u, {})
        g.setdefault(v, {})
        d = {"weight": e.get("weight", 1)}
        g[u][v] = d
        g[v][u] = d
    cut_value = float("inf")
    nodes = set(g)
    contractions = []
    best_phase = 0
    for i in range(n - 1):
        u = next(iter(g))
        a = {u}
        h = _BinaryHeap()
        for v, e in g[u].items():
            h.insert(v, -e["weight"])
        for _ in range(n - i - 2):
            u = h.pop()[0]
            a.add(u)
            for v, e in g[u].items():
                if v not in a:
                    h.insert(v, h.get(v, 0) - e["weight"])
        v, w = h.min()
        w = -w
        if w < cut_value:
            cut_value = w
            best_phase = i
        contractions.append((u, v))
        for x, e in g[v].items():
            if x != u:
                if x not in g[u]:
                    d = {"weight": e["weight"]}
                    g[u][x] = d
                    g[x][u] = d
                else:
                    g[u][x]["weight"] += e["weight"]
        for x in list(g[v]):
            del g[x][v]
        del g[v]
    # the side of the last contracted node of the best phase: a BFS over
    # the contractions before it
    tree: Dict[int, Dict[int, None]] = {}
    for x, y in itertools.islice(contractions, best_phase):
        tree.setdefault(x, {})
        tree.setdefault(y, {})
        tree[x][y] = None
        tree[y][x] = None
    v = contractions[best_phase][1]
    tree.setdefault(v, {})
    order = {v: 0}
    frontier = [v]
    while frontier:
        nxt = []
        for x in frontier:
            for y in tree[x]:
                if y not in order:
                    order[y] = 0
                    nxt.append(y)
        frontier = nxt
    reachable = set(order)
    return cut_value, (list(reachable), list(nodes - reachable))
