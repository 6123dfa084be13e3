"""Host-side random-topology generators, without networkx.

Port of `multihop_offload_tpu/graphs/generators.py`: every graph family the
dataset generator and the scenario matrix build, `generate` with its
errors, and `spring_positions`.  The port imports no networkx, so each
family that networkx 3.6.1 draws is drawn here with the standard library
alone, draw for draw as networkx draws it from an integer seed
(`py_random_state`: one `random.Random(seed)` shared by every call of the
draw):

- `barabasi_albert` (`barabasi_albert_graph`): the star on m + 1 nodes,
  hub 0; `repeated_nodes` lists every node once per incident edge; each
  new node draws m distinct targets with `rng.choice` into a `set`, whose
  own iteration order extends `repeated_nodes` (`_random_subset`);
- `erdos_renyi` (`fast_gnp_random_graph`): the geometric skip
  ``w += 1 + int(log(1 - rng.random()) / log(1 - p))``; p >= 1 is the
  complete graph (`gnp_random_graph`), which draws nothing;
- `watts_strogatz` (`connected_watts_strogatz_graph`, ``tries=100`` on one
  shared generator): the ring lattice, then per neighbour distance and node
  one `rng.random()` and, on a rewire, `rng.choice(nodes)` until the target
  is new;
- `gaussian_random_partition` (`gaussian_random_partition_graph` ->
  `random_partition_graph` -> `stochastic_block_model(sparse=True)`): block
  sizes from `rng.gauss`, then per block pair in
  `combinations_with_replacement` order the edges of Python sets of node
  ids: a draw per pair inside a block (plus the one wasted draw the
  sparse branch makes after it), the skip sampling between blocks.

The random families that can disconnect retry at growing density with the
seed ``seed + 7919 * attempt`` (`_retry_connected`), and warn with
`DisconnectedGraphWarning`, as in JAX.  Only the edge set reaches the
adjacency, so it equals the JAX function's bit for bit.  `poisson_disk`,
the lattices and `two_tier` draw with numpy, as JAX does.
`spring_positions` is `nx.spring_layout(g, seed=seed)`: the dense
Fruchterman-Reingold iteration below 500 nodes, the energy form with
scipy's L-BFGS-B from 500 up.
"""

from __future__ import annotations

import itertools
import math
import os
import random
import warnings
from typing import Optional, Tuple

import numpy as np
from scipy.sparse import csgraph, csr_array
from scipy.spatial import distance_matrix


class DisconnectedGraphWarning(UserWarning):
    """A generator's nominal draw was disconnected and the bounded
    densify-and-retry fallback engaged (the returned graph IS connected,
    but denser than the family's nominal parameterization)."""


# bounded retry-to-connected: densify by _RETRY_GROWTH per attempt, give up
# (raise) after _MAX_CONNECT_TRIES total draws
_MAX_CONNECT_TRIES = 8
_RETRY_GROWTH = 1.5


def _is_connected(adj: np.ndarray) -> bool:
    """True when the undirected graph of `adj` is connected (networkx's
    `is_connected`, which refuses the null graph)."""
    if adj.shape[0] == 0:
        raise ValueError("Connectivity is undefined for the null graph.")
    n_comp, _ = csgraph.connected_components(csr_array(adj), directed=False)
    return n_comp == 1


def _retry_connected(draw, family: str, n: int):
    """Run `draw(attempt)` until the graph connects (bounded).

    `draw` maps an attempt index (0 = nominal parameters) to ``(adj, pos)``;
    the densification schedule lives in the caller's closure."""
    for attempt in range(_MAX_CONNECT_TRIES):
        adj, pos = draw(attempt)
        if _is_connected(adj):
            return adj, pos
        if attempt == 0:
            warnings.warn(
                f"{family}(n={n}) drew a disconnected graph; densifying "
                f"and retrying (bounded, x{_RETRY_GROWTH} per attempt)",
                DisconnectedGraphWarning,
                stacklevel=3,
            )
    raise ValueError(
        f"{family}(n={n}) stayed disconnected after "
        f"{_MAX_CONNECT_TRIES} densifying retries"
    )


def _edges_to_adj(edges, n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=np.uint8)
    for u, v in edges:
        adj[u, v] = 1
        adj[v, u] = 1
    return adj


def _complete(n: int) -> np.ndarray:
    adj = np.ones((n, n), dtype=np.uint8)
    np.fill_diagonal(adj, 0)
    return adj


def barabasi_albert(n: int, m: int = 2, seed: int = 0) -> Tuple[np.ndarray, None]:
    """BA preferential attachment: ``(adj, None)`` with ``adj`` an (n, n)
    uint8 symmetric 0/1 matrix with zero diagonal."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabási–Albert network must have m >= 1 and m < n, "
                         f"m = {m}, n = {n}")
    rng = random.Random(seed)  # nondet-ok(seeded stdlib RNG: per-seed draws)
    adj = np.zeros((n, n), dtype=np.uint8)
    adj[0, 1:m + 1] = 1
    adj[1:m + 1, 0] = 1
    repeated_nodes = [0] * m + list(range(1, m + 1))
    for source in range(m + 1, n):
        targets: set = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated_nodes))
        for t in targets:
            adj[source, t] = 1
            adj[t, source] = 1
        repeated_nodes.extend(targets)
        repeated_nodes.extend([source] * m)
    return adj, None


def _stochastic_block_edges(sizes, p_in: float, p_out: float, rng: random.Random):
    """`stochastic_block_model(sizes, p, sparse=True)` with p_in on the
    diagonal and p_out off it: the edge list, drawn from `rng`."""
    nb = len(sizes)
    p = [[p_out] * nb for _ in range(nb)]
    for r in range(nb):
        p[r][r] = p_in
    for row in p:
        for prob in row:
            if prob < 0 or prob > 1:
                raise ValueError("Entries of 'p' not in [0,1].")
    nodelist = range(sum(sizes))
    cum = [sum(sizes[0:x]) for x in range(nb + 1)]
    parts = [set(nodelist[cum[x]:cum[x + 1]]) for x in range(nb)]
    out = []
    for i, j in itertools.combinations_with_replacement(range(nb), 2):
        if i == j:
            edges = itertools.combinations(parts[i], 2)
            for e in edges:
                if rng.random() < p[i][j]:
                    out.append(e)
        else:
            edges = itertools.product(parts[i], parts[j])
        if p[i][j] == 1:
            out.extend(edges)
        elif p[i][j] > 0:
            # the skip sampling; after a block's dense pass it draws once
            # and stops, as networkx's sparse branch does
            while True:
                try:
                    logrand = math.log(rng.random())
                    skip = math.floor(logrand / math.log(1 - p[i][j]))
                    next(itertools.islice(edges, skip, skip), None)
                    out.append(next(edges))
                except StopIteration:
                    break
    return out


def gaussian_random_partition(
    n: int, p_in: float = 0.4, p_out: float = 0.2, seed: int = 0
) -> Tuple[np.ndarray, None]:
    """GRP(n, 15, 3, p_in, p_out) (reference `offloading_v3.py:41-42`),
    densified-and-retried to connectivity (bounded)."""
    s, v = 15, 3

    def draw(attempt):
        grow = _RETRY_GROWTH ** attempt
        rng = random.Random(seed + 7919 * attempt)  # nondet-ok(seeded stdlib RNG: per-seed draws)
        if s > n:
            raise ValueError("s must be <= n")
        assigned = 0
        sizes = []
        while True:
            size = int(rng.gauss(s, s / v + 0.5))
            if size < 1:
                continue
            if assigned + size >= n:
                sizes.append(n - assigned)
                break
            assigned += size
            sizes.append(size)
        edges = _stochastic_block_edges(sizes, min(p_in * grow, 1.0),
                                        min(p_out * grow, 1.0), rng)
        return _edges_to_adj(edges, n), None

    return _retry_connected(draw, "gaussian_random_partition", n)


def _watts_strogatz_draw(n: int, k: int, p: float, rng: random.Random) -> np.ndarray:
    """One `watts_strogatz_graph(n, k, p, rng)`."""
    if k > n:
        raise ValueError("k>n, choose smaller k or larger n")
    if k == n:
        return _complete(n)
    nbrs = [set() for _ in range(n)]
    nodes = list(range(n))
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            nbrs[u].add(v)
            nbrs[v].add(u)
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            if rng.random() < p:
                w = rng.choice(nodes)
                while w == u or w in nbrs[u]:
                    w = rng.choice(nodes)
                    if len(nbrs[u]) >= n - 1:
                        break  # skip this rewiring
                else:
                    if v not in nbrs[u]:
                        raise ValueError(f"The edge {u}-{v} is not in the graph")
                    nbrs[u].discard(v)
                    nbrs[v].discard(u)
                    nbrs[u].add(w)
                    nbrs[w].add(u)
    return _edges_to_adj(((u, v) for u in nodes for v in nbrs[u]), n)


def watts_strogatz(n: int, k: int = 6, p: float = 0.2, seed: int = 0) -> Tuple[np.ndarray, None]:
    """Connected WS(k=6, p=0.2) (reference `offloading_v3.py:43-44`): up to
    100 draws on one generator until one connects."""
    rng = random.Random(seed)  # nondet-ok(seeded stdlib RNG: per-seed draws)
    for _ in range(100):
        adj = _watts_strogatz_draw(n, k, p, rng)
        if _is_connected(adj):
            return adj, None
    raise ValueError("Maximum number of tries exceeded")


def _gnp_edges(n: int, p: float, rng: random.Random) -> list:
    """`fast_gnp_random_graph(n, p, rng)`'s edges (undirected)."""
    if p >= 1:
        return [(u, v) for u in range(n) for v in range(u + 1, n)]
    if p <= 0:
        return []
    edges = []
    lp = math.log(1.0 - p)
    v, w = 1, -1
    while v < n:
        lr = math.log(1.0 - rng.random())
        w = w + 1 + int(lr / lp)
        while w >= v and v < n:
            w = w - v
            v = v + 1
        if v < n:
            edges.append((v, w))
    return edges


def erdos_renyi(
    n: int, degree: float = 15.0, seed: int = 0
) -> Tuple[np.ndarray, None]:
    """ER with expected degree `degree` (reference `offloading_v3.py:45-46`),
    densified-and-retried to connectivity (bounded)."""

    def draw(attempt):
        p = min(degree * (_RETRY_GROWTH ** attempt) / float(n), 1.0)
        rng = random.Random(seed + 7919 * attempt)  # nondet-ok(seeded stdlib RNG: per-seed draws)
        return _edges_to_adj(_gnp_edges(n, p, rng), n), None

    return _retry_connected(draw, "erdos_renyi", n)


def unit_disk_adjacency(pos: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """(n, n) uint8 adjacency of the unit-disk graph over 2-D points: an
    edge where two points lie within `radius`, no self-loops (the
    reference's mobility and Poisson-generator rule)."""
    adj = (distance_matrix(pos, pos) <= radius).astype(np.uint8)
    np.fill_diagonal(adj, 0)
    return adj


def poisson_disk(
    n: int, nb: float = 4.0, radius: float = 1.0, seed: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """2-D Poisson point process with expected `nb` neighbors in unit
    radius: points uniform on a square sized so the point density is
    nb/pi per unit area (`data_generation_offloading.py:34-50`)."""
    rng = np.random.default_rng(seed)
    density = float(nb) / np.pi
    side = np.sqrt(float(n) / density)
    pos = rng.uniform(0, side, (int(n), 2))
    return unit_disk_adjacency(pos, radius), pos


def connected_poisson_disk(
    n: int, seed: Optional[int] = None, nb_start: float = 4.0
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Increase density until the Poisson graph is connected
    (`data_generation_offloading.py:61-67`)."""
    nb = nb_start - 1
    while True:
        nb += 1
        adj, pos = poisson_disk(n, nb=nb, seed=seed)
        if _is_connected(adj):
            return adj, pos, nb


def _lattice(n: int, rows: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Row-major induced lattice over the first `n` cells of a rows x cols
    grid with unit spacing (connected by construction), positions with a
    small seeded jitter; the adjacency does not depend on the jitter."""
    rows = max(int(rows), 1)
    cols = -(-n // rows)
    adj = np.zeros((n, n), dtype=np.uint8)
    for i in range(n):
        c = i % cols
        if c + 1 < cols and i + 1 < n:          # east neighbor
            adj[i, i + 1] = adj[i + 1, i] = 1
        if i + cols < n:                        # south neighbor
            adj[i, i + cols] = adj[i + cols, i] = 1
    rng = np.random.default_rng(seed)
    grid_pos = np.stack(
        [np.arange(n) % cols, np.arange(n) // cols], axis=1
    ).astype(np.float64)
    pos = grid_pos + rng.uniform(-0.1, 0.1, (n, 2))
    return adj, pos


def grid_lattice(
    n: int, aspect: float = 1.0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Near-square planned lattice; `aspect` = rows/cols ratio of the
    bounding grid."""
    if aspect <= 0:
        raise ValueError("aspect must be positive")
    rows = max(int(round(np.sqrt(n * aspect))), 1)
    return _lattice(n, rows, seed=seed)


def corridor(n: int, width: int = 2, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Long thin lattice: `width` parallel lanes, length n/width."""
    if width < 1:
        raise ValueError("width must be >= 1")
    return _lattice(n, min(int(width), n), seed=seed)


def two_tier(
    n: int, clusters: int = 3, core: int = 2, p_in: float = 0.5,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Clustered two-tier edge/cloud topology: `core` cloud nodes in a
    clique; the rest round-robin into `clusters` clusters, each a star on
    its head node plus random chords with probability `p_in`; every head
    uplinks to cloud nodes ``c % core`` and ``(c + 1) % core``."""
    if not 1 <= core < n:
        raise ValueError("need 1 <= core < n")
    clusters = max(1, min(int(clusters), n - core))
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), dtype=np.uint8)
    for a in range(core):           # cloud clique
        for b in range(a + 1, core):
            adj[a, b] = adj[b, a] = 1
    members = [[] for _ in range(clusters)]
    for i in range(core, n):        # round-robin edge membership
        members[(i - core) % clusters].append(i)
    for c, nodes in enumerate(members):
        if not nodes:
            continue
        head = nodes[0]
        for v in nodes[1:]:         # star onto the head: connectivity
            adj[head, v] = adj[v, head] = 1
        for ai in range(1, len(nodes)):     # random intra-cluster chords
            for bi in range(ai + 1, len(nodes)):
                if rng.random() < p_in:
                    a, b = nodes[ai], nodes[bi]
                    adj[a, b] = adj[b, a] = 1
        for g in {c % core, (c + 1) % core}:  # head -> cloud gateways
            adj[head, g] = adj[g, head] = 1
    # geometry: cloud at the origin, clusters on a surrounding circle
    pos = np.zeros((n, 2), dtype=np.float64)
    pos[:core] = rng.uniform(-0.5, 0.5, (core, 2))
    for c, nodes in enumerate(members):
        theta = 2.0 * np.pi * c / clusters
        center = 3.0 * np.array([np.cos(theta), np.sin(theta)])
        pos[nodes] = center + rng.uniform(-0.8, 0.8, (len(nodes), 2))
    return adj, pos


# family registry: callable + the family-specific kwargs it accepts
_FAMILIES = {
    "ba": (barabasi_albert, ("m",)),
    "grp": (gaussian_random_partition, ("p_in", "p_out")),
    "ws": (watts_strogatz, ("k", "p")),
    "er": (erdos_renyi, ("degree",)),
    "poisson": (poisson_disk, ("nb", "radius")),
    "grid": (grid_lattice, ("aspect",)),
    "corridor": (corridor, ("width",)),
    "two_tier": (two_tier, ("clusters", "core", "p_in")),
}

# name -> callable(n, seed, **family_kwargs)
GENERATORS = {
    name: (lambda n, seed, _f=fn, **kw: _f(n, seed=seed, **kw))
    for name, (fn, _) in _FAMILIES.items()
}


def generate(gtype: str, n: int, seed: int, m: Optional[int] = None, **kwargs):
    """Dispatch on graph-family name (reference `offloading_v3.py:39-59`).

    `m` is the legacy density shorthand: BA attachment degree / Poisson
    expected-neighbor count.  Passing it (or any kwarg) to a family that
    does not take it raises."""
    gtype = gtype.lower()
    if gtype not in _FAMILIES:
        raise ValueError(
            f"unsupported graph model '{gtype}' "
            f"(known: {', '.join(sorted(_FAMILIES))})"
        )
    fn, allowed = _FAMILIES[gtype]
    if m is not None:
        legacy = {"ba": "m", "poisson": "nb"}.get(gtype)
        if legacy is None:
            raise ValueError(
                f"graph family '{gtype}' does not take the density "
                f"parameter m; its parameters are {allowed or '()'}"
            )
        kwargs.setdefault(legacy, m)
    unknown = sorted(set(kwargs) - set(allowed))
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {unknown} for graph family '{gtype}'; "
            f"it takes {allowed or '()'}"
        )
    return fn(n, seed=seed, **kwargs)


def _force_layout(a: np.ndarray, pos: np.ndarray, iterations: int = 50,
                  threshold: float = 1e-4) -> np.ndarray:
    """networkx's dense `_fruchterman_reingold` on adjacency `a` from
    initial positions `pos` (updated in place and returned)."""
    nnodes = a.shape[0]
    k = np.sqrt(1.0 / nnodes)
    t = max(max(pos.T[0]) - min(pos.T[0]), max(pos.T[1]) - min(pos.T[1])) * 0.1
    dt = t / (iterations + 1)
    for _ in range(iterations):
        delta = pos[:, np.newaxis, :] - pos[np.newaxis, :, :]
        distance = np.linalg.norm(delta, axis=-1)
        np.clip(distance, 0.01, None, out=distance)
        displacement = np.einsum(
            "ijk,ij->ik", delta, (k * k / distance**2 - a * distance / k)
        )
        length = np.linalg.norm(displacement, axis=-1)
        length = np.clip(length, a_min=0.01, a_max=None)
        delta_pos = np.einsum("ij,i->ij", displacement, t / length)
        pos += delta_pos
        t -= dt
        if (np.linalg.norm(delta_pos) / nnodes) < threshold:
            break
    return pos


def _energy_layout(adj: np.ndarray, pos: np.ndarray, iterations: int = 50,
                   threshold: float = 1e-4, gravity: float = 1.0) -> np.ndarray:
    """networkx's `_energy_fruchterman_reingold` (the float32 sparse
    adjacency, L-BFGS-B on the Fruchterman-Reingold energy plus gravity
    toward (0.5, 0.5) per connected component) from `pos`."""
    from scipy.optimize import minimize

    nnodes, dim = pos.shape
    k = np.sqrt(1.0 / nnodes)
    a = csr_array(np.asarray(adj, dtype=np.float32))
    a = np.abs(a)
    a = (a + a.T) / 2
    n_components, labels = csgraph.connected_components(a, directed=False)
    bincount = np.bincount(labels)
    batchsize = 500

    def cost_fr(x):
        p = x.reshape((nnodes, dim))
        grad = np.zeros((nnodes, dim))
        cost = 0.0
        for lo in range(0, nnodes, batchsize):
            hi = min(lo + batchsize, nnodes)
            delta = p[lo:hi, np.newaxis, :] - p[np.newaxis, :, :]
            distance2 = np.sum(delta * delta, axis=2)
            distance2 = np.maximum(distance2, 1e-10)
            distance = np.sqrt(distance2)
            ad = a[lo:hi] * distance
            grad[lo:hi] = 2 * np.einsum("ij,ijk->ik", ad / k - k**2 / distance2, delta)
            cost += np.sum(ad * distance2) / (3 * k)
            cost -= k**2 * np.sum(np.log(distance))
        centers = np.zeros((n_components, dim))
        np.add.at(centers, labels, p)
        delta0 = centers / bincount[:, np.newaxis] - 0.5
        grad += gravity * delta0[labels]
        cost += gravity * 0.5 * np.sum(bincount * np.linalg.norm(delta0, axis=1) ** 2)
        return cost, grad.ravel()

    options = {"maxiter": iterations, "gtol": threshold}
    return minimize(cost_fr, pos.ravel(), method="L-BFGS-B", jac=True,
                    options=options).x.reshape((nnodes, dim))


def _spring_layout(adj: np.ndarray, seed: Optional[int]) -> np.ndarray:
    """`nx.spring_layout(nx.from_numpy_array(adj), seed=seed)` as an
    (n, 2) array in node order."""
    n = adj.shape[0]
    if n == 1:
        return np.zeros((1, 2))
    rs = np.random.mtrand._rand if seed is None else np.random.RandomState(seed)
    if n < 500:
        a = np.asarray(adj, dtype=np.float64)
        pos = _force_layout(a, np.asarray(rs.rand(n, 2), dtype=a.dtype))
    else:
        pos = _energy_layout(adj, np.asarray(rs.rand(n, 2), dtype=np.float32))
    # rescale_layout: centre each axis, scale the largest |coordinate| to 1
    pos -= pos.mean(axis=0)
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= 1 / lim
    return pos + np.zeros(2)


def spring_positions(
    adj: np.ndarray,
    seed: Optional[int] = None,
    cache_dir: Optional[str] = None,
    name: Optional[str] = None,
    fresh: bool = False,
) -> np.ndarray:
    """Spring layout for plotting and the dataset's `pos` (reference
    `offloading_v3.py:156,163`).

    With `cache_dir` + `name`, layouts are cached on disk as
    ``<cache_dir>/<name>.npy``; `fresh=True` recomputes and overwrites."""
    path = None
    if cache_dir and name:
        path = os.path.join(cache_dir, f"{name}.npy")
        if not fresh and os.path.isfile(path):
            cached = np.load(path)
            if cached.shape == (adj.shape[0], 2):
                return cached
    out = _spring_layout(np.asarray(adj), seed)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(path, out)
    return out
