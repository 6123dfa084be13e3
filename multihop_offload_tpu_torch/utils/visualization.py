"""Network/route visualization with matplotlib and no networkx (port of
`multihop_offload_tpu/utils/visualization.py`).

Equivalents of `util.vis_network`/`vis_edges` (`util.py:53-98`) and
`AdhocCloud.plot_routes` (`offloading_v3.py:552-586`): draw the connectivity
graph with mobile sources red, servers blue, edge widths growing with the
realized link delay, node sizes with the compute delay.  The colours, sizes,
widths and edge colours are the JAX package's, edge for edge in networkx's
order of `from_numpy_array` (u < v, lexicographic; the canonical link
order).  As there, a weighted edge's width is `w / 10 + 1`, so the green
test `width > 0.99` colours every weighted edge green.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from multihop_offload_tpu_torch.graphs.generators import spring_positions
from multihop_offload_tpu_torch.graphs.topology import Topology


def layout_positions(
    topo: Topology,
    pos=None,
    case_name: Optional[str] = None,
    cache_dir: Optional[str] = None,
    seed: int = 0,
) -> np.ndarray:
    """Resolve node positions for drawing, mirroring the reference's
    `node_positions` (`offloading_v3.py:152-165`): an explicit (N, 2) array is
    used as-is; `pos='new'` forces a fresh spring layout; `pos=None` computes
    a spring layout (`graphs.generators.spring_positions`), read/written
    through an on-disk cache ``graph_c_pos_<case>.npy`` when `cache_dir` and
    `case_name` are given (the JAX package's cache file, read by either).
    """
    if isinstance(pos, np.ndarray):
        return np.asarray(pos, dtype=np.float64)
    if pos is not None and pos != "new":
        raise ValueError("pos must be None, 'new', or an (N, 2) array")
    if pos is None and cache_dir is not None and case_name:
        return spring_positions(topo.adj, seed=seed, cache_dir=cache_dir,
                                name=f"graph_c_pos_{case_name}")
    return spring_positions(topo.adj, seed=seed)


def _draw(pos: np.ndarray, edges: np.ndarray, node_color, node_size, width,
          edge_color, with_labels: bool, ax):
    """`networkx.draw`'s picture with matplotlib: edges under nodes, node
    ids centred on them, no axes."""
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    ax = plt.gca() if ax is None else ax
    ax.add_collection(LineCollection(pos[edges], linewidths=width, colors=edge_color,
                                     zorder=1))
    ax.scatter(pos[:, 0], pos[:, 1], s=node_size, c=node_color, zorder=2)
    if with_labels:
        for i, (x, y) in enumerate(pos):
            ax.text(x, y, str(i), ha="center", va="center", fontsize=12, zorder=3)
    ax.autoscale_view()
    ax.set_axis_off()
    return ax


def draw_network(
    topo: Topology,
    pos: Optional[np.ndarray],
    src_nodes: Sequence[int],
    dst_nodes: Sequence[int],
    edge_weights: Optional[np.ndarray] = None,
    node_delays: Optional[np.ndarray] = None,
    with_labels: bool = True,
    ax=None,
):
    """The connectivity graph with the JAX package's style, handed to the
    drawing as `networkx.draw`'s arguments: `node_color`, `node_size`,
    `width`, `edge_color`, the edges in networkx's order."""
    if pos is None:
        pos = layout_positions(topo)
    n = topo.n
    colors = ["y"] * n
    sizes = np.full(n, 300.0)
    if node_delays is not None:
        sizes = (np.asarray(node_delays) / 5.0) ** 2 + 20.0
    for s in src_nodes:
        colors[s] = "r"
        sizes[s] = max(sizes[s], 200.0)
    for d in dst_nodes:
        colors[d] = "b"
        sizes[d] = 200.0
    if edge_weights is None:
        widths = 1.0
        edge_colors = "k"
    else:
        w = np.asarray(edge_weights)
        widths = list(w / 10.0 + 1.0)
        edge_colors = ["g" if x > 0.99 else "k" for x in widths]
    edges = np.argwhere(np.triu(np.asarray(topo.adj) != 0, 1))
    return _draw(np.asarray(pos, dtype=np.float64), edges, node_color=colors,
                 node_size=list(sizes), width=widths, edge_color=edge_colors,
                 with_labels=with_labels, ax=ax)


def plot_routes(
    topo: Topology,
    pos: Optional[np.ndarray],
    servers: Sequence[int],
    job_srcs: Sequence[int],
    link_delay_sums: np.ndarray,   # (L,) per-link total realized delay
    node_delay_sums: np.ndarray,   # (N,) per-node total compute delay
    out_path: str,
    with_labels: bool = True,
):
    """Route/load visualization (`plot_routes`, `offloading_v3.py:552-586`)."""
    import matplotlib.pyplot as plt

    weights = np.nan_to_num(np.asarray(link_delay_sums))
    delays = np.nan_to_num(np.asarray(node_delay_sums)) * 100.0
    draw_network(
        topo, pos, list(job_srcs), list(servers),
        edge_weights=weights, node_delays=delays, with_labels=with_labels,
    )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.subplots_adjust(left=0.01, right=0.99, top=0.99, bottom=0.01)
    plt.savefig(out_path, dpi=300, bbox_inches="tight")
    plt.close()
    return out_path
