"""Dataset generator: the paper workflow's first step, without networkx.

Port of `multihop_offload_tpu/cli/datagen.py`: BA (or any `generate`
family) or Poisson topologies over sizes 20..110, topology-aware roles
(relays on the minimum node cut, servers on the larger non-relay side of
the Stoer-Wagner minimum edge cut with sorted Pareto(2) x 100
capacities, Pareto(2) x 8 mobile compute), written in the reference `.mat`
schema by `graphs.matio.save_case_mat`.  The cuts are `graphs/cuts.py`'s,
which return networkx's cut and partition lists, so every draw of
`np.random.default_rng(seed)` lands where the JAX generator's does and the
files hold the same adjacency, link rates and roles; `pos` is the spring
layout (`graphs.generators.spring_positions`), a float iteration.

    python -m multihop_offload_tpu_torch.cli.datagen --datapath=data/aco_data_ba_100 \\
        --gtype=ba --size=100 --seed=500

The committed paper dataset is ``--gtype ba --size 2 --seed 500``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from multihop_offload_tpu_torch.graphs import generators
from multihop_offload_tpu_torch.graphs.cuts import minimum_node_cut, stoer_wagner
from multihop_offload_tpu_torch.graphs.matio import save_case_mat

GRAPH_SIZES = [20, 30, 40, 50, 60, 70, 80, 90, 100, 110]


def assign_roles(adj: np.ndarray, num_servers: int, rng: np.random.Generator) -> np.ndarray:
    """(N, 2) nodes_info = [role, proc_bw] of the graph of `adj`
    (`data_generation_offloading.py:88-133`): role 2 on the minimum node
    cut, 1 on `num_servers` nodes of the larger side of the minimum edge
    cut (spilling to the other side), 0 elsewhere."""
    n = adj.shape[0]
    relay_set = set(minimum_node_cut(adj))
    _, partition = stoer_wagner(adj)
    nodes_info = np.zeros((n, 2), dtype=np.int64)
    for idx in relay_set:
        nodes_info[idx] = [2, 0]

    sides = [
        list(rng.permutation(list(set(partition[0]) - relay_set)).astype(int)),
        list(rng.permutation(list(set(partition[1]) - relay_set)).astype(int)),
    ]
    server_side = 1 if len(sides[0]) >= len(sides[1]) else 0

    def place_servers(nodes, count):
        bws = np.flip(np.sort((rng.pareto(2.0, count) + 1) * 100))
        for i in range(count):
            nodes_info[nodes[i]] = [1, int(bws[i])]

    far = sides[server_side]
    near = sides[1 - server_side]
    if num_servers >= len(far):
        place_servers(far, len(far))
        spill = num_servers - len(far)
        if spill:
            bws = (rng.pareto(2.0, spill) + 1) * 100
            for i in range(spill):
                nodes_info[near[i]] = [1, int(bws[i])]
        mobile = near[spill:]
    else:
        place_servers(far, num_servers)
        # far-side non-servers stay mobile, as do all near-side nodes
        mobile = near + far[num_servers:]
    m_bws = (rng.pareto(2.0, len(mobile)) + 1) * 8
    for i, idx in enumerate(mobile):
        nodes_info[idx] = [0, int(m_bws[i])]
    return nodes_info


def generate_dataset(
    datapath: str, gtype: str = "ba", size: int = 100, seed0: int = 500,
    m: int = 2, graph_sizes=None, verbose: bool = True,
):
    """Write `size` seeds x `graph_sizes` cases into `datapath`; returns
    the paths in the order written."""
    os.makedirs(datapath, exist_ok=True)
    written = []
    for sid in range(size):
        seed = seed0 + sid
        rng = np.random.default_rng(seed)
        for num_nodes in graph_sizes or GRAPH_SIZES:
            if gtype == "poisson":
                adj, pos, m_eff = generators.connected_poisson_disk(num_nodes, seed=seed)
            else:
                # `m` is the BA attachment degree; other families have their
                # own parameters and `generate` raises if handed a stray `m`
                adj, _ = generators.generate(
                    gtype, num_nodes, seed=seed,
                    **({"m": m} if gtype == "ba" else {}),
                )
                pos = generators.spring_positions(adj, seed=seed)
                m_eff = m
            num_links = int(np.count_nonzero(np.triu(adj)))
            num_servers = round(int(rng.integers(10, 25)) / 100 * num_nodes)
            link_rates = rng.uniform(30, 70, num_links)
            nodes_info = assign_roles(adj, num_servers, rng)
            fname = f"aco_case_seed{seed}_m{m_eff}_n{num_nodes}_s{num_servers}.mat"
            path = os.path.join(datapath, fname)
            save_case_mat(path, adj, link_rates, nodes_info, pos,
                          seed=seed, m=int(m_eff), gtype=gtype)
            written.append(path)
            if verbose:
                print("wrote", path)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datapath", default="data/aco_data_ba_100", type=str)
    p.add_argument("--gtype", default="ba", type=str)
    p.add_argument("--size", default=100, type=int)
    p.add_argument("--seed", default=500, type=int)
    p.add_argument("--m", default=2, type=int)
    args = p.parse_args(argv)
    return generate_dataset(args.datapath, args.gtype.lower(), args.size, args.seed, args.m)


if __name__ == "__main__":
    main()
