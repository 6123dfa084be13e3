"""Figure regeneration CLI, the analysis-notebook equivalent (port of
`multihop_offload_tpu/cli/plot.py`):

    python -m multihop_offload_tpu_torch.cli.plot out/Adhoc_test_data_*.csv --out fig/
    python -m multihop_offload_tpu_torch.cli.plot --route-demo data/case.mat --out fig/ \\
        [--device cpu]

The route demo is the `plot_routes` smoke path (`offloading_v3.py:552-586`):
one baseline-policy episode on a single case, on CUDA unless `--device cpu`
is given (K2's squarings, then K1's fixed point in the empirical run),
per-link realized delay sums as edge widths, per-node compute sums as node
sizes, spring-layout positions resolved (and cached) via
`utils.visualization.layout_positions`.  A result CSV whose name starts
with ``aco_training_data`` draws the training monitor, any other the
Fig. 2 panels and prints the whole-set table.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def route_sums(rec, device=None, dtype=torch.float32) -> dict:
    """One `baseline_policy` episode on the case `rec` (a `CaseRecord`), on
    `device` (default CUDA), drawn as the JAX route demo draws it: link
    rates and job rates from `default_rng(0)`, load 0.15, T 1000, pads
    rounded to 8.  Returns the per-link sums (L,) (route uses over the
    converged service rate), the per-node compute sums (N,), and the
    episode's `dst` (J,) and real-link incidence (L, J), as numpy."""
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.env.policies import baseline_policy
    from multihop_offload_tpu_torch.env.routing import link_incidence
    from multihop_offload_tpu_torch.graphs.instance import (
        PadSpec, build_instance, build_jobset, stack_instances,
    )
    from multihop_offload_tpu_torch.graphs.topology import sample_link_rates

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rates = sample_link_rates(rec.topo, rec.link_rates, rng=rng)
    pad = PadSpec.for_cases([rec.sizes], round_to=8)
    inst = build_instance(rec.topo, rec.roles, rec.proc_bws, rates, 1000.0, pad,
                          dtype=dtype, device=dev)
    mobile = rec.mobile_nodes
    jobs = build_jobset(mobile, 0.15 * rng.uniform(0.1, 0.5, mobile.size),
                        pad_jobs=pad.j, dtype=dtype, device=dev)
    inst, jobs = stack_instances([inst]), stack_instances([jobs])
    out = baseline_policy(inst, jobs)

    n, l = rec.topo.n, rec.topo.num_links
    inc = link_incidence(out.routes, inst.num_pad_links)[0].cpu().numpy()
    uses = inc.sum(1)[:l]
    mu = out.delays.link_mu[0].cpu().numpy()[:l]
    mask = jobs.mask[0].cpu().numpy()
    dst = out.decision.dst[0].cpu().numpy()
    node_sums = np.zeros(n)
    np.add.at(node_sums, dst[mask], out.delays.job_server[0].cpu().numpy()[mask])
    return {"link_sums": uses / np.maximum(mu, 1e-9), "node_sums": node_sums,
            "dst": dst[mask], "incidence": inc[:l, mask]}


def route_demo(case_path: str, out_dir: str, pos_cache: str | None = None,
               device=None) -> str:
    """The route figure of one `.mat` case (`route_sums` on `device`,
    default CUDA), written as ``<out_dir>/routes_<case>.png``; returns its
    path."""
    from multihop_offload_tpu_torch.graphs.matio import load_case_mat
    from multihop_offload_tpu_torch.utils.visualization import (
        layout_positions, plot_routes,
    )

    rec = load_case_mat(case_path)
    sums = route_sums(rec, device)
    case = os.path.splitext(os.path.basename(case_path))[0]
    pos = layout_positions(rec.topo, case_name=case, cache_dir=pos_cache)
    return plot_routes(
        rec.topo, pos, np.flatnonzero(rec.roles == 1),
        rec.mobile_nodes, sums["link_sums"], sums["node_sums"],
        os.path.join(out_dir, f"routes_{case}.png"),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("csvs", nargs="*", help="result CSVs (test or training)")
    p.add_argument("--out", default="fig", type=str)
    p.add_argument("--route-demo", default=None, metavar="CASE_MAT",
                   help="render a one-episode route figure for a .mat case")
    p.add_argument("--pos-cache", default=None, metavar="DIR",
                   help="position cache dir (reference ../pos/ equivalent)")
    p.add_argument("--device", default=None,
                   help="the route demo's device: cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.csvs and not args.route_demo:
        p.error("provide result CSVs and/or --route-demo CASE_MAT")
    if args.route_demo:
        print("wrote", route_demo(args.route_demo, args.out, args.pos_cache, args.device))
        if not args.csvs:
            return
    from multihop_offload_tpu_torch.train.analysis import (
        format_table,
        overall_table,
        plot_test_figures,
        plot_training_monitor,
        read_csv,
    )

    for pattern in args.csvs:
        for path in sorted(glob.glob(pattern)):
            name = os.path.basename(path)
            if name.startswith("aco_training_data"):
                out = plot_training_monitor(path, args.out)
                print("wrote", out)
            else:
                for out in plot_test_figures(path, args.out):
                    print("wrote", out)
                print(format_table(overall_table(read_csv(path))))


if __name__ == "__main__":
    main()
