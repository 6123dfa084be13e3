"""The large-graph path on one card: the port's counterpart of

    python scripts/large_scale_demo.py --n 1024 --gtype er --seed 42 --k 3 \\
        --apsp pallas --backward

It loads the committed 1,024-node Erdős–Rényi network and its job set
(`graphs.cases.load_large_case`: 7,694 links, 451 jobs; the demo's pads
N=1,024, L=7,696, E=8,720; dense layout), or, given `--n`, `--gtype`,
`--seed`, `--load` or `--T`, draws one as the demo's `build_case` and job
draw do (`build_case` here: `graphs.generators.generate`, then roles,
capacities, link rates and jobs from `np.random.default_rng(seed)`; at the
demo's defaults, `--n 1024 --gtype er --seed 42 --load 0.15 --T 1000`,
that is the committed case bit for bit), and at the demo's `--k 3` its
random initial parameters (`LARGE_K3_init` in `data/weights.npz`, JAX's
`PRNGKey(0)` draw; another `--k` gets the port's own glorot draw from
seed 0), then runs, as the demo does, `agent.policy.forward_env` and,
under `--backward`, `agent.train_step.forward_backward`; besides them it
runs `train.driver.eval_methods` (baseline, local, GNN) on the same
request.  Every call takes the APSP route of `--apsp` (the demo's
default, `'pallas'`: at this size the blocked FW, K3; `'xla'` the
squarings, K2); the fixed point takes the scan (L > 928, where K1's
shared memory ends); the report names the paths and counts each kernel's
launches per call.  `--sparse` swaps the dense (E, E) support (304 MB in
float32 at E = 8,720) for its COO list (`ops.sparse.dense_to_coo`) and
the ChebConv's propagate for `ops.sparse.coo_propagate` (a gather and a
segment-sum), on the dense layout otherwise, as the demo does.

    python -m multihop_offload_tpu_torch.large_scale [--device cpu] [--steps 3]
        [--backward] [--out FILE] [--n 1024] [--gtype er|ba|ws|poisson] [--seed 42]
        [--load 0.15] [--T 1000] [--k 3] [--apsp pallas|xla|auto] [--sparse]

It runs on CUDA unless `--device cpu` is given, and prints one JSON line
with the demo's keys, unrounded: `compile_s` is the first `forward_env`
call (on the card it builds the kernels), `step_s` the mean of `--steps`
more; unless `--apsp xla`, `apsp_pallas_ms` times the APSP of
the demo's unit-weight matrix on the path taken (K3 on the card) and
`apsp_xla_ms` the squarings on the same matrix (K2 on the card), as the
demo times its kernel path against the XLA squaring.  Added keys: the
fixed-point path, `sparse`, `eval_methods` time and per-method tau,
launches per call, peak device memory.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device, synchronize
from multihop_offload_tpu_torch.agent.actor import default_support
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.agent.train_step import forward_backward
from multihop_offload_tpu_torch.graphs import generators
from multihop_offload_tpu_torch.graphs.cases import (
    CaseRecord,
    LargeCase,
    large_request,
    load_large_case,
)
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.graphs.topology import build_topology, sample_link_rates
from multihop_offload_tpu_torch.models.chebconv import load_model, make_model
from multihop_offload_tpu_torch.ops import chebconv as cc
from multihop_offload_tpu_torch.ops import fixed_point as fp
from multihop_offload_tpu_torch.ops import minplus as mp
from multihop_offload_tpu_torch.ops.sparse import coo_propagate, dense_to_coo
from multihop_offload_tpu_torch.train.driver import eval_methods

MODEL = "LARGE_K3_init"
LARGE_APSP = "pallas"  # `scripts/large_scale_demo.py --apsp`'s default


def build_case(n: int = 1024, gtype: str = "er", seed: int = 42, load: float = 0.15,
               t_max: float = 1000.0) -> LargeCase:
    """One network and one job set, drawn as `scripts/large_scale_demo.py`
    draws them (`build_case`, `:32-60`, and the job draw, `:97-109`): the
    first connected graph of `generate(gtype, n, seed + attempt)` (Poisson:
    `connected_poisson_disk`), random roles (10% servers, 2% relays),
    Pareto capacities and realized link rates, then half the mobile nodes
    as sources at ``load * U(0.1, 0.5)``, all from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    if gtype == "poisson":
        adj, pos, _ = generators.connected_poisson_disk(n, seed=seed)
        topo = build_topology(adj, pos)
    else:
        for attempt in range(100):
            adj, pos = generators.generate(gtype, n, seed + attempt)
            topo = build_topology(adj, pos)
            if topo.connected:
                break
        else:
            raise RuntimeError("no connected topology found")
    roles = np.zeros(n, dtype=np.int32)
    num_servers = max(1, int(0.10 * n))
    num_relays = max(1, int(0.02 * n))
    perm = rng.permutation(n)
    roles[perm[:num_servers]] = 1
    roles[perm[num_servers:num_servers + num_relays]] = 2
    proc_bws = rng.pareto(2.0, n) * 8.0 + 1.0
    proc_bws[roles == 1] = rng.pareto(2.0, num_servers) * 100.0 + 10.0
    proc_bws[roles == 2] = 0.0
    link_rates = sample_link_rates(topo, rng.uniform(30.0, 70.0, topo.num_links), rng=rng)
    mobile = np.flatnonzero(roles == 0)
    nj = int(0.5 * mobile.size)
    job_src = rng.permutation(mobile)[:nj]
    job_rate = load * rng.uniform(0.1, 0.5, nj)
    rec = CaseRecord(topo=topo, roles=roles, proc_bws=proc_bws, link_rates=link_rates,
                     seed=seed, name=f"large_{gtype}_n{n}_seed{seed}")
    return LargeCase(rec=rec, job_src=job_src.astype(np.int64), job_rate=job_rate,
                     T=float(t_max), gtype=gtype)


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count, the fixed-point scan's runs, and
    K2's squarings that ran (`squarings`, `squarings_bf16`: summed over
    every card, which waits for them)."""
    return {"fixed_point": fp.fixed_point_cuda.launches,
            "fixed_point_scan": fp.fixed_point_scan.runs,
            "minplus": mp.minplus_closure_cuda.launches,
            "minplus_bwd": mp.minplus_closure_bwd_cuda.launches,
            "blocked_fw": mp.blocked_fw_cuda.launches,
            "coo_apsp": mp.apsp_coo_cuda.launches,
            "chebconv": cc.chebconv_propagate_cuda.launches,
            "ragged_index": cc.ragged_index_cuda.launches,
            "minplus_bf16": mp.minplus_closure_cuda.launches_bf16,
            "coo_apsp_bf16": mp.apsp_coo_cuda.launches_bf16,
            "chebconv_bf16": cc.chebconv_propagate_cuda.launches_bf16,
            "chebconv_bf16_t": cc.chebconv_propagate_cuda.launches_bf16_t,
            "blocked_fw_bf16": mp.blocked_fw_cuda.launches_bf16,
            "squarings": mp.squarings_executed(torch.float32),
            "squarings_bf16": mp.squarings_executed(torch.bfloat16)}


def reset_kernel_counts() -> None:
    fp.fixed_point_cuda.launches = 0
    fp.fixed_point_scan.runs = 0
    mp.minplus_closure_cuda.launches = 0
    mp.minplus_closure_bwd_cuda.launches = 0
    mp.blocked_fw_cuda.launches = 0
    mp.apsp_coo_cuda.launches = 0
    cc.chebconv_propagate_cuda.launches = 0
    cc.ragged_index_cuda.launches = 0
    mp.minplus_closure_cuda.launches_bf16 = 0
    mp.apsp_coo_cuda.launches_bf16 = 0
    cc.chebconv_propagate_cuda.launches_bf16 = 0
    cc.chebconv_propagate_cuda.launches_bf16_t = 0
    mp.blocked_fw_cuda.launches_bf16 = 0
    mp.reset_squarings()


def _timed(dev, fn, counts: dict | None = None, name: str = ""):
    """(result, seconds) of one call ending in a sync; with `counts`, the
    kernel counts are set to 0 before it and read after it into
    counts[name]."""
    if counts is not None:
        reset_kernel_counts()
    synchronize(dev)
    t0 = time.perf_counter()  # nondet-ok(the report's wall time is a measurement)
    out = fn()
    synchronize(dev)
    dt = time.perf_counter() - t0  # nondet-ok(same measurement)
    if counts is not None:
        counts[name] = kernel_counts()
    return out, dt


def _mean_s(dev, fn, steps: int) -> float:
    return sum(_timed(dev, fn)[1] for _ in range(steps)) / steps


def large_model(k: int = 3, device=None):
    """The demo's model at Chebyshev order `k`: JAX's initial draw at
    k = 3 (`LARGE_K3_init`), the port's glorot draw from seed 0 at any
    other order."""
    if k == 3:
        return load_model(MODEL, device=device)
    return make_model(Config(cheb_k=k), generator=torch.Generator().manual_seed(0)).to(
        resolve_device(device))


def coo_support(model, inst):
    """`--sparse`: the model's dense default support as a COO list on the
    instance's device, and the model's propagate swapped for
    `coo_propagate` (the demo's `model.clone(propagate=coo_propagate)`)."""
    support = dense_to_coo(default_support(model, inst)).to(inst.adj.device)
    for layer in [model] + list(model.layers):
        layer.propagate = coo_propagate
    return support


def run(device=None, steps: int = 3, backward: bool = False,
        case: LargeCase | None = None, k: int = 3, apsp: str = LARGE_APSP,
        sparse: bool = False) -> dict:
    """Drive the large-graph path once cold and `steps` times warm on
    `device` (default CUDA) at Chebyshev order `k` on the APSP route
    `apsp`, with the COO support under `sparse`; returns the report."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()  # nondet-ok(the report's wall time is a measurement)
    case = case or load_large_case()
    inst, jobs, pad = large_request(case, device=dev)
    model = large_model(k, dev)
    support = coo_support(model, inst) if sparse else None
    synchronize(dev)
    build_s = time.perf_counter() - t0  # nondet-ok(same measurement)
    counts: dict = {}
    apsp_path = mp.resolve_apsp(apsp, pad.n)[1]

    route = {"device": dev, "apsp_impl": apsp, "support": support}
    (outcome, _), compile_s = _timed(dev, lambda: forward_env(model, inst, jobs, **route),
                                     counts, "forward_env")
    step_s = _mean_s(dev, lambda: forward_env(model, inst, jobs, **route), steps)
    (bl, loc, gnn), eval_s = _timed(dev, lambda: eval_methods(model, inst, jobs, **route),
                                    counts, "eval_methods")

    m = jobs.mask[0]
    nj = int(m.sum())
    totals = outcome.job_total[0][m]
    offloaded = outcome.decision.dst[0][m] != jobs.src[0][m].to(torch.int32)
    report = {
        "metric": "large_scale_forward_env",
        "n": case.rec.topo.n, "links": case.rec.topo.num_links, "ext_slots": pad.e,
        "jobs": nj, "gtype": case.gtype, "cheb_k": model.k,
        "apsp": apsp_path,
        "fixed_point": fp.fixed_point_path(pad.l), "sparse": sparse,
        "pad": [pad.n, pad.l, pad.s, pad.j],
        "build_s": build_s, "compile_s": compile_s, "step_s": step_s,
        "tau": totals.mean().item(),
        "congested_ratio": (totals > inst.T[0]).double().mean().item(),
        "offloaded_ratio": offloaded.double().mean().item(),
        "eval_methods_s": eval_s,
        "tau_methods": {k: v[0][m].mean().item()
                        for k, v in (("baseline", bl), ("local", loc), ("gnn", gnn))},
    }

    if apsp != "xla":
        # the demo's standalone APSP: unit weights on the graph's edges
        inf = torch.full((), float("inf"), dtype=inst.adj.dtype, device=dev)
        wmat = torch.where(inst.adj > 0, 1.0 / inst.adj.clamp_min(1e-9), inf)
        eye = torch.eye(pad.n, dtype=torch.bool, device=dev)
        d0 = torch.where(eye, torch.zeros_like(inf), wmat).contiguous()
        reps = max(steps, 3)
        iters = mp.squaring_count(pad.n)
        # one call each first: the squarings are off the path, so their
        # first call here loads K2
        mp.apsp_minplus_pallas(wmat)
        mp.minplus_closure(d0, iters)
        report["apsp_pallas_ms"] = 1e3 * _mean_s(dev, lambda: mp.apsp_minplus_pallas(wmat),
                                                 reps)
        report["apsp_xla_ms"] = 1e3 * _mean_s(dev, lambda: mp.minplus_closure(d0, iters), reps)

    if backward:
        outs, report["bwd_compile_s"] = _timed(
            dev, lambda: forward_backward(model, inst, jobs, **route),
            counts, "forward_backward")
        report["bwd_step_s"] = _mean_s(
            dev, lambda: forward_backward(model, inst, jobs, **route), steps)
        report["loss_critic"] = outs.loss_critic[0].item()
        report["grads_finite"] = all(bool(torch.isfinite(g).all())
                                     for g in outs.grads.values())
    report["launches"] = counts
    report["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        report["peak_mem_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--backward", action="store_true",
                   help="also run the actor/critic training step")
    p.add_argument("--out", default=None, help="also write the report here")
    p.add_argument("--n", type=int, default=None,
                   help="draw a network of this many nodes (default: the committed 1,024)")
    p.add_argument("--gtype", default=None, choices=["er", "ba", "ws", "poisson"],
                   help="graph family of the drawn network (default er)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the drawn network and jobs (default 42)")
    p.add_argument("--load", type=float, default=None,
                   help="arrival load of the drawn jobs (default 0.15)")
    p.add_argument("--T", type=float, default=None,
                   help="congestion-penalty scale t_max (default 1000)")
    p.add_argument("--k", type=int, default=3, help="Chebyshev order")
    p.add_argument("--apsp", default=LARGE_APSP, choices=["pallas", "xla", "auto"])
    p.add_argument("--sparse", action="store_true",
                   help="COO segment-sum GNN propagation instead of the dense "
                        "(E, E) support")
    args = p.parse_args(argv)
    case = None
    drawn = (args.n, args.gtype, args.seed, args.load, args.T)
    if any(v is not None for v in drawn):
        case = build_case(1024 if args.n is None else args.n, args.gtype or "er",
                          42 if args.seed is None else args.seed,
                          0.15 if args.load is None else args.load,
                          1000.0 if args.T is None else args.T)
    report = run(args.device, args.steps, args.backward, case=case, k=args.k,
                 apsp=args.apsp, sparse=args.sparse)
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(line + "\n")
    print(line)  # print-ok(the script's one JSON line is its output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
