"""Where the time of the PyTorch port's decision path goes, on one card.

Runs `eval_methods` of `multihop_offload_tpu_torch` over the paper batch
(16 committed networks x 4 job sets = 64 requests, the model of record) and
reports:

* the wall time of each phase of the three methods (host clock, with a
  `torch.cuda.synchronize()` closing every phase), median of `--reps` runs;
* the wall time of whole `eval_methods` calls, median of `--reps`;
* a `torch.profiler` window over `--reps` whole calls: summed kernel time
  per call, the kernel launch count, and the kernels with the most device
  time.  The card's busy share is that device time over the unprofiled
  wall time (tracing itself stretches the window's wall time).

    python3 scripts/profile_torch_port.py [--reps 10] [--out build/profile_torch_port.json]

Needs a CUDA card; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from multihop_offload_tpu_torch.config import Config  # noqa: E402
from multihop_offload_tpu_torch.agent.actor import (  # noqa: E402
    actor_delay_matrix,
    default_support,
)
from multihop_offload_tpu_torch.env.apsp import (  # noqa: E402
    apsp_minplus,
    next_hop_table,
    weight_matrix_from_link_delays,
)
from multihop_offload_tpu_torch.env.baseline import baseline_unit_delays  # noqa: E402
from multihop_offload_tpu_torch.env.offloading import offload_decide  # noqa: E402
from multihop_offload_tpu_torch.env.policies import local_policy  # noqa: E402
from multihop_offload_tpu_torch.env.queueing import run_empirical  # noqa: E402
from multihop_offload_tpu_torch.env.routing import trace_routes  # noqa: E402
from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch  # noqa: E402
from multihop_offload_tpu_torch.models.chebconv import load_model  # noqa: E402
from multihop_offload_tpu_torch.train.driver import eval_methods  # noqa: E402


def phases(model, inst, jobs) -> dict:
    """Wall ms of each phase of eval_methods' three methods, in its order."""
    out = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = out.get(name, 0.0) + (now - t) * 1e3
        t = now

    def spmatrix(prefix, link_d, node_d):
        w = weight_matrix_from_link_delays(inst.adj, inst.link_index, link_d)
        sp = apsp_minplus(w)
        mark(f"{prefix}/apsp")
        dec = offload_decide(inst, jobs, sp, inst.hop, node_d)
        mark(f"{prefix}/offload_decide")
        nh = next_hop_table(inst.adj, sp)
        mark(f"{prefix}/next_hop_table")
        routes = trace_routes(inst, nh, jobs, dec.dst)
        mark(f"{prefix}/trace_routes")
        run_empirical(inst, jobs, routes)
        mark(f"{prefix}/run_empirical")

    with torch.no_grad():
        spmatrix("baseline", *baseline_unit_delays(inst))
        local_policy(inst, jobs)
        mark("local/all")
        actor = actor_delay_matrix(model, inst, jobs, default_support(model, inst))
        mark("gnn/actor")
        spmatrix("gnn", actor.link_delay,
                 torch.diagonal(actor.delay_matrix, dim1=1, dim2=2))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "profile_torch_port.json"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    inst, jobs, pad = request_batch(load_cases("paper")[:16], 4, seed=0,
                                    cfg=Config(arrival_scale=0.15), device=dev)
    model = load_model("SCRATCH800_decay0.99", device=dev)
    b = inst.adj.shape[0]

    for _ in range(3):  # warm-up: kernel build, allocator, cuBLAS handles
        phases(model, inst, jobs)
        eval_methods(model, inst, jobs)
    runs = [phases(model, inst, jobs) for _ in range(args.reps)]
    med = {k: sorted(r[k] for r in runs)[len(runs) // 2] for k in runs[0]}
    total = sum(med.values())
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        eval_methods(model, inst, jobs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            eval_methods(model, inst, jobs)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    kernels = sorted(
        ({"name": e.key[:80], "count": e.count,
          "device_ms": e.self_device_time_total / 1e3 / args.reps}
         for e in events if e.self_device_time_total > 0),
        key=lambda r: -r["device_ms"])
    device_ms = sum(k["device_ms"] for k in kernels)
    launches = sum(k["count"] for k in kernels) / args.reps
    record = {
        "card": smi, "batch": b, "pad": [pad.n, pad.l, pad.s, pad.j],
        "phase_ms": med, "phase_total_ms": total,
        "eval_methods_ms": wall_ms,
        "profiled_window_ms_per_call": window_ms / args.reps,
        "device_busy_ms": device_ms if kernels else None,
        "device_busy_share": (device_ms / wall_ms) if kernels else None,
        "kernel_launches_per_call": launches if kernels else None,
        "top_kernels": kernels[:15],
    }
    for name, ms in med.items():
        print(f"{name:28s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
    print(f"eval_methods {wall_ms:.3f} ms per batch of {b} (profiled "
          f"{window_ms / args.reps:.3f}); device "
          f"busy {record['device_busy_ms']} ms, share {record['device_busy_share']}; "
          f"{launches:.0f} kernels per call, on {smi}")
    for k in kernels[:15]:
        print(f"  {k['device_ms']:8.4f} ms  x{k['count'] // args.reps:<5d} {k['name']}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "top_kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
