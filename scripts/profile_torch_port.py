"""Where the time of the PyTorch port's paths goes, on one card.

`--path eval` (default) runs `eval_methods` of `multihop_offload_tpu_torch`
over the paper batch (16 committed networks x 4 job sets = 64 requests, the
model of record, dense layout); `--path train` runs `train_step` over the
same batch as 64 episodes (SPECTRAL_K2, sparse layout; the step replays
`Config.batch` stored gradients once that many are stored, which the
warm-up calls ensure); `--path large` runs the large-graph path of
`large_scale.py` on its one 1,024-node request (`LARGE_K3_init`, dense
layout, the demo's `'pallas'` APSP route): `eval_methods`, then
`forward_backward`, as one call.  It
reports:

* the wall time of each named phase of the path (`_phases.phase` marks
  them in the package's own functions; under `_phases.timing()` each phase
  synchronizes the card at its start and end), median of `--reps` calls;
  nested phases are named by their path (`gnn/apsp`) and their time is
  part of the enclosing phase's;
* the wall time of whole calls, median of `--reps`;
* a `torch.profiler` window over `--reps` whole calls: summed kernel time
  per call, the kernel launch count, and the kernels with the most device
  time.  The card's busy share is that device time over the unprofiled
  wall time (tracing itself stretches the window's wall time).

    python3 scripts/profile_torch_port.py [--path eval|train|large] [--reps 10] [--out FILE]

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

from multihop_offload_tpu_torch import _phases  # noqa: E402
from multihop_offload_tpu_torch.agent.train_step import forward_backward  # noqa: E402
from multihop_offload_tpu_torch.config import Config  # noqa: E402
from multihop_offload_tpu_torch.graphs.cases import (  # noqa: E402
    large_request,
    load_cases,
    request_batch,
)
from multihop_offload_tpu_torch.large_scale import LARGE_APSP  # noqa: E402
from multihop_offload_tpu_torch.large_scale import MODEL as LARGE_MODEL  # noqa: E402
from multihop_offload_tpu_torch.models.chebconv import load_model  # noqa: E402
from multihop_offload_tpu_torch.train.driver import (  # noqa: E402
    eval_methods,
    train_init,
    train_step,
)


def timed_phases(call) -> dict:
    """{phase: host ms} of one call of the path."""
    with _phases.timing() as times:
        call()
    return dict(times)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", choices=("eval", "train", "large"), default="eval")
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
    if args.path == "eval":
        cfg = Config(arrival_scale=0.15)
        inst, jobs, pad = request_batch(load_cases("paper")[:16], 4, seed=0, cfg=cfg,
                                        device=dev)
        model = load_model("SCRATCH800_decay0.99", device=dev)

        def call():
            eval_methods(model, inst, jobs)
    elif args.path == "large":
        inst, jobs, pad = large_request(device=dev)
        model = load_model(LARGE_MODEL, device=dev)

        def call():
            eval_methods(model, inst, jobs, apsp_impl=LARGE_APSP)
            forward_backward(model, inst, jobs, apsp_impl=LARGE_APSP)
    else:
        cfg = Config(arrival_scale=0.15, layout="sparse", cheb_k=2)
        inst, jobs, pad = request_batch(load_cases("paper")[:16], 4, seed=0, cfg=cfg,
                                        device=dev, layout="sparse")
        model = load_model("SPECTRAL_K2", device=dev, layout="sparse")
        state = train_init(model, cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def call():
            train_step(model, state, inst, jobs, cfg, gen=gen)
    b = inst.adj.shape[0]

    for _ in range(3):  # warm-up: kernel build, allocator, cuBLAS handles
        call()
    runs = [timed_phases(call) for _ in range(args.reps)]
    med = {k: sorted(r.get(k, 0.0) for r in runs)[len(runs) // 2]
           for k in sorted({k for r in runs for k in r})}
    # the outermost phases cover the path; nested ones are parts of them
    total = sum(ms for k, ms in med.items() if "/" not in k)
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the phases' record_function ranges also appear on the
    # device timeline, as spans that cover their kernels and the gaps
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type) and e.key not in med]
    kernels = sorted(
        ({"name": e.key[:80], "count": e.count,
          "device_ms": e.self_device_time_total / 1e3 / args.reps}
         for e in events if e.self_device_time_total > 0),
        key=lambda r: -r["device_ms"])
    device_ms = sum(k["device_ms"] for k in kernels)
    launches = sum(k["count"] for k in kernels) / args.reps
    record = {
        "card": smi, "path": args.path, "batch": b, "pad": [pad.n, pad.l, pad.s, pad.j],
        "phase_ms": med, "phase_total_ms": total,
        "call_ms": wall_ms,
        "profiled_window_ms_per_call": window_ms / args.reps,
        "device_busy_ms": device_ms if kernels else None,
        "device_busy_share": (device_ms / wall_ms) if kernels else None,
        "kernel_launches_per_call": launches if kernels else None,
        "top_kernels": kernels[:15],
    }
    for name, ms in med.items():
        print(f"{name:40s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
    print(f"{args.path} call {wall_ms:.3f} ms per batch of {b} (profiled "
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
