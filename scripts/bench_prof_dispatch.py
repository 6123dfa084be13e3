"""Host time of one call of each hand-kernel dispatcher on the main path.

The prof layer (`multihop_offload_tpu_torch/obs/prof.py`) puts a test of
its count into every kernel dispatcher (`counted`, `kernel_scope`).  This
script times what a call of each dispatcher costs the host outside a
count: the mean microseconds per call with no synchronize inside the loop
(the wrapper's Python and the launch), the least of `--windows` windows of
`--reps` calls, at a small batch of the paper cases (`--networks` x
`--instances` job sets, 2 x 2 by default: B = 4, where a call's host
time is longer than its device time, so the host is what is timed): K1
(`fixed_point`), K2 (`minplus_closure`), K4 (`chebconv_propagate`,
forward), K6 (`apsp_coo_squaring`) and K2's closure with its backward
(`apsp_minplus(early_stop=False)` and one `autograd.grad`).

`--root DIR` imports the port from DIR instead of this checkout, so an
older tree of the package can be timed in the same machine:

    python scripts/bench_prof_dispatch.py --root OLD_TREE --out old.json
    python scripts/bench_prof_dispatch.py --out new.json

Each run prints one JSON line (the card's name and power limit in it) and
writes it where `--out` names.  It runs on the card unless `--device cpu`
is given (the plain versions: a check that the script runs).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   help="directory holding the multihop_offload_tpu_torch package to time")
    p.add_argument("--networks", type=int, default=2)
    p.add_argument("--instances", type=int, default=2)
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--windows", type=int, default=5)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))

    import torch

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_prof_dispatch: CUDA is not available (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    from multihop_offload_tpu_torch.agent.actor import build_ext_features, default_support
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.env.apsp import weight_matrix_from_link_delays
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.ops import chebconv as cc
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp
    import multihop_offload_tpu_torch as pkg

    cfg = Config(arrival_scale=0.15)
    paper = load_cases("paper")[:a.networks]
    inst, jobs, _ = request_batch(paper, a.instances, seed=0, cfg=cfg, device=dev)
    sp_inst, _, _ = request_batch(paper, a.instances, seed=0, cfg=cfg, device=dev,
                                  layout="sparse")
    model = load_model("SCRATCH800_decay0.99", device=dev)
    with torch.no_grad():
        w = weight_matrix_from_link_delays(inst.adj, inst.link_index, 1.0 / inst.link_rates)
        n = w.shape[-1]
        d = torch.where(torch.eye(n, dtype=torch.bool, device=dev), 0.0, w).contiguous()
        lam = model(build_ext_features(inst, jobs), default_support(model, inst))[..., 0]
        lam = (lam * inst.ext_mask)[:, : inst.num_pad_links].contiguous()
    iters = max(1, math.ceil(math.log2(max(n - 1, 2))))
    fp_args = (inst.adj_conflict.contiguous(), inst.link_rates.contiguous(),
               inst.cf_degs.contiguous(), lam)
    support = sparse_chebyshev_support(sp_inst.sparse.ext, mask=sp_inst.ext_mask,
                                       csr=sp_inst.sparse.ext_csr)
    x = torch.rand((sp_inst.adj.shape[0], support.diag.shape[-1], 32), device=dev)
    delays = (1.0 / sp_inst.link_rates).contiguous()
    sp_n = sp_inst.num_pad_nodes
    ct = torch.rand_like(d)

    def closure_grad():
        xk = w.detach().requires_grad_()
        out = mp.apsp_minplus(xk, early_stop=False)
        torch.autograd.grad(out, xk, grad_outputs=torch.where(torch.isfinite(out), ct, 0.0))

    calls = {
        "fixed_point": lambda: fp.fixed_point(*fp_args),
        "minplus_closure": lambda: mp.minplus_closure(d, iters),
        "chebconv_propagate": lambda: cc.chebconv_propagate(support, x),
        "apsp_coo_squaring": lambda: mp.apsp_coo_squaring(sp_inst.link_ends, sp_inst.link_mask,
                                                          delays, sp_n),
    }
    out = {"root": os.path.abspath(a.root), "package": os.path.dirname(pkg.__file__),
           "device": str(dev), "card": _card() if dev.type == "cuda" else "",
           "shapes": {"B": int(inst.adj.shape[0]), "n": n,
                                       "l": int(fp_args[1].shape[-1]), "sparse_n": sp_n,
                                       "feat": 32},
           "reps": a.reps, "windows": a.windows, "host_us": {}}
    with torch.no_grad():
        for name, fn in calls.items():
            out["host_us"][name] = _host_us(fn, a.reps, a.windows, dev)
    out["host_us"]["minplus_closure_diff_fwd_bwd"] = _host_us(closure_grad, a.reps // 4,
                                                              a.windows, dev)
    line = json.dumps(out)
    print(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


def _host_us(fn, reps: int, windows: int, dev) -> float:
    """The least mean host microseconds a call over `windows` windows of
    `reps` calls, each window after a synchronize."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(windows):
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
    sync()
    return best


if __name__ == "__main__":
    sys.exit(main())
