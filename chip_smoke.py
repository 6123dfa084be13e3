"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's offloading decision path on the card through the entry
points a user calls (`train.driver.eval_methods`, `agent.policy.forward_env`)
at the full width of the model of record (5 ChebConv layers, width 32) over
the paper-scale batch: 16 committed BA networks (n = 20..110) x 4 job sets
= 64 requests, plus the 4-network 256-node rung.  It

1. prints the card, its power limit and the software versions;
2. builds the CUDA kernels from `multihop_offload_tpu_torch/csrc/` and
   prints the build time and ptxas' register / shared-memory / spill lines;
3. holds each kernel against its plain PyTorch version on the same card
   tensors at the main path's shapes (K2 bit-identical, K1 <= 1e-5 relative);
4. runs the main path with every launch count set to 0 and fails unless
   both kernels launched; checks card against CPU (float32, plain versions):
   baseline and local `dst` identical, GNN `dst` agreement >= 0.99,
   `job_total` within rtol 1e-4 on every request whose decisions all agree;
5. times each kernel, its plain version and the path with CUDA events;
6. prints the kernels line, then the `{"ok": true, ...}` line last.

Any failure raises, so the exit code is not 0 and no result line appears.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and fp32
# CUDA-core instructions/s (67 TFLOP/s counts an FMA as two operations)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_FP32_INSTR_PER_S = PEAK_FP32_FLOP_PER_S / 2
MODEL_K1 = "SCRATCH800_decay0.99"
MODEL_K2 = "SPECTRAL_K2"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median host milliseconds per call, each ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def device_lines() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} python={sys.version.split()[0]}")
    log(smi)
    return {"name": name, "smi": smi}


def build_kernels() -> None:
    from multihop_offload_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}")
    for name, info in sorted(_build.build_log.items()):
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                log(f"  ptxas[{name}] {line.strip()}")


def kernel_inputs(model, inst, jobs):
    """The operands the main path hands each kernel: the APSP input of the
    baseline method and the actor's fixed point (link lambdas of the GNN)."""
    from multihop_offload_tpu_torch.agent.actor import build_ext_features, default_support
    from multihop_offload_tpu_torch.env.apsp import weight_matrix_from_link_delays

    with torch.no_grad():
        w = weight_matrix_from_link_delays(inst.adj, inst.link_index,
                                           1.0 / inst.link_rates)
        n = w.shape[-1]
        d = torch.where(torch.eye(n, dtype=torch.bool, device=w.device), 0.0, w)
        lam = model(build_ext_features(inst, jobs), default_support(model, inst))[..., 0]
        lam = (lam * inst.ext_mask)[:, : inst.num_pad_links].contiguous()
    fp_args = (inst.adj_conflict.contiguous(), inst.link_rates.contiguous(),
               inst.cf_degs.contiguous(), lam)
    return d.contiguous(), max(1, math.ceil(math.log2(max(n - 1, 2)))), fp_args


def kernel_phase(batches) -> dict:
    """Each kernel against its plain version on the same card tensors."""
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp

    errs = {}
    for tag, (model, inst, jobs) in batches.items():
        d, iters, fp_args = kernel_inputs(model, inst, jobs)
        got = mp.minplus_closure_cuda(d, iters)
        ref = mp.minplus_closure_plain(d, iters)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"K2 {tag} {tuple(d.shape)}: {bad} entries differ")
        mu = fp.fixed_point_cuda(*fp_args)
        mu_ref = fp.fixed_point_plain(*fp_args)
        torch.cuda.synchronize()
        rel = ((mu - mu_ref).abs() / mu_ref.abs()).max().item()
        log(f"K2 minplus {tag} B,N={tuple(d.shape[:2])} iters={iters}: "
            f"bit-identical to plain (bar: torch.equal); K1 fixed_point "
            f"B,L={tuple(mu.shape)}: max rel err {rel:.3e} vs plain (bar 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"K1 {tag}: max relative error {rel} > 1e-5")
        errs[tag] = {"minplus": 0.0,
                     "fixed_point": ((mu - mu_ref).abs().max().item())}
    return errs


def reset_counts():
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp

    fp.fixed_point_cuda.launches = 0
    mp.minplus_closure_cuda.launches = 0
    if mp.minplus_closure_cuda.executed is not None:
        mp.minplus_closure_cuda.executed.zero_()


def read_counts() -> dict:
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp

    torch.cuda.synchronize()
    ex = mp.minplus_closure_cuda.executed
    return {"fixed_point": fp.fixed_point_cuda.launches,
            "minplus": mp.minplus_closure_cuda.launches,
            "squarings": 0 if ex is None else int(ex)}


def outcomes(model, inst, jobs, device):
    from multihop_offload_tpu_torch.agent.policy import forward_env
    from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy

    with torch.no_grad():
        inst, jobs = inst.to(device), jobs.to(device)
        return {"baseline": baseline_policy(inst, jobs),
                "local": local_policy(inst, jobs),
                "gnn": forward_env(model, inst, jobs, device=device)[0]}


def compare(tag, card: dict, cpu: dict, mask: torch.Tensor) -> None:
    """Card outcomes against CPU outcomes of the same requests."""
    for method, out in card.items():
        ref = cpu[method]
        dst, dst_ref = out.decision.dst.cpu(), ref.decision.dst
        tot, tot_ref = out.job_total.cpu(), ref.job_total
        if tot.shape != mask.shape or not torch.isfinite(tot[mask]).all():
            raise AssertionError(f"{tag}/{method}: job_total not finite {tuple(tot.shape)}")
        differ = ((dst != dst_ref) & mask)
        n_diff, n_real = int(differ.sum()), int(mask.sum())
        agree = 1.0 - n_diff / n_real
        if method in ("baseline", "local") and n_diff:
            raise AssertionError(f"{tag}/{method}: {n_diff} dst differ from the CPU")
        if agree < 0.99:
            raise AssertionError(f"{tag}/{method}: dst agreement {agree:.4f} < 0.99")
        same = ~differ.any(dim=1)  # requests whose decisions all agree
        rel = ((tot - tot_ref).abs() / tot_ref.abs())[mask & same[:, None]]
        worst = rel.max().item() if rel.numel() else 0.0
        log(f"{tag}/{method}: {n_diff} of {n_real} real jobs differ in dst "
            f"(agreement {agree:.4f}); job_total max rel err {worst:.3e} over "
            f"{int(same.sum())} requests with equal decisions")
        if not worst <= 1e-4:
            raise AssertionError(f"{tag}/{method}: job_total rel err {worst} > 1e-4")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from multihop_offload_tpu_torch.agent.policy import forward_env
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.train.driver import eval_methods

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = device_lines()
    build_kernels()

    # ---- workload: committed cases, seeded job sets, committed weights -----
    paper = load_cases("paper")[:16]
    cfg = Config(arrival_scale=0.15)  # the JAX bench workload's load
    inst_cpu, jobs_cpu, pad = request_batch(paper, 4, seed=0, cfg=cfg, device="cpu")
    rung_inst_cpu, rung_jobs_cpu, rung_pad = request_batch(
        load_cases("rung256"), 1, seed=0, cfg=cfg, device="cpu")
    inst, jobs = inst_cpu.to(dev), jobs_cpu.to(dev)
    rung_inst, rung_jobs = rung_inst_cpu.to(dev), rung_jobs_cpu.to(dev)
    model_cpu = load_model(MODEL_K1, device="cpu")
    model_k2_cpu = load_model(MODEL_K2, device="cpu")
    model = load_model(MODEL_K1, device=dev)
    model_k2 = load_model(MODEL_K2, device=dev)
    log(f"paper batch: B={inst.adj.shape[0]} {pad}; "
        f"rung256 batch: B={rung_inst.adj.shape[0]} {rung_pad}; "
        f"real jobs {int(jobs.mask.sum())} / {int(rung_jobs.mask.sum())}")

    # ---- kernel phase -------------------------------------------------------
    errs = kernel_phase({"paper": (model, inst, jobs),
                         "rung256": (model, rung_inst, rung_jobs)})

    # ---- main path: counts at 0 just before, read just after ----------------
    reset_counts()
    bl, loc, gnn = eval_methods(model, inst, jobs)
    counts = read_counts()
    log(f"main path eval_methods (B={inst.adj.shape[0]}): launches {counts}")
    if counts["fixed_point"] == 0 or counts["minplus"] == 0 or counts["squarings"] == 0:
        raise AssertionError(f"a kernel of the path did not launch: {counts}")

    # ---- slice checks: card vs CPU (float32, plain versions) ----------------
    mask = jobs_cpu.mask
    card_out = outcomes(model, inst, jobs, dev)
    cpu_out = outcomes(model_cpu, inst_cpu, jobs_cpu, "cpu")
    compare("paper", card_out, cpu_out, mask)
    for name, tot in (("baseline", bl), ("local", loc), ("gnn", gnn)):
        torch.testing.assert_close(tot.cpu(), cpu_out[name].job_total,
                                   rtol=1e-4, atol=0, msg=f"eval_methods {name}")
    k2_card = forward_env(model_k2, inst, jobs)[0]
    k2_cpu = forward_env(model_k2_cpu, inst_cpu, jobs_cpu, device="cpu")[0]
    compare("paper-K2", {"gnn": k2_card}, {"gnn": k2_cpu}, mask)
    rung_counts0 = read_counts()
    eval_methods(model, rung_inst, rung_jobs)
    rung_counts = {k: v - rung_counts0[k] for k, v in read_counts().items()}
    log(f"rung256 eval_methods (B={rung_inst.adj.shape[0]}): launches {rung_counts}")
    compare("rung256", outcomes(model, rung_inst, rung_jobs, dev),
            outcomes(model_cpu, rung_inst_cpu, rung_jobs_cpu, "cpu"),
            rung_jobs_cpu.mask)

    # ---- timing -------------------------------------------------------------
    d, iters, fp_args = kernel_inputs(model, inst, jobs)
    b, n, _ = d.shape
    _, l = fp_args[1].shape
    before = read_counts()["squarings"]
    mp.minplus_closure_cuda(d, iters)
    sq_per_call = read_counts()["squarings"] - before
    k2_ms = cuda_ms(lambda: mp.minplus_closure_cuda(d, iters), 50)
    k2_plain_ms = cuda_ms(lambda: mp.minplus_closure_plain(d, iters), 10)
    k1_ms = cuda_ms(lambda: fp.fixed_point_cuda(*fp_args), 200)
    k1_plain_ms = cuda_ms(lambda: fp.fixed_point_plain(*fp_args), 50)
    # bounds for the same work: K2 is 2 N^3 fp32 instructions per executed
    # matrix squaring (add + min; no tensor-core path); K1 must read A and
    # three (B, L) vectors once and write mu once
    k2_bound_ms = 2.0 * n ** 3 * sq_per_call / PEAK_FP32_INSTR_PER_S * 1e3
    k2_bytes_ms = 2 * b * n * n * 4 / PEAK_BYTES_PER_S * 1e3
    k1_bytes_ms = b * (l * l + 4 * l) * 4 / PEAK_BYTES_PER_S * 1e3
    k1_ops_ms = 10 * b * (2 * l * l + 5 * l) / PEAK_FP32_FLOP_PER_S * 1e3
    reps = 10
    eval_ms = wall_ms(lambda: eval_methods(model, inst, jobs), reps)
    fwd_ms = wall_ms(lambda: forward_env(model, inst, jobs), reps)
    rung_ms = wall_ms(lambda: eval_methods(model, rung_inst, rung_jobs), 5)
    torch.cuda.reset_peak_memory_stats()
    eval_methods(model, inst, jobs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"timing on {card['smi']}: K2 minplus {k2_ms:.4f} ms per APSP call "
        f"({iters} launches, {sq_per_call} matrix squarings run of {b * iters}), "
        f"plain {k2_plain_ms:.4f} ms, bound {max(k2_bound_ms, k2_bytes_ms):.4f} ms; "
        f"K1 fixed_point {k1_ms:.4f} ms per launch, plain {k1_plain_ms:.4f} ms, "
        f"bound {max(k1_bytes_ms, k1_ops_ms):.4f} ms")
    log(f"eval_methods {eval_ms:.2f} ms per batch of {b} requests "
        f"({b / eval_ms * 1e3:.1f} requests/s); forward_env {fwd_ms:.2f} ms; "
        f"rung256 eval_methods {rung_ms:.2f} ms per batch of "
        f"{rung_inst.adj.shape[0]}; peak memory {peak / 2**20:.1f} MiB "
        f"(max_memory_allocated, paper batch)")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "fixed_point", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/fixed_point.cu",
         "replaces": "multihop_offload_tpu/ops/fixed_point.py:144",
         "launches": counts["fixed_point"],
         "max_abs_err": errs["paper"]["fixed_point"],
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": max(k1_bytes_ms, k1_ops_ms),
         "bound_by": "bytes" if k1_bytes_ms >= k1_ops_ms else "operations",
         "library_ms": None, "shape": [b, l]},
        {"name": "minplus_squaring", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/minplus.cu",
         "replaces": "multihop_offload_tpu/ops/minplus.py:88",
         "launches": counts["minplus"], "squarings": counts["squarings"],
         "max_abs_err": errs["paper"]["minplus"],
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": max(k2_bound_ms, k2_bytes_ms),
         "bound_by": "operations" if k2_bound_ms >= k2_bytes_ms else "bytes",
         "library_ms": None, "shape": [b, n],
         "launches_per_call": iters, "ms_per_launch": k2_ms / iters,
         "squarings_per_call": sq_per_call},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
