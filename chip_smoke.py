"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's two paths on the card through the entry points a user
calls, at full width, over the paper-scale batch: 16 committed BA networks
(n = 20..110) x 4 job sets = 64 requests or episodes, plus the 4-network
256-node rung.

- Slice 1, the decision path: `train.driver.eval_methods` and
  `agent.policy.forward_env` with the model of record (K=1, 5 ChebConv
  layers, width 32), dense layout: kernels K1 and K2.
- Slice 2, the training step: `train.driver.train_step` (batched
  `forward_backward`, gradient replay, Adam) with SPECTRAL_K2 (K=2,
  5 layers, width 32) on the sparse layout: kernels K1, K4 and K6.
- Slice 3, the large-graph path (`large_scale.py`'s functions): the
  committed 1,024-node ER network of `scripts/large_scale_demo.py` (7,694
  links, 451 jobs; pads N=1,024, L=7,696, E=8,720) with its random K=3
  initial parameters, dense layout, through `eval_methods`, `forward_env`
  and `forward_backward`: kernel K3 (blocked Floyd-Warshall APSP) and the
  fixed point's scan (L > 928), with K1 launched no time.
- Slice 4, the offloading-decision service (`cli/serve.py:build_service`,
  `serve/`): 256 requests of `request_stream(case_pool([20, 50, 80, 110],
  per_size=2, seed=0), 256, seed=1)` (BA m=2; 2 buckets, pads N 56/112, L
  96/216) driven closed-loop at 16 slots, queue 64, deadline 60 s, after
  one warm-up pass: plain ticks with the model of record (K1, K2), then
  `ragged=True, overlap=True`, one tick past the deadline on an injected
  clock, and the sparse layout with SPECTRAL_K2 on the first 64 requests
  (K1, K4, K6).  K5 (`chebconv_propagate_ragged`: `ragged_index`, the
  stable counting sort of each slot's live prefix on the card, then K4's
  row walk) is on no path, in the JAX package as here: it is held on the
  sparse bucket 1's packed extended support (16 slots, E = 328) and on the
  JAX test's case.
- Slice 12, the Trainer and Evaluator drivers (`train/driver.py`,
  `cli/train.py`) over the committed paper dataset
  (`data/aco_data_ba_paper`: the 20 `.mat` cases, B = 10 job sets a file,
  load 0.15, T 1000; pads N=112, L=216), output in a temporary directory:
  the Evaluator with the model of record, dense (K1, K2), and the Trainer
  through `cli.train.main`, sparse, K=2, fresh init, 1 epoch, replay of
  100 from the 10th file (K1, K4, K6).

It

1. prints the card, its power limit and the software versions;
2. builds the CUDA kernels from `multihop_offload_tpu_torch/csrc/` and
   prints the build time and ptxas' register / shared-memory / spill lines;
3. holds each kernel against its plain PyTorch version on the same card
   tensors at the main paths' shapes: K2, K3 and K6 bit-identical (K2
   also at the service's two buckets, the large demo's (1, 1024) against
   the blocked plain closure and an odd (5, 37), a launch per squaring,
   its squarings run equal to `squarings_run_plain`; K3 on
   the large path's own predicted-delay matrix, against its plain version
   on the card and on the CPU), K1 <= 1e-5 relative on the paper batch,
   the rung, the service's two buckets, the cap (1, 928) and an odd
   (3, 215), bit for bit `rates / (cf + 1)` at `num_iters=0` and the same
   bits on a second call, K4 forward and
   backward within the scaled 4.5e-7 bar of the JAX package
   (max |kernel - plain| / max(1, max |plain|)), at F = 4 and 32; the
   sort equal to `ragged_index_plain` at live, capacity and 0; K5 forward
   and d x within the same bar, at live counts bit-identical to itself at
   the capacity, exactly diag * x at live 0, on the sorted lists, with each
   slot's live prefix permuted (rows unsorted), and on the JAX test's case
   (n=12, f=6, 17 live of 300);
4. drives each path with every launch count set to 0 just before it and
   read just after, and fails unless each of its kernels launched:
   `eval_methods` (K1, K2); three sparse `train_step`s (K1, K4, K6; the
   parameters must change and the losses be finite); one dense
   `forward_backward` with the model of record (K1, K2); the large path's
   `eval_methods`, `forward_env` and `forward_backward` (K3 launched, K1
   not, the fixed-point scan run; finite gradients); the service's plain
   run (K1, K2) and its sparse run (K1, K4, K6), each answering every
   admitted request exactly once; the Evaluator file by file (K1 exactly
   4 launches and K2 exactly 2 APSP calls on every file) and the Trainer
   file by file (K1, K4 and K6 on every file);
5. checks card against CPU (float32, plain versions): baseline and local
   `dst` identical, GNN `dst` agreement >= 0.99, `job_total` within rtol
   1e-4 on every request whose decisions all agree, for the dense
   decision path and for `eval_methods(layout="sparse")` with SPECTRAL_K2;
   for the sparse `forward_backward` at explore=0, `dst` agreement >= 0.99
   and, on episodes whose decisions all agree, `loss_critic` within rtol
   1e-4 and the per-episode gradient's cosine to the CPU's >= 0.999; and
   the large path's baseline, local and GNN methods with the bars of the
   dense decision path; the service's ragged + overlap run against its
   plain run (`dst` and `is_local` agreement >= 0.99, mismatches printed;
   `delay_est`, `job_total` within rtol 1e-5 where a request's decisions
   agree), the late tick served by the baseline with `baseline_policy`'s
   `dst`, and its first 64 requests re-served on the CPU (agreement >=
   0.99, rtol 1e-4); the Evaluator's 600 CSV rows against its first 4
   files on the CPU and against `file_batch=4` (`baseline` and `local`
   rows: `congest_jobs` identical, `tau` within rtol 1e-4; `GNN` rows the
   same on >= 99%); the Trainer's 800 rows, `tau` finite, its parameters
   changed, `try_restore` bit for bit, and a second `cli.train.main`
   resuming past the saved steps;
6. times each kernel on the card's own clock (`device_us`: the kernels'
   durations in `torch.profiler`'s CUDA trace), as a call (CUDA events
   around a loop of calls, host enqueue included) and on the host
   (enqueue only), beside its plain version, its bound and a library call
   (K1 at each of its shapes at 10 rounds and at 0, the A pass alone: the
   ns a round and the A pass's TB/s; K5 at live and at capacity, the sort
   alone, K4 on the same sorted lists and `torch.sparse.mm`; K4 beside
   `torch.sparse.mm` and `torch.bmm`), and the paths on the host clock; the
   service's requests/s, p50/p99 latency, dispatches per request, mean
   tick, launches per tick, host ms in `dispatch` against `fetch`; peak
   memory; the drivers' host ms per file (run-log step events and spans)
   and the card's busy share over one Evaluator file and one Trainer
   replay file;
7. prints the serving line, the drivers line, the kernels line, then the
   `{"ok": true, ...}` line last.

Any failure raises, so the exit code is not 0 and no result line appears.

    python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
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
CHEB_SCALED_TOL = 4.5e-7  # the JAX package's bar for the fused propagate


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` (CUDA events around a loop of
    calls): the "call" time.  Where a call's kernels run for less time
    than its host code takes to enqueue them, this is the host's time."""
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


def device_us(fn, reps: int, warmup: int = 3, kernels_per_call: int | None = None) -> float:
    """Mean device microseconds per call of `fn`, on the card's own clock,
    from `torch.profiler`'s CUDA trace of `reps` calls: for each kernel,
    copy or memset, the mean duration of its records times its launches
    per call, summed.  For a library call that is every kernel it launches.
    Every call launches the same kernels, but the trace can lose records
    (from 2 of 1,250 to nearly all of a window, in runs on an H100): a
    kernel's launches per call are its records over `reps`, rounded, and
    the window is traced again, up to 4 more times, when it holds no
    launch, a count is off a whole multiple by more than a tenth of
    `reps`, or the launches per call are not `kernels_per_call` (where
    given); then this raises.  `device_us.last` keeps the kernels per call,
    the records lost, their names and the device us per call of each name
    (`by_name`), for the log."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts, times = {}, {}
        for e in prof.key_averages():
            if "CUDA" in str(getattr(e, "device_type", "")) and e.self_device_time_total > 0:
                counts[e.key] = counts.get(e.key, 0) + e.count
                times[e.key] = times.get(e.key, 0.0) + e.self_device_time_total
        per_call = {k: round(c / reps) for k, c in counts.items()}
        launches = sum(per_call.values())
        if launches and all(abs(c - per_call[k] * reps) <= reps // 10
                            for k, c in counts.items()) and (
                kernels_per_call is None or launches == kernels_per_call):
            break
    else:
        raise AssertionError(f"device_us: 5 traces lost kernel records or held none "
                             f"({sum(counts.values())} for {reps} calls)")
    by_name = {k: times[k] / counts[k] * n for k, n in per_call.items() if n}
    total = sum(by_name.values())
    device_us.last = {"kernels_per_call": launches,
                      "lost_records": launches * reps - sum(counts.values()),
                      "names": sorted({k[:60] for k in by_name}), "by_name": by_name}
    return total


device_us.last = {}

K3_PHASES = ("pivot", "panels", "outer")


def k3_phase_us(last: dict) -> dict:
    """K3's device us per call split by phase from `device_us.last`: the
    `fw_pivot_kernel`, `fw_panels_kernel` and `fw_outer_kernel` launches,
    and "clone", the wrapper's copy of its input (every other name)."""
    out = dict.fromkeys((*K3_PHASES, "clone"), 0.0)
    for name, us in last["by_name"].items():
        phase = next((p for p in K3_PHASES if f"fw_{p}_kernel" in name), "clone")
        out[phase] += us
    return out


def fw_input(b: int, n: int):
    """K3's test input (`tests/test_torch_gpu.py`): (b, n, n) float32 on
    the CPU, an edge with probability 6 / n, weights U(0.1, 5), +inf
    elsewhere, zero diagonal, from `default_rng(n)`."""
    rng = np.random.default_rng(n)
    w = np.where(rng.uniform(size=(b, n, n)) < 6.0 / n, rng.uniform(0.1, 5.0, (b, n, n)),
                 np.inf).astype(np.float32)
    d = torch.from_numpy(w)
    d.diagonal(dim1=1, dim2=2).zero_()
    return d


def minplus_input(b: int, n: int):
    """K2's test input (`tests/test_torch_gpu.py:_weights`): (b, n, n)
    float32 on the CPU, a symmetric edge with probability 3 / n, weights
    U(0.1, 5), +inf elsewhere, zero diagonal, from `default_rng(n)`."""
    rng = np.random.default_rng(n)
    w = np.full((b, n, n), np.inf, dtype=np.float32)
    for k in range(b):
        iu, ju = np.where(np.triu(rng.uniform(size=(n, n)) < 3.0 / n, 1))
        vals = rng.uniform(0.1, 5.0, iu.size).astype(np.float32)
        w[k, iu, ju] = w[k, ju, iu] = vals
    d = torch.from_numpy(w)
    d.diagonal(dim1=1, dim2=2).zero_()
    return d


# K2's shapes besides the decision path's: the service's two buckets, the
# large demo's standalone squaring (`large_scale.py`'s `apsp_xla_ms`) and
# an odd N, with the squarings their paths run
K2_GENERATED = {(16, 56): 6, (16, 112): 7, (1, 1024): 10, (5, 37): 6}


def host_us(fn, reps: int, warmup: int = 3) -> float:
    """Mean host microseconds per call of `fn` with no synchronize inside
    the loop: what the wrapper's Python and the launch cost the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def clocks(fn, reps: int, warmup: int = 3, kernels_per_call: int | None = None) -> dict:
    """A call's three times: "ms" (events over the loop, host enqueue
    included), "device_ms" (profiler) and "host_us" (enqueue only)."""
    return {"ms": cuda_ms(fn, reps, warmup),
            "device_ms": device_us(fn, reps, 1, kernels_per_call) / 1e3,
            "host_us": host_us(fn, reps, 1), "kernels_per_call": device_us.last[
                "kernels_per_call"]}


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


def fp_input(b: int, n: int, density: float | None = None):
    """K1's test operands (adj, rates, cf, lam) on the CPU, as
    `tests/test_torch_gpu.py` makes them: a symmetric 0/1 matrix with an
    edge at probability `density` (8 / n by default), rates U(30, 70)
    rounded, lambdas U(0, 60), cf its row sums, from `default_rng(n)`."""
    rng = np.random.default_rng(n)
    p = 8.0 / n if density is None else density
    a = np.triu((rng.uniform(size=(b, n, n)) < p).astype(np.float32), 1)
    a = a + np.swapaxes(a, 1, 2)
    rates = rng.uniform(30, 70, (b, n)).round().astype(np.float32)
    lam = rng.uniform(0, 60, (b, n)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (a, rates, a.sum(1), lam)]


# K1's shapes besides the decision path's: the service's two buckets, the
# kernel's cap and an odd L (rows and instances off 16-byte boundaries)
K1_GENERATED = ((16, 96), (16, 216), (1, 928), (3, 215))


def k1_phase(path_args: dict, dev) -> dict:
    """K1 against `fixed_point_plain` on the paths' own operands and at
    `K1_GENERATED`: within 1e-5 relative at 10 rounds, `num_iters=0` bit for
    bit `rates / (cf + 1)`, two calls bit for bit the same; then its device
    us at 10 rounds and at 0 (the pass over A and mu0 alone), the ns a round
    ((t10 - t0) / 10, with the list build) and the A pass's rate."""
    from multihop_offload_tpu_torch.ops import fixed_point as fp

    shapes = dict(path_args)
    shapes.update({f"{b}x{n}": [t.to(dev) for t in fp_input(b, n)] for b, n in K1_GENERATED})
    out = {}
    for tag, args in shapes.items():
        want = fp.fixed_point_plain(*args)
        got = fp.fixed_point_cuda(*args)
        again = fp.fixed_point_cuda(*args)
        mu0 = fp.fixed_point_cuda(*args, num_iters=0)
        torch.cuda.synchronize()
        b, n = args[1].shape
        rel = ((got - want).abs() / want.abs()).max().item()
        if not rel <= 1e-5:
            raise AssertionError(f"K1 {tag} B,L={(b, n)}: max relative error {rel} > 1e-5")
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {tag} B,L={(b, n)}: two calls differ")
        if not torch.equal(mu0, args[1] / (args[2] + 1.0)):
            raise AssertionError(f"K1 {tag} B,L={(b, n)}: num_iters=0 is not rates / (cf + 1)")
        t10 = clocks(lambda: fp.fixed_point_cuda(*args), 50, kernels_per_call=1)
        t0 = clocks(lambda: fp.fixed_point_cuda(*args, num_iters=0), 50, kernels_per_call=1)
        us10, us0 = t10["device_ms"] * 1e3, t0["device_ms"] * 1e3
        out[tag] = {"shape": [b, n], "max_rel_err": rel,
                    "max_abs_err": (got - want).abs().max().item(),
                    "device_us": us10, "device_us_iters0": us0, "call_us": t10["ms"] * 1e3,
                    "ns_per_round": (us10 - us0) * 100.0,
                    "a_pass_tb_per_s": b * n * n * 4 / (us0 * 1e-6) / 1e12,
                    "bound_us": b * (n * n + 4 * n) * 4 / PEAK_BYTES_PER_S * 1e6}
        log(f"K1 fixed_point {tag} B,L={(b, n)}: max rel err {rel:.3e} vs plain (bar 1e-5), "
            f"num_iters=0 and a second call bit-identical; device us {us10:.2f} at 10 "
            f"rounds, {us0:.2f} at 0: {out[tag]['ns_per_round']:.1f} ns a round, A pass "
            f"{out[tag]['a_pass_tb_per_s']:.3f} TB/s; bound {out[tag]['bound_us']:.2f} us "
            f"(bytes)")
    return out


def k2_phase(path_args: dict, dev, card) -> dict:
    """K2 against its plain closure on the decision path's APSP inputs and
    at `K2_GENERATED` (against `minplus_closure_blocked` above N = 256,
    where the plain version's (N, N, N) temp is too large): bit for bit,
    a launch per squaring, and the squarings run equal to
    `squarings_run_plain`; then its device us (2 + iters kernels a call:
    the input clone, the memset of the flags, the squarings) and call
    us, its tile plan (`ops.minplus.tile_plan`), the candidates a squaring
    computes against B N^3, and the squarings' share of their bound."""
    from multihop_offload_tpu_torch.ops import minplus as mp

    shapes = dict(path_args)
    shapes.update({f"{b}x{n}": (minplus_input(b, n).to(dev), iters)
                   for (b, n), iters in K2_GENERATED.items()})
    out = {}
    for tag, (d, iters) in shapes.items():
        b, n, _ = d.shape
        launches = mp.minplus_closure_cuda.launches
        ex0 = read_counts()["squarings"]
        got = mp.minplus_closure_cuda(d, iters)
        ran = read_counts()["squarings"] - ex0
        ref = (mp.minplus_closure_plain(d, iters) if n <= 256
               else mp.minplus_closure_blocked(d, iters))
        want = mp.squarings_run_plain(d, iters)
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 {tag} B,N={(b, n)}: {int((got != ref).sum())} "
                                 "entries differ")
        if mp.minplus_closure_cuda.launches != launches + iters or ran != want:
            raise AssertionError(f"K2 {tag} B,N={(b, n)}: "
                                 f"{mp.minplus_closure_cuda.launches - launches} launches "
                                 f"(want {iters}), {ran} squarings run "
                                 f"(squarings_run_plain {want})")
        t = clocks(lambda: mp.minplus_closure_cuda(d, iters), 20,
                   kernels_per_call=2 + iters)
        squarings_us = sum(us for name, us in device_us.last["by_name"].items()
                           if "minplus" in name)
        bound_us = max(2.0 * n ** 3 * ran / PEAK_FP32_INSTR_PER_S,
                       2 * b * n * n * 4 / PEAK_BYTES_PER_S) * 1e6
        plan = mp.tile_plan(b, n)
        cand = plan["blocks"] * plan["tile_rows"] * plan["tile_cols"] * n
        out[tag] = {"shape": [b, n], "iters": iters, "squarings_run": ran,
                    "device_us": t["device_ms"] * 1e3, "call_us": t["ms"] * 1e3,
                    "host_us": t["host_us"], "kernels_per_call": t["kernels_per_call"],
                    "squarings_us": squarings_us, "bound_us": bound_us,
                    "share_of_bound": bound_us / squarings_us, "plan": plan,
                    "candidates_over_bn3": cand / (b * n ** 3)}
        log(f"K2 minplus {tag} B,N={(b, n)} iters={iters}: bit-identical to "
            f"{'plain' if n <= 256 else 'the blocked plain closure'} (bar: torch.equal), "
            f"{iters} launches, {ran} of {b * iters} squarings run (= "
            f"squarings_run_plain); tiles {plan['tile_rows']}x{plan['tile_cols']}, "
            f"{plan['threads']} threads in {plan['k_groups']} k-groups, "
            f"{plan['blocks']} blocks a squaring, {plan['smem_bytes']} shared bytes a block; "
            f"candidates a squaring {cand} = {cand / (b * n ** 3):.3f} B N^3; on "
            f"{card['smi']}: device {out[tag]['device_us']:.2f} us "
            f"({t['kernels_per_call']} kernels; the squarings {squarings_us:.2f}), call "
            f"{out[tag]['call_us']:.2f} us; bound {bound_us:.2f} us (operations), "
            f"{out[tag]['share_of_bound']:.3f} of it")
    return out


def kernel_phase(batches, dev, card) -> tuple:
    """Each kernel against its plain version on the same card tensors: K2
    in `k2_phase`, K1 in `k1_phase`.  Returns the errors and K2's and K1's
    per-shape records."""
    errs, apsp_sets, fp_sets = {}, {}, {}
    for tag, (model, inst, jobs) in batches.items():
        d, iters, fp_sets[tag] = kernel_inputs(model, inst, jobs)
        apsp_sets[tag] = (d, iters)
    k2 = k2_phase(apsp_sets, dev, card)
    k1 = k1_phase(fp_sets, dev)
    for tag in batches:
        errs[tag] = {"minplus": 0.0, "fixed_point": k1[tag]["max_abs_err"]}
    return errs, k2, k1


def reset_counts():
    from multihop_offload_tpu_torch.large_scale import reset_kernel_counts
    from multihop_offload_tpu_torch.ops import minplus as mp

    reset_kernel_counts()
    if mp.minplus_closure_cuda.executed is not None:
        mp.minplus_closure_cuda.executed.zero_()


def read_counts() -> dict:
    """Every kernel's launches (and the fixed-point scan's runs) since the
    last `reset_counts`, with K2's executed squarings."""
    from multihop_offload_tpu_torch.large_scale import kernel_counts
    from multihop_offload_tpu_torch.ops import minplus as mp

    torch.cuda.synchronize()
    ex = mp.minplus_closure_cuda.executed
    return {**kernel_counts(), "squarings": 0 if ex is None else int(ex)}


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, max |want|): the JAX package's scaled bar."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item()


def sparse_kernel_phase(batches, dev) -> dict:
    """K4 (forward and backward, F = 4 and 32) and K6 against their plain
    versions on the same card tensors, at the sparse path's shapes."""
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.ops import chebconv as cc
    from multihop_offload_tpu_torch.ops import minplus as mp

    errs = {}
    for tag, inst in batches.items():
        support = sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                           csr=inst.sparse.ext_csr)
        e_ = support.edges
        b, e = support.diag.shape
        gen = torch.Generator(device=dev).manual_seed(0)
        worst = 0.0
        for f in (4, 32):
            x = torch.randn((b, e, f), generator=gen, device=dev).mul_(10.0)
            g = torch.randn((b, e, f), generator=gen, device=dev)
            xk = x.clone().requires_grad_()
            out = cc.chebconv_propagate(support, xk)
            (dx,) = torch.autograd.grad(out, xk, g)
            xp = x.clone().requires_grad_()
            ref = cc.chebconv_propagate_plain(e_.rows, e_.cols, e_.vals, support.diag, xp)
            (dx_ref,) = torch.autograd.grad(ref, xp, g)
            fwd, bwd = scaled_err(out, ref), scaled_err(dx, dx_ref)
            log(f"K4 chebconv {tag} B,E,F={(b, e, f)} nnz pad {e_.rows.shape[1]}: "
                f"forward scaled err {fwd:.3e}, backward {bwd:.3e} vs plain "
                f"(bar {CHEB_SCALED_TOL})")
            if not (fwd <= CHEB_SCALED_TOL and bwd <= CHEB_SCALED_TOL):
                raise AssertionError(f"K4 {tag} F={f}: scaled errors {fwd}, {bwd}")
            worst = max(worst, (out - ref).abs().max().item(), (dx - dx_ref).abs().max().item())
        n = inst.num_pad_nodes
        for which, delays in (("baseline", 1.0 / inst.link_rates),
                              ("noisy", 1.0 / (inst.link_rates * torch.rand(
                                  inst.link_rates.shape, generator=gen, device=dev).add_(0.5)))):
            got = mp.apsp_coo_cuda(inst.link_ends, inst.link_mask, delays.contiguous(), n)
            ref = mp.apsp_coo_plain(inst.link_ends, inst.link_mask, delays, n)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"K6 {tag} {which}: {bad} entries differ")
        log(f"K6 coo_apsp {tag} B,N={(b, n)}: bit-identical to the plain chain "
            f"(bar: torch.equal)")
        errs[tag] = {"chebconv": worst, "coo_apsp": 0.0}
    return errs


def episode_cosines(card: dict, cpu: dict) -> torch.Tensor:
    """(B,) cosine of each episode's flattened gradient, card vs CPU."""
    a = torch.cat([g.cpu().flatten(1) for g in card.values()], dim=1).double()
    b = torch.cat([g.flatten(1) for g in cpu.values()], dim=1).double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-300)


def outcomes(model, inst, jobs, device, layout=None):
    from multihop_offload_tpu_torch.agent.policy import forward_env
    from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy

    with torch.no_grad():
        inst, jobs = inst.to(device), jobs.to(device)
        return {"baseline": baseline_policy(inst, jobs, layout=layout),
                "local": local_policy(inst, jobs, layout=layout),
                "gnn": forward_env(model, inst, jobs, device=device, layout=layout)[0]}


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


def large_phase(dev, card) -> dict:
    """Slice 3: the large-graph path at N=1,024.  K3 against its plain
    version on the path's own predicted-delay matrix; the three calls of
    the path with counts set to 0 just before and read just after each;
    card against CPU; then K3's and the paths' times."""
    from multihop_offload_tpu_torch.agent.actor import actor_delay_matrix, default_support
    from multihop_offload_tpu_torch.agent.policy import forward_env
    from multihop_offload_tpu_torch.agent.train_step import forward_backward
    from multihop_offload_tpu_torch.env.apsp import weight_matrix_from_link_delays
    from multihop_offload_tpu_torch.graphs.cases import large_request, load_large_case
    from multihop_offload_tpu_torch.large_scale import MODEL
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.train.driver import eval_methods

    t0 = time.perf_counter()
    case = load_large_case()
    inst_cpu, jobs_cpu, pad = large_request(case, device="cpu")
    inst, jobs = inst_cpu.to(dev), jobs_cpu.to(dev)
    model_cpu = load_model(MODEL, device="cpu")
    model = load_model(MODEL, device=dev)
    paths = {"apsp": mp.apsp_path(pad.n), "fixed_point": fp.fixed_point_path(pad.l)}
    log(f"large case: n={case.rec.topo.n}, {case.rec.topo.num_links} links, "
        f"{int(jobs_cpu.mask.sum())} jobs; {pad}, E={pad.e}; paths {paths}; "
        f"built on the host in {time.perf_counter() - t0:.2f} s")
    if paths != {"apsp": "blocked-fw", "fixed_point": "scan"}:
        raise AssertionError(f"large path: unexpected paths {paths}")

    # ---- K3 on the path's own predicted-delay matrix ------------------------
    with torch.no_grad():
        actor = actor_delay_matrix(model, inst, jobs, default_support(model, inst))
        w = weight_matrix_from_link_delays(inst.adj, inst.link_index, actor.link_delay)
        eye = torch.eye(pad.n, dtype=torch.bool, device=dev)
        d = torch.where(eye, 0.0, w).contiguous()
    got = mp.blocked_fw_cuda(d)
    ref = mp.blocked_fw_plain(d)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"K3 {tuple(d.shape)}: {int((got != ref).sum())} entries "
                             "differ from the plain version on the card")
    ref_cpu = mp.blocked_fw_plain(d.cpu())
    if not torch.equal(got.cpu(), ref_cpu):
        raise AssertionError(f"K3 {tuple(d.shape)}: {int((got.cpu() != ref_cpu).sum())} "
                             "entries differ from the plain version on the CPU")
    log(f"K3 blocked_fw large B,N={tuple(d.shape[:2])} on the GNN's predicted delays: "
        f"bit-identical to plain on the card and on the CPU (bar: torch.equal); "
        f"{int(torch.isinf(got).sum())} entries +inf")
    # the pivot alone (one launch), and three rounds, on the gpu test's input
    d384 = fw_input(2, 384)
    small = {"1x128": d384[:1, :128, :128].contiguous(), "2x384": d384,
             "132x128": fw_input(132, 128)}
    for tag, x in small.items():
        x_card = x.to(dev)
        got_s = mp.blocked_fw_cuda(x_card)
        ref_s = mp.blocked_fw_plain(x_card)
        torch.cuda.synchronize()
        bad = (int((got_s != ref_s).sum()),
               int((got_s.cpu() != mp.blocked_fw_plain(x)).sum()))
        if bad != (0, 0):
            raise AssertionError(f"K3 {tag}: {bad} entries differ from the plain version "
                                 "on the card, on the CPU")
        small[tag] = x_card
    log(f"K3 blocked_fw B,N in {list(small)} (default_rng inputs): bit-identical to plain "
        f"on the card and on the CPU (bar: torch.equal)")

    # ---- main path: counts at 0 just before each call, read just after ------
    calls = {"eval_methods": lambda: eval_methods(model, inst, jobs),
             "forward_env": lambda: forward_env(model, inst, jobs),
             "forward_backward": lambda: forward_backward(model, inst, jobs)}
    counts, results = {}, {}
    for name, call in calls.items():
        reset_counts()
        results[name] = call()
        counts[name] = read_counts()
        log(f"large path {name} (B=1, N={pad.n}): launches {counts[name]}")
        c = counts[name]
        if c["blocked_fw"] == 0 or c["fixed_point"] != 0 or c["fixed_point_scan"] == 0:
            raise AssertionError(f"large {name}: K3 must launch, K1 not, the scan run: {c}")
    fb = results["forward_backward"]
    if not (torch.isfinite(fb.loss_critic).all()
            and all(torch.isfinite(g).all() for g in fb.grads.values())):
        raise AssertionError("large forward_backward: non-finite loss or gradients")

    # ---- card against CPU (float32, plain versions) --------------------------
    t1 = time.perf_counter()
    compare("large", outcomes(model, inst, jobs, dev),
            outcomes(model_cpu, inst_cpu, jobs_cpu, "cpu"), jobs_cpu.mask)
    log(f"large card-vs-CPU check took {time.perf_counter() - t1:.2f} s")

    # ---- timing --------------------------------------------------------------
    n, b = pad.n, 1
    iters = mp.squaring_count(n)
    nb = n // mp.FW_TILE
    # the launches of a call, and the wrapper's copy of its input
    k3 = clocks(lambda: mp.blocked_fw_cuda(d), 50, kernels_per_call=3 * nb + 1)
    k3_ms = k3["ms"]
    # device us per phase, and ns per pivot step (n steps a call, for the
    # whole batch at once), at the path's shape and at one pivot block
    phases = {"1x1024": k3_phase_us(device_us.last)}
    lost = {"1x1024": device_us.last["lost_records"]}
    for tag in ("1x128", "132x128"):
        x = small[tag]
        device_us(lambda x=x: mp.blocked_fw_cuda(x), 50, kernels_per_call=2)
        phases[tag] = k3_phase_us(device_us.last)
        lost[tag] = device_us.last["lost_records"]
    ns_per_step = {tag: ph["pivot"] * 1e3 / int(tag.split("x")[1])
                   for tag, ph in phases.items()}
    k3_plain_ms = cuda_ms(lambda: mp.blocked_fw_plain(d), 3, warmup=1)
    k2_ms = cuda_ms(lambda: mp.minplus_closure_cuda(d, iters), 5, warmup=1)
    # one sweep makes N^3 candidates per matrix, 2 instructions each (add,
    # then min; no tensor-core path); bytes: d read once, the result written
    k3_ops_ms = 2.0 * b * n ** 3 / PEAK_FP32_INSTR_PER_S * 1e3
    k3_bytes_ms = 2 * b * n * n * 4 / PEAK_BYTES_PER_S * 1e3
    env_ms = wall_ms(lambda: forward_env(model, inst, jobs), 5)
    eval_ms = wall_ms(lambda: eval_methods(model, inst, jobs), 5)
    fb_ms = wall_ms(lambda: forward_backward(model, inst, jobs), 3)
    torch.cuda.reset_peak_memory_stats()
    eval_methods(model, inst, jobs)
    forward_backward(model, inst, jobs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"timing on {card['smi']}: K3 blocked_fw B,N={(b, n)} per APSP call ({3 * nb} "
        f"launches): device {k3['device_ms'] * 1e3:.1f} us ({k3['kernels_per_call']:.0f} "
        f"kernels), call {k3_ms * 1e3:.1f} us, host {k3['host_us']:.1f} us; plain "
        f"{k3_plain_ms:.3f} ms, bound "
        f"{max(k3_ops_ms, k3_bytes_ms) * 1e3:.1f} us (operations); K2 squaring on the "
        f"same matrix ({iters} launches) {k2_ms * 1e3:.1f} us")
    for tag, ph in phases.items():
        log(f"timing on {card['smi']}: K3 blocked_fw B,N={tag} device us per call by "
            f"phase: pivot {ph['pivot']:.2f} ({ns_per_step[tag]:.1f} ns per step), panels "
            f"{ph['panels']:.2f}, outer {ph['outer']:.2f}, input clone {ph['clone']:.2f} "
            f"({lost[tag]} trace records lost of 50 calls)")
    log(f"large path: forward_env {env_ms:.2f} ms, eval_methods {eval_ms:.2f} ms per "
        f"request, forward_backward {fb_ms:.2f} ms per episode; peak memory "
        f"{peak / 2**20:.1f} MiB (max_memory_allocated, eval_methods + forward_backward)")
    return {"counts": counts, "shape": [b, n], "launches_per_call": 3 * nb,
            "ms": k3_ms, "device_ms": k3["device_ms"], "plain_ms": k3_plain_ms,
            "squaring_ms": k2_ms, "phase_device_us": phases,
            "pivot_ns_per_step": ns_per_step,
            "bound_ms": max(k3_ops_ms, k3_bytes_ms),
            "bound_by": "operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
            "forward_env_ms": env_ms, "eval_methods_ms": eval_ms,
            "forward_backward_ms": fb_ms, "peak_mib": peak / 2**20}


def closed_loop(svc, reqs) -> list:
    """`cli/serve.py:main`'s closed loop over `reqs`, then `drain()`:
    keep the queue full, tick, refill; returns every response."""
    pending = list(reversed(reqs))
    responses = []
    while pending or svc.queue_depth:
        while pending:
            req = pending.pop()
            if not svc.submit(req):
                if svc.last_submit_outcome == "backpressure":
                    pending.append(req)
                break
        responses += svc.tick()
    return responses + svc.drain()


def check_conservation(tag, svc, responses) -> dict:
    """Every admitted request answered exactly once; returns them by id."""
    ids = [r.request_id for r in responses]
    if len(ids) != len(set(ids)) or len(ids) != svc.stats.admitted:
        raise AssertionError(f"{tag}: {len(ids)} responses ({len(set(ids))} distinct) "
                             f"for {svc.stats.admitted} admitted requests")
    for r in responses:
        if r.dst.shape != r.job_total.shape or not np.isfinite(r.job_total).all():
            raise AssertionError(f"{tag}: request {r.request_id} bad outputs")
    return {r.request_id: r for r in responses}


def compare_responses(tag, got: dict, want: dict, rtol: float) -> dict:
    """Decisions of the same requests from two runs: dst and is_local
    agreement over all jobs (bar 0.99, mismatches printed); on requests
    whose decisions all agree, delay_est and job_total within `rtol`."""
    n_jobs = n_diff = 0
    worst = 0.0
    for rid, w in want.items():
        g = got[rid]
        if g.served_by != w.served_by or g.bucket != w.bucket:
            raise AssertionError(f"{tag}: request {rid} served by {g.served_by}/"
                                 f"{g.bucket}, not {w.served_by}/{w.bucket}")
        diff = (g.dst != w.dst) | (g.is_local != w.is_local)
        n_jobs += diff.size
        n_diff += int(diff.sum())
        if diff.any():
            log(f"{tag}: request {rid} jobs {np.flatnonzero(diff).tolist()} differ: "
                f"dst {g.dst[diff].tolist()} vs {w.dst[diff].tolist()} (near-tie)")
            continue
        for a, b in ((g.delay_est, w.delay_est), (g.job_total, w.job_total)):
            rel = np.abs(a.astype(np.float64) - b) / np.abs(b.astype(np.float64))
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
    agree = 1.0 - n_diff / max(n_jobs, 1)
    log(f"{tag}: {n_diff} of {n_jobs} jobs differ in dst/is_local (agreement "
        f"{agree:.4f}, bar 0.99); delay_est/job_total max rel err {worst:.3e} "
        f"(bar {rtol}) on requests whose decisions all agree")
    if agree < 0.99 or not worst <= rtol:
        raise AssertionError(f"{tag}: agreement {agree}, rel err {worst}")
    return {"jobs": n_jobs, "differ": n_diff, "max_rel_err": worst}


def serving_phase(dev, card) -> dict:
    """Slice 4: the offloading-decision service through `cli/serve.py:
    build_service`, closed loop over 256 requests of the BA pool n = 20, 50,
    80, 110 at 16 slots: plain ticks (K1, K2), ragged + overlap, a tick past
    the deadline, the sparse layout with SPECTRAL_K2 (K1, K4, K6), and the
    first 64 requests again on the CPU."""
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.env.policies import baseline_policy
    from multihop_offload_tpu_torch.obs.spans import phase_stats, reset_phases
    from multihop_offload_tpu_torch.serve.bucketing import pack_bucket
    from multihop_offload_tpu_torch.serve.workload import case_pool, request_stream

    pool = case_pool([20, 50, 80, 110], per_size=2, seed=0)
    reqs = list(request_stream(pool, 256, seed=1, arrival_scale=0.15))
    base = dict(serve_slots=16, serve_queue_cap=64, serve_deadline_s=60.0,
                serve_model=MODEL_K1)
    cfg = Config(**base)
    warm, _ = build_service(cfg, pool=pool, device=dev)
    log(f"serving pool: {[p for p in warm.buckets.pads]}")
    closed_loop(warm, reqs)  # the warm-up pass
    torch.cuda.synchronize()

    # ---- run 1: plain ticks, counts at 0 just before, read just after --------
    svc, _ = build_service(cfg, pool=pool, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_phases()
    reset_counts()
    t0 = time.monotonic()
    plain = closed_loop(svc, reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    plain_by_id = check_conservation("serve plain", svc, plain)
    summary = svc.stats.summary(wall_s=wall)
    log(f"serve plain (dense, {MODEL_K1}, 16 slots): launches {counts}")
    if counts["fixed_point"] == 0 or counts["minplus"] == 0:
        raise AssertionError(f"serve plain: K1 and K2 must launch: {counts}")
    ticks = summary["ticks"]
    host = dict(svc.executor.host_s)
    spans = phase_stats()
    stats = {"requests_per_s": summary["requests_per_sec"],
             "p50_ms": summary["latency"]["p50_ms"], "p99_ms": summary["latency"]["p99_ms"],
             "dispatches_per_request": summary["dispatches_per_request"],
             "ticks": ticks, "mean_tick_ms": wall / ticks * 1e3,
             "launches_per_tick": {k: v / ticks for k, v in counts.items()
                                   if k != "squarings"},
             "dispatch_host_ms": host["dispatch"] * 1e3,
             "fetch_host_ms": host["fetch"] * 1e3,
             "tick_host_ms": spans["serve/tick"]["total_s"] * 1e3,
             "pack_host_ms": spans["serve/pack"]["total_s"] * 1e3,
             "peak_mib": peak / 2**20, "served": summary["served"],
             "degraded": summary["degraded"]}
    log(f"serving on {card['smi']}: {stats['requests_per_s']} requests/s over "
        f"{summary['served']} requests; latency p50 {stats['p50_ms']:.2f} ms, p99 "
        f"{stats['p99_ms']:.2f} ms; {stats['dispatches_per_request']} dispatches per "
        f"request; {ticks} ticks, mean tick {stats['mean_tick_ms']:.2f} ms")
    log(f"serving on {card['smi']}: launches per tick "
        f"{ {k: round(v, 2) for k, v in stats['launches_per_tick'].items()} }; host ms "
        f"in ticks {stats['tick_host_ms']:.1f}: pack {stats['pack_host_ms']:.1f}, "
        f"dispatch {stats['dispatch_host_ms']:.1f}, fetch {stats['fetch_host_ms']:.1f}; "
        f"peak memory {stats['peak_mib']:.1f} MiB (max_memory_allocated)")

    # ---- run 2: ragged + overlap on the same stream --------------------------
    rcfg = Config(**base, serve_ragged=True, serve_overlap=True)
    rsvc, _ = build_service(rcfg, pool=pool, device=dev)
    reset_counts()
    t0 = time.monotonic()
    ragged = check_conservation("serve ragged+overlap", rsvc, closed_loop(rsvc, reqs))
    torch.cuda.synchronize()
    rwall = time.monotonic() - t0
    rcounts = read_counts()
    rsum = rsvc.stats.summary(wall_s=rwall)
    stats["ragged"] = {
        "requests_per_s": rsum["requests_per_sec"], "p50_ms": rsum["latency"]["p50_ms"],
        "p99_ms": rsum["latency"]["p99_ms"], "ticks": rsum["ticks"],
        "mean_tick_ms": rwall / rsum["ticks"] * 1e3,
        "transitions": len(rsvc.ladder.transitions),
        "widths": sorted({w for _, w in rsvc.executor.dispatches_by_width}),
        "dispatch_host_ms": rsvc.executor.host_s["dispatch"] * 1e3,
        "fetch_host_ms": rsvc.executor.host_s["fetch"] * 1e3,
        "vs_plain": compare_responses("serve ragged+overlap vs plain", ragged,
                                      plain_by_id, 1e-5)}
    log(f"serving ragged+overlap on {card['smi']}: {rsum['requests_per_sec']} requests/s,"
        f" p50 {stats['ragged']['p50_ms']:.2f} ms, p99 {stats['ragged']['p99_ms']:.2f} ms,"
        f" {rsum['ticks']} ticks, widths {stats['ragged']['widths']}, "
        f"{stats['ragged']['transitions']} ladder transitions; launches {rcounts}")

    # ---- run 3: one tick past the deadline on an injected clock --------------
    t = [100.0]
    dsvc, _ = build_service(Config(**{**base, "serve_deadline_s": 0.5}), pool=pool,
                            clock=lambda: t[0], device=dev)
    req = reqs[0]
    if not dsvc.submit(req):
        raise AssertionError("deadline run: the request was refused")
    t[0] += 10.0
    (resp,) = dsvc.tick()
    b = dsvc.buckets.bucket_for(*req.sizes)
    binst, bjobs = pack_bucket([req], dsvc.buckets[b], 1, device=dev)
    with torch.no_grad():
        want = baseline_policy(binst, bjobs).decision.dst[0, :req.num_jobs].cpu().numpy()
    if resp.served_by != "baseline" or not np.array_equal(resp.dst, want):
        raise AssertionError(f"deadline run: served by {resp.served_by}, dst "
                             f"{resp.dst.tolist()} vs baseline {want.tolist()}")
    log("serve deadline: the late tick was served by the baseline, dst equal to "
        "baseline_policy on that request")

    # ---- run 4: the sparse layout with SPECTRAL_K2 on the first 64 -----------
    scfg = Config(**{**base, "serve_model": MODEL_K2}, layout="sparse", cheb_k=2)
    ssvc, _ = build_service(scfg, pool=pool, device=dev)
    closed_loop(ssvc, reqs[:16])  # warm-up
    ssvc, _ = build_service(scfg, pool=pool, device=dev)
    reset_counts()
    t0 = time.monotonic()
    sparse_by_id = check_conservation("serve sparse", ssvc, closed_loop(ssvc, reqs[:64]))
    torch.cuda.synchronize()
    swall = time.monotonic() - t0
    scounts = read_counts()
    log(f"serve sparse ({MODEL_K2}, 64 requests): launches {scounts}; "
        f"{len(sparse_by_id) / swall:.1f} requests/s on {card['smi']}")
    for key in ("fixed_point", "chebconv", "coo_apsp"):
        if scounts[key] == 0:
            raise AssertionError(f"serve sparse: {key} did not launch: {scounts}")
    stats["sparse"] = {"requests_per_s": len(sparse_by_id) / swall,
                       "ticks": ssvc.stats.ticks}

    # ---- run 5: the first 64 requests re-served on the CPU -------------------
    t1 = time.perf_counter()
    csvc, _ = build_service(cfg, pool=pool, device="cpu")
    cpu_by_id = check_conservation("serve cpu", csvc, closed_loop(csvc, reqs[:64]))
    stats["card_vs_cpu"] = compare_responses(
        "serve card vs CPU (first 64)", {k: plain_by_id[k] for k in cpu_by_id},
        cpu_by_id, 1e-4)
    log(f"serve card-vs-CPU check took {time.perf_counter() - t1:.2f} s")
    stats["counts"] = {"serve_plain": counts, "serve_ragged_overlap": rcounts,
                       "serve_sparse": scounts}
    stats["sparse_bucket1"] = [r for r in reqs if ssvc.buckets.bucket_for(*r.sizes) == 1][:16]
    return stats


def ragged_kernel_phase(dev, card, reqs) -> dict:
    """K5 against its plain version on the sparse serving bucket 1's packed
    extended support (16 slots, E = 328; live = each slot's real entries),
    sorted and with each live prefix permuted, at F = 4 and 32, and on the
    JAX test's case; then its times beside K4, torch.sparse.mm and the
    bound."""
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.ops import chebconv as cc
    from multihop_offload_tpu_torch.serve.bucketing import pack_bucket
    from multihop_offload_tpu_torch.serve.workload import buckets_for_pool, case_pool

    pad = buckets_for_pool(case_pool([20, 50, 80, 110], per_size=2, seed=0)).pads[1]
    inst, _ = pack_bucket(reqs, pad, 16, layout="sparse", device=dev)
    support = sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                       csr=inst.sparse.ext_csr)
    e_, csr = support.edges, support.csr
    b, e = support.diag.shape
    cap = e_.rows.shape[1]
    live = (inst.sparse.ext.vals != 0).sum(1).to(torch.int32)
    full = torch.full_like(live, cap)
    gen = torch.Generator(device=dev).manual_seed(4)
    perm_rows, perm_cols, perm_vals = e_.rows.clone(), e_.cols.clone(), e_.vals.clone()
    for k in range(b):
        n = int(live[k])
        p = torch.randperm(n, generator=gen, device=dev)
        perm_rows[k, :n], perm_cols[k, :n] = e_.rows[k, :n][p], e_.cols[k, :n][p]
        perm_vals[k, :n] = e_.vals[k, :n][p]
    rng = np.random.default_rng(37)  # tests/test_ops.py's ragged case
    j_rows = np.zeros((1, 300), np.int32)
    j_cols = np.zeros((1, 300), np.int32)
    j_vals = np.zeros((1, 300), np.float32)
    j_rows[0, :17] = rng.integers(0, 12, 17)
    j_cols[0, :17] = rng.integers(0, 12, 17)
    j_vals[0, :17] = rng.normal(size=17).astype(np.float32)
    j_diag = rng.normal(size=(1, 12)).astype(np.float32)
    j_x = rng.normal(size=(1, 12, 6)).astype(np.float32)
    cases = {"sorted": (e_.rows, e_.cols, e_.vals, support.diag, live, (4, 32)),
             "permuted": (perm_rows, perm_cols, perm_vals, support.diag, live, (4, 32)),
             "jax-test": tuple(torch.from_numpy(a).to(dev) for a in
                               (j_rows, j_cols, j_vals, j_diag))
             + (torch.tensor([17], dtype=torch.int32, device=dev), (6,))}
    # the sort against its plain version, exactly, at live, capacity and 0
    for tag, (rows, cols, vals, diag, lv, widths) in cases.items():
        e_tag = diag.shape[1]
        for which, counts in (("live", lv), ("capacity", torch.full_like(lv, rows.shape[1])),
                              ("zero", torch.zeros_like(lv))):
            got = cc.ragged_index_cuda(rows, cols, counts, e_tag)
            want = cc.ragged_index_plain(rows.cpu(), cols.cpu(), counts.cpu(), e_tag)
            torch.cuda.synchronize()
            for field in ("row_ptr", "row_order", "col_ptr", "col_order"):
                if not torch.equal(getattr(got, field).cpu(), getattr(want, field)):
                    raise AssertionError(f"ragged_index {tag} at {which}: {field} differs "
                                         "from ragged_index_plain")
        log(f"ragged_index {tag} B,E,cap={(rows.shape[0], e_tag, rows.shape[1])}: equal to "
            f"ragged_index_plain at live, capacity and 0 (bar: torch.equal)")
    launches0 = (cc.ragged_index_cuda.launches, cc.chebconv_propagate_cuda.launches)
    worst = {}
    for tag, (rows, cols, vals, diag, lv, widths) in cases.items():
        for f in widths:
            x = (torch.from_numpy(j_x).to(dev) if tag == "jax-test" else
                 torch.randn((b, e, f), generator=gen, device=dev).mul_(10.0))
            g = torch.randn(x.shape, generator=gen, device=dev)
            xk = x.clone().requires_grad_()
            out = cc.chebconv_propagate_ragged(rows, cols, vals, diag, xk, lv)
            (dx,) = torch.autograd.grad(out, xk, g)
            xp = x.clone().requires_grad_()
            ref = cc.chebconv_propagate_ragged_plain(rows, cols, vals, diag, xp, lv)
            (dx_ref,) = torch.autograd.grad(ref, xp, g)
            at_cap = cc.chebconv_propagate_ragged_cuda(
                rows, cols, vals, diag, x, torch.full_like(lv, rows.shape[1]))
            zero = cc.chebconv_propagate_ragged_cuda(rows, cols, vals, diag, x,
                                                     torch.zeros_like(lv))
            cpu = cc.chebconv_propagate_ragged_plain(rows.cpu(), cols.cpu(), vals.cpu(),
                                                     diag.cpu(), x.cpu(), lv.cpu())
            torch.cuda.synchronize()
            fwd, bwd = scaled_err(out, ref), scaled_err(dx, dx_ref)
            same_cap = torch.equal(at_cap, out.detach())
            diag_only = torch.equal(zero, diag[..., None] * x)
            log(f"K5 chebconv_ragged {tag} B,E,F={tuple(x.shape)} cap {rows.shape[1]}: "
                f"forward scaled err {fwd:.3e}, d x {bwd:.3e} vs plain on the card (bar "
                f"{CHEB_SCALED_TOL}); bit-identical to plain on the card "
                f"{torch.equal(out.detach(), ref.detach())}, on the CPU "
                f"{torch.equal(out.detach().cpu(), cpu)}; at live == at capacity "
                f"{same_cap}; live 0 == diag * x {diag_only}")
            if not (fwd <= CHEB_SCALED_TOL and bwd <= CHEB_SCALED_TOL and same_cap
                    and diag_only):
                raise AssertionError(f"K5 {tag} F={f}: scaled errors {fwd}, {bwd}, "
                                     f"live==cap {same_cap}, live 0 {diag_only}")
            worst[(tag, f)] = (out - ref).abs().max().item()
    launches = {"ragged_index": cc.ragged_index_cuda.launches - launches0[0],
                "walk": cc.chebconv_propagate_cuda.launches - launches0[1]}

    # ---- timing on the sorted lists ------------------------------------------
    n_live = int(live.sum())
    off = (torch.arange(b, device=dev) * e).unsqueeze(1)
    keep = torch.arange(cap, device=dev) < live.unsqueeze(1)
    diag_ids = torch.arange(b * e, device=dev)
    block = torch.sparse_coo_tensor(
        torch.stack([torch.cat([(e_.rows.long() + off)[keep], diag_ids]),
                     torch.cat([(e_.cols.long() + off)[keep], diag_ids])]),
        torch.cat([e_.vals[keep], support.diag.reshape(-1)]),
        (b * e, b * e)).coalesce().to_sparse_csr()
    timing = {}
    for f in (4, 32):
        x = torch.randn((b, e, f), generator=gen, device=dev)
        args = (e_.rows, e_.cols, e_.vals, support.diag, x)
        t_live = clocks(lambda: cc.chebconv_propagate_ragged_cuda(*args, live), 200)
        t_cap = clocks(lambda: cc.chebconv_propagate_ragged_cuda(*args, full), 100)
        t_k4 = clocks(lambda: cc.chebconv_propagate_cuda(
            csr.row_ptr, None, e_.cols, e_.vals, support.diag, x), 200)
        t_lib = clocks(lambda: torch.sparse.mm(block, x.view(b * e, f)), 100)
        t_plain = cuda_ms(lambda: cc.chebconv_propagate_ragged_plain(*args, live), 50)
        # bytes: each live (row, col, val) entry, diag, x and out once
        k5_bytes = (n_live * 12 + b * e * 4 + 2 * b * e * f * 4) / PEAK_BYTES_PER_S * 1e3
        k5_ops = 2.0 * (n_live + b * e) * f / PEAK_FP32_FLOP_PER_S * 1e3
        timing[f] = {"ms": t_live["ms"], "device_ms": t_live["device_ms"],
                     "host_us": t_live["host_us"],
                     "launches_per_call": t_live["kernels_per_call"],
                     "capacity_ms": t_cap["ms"], "capacity_device_ms": t_cap["device_ms"],
                     "k4_ms": t_k4["ms"], "k4_device_ms": t_k4["device_ms"],
                     "library_ms": t_lib["ms"], "library_device_ms": t_lib["device_ms"],
                     "plain_ms": t_plain, "bound_ms": max(k5_bytes, k5_ops),
                     "bound_by": "bytes" if k5_bytes >= k5_ops else "operations"}
        log(f"timing on {card['smi']}: K5 chebconv_ragged B,E,F={(b, e, f)} "
            f"({n_live} live of {b * cap} entries) at live: device "
            f"{t_live['device_ms'] * 1e3:.2f} us ({t_live['kernels_per_call']:.0f} kernels; "
            f"call {t_live['ms'] * 1e3:.2f}, host {t_live['host_us']:.2f}); at capacity: "
            f"device {t_cap['device_ms'] * 1e3:.2f} us (call {t_cap['ms'] * 1e3:.2f}); K4 on "
            f"the same sorted lists: device {t_k4['device_ms'] * 1e3:.2f} us (call "
            f"{t_k4['ms'] * 1e3:.2f}); torch.sparse.mm device "
            f"{t_lib['device_ms'] * 1e3:.2f} us (call {t_lib['ms'] * 1e3:.2f}); plain "
            f"{t_plain * 1e3:.2f} us; bound {timing[f]['bound_ms'] * 1e3:.3f} us "
            f"({timing[f]['bound_by']})")
    # the sort alone (it reads no x); its bound: rows and cols of the live
    # prefix read once, both pointers and both orders written once (it does
    # no arithmetic to speak of)
    t_sort = clocks(lambda: cc.ragged_index_cuda(e_.rows, e_.cols, live, e), 200)
    t_sort_cap = clocks(lambda: cc.ragged_index_cuda(e_.rows, e_.cols, full, e), 200)
    t_sort_plain = cuda_ms(lambda: cc.ragged_index_plain(e_.rows, e_.cols, live, e), 50)
    sort_bytes_ms = (n_live * 8 + b * 4 + b * 2 * (e + 1 + cap) * 4) / PEAK_BYTES_PER_S * 1e3
    sort = {"ms": t_sort["ms"], "device_ms": t_sort["device_ms"],
            "host_us": t_sort["host_us"], "capacity_ms": t_sort_cap["ms"],
            "capacity_device_ms": t_sort_cap["device_ms"], "plain_ms": t_sort_plain,
            "bound_ms": sort_bytes_ms, "bound_by": "bytes", "library_ms": None}
    log(f"timing on {card['smi']}: ragged_index (the sort) B,E,cap={(b, e, cap)}: device "
        f"{sort['device_ms'] * 1e3:.2f} us at live (call {sort['ms'] * 1e3:.2f}, host "
        f"{sort['host_us']:.2f}), device {sort['capacity_device_ms'] * 1e3:.2f} us at "
        f"capacity; plain {t_sort_plain * 1e3:.2f} us; bound {sort_bytes_ms * 1e3:.3f} us "
        f"(bytes)")
    return {"launches": launches, "max_abs_err": worst[("sorted", 32)],
            "max_abs_err_all": max(worst.values()), "shape": [b, e, 32],
            "cap": cap, "nnz_live": n_live, "timing": timing, "sort": sort}


def read_csv_rows(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def compare_eval_rows(tag: str, got: list, want: list) -> dict:
    """Evaluator CSV rows against rows of the same files (the `runtime`
    column excluded): strings and integers equal; `baseline` and `local`
    rows with identical `congest_jobs` and `tau`, `gap_2_bl` and
    `gnn_bl_ratio` each within rtol 1e-4; `GNN` rows meeting the same bars
    on at least 99% of them, mismatches printed."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} rows against {len(want)}")
    ints = ("seed", "num_nodes", "m", "num_mobile", "num_servers", "num_relays",
            "num_jobs", "n_instance")
    floats = ("tau", "gap_2_bl", "gnn_bl_ratio")
    bad = {"baseline": 0, "local": 0, "GNN": 0}
    worst = dict.fromkeys(floats, 0.0)
    for g, w in zip(got, want):
        if any(g[k] != w[k] for k in ("filename", "Algo") + ints):
            raise AssertionError(f"{tag}: rows out of step: {g} against {w}")
        rel = {}
        for k in floats:
            a, b = float(g[k]), float(w[k])
            rel[k] = 0.0 if a == b else abs(a - b) / abs(b)
        if g["congest_jobs"] != w["congest_jobs"] or not all(r <= 1e-4 for r in rel.values()):
            bad[g["Algo"]] += 1
            log(f"  {tag} mismatch: {g['filename']} n_instance {g['n_instance']} "
                f"{g['Algo']}: " + ", ".join(f"{k} {g[k]} against {w[k]}" for k in floats)
                + f", congest_jobs {g['congest_jobs']} against {w['congest_jobs']}")
        else:
            worst = {k: max(worst[k], rel[k]) for k in floats}
    n_gnn = sum(r["Algo"] == "GNN" for r in want)
    log(f"{tag}: {len(got)} rows; mismatched baseline {bad['baseline']}, local "
        f"{bad['local']}, GNN {bad['GNN']} of {n_gnn}; max rel err over the matching "
        f"rows: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    if bad["baseline"] or bad["local"] or bad["GNN"] > 0.01 * n_gnn:
        raise AssertionError(f"{tag}: rows disagree beyond the bars: {bad}")
    return {"rows": len(got), "mismatched": bad, "tau_max_rel_err": worst["tau"],
            "gap_2_bl_max_rel_err": worst["gap_2_bl"],
            "gnn_bl_ratio_max_rel_err": worst["gnn_bl_ratio"]}


def busy_share(fn, wall_ms: float) -> dict:
    """One call of `fn` under `torch.profiler`: the card's busy ms (the
    union of its kernel, copy and memset intervals on the device clock)
    over `wall_ms`, the unprofiled wall time of the same call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    # record_function ranges show on the device timeline too: drop every
    # name the host side also has
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in host)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"busy_ms": busy / 1e3, "wall_ms": wall_ms, "share": busy / 1e3 / wall_ms,
            "device_records": len(spans)}


def file_ms(log_path: str) -> list:
    """Host ms of each file visit after the first, from a driver run log:
    the gaps between consecutive `step` events (the whole visit: build,
    device work, metrics, replay, checkpoint and CSV)."""
    from multihop_offload_tpu_torch.obs.events import read_events

    ts = [e["ts"] for e in read_events(log_path) if e.get("event") == "step"]
    return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]


def span_ms(names, visits: int) -> dict:
    """Host ms per visit in each named span since the last `reset_phases`."""
    from multihop_offload_tpu_torch.obs.spans import phase_stats

    stats = phase_stats()
    return {n: stats[n]["total_s"] * 1e3 / visits for n in names if n in stats}


def driver_phase(dev, card) -> dict:
    """Slice 12: the Evaluator and the Trainer over the committed paper
    dataset (`data/aco_data_ba_paper`: 20 files, B = 10 job sets a file,
    load 0.15, T 1000), all output in a temporary directory.  The
    Evaluator with the model of record (dense): K1 4 launches and K2 2 APSP
    calls on every file; 20 x 10 x 3 rows in `TEST_COLUMNS`; the first 4
    files again on the CPU and the whole set at `file_batch=4`, both
    against these rows.  The Trainer through `cli/train.py:main` (sparse,
    K=2, fresh init, 1 epoch, batch 100, memory 5000, so replay starts at
    the 10th file): on every file, the training step launches K1 3, K4 9,
    K6 1 and K2 7 and its `eval_methods` K1 4, K4 5, K6 2 and K2 14, each
    read on its own; 20 x 10 x 4 rows in `TRAIN_COLUMNS`, `tau` finite; the parameters
    changed; `try_restore` bit for bit; a second `main` resumes past the
    saved steps.  Then the host ms per file and the card's busy share over
    one file of each."""
    import shutil
    import tempfile
    from statistics import median

    from multihop_offload_tpu_torch.cli import train as cli_train
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET
    from multihop_offload_tpu_torch.models.chebconv import load_weights, params_from_jax
    from multihop_offload_tpu_torch.obs.spans import reset_phases
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.train import driver as drv

    tmp = tempfile.mkdtemp(prefix="mho_drivers_")
    out = {}
    try:
        # ---- the Evaluator: launches counted file by file -------------------
        ecfg = Config(datapath=PAPER_DATASET, out=os.path.join(tmp, "eval"),
                      model_root=os.path.join(tmp, "model"), arrival_scale=0.15, T=1000,
                      num_instances=10, obs_log=os.path.join(tmp, "eval_count.jsonl"))
        ev = drv.Evaluator(ecfg, device=dev)
        ev.model.load_state_dict(params_from_jax(load_weights(MODEL_K1)))
        pad = ev.data.pad
        per_file = []
        inner = ev._eval_methods

        def counted(inst, jobs, gen):
            reset_counts()
            res = inner(inst, jobs, gen)
            per_file.append(read_counts())
            return res

        ev._eval_methods = counted
        rows = read_csv_rows(ev.run(verbose=False))
        ev._eval_methods = inner
        k2_per_file = 2 * mp.squaring_count(pad.n)
        log(f"driver Evaluator (dense, {MODEL_K1}, pads {pad}): launches per file "
            f"fixed_point {sorted({c['fixed_point'] for c in per_file})}, minplus "
            f"{sorted({c['minplus'] for c in per_file})} (2 APSP calls x "
            f"{mp.squaring_count(pad.n)} squarings), over {len(per_file)} files")
        if len(per_file) != 20 or any(c["fixed_point"] != 4 or c["minplus"] != k2_per_file
                                      for c in per_file):
            raise AssertionError(f"Evaluator launches per file: {per_file}")
        if len(rows) != 20 * 10 * 3 or list(rows[0]) != drv.TEST_COLUMNS:
            raise AssertionError(f"Evaluator CSV: {len(rows)} rows, columns {list(rows[0])}")
        if not all(math.isfinite(float(r["tau"])) for r in rows):
            raise AssertionError("Evaluator CSV: a tau is not finite")
        out["eval_launches_per_file"] = {"fixed_point": 4, "minplus": k2_per_file}
        out["eval_counts_file0"] = per_file[0]

        # the same files on the CPU (float32, plain versions), and batched
        cpu_ev = drv.Evaluator(dataclasses.replace(ecfg, out=os.path.join(tmp, "eval_cpu"),
                                                   obs_log=""), device="cpu")
        cpu_ev.model.load_state_dict(params_from_jax(load_weights(MODEL_K1)))
        cpu_rows = read_csv_rows(cpu_ev.run(files_limit=4, verbose=False))
        out["eval_card_vs_cpu"] = compare_eval_rows("Evaluator card vs CPU (4 files)",
                                                    rows[:len(cpu_rows)], cpu_rows)
        ev.cfg.file_batch = 4
        ev.cfg.obs_log = os.path.join(tmp, "eval_batch4.jsonl")
        b4_rows = read_csv_rows(ev.run(out_dir=os.path.join(tmp, "eval_b4"), verbose=False))
        out["eval_file_batch4"] = compare_eval_rows("Evaluator file_batch=4 vs 1", b4_rows,
                                                    rows)
        ev.cfg.file_batch = 1
        ev.cfg.obs_log = os.path.join(tmp, "eval_time.jsonl")
        reset_phases()
        t_rows = read_csv_rows(ev.run(out_dir=os.path.join(tmp, "eval_t"), verbose=False))
        out["eval_span_ms_per_file"] = span_ms(("eval/build", "eval/step"), 20)
        eval_ms = file_ms(ev.cfg.obs_log)
        b4_ms = file_ms(os.path.join(tmp, "eval_batch4.jsonl"))
        out["eval_ms_per_file"] = median(eval_ms)
        out["eval_ms_per_chunk_of_4"] = median(b4_ms)
        out["eval_runtime_median_s"] = median(float(r["runtime"]) for r in t_rows)

        # ---- the Trainer through its entry point ----------------------------
        args = ["--datapath", PAPER_DATASET, "--out", os.path.join(tmp, "train"),
                "--model_root", os.path.join(tmp, "model"), "--layout", "sparse",
                "--cheb_k", "2", "--epochs", "1", "--batch", "100", "--memory_size",
                "5000", "--arrival_scale", "0.15", "--T", "1000", "--num_instances", "10",
                "--device", dev.type]
        seen, step_counts, test_counts = {}, [], []
        orig = {k: getattr(drv.Trainer, k) for k in ("run", "_train_step", "_eval_methods")}

        def run(self, *a, **k):
            seen["trainer"] = self
            seen.setdefault("before", {n: p.clone() for n, p in self.params().items()})
            return orig["run"](self, *a, **k)

        def counted(name, into):
            def call(self, *a, **k):
                reset_counts()
                res = orig[name](self, *a, **k)
                into.append(read_counts())
                return res
            return call

        train_step = counted("_train_step", step_counts)
        eval_methods = counted("_eval_methods", test_counts)

        drv.Trainer.run, drv.Trainer._train_step = run, train_step
        drv.Trainer._eval_methods = eval_methods
        reset_phases()
        try:
            train_csv = cli_train.main(args + ["--obs_log",
                                               os.path.join(tmp, "train.jsonl")])
        finally:
            for k, v in orig.items():
                setattr(drv.Trainer, k, v)
        trainer = seen["trainer"]
        trows = read_csv_rows(train_csv)
        out["train_counts_file0"] = {k: step_counts[0][k] + test_counts[0][k]
                                     for k in step_counts[0]}
        out["train_span_ms_per_file"] = span_ms(("train/build", "train/step",
                                                 "train/metrics"), 20)
        out["train_span_ms_per_file"].update(span_ms(("train/replay",), 11))
        # per file: the training step K4 9 (5 layers forward, 4 backward:
        # layer 0 needs no d x), K1 3, K6 1; eval_methods K4 5, K1 4, K6 2;
        # each K6 call hands its matrix to K2's squarings, which stop early
        # by the data (`squarings`: those run, summed over the batch)
        sq = mp.squaring_count(trainer.data.pad.n)
        want_step = {"fixed_point": 3, "chebconv": 9, "coo_apsp": 1, "minplus": sq}
        want_test = {"fixed_point": 4, "chebconv": 5, "coo_apsp": 2, "minplus": 2 * sq}
        seen_counts = lambda got, keys: {k: sorted({c[k] for c in got}) for k in keys}
        log(f"driver Trainer (sparse, K=2, fresh init, {len(step_counts)} files): "
            f"launches per file in the training step {seen_counts(step_counts, want_step)}, "
            f"in eval_methods {seen_counts(test_counts, want_test)}; replays "
            f"{len(trainer.replay_losses)}, losses "
            f"{[round(x, 4) for x in trainer.replay_losses]}")
        for tag, got, want in (("training step", step_counts, want_step),
                               ("eval_methods", test_counts, want_test)):
            want = {k: want.get(k, 0) for k in read_counts() if k != "squarings"}
            if len(got) != 20 or any({k: c[k] for k in want} != want or c["squarings"] <= 0
                                     for c in got):
                raise AssertionError(f"Trainer {tag} launches per file: {got}, want {want}")
        if len(trows) != 20 * 10 * 4 or list(trows[0]) != drv.TRAIN_COLUMNS:
            raise AssertionError(f"Trainer CSV: {len(trows)} rows, columns {list(trows[0])}")
        if not all(math.isfinite(float(r["tau"])) for r in trows):
            raise AssertionError("Trainer CSV: a tau is not finite")
        if len(trainer.replay_losses) != 11:
            raise AssertionError(f"replays: {len(trainer.replay_losses)}, want 11")
        final = {n: p.clone() for n, p in trainer.params().items()}
        if all(torch.equal(final[n], seen["before"][n]) for n in final):
            raise AssertionError("Trainer: the parameters did not change")
        for p in trainer.model.parameters():
            p.data.zero_()
        step = trainer.try_restore()
        if step != 19 or not all(torch.equal(final[n], p)
                                 for n, p in trainer.params().items()):
            raise AssertionError(f"try_restore (step {step}) is not bit-exact")
        seen.clear()
        drv.Trainer.run = run
        try:
            cli_train.main(args + ["--files_limit", "2", "--obs_log",
                                   os.path.join(tmp, "train_resume.jsonl")])
        finally:
            drv.Trainer.run = orig["run"]
        resumed = read_csv_rows(train_csv)
        gidx = sorted({int(r["fid"]) for r in resumed})
        log(f"driver Trainer resumed: restored step {step}, visits {gidx}")
        if gidx != [20, 21]:
            raise AssertionError(f"the resumed run's visits are {gidx}, want [20, 21]")
        tms = file_ms(os.path.join(tmp, "train.jsonl"))
        # visit i >= 1 takes tms[i - 1]; visits 9 to 19 replay
        out["train_ms_per_file"] = median(tms[:8])
        out["train_ms_per_replay_file"] = median(tms[8:])
        out["train_runtime_median_s"] = median(float(r["runtime"]) for r in trows)

        # ---- the card's busy share over one file of each --------------------
        ev.cfg.obs_log = ""
        one = lambda: ev.run(files_limit=1, out_dir=os.path.join(tmp, "eval_1"),
                             verbose=False)
        out["eval_busy"] = busy_share(one, wall_ms(one, 3))
        # the first Trainer: its replay memory is full, so every visit replays
        trainer.cfg.obs_log = ""
        one_t = lambda: trainer.run(epochs=1, files_limit=1,
                                    out_dir=os.path.join(tmp, "train_1"), verbose=False)
        out["train_replay_busy"] = busy_share(one_t, wall_ms(one_t, 3))
        log(f"driver timing on {card['smi']}: Evaluator {out['eval_ms_per_file']:.2f} ms "
            f"per file (median of 19 visits, host clock; file_batch=4: "
            f"{out['eval_ms_per_chunk_of_4']:.2f} ms per chunk of 4), runtime column "
            f"median {out['eval_runtime_median_s'] * 1e3:.4f} ms; Trainer "
            f"{out['train_ms_per_file']:.2f} ms per file before replay, "
            f"{out['train_ms_per_replay_file']:.2f} ms per replay file, runtime column "
            f"median {out['train_runtime_median_s'] * 1e3:.4f} ms; busy share: Evaluator "
            f"file {out['eval_busy']['share']:.4f} ({out['eval_busy']['busy_ms']:.3f} of "
            f"{out['eval_busy']['wall_ms']:.2f} ms), Trainer replay file "
            f"{out['train_replay_busy']['share']:.4f} ({out['train_replay_busy']['busy_ms']:.3f}"
            f" of {out['train_replay_busy']['wall_ms']:.2f} ms); host ms per visit "
            f"in the spans: Evaluator {out['eval_span_ms_per_file']}, Trainer (counted "
            f"run; train/replay per replay) {out['train_span_ms_per_file']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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
    from multihop_offload_tpu_torch.agent.train_step import forward_backward
    from multihop_offload_tpu_torch.train.driver import eval_methods, train_init, train_step

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
    # the same requests on the sparse layout (nnz pads sized from the data)
    sp_inst_cpu, sp_jobs_cpu, sp_pad = request_batch(paper, 4, seed=0, cfg=cfg,
                                                     device="cpu", layout="sparse")
    sp_rung_cpu, sp_rung_jobs_cpu, sp_rung_pad = request_batch(
        load_cases("rung256"), 1, seed=0, cfg=cfg, device="cpu", layout="sparse")
    sp_inst, sp_jobs = sp_inst_cpu.to(dev), sp_jobs_cpu.to(dev)
    sp_rung, sp_rung_jobs = sp_rung_cpu.to(dev), sp_rung_jobs_cpu.to(dev)
    sp_model_cpu = load_model(MODEL_K2, device="cpu", layout="sparse")
    log(f"sparse layout: paper {sp_pad}, rung256 {sp_rung_pad}")

    # ---- kernel phase -------------------------------------------------------
    errs, k2_shapes, k1_shapes = kernel_phase({"paper": (model, inst, jobs),
                                               "rung256": (model, rung_inst, rung_jobs)},
                                              dev, card)
    errs_sp = sparse_kernel_phase({"paper": sp_inst, "rung256": sp_rung}, dev)

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

    # ---- slice 2 main path: the sparse training step ------------------------
    tcfg = Config(arrival_scale=0.15, layout="sparse", cheb_k=2)
    sp_model = load_model(MODEL_K2, device=dev, layout="sparse")
    state = train_init(sp_model, tcfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = [p.detach().clone() for p in sp_model.parameters()]
    reset_counts()
    reports = [train_step(sp_model, state, sp_inst, sp_jobs, tcfg, gen=gen)
               for _ in range(3)]
    train_counts = read_counts()
    log(f"main path train_step x3 (sparse, {MODEL_K2}, B={sp_inst.adj.shape[0]}, "
        f"replay batch {tcfg.batch}): launches {train_counts}; replayed "
        f"{[r.replayed for r in reports]}; replay loss "
        f"{[round(float(r.replay_loss), 4) for r in reports]}; skipped "
        f"{[int(r.skipped) for r in reports]}")
    for key in ("fixed_point", "chebconv", "coo_apsp"):
        if train_counts[key] == 0:
            raise AssertionError(f"kernel {key} did not launch in train_step: {train_counts}")
    if not all(torch.isfinite(r.loss_critic).all() and torch.isfinite(r.loss_mse).all()
               for r in reports):
        raise AssertionError("train_step: non-finite losses")
    if not any(r.replayed for r in reports) or all(
            torch.equal(a, b) for a, b in zip(before, sp_model.parameters())):
        raise AssertionError("train_step: the parameters did not change")

    # ---- dense forward_backward with the model of record --------------------
    reset_counts()
    dense_fb = forward_backward(model, inst, jobs)
    fb_counts = read_counts()
    log(f"dense forward_backward ({MODEL_K1}, B={inst.adj.shape[0]}): launches {fb_counts}")
    if fb_counts["fixed_point"] == 0 or fb_counts["minplus"] == 0:
        raise AssertionError(f"a kernel did not launch in forward_backward: {fb_counts}")
    if not all(torch.isfinite(g).all() for g in dense_fb.grads.values()):
        raise AssertionError("dense forward_backward: non-finite gradients")

    # ---- slice 2 checks: card vs CPU (float32, plain versions) ---------------
    sp_model_k2 = load_model(MODEL_K2, device=dev, layout="sparse")
    fb_card = forward_backward(sp_model_k2, sp_inst, sp_jobs, layout="sparse")
    fb_cpu = forward_backward(sp_model_cpu, sp_inst_cpu, sp_jobs_cpu, layout="sparse",
                              device="cpu")
    m = sp_jobs_cpu.mask
    differ = (fb_card.dst.cpu() != fb_cpu.dst) & m
    agree = 1.0 - int(differ.sum()) / int(m.sum())
    same = ~differ.any(dim=1)
    lc_rel = ((fb_card.loss_critic.cpu() - fb_cpu.loss_critic).abs()
              / fb_cpu.loss_critic.abs())[same]
    cos = episode_cosines(fb_card.grads, fb_cpu.grads)[same]
    log(f"sparse forward_backward card vs CPU: dst agreement {agree:.4f} "
        f"({int(differ.sum())} of {int(m.sum())} jobs differ); over {int(same.sum())} "
        f"episodes with equal decisions: loss_critic max rel err "
        f"{lc_rel.max().item():.3e} (bar 1e-4), gradient cosine min "
        f"{cos.min().item():.7f} (bar 0.999)")
    if agree < 0.99 or not lc_rel.max().item() <= 1e-4 or not cos.min().item() >= 0.999:
        raise AssertionError("sparse forward_backward: card disagrees with the CPU")
    sp_card = outcomes(sp_model_k2, sp_inst, sp_jobs, dev, layout="sparse")
    sp_cpu = outcomes(sp_model_cpu, sp_inst_cpu, sp_jobs_cpu, "cpu", layout="sparse")
    compare("paper-sparse-K2", sp_card, sp_cpu, m)
    sp_eval = eval_methods(sp_model_k2, sp_inst, sp_jobs, layout="sparse")
    for name, tot in zip(("baseline", "local", "gnn"), sp_eval):
        ref = sp_cpu[name]
        same = ~((sp_card[name].decision.dst.cpu() != ref.decision.dst) & m).any(dim=1)
        torch.testing.assert_close(tot.cpu()[same], ref.job_total[same], rtol=1e-4,
                                   atol=0, msg=f"sparse eval_methods {name}")

    # ---- timing -------------------------------------------------------------
    d, iters, fp_args = kernel_inputs(model, inst, jobs)
    b, n, _ = d.shape
    _, l = fp_args[1].shape
    before = read_counts()["squarings"]
    mp.minplus_closure_cuda(d, iters)
    sq_per_call = read_counts()["squarings"] - before
    # one call: the input clone, the memset of the flags, the squarings
    k2 = clocks(lambda: mp.minplus_closure_cuda(d, iters), 50, kernels_per_call=2 + iters)
    k2_ms = k2["ms"]
    k2_plain_ms = cuda_ms(lambda: mp.minplus_closure_plain(d, iters), 10)
    k1 = clocks(lambda: fp.fixed_point_cuda(*fp_args), 200)
    k1_ms = k1["ms"]
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
    log(f"timing on {card['smi']}: K2 minplus per APSP call ({iters} launches, "
        f"{sq_per_call} matrix squarings run of {b * iters}): call {k2_ms * 1e3:.2f} us, "
        f"device {k2['device_ms'] * 1e3:.2f} us ({k2['kernels_per_call']:.0f} kernels), "
        f"host {k2['host_us']:.2f} us; plain {k2_plain_ms:.4f} ms, bound "
        f"{max(k2_bound_ms, k2_bytes_ms) * 1e3:.2f} us; K1 fixed_point per launch: call "
        f"{k1_ms * 1e3:.2f} us, device {k1['device_ms'] * 1e3:.2f} us, host "
        f"{k1['host_us']:.2f} us; plain {k1_plain_ms:.4f} ms, bound "
        f"{max(k1_bytes_ms, k1_ops_ms) * 1e3:.2f} us")
    log(f"eval_methods {eval_ms:.2f} ms per batch of {b} requests "
        f"({b / eval_ms * 1e3:.1f} requests/s); forward_env {fwd_ms:.2f} ms; "
        f"rung256 eval_methods {rung_ms:.2f} ms per batch of "
        f"{rung_inst.adj.shape[0]}; peak memory {peak / 2**20:.1f} MiB "
        f"(max_memory_allocated, paper batch)")

    # ---- slice 2 timing ------------------------------------------------------
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.models.chebconv import chebyshev_support
    from multihop_offload_tpu_torch.ops import chebconv as cc

    support = sparse_chebyshev_support(sp_inst.sparse.ext, mask=sp_inst.ext_mask,
                                       csr=sp_inst.sparse.ext_csr)
    e_, csr = support.edges, support.csr
    sb, se = support.diag.shape
    nnz_pad = e_.rows.shape[1]
    real = int((e_.vals != 0).sum())  # the entries this run's supports hold
    # the library's yardsticks for the same function: one sparse product on
    # the block-diagonal batch support (diagonal merged in), and the dense
    # layout's batched product with the (B, E, E) support
    off = (torch.arange(sb, device=dev) * se).unsqueeze(1)
    keep = e_.vals != 0
    diag_ids = torch.arange(sb * se, device=dev)
    block = torch.sparse_coo_tensor(
        torch.stack([torch.cat([(e_.rows.long() + off)[keep], diag_ids]),
                     torch.cat([(e_.cols.long() + off)[keep], diag_ids])]),
        torch.cat([e_.vals[keep], support.diag.reshape(-1)]),
        (sb * se, sb * se)).coalesce().to_sparse_csr()
    dense_support = chebyshev_support(inst.adj_ext, inst.ext_mask).contiguous()
    k4 = {}
    for f in (4, 32):
        x = torch.randn((sb, se, f), generator=gen, device=dev)
        fwd = clocks(lambda: cc.chebconv_propagate_cuda(
            csr.row_ptr, None, e_.cols, e_.vals, support.diag, x), 200)
        # the backward's launch: the transposed walk through col_order
        bwd = clocks(lambda: cc.chebconv_propagate_cuda(
            csr.col_ptr, csr.col_order, e_.rows, e_.vals, support.diag, x), 200)
        k4_plain = cuda_ms(lambda: cc.chebconv_propagate_plain(
            e_.rows, e_.cols, e_.vals, support.diag, x), 50)
        lib = clocks(lambda: torch.sparse.mm(block, x.view(sb * se, f)), 50)
        bmm = clocks(lambda: torch.bmm(dense_support, x), 50)
        # bytes: each real (row, col, val) entry, diag, x and out once; the
        # operations (a multiply-add per entry and feature) are far below
        k4_bytes = (real * 12 + sb * se * 4 + 2 * sb * se * f * 4) / PEAK_BYTES_PER_S * 1e3
        k4_ops = 2.0 * (real + sb * se) * f / PEAK_FP32_FLOP_PER_S * 1e3
        k4[f] = {"ms": fwd["ms"], "device_ms": fwd["device_ms"], "host_us": fwd["host_us"],
                 "backward_ms": bwd["ms"], "backward_device_ms": bwd["device_ms"],
                 "plain_ms": k4_plain, "library_ms": lib["ms"],
                 "library_device_ms": lib["device_ms"],
                 "library_kernels_per_call": lib["kernels_per_call"],
                 "dense_bmm_ms": bmm["ms"], "dense_bmm_device_ms": bmm["device_ms"],
                 "bound_ms": max(k4_bytes, k4_ops),
                 "bound_by": "bytes" if k4_bytes >= k4_ops else "operations"}
    n6 = sp_inst.num_pad_nodes
    l6 = sp_inst.num_pad_links
    d6 = (1.0 / sp_inst.link_rates).contiguous()
    args6 = (sp_inst.link_ends, sp_inst.link_mask, d6, n6)
    before6 = read_counts()["squarings"]
    mp.apsp_coo_cuda(*args6)
    sq6 = read_counts()["squarings"] - before6
    # one call: the build of W, the memset of K2's flags, K2's squarings
    # (W is K2's first buffer: no clone)
    k6 = clocks(lambda: mp.apsp_coo_cuda(*args6), 50,
                kernels_per_call=2 + mp.squaring_count(n6))
    k6_ms = k6["ms"]
    k6_plain = cuda_ms(lambda: mp.apsp_coo_plain(*args6), 5)
    k6_ops = 2.0 * n6 ** 3 * sq6 / PEAK_FP32_INSTR_PER_S * 1e3
    k6_bytes = sb * (l6 * 13 + n6 * n6 * 4) / PEAK_BYTES_PER_S * 1e3
    rung_args6 = (sp_rung.link_ends, sp_rung.link_mask,
                  (1.0 / sp_rung.link_rates).contiguous(), sp_rung.num_pad_nodes)
    k6_rung_ms = cuda_ms(lambda: mp.apsp_coo_cuda(*rung_args6), 20)
    # the paths on the host clock
    fb_ms = wall_ms(lambda: forward_backward(sp_model_k2, sp_inst, sp_jobs,
                                             layout="sparse"), 5)
    ts_ms = wall_ms(lambda: train_step(sp_model, state, sp_inst, sp_jobs, tcfg, gen=gen), 5)
    rung_fb_ms = wall_ms(lambda: forward_backward(sp_model_k2, sp_rung, sp_rung_jobs,
                                                  layout="sparse"), 3)
    dense_fb_ms = wall_ms(lambda: forward_backward(model, inst, jobs), 5)
    torch.cuda.reset_peak_memory_stats()
    train_step(sp_model, state, sp_inst, sp_jobs, tcfg, gen=gen)
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    for f, t in k4.items():
        log(f"timing on {card['smi']}: K4 chebconv B,E,F={(sb, se, f)} ({real} real of "
            f"{sb * nnz_pad} padded entries) per launch: device {t['device_ms'] * 1e3:.2f} us "
            f"(call {t['ms'] * 1e3:.2f}, host {t['host_us']:.2f}); transposed, as the "
            f"backward launches it: device {t['backward_device_ms'] * 1e3:.2f} us (call "
            f"{t['backward_ms'] * 1e3:.2f}); plain {t['plain_ms'] * 1e3:.2f} us; bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}); torch.sparse.mm device "
            f"{t['library_device_ms'] * 1e3:.2f} us ({t['library_kernels_per_call']:.0f} "
            f"kernels; call {t['library_ms'] * 1e3:.2f}); dense torch.bmm device "
            f"{t['dense_bmm_device_ms'] * 1e3:.2f} us (call {t['dense_bmm_ms'] * 1e3:.2f})")
    log(f"timing: K6 coo_apsp (build + K2) B,N={(sb, n6)} per call: device "
        f"{k6['device_ms'] * 1e3:.2f} us ({k6['kernels_per_call']:.0f} kernels), call "
        f"{k6_ms * 1e3:.2f} us, host {k6['host_us']:.2f} us ({sq6} squarings run); plain "
        f"{k6_plain:.4f} ms, bound {max(k6_ops, k6_bytes) * 1e3:.2f} us; rung256 "
        f"B,N={(sp_rung.adj.shape[0], sp_rung.num_pad_nodes)} call {k6_rung_ms * 1e3:.2f} us")
    log(f"sparse forward_backward {fb_ms:.2f} ms per batch of {sb} episodes "
        f"({sb / fb_ms * 1e3:.1f} episodes/s); train_step {ts_ms:.2f} ms "
        f"({sb / ts_ms * 1e3:.1f} episodes/s, replay of {tcfg.batch} included); "
        f"rung256 sparse forward_backward {rung_fb_ms:.2f} ms per batch of "
        f"{sp_rung.adj.shape[0]}; dense forward_backward ({MODEL_K1}) "
        f"{dense_fb_ms:.2f} ms; peak memory {train_peak / 2**20:.1f} MiB "
        f"(max_memory_allocated, train_step)")

    # ---- slice 3: the large-graph path ---------------------------------------
    large = large_phase(dev, card)

    # ---- slice 4: the service, and K5 on its sparse bucket's lists ----------
    serving = serving_phase(dev, card)
    k5 = ragged_kernel_phase(dev, card, serving.pop("sparse_bucket1"))

    # ---- slice 12: the Trainer and Evaluator drivers --------------------------
    drivers = driver_phase(dev, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    by_path = {"eval_methods": counts, "train_step": train_counts,
               "forward_backward_dense": fb_counts,
               **{f"large_{k}": v for k, v in large["counts"].items()},
               **serving.pop("counts"),
               "driver_eval_file": drivers.pop("eval_counts_file0"),
               "driver_train_file": drivers.pop("train_counts_file0")}
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"drivers": drivers}), flush=True)
    kernels = [
        {"name": "fixed_point", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/fixed_point.cu",
         "replaces": "multihop_offload_tpu/ops/fixed_point.py:144",
         "launches": counts["fixed_point"],
         "max_abs_err": errs["paper"]["fixed_point"],
         "ms": k1_ms, "device_ms": k1["device_ms"], "plain_ms": k1_plain_ms,
         "bound_ms": max(k1_bytes_ms, k1_ops_ms),
         "bound_by": "bytes" if k1_bytes_ms >= k1_ops_ms else "operations",
         "library_ms": None, "shape": [b, l], "shapes": k1_shapes,
         "launches_by_path": {k: v["fixed_point"] for k, v in by_path.items()}},
        {"name": "minplus_squaring", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/minplus.cu",
         "replaces": "multihop_offload_tpu/ops/minplus.py:88",
         "launches": counts["minplus"], "squarings": counts["squarings"],
         "max_abs_err": errs["paper"]["minplus"],
         "ms": k2_ms, "device_ms": k2["device_ms"], "plain_ms": k2_plain_ms,
         "bound_ms": max(k2_bound_ms, k2_bytes_ms),
         "bound_by": "operations" if k2_bound_ms >= k2_bytes_ms else "bytes",
         "library_ms": None, "shape": [b, n],
         "launches_per_call": iters, "ms_per_launch": k2_ms / iters,
         "kernels_per_call": k2["kernels_per_call"],
         "squarings_per_call": sq_per_call, "shapes": k2_shapes,
         "launches_by_path": {k: v["minplus"] for k, v in by_path.items()}},
        {"name": "chebconv_propagate", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/chebconv.cu",
         "replaces": "multihop_offload_tpu/ops/chebconv.py:162",
         "launches": train_counts["chebconv"],
         "max_abs_err": errs_sp["paper"]["chebconv"],
         **k4[32], "shape": [sb, se, 32], "nnz_real": real, "nnz_pad": nnz_pad,
         "f4": k4[4],
         "launches_by_path": {k: v["chebconv"] for k, v in by_path.items()}},
        {"name": "coo_apsp", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/coo_apsp.cu",
         "replaces": "multihop_offload_tpu/ops/minplus.py:487",
         "launches": train_counts["coo_apsp"],
         "max_abs_err": errs_sp["paper"]["coo_apsp"],
         "ms": k6_ms, "device_ms": k6["device_ms"], "plain_ms": k6_plain,
         "bound_ms": max(k6_ops, k6_bytes),
         "bound_by": "operations" if k6_ops >= k6_bytes else "bytes",
         "library_ms": None, "shape": [sb, n6], "squarings_per_call": sq6,
         "rung_ms": k6_rung_ms,
         "launches_by_path": {k: v["coo_apsp"] for k, v in by_path.items()}},
        {"name": "blocked_fw", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/blocked_fw.cu",
         "replaces": "multihop_offload_tpu/ops/minplus.py:195",
         "launches": large["counts"]["eval_methods"]["blocked_fw"],
         "max_abs_err": 0.0,
         "ms": large["ms"], "device_ms": large["device_ms"], "plain_ms": large["plain_ms"],
         "bound_ms": large["bound_ms"],
         "bound_by": large["bound_by"], "library_ms": None, "shape": large["shape"],
         "launches_per_call": large["launches_per_call"],
         "squaring_ms": large["squaring_ms"],
         "phase_device_us": large["phase_device_us"],
         "pivot_ns_per_step": large["pivot_ns_per_step"],
         "large_path": {k: large[k] for k in ("forward_env_ms", "eval_methods_ms",
                                              "forward_backward_ms", "peak_mib")},
         "launches_by_path": {k: v["blocked_fw"] for k, v in by_path.items()}},
        {"name": "chebconv_ragged", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/chebconv_ragged.cu",
         "replaces": "multihop_offload_tpu/ops/chebconv.py:339",
         "launches": sum(k5["launches"].values()), "launches_split": k5["launches"],
         "max_abs_err": k5["max_abs_err"],
         **k5["timing"][32], "shape": k5["shape"], "nnz_cap": k5["cap"],
         "nnz_live": k5["nnz_live"], "max_abs_err_all_cases": k5["max_abs_err_all"],
         "f4": k5["timing"][4],
         "launches_by_path": {k: v["ragged_index"] for k, v in by_path.items()}},
        {"name": "ragged_index", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/chebconv_ragged.cu",
         "replaces": "multihop_offload_tpu/ops/chebconv.py:339",
         "launches": k5["launches"]["ragged_index"], "max_abs_err": 0.0,
         **k5["sort"], "shape": [k5["shape"][0], k5["shape"][1], k5["cap"]],
         "launches_by_path": {k: v["ragged_index"] for k, v in by_path.items()}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
