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
- Slice 13, the closed-loop packet simulator (`cli/sim.py`, `sim/`) at
  the paper's largest network size: 16 BA networks n = 110 (pads N=112,
  L=216, J=100), 100 jobs each at utilization 0.7, margin 5, cap 128, 4
  policy rounds x 125 slots (500 until slice 22; cut in slice 23 to fit
  the RL phase in the smoke's time), under `gnn` with the model of record (dense:
  K1, K2), `gnn` with SPECTRAL_K2 (sparse: K4, K1, K2), `baseline` (K2),
  `local` (no kernel) and `baseline` with 2 links and 1 node failing at
  mid-horizon; then 4 of the networks, 2 rounds x 200 slots, on the card
  and on the CPU under the same injected draws, `gnn` again on 4 x 10
  nodes (where it offloads), and `fidelity_sweep` at utilizations 0.3 and
  0.5 with the JAX record's settings (8 x 10 nodes, margin 10, 5 x 5000
  slots, 150 served).
- Slice 14, the bf16 precision policy (`precision.py`) on the decision
  paths: `eval_methods` under `precision="bf16"` on the paper batch with
  the model of record, dense (K2 in bf16, K1 on fp32), and with
  SPECTRAL_K2, sparse (K4's forward and K6 in bf16, K1 on fp32); the
  Evaluator on the paper dataset; the serving pool, dense (256 requests)
  and sparse (64); one `baseline` simulator run (the full-width fleet, 2
  rounds x 250 slots).  The bf16 kernels are held against their plain
  versions (K2 and K6 bit for bit, K2 at (64, 112), (16, 56), (16, 112)
  and (4, 256); K4 within one bf16 ulp at (64, 328, 32) and (16, 328,
  4)); each path's launches equal the counts the same calls make on the
  CPU, which also holds K1 to fp32; card against the CPU in bf16
  (`baseline` and `local` `dst` identical, the GNN's >= 0.99, per-method
  mean job total within 1e-2; the Evaluator's rows likewise; the
  service's answers to the same requests within 1e-2; the sim's
  `baseline` on 4 of the networks, 2 rounds x 200 slots, under the same
  injected draws, identical field for field), bf16 against fp32 on the
  card (`dst` agreement reported, and held to 0.99 for the service and
  the sim; mean job total within JAX's gate of 0.05); every request
  answered once; the sim's packets conserved.
- Slice 15, the last two kernel forms: K4's transposed walk in bf16 (the
  backward of the propagate) and K3 in bf16.  The Trainer under
  `precision="bf16"` through `cli.train.main` on 2 files of the paper
  dataset (10 job sets each, fresh K=2 init, replay of 20 from the second
  file, exploration off, the replay's indices injected), dense (K2 bf16,
  K1) and sparse (K4's bf16 forward and transposed walk, K6 and K2 in
  bf16, K1): every file's launches equal the CPU's bf16 run's, its rows
  (`baseline`, `local` all, `GNN` >= 99% with equal `congest_jobs` and
  `tau` within 1e-2), replay loss (1e-2) and final params (drift <= 0.05
  of the move) held to that run, checkpoints fp32, ms and busy share
  beside fp32; K4's transposed walk bit-identical to its plain version
  on 3 calls at (64, 328, 32) and (16, 328, 4).  In the large phase, K3
  in bf16 bit-identical to `blocked_fw_plain` in bf16 at (1, 1024) (the
  path's own delays narrowed) and (2, 384), and one `eval_methods(...,
  precision=bf16)` at N = 1,024 launching K3 bf16 2 x 3 N / 128 times and
  no other kernel.
- Slice 16, the APSP route of `apsp_impl` brought back to JAX's default
  (`'xla'`: the squarings at every N).  `route_phase`: on 2 BA(300, m=2)
  networks x 2 job sets (pad N 304, which the `'pallas'` route pads to
  384) one default-Config `eval_methods` in fp32 and one under bf16
  launch K2 (fp32, bf16) and no K3, as the CPU run of the same calls
  predicts, and their outcomes are held to that CPU run; K2 is held bit
  for bit to its plain closure on the (4, 304) matrix that path hands it,
  in both dtypes.  The large phases name the demo's `'pallas'` route
  (`large_scale.LARGE_APSP`) and keep their K3 counts.
- Slice 17, K2 and K3 in bf16 on packed bf16x2 arithmetic, each sharing
  one body with its float32 kernel (`csrc/minplus.cuh`,
  `csrc/blocked_fw.cuh`).  `bf16_kernel_phase` logs each K2 bf16 shape's
  bf16 tile plan beside the float32 one, and `large_bf16` times the
  float32 K3 on the same (1, 1024) matrix beside K3 bf16, with both
  pivots' ns a step; the bars are unchanged (bit for bit against the
  plain versions in bf16).
- Slice 18, the paper's dataset generator without networkx and
  `mho-serve`'s process wiring.  `datagen_phase`: `cli.datagen.
  generate_dataset` writes the ``paper`` (20 cases, n = 20..110) and
  ``rung256`` (4 x 250) groups on this host, bit for bit with
  `data/cases.npz` (`pos` within 1e-12 of the committed `.mat` files),
  `large_scale.build_case()` equals the committed large case, one n = 110
  case of each `generate` family is timed, and the Evaluator (model of
  record, dense: K1, K2) over the first 2 regenerated files gives the
  committed files' rows.  `serve_cli_phase`: `cli.serve.main` with a run
  log and a Prometheus file, step 1 of the port's checkpoints loaded at
  start, step 2 hot-reloaded between ticks, a truncated step 3
  quarantined, then SIGTERM with requests unsubmitted: every admitted
  request answered once, `shutdown` logged, the log sealed, K1 and K2
  launched, the answers under step 2 held to a CPU service on step 2;
  then `prob=True` answers equal alone and among 16.
- Slice 19, the reference's TF checkpoints without TensorFlow
  (`models/tf_bundle.py`, `models/tf_import.py`) and the paper's tables and
  figures (`train/analysis.py`, `utils/visualization.py`, `cli/plot.py`).
  `tf_checkpoint_phase`: the committed TF-format fixture (the model of
  record) read bit for bit as `weights.npz` and rewritten byte for byte;
  the Evaluator with `model_root` at the fixture's directory over 2 paper
  files, no `load_state_dict` (K1 4 and K2 2 APSP calls a file), its
  parameters bit for bit and its rows (`compare_eval_rows`) those of the
  `load_state_dict` Evaluator, `summarize_test` logged;
  `cli.plot.route_sums` on one n = 110 paper case (K1 and K2 launched as
  the CPU run predicts, routes and `dst` identical to it, sums within rtol
  1e-5), the figure drawn where matplotlib is installed.
- Slice 20, `parallel/` on a mesh of torch devices and the drivers' data
  mesh (`parallel_phase`), on `[cuda:0] * 4` (one card repeated: each
  shard launches its kernels there, so its times are the sharded path's
  overhead, not scaling): `sharded_apsp` at (1, 1024) over graph 4 on the
  large case's weights, bit for bit K2's closure and (its first squaring,
  and the whole ring at N = 256) the CPU ring; the `mean` and `replay`
  steps at data 4, graph 2 on the paper batch against the 1 x 1 mesh
  (K1 4 times one shard's launches, K2 none: the ring squares); the
  Trainer at `mesh_data = 4` (sparse, K = 2, 2 files, injected replay
  indices) and the Evaluator at `mesh_data = 2, file_batch = 2` (2 files)
  against their `mesh_data = 1` runs on the card, K1, K2, K4 and K6 on
  every file 4 times (the Evaluator: the same as) the one-device run's.
- Slice 21, sharded serving (`sharded_serving_phase`): `cli/serve.py:
  build_service(devices=[cuda:0] * 4)` with both buckets over all four
  fleet members, the serving pool's 256 requests dense (K1, K2 per
  shard) and the first 64 sparse (K1, K4, K6 per shard), each against the one-device
  service on the card: decisions identical, floats within 1e-4, every
  request answered once, the last dispatch over 4 devices, the launches
  the plain versions predict per shard (`count_plain` at the shard's
  width) and the one-device run's squarings (K2's counter is kept per
  card and summed); `lose_device(2)` after tick 3 and `restore_device(2)`
  after tick 6 under the planner's own plans, every admitted request
  answered once with the one-device decisions; then `mho-mesh --smoke`
  (`cli/mesh.py`) on the card, two gloo workers each on `[cuda:0] * 2`,
  every check passing.  One card repeated: the times are the sharded
  path's overhead, not scaling.
- Slice 22, training across processes (`multiprocess_phase`): two local
  processes join one gloo group, each on card `i % device_count` with
  two shards of its own 32 of the paper batch's 64 episodes (a 4-slot
  `data` axis over both processes, `make_mesh(runtime=)`, `global_batch`),
  and run one `make_dp_train_step(mode="mean")` step with the model of
  record: both report the same losses and new parameters bit for bit,
  equal to one process's four-shard step on the whole batch within
  `PARALLEL_RTOL`, each process's K1 and K2 launches the plain versions'
  count for its two shards.  The continual-learning loop (`loop_phase`):
  the `mho-loop` smoke (`cli/loop.py:run_loop`) on the card with the
  model of record and the serving pool's sizes (20, 50, 80, 110; two
  buckets, 4 slots): capture over >= 2 rotated log segments, refit,
  validate in the simulator, canary, promote, the injected regression,
  rollback; the run's K1 and K2 launches equal to the plain versions'
  count over the same run on the CPU, which ends in the same terminal
  state; the candidate's update (candidate minus champion) against the
  CPU's refit of the same outcomes (`compare_params` on the deltas), the
  promoted weights' decisions against the CPU service's
  (`compare_decisions`); a kill at `promote:post_save` and a restart
  reaching the same terminal state and lineage; a NaN-poisoned candidate
  refused at promotion and at hot reload (one
  `mho_canary_rejections_total` each); K1, K4 and K6 launches of one
  sparse refit equal to the plain count; one refit timed at the loop's
  default 4 slots a step.
- Slice 23, closed-loop RL (`rl/`, `cli/rl.py`) and K2's backward
  (`csrc/minplus_bwd.cu`), `rl_phase`: K2's backward through the
  autograd wrapper the RL path calls against autograd through the plain
  squarings on the card at (4, 16), (4, 112), (16, 112) and a tie-heavy
  (4, 112) hop matrix (distances bit for bit, the gradient within 1e-5 of
  its largest entry, `bwd_launches(iters)` launches, two calls
  bit-identical; slice 24's redesign: the backward alone within 1e-5 of
  its passes in plain torch, `minplus_closure_bwd_plain`, and timed by a
  CUDA graph replay and on the device clock beside the plain backward and
  its bound); `mho-rl --smoke` on the card in its own process (JAX's
  smoke configuration, cap 64; conservation exact, no skipped update, the
  same launches every step, K1, K2 and K2's backward among them; the
  improvement gate's verdict logged, ROADMAP.md Queue 3); the smoke's 20
  steps on the card (another process) and on the CPU under the same
  injected draws (no skipped step, `dst` identical in >= 99% of (step,
  lane, round, job), the output unit dying at the same step on both
  sides or on neither; the delivered ratios logged); one `RLTrainer` step
  with the model of record (dense: K1, K2, K2's backward) and one with
  SPECTRAL_K2 (sparse: K4 forward and transposed too) on 4 BA networks of
  n = 110 (pads N 112, L 216), 100 jobs at utilization 0.7, 2 rounds x
  100 slots, cap 128, at temperature 1000, where the gradient flows, each
  against the same step on the CPU under the same injected draws:
  launches equal to the plain versions' count of the CPU step, the CPU
  step offloading and every lane's gradient nonzero, `dst` identical in
  >= 99% of (lane, round, job), on lanes whose choices all agree the
  packet counters equal, the loss within 1e-4 and the lane's gradient
  within 1e-3 of its norm, Adam's update within 0.05 of its norm; then
  the same steps at the default temperature 0.5 (launches equal to the
  same count; the dense step's wall ms and the card's busy share).
- Slice 26, the scenario matrix (`scenarios/`, `cli/scenarios.py`) and the
  health drill (`cli/health.py`): `scenario_phase` runs `run_matrix` (the
  smoke's checks) over JAX's five smoke presets plus `grid_energy` (the
  energy-weighted objective), 4 lanes, 2 segments x 120 slots, the model
  of record, on the card and on the CPU under the same injected uniforms:
  K1 and K2 launches equal to the plain count of the CPU run,
  conservation exact on every lane, `baseline` and `local` lanes' counts
  and `dst` equal, `gnn` `dst` agreement >= 0.99 with equal counts on
  lanes whose decisions all agree, analytic taus within 1e-4, and
  `grid_energy`'s decisions different from `grid_poisson`'s; each leg's
  wall s, ms a slot and busy share (over one segment of 20 slots, a
  profiled pass beside an unprofiled one).  `health_phase`
  runs the drill on the card (every JAX check but the retrace one, not
  applicable), renders its run log with `obs/report.py`, and holds its
  K1 and K2 launches to the plain count of the CPU drill.

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
   file by file (K1, K4 and K6 on every file); each simulator run, whose
   K1, K2 and K4 launches must equal its rounds times one round's count
   (taken from the plain versions' calls on the CPU), whose packets must
   be conserved and whose device metrics must equal its state;
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
   resuming past the saved steps; the simulator's `baseline` and `local`
   runs on the card against the CPU under injected draws (every SimState
   counter, `delay_sum` and `q_sojourn` identical) and its `gnn` runs
   (`dst` agreement >= 0.99 in every round, on 10-node networks where the
   CPU run offloads in every round as well as at n = 110, where both
   models keep every job local); the fidelity sweep's acceptance (max
   link relative error <= 0.10 at utilization <= 0.5);
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
   replay file; the simulator's ms a slot and a policy round, MWIS
   sweeps a slot, its busy share and device records a slot over one
   segment, and K1 and K2 at its own operands;
7. prints the serving line, the drivers line, the sim line, the precision
   line, the bf16 training line, the route, datagen, serve CLI, TF
   checkpoint, parallel, sharded serving, multiprocess, loop, rl,
   scenarios and health lines, the kernels line (with the bf16 rows
   `minplus_squaring_bf16`, `chebconv_propagate_bf16`, `coo_apsp_bf16`,
   `chebconv_transpose_bf16` and `blocked_fw_bf16`, and K2's backward
   `minplus_backward`), then the
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
# bf16 add and min outside the tensor cores: the packed bf16x2 path
# (`__hadd2`, `__hmin2`) issues two elements an instruction, twice the fp32
# path's element rate (the data sheet's 133.8 TFLOP/s non-tensor bf16)
PEAK_BF16X2_OPS_PER_S = 2 * PEAK_FP32_INSTR_PER_S
BF16_RATE = "bf16x2 add and min outside the tensor cores, 67e12 elements/s"
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


def device_us(fn, reps: int, warmup: int = 3, kernels_per_call: int | None = None,
              per_call: dict | None = None) -> float:
    """Mean device microseconds per call of `fn`, on the card's own clock,
    from `torch.profiler`'s CUDA trace of `reps` calls: for each kernel,
    copy or memset, the mean duration of its records times its launches
    per call, summed.  For a library call that is every kernel it launches.
    The trace can lose records (from 2 of 1,250 to nearly all of a window,
    in runs on an H100); a kernel's mean is still its mean.  Its launches
    per call are known where `per_call` maps a substring of each kernel's
    name to them (the window is traced again, up to 4 more times, while a
    named kernel has no record); else they are its records over `reps`,
    rounded, and the window is traced again when it holds no launch, a
    count is off a whole multiple by more than a tenth of `reps`, or the
    launches per call are not `kernels_per_call` (where given).  Then this
    raises.  `device_us.last` keeps the kernels per call, the records seen
    and lost, their names and the device us per call of each name
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
                key = e.key if per_call is None else next(
                    (k for k in per_call if k in e.key), None)
                if key is not None:
                    counts[key] = counts.get(key, 0) + e.count
                    times[key] = times.get(key, 0.0) + e.self_device_time_total
        if per_call is not None:
            launches_per = dict(per_call)
            if all(counts.get(k) for k in per_call):
                break
            continue
        launches_per = {k: round(c / reps) for k, c in counts.items()}
        launches = sum(launches_per.values())
        if launches and all(abs(c - launches_per[k] * reps) <= reps // 10
                            for k, c in counts.items()) and (
                kernels_per_call is None or launches == kernels_per_call):
            break
    else:
        raise AssertionError(f"device_us: 5 traces lost kernel records or held none "
                             f"({counts} for {reps} calls)")
    by_name = {k: times[k] / counts[k] * n for k, n in launches_per.items() if n}
    launches = sum(launches_per.values())
    device_us.last = {"kernels_per_call": launches, "records": counts,
                      "lost_records": launches * reps - sum(counts.values()),
                      "names": sorted({k[:60] for k in by_name}), "by_name": by_name}
    return sum(by_name.values())


device_us.last = {}


def device_span_us(fn, reps: int, kernels_per_call: int, names: tuple,
                   warmup: int = 3) -> float | None:
    """Mean device microseconds per call of `fn` from the start of its first
    kernel to the end of its last, on the card's own clock
    (`torch.profiler`'s CUDA trace of `reps` calls of `kernels_per_call`
    kernels each, those whose names hold one of `names`): the time of a
    chain whose kernels overlap (a programmatic dependent launch starts
    before the kernel it waits for ends, so the sum of their durations
    counts the overlap twice).  The calls must not overlap each other.  A
    trace that lost records is taken again, up to 4 more times; then None
    (not measured).  `device_span_us.last` keeps the spans' range."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if "CUDA" in str(getattr(e, "device_type", ""))
                       and any(n in e.name for n in names))
        if len(spans) == reps * kernels_per_call:
            k = kernels_per_call
            per = [max(end for _, end in spans[i:i + k]) - spans[i][0]
                   for i in range(0, len(spans), k)]
            device_span_us.last = {"min": min(per), "max": max(per)}
            return sum(per) / len(per)
    device_span_us.last = {}


def graph_us(fn, reps: int) -> float | None:
    """Device microseconds a call of `fn` with no host in the way: one call
    captured in a CUDA graph (programmatic dependent launches become
    programmatic edges), the graph replayed `reps` times between CUDA
    events.  None (not measured) where `fn` cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps * 1e3
    except RuntimeError as exc:
        log(f"graph capture failed: {exc}")
        return None
    return None


device_span_us.last = {}

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

    reset_kernel_counts()


def read_counts() -> dict:
    """Every kernel's launches (and the fixed-point scan's runs) since the
    last `reset_counts`, with K2's executed squarings summed over every
    card (`squarings`, `squarings_bf16`)."""
    from multihop_offload_tpu_torch.large_scale import kernel_counts

    torch.cuda.synchronize()
    return kernel_counts()


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


def outcomes(model, inst, jobs, device, layout=None, precision=None, apsp_impl="xla"):
    from multihop_offload_tpu_torch.agent.policy import forward_env
    from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy

    with torch.no_grad():
        inst, jobs = inst.to(device), jobs.to(device)
        return {"baseline": baseline_policy(inst, jobs, layout=layout, precision=precision,
                                            apsp_impl=apsp_impl),
                "local": local_policy(inst, jobs, layout=layout),
                "gnn": forward_env(model, inst, jobs, device=device, layout=layout,
                                   precision=precision, apsp_impl=apsp_impl)[0]}


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
    """Slice 3: the large-graph path at N=1,024, on the demo's APSP route
    (`large_scale.LARGE_APSP`, `apsp_impl='pallas'`).  K3 against its plain
    version on the path's own predicted-delay matrix; the three calls of
    the path with counts set to 0 just before and read just after each;
    card against CPU; then K3's and the paths' times."""
    from multihop_offload_tpu_torch.agent.actor import actor_delay_matrix, default_support
    from multihop_offload_tpu_torch.agent.policy import forward_env
    from multihop_offload_tpu_torch.agent.train_step import forward_backward
    from multihop_offload_tpu_torch.env.apsp import weight_matrix_from_link_delays
    from multihop_offload_tpu_torch.graphs.cases import large_request, load_large_case
    from multihop_offload_tpu_torch.large_scale import LARGE_APSP, MODEL
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.train.driver import eval_methods

    t0 = time.perf_counter()
    route = {"apsp_impl": LARGE_APSP}
    case = load_large_case()
    inst_cpu, jobs_cpu, pad = large_request(case, device="cpu")
    inst, jobs = inst_cpu.to(dev), jobs_cpu.to(dev)
    model_cpu = load_model(MODEL, device="cpu")
    model = load_model(MODEL, device=dev)
    paths = {"apsp": mp.resolve_apsp(LARGE_APSP, pad.n)[1],
             "fixed_point": fp.fixed_point_path(pad.l)}
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
    calls = {"eval_methods": lambda: eval_methods(model, inst, jobs, **route),
             "forward_env": lambda: forward_env(model, inst, jobs, **route),
             "forward_backward": lambda: forward_backward(model, inst, jobs, **route)}
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
    compare("large", outcomes(model, inst, jobs, dev, **route),
            outcomes(model_cpu, inst_cpu, jobs_cpu, "cpu", **route), jobs_cpu.mask)
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
    env_ms = wall_ms(lambda: forward_env(model, inst, jobs, **route), 5)
    eval_ms = wall_ms(lambda: eval_methods(model, inst, jobs, **route), 5)
    fb_ms = wall_ms(lambda: forward_backward(model, inst, jobs, **route), 3)
    torch.cuda.reset_peak_memory_stats()
    eval_methods(model, inst, jobs, **route)
    forward_backward(model, inst, jobs, **route)
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
    bf16 = large_bf16(dev, card, case, d, small["2x384"], results["eval_methods"])
    return {"counts": counts, "shape": [b, n], "launches_per_call": 3 * nb, "bf16": bf16,
            "ms": k3_ms, "device_ms": k3["device_ms"], "plain_ms": k3_plain_ms,
            "squaring_ms": k2_ms, "phase_device_us": phases,
            "pivot_ns_per_step": ns_per_step,
            "bound_ms": max(k3_ops_ms, k3_bytes_ms),
            "bound_by": "operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
            "forward_env_ms": env_ms, "eval_methods_ms": eval_ms,
            "forward_backward_ms": fb_ms, "peak_mib": peak / 2**20}


def large_bf16(dev, card, case, d, d384, fp32_totals) -> dict:
    """Slice 15: K3 in bf16 on the large path.  K3 bf16 against
    `blocked_fw_plain` in bf16 on the card, bit for bit on 2 calls, at the
    path's own predicted-delay matrix narrowed (1, 1024) and at (2, 384)
    (also against the CPU); then one `eval_methods(..., precision=bf16)` on
    the demo's `'pallas'` route at N = 1,024 (the case stored as bf16, the random K=3 weights under the
    bf16 policy) with every count at 0 just before it and read just after:
    2 APSP calls of 3 N / 128 K3 bf16 launches (`blocked_fw_cuda`'s rule),
    no other kernel, the fixed-point scan run; job totals finite fp32, the
    `baseline` and `local` mean job totals within JAX's gate of fp32's.
    Then K3 bf16's device us by phase and ns a pivot step, beside the
    float32 K3's on the same matrix, call us, plain ms and bound: 2 N^3
    adds and mins at the card's bf16x2 rate (the bound), and at the fp32
    path's rate."""
    from multihop_offload_tpu_torch.graphs.cases import large_request
    from multihop_offload_tpu_torch.large_scale import LARGE_APSP, MODEL
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.precision import resolve_precision
    from multihop_offload_tpu_torch.train.driver import eval_methods

    bf = torch.bfloat16
    b, n, _ = d.shape
    nb = n // mp.FW_TILE
    d16 = d.to(bf).contiguous()
    for tag, x in (("1x1024", d16), ("2x384", d384.to(bf))):
        launches = (mp.blocked_fw_cuda.launches_bf16, mp.blocked_fw_cuda.launches)
        outs = [mp.blocked_fw_cuda(x) for _ in range(2)]
        ref = mp.blocked_fw_plain(x)
        torch.cuda.synchronize()
        per_call = 3 * (x.shape[-1] // mp.FW_TILE)
        got = (mp.blocked_fw_cuda.launches_bf16 - launches[0],
               mp.blocked_fw_cuda.launches - launches[1])
        bad = [int((o != ref).sum()) for o in outs]
        if tag == "2x384":
            bad.append(int((outs[0].cpu() != mp.blocked_fw_plain(x.cpu())).sum()))
        if any(bad) or got != (2 * per_call, 0) or outs[0].dtype != bf:
            raise AssertionError(f"K3 bf16 {tag}: entries differ {bad}, launches {got}")
    log(f"K3 blocked_fw bf16 B,N in [1x1024 (the path's predicted delays), 2x384]: "
        f"bit-identical to blocked_fw_plain in bf16 on the card on 2 calls (and on the CPU "
        f"at 2x384), 3 N / 128 launches a call, no float32 K3")

    # ---- main path: eval_methods under bf16, counts at 0 just before -------
    pol = resolve_precision("bf16", device=dev)
    t0 = time.perf_counter()
    inst, jobs, _ = large_request(case, dtype=pol.storage_dtype, device=dev)
    model = load_model(MODEL, device=dev, policy=pol)
    build_s = time.perf_counter() - t0
    reset_counts()
    totals = eval_methods(model, inst, jobs, device=dev, precision=pol, apsp_impl=LARGE_APSP)
    counts = read_counts()
    want = {"blocked_fw_bf16": 2 * 3 * nb}
    check_launches(f"large bf16 eval_methods (B=1, N={n})", counts, want)
    if counts["fixed_point_scan"] == 0:
        raise AssertionError("large bf16 eval_methods: the fixed-point scan did not run")
    mask = jobs.mask
    rel = {}
    for name, tot, ref in zip(("baseline", "local", "gnn"), totals, fp32_totals):
        if tot.dtype != torch.float32 or not torch.isfinite(tot[mask]).all():
            raise AssertionError(f"large bf16 {name}: job totals not finite fp32")
        m16, m32 = float(tot[mask].double().mean()), float(ref[mask].double().mean())
        rel[name] = abs(m16 - m32) / abs(m32)
    log(f"large bf16 eval_methods: mean job total rel to fp32 on the card {rel} (gate "
        f"{BF16_GATE_TAU} on baseline and local); the case built at bf16 in {build_s:.2f} s")
    if not (rel["baseline"] <= BF16_GATE_TAU and rel["local"] <= BF16_GATE_TAU):
        raise AssertionError(f"large bf16 eval_methods: mean job totals {rel}")
    eval_ms = wall_ms(lambda: eval_methods(model, inst, jobs, device=dev, precision=pol,
                                           apsp_impl=LARGE_APSP), 3)

    # ---- timing ----------------------------------------------------------------
    k3 = clocks(lambda: mp.blocked_fw_cuda(d16), 50, kernels_per_call=3 * nb + 1)
    phases = k3_phase_us(device_us.last)
    lost = device_us.last["lost_records"]
    k3_32 = clocks(lambda: mp.blocked_fw_cuda(d), 50, kernels_per_call=3 * nb + 1)
    phases32 = k3_phase_us(device_us.last)
    plain_ms = cuda_ms(lambda: mp.blocked_fw_plain(d16), 3, warmup=1)
    ops_ms = 2.0 * b * n ** 3 / PEAK_BF16X2_OPS_PER_S * 1e3
    bytes_ms = 2 * b * n * n * 2 / PEAK_BYTES_PER_S * 1e3
    rec = {"shape": [b, n], "launches": counts["blocked_fw_bf16"], "launches_per_call": 3 * nb,
           "counts": counts, "device_us": k3["device_ms"] * 1e3, "call_us": k3["ms"] * 1e3,
           "host_us": k3["host_us"], "phase_device_us": phases,
           "pivot_ns_per_step": phases["pivot"] * 1e3 / n, "lost_records": lost,
           "plain_ms": plain_ms, "bound_us": max(ops_ms, bytes_ms) * 1e3,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bound_rate": BF16_RATE, "bound_fp32_path_us": max(2 * ops_ms, bytes_ms) * 1e3,
           "fp32_device_us": k3_32["device_ms"] * 1e3, "fp32_phase_device_us": phases32,
           "fp32_pivot_ns_per_step": phases32["pivot"] * 1e3 / n,
           "eval_methods_ms": eval_ms, "mean_job_total_rel_to_fp32": rel}
    log(f"timing on {card['smi']}: K3 blocked_fw bf16 B,N={(b, n)} per call ({3 * nb} "
        f"launches): device {rec['device_us']:.1f} us (pivot {phases['pivot']:.2f}, "
        f"{rec['pivot_ns_per_step']:.1f} ns a step; panels {phases['panels']:.2f}; outer "
        f"{phases['outer']:.2f}; input clone {phases['clone']:.2f}; {lost} records lost; "
        f"fp32 K3 on the same matrix {rec['fp32_device_us']:.1f} us: pivot "
        f"{phases32['pivot']:.2f}, {rec['fp32_pivot_ns_per_step']:.1f} ns a step, panels "
        f"{phases32['panels']:.2f}, outer {phases32['outer']:.2f}), "
        f"call {rec['call_us']:.1f} us, host {rec['host_us']:.1f} us; plain {plain_ms:.3f} "
        f"ms; bound {rec['bound_us']:.2f} us (operations at the bf16x2 rate; "
        f"{rec['bound_fp32_path_us']:.2f} at the fp32 path's); large bf16 eval_methods "
        f"{eval_ms:.2f} ms")
    return rec


ROUTE_NODES = 300  # BA(300, m=2): pad N 304, which the blocked FW pads to 384


def route_phase(dev, card) -> dict:
    """Slice 16: the default Config's APSP route (`apsp_impl='xla'`, JAX's
    default) squares at every N.  On 2 BA(300, m=2) networks
    (`serve.workload.case_pool`, pad N 304, which the `'pallas'` route pads
    to 384) x 2 job sets, one `eval_methods` in fp32 (model of record) and
    one under bf16, each with every count at 0 just before it and read just
    after, its launches held to the counts the same calls make on the CPU
    (`count_plain`): K2 (fp32, then bf16) launched, K3 in neither dtype.
    The outcomes are held to that CPU run (`compare` in fp32,
    `compare_bf16` under bf16), and K2 to `minplus_closure_plain` bit for
    bit, a launch a squaring, on the (B, N) = (4, 304) matrix the path hands
    it (captured from one more decision, outside the counted run)."""
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import CaseRecord, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.precision import resolve_precision
    from multihop_offload_tpu_torch.serve.workload import case_pool
    from multihop_offload_tpu_torch.train.driver import eval_methods

    t0 = time.perf_counter()
    cfg = Config(arrival_scale=0.15)
    cases = [CaseRecord(topo=c.topo, roles=c.roles, proc_bws=c.proc_bws,
                        link_rates=np.full(c.topo.num_links, c.base_rate), seed=i,
                        name=f"ba{ROUTE_NODES}-{i}")
             for i, c in enumerate(case_pool([ROUTE_NODES], per_size=2, seed=16))]
    out = {"counts": {}, "k2": {}, "card_vs_cpu": {}}
    orig = mp.minplus_closure
    for name in ("fp32", "bf16"):
        pol = resolve_precision(name, device=dev)
        dtype = pol.storage_dtype if pol.mixed else torch.float32
        inst_cpu, jobs_cpu, pad = request_batch(cases, 2, seed=0, cfg=cfg, device="cpu",
                                                dtype=dtype)
        paths = {impl: mp.resolve_apsp(impl, pad.n)[1] for impl in ("xla", "pallas")}
        if (cfg.apsp_impl, mp.padded_n(pad.n)) != ("xla", 384) or paths != {
                "xla": "squaring", "pallas": "blocked-fw"}:
            raise AssertionError(f"route: Config's {cfg.apsp_impl}, {pad}, paths {paths}")
        out["pad"], out["paths"] = [pad.n, pad.l, pad.s, pad.j], paths
        tag = f"route {name} eval_methods (B={inst_cpu.adj.shape[0]}, N={pad.n})"
        m_cpu = load_model(MODEL_K1, device="cpu", policy=pol)
        model = load_model(MODEL_K1, device=dev, policy=pol)
        cpu_out, want = count_plain(
            lambda: outcomes(m_cpu, inst_cpu, jobs_cpu, "cpu", precision=pol,
                             apsp_impl=cfg.apsp_impl))
        inst, jobs = inst_cpu.to(dev), jobs_cpu.to(dev)
        reset_counts()
        totals = eval_methods(model, inst, jobs, device=dev, precision=pol,
                              apsp_impl=cfg.apsp_impl)
        counts = read_counts()
        check_launches(tag, counts, want)
        if (counts["minplus" + ("_bf16" if pol.mixed else "")] == 0 or counts["blocked_fw"] or counts["blocked_fw_bf16"]
                or not all(torch.isfinite(t[jobs.mask]).all() for t in totals)):
            raise AssertionError(f"{tag}: K2 must launch, K3 not, totals finite: {counts}")
        out["counts"][f"route_eval_methods_{name}"] = counts

        # the operand the path hands K2, from one more decision
        captured = {}

        def capture(d, iters, owned=False):
            captured.setdefault("d", (d.clone(), iters))
            return orig(d, iters, owned)

        mp.minplus_closure = capture
        try:
            card_out = outcomes(model, inst, jobs, dev, precision=pol, apsp_impl=cfg.apsp_impl)
        finally:
            mp.minplus_closure = orig
        for mname, tot in zip(("baseline", "local", "gnn"), totals):
            if not torch.equal(tot, card_out[mname].job_total):
                raise AssertionError(f"{tag}: eval_methods {mname} differs from its policy")
        if pol.mixed:
            out["card_vs_cpu"][name] = compare_bf16(f"{tag} card vs CPU", card_out, cpu_out,
                                                    jobs_cpu.mask, BF16_CARD_VS_CPU, True)
        else:
            compare(tag, card_out, cpu_out, jobs_cpu.mask)
        d, iters = captured["d"]
        b, n, _ = d.shape
        sfx = "_bf16" if pol.mixed else ""
        launches = getattr(mp.minplus_closure_cuda, "launches" + sfx)
        ex0 = read_counts()["squarings" + sfx]
        got = mp.minplus_closure_cuda(d, iters)
        ran = read_counts()["squarings" + sfx] - ex0
        launched = getattr(mp.minplus_closure_cuda, "launches" + sfx) - launches
        ref = mp.minplus_closure_plain(d, iters)
        run_plain = mp.squarings_run_plain(d, iters)
        if (d.dtype != (torch.bfloat16 if pol.mixed else torch.float32) or (b, n) != (4, pad.n)
                or not torch.equal(got, ref) or launched != iters or ran != run_plain):
            raise AssertionError(f"route K2 {name} at {tuple(d.shape)} {d.dtype}: "
                                 f"{int((got != ref).sum())} entries differ from "
                                 f"minplus_closure_plain, {launched} launches (want {iters}), "
                                 f"{ran} squarings run (plain {run_plain})")
        plan = mp.tile_plan(b, n, d.dtype)
        out["k2"][name] = {"shape": [b, n], "dtype": str(d.dtype), "iters": iters,
                           "squarings_run": ran, "plan": plan}
        log(f"route K2 {name} on the path's own W, B,N={(b, n)}: bit-identical to "
            f"minplus_closure_plain (bar: torch.equal), {iters} launches, {ran} of "
            f"{b * iters} squarings run (= squarings_run_plain), plan {plan}")
    out["seconds"] = time.perf_counter() - t0
    log(f"route phase {out['seconds']:.1f} s")
    return out


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


# ---- slice 13: the closed-loop packet simulator ------------------------------

# `cli/sim.py`'s main path at the paper's largest network size: 16 BA(110,
# m=2) networks (graph seeds seed + 100 i; pads N 112, L 216, J 100)
SIM_FULL = dict(sim_fleet=16, sim_nodes=110, sim_jobs=100, sim_util=0.7, sim_margin=5.0,
                sim_cap=128, sim_rounds=4, sim_slots=125)
SIM_RUNS = (
    ("gnn_dense", dict(sim_policy="gnn", sim_model=MODEL_K1)),
    ("gnn_sparse", dict(sim_policy="gnn", sim_model=MODEL_K2, layout="sparse")),
    ("baseline", dict(sim_policy="baseline")),
    ("local", dict(sim_policy="local")),
    ("baseline_fail", dict(sim_policy="baseline", sim_fail_links=2, sim_fail_nodes=1)),
)
# the card against the CPU under injected draws (made on the CPU from a
# seed): SIM_RUNS' cells cut to 4 networks and 2 x 200 slots.  Both models
# keep every job local at n = 110 (the JAX simulator's gnn too), so gnn is
# held again on 10-node networks, where both models offload every job
SIM_PAIR = dict(sim_fleet=4, sim_rounds=2, sim_slots=200)
SIM_PAIR_RUNS = (
    ("baseline", "baseline", {}),
    ("local", "local", {}),
    ("gnn_dense", "gnn_dense", {}),
    ("gnn_dense_n10", "gnn_dense", dict(sim_nodes=10, sim_jobs=4)),
    ("gnn_sparse_n10", "gnn_sparse", dict(sim_nodes=10, sim_jobs=4)),
)
# the committed JAX record's own sweep settings (`benchmarks/sim_fidelity.json`
# config): at the function's defaults (margin 5, 5 x 1000 slots, 50 served)
# neither package meets the 0.10 bar on the CPU (JAX 0.127, the port 0.111)
SIM_FIDELITY = dict(margin=10.0, slots_per_round=5000, min_served=150)
SIM_KERNELS = ("fixed_point", "minplus", "chebconv")


def count_plain(fn):
    """(fn(), launches) with the plain versions' calls counted as the
    launches their kernels make for them, by the dtype they receive: K1 one
    a forward call of its autograd Function (and only on float32 or
    wider), K2 one a squaring of the schedule (`minplus` or
    `minplus_bf16`; on the tape, `minplus_closure_diff_plain`, also K2's
    backward, `minplus_bwd`, `bwd_launches(iters)` a backward: the RL step
    runs the backward of every APSP it takes), K3 3 N / 128 a call (1 at N = 128;
    `blocked_fw` or `blocked_fw_bf16`), K6 one a call plus its squarings
    (or K3's launches on the `pallas` route's blocked FW), K4 one a call (`chebconv` or
    `chebconv_bf16`; the bf16 transposed walk `chebconv_bf16_t`).  Runs on
    the CPU; gradients flow where `fn` enables them."""
    from multihop_offload_tpu_torch.ops import chebconv as cc
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp

    counts: dict = {}

    def add(key, n):
        counts[key] = counts.get(key, 0) + n

    def suffix(t):
        return "_bf16" if t.dtype == torch.bfloat16 else ""

    def k1(*a, **k):
        if any(t.dtype == torch.bfloat16 for t in a[:4]):
            raise AssertionError("K1 received bf16: the fixed_point island broke")
        add("fixed_point", 1)
        return orig["_forward"](*a, **k)

    def k2(d, iters, *a, **k):
        add("minplus" + suffix(d), iters)
        return orig["minplus_closure"](d, iters, *a, **k)

    def k3(d, *a, **k):
        nb = d.shape[-1] // mp.FW_TILE
        add("blocked_fw" + suffix(d), 3 * nb if nb > 1 else 1)
        return orig["blocked_fw_plain"](d, *a, **k)

    def k6(ends, mask, delays, n, path=None):
        add("coo_apsp" + suffix(delays), 1)
        if (path or mp.apsp_path(n)) != "blocked-fw":  # K3's launches count themselves
            add("minplus" + suffix(delays), mp.squaring_count(n))
        return orig["apsp_coo_plain"](ends, mask, delays, n, path)

    def k4(rows, cols, vals, diag, x, *a, **k):
        add("chebconv" + suffix(x), 1)
        return orig["chebconv_propagate_plain"](rows, cols, vals, diag, x, *a, **k)

    def k4t(rows, cols, vals, diag, g):
        add("chebconv_bf16_t", 1)
        return orig["chebconv_transpose_bf16_plain"](rows, cols, vals, diag, g)

    def k2d(d, iters):
        add("minplus", iters)
        add("minplus_bwd", mp.bwd_launches(iters))
        return orig["minplus_closure_diff_plain"](d, iters)

    # K1: its autograd Function's forward (the backward recomputes the
    # plain scan on the card too, and the scan path launches no K1)
    wraps = {"_forward": (fp, k1), "minplus_closure": (mp, k2),
             "blocked_fw_plain": (mp, k3), "apsp_coo_plain": (mp, k6),
             "chebconv_propagate_plain": (cc, k4),
             "chebconv_transpose_bf16_plain": (cc, k4t),
             "minplus_closure_diff_plain": (mp, k2d)}
    orig = {name: getattr(mod, name) for name, (mod, _) in wraps.items()}
    for name, (mod, fn_) in wraps.items():
        setattr(mod, name, fn_)
    try:
        with torch.no_grad():
            out = fn()
    finally:
        for name, (mod, _) in wraps.items():
            setattr(mod, name, orig[name])
    return out, counts


def plain_policy_counts(cfg, scen) -> dict:
    """The launches one policy round asks of K1, K2 and K4, counted on
    the CPU (`count_plain`): the fleet and the policy's model moved there,
    one decision."""
    from multihop_offload_tpu_torch.cli.sim import load_gnn
    from multihop_offload_tpu_torch.sim.policies import make_policy
    from multihop_offload_tpu_torch.sim.state import liveness_masks

    kw = {"model": load_gnn(cfg, "cpu")[0]} if cfg.sim_policy == "gnn" else {}
    policy = make_policy(cfg.sim_policy, layout=cfg.layout, **kw)
    insts, jobss, paramss = (scen[k].to("cpu") for k in ("insts", "jobss", "paramss"))
    up = liveness_masks(insts, paramss, torch.zeros_like(insts.link_mask[:, 0], dtype=torch.int32))
    _, counts = count_plain(lambda: policy(insts, jobss, *up))
    return {k: counts.get(k, 0) for k in SIM_KERNELS}


def sim_pair_phase(dev, base) -> dict:
    """Card against CPU under injected draws (`SIM_PAIR_RUNS`): each fleet
    built once on the CPU, the draws made there from seed 13, run on both
    through `cli.sim.run_on`.  `baseline` and `local`: every SimState
    counter, `delay_sum` and `q_sojourn` identical (the scratch row
    excluded); `gnn`: `dst` agreement >= 0.99 in every round, and on the
    10-node cells the CPU run offloads in every round, so the agreement
    is over real decisions; every run conserves."""
    from multihop_offload_tpu_torch.cli.sim import (
        build_scenarios,
        fields_that_differ,
        offload_share,
        run_on,
        uniform_draws,
    )
    from multihop_offload_tpu_torch.sim.state import conservation_gap

    out = {}
    runs_by_name = dict(SIM_RUNS)
    for name, run_name, cut in SIM_PAIR_RUNS:
        cfg = dataclasses.replace(base, **{**SIM_FULL, **SIM_PAIR, **runs_by_name[run_name],
                                           **cut})
        scen = build_scenarios(cfg, "cpu")
        draws = uniform_draws(scen["sim"].spec, cfg.sim_fleet, cfg.sim_rounds,
                              cfg.sim_slots, seed=13)
        states, dsts = [], []
        for d in ("cpu", dev):
            _, run, rounds = run_on(cfg, scen, d, draws)
            states.append(run.state.to("cpu"))
            dsts.append([r[0] for r in rounds])
        (cpu, card), (cpu_rounds, card_rounds) = states, dsts
        mask = scen["jobss"].mask
        agree = [float((a == b)[mask].double().mean())
                 for a, b in zip(card_rounds, cpu_rounds)]
        offload = [offload_share(d, scen["jobss"]) for d in cpu_rounds]
        gaps = [int(conservation_gap(st).abs().max()) for st in (card, cpu)]
        differ = fields_that_differ(card, cpu)
        log(f"sim card vs CPU ({name}, fleet {cfg.sim_fleet}, n {cfg.sim_nodes}, J "
            f"{cfg.sim_jobs}, {cfg.sim_rounds} x {cfg.sim_slots} slots, injected draws): "
            f"dst agreement per round {agree}; offload share per round (CPU) {offload}; "
            f"state fields that differ {differ}; conservation gaps {gaps}; generated "
            f"{int(card.generated.sum())} / {int(cpu.generated.sum())}")
        if gaps != [0, 0]:
            raise AssertionError(f"sim {name}: packets not conserved: {gaps}")
        if cfg.sim_policy == "gnn":
            if min(agree) < 0.99:
                raise AssertionError(f"sim {name}: dst agreement {agree} below 0.99")
            if cfg.sim_nodes == 10 and min(offload) == 0:
                raise AssertionError(f"sim {name}: a round offloaded nothing: {offload}")
        elif differ or min(agree) < 1.0:
            raise AssertionError(f"sim {name}: card state differs from the CPU in {differ}")
        out[name] = {"dst_agreement": agree, "offload_share": offload,
                     "fields_differ": differ}
    return out


def sim_phase(dev, card) -> dict:
    """Slice 13: `cli/sim.py`'s main path on the card at full width
    (`SIM_FULL`) under each of `SIM_RUNS`, each with its launches counted
    from 0 around `FleetSim.run`; then the card against the CPU
    (`sim_pair_phase`), the kernels' device us at the path's own operands,
    the busy share over one segment, and `fidelity_sweep` at utilizations
    0.3 and 0.5 on its default fleet with the JAX record's settings
    (`SIM_FIDELITY`)."""
    from multihop_offload_tpu_torch.cli import sim as cli_sim
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.env.scheduling import local_greedy_mwis
    from multihop_offload_tpu_torch.ops import fixed_point as fp
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.sim.fidelity import fidelity_sweep
    from multihop_offload_tpu_torch.sim.runner import FleetSim
    from multihop_offload_tpu_torch.sim.state import liveness_masks

    from multihop_offload_tpu_torch.env import queueing as env_queueing

    t_phase = time.perf_counter()
    base = Config(model_root=os.path.join(ROOT, "build", "sim_no_checkpoint"))
    out, counts_by_run, captured = {"runs": {}}, {}, {}
    # the callers' names for the fixed point and the squarings, wrapped to
    # keep the first operands they pass on (the kernel wrappers stay as
    # they are, counters included)
    orig = {"fp": env_queueing.fixed_point, "mp": mp.minplus_closure}

    def capture_fp(*a, **k):
        captured.setdefault("fp", [x.clone() for x in a])
        return orig["fp"](*a, **k)

    def capture_mp(d, iters, owned=False):
        captured.setdefault("mp", (d.clone(), iters))
        return orig["mp"](d, iters, owned)

    for name, over in SIM_RUNS:
        cfg = dataclasses.replace(base, **SIM_FULL, **over)
        t0 = time.perf_counter()
        scen = cli_sim.build_scenarios(cfg, dev)
        build_s = time.perf_counter() - t0
        want = {k: v * cfg.sim_rounds for k, v in plain_policy_counts(cfg, scen).items()}
        sim = scen["sim"]
        rounds = cli_sim.record_rounds(sim)
        slots = cfg.sim_rounds * cfg.sim_slots
        sweeps0 = local_greedy_mwis.sweeps
        reset_counts()
        t0 = time.perf_counter()
        run = sim.run(scen["insts"], scen["jobss"], scen["paramss"], scen["seeds"])
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        sweeps = local_greedy_mwis.sweeps - sweeps0
        summary = cli_sim.summarize(cfg, scen, run)
        policy_ms = [r[1] for r in rounds]
        rec = {
            "policy": cfg.sim_policy, "layout": cfg.layout, "model": scen["model_source"],
            "pads": {"n": sim.spec.num_nodes, "l": sim.spec.num_links,
                     "j": sim.spec.num_jobs, "q": sim.spec.num_queues},
            "build_s": build_s, "wall_s": wall_s,
            "ms_per_round": sum(policy_ms) / len(policy_ms),
            "ms_per_slot": (wall_s * 1e3 - sum(policy_ms)) / slots,
            "mwis_sweeps_per_slot": sweeps / slots,
            "offload_share": [cli_sim.offload_share(r[0], scen["jobss"]) for r in rounds],
            "launches": {k: counts[k] for k in SIM_KERNELS}, "launches_want": want,
            "summary": {k: summary[k] for k in (
                "generated", "delivered", "dropped", "in_flight", "conservation_ok",
                "delivery_ratio", "mean_packet_delay_ul", "mean_packet_delay_dl",
                "fail_slot")},
            "matches_state": summary["devmetrics"]["matches_state"],
        }
        log(f"sim {name} (fleet {cfg.sim_fleet}, n {cfg.sim_nodes}, J {cfg.sim_jobs}, "
            f"{cfg.sim_rounds} x {cfg.sim_slots} slots, {rec['model']}): "
            f"launches {rec['launches']} (want {want}); {rec['ms_per_slot']:.3f} ms a slot, "
            f"{rec['ms_per_round']:.2f} ms a policy round, {rec['mwis_sweeps_per_slot']:.2f} "
            f"MWIS sweeps (host syncs) a slot, offload share per round "
            f"{rec['offload_share']}; generated {summary['generated']}, delivered "
            f"{summary['delivered']}, dropped {summary['dropped']}, conservation "
            f"{summary['conservation_ok']}, devmetrics match {rec['matches_state']}")
        if not (summary["conservation_ok"] and rec["matches_state"]):
            raise AssertionError(f"sim {name}: conservation or devmetrics failed: {summary}")
        if rec["launches"] != want or counts["coo_apsp"] or counts["blocked_fw"]:
            raise AssertionError(f"sim {name}: launches {counts}, want {want}")
        if cfg.sim_policy != "local" and not (counts["minplus"] and (
                cfg.sim_policy == "baseline" or counts["fixed_point"])):
            raise AssertionError(f"sim {name}: a kernel of the policy did not launch")
        if cfg.layout == "sparse" and not counts["chebconv"]:
            raise AssertionError(f"sim {name}: K4 did not launch")
        out["runs"][name] = rec
        counts_by_run[f"sim_{name}"] = counts
        if name == "gnn_dense":
            # the operands the path hands K1 and K2, from one more decision
            # (outside the counted run)
            env_queueing.fixed_point, mp.minplus_closure = capture_fp, capture_mp
            try:
                up = liveness_masks(scen["insts"], scen["paramss"], run.state.t)
                with torch.no_grad():
                    sim.policy_fn(scen["insts"], scen["jobss"], *up, None)
            finally:
                env_queueing.fixed_point, mp.minplus_closure = orig["fp"], orig["mp"]
        if name in ("gnn_dense", "local"):
            # one segment (1 round x 100 slots) under the profiler: the
            # card's busy share and its device records a slot
            seg = FleetSim(sim.spec, sim.policy_fn, rounds=1, slots_per_round=100)

            def segment():
                seg.run(scen["insts"], scen["jobss"], scen["paramss"], scen["seeds"])

            out["runs"][name]["segment_busy"] = busy_share(segment, wall_ms(segment, 3, 1))
            b = out["runs"][name]["segment_busy"]
            log(f"sim {name} segment (1 x 100 slots): busy {b['busy_ms']:.2f} of "
                f"{b['wall_ms']:.2f} ms (share {b['share']:.3f}), "
                f"{b['device_records'] / 100:.1f} device records a slot")

    # ---- K1 and K2 at the sim's own operands (gnn, dense) -------------------
    fp_args = captured["fp"]
    d, iters = captured["mp"]
    k1 = clocks(lambda: fp.fixed_point_cuda(*fp_args), 200)
    # 200 calls a window: on an H100 these traces lost 7-8 records a window
    # at 20 and 50 calls alike, and 15 at 100 late in the smoke, within
    # `device_us`'s tenth of the window only at 200
    k2 = clocks(lambda: mp.minplus_closure_cuda(d, iters), 200, kernels_per_call=2 + iters)
    out["kernels_on_path"] = {
        "fixed_point": {"shape": list(fp_args[3].shape), **k1},
        "minplus": {"shape": list(d.shape[:2]), "iters": iters, **k2}}
    log(f"sim path kernels on {card['smi']}: K1 at {list(fp_args[3].shape)} device "
        f"{k1['device_ms'] * 1e3:.2f} us (call {k1['ms'] * 1e3:.2f}); K2 at "
        f"{list(d.shape[:2])} ({iters} squarings) device {k2['device_ms'] * 1e3:.2f} us "
        f"(call {k2['ms'] * 1e3:.2f}, {k2['kernels_per_call']} kernels)")

    out["card_vs_cpu"] = sim_pair_phase(dev, base)

    t0 = time.perf_counter()
    fid = fidelity_sweep(utils=(0.3, 0.5), device=dev, **SIM_FIDELITY)
    acc = fid["acceptance"]
    out["fidelity"] = {"acceptance": acc, "s": time.perf_counter() - t0,
                       "link": [r["link"] for r in fid["sweep"]],
                       "config": fid["config"]}
    log(f"sim fidelity sweep (utils 0.3, 0.5; fleet 8 x 10 nodes, {SIM_FIDELITY}): max "
        f"link rel err at util <= 0.5 {acc['max_link_rel_err_util_le_0.5']} (bar 0.10), "
        f"{out['fidelity']['s']:.1f} s")
    if not acc["pass"]:
        raise AssertionError(f"sim fidelity acceptance failed: {acc}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["counts"] = counts_by_run
    log(f"sim phase {out['phase_s']:.1f} s")
    return out


# ---- slice 14: the bf16 precision policy --------------------------------------

BF16_ULP = 2.0 ** -8       # one bf16 unit in the last place, relative
BF16_GATE_TAU = 0.05       # JAX's bf16-vs-fp32 gate (`benchmarks/precision_ab.json`)
BF16_CARD_VS_CPU = 1e-2    # per-method mean job total, card vs CPU, both bf16
# the sim's bf16 run: the full-width fleet, 2 rounds of 250 slots
SIM_BF16 = dict(sim_policy="baseline", sim_rounds=2, sim_slots=250, precision="bf16")
# calls a profiler window in this phase, the smoke's last: late in the
# process an H100 trace lost 29 records a window of 200 calls, whatever
# the kernels a call, past `device_us`'s tenth of 200
WINDOW = 500
LAUNCH_KEYS = ("fixed_point", "minplus", "minplus_bf16", "coo_apsp", "coo_apsp_bf16",
               "chebconv", "chebconv_bf16", "chebconv_bf16_t", "blocked_fw",
               "blocked_fw_bf16", "minplus_bwd")


def check_launches(tag, counts: dict, want: dict) -> None:
    """Every kernel's launches equal the CPU run's prediction (kernels it
    does not name launched no time)."""
    got = {k: counts.get(k, 0) for k in LAUNCH_KEYS}
    exp = {k: want.get(k, 0) for k in LAUNCH_KEYS}
    log(f"{tag}: launches {got} (the CPU run predicts {exp})")
    if got != exp:
        raise AssertionError(f"{tag}: launches {got}, want {exp}")


def compare_bf16(tag, got: dict, want: dict, mask, rtol: float, exact_baseline: bool) -> dict:
    """Outcomes of the same requests: `dst` agreement per method (the
    `baseline` and `local` ones identical where `exact_baseline`; the GNN's
    >= 0.99 there), and each method's mean job total within `rtol`
    relative; job totals finite and fp32."""
    out = {}
    for method, g in got.items():
        w = want[method]
        tot, tot_w = g.job_total.cpu(), w.job_total.cpu()
        if tot.dtype != torch.float32 or not torch.isfinite(tot[mask]).all():
            raise AssertionError(f"{tag}/{method}: job_total {tot.dtype}, not finite fp32")
        differ = (g.decision.dst.cpu() != w.decision.dst.cpu()) & mask
        agree = 1.0 - int(differ.sum()) / int(mask.sum())
        mean, mean_w = (float(t[mask].double().mean()) for t in (tot, tot_w))
        rel = abs(mean - mean_w) / abs(mean_w)
        out[method] = {"dst_agreement": agree, "mean_job_total": mean,
                       "mean_job_total_ref": mean_w, "mean_rel_delta": rel}
        log(f"{tag}/{method}: dst agreement {agree:.4f} ({int(differ.sum())} of "
            f"{int(mask.sum())} jobs differ); mean job total {mean:.6f} against "
            f"{mean_w:.6f} (rel {rel:.3e}, bar {rtol})")
        if exact_baseline and (agree < (1.0 if method != "gnn" else 0.99)):
            raise AssertionError(f"{tag}/{method}: dst agreement {agree}")
        if not rel <= rtol:
            raise AssertionError(f"{tag}/{method}: mean job total rel {rel} > {rtol}")
    return out


def compare_bf16_rows(tag: str, got: list, want: list, rtol: float, strict: bool) -> dict:
    """Evaluator CSV rows of the same files: per method, the mean `tau`
    within `rtol` relative, and the rows whose `congest_jobs` is identical
    and `tau` within `rtol` counted; `strict` (both runs bf16): every
    `baseline` and `local` row and >= 99% of the `GNN` rows so."""
    if len(got) != len(want) or any(g["filename"] != w["filename"] or g["Algo"] != w["Algo"]
                                    for g, w in zip(got, want)):
        raise AssertionError(f"{tag}: rows out of step")
    out = {}
    for algo in ("baseline", "local", "GNN"):
        pairs = [(g, w) for g, w in zip(got, want) if g["Algo"] == algo]
        a = np.array([float(g["tau"]) for g, _ in pairs])
        b = np.array([float(w["tau"]) for _, w in pairs])
        same = sum(g["congest_jobs"] == w["congest_jobs"] and abs(x - y) <= rtol * abs(y)
                   for (g, w), x, y in zip(pairs, a, b))
        rel = abs(a.mean() - b.mean()) / abs(b.mean())
        out[algo] = {"rows": len(pairs), "rows_within": int(same), "mean_tau": a.mean(),
                     "mean_tau_ref": b.mean(), "mean_rel_delta": rel}
        log(f"{tag}/{algo}: {same} of {len(pairs)} rows with equal congest_jobs and tau "
            f"within {rtol}; mean tau {a.mean():.6f} against {b.mean():.6f} (rel {rel:.3e})")
        floor = 1.0 if algo != "GNN" else 0.99
        if not rel <= rtol or (strict and same < floor * len(pairs)):
            raise AssertionError(f"{tag}/{algo}: {out[algo]}")
    return out


def compare_served(tag: str, got: dict, want: dict) -> dict:
    """The service's answers under bf16 against fp32 on the same requests:
    `dst` agreement over all jobs >= 0.99 (JAX's floor) and the mean job
    total within JAX's gate `BF16_GATE_TAU` relative."""
    g = np.concatenate([got[k].dst for k in sorted(want)])
    w = np.concatenate([want[k].dst for k in sorted(want)])
    agree = float((g == w).mean())
    mean, mean_w = (float(np.concatenate([r[k].job_total for k in sorted(want)])
                          .astype(np.float64).mean()) for r in (got, want))
    rel = abs(mean - mean_w) / abs(mean_w)
    log(f"{tag}: dst agreement {agree:.4f} over {g.size} jobs (bar 0.99); mean job "
        f"total {mean:.6f} against {mean_w:.6f} (rel {rel:.3e}, bar {BF16_GATE_TAU})")
    if agree < 0.99 or not rel <= BF16_GATE_TAU:
        raise AssertionError(f"{tag}: dst agreement {agree}, mean job total rel {rel}")
    return {"dst_agreement": agree, "jobs": int(g.size), "mean_job_total": mean,
            "mean_job_total_ref": mean_w, "mean_rel_delta": rel}


def bf16_kernel_phase(dev, card, inst, sp_inst) -> dict:
    """K2, K6 and K4 (forward and transposed walk) in bf16 against their
    plain versions on the card, at the bf16 paths' shapes: K2 bit for bit
    with the squarings run of `squarings_run_plain` on the paper batch's
    APSP input (64, 112), the service's (16, 56), (16, 112) and the rung's
    (4, 256); K6 bit for bit at (64, L 216 -> N 112), one build and
    `squaring_count(n)` squarings; K4's forward within one bf16 ulp and its
    transposed walk bit for bit on 3 calls, at (64, 328, 32) and (16, 328,
    4).  Then each one's device us, call us, plain ms, bound (2 B an
    element; K2 and K6 also their adds and mins at the card's bf16x2 rate,
    `BF16_RATE`, with the fp32 path's rate beside it) and the float32
    kernel's device us at the same shape, K2 with its bf16 tile plan
    (`ops.minplus.tile_plan(..., bfloat16)`) beside the float32 one and the
    squarings the float32 kernel runs on the same matrices (float32 sums
    can reach the fixed point in fewer); K4
    beside `torch.bmm` in bf16 on the dense support (the transposed walk on
    its transpose)."""
    from multihop_offload_tpu_torch.env.apsp import weight_matrix_from_link_delays
    from multihop_offload_tpu_torch.layouts.sparse import (
        CsrIndex,
        SparseSupport,
        sparse_chebyshev_support,
    )
    from multihop_offload_tpu_torch.models.chebconv import cast_support, chebyshev_support
    from multihop_offload_tpu_torch.ops import chebconv as cc
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.ops.sparse import COO

    bf = torch.bfloat16
    out = {"minplus_bf16": {}, "coo_apsp_bf16": {}, "chebconv_bf16": {},
           "chebconv_bf16_t": {}}
    # ---- K2 ----------------------------------------------------------------
    w = weight_matrix_from_link_delays(inst.adj, inst.link_index, 1.0 / inst.link_rates)
    n = w.shape[-1]
    paper_d = torch.where(torch.eye(n, dtype=torch.bool, device=dev), 0.0, w).to(bf)
    shapes = {"paper": paper_d.contiguous(),
              **{f"{b}x{m}": minplus_input(b, m).to(dev).to(bf)
                 for b, m in ((16, 56), (16, 112), (4, 256))}}
    for tag, d in shapes.items():
        b, m, _ = d.shape
        iters = mp.squaring_count(m)
        launches = (mp.minplus_closure_cuda.launches_bf16, mp.minplus_closure_cuda.launches)
        ex0 = mp.squarings_executed(bf)
        got = mp.minplus_closure_cuda(d, iters)
        torch.cuda.synchronize()
        ran = mp.squarings_executed(bf) - ex0
        pair = (mp.minplus_closure_cuda.launches_bf16 - launches[0],
                mp.minplus_closure_cuda.launches - launches[1])
        ref = mp.minplus_closure_plain(d, iters)
        want_ran = mp.squarings_run_plain(d, iters)
        if not torch.equal(got, ref) or got.dtype != bf:
            raise AssertionError(f"K2 bf16 {tag}: {int((got != ref).sum())} entries differ")
        if pair != (iters, 0) or ran != want_ran:
            raise AssertionError(f"K2 bf16 {tag}: launches or squarings run {ran} "
                                 f"(squarings_run_plain {want_ran})")
        t = clocks(lambda: mp.minplus_closure_cuda(d, iters), WINDOW,
                   kernels_per_call=2 + iters)
        d32 = d.float()
        ex32 = read_counts()["squarings"]
        mp.minplus_closure_cuda(d32, iters)
        ran32 = read_counts()["squarings"] - ex32  # float32 sums converge sooner
        t32 = clocks(lambda: mp.minplus_closure_cuda(d32, iters), WINDOW,
                     kernels_per_call=2 + iters)
        plain_ms = cuda_ms(lambda: mp.minplus_closure_plain(d, iters), 5, 1)
        ops_ms = 2.0 * m ** 3 * ran / PEAK_BF16X2_OPS_PER_S * 1e3
        bytes_ms = 2 * b * m * m * 2 / PEAK_BYTES_PER_S * 1e3
        plan, plan32 = mp.tile_plan(b, m, bf), mp.tile_plan(b, m)
        out["minplus_bf16"][tag] = {
            "shape": [b, m], "iters": iters, "squarings_run": ran,
            "device_us": t["device_ms"] * 1e3, "call_us": t["ms"] * 1e3,
            "host_us": t["host_us"], "plain_ms": plain_ms,
            "bound_us": max(ops_ms, bytes_ms) * 1e3,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_rate": BF16_RATE,
            # the same operations at the fp32 path's rate, for comparison
            # with the float32 kernel
            "bound_fp32_path_us": max(2 * ops_ms, bytes_ms) * 1e3,
            "fp32_device_us": t32["device_ms"] * 1e3, "fp32_call_us": t32["ms"] * 1e3,
            "fp32_squarings_run": ran32, "plan": plan, "fp32_plan": plan32}
        r = out["minplus_bf16"][tag]
        log(f"K2 bf16 minplus {tag} B,N={(b, m)}: bit-identical to plain bf16, {iters} "
            f"launches, {ran} squarings run (= squarings_run_plain); bf16 plan {plan} "
            f"(fp32 {plan32}); on {card['smi']}: device {r['device_us']:.2f} us (fp32 kernel "
            f"{r['fp32_device_us']:.2f} on the same matrices, {ran32} squarings run), call "
            f"{r['call_us']:.2f} us, plain {plain_ms:.3f} ms, bound {r['bound_us']:.2f} us "
            f"({r['bound_by']})")
    # ---- K6 ----------------------------------------------------------------
    n6 = sp_inst.num_pad_nodes
    b6, l6 = sp_inst.link_rates.shape
    delays = (1.0 / sp_inst.link_rates).to(bf).contiguous()
    args6 = (sp_inst.link_ends, sp_inst.link_mask, delays, n6)
    before = (mp.apsp_coo_cuda.launches_bf16, mp.minplus_closure_cuda.launches_bf16)
    ex0 = mp.squarings_executed(bf)
    got = mp.apsp_minplus_coo(*args6)
    torch.cuda.synchronize()
    sq6 = mp.squarings_executed(bf) - ex0
    pair = (mp.apsp_coo_cuda.launches_bf16 - before[0],
            mp.minplus_closure_cuda.launches_bf16 - before[1])
    if pair != (1, mp.squaring_count(n6)) or not torch.equal(got, mp.apsp_coo_plain(*args6)):
        raise AssertionError(f"K6 bf16: launches {pair} or entries differ")
    t = clocks(lambda: mp.apsp_coo_cuda(*args6), WINDOW,
               kernels_per_call=2 + mp.squaring_count(n6))
    args32 = (sp_inst.link_ends, sp_inst.link_mask, delays.float(), n6)
    t32 = clocks(lambda: mp.apsp_coo_cuda(*args32), WINDOW,
                 kernels_per_call=2 + mp.squaring_count(n6))
    plain_ms = cuda_ms(lambda: mp.apsp_coo_plain(*args6), 3, 1)
    ops_ms = 2.0 * n6 ** 3 * sq6 / PEAK_BF16X2_OPS_PER_S * 1e3
    bytes_ms = b6 * (l6 * 11 + n6 * n6 * 2) / PEAK_BYTES_PER_S * 1e3
    out["coo_apsp_bf16"]["paper"] = {
        "shape": [b6, l6, n6], "squarings_run": sq6, "launches_per_call": list(pair),
        "device_us": t["device_ms"] * 1e3, "call_us": t["ms"] * 1e3, "host_us": t["host_us"],
        "plain_ms": plain_ms, "bound_us": max(ops_ms, bytes_ms) * 1e3,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_rate": BF16_RATE,
        "bound_fp32_path_us": max(2 * ops_ms, bytes_ms) * 1e3,
        "fp32_device_us": t32["device_ms"] * 1e3, "fp32_call_us": t32["ms"] * 1e3,
        "plan": mp.tile_plan(b6, n6, bf)}
    r = out["coo_apsp_bf16"]["paper"]
    log(f"K6 bf16 coo_apsp B,L,N={(b6, l6, n6)}: bit-identical to the plain chain in bf16, "
        f"launches (build, squarings) {pair}, {sq6} squarings run, bf16 plan {r['plan']}; device "
        f"{r['device_us']:.2f} us (fp32 {r['fp32_device_us']:.2f}), call {r['call_us']:.2f} "
        f"us, plain {plain_ms:.3f} ms, bound {r['bound_us']:.2f} us ({r['bound_by']})")
    # ---- K4's forward --------------------------------------------------------
    sup32 = sparse_chebyshev_support(sp_inst.sparse.ext, mask=sp_inst.ext_mask,
                                     csr=sp_inst.sparse.ext_csr)
    sup = cast_support(sup32, bf)
    dense = chebyshev_support(inst.adj_ext, inst.ext_mask, dtype=bf).contiguous()
    gen = torch.Generator(device=dev).manual_seed(14)
    for f, rows in ((32, slice(None)), (4, slice(0, 16))):
        e0, c0 = sup.edges, sup.csr
        s = SparseSupport(
            edges=COO(rows=e0.rows[rows].contiguous(), cols=e0.cols[rows].contiguous(),
                      vals=e0.vals[rows].contiguous(), shape=e0.shape),
            diag=sup.diag[rows].contiguous(),
            csr=CsrIndex(row_ptr=c0.row_ptr[rows].contiguous(),
                         col_ptr=c0.col_ptr[rows].contiguous(),
                         col_order=c0.col_order[rows].contiguous()))
        b, e = s.diag.shape
        x = torch.randn((b, e, f), generator=gen, device=dev).to(bf)
        e_ = s.edges
        launches = cc.chebconv_propagate_cuda.launches_bf16
        got = cc.chebconv_propagate(s, x)
        again = cc.chebconv_propagate(s, x)
        launched = cc.chebconv_propagate_cuda.launches_bf16 - launches
        ref = cc.chebconv_propagate_plain(e_.rows, e_.cols, e_.vals, s.diag, x)
        torch.cuda.synchronize()
        err = ((got.float() - ref.float()).abs()
               - (BF16_ULP * ref.float().abs() + 1e-6)).max().item()
        if launched != 2 or err > 0 or not torch.equal(got, again):
            raise AssertionError(f"K4 bf16 F={f}: beyond one ulp ({err}) or not "
                                 "deterministic")
        fwd = lambda: cc.chebconv_propagate_cuda(  # noqa: E731
            s.csr.row_ptr, None, e_.cols, e_.vals, s.diag, x)
        t = clocks(fwd, WINDOW, kernels_per_call=1)
        v32, d32, x32 = e_.vals.float(), s.diag.float(), x.float()
        t32 = clocks(lambda: cc.chebconv_propagate_cuda(s.csr.row_ptr, None, e_.cols, v32,
                                                        d32, x32), WINDOW,
                     kernels_per_call=1)
        plain_ms = cuda_ms(lambda: cc.chebconv_propagate_plain(e_.rows, e_.cols, e_.vals,
                                                               s.diag, x), 20)
        dsup = dense[rows]
        lib = clocks(lambda: torch.bmm(dsup, x), WINDOW)
        real = int((e_.vals != 0).sum())
        bytes_ms = (real * 6 + b * (e + 1) * 4 + b * e * 2 + 2 * b * e * f * 2) \
            / PEAK_BYTES_PER_S * 1e3
        ops_ms = 2.0 * (real + b * e) * f / PEAK_FP32_FLOP_PER_S * 1e3
        out["chebconv_bf16"][f"F{f}"] = {
            "shape": [b, e, f], "nnz_real": real, "max_ulp_excess": err,
            "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "device_us": t["device_ms"] * 1e3, "call_us": t["ms"] * 1e3,
            "host_us": t["host_us"], "plain_ms": plain_ms,
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "fp32_device_us": t32["device_ms"] * 1e3,
            "library": "torch.bmm bf16 (dense support)",
            "library_device_us": lib["device_ms"] * 1e3, "library_call_us": lib["ms"] * 1e3}
        r = out["chebconv_bf16"][f"F{f}"]
        log(f"K4 bf16 chebconv B,E,F={(b, e, f)} ({real} real entries): within one bf16 ulp "
            f"of plain, two calls bit-identical; device {r['device_us']:.2f} us (fp32 "
            f"{r['fp32_device_us']:.2f}), call {r['call_us']:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, bound {r['bound_us']:.3f} us ({r['bound_by']}); "
            f"torch.bmm bf16 device {r['library_device_us']:.2f} us")
        # ---- K4's bf16 transposed walk (the Trainer's backward) on the same lists
        g = torch.randn((b, e, f), generator=gen, device=dev).to(bf)
        tr_args = (s.csr.col_ptr, s.csr.col_order, e_.rows, e_.vals, s.diag, g)
        launches = cc.chebconv_propagate_cuda.launches_bf16_t
        outs_t = [cc.chebconv_propagate_cuda(*tr_args) for _ in range(3)]
        launched = cc.chebconv_propagate_cuda.launches_bf16_t - launches
        ref_t = cc.chebconv_transpose_bf16_plain(e_.rows, e_.cols, e_.vals, s.diag, g)
        torch.cuda.synchronize()
        bad = [int((o != ref_t).sum()) for o in outs_t]
        if launched != 3 or any(bad) or outs_t[0].dtype != bf:
            raise AssertionError(f"K4 bf16 transposed F={f}: {bad} entries differ from the "
                                 f"plain version, {launched} launches")
        tt = clocks(lambda: cc.chebconv_propagate_cuda(*tr_args), WINDOW, kernels_per_call=1)
        g32 = g.float()
        tt32 = clocks(lambda: cc.chebconv_propagate_cuda(s.csr.col_ptr, s.csr.col_order,
                                                         e_.rows, v32, d32, g32), WINDOW,
                      kernels_per_call=1)
        plain_t_ms = cuda_ms(lambda: cc.chebconv_transpose_bf16_plain(
            e_.rows, e_.cols, e_.vals, s.diag, g), 5, 1)
        dsup_t = dsup.transpose(1, 2).contiguous()
        lib_t = clocks(lambda: torch.bmm(dsup_t, g), WINDOW)
        # bytes: each real entry's entry id, gather id and value, the column
        # pointers, diag, g and out once
        bytes_t = (real * 10 + b * (e + 1) * 4 + b * e * 2 + 2 * b * e * f * 2) \
            / PEAK_BYTES_PER_S * 1e3
        out["chebconv_bf16_t"][f"F{f}"] = {
            "shape": [b, e, f], "nnz_real": real, "calls_bit_identical": 3,
            "max_abs_err": 0.0, "device_us": tt["device_ms"] * 1e3, "call_us": tt["ms"] * 1e3,
            "host_us": tt["host_us"], "plain_ms": plain_t_ms,
            "bound_us": max(bytes_t, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_t >= ops_ms else "operations",
            "fp32_device_us": tt32["device_ms"] * 1e3,
            "forward_device_us": t["device_ms"] * 1e3,
            "library": "torch.bmm bf16 (transposed dense support)",
            "library_device_us": lib_t["device_ms"] * 1e3, "library_call_us": lib_t["ms"] * 1e3}
        r = out["chebconv_bf16_t"][f"F{f}"]
        log(f"K4 bf16 transposed walk B,E,F={(b, e, f)}: bit-identical to "
            f"chebconv_transpose_bf16_plain on 3 calls; on {card['smi']}: device "
            f"{r['device_us']:.2f} us (bf16 forward {r['forward_device_us']:.2f}, fp32 "
            f"transposed {r['fp32_device_us']:.2f}), call {r['call_us']:.2f} us, plain "
            f"{plain_t_ms * 1e3:.2f} us, bound {r['bound_us']:.3f} us ({r['bound_by']}); "
            f"torch.bmm bf16 on the transposed dense support device "
            f"{r['library_device_us']:.2f} us")
    return out


def precision_phase(dev, card, paper, cfg, fp32_card: dict) -> dict:
    """Slice 14: the bf16 precision policy on the decision paths at full
    width.  `paper`: the committed networks of the paper batch; `fp32_card`:
    the card's float32 outcomes of the same requests (dense, model of
    record; sparse, SPECTRAL_K2).  Each path is driven with every count at
    0 just before it and read just after, and its launches held to the
    counts the same calls make on the CPU (`count_plain`); its answers are
    held to that CPU run and to fp32 on the card."""
    import shutil
    import tempfile

    from multihop_offload_tpu_torch.cli import sim as cli_sim
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import request_batch
    from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET
    from multihop_offload_tpu_torch.models.chebconv import load_model, load_weights
    from multihop_offload_tpu_torch.models.chebconv import params_from_jax
    from multihop_offload_tpu_torch.precision import resolve_precision
    from multihop_offload_tpu_torch.serve.workload import case_pool, request_stream
    from multihop_offload_tpu_torch.sim.state import liveness_masks
    from multihop_offload_tpu_torch.train import driver as drv
    from multihop_offload_tpu_torch.train.driver import eval_methods

    t_phase = time.perf_counter()
    pol = resolve_precision("bf16", device=dev)
    bf = pol.storage_dtype
    out: dict = {"policy": {"name": pol.name, "compute": str(pol.compute_dtype),
                            "accum": str(pol.accum_dtype), "storage": str(pol.storage_dtype)},
                 "paths": {}}
    counts_by_path = {}
    batches = {}
    for layout, name in (("dense", MODEL_K1), ("sparse", MODEL_K2)):
        i_cpu, j_cpu, _ = request_batch(paper, 4, seed=0, cfg=cfg, dtype=bf, device="cpu",
                                        layout=layout)
        batches[layout] = (i_cpu, j_cpu, load_model(name, device="cpu", layout=layout,
                                                    policy=pol),
                           load_model(name, device=dev, layout=layout, policy=pol))
    out["kernels"] = bf16_kernel_phase(dev, card, batches["dense"][0].to(dev),
                                       batches["sparse"][0].to(dev))
    for layout, (i_cpu, j_cpu, m_cpu, m_dev) in batches.items():
        tag = f"bf16 eval_methods ({layout}, {MODEL_K1 if layout == 'dense' else MODEL_K2})"
        cpu_out, want = count_plain(lambda: outcomes(m_cpu, i_cpu, j_cpu, "cpu", layout, pol))
        inst, jobs = i_cpu.to(dev), j_cpu.to(dev)
        reset_counts()
        totals = eval_methods(m_dev, inst, jobs, device=dev, layout=layout, precision=pol)
        counts = read_counts()
        check_launches(tag, counts, want)
        if counts["squarings_bf16"] <= 0:
            raise AssertionError(f"{tag}: no bf16 squaring ran")
        counts_by_path[f"bf16_eval_methods_{layout}"] = counts
        card_out = outcomes(m_dev, inst, jobs, dev, layout, pol)
        for mname, tot in zip(("baseline", "local", "gnn"), totals):
            if not torch.equal(tot, card_out[mname].job_total):
                raise AssertionError(f"{tag}: eval_methods {mname} differs from its policy")
        mask = j_cpu.mask
        rec = {"card_vs_cpu": compare_bf16(f"{tag} card vs CPU", card_out, cpu_out, mask,
                                           BF16_CARD_VS_CPU, True),
               "bf16_vs_fp32": compare_bf16(f"{tag} bf16 vs fp32 on the card", card_out,
                                            fp32_card[layout], mask, BF16_GATE_TAU, False)}
        fp32_model = fp32_card[f"{layout}_model"]
        i32, j32 = fp32_card[f"{layout}_batch"]
        ms16 = wall_ms(lambda: eval_methods(m_dev, inst, jobs, device=dev, layout=layout,
                                            precision=pol), 10)
        ms32 = wall_ms(lambda: eval_methods(fp32_model, i32, j32, device=dev, layout=layout), 10)
        busy16 = busy_share(lambda: eval_methods(m_dev, inst, jobs, device=dev,
                                                 layout=layout, precision=pol), ms16)
        busy32 = busy_share(lambda: eval_methods(fp32_model, i32, j32, device=dev, layout=layout), ms32)
        rec.update(launches=counts, ms_bf16=ms16, ms_fp32=ms32, busy_bf16=busy16,
                   busy_fp32=busy32)
        log(f"{tag}: {ms16:.2f} ms a batch of {inst.adj.shape[0]} (fp32 {ms32:.2f}); busy "
            f"{busy16['busy_ms']:.2f} ms, share {busy16['share']:.3f} (fp32 "
            f"{busy32['busy_ms']:.2f}, {busy32['share']:.3f})")
        out["paths"][f"eval_methods_{layout}"] = rec

    tmp = tempfile.mkdtemp(prefix="mho_bf16_")
    try:
        # ---- the Evaluator on the paper dataset ------------------------------
        ecfg = Config(datapath=PAPER_DATASET, out=os.path.join(tmp, "eval"),
                      model_root=os.path.join(tmp, "model"), arrival_scale=0.15, T=1000,
                      num_instances=10, precision="bf16")
        evs = {"card": drv.Evaluator(ecfg, device=dev),
               "cpu": drv.Evaluator(dataclasses.replace(ecfg, out=os.path.join(tmp, "cpu")),
                                    device="cpu"),
               "fp32": drv.Evaluator(dataclasses.replace(ecfg, out=os.path.join(tmp, "fp32"),
                                                         precision="fp32"), device=dev)}
        per_file = {"card": [], "cpu": []}
        for name, ev in evs.items():
            ev.model.load_state_dict(params_from_jax(load_weights(MODEL_K1)))
        inner = {k: evs[k]._eval_methods for k in per_file}

        def on_card(inst, jobs, gen):
            reset_counts()
            res = inner["card"](inst, jobs, gen)
            per_file["card"].append(read_counts())
            return res

        def on_cpu(inst, jobs, gen):
            res, c = count_plain(lambda: inner["cpu"](inst, jobs, gen))
            per_file["cpu"].append(c)
            return res

        evs["card"]._eval_methods, evs["cpu"]._eval_methods = on_card, on_cpu
        t0 = time.perf_counter()
        rows = {"card": read_csv_rows(evs["card"].run(verbose=False))}
        card_s = time.perf_counter() - t0
        rows["cpu"] = read_csv_rows(evs["cpu"].run(files_limit=4, verbose=False))
        t0 = time.perf_counter()
        rows["fp32"] = read_csv_rows(evs["fp32"].run(verbose=False))
        fp32_s = time.perf_counter() - t0
        want = per_file["cpu"][0]
        if len(per_file["card"]) != 20 or any(c != want for c in per_file["cpu"]):
            raise AssertionError(f"bf16 Evaluator: {len(per_file['card'])} files, CPU "
                                 f"launches {per_file['cpu']}")
        bad = [fid for fid, c in enumerate(per_file["card"])
               if any(c[k] != want.get(k, 0) for k in LAUNCH_KEYS)]
        log(f"bf16 Evaluator (dense, {MODEL_K1}, 20 files x 10 job sets): launches of "
            f"every file {per_file['card'][0]} (the CPU run predicts {want}); files that "
            f"differ {bad}; {card_s:.2f} s")
        if bad:
            raise AssertionError(f"bf16 Evaluator: launches of files {bad} differ")
        if not (want.get("minplus_bf16") and want.get("fixed_point")):
            raise AssertionError(f"bf16 Evaluator: the CPU run predicts {want}")
        log(f"bf16 Evaluator {card_s * 1e3 / 20:.2f} ms a file, fp32 "
            f"{fp32_s * 1e3 / 20:.2f} (whole runs of 20 files, bf16 first)")
        out["evaluator"] = {
            "rows": len(rows["card"]), "s": card_s, "ms_per_file": card_s * 1e3 / 20,
            "fp32_ms_per_file": fp32_s * 1e3 / 20,
            "launches_per_file": want,
            "card_vs_cpu": compare_bf16_rows("bf16 Evaluator card vs CPU (4 files)",
                                             rows["card"][:len(rows["cpu"])], rows["cpu"],
                                             BF16_CARD_VS_CPU, strict=True),
            "bf16_vs_fp32": compare_bf16_rows("bf16 Evaluator vs fp32 on the card",
                                              rows["card"], rows["fp32"], BF16_GATE_TAU,
                                              strict=False)}
        counts_by_path["bf16_evaluator_file0"] = per_file["card"][0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- the serving pool, dense and sparse ---------------------------------
    pool = case_pool([20, 50, 80, 110], per_size=2, seed=0)
    reqs = list(request_stream(pool, 256, seed=1, arrival_scale=0.15))
    base = dict(serve_slots=16, serve_queue_cap=64, serve_deadline_s=60.0)
    out["serving"] = {}
    for layout, model, n_req in (("dense", MODEL_K1, 256), ("sparse", MODEL_K2, 64)):
        tag = f"bf16 service {layout}"
        # fp32 first, in the same call: the yardstick of the bf16 run
        fcfg = Config(**base, serve_model=model, layout=layout,
                      cheb_k=2 if layout == "sparse" else 1)
        fsvc, _ = build_service(fcfg, pool=pool, device=dev)
        t0 = time.perf_counter()
        fres = check_conservation(f"fp32 service {layout}", fsvc,
                                  closed_loop(fsvc, reqs[:n_req]))
        fp32_rps = len(fres) / (time.perf_counter() - t0)
        scfg = dataclasses.replace(fcfg, precision="bf16")
        # the same requests served on the CPU under bf16: the launches the
        # card's run must make, and the answers it must give
        csvc, _ = build_service(scfg, pool=pool, device="cpu")
        cres, want = count_plain(lambda: check_conservation(
            f"{tag} on the CPU", csvc, closed_loop(csvc, reqs[:n_req])))
        svc, _ = build_service(scfg, pool=pool, device=dev)
        if svc.dtype != bf or not svc.precision.mixed:
            raise AssertionError("bf16 service: not packing bf16")
        reset_counts()
        t0 = time.perf_counter()
        res = check_conservation(tag, svc, closed_loop(svc, reqs[:n_req]))
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_launches(tag, counts, want)
        s = svc.stats.summary(wall_s=wall)
        rec = {"requests": len(res), "wall_s": wall, "requests_per_s": len(res) / wall,
               "fp32_requests_per_s": fp32_rps, "latency": s["latency"], "launches": counts,
               "card_vs_cpu": compare_responses(f"{tag} card vs CPU", res, cres,
                                                BF16_CARD_VS_CPU),
               "bf16_vs_fp32": compare_served(f"{tag} vs fp32 on the card", res, fres)}
        out["serving"][layout] = rec
        counts_by_path[f"bf16_service_{layout}"] = counts
        log(f"{tag} ({n_req} requests, 16 slots): every request answered once; "
            f"{len(res) / wall:.1f} requests/s (fp32 {fp32_rps:.1f}, just before); dst "
            f"agreement with fp32 {rec['bf16_vs_fp32']['dst_agreement']:.4f}")

    # ---- one baseline simulator run ------------------------------------------
    scfg = dataclasses.replace(Config(model_root=os.path.join(ROOT, "build",
                                                              "sim_no_checkpoint")),
                               **{**SIM_FULL, **SIM_BF16})
    # fp32 first, in the same call: the yardstick of the bf16 run
    fscen = cli_sim.build_scenarios(dataclasses.replace(scfg, precision="fp32"), dev)
    t0 = time.perf_counter()
    frun = fscen["sim"].run(fscen["insts"], fscen["jobss"], fscen["paramss"], fscen["seeds"])
    fp32_ms = (time.perf_counter() - t0) * 1e3 / (scfg.sim_rounds * scfg.sim_slots)
    scen = cli_sim.build_scenarios(scfg, dev)
    from multihop_offload_tpu_torch.sim.policies import make_policy

    cpu_policy = make_policy("baseline", precision=pol, layout=scfg.layout)
    insts, jobss, paramss = (scen[k].to("cpu") for k in ("insts", "jobss", "paramss"))
    up = liveness_masks(insts, paramss, torch.zeros_like(insts.link_mask[:, 0],
                                                         dtype=torch.int32))
    _, per_round = count_plain(lambda: cpu_policy(insts, jobss, *up))
    want = {k: v * scfg.sim_rounds for k, v in per_round.items()}
    reset_counts()
    t0 = time.perf_counter()
    run = scen["sim"].run(scen["insts"], scen["jobss"], scen["paramss"], scen["seeds"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    summary = cli_sim.summarize(scfg, scen, run)
    check_launches("bf16 sim baseline", counts, want)
    if not summary["conservation_ok"]:
        raise AssertionError(f"bf16 sim: conservation failed {summary}")
    slots = scfg.sim_rounds * scfg.sim_slots
    same_dst = float((run.routes.dst == frun.routes.dst).double().mean())
    out["sim"] = {"rounds": scfg.sim_rounds, "slots": slots, "wall_s": wall,
                  "ms_per_slot": wall * 1e3 / slots, "fp32_ms_per_slot": fp32_ms,
                  "last_round_dst_agreement_vs_fp32": same_dst, "launches": counts,
                  "delivered": summary["delivered"], "generated": summary["generated"]}
    counts_by_path["bf16_sim_baseline"] = counts
    log(f"bf16 sim baseline (fleet {scfg.sim_fleet}, n {scfg.sim_nodes}, {scfg.sim_rounds} x "
        f"{scfg.sim_slots} slots): conservation held, {out['sim']['ms_per_slot']:.3f} ms a "
        f"slot (fp32 {fp32_ms:.3f}, just before), delivered {summary['delivered']} of "
        f"{summary['generated']}; last round's dst agreement with fp32 {same_dst:.4f} "
        "(bar 0.99)")
    if same_dst < 0.99:
        raise AssertionError(f"bf16 sim: last round's dst agreement with fp32 {same_dst}")
    # the card against the CPU under bf16 at the pair cell (`SIM_PAIR`), one
    # fleet and one set of injected draws: every state field and every
    # round's routes identical
    pcfg = dataclasses.replace(scfg, **SIM_PAIR)
    pscen = cli_sim.build_scenarios(pcfg, "cpu")
    draws = cli_sim.uniform_draws(pscen["sim"].spec, pcfg.sim_fleet, pcfg.sim_rounds,
                                  pcfg.sim_slots, seed=13)
    pair = {}
    for d in ("cpu", dev):
        _, prun, prounds = cli_sim.run_on(pcfg, pscen, d, draws)
        pair[torch.device(d).type] = (prun.state.to("cpu"), [r[0].cpu() for r in prounds])
    differ = cli_sim.fields_that_differ(pair["cuda"][0], pair["cpu"][0])
    same_rounds = [bool(torch.equal(a, b)) for a, b in zip(pair["cuda"][1], pair["cpu"][1])]
    log(f"bf16 sim baseline card vs CPU (fleet {pcfg.sim_fleet}, {pcfg.sim_rounds} x "
        f"{pcfg.sim_slots} slots, injected draws): state fields that differ {differ}; "
        f"routes identical per round {same_rounds}")
    if differ or not all(same_rounds) or len(same_rounds) != pcfg.sim_rounds:
        raise AssertionError(f"bf16 sim card vs CPU: fields {differ}, rounds {same_rounds}")
    out["sim"]["card_vs_cpu"] = {"fleet": pcfg.sim_fleet, "rounds": pcfg.sim_rounds,
                                 "slots": pcfg.sim_slots, "fields_differ": differ,
                                 "routes_identical": same_rounds}
    out["phase_s"] = time.perf_counter() - t_phase
    out["counts"] = counts_by_path
    log(f"precision phase {out['phase_s']:.1f} s")
    return out


# the bf16 Trainer's run: 2 files of the paper dataset, 10 job sets each,
# replay of 20 from the second file (so 1 replay), exploration off
BF16_TRAIN = ["--epochs", "1", "--files_limit", "2", "--batch", "20", "--memory_size", "40",
              "--explore", "0", "--arrival_scale", "0.15", "--T", "1000",
              "--num_instances", "10", "--cheb_k", "2"]
BF16_PARAM_DRIFT = 0.05  # ||p_card - p_cpu|| over ||p_cpu - p0||


def injected_indices(mem, batch, gen=None):
    """The replay's sampled slots, the same on the card and the CPU: the
    first `batch` of a permutation of the filled slots from
    `default_rng(count)`."""
    count = int(mem.count)
    idx = np.random.default_rng(count).permutation(count)[:batch]
    return torch.from_numpy(idx).to(mem.loss_critic.device)


def compare_train_rows(tag: str, got: list, want: list, rtol: float = BF16_CARD_VS_CPU) -> dict:
    """Trainer CSV rows of the same visits: per method the share of rows
    with identical `congest_jobs` and `tau` within `rtol`; every
    `baseline` and `local` row and >= 99% of the `GNN` and `GNN-test`
    rows so."""
    if len(got) != len(want) or not got or any(
            (g["fid"], g["method"], g["n_instance"]) != (w["fid"], w["method"], w["n_instance"])
            for g, w in zip(got, want)):
        raise AssertionError(f"{tag}: rows out of step ({len(got)}, {len(want)})")
    share = {}
    for method in ("baseline", "local", "GNN", "GNN-test"):
        pairs = [(g, w) for g, w in zip(got, want) if g["method"] == method]
        same = sum(g["congest_jobs"] == w["congest_jobs"]
                   and abs(float(g["tau"]) - float(w["tau"]))
                   <= rtol * abs(float(w["tau"])) for g, w in pairs)
        share[method] = same / len(pairs)
    log(f"{tag}: rows with equal congest_jobs and tau within {rtol}: {share}")
    if share["baseline"] < 1.0 or share["local"] < 1.0 or min(
            share["GNN"], share["GNN-test"]) < 0.99:
        raise AssertionError(f"{tag}: {share}")
    return share


def bf16_training_phase(dev, card) -> dict:
    """Slice 15: the Trainer under `precision="bf16"` through
    `cli/train.py:main` on the committed paper dataset (2 files of 10 job
    sets, fresh K=2 init, replay of 20 from the second file, exploration
    off), dense and sparse, the replay's indices injected
    (`injected_indices`).  On the card every file's training step and its
    `eval_methods` are counted with every count at 0 just before and read
    just after, and held to the counts the same calls make on the CPU
    (`count_plain`): sparse K4's bf16 forward and transposed walk, K6 and
    K2 in bf16, K1 on fp32; dense K2 in bf16 and K1.  The card's rows,
    replay losses and final params are held to the same run on the CPU
    (the rows' bars of the CPU parity test, replay losses within 1e-2,
    ||p_card - p_cpu|| <= 0.05 ||p_cpu - p0||), its checkpoints to fp32.
    Then bf16 beside fp32 on the card in the same call: host ms a visit in
    the spans, the replay file's ms and the busy share over one replay
    file."""
    import shutil
    import tempfile

    from multihop_offload_tpu_torch.agent import replay as replay_mod
    from multihop_offload_tpu_torch.cli import train as cli_train
    from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET
    from multihop_offload_tpu_torch.obs.spans import reset_phases
    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib
    from multihop_offload_tpu_torch.train import driver as drv

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mho_bf16_train_")
    orig = {k: getattr(drv.Trainer, k) for k in ("run", "_train_step", "_eval_methods")}
    orig_sample = replay_mod.sample_indices
    out: dict = {"config": " ".join(BF16_TRAIN), "layouts": {}}
    counts_by_path = {}
    try:
        replay_mod.sample_indices = injected_indices
        for layout in ("dense", "sparse"):
            runs = {}
            for name, device, precision in (("card", dev.type, "bf16"), ("cpu", "cpu", "bf16"),
                                            ("fp32", dev.type, "fp32")):
                seen = {"steps": [], "tests": []}

                def run(self, *a, _seen=seen, **k):
                    _seen.setdefault("trainer", self)
                    _seen.setdefault("p0", {n_: p.clone() for n_, p in self.params().items()})
                    return orig["run"](self, *a, **k)

                def counted(key, into):
                    def call(self, *a, **k):
                        if self.device.type == "cpu":
                            res, c = count_plain(lambda: orig[key](self, *a, **k))
                        else:
                            reset_counts()
                            res = orig[key](self, *a, **k)
                            c = read_counts()
                        into.append(c)
                        return res
                    return call

                drv.Trainer.run = run
                drv.Trainer._train_step = counted("_train_step", seen["steps"])
                drv.Trainer._eval_methods = counted("_eval_methods", seen["tests"])
                root = os.path.join(tmp, f"{layout}_{name}")
                args = ["--datapath", PAPER_DATASET, "--out", os.path.join(root, "out"),
                        "--model_root", os.path.join(root, "model"), "--layout", layout,
                        "--precision", precision, "--device", device, *BF16_TRAIN]
                reset_phases()
                t0 = time.perf_counter()
                try:
                    csv_path = cli_train.main(args)
                finally:
                    for k, v in orig.items():
                        setattr(drv.Trainer, k, v)
                seen["wall_s"] = time.perf_counter() - t0
                seen["spans"] = span_ms(("train/build", "train/step", "train/metrics"), 2)
                seen["spans"].update(span_ms(("train/replay",), 1))
                seen["rows"] = read_csv_rows(csv_path)
                runs[name] = seen
            on_card, cpu = runs["card"], runs["cpu"]
            tag = f"bf16 Trainer ({layout}, K=2, 2 files)"
            tr = on_card["trainer"]
            if not tr.precision.mixed or cpu["trainer"].precision != tr.precision:
                raise AssertionError(f"{tag}: not under bf16 ({tr.precision})")
            # launches: every file's step and eval_methods as the CPU predicts
            for what in ("steps", "tests"):
                if len(on_card[what]) != 2 or len(cpu[what]) != 2:
                    raise AssertionError(f"{tag}: {what} counted {len(on_card[what])} times")
                for i, (c, w) in enumerate(zip(on_card[what], cpu[what])):
                    check_launches(f"{tag} file {i} {what}", c, w)
            step0 = on_card["steps"][0]
            need = (("chebconv_bf16", "chebconv_bf16_t", "coo_apsp_bf16", "minplus_bf16",
                     "fixed_point") if layout == "sparse" else ("minplus_bf16", "fixed_point"))
            if any(step0.get(k, 0) <= 0 for k in need) or step0.get("chebconv") or step0.get(
                    "minplus"):
                raise AssertionError(f"{tag}: the training step's launches {step0}")
            counts_by_path[f"bf16_train_step_{layout}"] = step0
            # card against the CPU: rows, replay losses, params, fp32 state
            share = compare_train_rows(f"{tag} card vs CPU", on_card["rows"], cpu["rows"])
            rl, rl_cpu = np.array(tr.replay_losses), np.array(cpu["trainer"].replay_losses)
            if rl.size != 1 or rl_cpu.size != 1 or not np.all(
                    np.abs(rl - rl_cpu) <= BF16_CARD_VS_CPU * np.abs(rl_cpu)):
                raise AssertionError(f"{tag}: replay losses {rl} against the CPU's {rl_cpu}")
            p_card = {k: v.cpu().double() for k, v in tr.params().items()}
            p_cpu = {k: v.double() for k, v in cpu["trainer"].params().items()}
            p0 = {k: v.cpu().double() for k, v in on_card["p0"].items()}
            moved = math.sqrt(sum(float(((p_cpu[k] - p0[k]) ** 2).sum()) for k in p0))
            drift = math.sqrt(sum(float(((p_card[k] - p_cpu[k]) ** 2).sum()) for k in p0))
            saved = ckpt_lib.restore_checkpoint_raw(tr._ckpt_dir())
            dtypes = {str(v.dtype) for part in (saved["params"], saved["opt_state"]["mu"],
                                                saved["opt_state"]["nu"])
                      for v in part.values()} | {str(v.dtype) for v in tr.params().values()}
            log(f"{tag} card vs CPU: replay loss {rl[0]:.6f} against {rl_cpu[0]:.6f}; params "
                f"moved {moved:.4e} on the CPU, card - CPU {drift:.4e} (bar "
                f"{BF16_PARAM_DRIFT} of the move); params and checkpoint dtypes {dtypes}")
            if not (moved > 0 and drift <= BF16_PARAM_DRIFT * moved) or dtypes != {
                    "torch.float32"}:
                raise AssertionError(f"{tag}: params drift {drift} of {moved}, dtypes {dtypes}")
            # bf16 beside fp32 on the card: one replay file each (memory full)
            timing = {}
            for name in ("card", "fp32"):
                trn = runs[name]["trainer"]
                one = lambda trn=trn, name=name: trn.run(  # noqa: E731
                    epochs=1, files_limit=1, verbose=False,
                    out_dir=os.path.join(tmp, f"{layout}_{name}_one"))
                ms = wall_ms(one, 3)
                timing[name] = {"wall_s_2_files": runs[name]["wall_s"],
                                "span_ms_per_visit": runs[name]["spans"],
                                "replay_file_ms": ms, "busy": busy_share(one, ms)}
            b16, b32 = timing["card"], timing["fp32"]
            log(f"{tag} timing on {card['smi']}: train/step "
                f"{b16['span_ms_per_visit'].get('train/step', float('nan')):.2f} ms a visit "
                f"(fp32 {b32['span_ms_per_visit'].get('train/step', float('nan')):.2f}), "
                f"train/replay {b16['span_ms_per_visit'].get('train/replay', float('nan')):.2f} "
                f"({b32['span_ms_per_visit'].get('train/replay', float('nan')):.2f}); a replay "
                f"file {b16['replay_file_ms']:.2f} ms ({b32['replay_file_ms']:.2f}); busy "
                f"{b16['busy']['busy_ms']:.3f} ms, share {b16['busy']['share']:.4f} (fp32 "
                f"{b32['busy']['busy_ms']:.3f}, {b32['busy']['share']:.4f})")
            out["layouts"][layout] = {
                "launches_per_file": {"train_step": step0,
                                      "eval_methods": on_card["tests"][0]},
                "card_vs_cpu": {"rows": share, "replay_loss": [float(rl[0]), float(rl_cpu[0])],
                                "param_drift_over_move": drift / moved},
                "bf16": b16, "fp32": b32}
    finally:
        replay_mod.sample_indices = orig_sample
        for k, v in orig.items():
            setattr(drv.Trainer, k, v)
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out["counts"] = counts_by_path
    log(f"bf16 training phase {out['phase_s']:.1f} s")
    return out


# ---- slice 18: the dataset generator and mho-serve's process wiring ---------

POS_TOL = 1e-12  # spring layout: the regenerated `pos` against the committed
DATAGEN_FAMILIES = ("ba", "grp", "ws", "er", "poisson", "grid", "corridor", "two_tier")


def datagen_phase(dev, card) -> dict:
    """Slice 18, the dataset generator without networkx: `cli.datagen.
    generate_dataset` writes the ``paper`` group (``ba``, size 2, seed 500,
    n = 20..110) and the ``rung256`` group (size 4, n = 250) into a
    temporary directory on this host; every case's adjacency, link rates
    and `nodes_info` equal `data/cases.npz` bit for bit, and the paper
    files' `pos` is within `POS_TOL` of the committed `.mat` dataset;
    `large_scale.build_case()` equals the committed ``large`` group field
    for field.  Then the Evaluator (model of record, dense) runs on the
    card over the first 2 regenerated files (K1, K2) and its CSV rows
    equal those of the same Evaluator over the committed files.  Host
    seconds per case for each group and for one n = 110 case of every
    `generate` family."""
    import importlib.util
    import shutil
    import tempfile

    import scipy.io as sio

    from multihop_offload_tpu_torch.cli.datagen import generate_dataset
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import CASES_PATH, load_large_case
    from multihop_offload_tpu_torch.graphs.matio import (
        PAPER_DATASET,
        list_dataset,
        load_case_mat,
    )
    from multihop_offload_tpu_torch.large_scale import build_case
    from multihop_offload_tpu_torch.models.chebconv import load_weights, params_from_jax
    from multihop_offload_tpu_torch.train import driver as drv

    t_phase = time.perf_counter()
    nx_loaded = "networkx" in sys.modules
    out = {"networkx_importable": importlib.util.find_spec("networkx") is not None}
    tmp = tempfile.mkdtemp(prefix="mho_datagen_")
    try:
        z = np.load(CASES_PATH)
        for group, kw in (("paper", {}), ("rung256", {"size": 4, "graph_sizes": [250]})):
            d = os.path.join(tmp, group)
            t0 = time.perf_counter()
            generate_dataset(d, "ba", **{"size": 2, "seed0": 500, "verbose": False, **kw})
            host_s = time.perf_counter() - t0
            names = list_dataset(d)
            if names != [str(x) for x in z[f"{group}/names"]]:
                raise AssertionError(f"datagen {group}: files {names}")
            pos_err = 0.0
            for i, name in enumerate(names):
                rec = load_case_mat(os.path.join(d, name))
                info = np.stack([rec.roles.astype(np.int64), rec.proc_bws.astype(np.int64)], 1)
                if not (np.array_equal(rec.topo.adj, z[f"{group}/{i}/adj"])
                        and np.array_equal(rec.link_rates, z[f"{group}/{i}/link_rates"])
                        and np.array_equal(info, z[f"{group}/{i}/nodes_info"])):
                    raise AssertionError(f"datagen {group}: {name} differs from cases.npz")
                if group == "paper":
                    got = sio.loadmat(os.path.join(d, name))["pos_c"]
                    want = sio.loadmat(os.path.join(PAPER_DATASET, name))["pos_c"]
                    pos_err = max(pos_err, float(np.abs(got - want).max()))
            if pos_err > POS_TOL:
                raise AssertionError(f"datagen {group}: pos off by {pos_err}")
            out[group] = {"cases": len(names), "host_s": host_s,
                          "host_s_per_case": host_s / len(names), "pos_max_abs_err": pos_err}
        t0 = time.perf_counter()
        case = build_case()
        large_s = time.perf_counter() - t0
        ref = load_large_case()
        for k in ("roles", "proc_bws", "link_rates"):
            if not np.array_equal(getattr(case.rec, k), getattr(ref.rec, k)):
                raise AssertionError(f"build_case: {k} differs from the committed large case")
        if not (np.array_equal(case.rec.topo.link_ends, ref.rec.topo.link_ends)
                and np.array_equal(case.job_src, ref.job_src)
                and np.array_equal(case.job_rate, ref.job_rate)):
            raise AssertionError("build_case: links or jobs differ from the committed case")
        out["large"] = {"n": case.rec.topo.n, "links": case.rec.topo.num_links,
                        "jobs": int(case.job_src.size), "host_s": large_s}
        fam = {}
        for g in DATAGEN_FAMILIES:
            t0 = time.perf_counter()
            generate_dataset(os.path.join(tmp, f"fam_{g}"), g, size=1, seed0=500,
                             graph_sizes=[110], verbose=False)
            fam[g] = time.perf_counter() - t0
        out["family_host_s_per_case_n110"] = fam
        if "networkx" in sys.modules and not nx_loaded:
            raise AssertionError("datagen: the port's generator imported networkx")

        # the Evaluator on the card over the first 2 regenerated files
        rows = {}
        for tag, datapath in (("regenerated", os.path.join(tmp, "paper")),
                              ("committed", PAPER_DATASET)):
            ecfg = Config(datapath=datapath, out=os.path.join(tmp, f"eval_{tag}"),
                          model_root=os.path.join(tmp, "model"), arrival_scale=0.15,
                          T=1000, num_instances=10)
            ev = drv.Evaluator(ecfg, device=dev)
            ev.model.load_state_dict(params_from_jax(load_weights(MODEL_K1)))
            if tag == "regenerated":
                reset_counts()
            rows[tag] = read_csv_rows(ev.run(files_limit=2, verbose=False))
            if tag == "regenerated":
                counts = read_counts()
        if counts["fixed_point"] == 0 or counts["minplus"] == 0:
            raise AssertionError(f"datagen Evaluator: a kernel did not launch: {counts}")
        out["eval_rows"] = compare_eval_rows("Evaluator regenerated vs committed (2 files)",
                                             rows["regenerated"], rows["committed"])
        out["counts"] = {"datagen_evaluator": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"datagen on this host ({card['smi']}): networkx importable "
        f"{out['networkx_importable']}; paper {out['paper']['cases']} cases "
        f"{out['paper']['host_s_per_case']:.4f} s a case, rung256 "
        f"{out['rung256']['host_s_per_case']:.4f} s a case, both bit for bit with "
        f"cases.npz, pos max abs err {out['paper']['pos_max_abs_err']:.3e} (bar {POS_TOL}); "
        f"large case {out['large']['host_s']:.3f} s, equal to the committed one; one n = 110 "
        f"case a family (s): { {k: round(v, 4) for k, v in fam.items()} }; Evaluator "
        f"launches {counts}; phase {out['phase_s']:.1f} s")
    return out


def _stage_truncated(directory: str, step: int, state: dict) -> None:
    """Put step `step` into `directory` with its integrity sidecar and its
    state file cut to half, renamed into place only once cut (a reader
    never sees the whole file)."""
    import shutil

    from multihop_offload_tpu_torch.train import checkpoints as ckpt

    stage = directory + ".stage"
    ckpt.save_checkpoint(stage, step, state)
    path = os.path.join(stage, str(step), ckpt.STATE_FILE)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    os.makedirs(os.path.join(directory, "integrity"), exist_ok=True)
    shutil.copy(os.path.join(stage, "integrity", f"{step}.json"),
                os.path.join(directory, "integrity", f"{step}.json"))
    os.replace(os.path.join(stage, str(step)), os.path.join(directory, str(step)))


def serve_cli_phase(dev, card) -> dict:
    """Slice 18, `mho-serve` as an operator runs it: `cli.serve.main` on
    the card (in this process, so the kernel counts can be read), the BA
    pool n = 20, 50, 80, 110 at 16 slots, deadline 60 s, 20,000 requests,
    with `--obs_log` and `--obs_prom` in a temporary directory and step 1
    (the model of record) in the model directory's ``torch/``.  An
    operator thread watches the run log: after 3 ticks it saves step 2
    (the parameters x 1.25), after its `hot_reload` it renames a truncated
    step 3 into place, 2 ticks after its quarantine it sends SIGTERM.
    Bars: `hot_reload` events for steps 1 and 2, step 3 quarantined and
    step 2 serving to the end, K1 and K2 launched, every admitted request
    answered exactly once, a `shutdown` event with `unserved` > 0, the run
    log sealed terminally, the Prometheus file written; the answers served
    under step 2 (up to 64) against a CPU service built on the same
    directory (step 2): `compare_responses`, rtol 1e-4.  Then `prob=True`
    on the card: 16 requests of one bucket served in one tick and each
    alone give identical answers."""
    import contextlib
    import io
    import shutil
    import signal
    import tempfile
    import threading

    from multihop_offload_tpu_torch.cli import serve as cli_serve
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.obs.events import read_events, segment_paths
    from multihop_offload_tpu_torch.serve.service import OffloadService
    from multihop_offload_tpu_torch.serve.workload import case_pool, request_stream
    from multihop_offload_tpu_torch.train import checkpoints as ckpt

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mho_serve_cli_")
    out = {}
    try:
        root = os.path.join(tmp, "model")
        directory = os.path.join(Config(model_root=root).model_dir(), "torch")
        params = {k: v.clone() for k, v in load_model(MODEL_K1, device="cpu")
                  .state_dict().items()}
        ckpt.save_checkpoint(directory, 1, {"params": params, "step": 1},
                             lineage=ckpt.make_lineage("offline"))
        log_path, prom = os.path.join(tmp, "serve.jsonl"), os.path.join(tmp, "serve.prom")
        n_req = 20000
        argv = [f"--device={dev.type}", "--serve_sizes=20,50,80,110", "--serve_slots=16",
                "--serve_deadline_s=60",
                f"--serve_requests={n_req}", f"--serve_model={MODEL_K1}",
                f"--obs_log={log_path}", f"--obs_prom={prom}", f"--model_root={root}"]
        served, requests = [], {}
        orig = {"tick": OffloadService.tick, "submit": OffloadService.submit}

        def tick(self, now=None):
            responses = orig["tick"](self, now)
            served.extend((r, self.executor.loaded_step) for r in responses)
            return responses

        def submit(self, req, now=None):
            requests[req.request_id] = req
            return orig["submit"](self, req, now)

        def events():
            return list(read_events(log_path))

        def wait(pred, what, timeout=120.0):
            t0 = time.monotonic()
            while time.monotonic() - t0 < timeout:
                ev = events()
                if pred(ev):
                    return ev
                time.sleep(0.02)
            raise AssertionError(f"serve CLI: timed out waiting for {what}")

        def ticks_after(ev, kind, step):
            names = [(e.get("event"), e.get("step")) for e in ev]
            return names[names.index((kind, step)):].count(("tick", None)) \
                if (kind, step) in names else -1

        failed = []

        def operator():
            try:
                wait(lambda ev: sum(e.get("event") == "tick" for e in ev) >= 3, "3 ticks")
                ckpt.save_checkpoint(directory, 2, {"params": {k: v * 1.25 for k, v in
                                                               params.items()}, "step": 2},
                                     lineage=ckpt.make_lineage("offline"))
                wait(lambda ev: ticks_after(ev, "hot_reload", 2) >= 0, "step 2's reload")
                _stage_truncated(directory, 3, {"params": params, "step": 3})
                wait(lambda ev: ticks_after(ev, "ckpt_quarantine", 3) >= 2,
                     "2 ticks after step 3's quarantine")
            except BaseException as e:  # reported by the main thread below
                failed.append(e)
            os.kill(os.getpid(), signal.SIGTERM)

        OffloadService.tick, OffloadService.submit = tick, submit
        thread = threading.Thread(target=operator, daemon=True)
        # a SIGTERM that comes after `main` has restored the handler it
        # replaced lands here, not in the default action
        late = []
        previous = signal.signal(signal.SIGTERM, lambda signum, frame: late.append(signum))
        reset_counts()
        t0 = time.perf_counter()
        try:
            thread.start()
            with contextlib.redirect_stdout(io.StringIO()):
                summary = cli_serve.main(argv)
        finally:
            OffloadService.tick, OffloadService.submit = orig["tick"], orig["submit"]
            thread.join(timeout=60)
            signal.signal(signal.SIGTERM, previous)
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        if failed or late:
            raise AssertionError(f"serve CLI operator: {failed!r}; SIGTERM after the "
                                 f"serve loop ended: {bool(late)}")
        ev = list(read_events(log_path))
        kinds = {e["event"] for e in ev}
        shutdown = [e for e in ev if e["event"] == "shutdown"]
        reloads = [e["step"] for e in ev if e["event"] == "hot_reload"]
        quarantined = [e["step"] for e in ev if e["event"] == "ckpt_quarantine"]
        ids = [r.request_id for r, _ in served]
        first2 = next((i for i, (_, s) in enumerate(served) if s == 2), len(served))
        steps_after = {s for _, s in served[first2:]}
        log(f"serve CLI ({card['smi']}): {summary['admitted']} admitted of {n_req}, "
            f"{summary['served']} served in {summary['ticks']} ticks, {wall_s:.2f} s; "
            f"hot_reload steps {reloads}, quarantined {quarantined}, shutdown {shutdown}; "
            f"event types {sorted(kinds)}; launches {counts}")
        if counts["fixed_point"] == 0 or counts["minplus"] == 0:
            raise AssertionError(f"serve CLI: a kernel did not launch: {counts}")
        if reloads != [1, 2] or quarantined != [3] or steps_after != {2}:
            raise AssertionError(f"serve CLI: reloads {reloads}, quarantined {quarantined}, "
                                 f"steps after the swap {steps_after}")
        if (len(ids) != len(set(ids)) or len(ids) != summary["admitted"]
                or summary["served"] != summary["admitted"]):
            raise AssertionError(f"serve CLI: {len(ids)} answers ({len(set(ids))} distinct) "
                                 f"for {summary['admitted']} admitted")
        if (len(shutdown) != 1 or shutdown[0]["signum"] != signal.SIGTERM
                or not shutdown[0]["unserved"] > 0):
            raise AssertionError(f"serve CLI: shutdown events {shutdown}")
        if (os.path.exists(log_path) or not segment_paths(log_path)
                or ev[-1]["event"] != "summary"):
            raise AssertionError("serve CLI: the run log is not sealed terminally")
        prom_text = open(prom).read()
        if "mho_serve_hot_reloads_total 2" not in prom_text:
            raise AssertionError("serve CLI: the Prometheus file lacks the reload count")
        if ckpt.all_steps(directory) != [1, 2] or not os.path.isdir(
                os.path.join(directory, "quarantine", "3")):
            raise AssertionError(f"serve CLI: steps {ckpt.all_steps(directory)}")
        # the answers under step 2 against a CPU service on the same directory
        under2 = [(r, requests[r.request_id]) for r, s in served if s == 2][:64]
        ccfg = Config(serve_sizes="20,50,80,110", serve_slots=16, serve_deadline_s=60.0,
                      serve_model=MODEL_K1, model_root=root)
        pool = case_pool([20, 50, 80, 110], per_size=2, seed=0)
        with contextlib.redirect_stdout(io.StringIO()):
            cpu_svc, _ = cli_serve.build_service(ccfg, pool=pool, device="cpu")
        if cpu_svc.executor.loaded_step != 2:
            raise AssertionError(f"CPU service loaded step {cpu_svc.executor.loaded_step}")
        cpu = check_conservation("serve CLI step 2 on the CPU", cpu_svc,
                                 closed_loop(cpu_svc, [q for _, q in under2]))
        out["step2_vs_cpu"] = compare_responses(
            "serve CLI step 2: card vs CPU", {r.request_id: r for r, _ in under2}, cpu, 1e-4)
        out.update(summary={k: summary[k] for k in ("submitted", "admitted", "served",
                                                    "ticks", "dispatches", "degraded")},
                   wall_s=wall_s, reloads=reloads, quarantined=quarantined,
                   unserved=shutdown[0]["unserved"], event_types=sorted(kinds),
                   served_under_step2=sum(s == 2 for _, s in served))

        # prob=True: one tick of 16 against each request alone
        pcfg = Config(prob=True, seed=7, serve_slots=16, serve_deadline_s=60.0,
                      serve_model=MODEL_K1, model_root=os.path.join(tmp, "none"))
        with contextlib.redirect_stdout(io.StringIO()):
            psvc, _ = cli_serve.build_service(pcfg, pool=pool, device=dev)
        reqs = [r for r in request_stream(pool, 400, seed=5, arrival_scale=0.15)
                if psvc.buckets.bucket_for(*r.sizes) == 1][:16]
        reset_counts()
        for r in reqs:
            psvc.submit(r)
        together = {r.request_id: r for r in psvc.tick()}
        prob_counts = read_counts()
        alone = {}
        for r in reqs:
            psvc.submit(r)
            alone.update({x.request_id: x for x in psvc.tick()})
        same = len(together) == len(alone) == 16 and all(
            all(np.array_equal(getattr(together[k], f), getattr(alone[k], f))
                for f in ("dst", "is_local", "delay_est", "job_total")) for k in together)
        log(f"serve prob=True on the card: 16 requests of bucket 1 in one tick and each "
            f"alone: identical {same}; launches of the tick {prob_counts}")
        if not same or prob_counts["fixed_point"] == 0 or prob_counts["minplus"] == 0:
            raise AssertionError("serve prob=True: answers depend on batching, or a "
                                 f"kernel did not launch ({prob_counts})")
        out["prob_identical_alone_vs_16"] = same
        out["counts"] = {"serve_cli": counts, "serve_prob_tick": prob_counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve CLI phase {out['phase_s']:.1f} s")
    return out


# ---- slice 19: the reference's TF checkpoints and the paper's figures --------

TF_MODEL_SET = "SCRATCH800"  # the fixture's `training_set` tag
ROUTE_CASE = "aco_case_seed500_m2_n110_s11.mat"


def tf_checkpoint_phase(dev, card) -> dict:
    """Slice 19, the reference's TF checkpoints without TensorFlow and the
    paper's tables and figures.  The committed fixture
    (`data/tf_ckpt/model_ChebConv_SCRATCH800_a5_c5_ACO_agent/`, the model of
    record as a TF-format checkpoint) read by `models.tf_import` equals
    `weights.npz` bit for bit, and the port's writer rewrites its `.index`
    and `.data` byte for byte.  The Evaluator with `model_root` at a copy
    of the fixture's directory (no `load_state_dict`: the driver loads it)
    over the first 2 paper files (10 job sets a file, pads N=112, L=216):
    K1 4 launches and K2 2 APSP calls on every file; its parameters equal,
    bit for bit, those of the same Evaluator whose weights are set by
    `load_state_dict` as `driver_phase` sets them, and its rows meet
    `compare_eval_rows` against that Evaluator's (the card's run to run
    noise; the identical rows counted); `summarize_test` of its CSV
    logged.  `cli.plot.route_sums` on one paper case (n = 110) on the
    card: its K1 and K2 launches equal those the same call makes on the
    CPU (`count_plain`), routes and `dst` identical to that CPU run, the
    link and node sums within rtol 1e-5; the figure (`route_demo`) drawn
    when matplotlib is installed, and which case happened logged."""
    import filecmp
    import importlib.util
    import shutil
    import tempfile

    from multihop_offload_tpu_torch.cli import plot as cli_plot
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET, load_case_mat
    from multihop_offload_tpu_torch.models.chebconv import load_weights, params_from_jax
    from multihop_offload_tpu_torch.models.tf_import import (
        load_reference_checkpoint, save_reference_checkpoint,
    )
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.train import analysis
    from multihop_offload_tpu_torch.train import driver as drv

    fixture_root = os.path.join(ROOT, "multihop_offload_tpu_torch", "data", "tf_ckpt")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mho_tf_")
    out = {}
    try:
        # ---- the fixture: read, and rewritten byte for byte ------------------
        model_root = os.path.join(tmp, "model")
        shutil.copytree(fixture_root, model_root)
        cfg = Config(datapath=PAPER_DATASET, out=os.path.join(tmp, "eval_tf"),
                     model_root=model_root, training_set=TF_MODEL_SET, arrival_scale=0.15,
                     T=1000, num_instances=10)
        fixture = cfg.model_dir()
        t0 = time.perf_counter()
        tree = load_reference_checkpoint(fixture)
        out["read_ms"] = (time.perf_counter() - t0) * 1e3
        want = load_weights(MODEL_K1)["params"]
        for layer, leaves in want.items():
            for leaf, value in leaves.items():
                got = tree["params"][layer][leaf]
                if got.dtype != value.dtype or got.tobytes() != value.tobytes():
                    raise AssertionError(f"fixture {layer}/{leaf} is not weights.npz's")
        t0 = time.perf_counter()
        prefix = save_reference_checkpoint(os.path.join(tmp, "rewrite", "cp-0000.ckpt"),
                                           {"params": want})
        out["write_ms"] = (time.perf_counter() - t0) * 1e3
        for suffix in (".index", ".data-00000-of-00001"):
            if not filecmp.cmp(prefix + suffix, os.path.join(fixture, "cp-0000.ckpt" + suffix),
                               shallow=False):
                raise AssertionError(f"the port's writer changed {suffix}")
        out["fixture_bytes"] = sum(os.path.getsize(os.path.join(fixture, f))
                                   for f in os.listdir(fixture))

        # ---- the Evaluator on the TF-format directory ------------------------
        ev = drv.Evaluator(cfg, device=dev)
        per_file = []
        inner = ev._eval_methods

        def counted(inst, jobs, gen):
            reset_counts()
            res = inner(inst, jobs, gen)
            per_file.append(read_counts())
            return res

        ev._eval_methods = counted
        t0 = time.perf_counter()
        csv_path = ev.run(files_limit=2, verbose=False)
        out["eval_2_files_ms"] = (time.perf_counter() - t0) * 1e3
        ev._eval_methods = inner
        k2_per_file = 2 * mp.squaring_count(ev.data.pad.n)
        log(f"tf_checkpoint Evaluator from {fixture} (pads {ev.data.pad}): launches per "
            f"file fixed_point {[c['fixed_point'] for c in per_file]}, minplus "
            f"{[c['minplus'] for c in per_file]} (2 APSP calls x "
            f"{mp.squaring_count(ev.data.pad.n)} squarings)")
        if len(per_file) != 2 or any(c["fixed_point"] != 4 or c["minplus"] != k2_per_file
                                     for c in per_file):
            raise AssertionError(f"TF-loaded Evaluator launches per file: {per_file}")
        out["eval_counts_file0"] = per_file[0]
        rows = read_csv_rows(csv_path)
        ref = drv.Evaluator(dataclasses.replace(cfg, out=os.path.join(tmp, "eval_ref"),
                                                model_root=os.path.join(tmp, "none")),
                            device=dev)
        ref.model.load_state_dict(params_from_jax(load_weights(MODEL_K1)))
        # the same model bit for bit; the rows then within the card's run to
        # run noise (its scatter-adds are not deterministic: `gap_2_bl` has
        # moved by a float32 ulp between two runs of one Evaluator)
        if not all(torch.equal(p, ref.params()[k]) for k, p in ev.params().items()):
            raise AssertionError("the TF-loaded parameters are not load_state_dict's")
        ref_rows = read_csv_rows(ref.run(files_limit=2, verbose=False))
        if len(rows) != 2 * 10 * 3:
            raise AssertionError(f"TF-loaded Evaluator: {len(rows)} rows")
        out["eval_vs_load_state_dict"] = compare_eval_rows(
            "TF-loaded Evaluator vs load_state_dict", rows, ref_rows)
        out["rows_identical"] = sum(
            {k: v for k, v in g.items() if k != "runtime"}
            == {k: v for k, v in w.items() if k != "runtime"} for g, w in zip(rows, ref_rows))
        table = analysis.summarize_test(analysis.read_csv(csv_path))
        log(f"tf_checkpoint Evaluator: parameters bit for bit; {out['rows_identical']} of "
            f"{len(rows)} rows identical (runtime aside) to the load_state_dict "
            f"Evaluator's; summarize_test:\n{analysis.format_table(table)}")
        out["summary"] = {k: v.tolist() for k, v in table.items()}

        # ---- the route demo --------------------------------------------------
        rec = load_case_mat(os.path.join(PAPER_DATASET, ROUTE_CASE))
        cpu, want_counts = count_plain(lambda: cli_plot.route_sums(rec, device="cpu"))
        reset_counts()
        card_sums = cli_plot.route_sums(rec, device=dev)
        counts = read_counts()
        out["route_counts"] = counts
        log(f"route_sums ({ROUTE_CASE}, n={rec.topo.n}, L={rec.topo.num_links}) on the "
            f"card: launches {counts}; on the CPU, plain versions counted: {want_counts}")
        for key in ("fixed_point", "minplus"):
            if counts[key] == 0 or counts[key] != want_counts.get(key, 0):
                raise AssertionError(f"route_sums {key}: {counts[key]} launches, "
                                     f"{want_counts.get(key, 0)} predicted")
        for key in ("dst", "incidence"):
            if not np.array_equal(card_sums[key], cpu[key]):
                raise AssertionError(f"route_sums: {key} differs from the CPU run")
        rel = {}
        for key in ("link_sums", "node_sums"):
            a, b = card_sums[key], cpu[key]
            rel[key] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
            if not np.allclose(a, b, rtol=1e-5, atol=0):
                raise AssertionError(f"route_sums: {key} beyond rtol 1e-5 ({rel[key]:.3e})")
        out["route_max_rel_err"] = rel
        out["route_sums_ms"] = wall_ms(lambda: cli_plot.route_sums(rec, device=dev), 5)
        t0 = time.perf_counter()
        cli_plot.route_sums(rec, device="cpu")
        out["route_sums_cpu_ms"] = (time.perf_counter() - t0) * 1e3
        if importlib.util.find_spec("matplotlib") is not None:
            fig = cli_plot.route_demo(os.path.join(PAPER_DATASET, ROUTE_CASE),
                                      os.path.join(tmp, "fig"), device=dev)
            out["figure"] = {"drawn": True, "bytes": os.path.getsize(fig)}
            log(f"route_demo: matplotlib found, figure drawn ({out['figure']['bytes']} "
                "bytes)")
        else:
            out["figure"] = {"drawn": False}
            log("route_demo: matplotlib not installed, the figure was not drawn")
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"tf_checkpoint timing on {card['smi']}: phase {out['phase_s']:.2f} s; "
            f"fixture read {out['read_ms']:.2f} ms, "
            f"rewrite {out['write_ms']:.2f} ms ({out['fixture_bytes']} bytes); Evaluator "
            f"2 files {out['eval_2_files_ms']:.1f} ms (host clock, first run); route_sums "
            f"{out['route_sums_ms']:.2f} ms on the card (median of 5), "
            f"{out['route_sums_cpu_ms']:.2f} ms on the CPU; sums max rel err {rel}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- slice 20: parallel/ on a mesh of devices, the drivers' data mesh ----------

MESH_WIDTH = 4       # the repeated card: [cuda:0] * 4 (8 for data 4 x graph 2)
RING_N = 1024        # the large path's N, ring over graph 4
RING_CPU_N = 256     # the whole ring on the CPU at this N (1,024 takes ~1 min there)
PARALLEL_RTOL = 1e-4  # fp32: per-shard batches against one batch


def _shard_counts(fn):
    """`fn()` with every count set to 0 just before and read just after."""
    reset_counts()
    res = fn()
    return res, read_counts()


def _scaled(counts: dict, k: int) -> dict:
    return {key: k * counts.get(key, 0) for key in LAUNCH_KEYS}


def compare_params(tag: str, got: dict, want: dict, rtol: float) -> float:
    """max |got - want| / max |want| over every leaf, held to `rtol`."""
    err = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
              for k in want)
    log(f"{tag}: parameters max scaled err {err:.3e} (bar {rtol})")
    if not err <= rtol:
        raise AssertionError(f"{tag}: parameters differ by {err:.3e}")
    return err


def compare_updates(tag: str, got: dict, want: dict, base: dict, rtol: float) -> float:
    """The update `got - base` against `want - base`: per leaf, the largest
    difference less one float32 rounding of the parameter (eps times its
    magnitude) over max |want - base|, held to `rtol`.  An update that was
    skipped is off by 1, one whose sign flipped by about 2."""
    err = 0.0
    for k in want:
        d_want = (want[k] - base[k]).double()
        if not d_want.abs().max() > 0:
            raise AssertionError(f"{tag}: the reference moved no element of {k}")
        ulp = torch.finfo(torch.float32).eps * torch.maximum(want[k].abs(),
                                                             base[k].abs()).double()
        diff = ((got[k] - base[k]).double() - d_want).abs()
        err = max(err, ((diff - ulp).clamp_min(0.0).max() / d_want.abs().max()).item())
    log(f"{tag}: updates max scaled err {err:.3e} past one float32 rounding (bar {rtol})")
    if not err <= rtol:
        raise AssertionError(f"{tag}: updates differ by {err:.3e}")
    return err


def compare_totals(tag: str, got, want, mask, share: float = 0.95) -> float:
    """Per-episode job totals: the share of episodes whose every job is
    within `PARALLEL_RTOL` (a flipped near-tie decision changes a whole
    episode), held to `share`."""
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).masked_fill(~mask, 0.0)
    same = (rel <= PARALLEL_RTOL).all(dim=1).float().mean().item()
    log(f"{tag}: episodes with every job total within {PARALLEL_RTOL}: {same:.4f} "
        f"(bar {share}); max rel err {rel.max().item():.3e}")
    if same < share:
        raise AssertionError(f"{tag}: {same} of the episodes agree")
    return same


def ring_weights(dev):
    """The large case's one-hop weights (1, 1024, 1024) (`1 / rate` on its
    links, +inf off them) on `dev`."""
    from multihop_offload_tpu_torch.env.apsp import weight_matrix_from_link_delays
    from multihop_offload_tpu_torch.graphs.cases import large_request, load_large_case

    inst, _, _ = large_request(load_large_case(), device=dev)
    with torch.no_grad():
        return weight_matrix_from_link_delays(inst.adj, inst.link_index,
                                              1.0 / inst.link_rates).contiguous()


def parallel_phase(dev, card, paper_batch) -> dict:
    """Slice 20, `parallel/` and the drivers' data mesh, on `[cuda:0] * 4`
    (the one card repeated: every shard's kernels queue on it, so the
    times below are the sharded path's overhead, not scaling).

    - `sharded_apsp` at (1, 1024) over graph 4 on the large case's one-hop
      weights: equal bit for bit to K2's closure of the same matrix on the
      card, its first squaring to the CPU ring's first squaring, and the
      whole ring at N = 256 to the CPU ring; its time beside K2's.
    - The `mean` and `replay` steps at data 4, graph 2 (`[cuda:0] * 8`) on
      the paper batch (64 episodes, the model of record, dense): against
      the 1 x 1 mesh on the card (parameters and buffers within
      `PARALLEL_RTOL` scaled, >= 95% of the episodes' totals within it);
      K1 launched 4 times one shard's count and K2 not at all (the ring
      squares), the 1 x 1 mesh one shard's K1 and K2.
    - The Trainer at `mesh_data = 4` on two paper files (sparse, K = 2,
      fresh init, 10 job sets padded to 12, exploration off, replay of 20
      at the second file with injected indices): rows (`compare_train_rows`
      at `PARALLEL_RTOL`) and final parameters against its `mesh_data = 1`
      run on the card; every file's K1, K2, K4 and K6 launches 4 times the
      one-device run's.
    - The Evaluator at `mesh_data = 2, file_batch = 2` on two paper files:
      rows (`compare_eval_rows`) against its `mesh_data = 1` run; launches
      those of the one-device run over the same files (one file a shard).
    Each mesh path's host ms per call and the card's busy ms per call
    (`busy_share`) are logged beside its one-device path."""
    import shutil
    import tempfile

    from multihop_offload_tpu_torch.agent import replay as replay_mod
    from multihop_offload_tpu_torch.agent.train_step import forward_backward
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.matio import PAPER_DATASET
    from multihop_offload_tpu_torch.models.chebconv import load_model, load_weights, params_from_jax
    from multihop_offload_tpu_torch.ops import minplus as mp
    from multihop_offload_tpu_torch.parallel import data_parallel as dp
    from multihop_offload_tpu_torch.parallel import make_mesh
    from multihop_offload_tpu_torch.parallel import ring
    from multihop_offload_tpu_torch.train import driver as drv

    t_phase = time.perf_counter()
    out, counts = {}, {}
    cards = lambda k: [dev] * k
    cpus = lambda k: [torch.device("cpu")] * k

    # ---- the ring at the large path's N -------------------------------------
    w = ring_weights(dev)
    n = w.shape[-1]
    iters = ring.squarings(n)
    got, counts["parallel_ring"] = _shard_counts(lambda: ring.sharded_apsp(w, cards(4)))
    d = torch.where(torch.eye(n, dtype=torch.bool, device=dev), 0.0, w).contiguous()
    k2 = mp.minplus_closure_cuda(d, iters)
    torch.cuda.synchronize()
    if not torch.equal(got, k2):
        raise AssertionError(f"ring (1, {n}) over graph 4: {int((got != k2).sum())} entries "
                             "differ from K2's closure on the card")
    check_launches(f"ring (1, {n}) over graph 4", counts["parallel_ring"], {})
    # the first squaring on the CPU at N = 1,024, the whole ring at N = 256
    rows = [x.contiguous() for x in ring.ring_apsp_rows(
        list(w.view(1, 4, n // 4, n).unbind(1)), n, num_iters=1)]
    t0 = time.perf_counter()
    rows_cpu = ring.ring_apsp_rows(list(w.cpu().view(1, 4, n // 4, n).unbind(1)), n,
                                   num_iters=1)
    cpu_sq_s = time.perf_counter() - t0
    if not all(torch.equal(a.cpu(), b) for a, b in zip(rows, rows_cpu)):
        raise AssertionError("ring: the card's first squaring differs from the CPU's")
    w256 = w[:, :RING_CPU_N, :RING_CPU_N].contiguous()
    small = ring.sharded_apsp(w256, cards(4))
    if not torch.equal(small.cpu(), ring.sharded_apsp(w256.cpu(), cpus(4))):
        raise AssertionError(f"ring (1, {RING_CPU_N}): the card differs from the CPU ring")
    # a call's time on the host clock (ending in a synchronize) and the
    # card's busy ms over one call (the union of its kernels' intervals)
    ring_call = lambda: ring.sharded_apsp(w, cards(4))
    k2_call = lambda: mp.minplus_closure_cuda(d, iters)
    ring_t = busy_share(ring_call, wall_ms(ring_call, 5))
    k2_t = busy_share(k2_call, wall_ms(k2_call, 20))
    out["ring"] = {"shape": [1, n], "graph": 4, "squarings": iters,
                   "wall_ms": ring_t["wall_ms"], "busy_ms": ring_t["busy_ms"],
                   "device_records": ring_t["device_records"],
                   "k2_wall_ms": k2_t["wall_ms"], "k2_busy_ms": k2_t["busy_ms"],
                   "cpu_first_squaring_s": cpu_sq_s, "block_elems": ring.BLOCK_ELEMS}
    log(f"ring sharded_apsp (1, {n}) over graph 4 on [cuda:0] * 4: bit-identical to K2's "
        f"closure on the card ({int(torch.isinf(got).sum())} entries +inf), its first "
        f"squaring to the CPU ring's (CPU {cpu_sq_s:.2f} s), the whole ring at N = "
        f"{RING_CPU_N} to the CPU ring; on {card['smi']}: ring call "
        f"{ring_t['wall_ms']:.3f} ms, card busy {ring_t['busy_ms']:.3f} ms "
        f"({ring_t['device_records']} device records, {iters} squarings x 16 block "
        f"products); K2 (1, {n}) call {k2_t['wall_ms']:.3f} ms, busy "
        f"{k2_t['busy_ms']:.3f} ms (the shards serialize on one card: overhead, not "
        f"scaling)")

    # ---- the mean and replay steps at data 4, graph 2 ------------------------
    inst, jobs = paper_batch
    b = inst.adj.shape[0]
    opt = replay_mod.make_optimizer(Config(learning_rate=1e-3))
    mesh42 = make_mesh(data=4, graph=2, devices=cards(8))
    mesh11 = make_mesh(data=1, graph=1, devices=cards(1))
    # one shard's launches: a call launches the same kernels whatever its batch
    _, one = _shard_counts(lambda: forward_backward(load_model(MODEL_K1, device=dev),
                                                    inst, jobs, device=dev))
    steps = {}
    for tag, mesh in (("4x2", mesh42), ("1x1", mesh11)):
        model = load_model(MODEL_K1, device=dev)
        step = dp.make_dp_train_step(model, opt, mesh, mode="mean")
        state = opt.init({k: p.detach() for k, p in model.named_parameters()})
        (params, _, metrics), c = _shard_counts(
            lambda: step(model, state, inst, jobs, None, 0.0))
        counts[f"parallel_mean_{tag}"] = c
        rmodel = load_model(MODEL_K1, device=dev)
        rstep = dp.make_dp_train_step(rmodel, opt, mesh, mode="replay")
        mem = replay_mod.replay_init({k: p.detach() for k, p in rmodel.named_parameters()}, 128)
        (mem, rmetrics), rc = _shard_counts(
            lambda: rstep(rmodel, mem, inst, jobs, None, 0.0))
        counts[f"parallel_replay_{tag}"] = rc
        mean_call = lambda: step(model, state, inst, jobs, None, 0.0)
        mem_t = replay_mod.replay_init({k: p.detach() for k, p in rmodel.named_parameters()},
                                       10 * b)
        replay_call = lambda: rstep(rmodel, mem_t, inst, jobs, None, 0.0)
        steps[tag] = {"params": params, "metrics": metrics, "mem": mem, "rmetrics": rmetrics,
                      "mean_wall_ms": wall_ms(mean_call, 3),
                      "replay_wall_ms": wall_ms(replay_call, 3)}
        steps[tag]["mean_busy"] = busy_share(mean_call, steps[tag]["mean_wall_ms"])
        steps[tag]["replay_busy"] = busy_share(replay_call, steps[tag]["replay_wall_ms"])
    want42 = {"fixed_point": 4 * one["fixed_point"]}
    want11 = {"fixed_point": one["fixed_point"], "minplus": one["minplus"]}
    for mode in ("mean", "replay"):
        check_launches(f"{mode} step data 4 x graph 2", counts[f"parallel_{mode}_4x2"], want42)
        check_launches(f"{mode} step 1 x 1", counts[f"parallel_{mode}_1x1"], want11)
    a, r = steps["4x2"], steps["1x1"]
    mask = jobs.mask.to(dev)
    out["mean"] = {
        "params_err": compare_params("mean step 4x2 vs 1x1", a["params"], r["params"],
                                     PARALLEL_RTOL),
        "loss_critic_rel_err": abs(float(a["metrics"]["loss_critic"])
                                   - float(r["metrics"]["loss_critic"]))
        / abs(float(r["metrics"]["loss_critic"])),
        "job_total_agree": compare_totals("mean step 4x2 vs 1x1", a["metrics"]["job_total"],
                                          r["metrics"]["job_total"], mask)}
    if not out["mean"]["loss_critic_rel_err"] <= PARALLEL_RTOL:
        raise AssertionError(f"mean step: loss_critic {out['mean']}")
    if not a["mem"].count == r["mem"].count == b:
        raise AssertionError(f"replay step: counts {a['mem'].count}, {r['mem'].count}")
    out["replay"] = {
        "grads_err": compare_params("replay step 4x2 vs 1x1 (buffer)",
                                    {k: g[:b] for k, g in a["mem"].grads.items()},
                                    {k: g[:b] for k, g in r["mem"].grads.items()},
                                    PARALLEL_RTOL),
        "job_total_agree": compare_totals("replay step 4x2 vs 1x1",
                                          a["rmetrics"]["job_total"],
                                          r["rmetrics"]["job_total"], mask)}
    for tag in ("4x2", "1x1"):
        s = steps[tag]
        out[f"step_{tag}"] = {k: s[k] for k in ("mean_wall_ms", "replay_wall_ms")}
        out[f"step_{tag}"].update(mean_busy_ms=s["mean_busy"]["busy_ms"],
                                  replay_busy_ms=s["replay_busy"]["busy_ms"])
    log(f"dp steps on {card['smi']} (B={b}, {MODEL_K1}, dense; data 4 x graph 2 on "
        f"[cuda:0] * 8 against 1 x 1; the shards serialize on one card, so this is the "
        f"sharded path's overhead, not scaling): mean step {a['mean_wall_ms']:.2f} ms "
        f"(card busy {a['mean_busy']['busy_ms']:.2f} ms) against "
        f"{r['mean_wall_ms']:.2f} ms (busy {r['mean_busy']['busy_ms']:.2f} ms); replay step "
        f"{a['replay_wall_ms']:.2f} ms (busy {a['replay_busy']['busy_ms']:.2f} ms) against "
        f"{r['replay_wall_ms']:.2f} ms (busy {r['replay_busy']['busy_ms']:.2f} ms)")

    # ---- the drivers on the data mesh ------------------------------------------
    tmp = tempfile.mkdtemp(prefix="mho_parallel_")
    orig_sample = replay_mod.sample_indices
    try:
        replay_mod.sample_indices = injected_indices
        tcfg = dict(datapath=PAPER_DATASET, layout="sparse", cheb_k=2, epochs=1,
                    files_limit=2, batch=20, memory_size=100, explore=0.0, best_window=0,
                    num_instances=10, arrival_scale=0.15, T=1000)
        runs = {}
        for n_dp in (MESH_WIDTH, 1):
            tr = drv.Trainer(Config(**tcfg, mesh_data=n_dp, out=os.path.join(tmp, f"t{n_dp}"),
                                    model_root=os.path.join(tmp, f"m{n_dp}")),
                             device=dev, devices=cards(MESH_WIDTH))
            per_file = []
            names = ("_train_step_dp", "_eval_methods_dp") if n_dp > 1 else (
                "_train_step", "_eval_methods")
            inner = {k: getattr(tr, k) for k in names}

            def counted(name):
                def call(*a, **k):
                    res, c = _shard_counts(lambda: inner[name](*a, **k))
                    if name == names[0]:
                        per_file.append(c)
                    else:
                        per_file[-1] = {key: per_file[-1][key] + c[key] for key in c}
                    return res
                return call

            for k in names:
                setattr(tr, k, counted(k))
            t0 = time.perf_counter()
            trows = read_csv_rows(tr.run(verbose=False))
            runs[n_dp] = {"rows": trows, "counts": per_file, "params": tr.params(),
                          "wall_ms_per_file": (time.perf_counter() - t0) * 1e3 / 2,
                          "replays": len(tr.replay_losses)}
        a, r = runs[MESH_WIDTH], runs[1]
        if len(a["rows"]) != 2 * 10 * 4 or not a["replays"] == r["replays"] == 1:
            raise AssertionError(f"Trainer mesh_data={MESH_WIDTH}: {len(a['rows'])} rows, "
                                 f"replays {a['replays']}, {r['replays']}")
        for f, (ca, cr) in enumerate(zip(a["counts"], r["counts"])):
            check_launches(f"Trainer mesh_data={MESH_WIDTH} file {f}", ca,
                           _scaled(cr, MESH_WIDTH))
        counts["parallel_trainer_file0"] = a["counts"][0]
        out["trainer"] = {
            "rows": compare_train_rows(f"Trainer mesh_data={MESH_WIDTH} vs 1 (card)",
                                       a["rows"], r["rows"], rtol=PARALLEL_RTOL),
            "params_err": compare_params(f"Trainer mesh_data={MESH_WIDTH} vs 1 after the replay",
                                         a["params"], r["params"], PARALLEL_RTOL),
            "ms_per_file": a["wall_ms_per_file"], "ms_per_file_one_device": r["wall_ms_per_file"],
            "launches_per_file": a["counts"][0]}

        ecfg = dict(datapath=PAPER_DATASET, num_instances=10, arrival_scale=0.15, T=1000)
        erows = {}
        for n_dp, fb in ((2, 2), (1, 1)):
            ev = drv.Evaluator(Config(**ecfg, mesh_data=n_dp, file_batch=fb,
                                      out=os.path.join(tmp, f"e{n_dp}"),
                                      model_root=os.path.join(tmp, "em")),
                               device=dev, devices=cards(MESH_WIDTH))
            ev.model.load_state_dict(params_from_jax(load_weights(MODEL_K1)))
            name = "_eval_files_dp" if n_dp > 1 else "_eval_methods"
            inner_e = getattr(ev, name)
            total = {}

            def counted_e(*a_, **k_):
                res, c = _shard_counts(lambda: inner_e(*a_, **k_))
                for key, v in c.items():
                    total[key] = total.get(key, 0) + v
                return res

            setattr(ev, name, counted_e)
            t0 = time.perf_counter()
            erows[n_dp] = (read_csv_rows(ev.run(files_limit=2, verbose=False)), total,
                           (time.perf_counter() - t0) * 1e3)
        check_launches("Evaluator mesh_data=2, file_batch=2 (2 files)", erows[2][1], erows[1][1])
        counts["parallel_evaluator"] = erows[2][1]
        out["evaluator"] = {
            "rows": compare_eval_rows("Evaluator mesh_data=2, file_batch=2 vs 1 (card)",
                                      erows[2][0], erows[1][0]),
            "ms_2_files": erows[2][2], "ms_2_files_one_device": erows[1][2],
            "launches": erows[2][1]}
        log(f"drivers on the data mesh on {card['smi']} (shards serialized on one card): "
            f"Trainer mesh_data={MESH_WIDTH} {a['wall_ms_per_file']:.1f} ms per file "
            f"against {r['wall_ms_per_file']:.1f} ms at mesh_data=1 (2 files, first calls "
            f"included); Evaluator mesh_data=2, file_batch=2 {erows[2][2]:.1f} ms for 2 files "
            f"against {erows[1][2]:.1f} ms")
    finally:
        replay_mod.sample_indices = orig_sample
        shutil.rmtree(tmp, ignore_errors=True)
    out["counts"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel phase {out['phase_s']:.1f} s")
    return out


SHARD_FLEET = 4      # the repeated card: [cuda:0] * 4
SHARD_RTOL = 1e-4    # fp32 floats of a 4-slot shard against the 16-slot batch


def compare_decisions(tag: str, got: dict, want: dict, rtol: float) -> dict:
    """The same requests from two services: `dst`, `is_local`, `served_by`
    and bucket identical for every request (every mismatch logged before
    the raise), `delay_est` and `job_total` within `rtol` relative."""
    bad, worst = [], 0.0
    if set(got) != set(want):
        raise AssertionError(f"{tag}: {len(got)} responses for {len(want)} requests")
    for rid, w in want.items():
        g = got[rid]
        if (g.served_by, g.bucket) != (w.served_by, w.bucket) or not (
                np.array_equal(g.dst, w.dst) and np.array_equal(g.is_local, w.is_local)):
            bad.append(rid)
            log(f"{tag}: request {rid} differs: {g.served_by}/{g.bucket} dst "
                f"{g.dst.tolist()} vs {w.served_by}/{w.bucket} {w.dst.tolist()}")
            continue
        for a, b in ((g.delay_est, w.delay_est), (g.job_total, w.job_total)):
            rel = np.abs(a.astype(np.float64) - b) / np.abs(b.astype(np.float64))
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
    log(f"{tag}: decisions of {len(want)} requests identical: {not bad}; delay_est/"
        f"job_total max rel err {worst:.3e} (bar {rtol})")
    if bad or not worst <= rtol:
        raise AssertionError(f"{tag}: requests {bad} differ, rel err {worst}")
    return {"requests": len(want), "max_rel_err": worst}


def plain_shard_counts(model_name: str, cfg, svc, reqs) -> dict:
    """Launches the sharded run asks for, from the plain versions: one
    shard's GNN pass at its block width, counted on the CPU
    (`count_plain`) per bucket, times the bucket's dispatches and shards."""
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.serve.bucketing import pack_bucket
    from multihop_offload_tpu_torch.serve.executor import BucketExecutor

    ex = BucketExecutor(load_model(model_name, device="cpu", layout=cfg.layout),
                        layout=cfg.layout, device="cpu")
    want: dict = {}
    for b, stats in svc.stats.buckets.items():
        if not stats.dispatches:
            continue
        shards = len(svc.executor.devices_for(b))
        per = svc.slots // shards
        mine = [r for r in reqs if svc.buckets.bucket_for(*r.sizes) == b][:per]
        binst, bjobs = pack_bucket(mine, svc.buckets[b], per, layout=cfg.layout,
                                   device="cpu")
        _, one = count_plain(lambda: ex.gnn_step(binst, bjobs))
        for k, v in one.items():
            want[k] = want.get(k, 0) + v * shards * stats.dispatches
    return want


def sharded_serving_phase(dev, card) -> dict:
    """Slice 21: sharded serving through `cli/serve.py:build_service(devices=
    [cuda:0] * 4)`, both buckets laid over all four fleet members: the
    serving pool's 256 requests dense (K1, K2 per shard) and the first 64
    sparse (K1, K4, K6 per shard), each against the one-device service on the card
    (decisions identical, floats within 1e-4) with the launches the plain
    versions predict and the one-device run's squarings; a device lost and
    restored mid-run (the planner's own plans, every admitted request
    answered once); `mho-mesh --smoke` on the card (two gloo workers, each
    on `[cuda:0] * 2`).  On one card the shards queue on the same card: the
    times are the sharded path's overhead, not scaling."""
    from multihop_offload_tpu_torch.cli import mesh as mesh_cli
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.serve.placement import PlacementPlan
    from multihop_offload_tpu_torch.serve.workload import case_pool, request_stream

    t0 = time.perf_counter()
    pool = case_pool([20, 50, 80, 110], per_size=2, seed=0)
    reqs = list(request_stream(pool, 256, seed=1, arrival_scale=0.15))
    fleet = [dev] * SHARD_FLEET
    base = dict(serve_slots=16, serve_queue_cap=64, serve_deadline_s=60.0,
                serve_model=MODEL_K1, serve_replan_ticks=10**9)
    out, counts, ref_by_id = {}, {}, {}
    for layout, model, n_req in (("dense", MODEL_K1, 256), ("sparse", MODEL_K2, 64)):
        cfg = Config(**{**base, "serve_model": model},
                     **({"layout": "sparse", "cheb_k": 2} if layout == "sparse" else {}))
        runs = {}
        for name in ("one", "sharded"):
            kw = {"device": dev} if name == "one" else {"devices": fleet}
            for rep in ("warm", "timed"):
                svc, _ = build_service(cfg, pool=pool, **kw)
                if name == "sharded":
                    every = tuple(range(SHARD_FLEET))
                    svc.executor.set_placement(PlacementPlan((every,) * len(svc.buckets)))
                stream = reqs[:n_req] if rep == "timed" else reqs[:32]
                torch.cuda.synchronize()
                reset_counts()
                t1 = time.monotonic()
                got = check_conservation(f"serve {layout} {name}", svc,
                                         closed_loop(svc, stream))
                torch.cuda.synchronize()
                wall = time.monotonic() - t1
            runs[name] = (svc, got, read_counts(), svc.stats.summary(wall_s=wall))
        (one, one_by_id, c_one, s_one), (sh, sh_by_id, c_sh, s_sh) = \
            runs["one"], runs["sharded"]
        tag = f"sharded serve {layout} ({model}, {n_req} requests, [cuda:0] * {SHARD_FLEET})"
        if sh.executor.last_devices_used != SHARD_FLEET or s_sh["degraded"]:
            raise AssertionError(f"{tag}: last dispatch spanned "
                                 f"{sh.executor.last_devices_used} devices, "
                                 f"{s_sh['degraded']} degraded")
        vs = compare_decisions(f"{tag} vs one device", sh_by_id, one_by_id, SHARD_RTOL)
        check_launches(tag, c_sh, plain_shard_counts(model, cfg, sh, reqs[:n_req]))
        if c_sh["squarings"] != c_one["squarings"]:
            raise AssertionError(f"{tag}: {c_sh['squarings']} squarings run, the one-"
                                 f"device service ran {c_one['squarings']}")
        ref_by_id[layout] = one_by_id
        counts[f"sharded_serve_{layout}"] = c_sh
        counts[f"one_device_serve_{layout}"] = c_one
        out[layout] = {
            "requests": n_req, "vs_one_device": vs,
            "squarings": c_sh["squarings"],
            "one_device": {k: s_one.get(k) for k in ("requests_per_sec", "ticks")}
            | {"p50_ms": s_one["latency"]["p50_ms"], "p99_ms": s_one["latency"]["p99_ms"]},
            "sharded": {k: s_sh.get(k) for k in ("requests_per_sec", "ticks")}
            | {"p50_ms": s_sh["latency"]["p50_ms"], "p99_ms": s_sh["latency"]["p99_ms"],
               "shards": s_sh["shards"],
               "placement_host_ms": {f"{b}:{d}": v * 1e3 for (b, d), v in
                                     sh.executor.placement_host_s.items()}}}
        o, s = out[layout]["one_device"], out[layout]["sharded"]
        log(f"{tag} on {card['smi']}: {s['requests_per_sec']} requests/s, p50 "
            f"{s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms against one device's "
            f"{o['requests_per_sec']} requests/s, p50 {o['p50_ms']:.2f}, p99 "
            f"{o['p99_ms']:.2f} ({s['ticks']} ticks each); the four shards queue on one "
            f"card, so this is the sharded path's overhead, not scaling")

    # ---- a device lost and restored mid-run, the planner's own plans ---------
    cfg = Config(**{**base, "serve_replan_ticks": 4})
    svc, _ = build_service(cfg, pool=pool, devices=fleet)
    plans, responses = [svc.planner.plan.describe()], []
    pending = list(reversed(reqs))
    reset_counts()
    while pending or svc.queue_depth:
        while pending:
            req = pending.pop()
            if not svc.submit(req):
                pending.append(req)
                break
        responses += svc.tick()
        if svc.stats.ticks == 3:
            svc.lose_device(2)
            plans.append(svc.planner.plan.describe())
            if svc.planner.plan.uses(2):
                raise AssertionError(f"device loss: plan {plans[-1]} still uses 2")
        if svc.stats.ticks == 6:
            svc.restore_device(2)
            plans.append(svc.planner.plan.describe())
    responses += svc.drain()
    loss_counts = read_counts()
    loss_by_id = check_conservation("sharded serve, device 2 lost and restored", svc,
                                    responses)
    compare_decisions("sharded serve, device 2 lost and restored, vs one device",
                      loss_by_id, ref_by_id["dense"], SHARD_RTOL)
    if loss_counts["squarings"] != counts["one_device_serve_dense"]["squarings"]:
        raise AssertionError(f"device loss: {loss_counts['squarings']} squarings run")
    counts["sharded_serve_device_loss"] = loss_counts
    out["device_loss"] = {"plans": plans, "answered": len(loss_by_id),
                          "admitted": svc.stats.admitted, "ticks": svc.stats.ticks,
                          "replans": svc.planner.replans}
    log(f"sharded serve, device 2 lost after tick 3 and restored after tick 6: plans "
        f"{plans}; {len(loss_by_id)} of {svc.stats.admitted} admitted requests answered "
        f"once, decisions equal to one device's; launches {loss_counts}")

    # ---- mho-mesh --smoke on the card -----------------------------------------
    path = os.path.join(ROOT, "build", "mesh_smoke_card.json")
    reset_counts()
    t1 = time.perf_counter()
    rc = mesh_cli.run_smoke(path)
    mesh_s = time.perf_counter() - t1
    counts["mesh_smoke_reference"] = read_counts()
    with open(path) as f:
        rec = json.load(f)
    if rc != 0 or not rec["pass"]:
        raise AssertionError(f"mho-mesh --smoke failed on the card: {rec['checks']}")
    out["mesh_smoke"] = {"wall_s": mesh_s, "elapsed_s": rec["elapsed_s"],
                         "sustained_rps": rec["open_loop"]["sustained_rps"],
                         "fleets": {h: r["fleet"] for h, r in rec["bring_up"].items()},
                         "checks": {k: v["ok"] for k, v in rec["checks"].items()}}
    log(f"mho-mesh --smoke on {card['smi']}: every check passed, two gloo workers on "
        f"{out['mesh_smoke']['fleets']}; sustained {rec['open_loop']['sustained_rps']:.1f} "
        f"req/s at p99 <= {mesh_cli.OPEN_LOOP_SLO_P99_S} s (virtual clock), wall "
        f"{mesh_s:.1f} s")
    out["counts"] = counts
    out["seconds"] = time.perf_counter() - t0
    log(f"sharded serving phase {out['seconds']:.1f} s")
    return out


MP_PROCESSES = 2     # local gloo processes of the cross-process step
MP_DIR = os.path.join(ROOT, "build", "multiprocess")


def multiprocess_worker() -> int:
    """One process of `multiprocess_phase` (`python3 chip_smoke.py
    --multiprocess-worker`): joins the group from `worker_env`'s
    environment, takes card `process_id % device_count`,
    lays its own half of the paper batch over its two slots of the 4-slot
    data axis, runs one mean step with its launches counted, then three
    timed steps; writes its results to `MP_DIR/out<process_id>.pt`."""
    from multihop_offload_tpu_torch._records import slice_records
    from multihop_offload_tpu_torch.agent.replay import make_optimizer
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.multihost.runtime import bootstrap, shutdown
    from multihop_offload_tpu_torch.parallel import global_batch, make_mesh
    from multihop_offload_tpu_torch.parallel.data_parallel import make_dp_train_step

    rt = bootstrap(timeout_s=120)
    pid = rt.process_id
    dev = torch.device(f"cuda:{pid % torch.cuda.device_count()}")
    torch.cuda.set_device(dev)
    inst, jobs, _ = request_batch(load_cases("paper")[:16], 4, seed=0,
                                  cfg=Config(arrival_scale=0.15), device="cpu")
    per = inst.adj.shape[0] // rt.num_processes
    inst = slice_records(inst, pid * per, (pid + 1) * per).to(dev)
    jobs = slice_records(jobs, pid * per, (pid + 1) * per).to(dev)
    mesh = make_mesh(data=2 * rt.num_processes, devices=[dev] * 2, runtime=rt)
    if not mesh.spans_processes or len(global_batch(mesh, jobs)) != 2:
        raise AssertionError(f"process {pid}: mesh {mesh} does not span the group")
    model = load_model(MODEL_K1, device=dev)
    opt = make_optimizer(Config())
    state = opt.init({k: p.detach() for k, p in model.named_parameters()})
    step = make_dp_train_step(model, opt, mesh, mode="mean")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    params, state, metrics = step(model, state, inst, jobs, None, 0.0)
    counts = read_counts()
    first_ms = (time.perf_counter() - t0) * 1e3
    out = {"params": {k: v.cpu() for k, v in params.items()},
           "metrics": {k: v.cpu() for k, v in metrics.items()},
           "counts": counts, "first_ms": first_ms, "device": str(dev),
           "mesh": repr(mesh), "local_rows": mesh.local_rows}
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(model, state, inst, jobs, None, 0.0)
        read_counts()  # waits for the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = step_ms
    torch.save(out, os.path.join(MP_DIR, f"out{pid}.pt"))
    log(f"process {pid} on {dev}: one mean step {first_ms:.1f} ms (first), then "
        f"{[round(t, 2) for t in step_ms]} ms; launches {counts}")
    shutdown()
    return 0


def multiprocess_phase(dev, card) -> dict:
    """Slice 22: one `mean` step over a data mesh that spans two processes
    (see the module docstring)."""
    import shutil

    from multihop_offload_tpu_torch.agent.replay import make_optimizer
    from multihop_offload_tpu_torch.agent.train_step import forward_backward
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.multihost.runtime import free_port, worker_env
    from multihop_offload_tpu_torch.parallel import make_mesh
    from multihop_offload_tpu_torch.parallel.data_parallel import make_dp_train_step
    from multihop_offload_tpu_torch._records import slice_records

    t0 = time.perf_counter()
    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR)
    coord = f"127.0.0.1:{free_port()}"
    argv = [sys.executable, os.path.abspath(__file__), "--multiprocess-worker"]
    procs = [subprocess.Popen(argv, env=worker_env(coord, MP_PROCESSES, i), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(MP_PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for i, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            log(f"[process {i}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"multiprocess worker {i} exited {p.returncode}")
    res = [torch.load(os.path.join(MP_DIR, f"out{i}.pt"), weights_only=False)
           for i in range(MP_PROCESSES)]
    spawn_s = time.perf_counter() - t0

    # the same update and metrics on both processes, bit for bit
    a, b = res
    for k in a["params"]:
        if not torch.equal(a["params"][k], b["params"][k]):
            raise AssertionError(f"multiprocess: parameter {k} differs between processes")
    for k in ("loss_critic", "loss_mse", "job_total"):
        if not torch.equal(a["metrics"][k], b["metrics"][k]):
            raise AssertionError(f"multiprocess: {k} differs between processes")

    # one process, four shards on this card, the whole batch
    inst, jobs, _ = request_batch(load_cases("paper")[:16], 4, seed=0,
                                  cfg=Config(arrival_scale=0.15), device="cpu")
    model = load_model(MODEL_K1, device=dev)
    opt = make_optimizer(Config())
    state = opt.init({k: p.detach() for k, p in model.named_parameters()})
    one = make_dp_train_step(model, opt, make_mesh(data=4, devices=[dev] * 4))
    params, _, metrics = one(model, state, inst.to(dev), jobs.to(dev), None, 0.0)
    err = compare_params("cross-process mean step vs one process's four shards",
                         a["params"], {k: v.cpu() for k, v in params.items()},
                         PARALLEL_RTOL)
    for k in ("loss_critic", "loss_mse"):
        rel = abs(float(a["metrics"][k]) - float(metrics[k])) / abs(float(metrics[k]))
        if not rel <= PARALLEL_RTOL:
            raise AssertionError(f"multiprocess: {k} rel err {rel} vs one process")

    # each process's launches: its two shards' forward_backward, counted on
    # the CPU from the plain versions (one shard's count, twice)
    shard = inst.adj.shape[0] // (2 * MP_PROCESSES)
    cpu_model = load_model(MODEL_K1, device="cpu")
    _, one_shard = count_plain(lambda: forward_backward(
        cpu_model, slice_records(inst, 0, shard), slice_records(jobs, 0, shard),
        device="cpu"))
    want = _scaled(one_shard, 2)
    for i, r in enumerate(res):
        check_launches(f"multiprocess: process {i} ({r['device']})", r["counts"], want)
    out = {"processes": MP_PROCESSES, "devices": [r["device"] for r in res],
           "episodes_per_process": inst.adj.shape[0] // MP_PROCESSES,
           "loss_critic": float(a["metrics"]["loss_critic"]),
           "params_vs_one_process": err,
           "first_step_ms": [r["first_ms"] for r in res],
           "step_ms": [r["step_ms"] for r in res],
           "launches_per_process": {k: want.get(k, 0) for k in ("fixed_point", "minplus")},
           "counts": {f"multiprocess_step_p{i}": r["counts"] for i, r in enumerate(res)},
           "seconds": time.perf_counter() - t0, "spawn_s": spawn_s}
    log(f"cross-process mean step on {card['smi']}: {MP_PROCESSES} processes on "
        f"{out['devices']}, losses and parameters equal bit for bit, within "
        f"{err:.3e} of one process's four shards; step "
        f"{[round(min(t), 2) for t in out['step_ms']]} ms (min of 3 per process); "
        f"phase {out['seconds']:.1f} s")
    return out


LOOP_SIZES = "20,50,80,110"  # the serving phase's pool
# the refit's update, card against CPU, past one float32 rounding of the
# parameter: 5.651e-08 and 2.660e-08 on an H100 (smoke lr 1e-6; 4 slots,
# lr 1e-4); a skipped update is off by 1
REFIT_UPDATE_RTOL = 1e-6


def loop_phase(dev, card) -> dict:
    """Slice 22: the continual-learning loop on the card (see the module
    docstring)."""
    import shutil

    from multihop_offload_tpu_torch import obs
    from multihop_offload_tpu_torch.chaos import faults
    from multihop_offload_tpu_torch.cli import loop as loop_cli
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.loop.canary import CheckpointCanary
    from multihop_offload_tpu_torch.loop.experience import read_outcomes, split_holdout
    from multihop_offload_tpu_torch.loop.promote import PromotionController
    from multihop_offload_tpu_torch.loop.refit import candidate_dir, refit
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.obs.registry import registry
    from multihop_offload_tpu_torch.serve.workload import request_stream
    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "loop_card")
    shutil.rmtree(root, ignore_errors=True)

    def config(name: str) -> Config:
        # the sim phase's ring capacity: the process's metric registry keeps
        # a histogram's first bucket boundaries (`mho_dev_sim_queue_depth`),
        # as JAX's does, so one process simulates at one cap
        base = Config(serve_model=MODEL_K1, seed=0)
        return dataclasses.replace(loop_cli.smoke_config(base, os.path.join(root, name)),
                                   serve_sizes=LOOP_SIZES, serve_buckets=2,
                                   sim_cap=SIM_FULL["sim_cap"])

    def run(cfg, plan=None, device=dev):
        faults.install(plan)
        runlog = obs.start_run(cfg, role="loop")
        try:
            return loop_cli.run_loop(cfg, inject_regression=True, device=device), None
        except faults.SimulatedCrash as c:
            return None, c.site
        finally:
            faults.clear()
            obs.finish_run(runlog)

    def terminal(o):
        lin = o["final_lineage"] or {}
        return (o["final_state"], o["final_loaded_step"], lin.get("source"),
                lin.get("parent_step"))

    # ---- the mho-loop smoke on the card ---------------------------------------
    cfg = config("smoke")
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    out, _ = run(cfg)
    smoke_counts = read_counts()
    smoke_s = time.perf_counter() - t1
    checks = loop_cli.smoke_checks(out)
    if not all(checks.values()):
        raise AssertionError(f"loop smoke on the card: {checks}")
    cyc = out["cycles"][0]
    log(f"mho-loop smoke on {card['smi']} ({MODEL_K1}, sizes {LOOP_SIZES}): "
        f"{out['log_segments']} log segments, promoted step {cyc['promoted_step']}, "
        f"rolled back to {cyc['rollback_step']}, states {out['states']}; refit steps "
        f"{[round(t, 2) for t in cyc['refit']['step_ms']]} ms; the cycle "
        f"{cyc['wall_s']:.2f} s wall, the run {smoke_s:.2f} s")

    # the same run on the CPU: the plain versions' launches, the same end
    (cpu_out, _), want_smoke = count_plain(lambda: run(config("smoke_cpu"), device="cpu"))
    check_launches("loop smoke (capture, refit, validation, canary, monitor)",
                   smoke_counts, want_smoke)
    for key in ("fixed_point", "minplus"):
        if smoke_counts[key] == 0:
            raise AssertionError(f"loop smoke: {key} never launched: {smoke_counts}")
    if terminal(cpu_out) != terminal(out):
        raise AssertionError(f"loop: the CPU run ends at {terminal(cpu_out)}, the "
                             f"card's at {terminal(out)}")

    # the candidate's update against the same outcomes refit on the CPU: at
    # the smoke's lr 1e-6 a parameter moves ~1e-6, under the parameters'
    # own bar, so the updates are held and the refit's losses
    outcomes = [o for o in read_outcomes(cfg.obs_log)
                if o.request.request_id < cfg.loop_capture_requests]
    train, _ = split_holdout(outcomes, cfg.loop_holdout_frac)
    champion = {k: v.detach().clone()
                for k, v in load_model(MODEL_K1, device="cpu").state_dict().items()}
    card_cand = ckpt_lib.restore_checkpoint_raw(candidate_dir(cfg.model_dir()),
                                                cyc["candidate_step"])["params"]

    def cpu_refit(rcfg):
        return refit(load_model(MODEL_K1, device="cpu"), {"params": champion}, train, rcfg,
                     seed=cfg.seed, device="cpu")

    cpu_cand, cpu_info = cpu_refit(cfg)
    refit_err = compare_updates("loop refit: the card candidate's update vs the CPU's",
                                {k: v.cpu() for k, v in card_cand.items()},
                                cpu_cand["params"], champion, REFIT_UPDATE_RTOL)
    for key in ("loss_critic_first", "loss_critic_last", "loss_mse_last"):
        rel = abs(cyc["refit"][key] - cpu_info[key]) / abs(cpu_info[key])
        if not rel <= PARALLEL_RTOL:
            raise AssertionError(f"loop refit: {key} rel err {rel} vs the CPU's")
    # the loop's default slots a step and learning rate (the smoke's 2 and
    # 1e-6), timed, its update held the same way
    dflt = Config()
    cfg4 = dataclasses.replace(cfg, loop_refit_slots=dflt.loop_refit_slots,
                               learning_rate=dflt.learning_rate)
    cand4, refit4 = refit(load_model(MODEL_K1, device=dev), {"params": champion}, train,
                          cfg4, seed=cfg.seed, device=dev)
    refit4_err = compare_updates(
        f"loop refit at {cfg4.loop_refit_slots} slots, lr {cfg4.learning_rate}: card vs CPU",
        {k: v.cpu() for k, v in cand4["params"].items()}, cpu_refit(cfg4)[0]["params"],
        champion, REFIT_UPDATE_RTOL)
    log(f"loop refit at {cfg4.loop_refit_slots} slots a step on {card['smi']}: steps "
        f"{[round(t, 2) for t in refit4['step_ms']]} ms")

    # the promoted weights' decisions: a card service and a CPU service
    svc_card, pool = build_service(cfg, device=dev, load_checkpoint=False)
    svc_cpu, _ = build_service(cfg, pool=pool, device="cpu", load_checkpoint=False)
    for svc in (svc_card, svc_cpu):
        if svc.executor.load_params(card_cand, step=cyc["promoted_step"]) is None:
            raise AssertionError("loop: the promoted weights were refused")
    pool_reqs = list(request_stream(pool, 32, seed=5, arrival_scale=cfg.arrival_scale))
    got = check_conservation("loop promoted, card", svc_card, closed_loop(svc_card, pool_reqs))
    want = check_conservation("loop promoted, CPU", svc_cpu, closed_loop(svc_cpu, pool_reqs))
    promoted_vs_cpu = compare_decisions("loop: promoted weights, card vs CPU service", got,
                                        want, SHARD_RTOL)

    # one sparse-layout refit: K1, K4 (both walks) and K6
    sp_cfg = dataclasses.replace(cfg, layout="sparse", cheb_k=2)
    sp_state = load_model(MODEL_K2, device="cpu", layout="sparse").state_dict()
    reset_counts()
    refit(load_model(MODEL_K2, device=dev, layout="sparse"), {"params": sp_state}, train,
          sp_cfg, seed=cfg.seed, device=dev)
    counts = {"loop_refit_sparse": read_counts()}
    _, want_sparse = count_plain(lambda: refit(
        load_model(MODEL_K2, device="cpu", layout="sparse"), {"params": sp_state}, train,
        sp_cfg, seed=cfg.seed, device="cpu"))
    check_launches(f"loop sparse refit ({len(train)} train outcomes)",
                   counts["loop_refit_sparse"], want_sparse)
    for key in ("chebconv", "coo_apsp", "fixed_point"):
        if counts["loop_refit_sparse"][key] == 0:
            raise AssertionError(f"sparse refit: {key} never launched")

    # ---- a kill at promote:post_save, then a restart -------------------------
    kcfg = config("kill")
    dead, site = run(kcfg, faults.FaultPlan(crash_at={"promote:post_save": 1}))
    if dead is not None or site != "promote:post_save":
        raise AssertionError(f"loop: the crash at promote:post_save never fired ({site})")
    resumed, site = run(kcfg)
    if site is not None or resumed["cycles"][0].get("resumed_from") != "promoting":
        raise AssertionError(f"loop: the restart did not resume from the journal: "
                             f"{resumed['cycles'][0]}")
    if terminal(resumed) != terminal(out):
        raise AssertionError(f"loop: resumed terminal {terminal(resumed)} != "
                             f"uninterrupted {terminal(out)}")
    log(f"loop: killed at promote:post_save, resumed from 'promoting' to "
        f"{terminal(resumed)}, the uninterrupted run's terminal state and lineage")

    # ---- a NaN-poisoned candidate: refused at promotion and at hot reload ------
    pcfg = config("poison")
    svc, ppool = build_service(pcfg, device=dev)
    loop_cli._bootstrap_champion(pcfg, svc)
    ctl = PromotionController(pcfg.model_dir())
    guard = CheckpointCanary(svc, ppool, count=8, seed=pcfg.seed + 1234)
    guard.record_champion()
    svc.executor.canary = guard
    rejections = registry().counter("mho_canary_rejections_total")
    before = {st: rejections.total(stage=st) for st in ("promote", "hot_reload")}
    nan = {k: torch.full_like(v, float("nan")) for k, v in champion.items()}
    if ctl.promote(svc, {"params": nan}, candidate_step=1, canary=guard) is not None:
        raise AssertionError("loop: the NaN candidate was promoted")
    faults.poison_checkpoint(ctl.directory, mode="nan", seed=0)
    reloads = [svc.hot_reload(pcfg.model_dir()) for _ in range(2)]
    refused = {st: rejections.total(stage=st) - before[st] for st in before}
    if reloads != [None, None] or refused != {"promote": 1, "hot_reload": 1} \
            or svc.executor.loaded_step != 1:
        raise AssertionError(f"loop canary: reloads {reloads}, refusals {refused}, "
                             f"serving step {svc.executor.loaded_step}")
    log(f"loop canary: the NaN candidate refused at promotion and the NaN-poisoned "
        f"checkpoint at hot reload (twice polled), {refused}; step 1 keeps serving")

    result = {"smoke": {"checks": checks, "states": out["states"],
                        "log_segments": out["log_segments"],
                        "promoted_step": cyc["promoted_step"],
                        "rollback_step": cyc["rollback_step"],
                        "refit_step_ms": cyc["refit"]["step_ms"],
                        "cycle_wall_s": cyc["wall_s"], "run_s": smoke_s,
                        "ab": cyc["ab"], "outcomes": cyc["outcomes"]},
              "refit_delta_vs_cpu": refit_err, "promoted_vs_cpu": promoted_vs_cpu,
              "refit_default": {"slots": cfg4.loop_refit_slots, "lr": cfg4.learning_rate,
                                "step_ms": refit4["step_ms"], "delta_vs_cpu": refit4_err},
              "resume": {"killed_at": "promote:post_save",
                         "terminal": list(terminal(resumed))},
              "canary_refusals": refused,
              "counts": {"loop_smoke": smoke_counts, **counts},
              "plain_counts": {"loop_smoke": want_smoke, "loop_refit_sparse": want_sparse},
              "seconds": time.perf_counter() - t0}
    log(f"loop phase {result['seconds']:.1f} s")
    return result



# ---- slice 23: closed-loop RL and K2's backward ------------------------------

# K2's backward at the RL path's shapes (4 lanes at the smoke's N = 16 and
# at n = 110's N = 112, the serving bucket's 16 x 112) and on hop weights
# (every edge 1: ties at nearly every k)
K2B_SHAPES = ((4, 16), (4, 112), (16, 112))
K2B_TOL = 1e-5      # of max |gradient|: float32 sums in another order
# one train step at full width: 4 BA networks of n = 110 (pads N 112, L
# 216), 100 jobs at utilization 0.7, 2 rounds x 100 slots; the sim phase's
# ring capacity (one histogram boundary set a process, `loop_phase`)
RL_FULL = dict(sim_nodes=110, sim_jobs=100, rl_util=0.7, rl_fleet=4, rl_rounds=2,
               rl_slots=100, sim_cap=SIM_FULL["sim_cap"])
RL_LOSS_RTOL = 1e-4    # a lane's loss, card against CPU, where its choices agree
RL_GRAD_RTOL = 1e-3    # a lane's gradient, card against CPU, of its norm, likewise
RL_DELTA_TOL = 0.05    # the update, card against CPU, of its norm
# the compared steps' temperature: on the cost table's scale (a job's
# local cost ~16 against ~1,600 a server), where the committed models
# sample offloads and every lane's gradient flows; at the default 0.5
# every job stays local at n = 110 and every gradient is exactly 0
RL_CMP_TEMP = 1000.0
RL_WITNESS_EVALS = 4   # fixed-draw evaluation batches a contender, as the smoke's
RL_DIR = os.path.join(ROOT, "build", "rl_card")


def hop_weights(b: int, n: int, seed: int):
    """(b, n, n) float32 on the CPU: weight 1 on a ring and on chords drawn
    with probability 2 / n from `default_rng(seed)`, +inf elsewhere."""
    rng = np.random.default_rng(seed)
    w = np.full((b, n, n), np.inf, dtype=np.float32)
    for k in range(b):
        iu, ju = np.where(np.triu(rng.uniform(size=(n, n)) < 2.0 / n, 2))
        for i, j in list(zip(iu, ju)) + [(i, (i + 1) % n) for i in range(n)]:
            w[k, i, j] = w[k, j, i] = 1.0
    return torch.from_numpy(w)


def k2_backward_phase(dev, card) -> dict:
    """K2's backward through the autograd wrapper the RL path calls
    (`minplus_closure_diff`, `_MinplusClosure`) against autograd through
    the plain squarings on the same card tensors: the distances bit for
    bit, the input's gradient within `K2B_TOL` of its largest entry,
    `bwd_launches(iters)` launches (the first squaring's tie pass, then one
    fused split-and-gather a squaring), the same bits on a second call; then the
    backward alone (`minplus_closure_bwd_cuda` on the saved squarings)
    within `K2B_TOL` of the kernel's passes in plain torch on the same
    stack (`minplus_closure_bwd_plain`): its device time a CUDA graph
    replay (`graph_us`: the launches overlap under programmatic dependent
    launch, which the profiler curbs), its span and kernels under the
    profiler, its call and host time, the plain backward's, and its bound
    by operations (6 N^3 a squaring and matrix: the tie pass's add and
    min, the gather's add and compare for each operand)."""
    from multihop_offload_tpu_torch.ops import minplus as mp

    cases = {f"{b}x{n}": minplus_input(b, n) for b, n in K2B_SHAPES}
    cases["4x112_hops"] = hop_weights(4, 112, 23)
    out = {}
    for tag, w in cases.items():
        b, n, _ = w.shape
        iters = mp.squaring_count(n)
        d = w.to(dev)
        d = torch.where(torch.eye(n, dtype=torch.bool, device=dev), 0.0, d).contiguous()
        c = torch.from_numpy(np.random.default_rng(n).uniform(0.5, 1.5, (b, n, n))
                             .astype(np.float32)).to(dev)

        def wrapped():
            xk = d.clone().requires_grad_()
            fwd = mp.minplus_closure_diff(xk, iters)
            ct = torch.where(torch.isfinite(fwd), c, 0.0)
            return fwd.detach(), ct, torch.autograd.grad(fwd, xk, grad_outputs=ct)[0]

        launches0 = mp.minplus_closure_bwd_cuda.launches
        fwd, ct, got = wrapped()
        launched = mp.minplus_closure_bwd_cuda.launches - launches0
        again = wrapped()[2]
        x = d.clone().requires_grad_()
        sp = mp.minplus_closure_diff_plain(x, iters)
        (want,) = torch.autograd.grad(sp, x, grad_outputs=ct, retain_graph=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not torch.equal(fwd, sp.detach()):
            raise AssertionError(f"K2 backward {tag}: the forward differs from plain")
        if launched != mp.bwd_launches(iters):
            raise AssertionError(f"K2 backward {tag}: {launched} launches through the "
                                 f"autograd wrapper, not {mp.bwd_launches(iters)}")
        if not err <= K2B_TOL * scale:
            raise AssertionError(f"K2 backward {tag}: max |err| {err:.3e} > {K2B_TOL} x "
                                 f"{scale:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"K2 backward {tag}: two calls differ")
        _, stack, step_elems, lead = mp._minplus_closure_saved(d, iters)
        bwd = lambda: mp.minplus_closure_bwd_cuda(stack, step_elems, lead, ct, iters)
        passes = mp.minplus_closure_bwd_plain(stack, step_elems, lead, ct, iters)
        err_passes = (bwd() - passes).abs().max().item()
        if not err_passes <= K2B_TOL * scale:
            raise AssertionError(f"K2 backward {tag}: max |err| {err_passes:.3e} against the "
                                 f"plain passes > {K2B_TOL} x {scale:.3e}")
        kernels = {"bwd_ties_kernel": 1, "bwd_gather_kernel": iters}
        t = {"ms": cuda_ms(bwd, 20),
             "kernel_sum_ms": device_us(bwd, 20, per_call=kernels) / 1e3,
             "tie_pass_ms": device_us.last["by_name"]["bwd_ties_kernel"] / 1e3,
             "records": device_us.last["records"],
             "host_us": host_us(bwd, 20), "kernels_per_call": mp.bwd_launches(iters)}
        span = device_span_us(bwd, 20, mp.bwd_launches(iters), tuple(kernels))
        t["span_ms"] = None if span is None else span / 1e3
        graph = graph_us(bwd, 20)
        t["device_ms"] = None if graph is None else graph / 1e3
        plain_ms = cuda_ms(lambda: torch.autograd.grad(sp, x, grad_outputs=ct,
                                                       retain_graph=True), 3)
        ops_ms = 6.0 * b * n ** 3 * iters / PEAK_FP32_INSTR_PER_S * 1e3
        bytes_ms = (iters + 4) * b * n * n * 4 / PEAK_BYTES_PER_S * 1e3
        out[tag] = {"shape": [b, n], "iters": iters, "leading_changes": lead.tolist(),
                    "max_abs_err": err, "max_abs_grad": scale,
                    "max_abs_err_vs_plain_passes": err_passes,
                    "device_ms": t["device_ms"], "span_ms": t["span_ms"],
                    "kernel_sum_ms": t["kernel_sum_ms"],
                    "tie_pass_ms": t["tie_pass_ms"], "ms": t["ms"], "host_us": t["host_us"],
                    "kernels_per_call": t["kernels_per_call"], "records": t["records"],
                    "plain_ms": plain_ms,
                    "bound_ms": max(ops_ms, bytes_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                    "library_ms": None}
        graph = "not measured" if t["device_ms"] is None else f"{t['device_ms'] * 1e3:.2f} us"
        span = "not measured" if t["span_ms"] is None else f"{t['span_ms'] * 1e3:.2f} us"
        device = (f"{graph} a CUDA graph replay, {span} from the first kernel's start to "
                  f"the last one's end under the profiler "
                  f"({t['kernels_per_call']} kernels; their durations sum to "
                  f"{t['kernel_sum_ms'] * 1e3:.2f} us, the tie pass "
                  f"{t['tie_pass_ms'] * 1e3:.2f}; records {t['records']} of 20 and "
                  f"{20 * iters})")
        log(f"K2 backward {tag} B,N={(b, n)} iters={iters} (leading changes "
            f"{lead.tolist()}), through the autograd wrapper ({launched} launches): "
            f"distances bit-identical to plain, gradient max |err| "
            f"{err:.3e} of max {scale:.3e} (bar {K2B_TOL} of it), two calls bit-identical; "
            f"against the plain passes {err_passes:.3e}; "
            f"on {card['smi']}: device {device}, call {t['ms'] * 1e3:.2f} us, host "
            f"{t['host_us']:.2f} us; plain backward {plain_ms:.4f} ms; bound "
            f"{out[tag]['bound_ms'] * 1e3:.2f} us ({out[tag]['bound_by']})")
    return out


def rl_step_setup(cfg) -> dict:
    """The full-width step's fleet (`cli.rl.build_fleet` on the CPU), its
    slot draws (seed 23) and Gumbel decision noise (seed 29), on the CPU."""
    from multihop_offload_tpu_torch.cli import rl as rl_cli
    from multihop_offload_tpu_torch.cli.sim import uniform_draws
    from multihop_offload_tpu_torch.rl.rollout import gumbel_noise

    insts, jobss, paramss, spec, _ = rl_cli.build_fleet(cfg, "cpu")
    shape = (cfg.rl_fleet, cfg.rl_rounds, spec.num_jobs, insts.servers.shape[1] + 1)
    return {"cfg": cfg, "fleet": (insts, jobss, paramss), "spec": spec,
            "draws": uniform_draws(spec, cfg.rl_fleet, cfg.rl_rounds, cfg.rl_slots, seed=23),
            "gumbel": gumbel_noise([torch.Generator().manual_seed(29)], shape, torch.float32,
                                   "cpu")}


def rl_step_run(setup: dict, model_name: str, where, plain: bool = False) -> dict:
    """One `RLTrainer` step of `setup` on `where` from the committed weights
    `model_name`: with `plain` (on the CPU) under `count_plain`, the
    launches the card's kernels make for the same step; else between
    `reset_counts` and `read_counts`, the step's wall ms beside them."""
    from multihop_offload_tpu_torch.models.chebconv import load_model
    from multihop_offload_tpu_torch.rl import RLTrainer
    from multihop_offload_tpu_torch.sim.runner import InjectedDraws

    cfg = setup["cfg"]
    tr = RLTrainer(cfg, load_model(model_name, device=where, layout=cfg.layout), setup["spec"])
    before = {k: v.clone() for k, v in tr.params.items()}
    args = tuple(x.to(where) for x in setup["fleet"])
    draws = InjectedDraws(*[x.to(where) for x in setup["draws"]])
    gumbel = setup["gumbel"].to(where)
    if plain:
        out, counts = count_plain(lambda: tr.train_step(*args, draws, gumbel=gumbel))
        run = {}
    else:
        reset_counts()
        t0 = time.perf_counter()
        out = tr.train_step(*args, draws, gumbel=gumbel)
        counts = read_counts()
        run = {"first_ms": (time.perf_counter() - t0) * 1e3}
    # the update of this step (later timing steps move the trainer on)
    update = {k: v - before[k] for k, v in tr.params.items()}
    return run | {"tr": tr, "out": out, "counts": counts, "update": update, "args": args}


def rl_compare(tag: str, model_name: str, setup: dict, card_run: dict, cpu_run: dict) -> dict:
    """The card's step against the CPU's: launches equal to the plain
    versions' count of the CPU step (K1, K2 and K2's backward; under the
    sparse layout K4 forward and transposed too); the CPU step must offload
    and every lane's gradient be nonzero; `dst` identical in >= 99% of
    (lane, round, job), on lanes whose choices all agree the packet
    counters equal, the loss within `RL_LOSS_RTOL` and the lane's gradient
    within `RL_GRAD_RTOL` of its norm; the update Adam makes of the mean
    gradient within `RL_DELTA_TOL` of its norm."""
    from multihop_offload_tpu_torch.cli.sim import fields_that_differ
    from multihop_offload_tpu_torch._records import slice_records

    cfg = setup["cfg"]
    jobss = setup["fleet"][1]
    got, cpu = card_run["out"], cpu_run["out"]
    counts = card_run["counts"]
    check_launches(f"rl {tag} train step", counts, cpu_run["counts"])
    for k in ("fixed_point", "minplus", "minplus_bwd"):
        if counts[k] == 0:
            raise AssertionError(f"rl {tag}: kernel {k} did not launch: {counts}")
    mask = jobss.mask.unsqueeze(1).expand(-1, cfg.rl_rounds, -1)

    def offload_share(dsts):
        return float(((dsts.cpu() != jobss.src.unsqueeze(1)) & mask).double().sum() / mask.sum())

    offload, cpu_offload = offload_share(got.dsts), offload_share(cpu.dsts)
    if not (cpu_offload > 0 and float(cpu.grad_norms.min()) > 0):
        raise AssertionError(f"rl {tag}: the CPU step holds no gradient to compare (offload "
                             f"share {cpu_offload}, lane gradient norms "
                             f"{cpu.grad_norms.tolist()})")
    same = (got.dsts.cpu() == cpu.dsts) | ~mask
    agree = float(same[mask].double().mean())
    lanes = same.flatten(1).all(dim=1)
    loss_rel, grad_rel, differ = [], [], {}
    for i in torch.nonzero(lanes).flatten().tolist():
        a, b = slice_records(got.state.to("cpu"), i, i + 1), slice_records(cpu.state, i, i + 1)
        differ[i] = fields_that_differ(a, b)
        for f in ("generated", "delivered", "dropped"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"rl {tag}: lane {i}'s {f} counter differs from the CPU")
        loss_rel.append(abs(float(got.losses[i]) - float(cpu.losses[i]))
                        / max(abs(float(cpu.losses[i])), 1e-30))
        num = sum(float((got.grads[k][i].cpu() - g[i]).pow(2).sum())
                  for k, g in cpu.grads.items())
        den = sum(float(g[i].pow(2).sum()) for g in cpu.grads.values())
        grad_rel.append(math.sqrt(num / den))
    if agree < 0.99 or not lanes.any() or not max(loss_rel) <= RL_LOSS_RTOL:
        raise AssertionError(f"rl {tag}: dst agreement {agree}, agreeing lanes "
                             f"{lanes.tolist()}, loss rel err {loss_rel}")
    if not max(grad_rel) <= RL_GRAD_RTOL:
        raise AssertionError(f"rl {tag}: a lane's gradient differs from the CPU's by "
                             f"{grad_rel} of its norm")
    upd, cpu_upd = card_run["update"], cpu_run["update"]
    num = sum(float((upd[k].cpu() - cpu_upd[k]).pow(2).sum()) for k in upd)
    den = sum(float(cpu_upd[k].pow(2).sum()) for k in upd)
    if not den > 0:
        raise AssertionError(f"rl {tag}: the CPU step made no update")
    delta_rel = math.sqrt(num / den)
    if not delta_rel <= RL_DELTA_TOL:
        raise AssertionError(f"rl {tag}: the update differs from the CPU's by {delta_rel:.3e} "
                             f"of its norm")
    res = {"counts": counts, "temperature": cfg.rl_temp, "dst_agreement": agree,
           "lanes_agreeing": int(lanes.sum()), "loss_rel_err": max(loss_rel),
           "grad_rel_err": grad_rel, "grad_norms_cpu": cpu.grad_norms.tolist(),
           "state_fields_differ": differ, "update_rel_err": delta_rel,
           "update_norm_cpu": math.sqrt(den), "offload_share": offload,
           "offload_share_cpu": cpu_offload, "skipped": got.skipped}
    log(f"rl {tag} train step ({model_name}, {cfg.layout}, fleet {cfg.rl_fleet}, n "
        f"{cfg.sim_nodes}, J {cfg.sim_jobs}, {cfg.rl_rounds} x {cfg.rl_slots} slots, "
        f"temperature {cfg.rl_temp}): launches {counts} = the CPU step's plain count; "
        f"offload share {offload:.4f} (CPU {cpu_offload:.4f}), lane gradient norms (CPU) "
        f"{[f'{x:.3e}' for x in cpu.grad_norms.tolist()]}; dst agreement {agree:.4f} (bar "
        f"0.99); {int(lanes.sum())} lanes agree: loss rel err {max(loss_rel):.3e} (bar "
        f"{RL_LOSS_RTOL}), gradient rel err {[f'{x:.3e}' for x in grad_rel]} (bar "
        f"{RL_GRAD_RTOL}), fields that differ {differ}; update {delta_rel:.3e} of its norm "
        f"{math.sqrt(den):.3e} (bar {RL_DELTA_TOL})")
    return res


def rl_witness_setup() -> dict:
    """The smoke's run (`cli.rl.SMOKE` at seed 0: its fleet and its fresh
    init, `make_rl_model`) on the CPU, with injected draws for each of its
    steps (slot draws seed 1000 + s, Gumbel noise 2000 + s) and for each
    evaluation batch (3000 + e, 4000 + e)."""
    from multihop_offload_tpu_torch.cli import rl as rl_cli
    from multihop_offload_tpu_torch.cli.sim import uniform_draws
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.rl.rollout import gumbel_noise

    cfg = dataclasses.replace(Config(seed=0), **rl_cli.SMOKE)
    insts, jobss, paramss, spec, _ = rl_cli.build_fleet(cfg, "cpu")
    shape = (cfg.rl_fleet, cfg.rl_rounds, spec.num_jobs, insts.servers.shape[1] + 1)

    def draws(a: int, b: int):
        return (uniform_draws(spec, cfg.rl_fleet, cfg.rl_rounds, cfg.rl_slots, seed=a),
                gumbel_noise([torch.Generator().manual_seed(b)], shape, torch.float32, "cpu"))

    return {"cfg": cfg, "fleet": (insts, jobss, paramss), "spec": spec,
            "model": rl_cli.make_rl_model(cfg, insts, jobss),
            "train": [draws(1000 + s, 2000 + s) for s in range(cfg.rl_steps)],
            "eval": [draws(3000 + e, 4000 + e) for e in range(RL_WITNESS_EVALS)]}


def rl_witness_run(w: dict, where) -> dict:
    """The smoke's steps of `w` on `where` under its injected draws, with
    no devmetrics: each step's loss, lane gradient norms, `dst`, and the
    probes (`make_rl_model`'s, one a lane) on which the output unit is
    alive after its update; then the sampling policy's delivered ratio
    of the init and of the trained parameters over the injected
    evaluation batches."""
    import copy

    from multihop_offload_tpu_torch._records import slice_records
    from multihop_offload_tpu_torch.agent.actor import build_ext_features, default_support
    from multihop_offload_tpu_torch.rl import RLTrainer, delivered_ratio, make_eval
    from multihop_offload_tpu_torch.sim.runner import InjectedDraws

    cfg, spec = w["cfg"], w["spec"]
    model = copy.deepcopy(w["model"]).to(where)
    probe = copy.deepcopy(model)
    insts, jobss, paramss = (x.to(where) for x in w["fleet"])
    probes = []
    for i in range(cfg.rl_fleet):
        inst, jobs = slice_records(insts, i, i + 1), slice_records(jobss, i, i + 1)
        feats = build_ext_features(inst, jobs)
        mask = inst.ext_mask if inst.ext_mask is not None else torch.ones(
            feats.shape[:-1], dtype=torch.bool, device=feats.device)
        probes.append((feats, default_support(probe, inst, cfg.layout), mask))

    def alive(params) -> int:
        with torch.no_grad():
            for k, p in probe.named_parameters():
                p.copy_(params[k])
            return sum(bool(((probe(f, s)[..., 0] > 0) & m).any()) for f, s, m in probes)

    def injected(pair):
        return InjectedDraws(*[x.to(where) for x in pair[0]]), pair[1].to(where)

    tr = RLTrainer(cfg, model, spec, devmetrics=False, sim_dtype=cfg.torch_dtype)
    init = {k: v.clone() for k, v in tr.params.items()}
    steps = []
    for pair in w["train"]:
        draws, gumbel = injected(pair)
        out = tr.train_step(insts, jobss, paramss, draws, gumbel=gumbel)
        steps.append({"loss": float(out.loss), "grad_norms": out.grad_norms.tolist(),
                      "skipped": out.skipped, "alive": alive(tr.params), "dsts": out.dsts.cpu()})
    ev = make_eval(cfg, model, spec)
    states0 = tr.init_states(cfg.rl_fleet, where)
    rates0 = torch.zeros((cfg.rl_fleet, spec.num_jobs), dtype=cfg.torch_dtype, device=where)

    def ratio(params) -> float:
        return sum(delivered_ratio(ev(params, insts, jobss, paramss, states0, rates0,
                                      *injected(pair)))
                   for pair in w["eval"]) / len(w["eval"])

    return {"alive_init": alive(init), "steps": steps, "ratio_init": ratio(init),
            "ratio_trained": ratio(tr.params)}


def rl_witness_worker(path: str) -> int:
    """`python3 chip_smoke.py --rl-witness-worker PATH`: `rl_witness_run`
    of the smoke's steps on the card, saved to PATH with `torch.save`."""
    torch.save(rl_witness_run(rl_witness_setup(), torch.device("cuda")), path)
    return 0


def rl_witness_compare(w: dict, card: dict, cpu: dict) -> dict:
    """The smoke's steps on the card against the CPU under the same
    injected draws: no skipped step, `dst` identical in >= 99% of (step,
    lane, round, job) over the steps, and the output unit dies (is alive on no probe) at
    the same step on both sides, or on neither."""
    cfg, jobss = w["cfg"], w["fleet"][1]
    mask = jobss.mask.unsqueeze(1).expand(-1, cfg.rl_rounds, -1)
    same = torch.stack([(a["dsts"] == b["dsts"])[mask]
                        for a, b in zip(card["steps"], cpu["steps"])])
    agree = [float(x) for x in same.double().mean(dim=1)]
    dies = {side: next((s for s, st in enumerate(r["steps"]) if st["alive"] == 0), None)
            for side, r in (("card", card), ("cpu", cpu))}
    zero = {side: next((s for s, st in enumerate(r["steps"]) if max(st["grad_norms"]) == 0),
                       None) for side, r in (("card", card), ("cpu", cpu))}
    res = {"dst_agreement": float(same.double().mean()), "dst_agreement_by_step": agree,
           "dies_after_step": dies, "first_zero_gradient_step": zero,
           "alive_init": {"card": card["alive_init"], "cpu": cpu["alive_init"]},
           "losses": {"card": [st["loss"] for st in card["steps"]],
                      "cpu": [st["loss"] for st in cpu["steps"]]},
           "grad_norm_max": {"card": [max(st["grad_norms"]) for st in card["steps"]],
                             "cpu": [max(st["grad_norms"]) for st in cpu["steps"]]},
           "delivered_ratio": {side: {"init": r["ratio_init"], "trained": r["ratio_trained"]}
                               for side, r in (("card", card), ("cpu", cpu))}}
    log(f"rl smoke witness ({cfg.rl_steps} steps of the smoke's run, injected draws, card "
        f"against CPU): dst agreement {res['dst_agreement']:.4f} (bar 0.99), a step "
        f"{[round(x, 4) for x in agree]}; the output unit "
        f"alive on {res['alive_init']} probes at init, dies after step {dies}; first step "
        f"with every gradient 0 {zero}; largest gradient norm a step card "
        f"{[f'{x:.2e}' for x in res['grad_norm_max']['card']]}, CPU "
        f"{[f'{x:.2e}' for x in res['grad_norm_max']['cpu']]}; delivered ratio "
        f"{res['delivered_ratio']}")
    if any(st["skipped"] for r in (card, cpu) for st in r["steps"]):
        raise AssertionError("rl smoke witness: a step was skipped")
    if res["dst_agreement"] < 0.99 or dies["card"] != dies["cpu"]:
        raise AssertionError(f"rl smoke witness: the card's run departs from the CPU's: {res}")
    return res


RL_STEPS = (("dense", MODEL_K1, {}), ("sparse", MODEL_K2, dict(layout="sparse", cheb_k=2)))


def rl_phase(dev, card) -> dict:
    """Slice 23: `mho-rl --smoke` on the card in its own process, and the
    smoke's run on the card under injected draws in another
    (`--rl-witness-worker`), while the full-width steps' fleets and the
    witness are built and stepped on the CPU; then K2's backward, the
    compared steps on the card held to the CPU's, and the model of
    record's steps at the default temperature for their launches and
    times (see the module docstring)."""
    from multihop_offload_tpu_torch.cli import rl as rl_cli
    from multihop_offload_tpu_torch.config import Config

    t0 = time.perf_counter()
    # the smoke in its own process: it flushes the sim's queue-depth
    # histogram at its capacity 64, and a process keeps one boundary set
    os.makedirs(RL_DIR, exist_ok=True)
    record = os.path.join(RL_DIR, "smoke.json")
    witness_file = os.path.join(RL_DIR, "witness_card.pt")
    procs = {"mho-rl --smoke": [sys.executable, "-m", "multihop_offload_tpu_torch.cli.rl",
                                "--smoke", "--rl_out", record],
             "witness": [sys.executable, os.path.abspath(__file__), "--rl-witness-worker",
                         witness_file]}
    procs = {k: subprocess.Popen(v, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, v in procs.items()}
    try:
        setups, cpus = {}, {}
        for tag, model_name, kw in RL_STEPS:
            setups[tag] = rl_step_setup(dataclasses.replace(
                Config(seed=0), **RL_FULL, **kw, rl_temp=RL_CMP_TEMP))
            cpus[tag] = rl_step_run(setups[tag], model_name, "cpu", plain=True)
        witness = rl_witness_setup()
        witness_cpu = rl_witness_run(witness, "cpu")
        texts = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    smoke_s = time.perf_counter() - t0
    for k, p in procs.items():
        for line in texts[k].splitlines():
            if not line.startswith((" ", "{", "}")) and "ptxas" not in line:
                log(f"[{k}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"{k} exited {p.returncode}")
    with open(record) as f:
        smoke = json.load(f)
    per_step = smoke["launches_per_step"]
    if not (smoke["conservation"]["exact"] and smoke["skipped_updates"] == 0
            and smoke["steady_launches"] and smoke["platform"] == "cuda"
            and all(per_step.get(k, 0) > 0 for k in ("fixed_point", "minplus", "minplus_bwd"))):
        raise AssertionError(f"mho-rl --smoke on the card: a gate failed: {smoke}")
    log(f"mho-rl --smoke on the card: {smoke_s:.1f} s (beside the witness and the CPU's "
        f"steps); conservation exact {smoke['conservation']['device']}, skipped 0, the same "
        f"launches every step after the first {per_step}; delivered ratio init "
        f"{smoke['delivered_ratio_init']:.4f}, trained {smoke['delivered_ratio_trained']:.4f} "
        f"(improved: {smoke['improved']}; ROADMAP.md Queue 3), last step's largest "
        f"gradient norm {smoke['grad_norm_last']:.3e}; {smoke['episodes_per_s']:.2f} "
        f"episodes/s")
    wit = rl_witness_compare(witness, torch.load(witness_file, weights_only=False), witness_cpu)
    k2b = k2_backward_phase(dev, card)
    steps, counts = {}, {}
    default_temp = Config().rl_temp
    for tag, model_name, _ in RL_STEPS:
        setup = setups[tag]
        steps[tag] = rl_compare(tag, model_name, setup, rl_step_run(setup, model_name, dev),
                                cpus[tag])
        # the model of record's step at the default temperature: its
        # launches (the schedule's, whatever the temperature samples) and
        # its times
        plain = dict(setup, cfg=dataclasses.replace(setup["cfg"], rl_temp=default_temp))
        run = rl_step_run(plain, model_name, dev)
        check_launches(f"rl {tag} train step at temperature {default_temp}", run["counts"],
                       cpus[tag]["counts"])
        counts[tag] = run["counts"]
        run["step_ms"] = run["busy"] = None
        if tag == "dense":  # the next step's wall ms, and the card's busy share over one
            step = lambda: run["tr"].train_step(*run["args"], rl_cli.train_seeds(plain["cfg"], 1))
            run["step_ms"] = wall_ms(step, 1, warmup=0)
            run["busy"] = busy_share(step, run["step_ms"])
        log(f"rl {tag} train step at temperature {default_temp} on {card['smi']}: launches "
            f"{run['counts']}, {run['first_ms']:.2f} ms (the first step)"
            + (f", {run['step_ms']:.2f} ms (the next); card busy {run['busy']['busy_ms']:.2f} "
               f"ms ({run['busy']['share']:.3f}, {run['busy']['device_records']} device "
               f"records)" if run["busy"] else ""))
        steps[tag].update({k: run[k] for k in ("first_ms", "step_ms", "busy")})
    out = {"k2_backward": k2b, "smoke": {k: smoke[k] for k in (
               "delivered_ratio_init", "delivered_ratio_trained", "improved", "grad_norm_last",
               "episodes_per_s", "launches_per_step", "conservation", "loss_first",
               "loss_last")} | {"seconds": smoke_s},
           "witness": wit,
           "steps": {k: {f: v for f, v in r.items() if f != "counts"} for k, r in steps.items()},
           "counts": {f"rl_train_step_{k}": c for k, c in counts.items()},
           "seconds": time.perf_counter() - t0}
    log(f"rl phase {out['seconds']:.1f} s")
    return out


# ---- slice 26: the scenario matrix and the health drill -----------------------

# JAX's smoke subset plus `grid_energy` (the energy-weighted objective), 4
# lanes, 2 segments of 1 round x 120 slots (JAX's cap 64 and margin 5)
SCEN_NAMES = ("ba_poisson", "grid_poisson", "corridor_links_fail", "two_tier_poisson",
              "poisson_mobility", "grid_energy")
SCEN_SHAPES = dict(scenario_fleet=4, scenario_segments=2, scenario_rounds=1,
                   scenario_slots=120)
SCEN_BUSY_SHAPES = dict(scenario_segments=1, scenario_slots=20)
SCEN_SEED = 21          # the injected uniforms (`scenarios.matrix.uniform_draws`)
SCEN_TAU_RTOL = 1e-4    # analytic taus, card vs CPU (K1 within 1e-5 of its plain version)
SCEN_DST_AGREE = 0.99   # gnn decisions, card vs CPU, as `sim_pair_phase`


def range_busy_ms(fn, prefix: str) -> dict:
    """One call of `fn` under `torch.profiler`: for each range whose name
    starts with `prefix` (a `span`), the card's busy ms inside it: the
    union of its kernel, copy and memset intervals within the range's own
    record on the device timeline (a `record_function` range shows there
    too).  Reads the profiler's raw records: building its Python events
    costs ~70 us a record, minutes at a matrix's millions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ranges, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns()))
        elif e.name().startswith(prefix):
            ranges.append((e.name()[len(prefix):], e.start_ns(), e.end_ns()))
    device.sort()
    out = {}
    for name, lo, hi in ranges:
        busy, end = 0, -math.inf
        for a, b in device:
            a, b = max(a, lo), min(b, hi)
            if b > a and b > end:
                busy += b - max(a, end)
                end = b
        out[name] = busy / 1e6
    return out


def scenario_phase(dev, card) -> dict:
    """Slice 26: `run_matrix` (`--matrix --smoke`'s checks) over
    `SCEN_NAMES` with the model of record on the card and on the CPU under
    the same injected uniforms: launches equal to the plain count of the
    CPU run; conservation exact on every lane; `baseline` and `local`
    lanes' counts and `dst` equal, `gnn` `dst` agreement >= 0.99 and equal
    counts on lanes whose decisions all agree; `grid_energy`'s decisions
    differ from `grid_poisson`'s (the same lanes under the null
    objective); then a profiled pass for each leg's busy share."""
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.obs.registry import registry
    from multihop_offload_tpu_torch.scenarios.matrix import (
        POLICY_KINDS,
        run_matrix,
        uniform_draws,
    )

    t0 = time.perf_counter()
    # the matrix flushes the sim's queue-depth histogram at cap 64 (the sim
    # phase's at 128): a process keeps one boundary set
    registry().reset()
    cfg = Config(seed=0)

    def run(d):
        return run_matrix(cfg, True, device=d, names=SCEN_NAMES, shapes=SCEN_SHAPES,
                          draws=uniform_draws(SCEN_SEED, d))

    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    card_rec = run(dev)
    counts = read_counts()
    card_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    cpu_rec, plain = count_plain(lambda: run("cpu"))
    cpu_s = time.perf_counter() - t2
    check_launches(f"scenario matrix smoke ({len(SCEN_NAMES)} legs x 3 policies, both "
                   "evaluators)", counts, plain)
    for key in ("fixed_point", "minplus"):
        if counts[key] == 0:
            raise AssertionError(f"scenario matrix: {key} never launched: {counts}")

    legs = {}
    rows = {r["name"]: r for r in card_rec["scenarios"]}
    for got, want in zip(card_rec["scenarios"], cpu_rec["scenarios"]):
        name = got["name"]
        leg = {"wall_s": got["wall_s"], "slots": got["slots"], "policies": {}}
        for kind in POLICY_KINDS:
            g, w = got["sim"][kind]["per_lane"], want["sim"][kind]["per_lane"]
            if any(g["conservation_gap"]) or any(w["conservation_gap"]):
                raise AssertionError(f"scenario {name}/{kind}: packets not conserved")
            dg = np.asarray(g["dst_per_segment"])      # (segments, lanes, J)
            dw = np.asarray(w["dst_per_segment"])
            agree = float((dg == dw).mean())
            same = (dg == dw).all(axis=(0, 2))
            counts_eq = all(np.array_equal(np.asarray(g[k])[same], np.asarray(w[k])[same])
                            for k in ("generated", "delivered", "dropped"))
            ta, tw = got["analytic"][kind]["tau"], want["analytic"][kind]["tau"]
            tau_rel = abs(ta - tw) / abs(tw)
            if kind != "gnn" and (g != w or not tau_rel <= SCEN_TAU_RTOL):
                raise AssertionError(f"scenario {name}/{kind}: card differs from the CPU: "
                                     f"{g} vs {w}; tau {ta} vs {tw}")
            if kind == "gnn" and (agree < SCEN_DST_AGREE or not counts_eq):
                raise AssertionError(f"scenario {name}/gnn: dst agreement {agree}, lanes "
                                     f"{same.tolist()} equal counts {counts_eq}")
            srow = got["sim"][kind]
            leg["policies"][kind] = {
                "sim_wall_s": srow["sim_wall_s"],
                "ms_a_slot": srow["sim_wall_s"] * 1e3 / got["slots"],
                "dst_agreement": agree, "lanes_equal": int(same.sum()),
                "tau_rel_err": tau_rel, "delivered_ratio": srow["delivered_ratio"],
                "tau": ta}
        legs[name] = leg
    energy, null = rows["grid_energy"], rows["grid_poisson"]
    moved = {k: int((np.asarray(energy["sim"][k]["per_lane"]["dst_per_segment"])
                     != np.asarray(null["sim"][k]["per_lane"]["dst_per_segment"])).sum())
             for k in ("gnn", "baseline")}
    if not any(moved.values()):
        raise AssertionError("grid_energy: the energy weights changed no decision")

    # each leg's busy share over one segment of 20 slots (the profiler slows
    # this path ~10x: the whole run would cost minutes): the card's busy ms
    # of the profiled pass over the wall of the same pass unprofiled
    def short():
        return run_matrix(cfg, False, device=dev, names=SCEN_NAMES,
                          shapes={**SCEN_SHAPES, **SCEN_BUSY_SHAPES},
                          draws=uniform_draws(SCEN_SEED, dev))
    t3 = time.perf_counter()
    short_wall = {r["name"]: r["wall_s"] for r in short()["scenarios"]}
    busy = range_busy_ms(short, "scenarios/")
    busy_s = time.perf_counter() - t3
    for name, leg in legs.items():
        leg["busy_ms"] = busy[name]
        leg["busy_wall_ms"] = short_wall[name] * 1e3
        leg["busy_share"] = busy[name] / leg["busy_wall_ms"]
        pol = ", ".join(f"{k} {v['ms_a_slot']:.3f} ms/slot" for k, v in leg["policies"].items())
        log(f"scenario leg {name} on {card['smi']}: {leg['wall_s']:.2f} s wall ({pol}); "
            f"busy share {leg['busy_share']:.4f} over one segment of "
            f"{SCEN_BUSY_SHAPES['scenario_slots']} slots ({leg['busy_ms']:.1f} of "
            f"{leg['busy_wall_ms']:.1f} ms); gnn dst agreement "
            f"{leg['policies']['gnn']['dst_agreement']}")
    if not all(leg["busy_ms"] > 0 for leg in legs.values()):
        raise AssertionError("scenario matrix: a leg's profile holds no device work")
    log(f"scenario matrix smoke: card run {card_s:.2f} s, CPU run {cpu_s:.2f} s, "
        f"busy-share passes {busy_s:.2f} s; "
        f"grid_energy decisions that differ from grid_poisson's {moved}; checks "
        f"{card_rec['checks']}; pad {card_rec['config']['pad']}")
    result = {"legs": legs, "checks": card_rec["checks"], "card_s": card_s, "cpu_s": cpu_s,
              "busy_s": busy_s,
              "energy_moved": moved, "pad": card_rec["config"]["pad"],
              "shift_drift": [{k: r[k] for k in ("from", "to", "tripped_at", "detected")}
                              for r in card_rec["shift_drift"]],
              "counts": {"scenario_matrix_smoke": counts},
              "plain_counts": {"scenario_matrix_smoke": plain},
              "seconds": time.perf_counter() - t0}
    log(f"scenario phase {result['seconds']:.1f} s")
    return result


def health_phase(dev, card) -> dict:
    """Slice 26: `cli.health.run_smoke` on the card (every JAX check but the
    retrace one, which is not applicable), its run log rendered by
    `obs.report.render_report`, its launches equal to the plain count of
    the same drill on the CPU."""
    import shutil

    from multihop_offload_tpu_torch.cli import health
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.obs.registry import registry
    from multihop_offload_tpu_torch.obs.report import render_report

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "health_card")
    shutil.rmtree(root, ignore_errors=True)
    cfg = Config(seed=0)
    # the drill reads its SLOs from the process's registry: a fresh one,
    # as its own process would have
    registry().reset()
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    rec = health.run_smoke(cfg, device=dev, tmp=os.path.join(root, "card"))
    counts = read_counts()
    drill_s = time.perf_counter() - t1
    checks = rec["checks"]
    failed = [k for k, v in checks.items()
              if v is not True and not (isinstance(v, dict) and v.get("not_applicable"))]
    if failed or not rec["ok"]:
        raise AssertionError(f"health drill on the card: {failed} failed: {checks}")
    log_path = health.smoke_config(cfg, os.path.join(root, "card")).obs_log
    text = render_report(log_path)
    for part in ("alerts & drift", "serving", "continual learning"):
        if part not in text:
            raise AssertionError(f"health drill: the report has no '{part}' section")
    registry().reset()
    cpu_rec, plain = count_plain(lambda: health.run_smoke(
        cfg, device="cpu", tmp=os.path.join(root, "cpu")))
    check_launches("health drill (serve, refit, promote)", counts, plain)
    for key in ("fixed_point", "minplus"):
        if counts[key] == 0:
            raise AssertionError(f"health drill: {key} never launched: {counts}")
    log(f"health drill on {card['smi']}: {drill_s:.2f} s; phases {rec['phases']}; alerts "
        f"{[(a['name'], a['state']) for a in rec['alerts']]}; trace of request "
        f"{rec['trace']['request_id']}: {rec['trace']['hops']}; {rec['log_segments']} log "
        f"segments; promoted step {rec['promoted_step']}; the CPU drill's alerts "
        f"{[(a['name'], a['state']) for a in cpu_rec['alerts']]}; report "
        f"{len(text.splitlines())} lines")
    result = {"checks": checks, "drill_s": drill_s, "phases": rec["phases"],
              "trace": rec["trace"], "log_segments": rec["log_segments"],
              "alerts": rec["alerts"], "promoted_step": rec["promoted_step"],
              "report_lines": len(text.splitlines()),
              "counts": {"health_drill": counts}, "plain_counts": {"health_drill": plain},
              "seconds": time.perf_counter() - t0}
    log(f"health phase {result['seconds']:.1f} s")
    return result


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
    # 100 calls a window: on an H100 these traces lost 7-8 records a window
    # at 20 and 50 calls alike, within `device_us`'s tenth of 100
    k2 = clocks(lambda: mp.minplus_closure_cuda(d, iters), 100, kernels_per_call=2 + iters)
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

    # ---- slice 16: the default APSP route at a padded N of 384 -------------
    route = route_phase(dev, card)

    # ---- slice 4: the service, and K5 on its sparse bucket's lists ----------
    serving = serving_phase(dev, card)
    k5 = ragged_kernel_phase(dev, card, serving.pop("sparse_bucket1"))

    # ---- slice 12: the Trainer and Evaluator drivers --------------------------
    drivers = driver_phase(dev, card)

    # ---- slice 13: the closed-loop packet simulator ---------------------------
    sim = sim_phase(dev, card)

    # ---- slice 14: the bf16 precision policy on the decision paths ----------
    prec = precision_phase(dev, card, paper, cfg, {
        "dense": card_out, "sparse": sp_card, "dense_model": model,
        "dense_batch": (inst, jobs), "sparse_model": sp_model_k2,
        "sparse_batch": (sp_inst, sp_jobs)})

    # ---- slice 15: the Trainer under bf16 ------------------------------------
    train16 = bf16_training_phase(dev, card)

    # ---- slice 18: the dataset generator and mho-serve's process wiring ------
    dgen = datagen_phase(dev, card)
    scli = serve_cli_phase(dev, card)

    # ---- slice 19: TF checkpoints, the paper's tables and route figure -------
    tfck = tf_checkpoint_phase(dev, card)

    # ---- slice 20: parallel/ on [cuda:0] * 4, the drivers' data mesh ---------
    par = parallel_phase(dev, card, (inst, jobs))

    # ---- slice 21: sharded serving on [cuda:0] * 4, mho-mesh over gloo ------
    shard = sharded_serving_phase(dev, card)

    # ---- slice 22: training across processes, the continual-learning loop ---
    mproc = multiprocess_phase(dev, card)
    loopr = loop_phase(dev, card)

    rl = rl_phase(dev, card)

    # ---- slice 26: the scenario matrix and the health drill -------------------
    scen = scenario_phase(dev, card)
    hlth = health_phase(dev, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    by_path = {"eval_methods": counts, "train_step": train_counts,
               "forward_backward_dense": fb_counts,
               **{f"large_{k}": v for k, v in large["counts"].items()},
               **serving.pop("counts"),
               "driver_eval_file": drivers.pop("eval_counts_file0"),
               "driver_train_file": drivers.pop("train_counts_file0"),
               **sim.pop("counts"), **prec.pop("counts"), **train16.pop("counts"),
               "large_bf16_eval_methods": large["bf16"].pop("counts"),
               **route.pop("counts"), **dgen.pop("counts"), **scli.pop("counts"),
               "tf_eval_file": tfck.pop("eval_counts_file0"),
               "route_demo": tfck.pop("route_counts"), **par.pop("counts"),
               **shard.pop("counts"), **mproc.pop("counts"), **loopr.pop("counts"),
               **rl.pop("counts"), **scen.pop("counts"), **hlth.pop("counts")}
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"drivers": drivers}), flush=True)
    print(json.dumps({"sim": sim}), flush=True)
    pk = prec.pop("kernels")
    print(json.dumps({"precision": prec}), flush=True)
    print(json.dumps({"bf16_training": train16}), flush=True)
    print(json.dumps({"route": route}), flush=True)
    print(json.dumps({"datagen": dgen}), flush=True)
    print(json.dumps({"serve_cli": scli}), flush=True)
    print(json.dumps({"tf_checkpoint": tfck}), flush=True)
    print(json.dumps({"parallel": par}), flush=True)
    print(json.dumps({"sharded_serving": shard}), flush=True)
    print(json.dumps({"multiprocess": mproc}), flush=True)
    print(json.dumps({"loop": loopr}, default=str), flush=True)
    print(json.dumps({"rl": rl}, default=str), flush=True)
    print(json.dumps({"scenarios": scen}, default=str), flush=True)
    print(json.dumps({"health": hlth}, default=str), flush=True)
    k2b, k6b = pk["minplus_bf16"]["paper"], pk["coo_apsp_bf16"]["paper"]
    k4b, k4t = pk["chebconv_bf16"]["F32"], pk["chebconv_bf16_t"]["F32"]
    k3b = large["bf16"]
    pc = prec["paths"]
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
        {"name": "minplus_squaring_bf16", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/minplus_bf16.cu",
         "replaces": "multihop_offload_tpu/ops/minplus.py:88",
         "launches": pc["eval_methods_dense"]["launches"]["minplus_bf16"],
         "squarings": pc["eval_methods_dense"]["launches"]["squarings_bf16"],
         "max_abs_err": 0.0, "ms": k2b["call_us"] / 1e3,
         "device_ms": k2b["device_us"] / 1e3, "plain_ms": k2b["plain_ms"],
         "bound_ms": k2b["bound_us"] / 1e3, "bound_by": k2b["bound_by"],
         "bound_rate": k2b["bound_rate"],
         "bound_fp32_path_ms": k2b["bound_fp32_path_us"] / 1e3,
         "library_ms": None, "shape": k2b["shape"],
         "fp32_device_ms": k2b["fp32_device_us"] / 1e3, "shapes": pk["minplus_bf16"],
         "launches_by_path": {k: v["minplus_bf16"] for k, v in by_path.items()}},
        {"name": "chebconv_propagate_bf16", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/chebconv_bf16.cu",
         "replaces": "multihop_offload_tpu/ops/chebconv.py:162",
         "launches": pc["eval_methods_sparse"]["launches"]["chebconv_bf16"],
         "max_abs_err": k4b["max_abs_err"], "ms": k4b["call_us"] / 1e3,
         "device_ms": k4b["device_us"] / 1e3, "plain_ms": k4b["plain_ms"],
         "bound_ms": k4b["bound_us"] / 1e3, "bound_by": k4b["bound_by"],
         "library_ms": k4b["library_call_us"] / 1e3, "library": k4b["library"],
         "library_device_ms": k4b["library_device_us"] / 1e3, "shape": k4b["shape"],
         "fp32_device_ms": k4b["fp32_device_us"] / 1e3, "f4": pk["chebconv_bf16"]["F4"],
         "launches_by_path": {k: v["chebconv_bf16"] for k, v in by_path.items()}},
        {"name": "coo_apsp_bf16", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/coo_apsp_bf16.cu",
         "replaces": "multihop_offload_tpu/ops/minplus.py:487",
         "launches": pc["eval_methods_sparse"]["launches"]["coo_apsp_bf16"],
         "max_abs_err": 0.0, "ms": k6b["call_us"] / 1e3,
         "device_ms": k6b["device_us"] / 1e3, "plain_ms": k6b["plain_ms"],
         "bound_ms": k6b["bound_us"] / 1e3, "bound_by": k6b["bound_by"],
         "bound_rate": k6b["bound_rate"],
         "bound_fp32_path_ms": k6b["bound_fp32_path_us"] / 1e3,
         "library_ms": None, "shape": k6b["shape"],
         "fp32_device_ms": k6b["fp32_device_us"] / 1e3,
         "squarings_per_call": k6b["squarings_run"],
         "launches_by_path": {k: v["coo_apsp_bf16"] for k, v in by_path.items()}},
        {"name": "chebconv_transpose_bf16", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/chebconv_bf16.cu",
         "replaces": "multihop_offload_tpu/ops/chebconv.py:184",
         "launches": by_path["bf16_train_step_sparse"]["chebconv_bf16_t"],
         "max_abs_err": k4t["max_abs_err"], "ms": k4t["call_us"] / 1e3,
         "device_ms": k4t["device_us"] / 1e3, "plain_ms": k4t["plain_ms"],
         "bound_ms": k4t["bound_us"] / 1e3, "bound_by": k4t["bound_by"],
         "library_ms": k4t["library_call_us"] / 1e3, "library": k4t["library"],
         "library_device_ms": k4t["library_device_us"] / 1e3, "shape": k4t["shape"],
         "fp32_device_ms": k4t["fp32_device_us"] / 1e3,
         "forward_device_ms": k4t["forward_device_us"] / 1e3,
         "f4": pk["chebconv_bf16_t"]["F4"],
         "launches_by_path": {k: v["chebconv_bf16_t"] for k, v in by_path.items()}},
        {"name": "blocked_fw_bf16", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/blocked_fw_bf16.cu",
         "replaces": "multihop_offload_tpu/ops/minplus.py:195",
         "launches": k3b["launches"], "max_abs_err": 0.0, "ms": k3b["call_us"] / 1e3,
         "device_ms": k3b["device_us"] / 1e3, "plain_ms": k3b["plain_ms"],
         "bound_ms": k3b["bound_us"] / 1e3, "bound_by": k3b["bound_by"],
         "bound_rate": k3b["bound_rate"],
         "bound_fp32_path_ms": k3b["bound_fp32_path_us"] / 1e3,
         "library_ms": None, "shape": k3b["shape"],
         "launches_per_call": k3b["launches_per_call"],
         "phase_device_us": k3b["phase_device_us"],
         "pivot_ns_per_step": k3b["pivot_ns_per_step"],
         "fp32_device_ms": large["device_ms"],
         "launches_by_path": {k: v["blocked_fw_bf16"] for k, v in by_path.items()}},
    ]
    kb = rl["k2_backward"]["4x112"]
    kernels.append(
        {"name": "minplus_backward", "route": "cuda",
         "source": "multihop_offload_tpu_torch/csrc/minplus_bwd.cu",
         "replaces": "multihop_offload_tpu/env/apsp.py:24",
         "launches": by_path["rl_train_step_dense"]["minplus_bwd"],
         "max_abs_err": kb["max_abs_err"], "ms": kb["ms"], "device_ms": kb["device_ms"],
         "span_ms": kb["span_ms"],
         "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"],
         "bound_by": kb["bound_by"], "library_ms": None, "shape": kb["shape"],
         "launches_per_backward": "1 + iters (the first squaring's tie pass, one fused "
                                  "split-and-gather a squaring)",
         "launches_per_call": {k: v["kernels_per_call"] for k, v in rl["k2_backward"].items()},
         "shapes": rl["k2_backward"],
         "launches_by_path": {k: v.get("minplus_bwd", 0) for k, v in by_path.items()}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multiprocess-worker"]:
        sys.exit(multiprocess_worker())
    if sys.argv[1:2] == ["--rl-witness-worker"]:
        sys.exit(rl_witness_worker(sys.argv[2]))
    sys.exit(main())
