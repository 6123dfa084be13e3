"""Hold builds of K1 (`csrc/fixed_point.cu`, the conflict-interference fixed
point) against each other on one card, in one process, shape by shape.

Each `--variant TAG=SOURCE[:NAME=VALUE,...]` is a source that exports
`mho_fixed_point_f32` (the package's own, or an older copy unpacked with
`git archive`), with each `constexpr int NAME` of the source set to VALUE
(`kThreads=512`).  All are compiled in parallel with the package's nvcc
flags into `build/k1_bench/`.

The shapes are the main paths' own: the paper batch (64, 216) and the
256-node rung (4, 496) with the model of record's link lambdas
(`chip_smoke.kernel_inputs`), and, from the gpu test's generator (a
symmetric 0/1 matrix of density 8 / L, rates U(30, 70) rounded, lambdas
U(0, 60), cf the row sums, from `default_rng(L)`), the service's two
buckets (16, 96) and (16, 216), the kernel's cap (1, 928) and an odd
(3, 215).  At each shape every variant is first checked: within 1e-5
relative of `fixed_point_plain` at 10 rounds, bit for bit
`rates / (cf + 1)` at 0 rounds, and the same bits on a second call.  Then
each is timed in turns (forward, then backward order, `--rounds` times) on
the card's own clock (`chip_smoke.device_us`, one kernel a call), at
`num_iters=10` and at `num_iters=0`.  The 0-round launch reads A and
writes mu0 only, so its time is the A pass; (t10 - t0) / 10 is one round.
Logged per shape and variant: the medians, the ns a round and the A
pass's rate (B L^2 4 bytes over t0).  `--iters 0,1,10,20` adds the slope
(t20 - t10) / 10, one round alone, and t1 - t0 less the slope, what the
first round's launch adds besides its round.  The SM clock is read before
and after from `torch.cuda._sleep` (a spin of a known number of cycles on
the card's clock).

    python3 scripts/bench_fixed_point.py \\
        --variant old=build/parent/multihop_offload_tpu_torch/csrc/fixed_point.cu \\
        --variant new=multihop_offload_tpu_torch/csrc/fixed_point.cu \\
        --out build/k1_bench.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    K1_GENERATED, MODEL_K1, device_lines, device_us, fp_input, kernel_inputs)
from scripts.bench_blocked_fw import parse_variant, variant_source  # noqa: E402
from multihop_offload_tpu_torch.ops import _build  # noqa: E402
from multihop_offload_tpu_torch.ops import fixed_point as fp  # noqa: E402

def path_inputs(dev) -> dict:
    """K1's operands on the paper batch and the 256-node rung, as the
    decision path hands them to it (`chip_smoke.kernel_inputs`)."""
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model

    cfg = Config(arrival_scale=0.15)
    model = load_model(MODEL_K1, device=dev)
    out = {}
    for cases, per in ((load_cases("paper")[:16], 4), (load_cases("rung256"), 1)):
        inst, jobs, _ = request_batch(cases, per, seed=0, cfg=cfg, device=dev)
        args = kernel_inputs(model, inst, jobs)[2]
        out[tuple(args[1].shape)] = list(args)
    return out


def build(variants: dict, out_dir: str) -> dict:
    """Compile every variant at once; returns {tag: (library, ptxas log)}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, (src, values) in variants.items():
        lib = os.path.join(out_dir, f"{tag}.so")
        src = variant_source(src, values, os.path.join(out_dir, f"{tag}.cu"))
        procs[tag] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        built[tag] = (lib, log)
    return built


def bind(lib: str):
    fn = ctypes.CDLL(lib).mho_fixed_point_f32
    fn.argtypes = _build.SIGNATURES["fixed_point"][1]
    fn.restype = ctypes.c_int
    return fn


def run(fn, args, iters: int) -> torch.Tensor:
    """One K1 launch on the current stream; returns mu."""
    adj, rates, cf, lam = args
    b, l, _ = adj.shape
    mu = torch.empty_like(rates)
    err = fn(adj.data_ptr(), rates.data_ptr(), cf.data_ptr(), lam.data_ptr(),
             mu.data_ptr(), b, l, iters, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mho_fixed_point_f32 returned cudaError_t {err}")
    return mu


def check(tag: str, fn, args, shape) -> float:
    """Raise unless `fn` holds K1's three checks at this shape; returns the
    max relative error at 10 rounds."""
    want = fp.fixed_point_plain(*args)
    got = run(fn, args, 10)
    again = run(fn, args, 10)
    mu0 = run(fn, args, 0)
    torch.cuda.synchronize()
    rel = ((got - want).abs() / want.abs()).max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"{tag} at {shape}: max relative error {rel} > 1e-5")
    if not torch.equal(got, again):
        raise AssertionError(f"{tag} at {shape}: two calls differ")
    if not torch.equal(mu0, args[1] / (args[2] + 1.0)):
        raise AssertionError(f"{tag} at {shape}: num_iters=0 is not rates / (cf + 1)")
    return rel


def sm_mhz(cycles: int = 2_000_000) -> float:
    """The SM clock in MHz: a spin of `cycles` cycles over its device us."""
    return cycles / device_us(lambda: torch.cuda._sleep(cycles), 5, kernels_per_call=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True, type=parse_variant)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--iters", default="10,0",
                    type=lambda t: [int(x) for x in t.split(",")])
    ap.add_argument("--sass", default=None,
                    help="directory for each variant's `cuobjdump -sass`")
    ap.add_argument("--out", default="build/k1_bench.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_fixed_point: needs a CUDA card", file=sys.stderr)
        return 1
    card = device_lines()
    variants = dict(args.variant)
    built = build(variants, os.path.join(ROOT, "build", "k1_bench"))
    fns = {tag: bind(lib) for tag, (lib, _) in built.items()}
    for tag, (lib, log) in built.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas[{tag}] {line.strip()}", flush=True)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            with open(os.path.join(args.sass, f"k1_sass_{tag}.txt"), "w") as fh:
                fh.write(subprocess.run(["cuobjdump", "-sass", lib], capture_output=True,
                                        text=True).stdout)
    dev = torch.device("cuda")
    inputs = path_inputs(dev)
    inputs.update({(b, l): [t.to(dev) for t in fp_input(b, l)] for b, l in K1_GENERATED})
    result = {"card": card["smi"], "variants": {t: f"{s} {v}" for t, (s, v) in variants.items()},
              "sm_mhz_before": sm_mhz(), "shapes": {}}
    for shape, op in inputs.items():
        b, l = shape
        errs = {tag: check(tag, fn, op, shape) for tag, fn in fns.items()}
        runs = {tag: {it: [] for it in args.iters} for tag in fns}
        for _ in range(args.rounds):
            for order in (list(fns), list(reversed(fns))):
                for tag in order:
                    for iters in args.iters:
                        runs[tag][iters].append(device_us(
                            lambda fn=fns[tag], it=iters: run(fn, op, it), args.reps,
                            kernels_per_call=1))
        out = {}
        for tag, r in runs.items():
            t10, t0 = statistics.median(r[10]), statistics.median(r[0])
            out[tag] = {"us_iters10": t10, "us_iters0": t0,
                        "us_iters10_range": [min(r[10]), max(r[10])],
                        "us_iters0_range": [min(r[0]), max(r[0])],
                        "ns_per_round": (t10 - t0) * 100.0,
                        "a_pass_tb_per_s": b * l * l * 4 / (t0 * 1e-6) / 1e12,
                        "max_rel_err": errs[tag]}
            if {1, 20} <= set(r):
                t1, t20 = statistics.median(r[1]), statistics.median(r[20])
                out[tag].update(us_iters1=t1, us_iters20=t20,
                                slope_ns_per_round=(t20 - t10) * 100.0,
                                first_launch_extra_us=t1 - t0 - (t20 - t10) / 10)
                print(f"  {tag} B,L={shape}: iters=1 {t1:.2f}, iters=20 {t20:.2f}: slope "
                      f"{out[tag]['slope_ns_per_round']:.1f} ns a round; t1 - t0 less it "
                      f"{out[tag]['first_launch_extra_us']:.2f} us", flush=True)
            print(f"K1 bench on {card['smi']}: {tag} B,L={shape}: device us (median of "
                  f"{len(r[10])}) iters=10 {t10:.2f} [{min(r[10]):.2f}, {max(r[10]):.2f}], "
                  f"iters=0 {t0:.2f} [{min(r[0]):.2f}, {max(r[0]):.2f}]; "
                  f"{out[tag]['ns_per_round']:.1f} ns a round; A pass "
                  f"{out[tag]['a_pass_tb_per_s']:.3f} TB/s; max rel err {errs[tag]:.2e}",
                  flush=True)
        result["shapes"][f"{b}x{l}"] = out
    result["sm_mhz_after"] = sm_mhz()
    print(f"SM clock from torch.cuda._sleep: {result['sm_mhz_before']:.0f} MHz before, "
          f"{result['sm_mhz_after']:.0f} MHz after", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"k1_bench": result["shapes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
