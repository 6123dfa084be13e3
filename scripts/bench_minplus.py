"""Hold builds of K2 (`csrc/minplus.cu`, `csrc/minplus_bf16.cu`: the
min-plus squaring APSP) against each other on one card, in one process,
shape by shape.

Each `--variant TAG=SOURCE[:NAME=VALUE,...]` is a source (the package's own,
an older copy unpacked with `git archive`, `scripts/minplus_tile32.cu` or a
trial build), with each `constexpr int NAME` of the source or of a header
it includes from its own directory set to VALUE.  All are compiled in
parallel with the package's nvcc flags into `build/k2_bench/`.  A variant's
C interface says how to drive it: `mho_minplus_square_f32` or
`mho_minplus_square_bf16`, a launch per squaring as `ops/minplus.py` drives
it in that element type (the input cloned into the first ping-pong buffer,
the flags zeroed, then the launches), or `mho_minplus_closure_f32(buf0, buf1, work, executed,
B, N, iters, stream)`, every squaring of a call in one launch, `work`
holding the flags (iters x B), a count per (squaring, matrix) of finished
tiles and a claim counter, zeroed.  A one-launch source whose `kSpinClock`
is set to 1 adds two uint64 sums after them, at the next even word: the
cycles its items spent waiting for their matrix's previous squaring, and
all their cycles.  A source whose `kClock` is set to 1 adds thread 0's
clock64 split of every block to `executed[1..7]` (`scripts/
minplus_tile32.cu` says which phase is which); it is logged per block at
the path's squarings.  A source that exports `mho_minplus_plan` names its
tile plan per shape.  With `--dtype bf16` the shapes are the bf16 paths'
(below, with the route cell's (4, 304) and without the float32-only (1,
1024) and (1, 128)) and the package's float32 kernel joins as the variant
`fp32`, on the same matrices in float32; each variant's input is narrowed
to its element type.

The shapes are the paths' own: the paper batch (64, 112) and the 256-node
rung (4, 256) from the decision path's APSP input
(`chip_smoke.kernel_inputs`), and, from the gpu test's generator
(`chip_smoke.minplus_input`), the service's two buckets (16, 56) and
(16, 112), the large demo's standalone squaring (1, 1024) and an odd
(5, 37), each at the squarings its path runs; and (1, 128), where every
tile of a squaring has an SM to itself (`--shapes` picks some).  At each
shape every variant is first held bit-identical to the plain closure and
its squarings run to `squarings_run_plain`, in its element type; one that fails is logged and
not timed there, and the script exits 1.  Then each is timed in turns
(forward, then backward order, `--rounds` times) on the card's own clock
(`chip_smoke.device_us`) at iters = 1 .. the path's: the device us of the
K2 kernels alone at iters = k less those at k - 1 is squaring k's share.
Logged per shape and variant: device us per call (with the clone and the
memset) and kernels per call, each squaring's us, the matrices live in each
squaring (from the flags of one run), the squarings run of B iters, the
call us (CUDA events around a loop of calls), the candidates a squaring of
one matrix computes against N^3, and the K2 kernels' share of their bound
(2 N^3 adds and mins per squaring run: in float32 CUDA-core instructions at
33.5e12 a second, in bf16 at the bf16x2 rate of 67e12 a second).  With
`--sass DIR`, each variant's `cuobjdump -sass` goes to DIR and its
instruction counts per kernel are logged.

    python3 scripts/bench_minplus.py \\
        --variant old=build/parent/multihop_offload_tpu_torch/csrc/minplus.cu \\
        --variant new=multihop_offload_tpu_torch/csrc/minplus.cu \\
        --variant split=scripts/minplus_tile32.cu:kClock=1 \\
        --out build/k2_bench.json
    python3 scripts/bench_minplus.py --dtype bf16 \\
        --variant old=build/parent/multihop_offload_tpu_torch/csrc/minplus_bf16.cu \\
        --variant new=multihop_offload_tpu_torch/csrc/minplus_bf16.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    K2_GENERATED, MODEL_K1, PEAK_BF16X2_OPS_PER_S, PEAK_FP32_INSTR_PER_S, cuda_ms,
    device_lines, device_us, kernel_inputs, minplus_input)
from scripts.bench_blocked_fw import parse_variant, variant_source  # noqa: E402
from multihop_offload_tpu_torch.ops import _build  # noqa: E402
from multihop_offload_tpu_torch.ops import minplus as mp  # noqa: E402

ONE_LAUNCH, PER_SQUARING = "mho_minplus_closure_f32", "mho_minplus_square_f32"
PER_SQUARING_BF16 = "mho_minplus_square_bf16"
DTYPES = {ONE_LAUNCH: torch.float32, PER_SQUARING: torch.float32,
          PER_SQUARING_BF16: torch.bfloat16}
# adds and mins a second: CUDA-core fp32 instructions, or bf16x2 elements
RATE = {torch.float32: PEAK_FP32_INSTR_PER_S, torch.bfloat16: PEAK_BF16X2_OPS_PER_S}
PLAN = "mho_minplus_plan"
FP32_SOURCE = os.path.join(ROOT, "multihop_offload_tpu_torch", "csrc", "minplus.cu")
# every 32 x 32 tile of a squaring on an SM of its own: a lone tile's time
LONE = {(1, 128): 7}
# the bf16 paths' generated shapes: the service's buckets, the route cell's
# (4, 304) and an odd N (the paper batch and the rung come from the path)
K2_BF16_GENERATED = {(16, 56): 6, (16, 112): 7, (4, 304): 9, (5, 37): 6}
CLOCK_PHASES = ("blocks", "load_issue", "wait_store_barrier", "k_loop", "barrier",
                "epilogue", "total")
SASS_OPS = ("FADD", "FMNMX", "HADD2", "HFMA2", "HMNMX2", "PRMT", "F2FP", "LDS", "STS", "LDG",
            "STG", "LDGSTS", "BAR", "IMAD", "IADD3", "ISETP", "LEA", "SHF", "MOV", "BRA")


def path_inputs(dev) -> dict:
    """K2's input on the paper batch and the 256-node rung, as the decision
    path hands it over (`chip_smoke.kernel_inputs`), with its squarings."""
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model

    cfg = Config(arrival_scale=0.15)
    model = load_model(MODEL_K1, device=dev)
    out = {}
    for cases, per in ((load_cases("paper")[:16], 4), (load_cases("rung256"), 1)):
        inst, jobs, _ = request_batch(cases, per, seed=0, cfg=cfg, device=dev)
        d, iters, _ = kernel_inputs(model, inst, jobs)
        out[tuple(d.shape[:2])] = (d, iters)
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
    """(symbol, bound launcher, bound plan query or None) of the variant."""
    cdll = ctypes.CDLL(lib)
    plan = None
    if hasattr(cdll, PLAN):
        plan = getattr(cdll, PLAN)
        plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        plan.restype = ctypes.c_int
    for symbol in DTYPES:
        if hasattr(cdll, symbol):
            fn = getattr(cdll, symbol)
            fn.argtypes = _build.SIGNATURES["minplus"][1]
            fn.restype = ctypes.c_int
            return symbol, fn, plan
    raise RuntimeError(f"{lib} exports none of {list(DTYPES)}")


def sass_counts(text: str) -> dict:
    """Instruction counts per kernel in `cuobjdump -sass` output: all, and
    each opcode of `SASS_OPS` (its modifiers dropped)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(("all", *SASS_OPS), 0)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m:
            op = m.group(1)
            out[name]["all"] += 1
            if op in out[name]:
                out[name][op] += 1
    return out


class Variant:
    """One build, driven as the package's wrapper drives its interface."""

    def __init__(self, tag: str, lib: str, values: list, dev):
        self.tag = tag
        self.values = values
        self.symbol, self.fn, self.plan_fn = bind(lib)
        self.dtype = DTYPES[self.symbol]
        self.spin = "kSpinClock=1" in values
        self.clock = "kClock=1" in values
        # with kClock the split sits after the squarings counter
        self.executed = torch.zeros(8 if self.clock else (), dtype=torch.int64, device=dev)
        self.work = None

    def ran(self) -> int:
        return int(self.executed.view(-1)[0])

    def kernels_per_call(self, iters: int) -> int:
        return 3 if self.symbol == ONE_LAUNCH else 2 + iters

    def plan(self, b: int, n: int) -> dict | None:
        if self.plan_fn is None:
            return None
        info = (ctypes.c_int * len(mp.PLAN_FIELDS))()
        if self.plan_fn(b, n, ctypes.addressof(info)) != 0:
            raise RuntimeError(f"{self.tag}: {PLAN} failed at {(b, n)}")
        return dict(zip(mp.PLAN_FIELDS, info))

    def candidates(self, b: int, n: int) -> int | None:
        """(min, +) candidates one squaring of one matrix computes: output
        entries of the grid's tiles times the k steps it runs."""
        plan = self.plan(b, n)
        if plan is not None:
            return plan["blocks"] // b * plan["tile_rows"] * plan["tile_cols"] * n
        if self.symbol == ONE_LAUNCH:
            return None
        if self.symbol == PER_SQUARING_BF16:  # the planless bf16 kernel: 32 x 32 tiles
            return (32 * math.ceil(n / 32)) ** 2 * n
        if "kCut=1" in self.values:  # `scripts/minplus_tile32.cu`'s cut tiles
            parts = math.ceil(n / 32)
            edge = 4 * math.ceil(math.ceil(n / parts) / 4)
            return (edge * math.ceil(n / edge)) ** 2 * n
        return (32 * math.ceil(n / 32)) ** 3  # 32 x 32 tiles, k padded to 32

    def __call__(self, d: torch.Tensor, iters: int) -> torch.Tensor:
        b, n, _ = d.shape
        bufs = (d.clone(), torch.empty_like(d))
        stream = torch.cuda.current_stream().cuda_stream
        if self.symbol == ONE_LAUNCH:
            # flags, done, the claim counter; with kSpinClock two uint64
            # cycle sums at the next even word
            self.work = torch.zeros(2 * iters * b + 2 + (4 if self.spin else 0),
                                    dtype=torch.int32, device=d.device)
            errs = [self.fn(bufs[0].data_ptr(), bufs[1].data_ptr(), self.work.data_ptr(),
                            self.executed.data_ptr(), b, n, iters, stream)]
        else:
            self.work = torch.zeros((iters, b), dtype=torch.int32, device=d.device)
            errs = [self.fn(bufs[s % 2].data_ptr(), bufs[(s + 1) % 2].data_ptr(),
                            self.work.data_ptr(), self.executed.data_ptr(), b, n, s, stream)
                    for s in range(iters)]
        if any(errs):
            raise RuntimeError(f"{self.tag}: {self.symbol} returned cudaError_t {errs}")
        return bufs[iters % 2]

    def live(self, b: int, iters: int) -> list:
        """Matrices live in each squaring of the last call, from its flags."""
        flags = self.work.view(-1)[: iters * b].view(iters, b).cpu()
        return [b] + [int(x) for x in (flags[:-1] != 0).sum(dim=1)]

    def spin_share(self, b: int, iters: int) -> float | None:
        """Waited cycles over item cycles of the last call (kSpinClock)."""
        if not self.spin:
            return None
        at = (2 * iters * b + 2) & ~1
        waited, busy = self.work[at:at + 4].cpu().view(torch.int64).tolist()
        return waited / max(busy, 1)

    def clock_split(self, d: torch.Tensor, iters: int) -> dict | None:
        """Thread 0's clock64 split per block of one call (kClock): mean
        cycles a block in each phase, and the blocks that ran."""
        if not self.clock:
            return None
        self.executed.zero_()
        self(d, iters)
        torch.cuda.synchronize()
        sums = dict(zip(CLOCK_PHASES, self.executed[1:].cpu().tolist()))
        blocks = max(sums["blocks"], 1)
        return {"blocks": sums["blocks"],
                **{k: v / blocks for k, v in sums.items() if k != "blocks"}}


def check(v: Variant, d: torch.Tensor, iters: int, want: torch.Tensor, run: int) -> list:
    """Raise unless `v` is bit-identical to the plain closure and runs
    `run` squarings; returns the live matrices per squaring."""
    b = d.shape[0]
    before = v.ran()
    got = v(d, iters)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{v.tag} at {tuple(d.shape[:2])}: {int((got != want).sum())} "
                             "entries differ from the plain closure")
    ran, live = v.ran() - before, v.live(b, iters)
    if not ran == sum(live) == run:
        raise AssertionError(f"{v.tag} at {tuple(d.shape[:2])}: {ran} squarings run, flags "
                             f"say {sum(live)}, squarings_run_plain {run}")
    return live


def kernel_us(last: dict) -> float:
    """The K2 kernels' device us per call in `device_us.last` (no clone or
    memset)."""
    return sum(us for name, us in last["by_name"].items() if "minplus" in name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True, type=parse_variant)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="bf16: the bf16 paths' shapes, the package's fp32 K2 beside")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--shapes", default=None,
                    help="comma-separated BxN of the shapes to run (default: all)")
    ap.add_argument("--sass", default=None,
                    help="directory for each variant's `cuobjdump -sass`")
    ap.add_argument("--out", default="build/k2_bench.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_minplus: needs a CUDA card", file=sys.stderr)
        return 1
    card = device_lines()
    variants = dict(args.variant)
    if args.dtype == "bf16":
        variants.setdefault("fp32", (FP32_SOURCE, []))
    built = build(variants, os.path.join(ROOT, "build", "k2_bench"))
    dev = torch.device("cuda")
    runs = {tag: Variant(tag, lib, variants[tag][1], dev) for tag, (lib, _) in built.items()}
    result = {"card": card["smi"], "variants": {t: f"{s} {v}" for t, (s, v) in variants.items()},
              "sass": {}, "shapes": {}, "failed": []}
    for tag, (lib, log) in built.items():
        print(f"  {tag}: {runs[tag].symbol} ({runs[tag].dtype})", flush=True)
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas[{tag}] {line.strip()}", flush=True)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            text = subprocess.run(["cuobjdump", "-sass", lib], capture_output=True,
                                  text=True).stdout
            with open(os.path.join(args.sass, f"k2_sass_{tag}.txt"), "w") as fh:
                fh.write(text)
            result["sass"][tag] = sass_counts(text)
            for name, counts in result["sass"][tag].items():
                print(f"  sass[{tag}] {name[:90]}: {counts}", flush=True)
    inputs = path_inputs(dev)
    generated = K2_BF16_GENERATED if args.dtype == "bf16" else {**K2_GENERATED, **LONE}
    inputs.update({shape: (minplus_input(*shape).to(dev), iters)
                   for shape, iters in generated.items()})
    if args.shapes:
        keep = {tuple(int(x) for x in s.split("x")) for s in args.shapes.split(",")}
        inputs = {shape: v for shape, v in inputs.items() if shape in keep}
    for (b, n), (d32, iters) in inputs.items():
        ds, want, run = {}, {}, {}
        for dtype in {v.dtype for v in runs.values()}:
            d = ds[dtype] = d32.to(dtype)
            want[dtype] = (mp.minplus_closure_plain(d, iters) if n <= 256
                           else mp.minplus_closure_blocked(d, iters))
            run[dtype] = mp.squarings_run_plain(d, iters)
        live, ok = {}, {}
        for tag, v in runs.items():
            try:
                live[tag] = check(v, ds[v.dtype], iters, want[v.dtype], run[v.dtype])
                ok[tag] = v
            except AssertionError as exc:
                print(f"K2 bench CHECK FAILED: {exc}", flush=True)
                result["failed"].append(str(exc))
        samples = {tag: {k: [] for k in range(1, iters + 1)} for tag in ok}
        totals = {tag: [] for tag in ok}
        for _ in range(args.rounds):
            for order in (list(ok), list(reversed(ok))):
                for tag in order:
                    v, d = ok[tag], ds[ok[tag].dtype]
                    for k in range(1, iters + 1):
                        total = device_us(lambda v=v, d=d, k=k: v(d, k), args.reps,
                                          kernels_per_call=v.kernels_per_call(k))
                        samples[tag][k].append(kernel_us(device_us.last))
                        if k == iters:
                            totals[tag].append(total)
        out = {}
        for tag, v in ok.items():
            d = ds[v.dtype]
            bound_us = 2.0 * n ** 3 * run[v.dtype] / RATE[v.dtype] * 1e6
            kern = [statistics.median(samples[tag][k]) for k in range(1, iters + 1)]
            per_sq = [kern[0]] + [kern[k] - kern[k - 1] for k in range(1, iters)]
            call = [cuda_ms(lambda v=v, d=d: v(d, iters), args.reps) * 1e3
                    for _ in range(args.rounds)]
            v(d, iters)
            torch.cuda.synchronize()
            cand = v.candidates(b, n)
            out[tag] = {"symbol": v.symbol, "dtype": str(v.dtype), "iters": iters,
                        "device_us": statistics.median(totals[tag]),
                        "device_us_range": [min(totals[tag]), max(totals[tag])],
                        "kernel_us": kern[-1], "kernels_per_call": v.kernels_per_call(iters),
                        "squaring_us": per_sq, "live": live[tag],
                        "squarings_run": sum(live[tag]), "of": b * iters,
                        "call_us": statistics.median(call),
                        "call_us_range": [min(call), max(call)],
                        "spin_share": v.spin_share(b, iters),
                        "plan": v.plan(b, n), "candidates_per_matrix": cand,
                        "candidates_over_n3": None if cand is None else cand / n ** 3,
                        "bound_us": bound_us, "share_of_bound": bound_us / kern[-1],
                        "clock": v.clock_split(d, iters)}
            o = out[tag]
            print(f"K2 bench on {card['smi']}: {tag} ({v.dtype}) B,N={(b, n)} iters={iters}: "
                  f"device us "
                  f"per call (median of {len(totals[tag])}) {o['device_us']:.2f} "
                  f"[{min(totals[tag]):.2f}, {max(totals[tag]):.2f}], K2 kernels "
                  f"{o['kernel_us']:.2f} ({o['share_of_bound']:.3f} of the bound "
                  f"{bound_us:.2f}), {o['kernels_per_call']} kernels a call; call "
                  f"{o['call_us']:.2f} us; squarings run {o['squarings_run']} of {b * iters}",
                  flush=True)
            print(f"  {tag} B,N={(b, n)} per squaring: us "
                  f"{[round(x, 2) for x in per_sq]}, live {live[tag]}"
                  + ("" if o["spin_share"] is None
                     else f"; waited {o['spin_share']:.3f} of item cycles"), flush=True)
            print(f"  {tag} B,N={(b, n)} plan {o['plan']}; candidates a squaring of a "
                  f"matrix {cand} = "
                  + ("?" if cand is None else f"{cand / n ** 3:.3f}") + " N^3", flush=True)
            if o["clock"] is not None:
                print(f"  {tag} B,N={(b, n)} clock64 split, cycles a block (thread 0): "
                      + ", ".join(f"{k} {x:.0f}" for k, x in o["clock"].items()), flush=True)
        result["shapes"][f"{b}x{n}"] = out
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"k2_bench": {s: {t: {k: r[k] for k in ("device_us", "kernel_us",
                                                              "call_us", "squarings_run",
                                                              "share_of_bound")}
                                       for t, r in o.items()}
                                   for s, o in result["shapes"].items()},
                      "failed": len(result["failed"])}), flush=True)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
