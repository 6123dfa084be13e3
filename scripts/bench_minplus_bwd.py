"""Hold the forms of K2's backward (the VJP of the min-plus squarings) against
each other on one card, in one process, shape by shape.

The package's form (`csrc/minplus_bwd.cu` through its wrapper
`ops/minplus.py:minplus_closure_bwd_cuda`: one host call, 1 + iters
launches chained by programmatic dependent launch) always runs, as
`package`.  Each `--variant TAG=SOURCE[:NAME=VALUE,...]` adds a source built
by the bench alone (`scripts/bench_minplus.py` says how NAME=VALUE sets a
`constexpr int`), driven by the C interface it exports:
`mho_minplus_closure_bwd_persistent_f32` (`scripts/minplus_bwd_persistent.cu`,
the package's passes in one cooperative launch), `mho_minplus_closure_bwd_f32`
(the package's interface: its source with its bench-only constants set,
`kPlan=0` or `1` the Full or the Wide plan at every shape, `kClock=1` a
`%globaltimer` timeline a pass, logged) or `mho_minplus_square_bwd_f32` (the
first version, `scripts/minplus_bwd_tile32.cu`: two launches a squaring, a
host call a squaring, as its wrapper drove it).  The default variant is that
first version, as `tile32`.

The shapes are `chip_smoke.K2B_SHAPES` (the RL path's (4, 16) and (4, 112)
and the bucket's (16, 112), from `chip_smoke.minplus_input`) and the
tie-heavy hop case (4, 112) (`chip_smoke.hop_weights`), each at the
squarings its N takes, on the stack K2 forward saves
(`_minplus_closure_saved`), with the cotangent `chip_smoke.k2_backward_phase`
uses.  At each shape every form is first held to autograd through the plain
squarings within `chip_smoke.K2B_TOL` of the largest gradient entry (its
error against `minplus_closure_bwd_plain`, the kernel's passes in plain
torch, is logged beside), and two calls must give the same bits; a form that
fails is logged and not timed there, and the script exits 1.  Then the forms
are timed in turns (forward, then backward order, `--rounds` times): the
device us a backward with no host in the way (`chip_smoke.graph_us`: a CUDA
graph of one call, replayed), on the card's own clock under the profiler
the span from the first kernel's start to the last one's end
(`chip_smoke.device_span_us`; the profiler curbs the launches' overlap) and
each kernel's durations (`chip_smoke.device_us`: the tie pass,
`bwd_ties_kernel`, or the first version's `bwd_split_kernel`, which also
splits the cotangent, and the chain), the call us (CUDA events around a
loop of calls, host enqueue included), the host us (the loop without a
synchronize; for the package also its C entry point alone), and the share
of the bound (6 N^3 instructions a squaring and matrix at 33.5e12 a second,
as PERF.md counts it).  `--sass DIR` writes each form's `cuobjdump -sass`
and ptxas lines there.

    python3 scripts/bench_minplus_bwd.py --variant tile32=scripts/minplus_bwd_tile32.cu \\
        --variant persistent=scripts/minplus_bwd_persistent.cu \\
        --variant full=multihop_offload_tpu_torch/csrc/minplus_bwd.cu:kPlan=0 \\
        --variant wide=multihop_offload_tpu_torch/csrc/minplus_bwd.cu:kPlan=1 \\
        --out chiprun_out/k2b_bench.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    K2B_SHAPES, K2B_TOL, PEAK_FP32_INSTR_PER_S, cuda_ms, device_lines, device_span_us, device_us,
    graph_us, hop_weights, host_us, minplus_input)
from scripts.bench_blocked_fw import parse_variant  # noqa: E402
from scripts.bench_minplus import build  # noqa: E402
from multihop_offload_tpu_torch.ops import _build  # noqa: E402
from multihop_offload_tpu_torch.ops import minplus as mp  # noqa: E402

ONE_CALL, PER_SQUARING = "mho_minplus_closure_bwd_f32", "mho_minplus_square_bwd_f32"
PERSISTENT = "mho_minplus_closure_bwd_persistent_f32"
FIRST_VERSION = os.path.join(ROOT, "scripts", "minplus_bwd_tile32.cu")
# the kernels of the tie pass (the first version's split pass also splits
# the cotangent); every other kernel is the chain
TIE_KERNELS = ("bwd_ties_kernel", "bwd_split_kernel")
# kClock's timeline slots (`csrc/minplus_bwd.cu:kStart` ...)
CLOCK_SLOTS = ("start", "start_last", "waited", "loaded", "staged", "computed", "end_first",
               "end", "blocks")


class Form:
    """One form of the backward: `__call__(stack, step_elems, lead, g,
    iters)` returns the input's cotangent, as the package's wrapper does."""

    def __init__(self, tag: str, lib: str | None, values: list = ()):
        self.tag = tag
        self.clock = None
        if lib is None:  # the package, through its wrapper
            self.symbol, self.fn = ONE_CALL, None
            return
        cdll = ctypes.CDLL(lib)
        for symbol in (PERSISTENT, ONE_CALL, PER_SQUARING):
            if hasattr(cdll, symbol):
                self.symbol, self.fn = symbol, getattr(cdll, symbol)
                break
        else:
            raise RuntimeError(f"{lib} exports none of {PERSISTENT}, {ONE_CALL}, {PER_SQUARING}")
        if self.symbol != PER_SQUARING:
            self.fn.argtypes = _build.SIGNATURES["minplus_bwd"][1]
            if "kClock=1" in values:
                self.clock = getattr(cdll, "mho_minplus_closure_bwd_clock")
                self.clock.argtypes = [ctypes.c_void_p]
                self.clock.restype = ctypes.c_int
        else:
            self.fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                + [ctypes.c_void_p])
        self.fn.restype = ctypes.c_int

    def kernels(self, iters: int) -> dict:
        """Launches a backward, by kernel name."""
        if self.symbol == PER_SQUARING:
            return {"bwd_split_kernel": iters, "bwd_gather_kernel": iters}
        if self.symbol == PERSISTENT:
            return {"bwd_persistent_kernel": 1}
        return {"bwd_ties_kernel": 1, "bwd_gather_kernel": mp.bwd_launches(iters) - 1}

    def timeline(self, stack, step_elems, lead, g, iters) -> list | None:
        """kClock: one call's timeline, a row a pass (the tie pass, then
        the chain's squarings), each slot in us after the tie pass's first
        block started."""
        if self.clock is None:
            return None
        torch.cuda.synchronize()
        _build.check_launch(self.tag, self.clock(None))
        self(stack, step_elems, lead, g, iters)
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (64 * len(CLOCK_SLOTS)))()
        _build.check_launch(self.tag, self.clock(ctypes.addressof(raw)))
        # rows 0 .. iters: the first launch's tie blocks, then the chain's
        # squarings; rows 33 .. 32 + iters: the tie blocks beside them
        picks = [("ties", 0)] + [(f"squaring {iters - r}", r) for r in range(1, iters + 1)] + [
            (f"ties beside squaring {iters - r}", 32 + r) for r in range(1, iters + 1)]
        t0 = raw[0]
        out = []
        for name, r in picks:
            row = dict(zip(CLOCK_SLOTS, raw[r * len(CLOCK_SLOTS):(r + 1) * len(CLOCK_SLOTS)]))
            if row["blocks"]:
                out.append({"pass": name, "blocks": row.pop("blocks"),
                            **{k: (v - t0) / 1e3 for k, v in row.items()
                               if v}})
        return out

    def __call__(self, stack, step_elems, lead, g, iters):
        if self.fn is None:
            return mp.minplus_closure_bwd_cuda(stack, step_elems, lead, g, iters)
        b, n, _ = g.shape
        stream = torch.cuda.current_stream().cuda_stream
        if self.symbol != PER_SQUARING:
            out, tmp = torch.empty_like(g), torch.empty_like(g)
            tie = torch.empty((2, iters, b, n, n), dtype=torch.float32, device=g.device)
            err = self.fn(stack.data_ptr(), step_elems, lead.data_ptr(), iters, g.data_ptr(),
                          out.data_ptr(), tmp.data_ptr(), tie[0].data_ptr(),
                          tie[1].data_ptr(), b, n, stream)
            _build.check_launch(self.tag, err)
            return out
        # the first version: two launches a squaring, a host call each
        m, w = torch.empty_like(g), torch.empty_like(g)
        bufs = (torch.empty_like(g), torch.empty_like(g))
        cur = g
        for i, s in enumerate(reversed(range(iters))):
            out = bufs[i % 2]
            err = self.fn(stack.data_ptr(), step_elems, lead.data_ptr(), s, cur.data_ptr(),
                          out.data_ptr(), m.data_ptr(), w.data_ptr(), b, n, stream)
            _build.check_launch(self.tag, err)
            cur = out
        return cur


def c_call_host_us(stack, step_elems, lead, g, iters, reps) -> float:
    """Host us of the package's C entry point alone, its scratch allocated
    once: the wrapper's host time less its Python and allocations."""
    fn = _build.kernel("minplus_bwd")
    b, n, _ = g.shape
    out, tmp = torch.empty_like(g), torch.empty_like(g)
    tie = torch.empty((2, iters, b, n, n), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (stack.data_ptr(), step_elems, lead.data_ptr(), iters, g.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), tie[0].data_ptr(), tie[1].data_ptr(), b, n, stream)
    return host_us(lambda: fn(*args), reps)


def shape_inputs(dev) -> dict:
    """tag -> (d, cotangent, stack, step_elems, lead, iters) on the card."""
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
        fwd, stack, step_elems, lead = mp._minplus_closure_saved(d, iters)
        ct = torch.where(torch.isfinite(fwd), c, 0.0)
        out[tag] = (d, ct, stack, step_elems, lead, iters)
    return out


def check(form: Form, inp, want: torch.Tensor, plain: torch.Tensor) -> dict:
    """Raise unless `form` is within `K2B_TOL` of autograd's gradient and
    deterministic; returns its errors."""
    _, ct, stack, step_elems, lead, iters = inp
    got = form(stack, step_elems, lead, ct, iters)
    again = form(stack, step_elems, lead, ct, iters)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not (err <= K2B_TOL * scale and torch.isfinite(got).all()):
        raise AssertionError(f"{form.tag}: max |err| {err:.3e} > {K2B_TOL} x {scale:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"{form.tag}: two calls differ")
    return {"max_abs_err": err, "max_abs_grad": scale,
            "err_vs_plain_passes": float((got - plain).abs().max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", type=parse_variant, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--shapes", default=None,
                    help="comma-separated tags of the shapes to run (default: all)")
    ap.add_argument("--sass", default=None,
                    help="directory for each form's `cuobjdump -sass` and ptxas lines")
    ap.add_argument("--out", default="chiprun_out/k2b_bench.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_minplus_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    card = device_lines()
    variants = dict(args.variant or [("tile32", (FIRST_VERSION, []))])
    built = build(variants, os.path.join(ROOT, "build", "k2b_bench"))
    forms = {"package": Form("package", None)}
    forms.update({tag: Form(tag, lib, variants[tag][1]) for tag, (lib, _) in built.items()})
    for tag, (lib, log) in built.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas[{tag}] {line.strip()}", flush=True)
    _build.build_all()
    for name, entry in _build.build_log.items():
        if name == "minplus_bwd":
            for line in entry["ptxas"].splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling entry")):
                    print(f"  ptxas[package] {line.strip()}", flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        libs = {"package": _build.build_all()["minplus_bwd"],
                **{tag: lib for tag, (lib, _) in built.items()}}
        for tag, lib in libs.items():
            text = subprocess.run(["cuobjdump", "-sass", lib], capture_output=True,
                                  text=True).stdout
            with open(os.path.join(args.sass, f"k2b_sass_{tag}.txt"), "w") as fh:
                fh.write(text)
        with open(os.path.join(args.sass, "k2b_ptxas.txt"), "w") as fh:
            for tag, (_, log) in {"package": (None, _build.build_log["minplus_bwd"]["ptxas"]),
                                  **built}.items():
                fh.write(f"== {tag}\n{log}\n")
    dev = torch.device("cuda")
    inputs = shape_inputs(dev)
    if args.shapes:
        keep = set(args.shapes.split(","))
        inputs = {k: v for k, v in inputs.items() if k in keep}
    result = {"card": card["smi"], "variants": {t: f"{s} {v}" for t, (s, v) in variants.items()},
              "shapes": {}, "plans": {}, "failed": []}
    plan_fn = _build.symbol("minplus_bwd", "mho_minplus_closure_bwd_plan",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for stag, inp in inputs.items():
        d, ct, stack, step_elems, lead, iters = inp
        b, n, _ = d.shape
        info = (ctypes.c_int * 5)()
        _build.check_launch("plan", plan_fn(b, n, ctypes.addressof(info)))
        result["plans"][stag] = dict(zip(("wide", "threads", "gather_blocks", "chain_smem_bytes",
                                          "first_smem_bytes"), info))
        print(f"  package plan at {stag}: {result['plans'][stag]}", flush=True)
        x = d.clone().requires_grad_()
        sp = mp.minplus_closure_diff_plain(x, iters)
        (want,) = torch.autograd.grad(sp, x, grad_outputs=ct)
        plain = mp.minplus_closure_bwd_plain(stack, step_elems, lead, ct, iters)
        ok, errs = {}, {}
        for tag, form in forms.items():
            try:
                errs[tag] = check(form, inp, want, plain)
                ok[tag] = form
            except AssertionError as exc:
                msg = f"{stag}: {exc}"
                print(f"K2 backward bench CHECK FAILED: {msg}", flush=True)
                result["failed"].append(msg)
        dev_us = {tag: [] for tag in ok}
        sums = {tag: [] for tag in ok}
        split = {tag: [] for tag in ok}
        for _ in range(args.rounds):
            for order in (list(ok), list(reversed(ok))):
                for tag in order:
                    f = ok[tag]
                    call = lambda f=f: f(stack, step_elems, lead, ct, iters)
                    kernels = f.kernels(iters)
                    sums[tag].append(device_us(call, args.reps, per_call=kernels))
                    split[tag].append(dict(device_us.last["by_name"]))
                    span = device_span_us(call, args.reps, sum(kernels.values()),
                                          tuple(kernels))
                    if span is not None:
                        dev_us[tag].append(span)
        out = {}
        bound_us = 6.0 * b * n ** 3 * iters / PEAK_FP32_INSTR_PER_S * 1e6
        for tag, f in ok.items():
            call = lambda f=f: f(stack, step_elems, lead, ct, iters)
            calls = [cuda_ms(call, args.reps) * 1e3 for _ in range(args.rounds)]
            hosts = [host_us(call, args.reps) for _ in range(args.rounds)]
            c_host = c_call_host_us(stack, step_elems, lead, ct, iters, args.reps) \
                if tag == "package" else None
            graphs = [x for x in (graph_us(call, args.reps) for _ in range(args.rounds))
                      if x is not None]
            by_kernel = {k: statistics.median(s.get(k, 0.0) for s in split[tag])
                         for k in f.kernels(iters)}
            tie = sum(v for k, v in by_kernel.items() if k in TIE_KERNELS)
            # the span a call; where every trace lost records, the sum of
            # the kernels' durations (an upper bound where they overlap)
            spans = dev_us[tag] or sums[tag]
            dus = statistics.median(spans)
            timeline = f.timeline(stack, step_elems, lead, ct, iters)
            out[tag] = {"symbol": f.symbol, "iters": iters, "leading_changes": lead.tolist(),
                        "kernels_per_call": sum(f.kernels(iters).values()),
                        "device_us": dus, "device_us_range": [min(spans), max(spans)],
                        "device_us_is_span": bool(dev_us[tag]),
                        "kernel_sum_us": statistics.median(sums[tag]),
                        "device_us_by_kernel": by_kernel, "tie_pass_us": tie,
                        "chain_us": dus - tie, "timeline": timeline,
                        "call_us": statistics.median(calls), "call_us_range": [min(calls),
                                                                              max(calls)],
                        "host_us": statistics.median(hosts), "c_call_host_us": c_host,
                        "graph_us": statistics.median(graphs) if graphs else None,
                        "graph_us_range": [min(graphs), max(graphs)] if graphs else None,
                        "bound_us": bound_us,
                        "share_of_bound": bound_us / dus,
                        "graph_share_of_bound": bound_us / statistics.median(graphs)
                        if graphs else None, **errs[tag]}
            o = out[tag]
            print(f"K2 backward bench on {card['smi']}: {tag} {stag} iters={iters} "
                  f"(leading changes {lead.tolist()}): device us "
                  f"{'(span)' if dev_us[tag] else '(kernel sum: spans lost)'} {dus:.2f} "
                  f"[{min(spans):.2f}, {max(spans):.2f}] ({o['kernels_per_call']} kernels, "
                  f"durations summing to {o['kernel_sum_us']:.2f}; tie pass {tie:.2f}, chain "
                  f"{dus - tie:.2f}; by kernel "
                  f"{ {k: round(v, 2) for k, v in by_kernel.items()} }), call "
                  f"{o['call_us']:.2f} us [{min(calls):.2f}, {max(calls):.2f}], graph replay "
                  + ("not measured" if not graphs else
                     f"{o['graph_us']:.2f} us [{min(graphs):.2f}, {max(graphs):.2f}]")
                  + ", host "
                  f"{o['host_us']:.2f} us"
                  + ("" if c_host is None else f" (the bare C call {c_host:.2f})")
                  + f"; bound {bound_us:.2f} us, share "
                  f"{o['share_of_bound']:.4f}; max |err| {o['max_abs_err']:.3e} of "
                  f"{o['max_abs_grad']:.3e} (vs the plain passes "
                  f"{o['err_vs_plain_passes']:.3e})", flush=True)
            for row in timeline or []:
                print(f"  {tag} {stag} timeline {row['pass']}: "
                      + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in row.items() if k != "pass"), flush=True)
        result["shapes"][stag] = out
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"k2b_bench": {s: {t: {k: r[k] for k in ("device_us", "graph_us",
                                                               "tie_pass_us", "call_us",
                                                               "host_us", "share_of_bound")}
                                        for t, r in o.items()}
                                    for s, o in result["shapes"].items()},
                      "failed": len(result["failed"])}), flush=True)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
