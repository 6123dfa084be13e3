"""Hold builds of K3 (`csrc/blocked_fw.cu`, `csrc/blocked_fw_bf16.cu`:
blocked Floyd-Warshall) against each other on one card, in one process,
phase by phase.

Each `--variant TAG=SOURCE[:NAME=VALUE,...]` is a source that exports
`mho_blocked_fw_f32` or `mho_blocked_fw_bf16` (the package's own, or an
older copy unpacked with `git archive`), with each `constexpr int NAME` of
the source or of a header it includes from its own directory set to VALUE
(`kW=16`: 16 pivot warps; `kOuterM=64,kOuterN=32`: 64 x 32 outer tiles).
Each is driven in the element type of the launcher it exports.  All are
compiled in parallel with the package's nvcc flags into `build/k3_bench/`.
With `--dtype bf16` the shapes are the bf16 paths' (the large path's (1,
1024) and the `'pallas'` route's padded (2, 384)) and the package's float32
kernel joins as the variant `fp32`, on the same matrices in float32.  At
each shape every variant is first held bit-identical to `blocked_fw_plain`
in its element type on the card, then timed in turns (forward, then
backward order, `--rounds` times) on the card's own clock: the device us
of each phase (`fw_pivot_kernel`, `fw_panels_kernel`, `fw_outer_kernel`)
per call, from `torch.profiler`, as `chip_smoke.py`'s `device_us` reads
them, and ns per pivot step (pivot us over 128 N / 128 steps).  The inputs
are the gpu test's: a random graph of density 6 / N, weights U(0.1, 5),
made from `default_rng(N)` (narrowed to bf16 for a bf16 variant).

    python3 scripts/bench_blocked_fw.py \\
        --variant old=build/parent/multihop_offload_tpu_torch/csrc/blocked_fw.cu \\
        --variant new=multihop_offload_tpu_torch/csrc/blocked_fw.cu \\
        --out chiprun_out/k3_bench.json --sass chiprun_out
    python3 scripts/bench_blocked_fw.py --dtype bf16 \\
        --variant old=build/parent/multihop_offload_tpu_torch/csrc/blocked_fw_bf16.cu \\
        --variant new=multihop_offload_tpu_torch/csrc/blocked_fw_bf16.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_lines, device_us, fw_input, k3_phase_us  # noqa: E402
from multihop_offload_tpu_torch.ops import _build  # noqa: E402
from multihop_offload_tpu_torch.ops import minplus as mp  # noqa: E402

SHAPES = {"f32": ((1, 128), (132, 128), (1, 1024)), "bf16": ((1, 1024), (2, 384))}
SYMBOLS = {"mho_blocked_fw_f32": torch.float32, "mho_blocked_fw_bf16": torch.bfloat16}
FP32_SOURCE = os.path.join(ROOT, "multihop_offload_tpu_torch", "csrc", "blocked_fw.cu")


def inline_includes(path: str, seen: set | None = None) -> str:
    """The text of `path` with each `#include "FILE"` of a file beside it
    replaced by that file's text, once (as its `#pragma once` would have
    it), so that a copy compiles anywhere and every constant it reaches can
    be set."""
    seen = set() if seen is None else seen
    base = os.path.dirname(os.path.abspath(path))
    out = []
    with open(path) as fh:
        for line in fh:
            m = re.match(r'\s*#include "([^"]+)"', line)
            inc = os.path.join(base, m.group(1)) if m else None
            if inc and os.path.isfile(inc):
                if inc not in seen:
                    seen.add(inc)
                    out.append(inline_includes(inc, seen))
                continue
            if line.strip() != "#pragma once":
                out.append(line)
    return "".join(out)


def variant_source(src: str, values: list, out: str) -> str:
    """Write `src`, its local includes inlined, to `out` with each
    `constexpr int NAME = ...;` named in `values` ("NAME=VALUE") set to
    VALUE; returns `out`."""
    text = inline_includes(src)
    for item in values:
        name, _, value = item.partition("=")
        text, n = re.subn(rf"constexpr int {name} = [^;]*;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{src}: {n} definitions of constexpr int {name}")
    with open(out, "w") as fh:
        fh.write(text)
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
    """(bound launcher, its element type) of the variant's library."""
    cdll = ctypes.CDLL(lib)
    for symbol, dtype in SYMBOLS.items():
        if hasattr(cdll, symbol):
            fn = getattr(cdll, symbol)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            return fn, dtype
    raise RuntimeError(f"{lib} exports none of {list(SYMBOLS)}")


def run(fn, d: torch.Tensor) -> None:
    """One K3 call in place on `d`, on the current stream."""
    b, n, _ = d.shape
    err = fn(d.data_ptr(), b, n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3 variant returned cudaError_t {err}")


def parse_variant(text: str):
    tag, _, rest = text.partition("=")
    src, _, values = rest.partition(":")
    return tag, (src, [x for x in values.split(",") if x])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True, type=parse_variant)
    ap.add_argument("--dtype", choices=tuple(SHAPES), default="f32",
                    help="bf16: the bf16 paths' shapes, the package's fp32 K3 beside")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/k3_bench.json")
    ap.add_argument("--sass", default=None,
                    help="directory for each variant's `cuobjdump -sass` of the pivot")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_blocked_fw: needs a CUDA card", file=sys.stderr)
        return 1
    card = device_lines()
    variants = dict(args.variant)
    if args.dtype == "bf16":
        variants.setdefault("fp32", (FP32_SOURCE, []))
    built = build(variants, os.path.join(ROOT, "build", "k3_bench"))
    bound = {tag: bind(lib) for tag, (lib, _) in built.items()}
    fns = {tag: fn for tag, (fn, _) in bound.items()}
    dtypes = {tag: dtype for tag, (_, dtype) in bound.items()}
    for tag, (lib, log) in built.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas[{tag}] {line.strip()}", flush=True)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            sass = subprocess.run(["cuobjdump", "-sass", lib], capture_output=True,
                                  text=True).stdout
            with open(os.path.join(args.sass, f"k3_sass_{tag}.txt"), "w") as fh:
                fh.write(sass)
    dev = torch.device("cuda")
    result = {"card": card["smi"], "variants": {t: f"{s} {v}" for t, (s, v) in variants.items()},
              "dtypes": {t: str(x) for t, x in dtypes.items()}, "shapes": {}}
    for b, n in SHAPES[args.dtype]:
        d32 = fw_input(b, n).to(dev)
        ds = {dtype: d32.to(dtype) for dtype in set(dtypes.values())}
        for tag, fn in fns.items():
            d = ds[dtypes[tag]]
            got = d.clone()
            run(fn, got)
            torch.cuda.synchronize()
            ref = mp.blocked_fw_plain(d)
            if not torch.equal(got, ref):
                raise AssertionError(f"{tag} at {(b, n)} {d.dtype}: {int((got != ref).sum())} "
                                     "entries differ from blocked_fw_plain")
        runs = {tag: [] for tag in fns}
        # timed in place: FW's work does not depend on the values
        bufs = {dtype: d.clone() for dtype, d in ds.items()}
        for _ in range(args.rounds):
            for order in (list(fns), list(reversed(fns))):
                for tag in order:
                    buf = bufs[dtypes[tag]]
                    total = device_us(lambda fn=fns[tag], buf=buf: run(fn, buf), args.reps,
                                      kernels_per_call=3 * (n // 128) if n > 128 else 1)
                    runs[tag].append({"total": total, **k3_phase_us(device_us.last)})
        steps = n  # 128 steps for each of the n / 128 pivot blocks
        shape = {}
        for tag, rs in runs.items():
            med = {k: statistics.median(r[k] for r in rs) for k in rs[0]}
            shape[tag] = {"dtype": str(dtypes[tag]), "median_us": med,
                          "min_us": {k: min(r[k] for r in rs) for k in rs[0]},
                          "max_us": {k: max(r[k] for r in rs) for k in rs[0]},
                          "pivot_ns_per_step": med["pivot"] * 1e3 / steps}
            print(f"K3 bench on {card['smi']}: {tag} ({dtypes[tag]}) B,N={(b, n)}: device us "
                  f"per call "
                  f"(median of {len(rs)}) total {med['total']:.2f}, pivot {med['pivot']:.2f} "
                  f"({med['pivot'] * 1e3 / steps:.1f} ns/step), panels {med['panels']:.2f}, "
                  f"outer {med['outer']:.2f}; total min {shape[tag]['min_us']['total']:.2f} "
                  f"max {shape[tag]['max_us']['total']:.2f}", flush=True)
        result["shapes"][f"{b}x{n}"] = shape
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"k3_bench": result["shapes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
