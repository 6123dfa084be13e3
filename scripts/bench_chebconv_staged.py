"""A/B of builds of a staged form of K4's bf16 walks
(`scripts/chebconv_staged.cu`, tried and not kept in the package) against
the package's row walk (`csrc/chebconv_bf16.cu`) on one card, in one
process, over the staged form's launch grid.

Each `--variant TAG=SOURCE[:NAME=VALUE,...]` is a copy of the source with
`constexpr int`s set (`kClock=1`: each block's clock64 split; `kSteps`:
entries a step of the walk; `kStagedThreads`, the launch bound), built at
once into `build/k4_staged/`.  The shapes are the bf16 paths' own, as
`scripts/bench_chebconv_bf16.py` builds them: the paper batch's sparse
extended support (64 networks, E = 328) at F = 32 and 4 (the hidden
layers' width and the first layer's), and its first 16 networks at F = 4
(the service's batch), x and the cotangent standard normal from a seeded
generator.  For each variant, walk and shape, every (slices, threads) of
`GRID` (`staged_launch`'s first) is held bit-identical to the row walk
(`ops.chebconv.chebconv_propagate_cuda`), then timed on the card's clock
(`chip_smoke.device_us`, profiler); the row walk and `torch.bmm` in bf16
on the dense support are timed beside them.  One JSON line goes to stdout
and to `--out`.

    python3 scripts/bench_chebconv_staged.py \\
        --variant base=scripts/chebconv_staged.cu \\
        --variant clock=scripts/chebconv_staged.cu:kClock=1
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from scripts.bench_blocked_fw import build, parse_variant  # noqa: E402

STAGED_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# a block's shared memory on an H100 (227 KB, less the mbarrier), the most
# threads a block (`kStagedThreads`), the rows a slice aims at
STAGED_SMEM_LIMIT = 232448 - 8
STAGED_MAX_THREADS = 1024
STAGED_ROWS = 20
# (slices, threads) tried at each width, beside `staged_launch`'s
GRID = {(32, 64): [(2, 672), (4, 352), (8, 192), (8, 352)],
        (4, 64): [(2, 672), (4, 352), (8, 192), (16, 96)],
        (4, 16): [(8, 192), (16, 96), (16, 256), (32, 64)]}


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def staged_smem_bytes(e: int, f: int, nnz: int) -> int:
    """Shared bytes a block takes (`chebconv_staged.cu:staged_smem`): x (E F
    bf16) and diag (bf16), each with 16 elements of room to widen to
    16-byte boundaries, ptr (int32), and the slice's entries as 8-byte
    words (gather id, value twice), at most the padded count and one more;
    each rounded to 16 bytes."""
    return (_round16((e * f + 16) * 2) + _round16((e + 16) * 2) + _round16((e + 1) * 4)
            + _round16((nnz + 1) * 8))


def staged_launch(b: int, e: int, f: int, nnz: int, sms: int) -> dict | None:
    """The launch for (B, E, F) x over (B, nnz) lists, or None where an
    instance does not fit a block's shared memory: `slices` an instance of
    about `STAGED_ROWS` rows, but no more than fill the `sms` SMs twice
    over; `threads` a block (a group of `group` lanes a row, `word` bf16 a
    lane: 8 where F is a multiple of 8 and at least 32, 4 where a multiple
    of 4 and at least 16, else 1; every row at once up to
    `STAGED_MAX_THREADS`)."""
    smem = staged_smem_bytes(e, f, nnz)
    if smem > STAGED_SMEM_LIMIT:
        return None
    word = 8 if f % 8 == 0 and f >= 32 else 4 if f % 4 == 0 and f >= 16 else 1
    fv = f // word
    group = 4 if fv <= 4 else 8 if fv <= 8 else 16 if fv <= 16 else 32
    slices = max(1, min(-(-e // STAGED_ROWS), -(-2 * sms // max(b, 1))))
    rows = -(-e // slices)
    slices = -(-e // rows)  # no empty slice
    threads = min(STAGED_MAX_THREADS, max(32, -(-rows * group // 32) * 32))
    return {"slices": slices, "rows": rows, "threads": threads, "group": group,
            "word": word, "smem_bytes": smem, "blocks": b * slices}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True, type=parse_variant)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default="chiprun_out/k4_staged.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_chebconv_staged: needs an NVIDIA card", file=sys.stderr)
        return 1
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.models.chebconv import cast_support, chebyshev_support
    from multihop_offload_tpu_torch.ops import chebconv as cc

    dev = torch.device("cuda")
    card = cs.device_lines()
    variants = dict(args.variant)
    built = build(variants, os.path.join(ROOT, "build", "k4_staged"))
    fns = {}
    for tag, (lib, log) in built.items():
        cdll = ctypes.CDLL(lib)
        fn, clock = cdll.mho_chebconv_staged_bf16, cdll.mho_chebconv_staged_clock
        fn.argtypes, fn.restype = STAGED_ARGS, ctypes.c_int
        clock.argtypes, clock.restype = [ctypes.c_void_p], ctypes.c_int
        fns[tag] = (fn, clock, "kClock=1" in variants[tag][1])
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{tag}] {line.strip()}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = Config(arrival_scale=0.15)
    paper = load_cases("paper")[:16]
    inst, _, _ = request_batch(paper, 4, seed=0, cfg=cfg, device=dev, layout="sparse")
    dinst, _, _ = request_batch(paper, 4, seed=0, cfg=cfg, device=dev)
    sup = cast_support(sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                                csr=inst.sparse.ext_csr), torch.bfloat16)
    dense = chebyshev_support(dinst.adj_ext, dinst.ext_mask, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(14)
    record = {"card": card["smi"], "variants": {t: f"{s} {v}" for t, (s, v) in
                                                 variants.items()}, "shapes": {}}
    for f, b in GRID:
        cut = {k: t[:b].contiguous() for k, t in (
            ("row_ptr", sup.csr.row_ptr), ("col_ptr", sup.csr.col_ptr),
            ("order", sup.csr.col_order), ("rows", sup.edges.rows),
            ("cols", sup.edges.cols), ("vals", sup.edges.vals), ("diag", sup.diag))}
        e, nnz = cut["diag"].shape[1], cut["cols"].shape[1]
        x = torch.randn((b, e, f), generator=gen, device=dev).to(torch.bfloat16)
        walks = {"forward": (0, cut["row_ptr"], None, cut["cols"], x),
                 "transposed": (1, cut["col_ptr"], cut["order"], cut["rows"], x)}
        shape = {"b": b, "e": e, "f": f}
        for walk, (t, ptr, order, index, xin) in walks.items():
            def row_walk():
                return cc.chebconv_propagate_cuda(ptr, order, index, cut["vals"], cut["diag"],
                                                  xin)
            want = row_walk()
            plan = staged_launch(b, e, f, nnz, sms)
            rec = {"staged": plan,
                   "row_walk_us": cs.device_us(row_walk, args.reps, kernels_per_call=1)}
            grid = [(plan["slices"], plan["threads"])] + [
                g for g in GRID[(f, b)] if g != (plan["slices"], plan["threads"])]
            for tag, (fn, clock, clocked) in fns.items():
                for slices, threads in grid:
                    smem = staged_smem_bytes(e, f, nnz)
                    out = torch.empty_like(xin)

                    def run(fn=fn, slices=slices, threads=threads, smem=smem, out=out):
                        err = fn(t, ptr.data_ptr(), None if order is None else order.data_ptr(),
                                 index.data_ptr(), cut["vals"].data_ptr(),
                                 cut["diag"].data_ptr(), xin.data_ptr(), out.data_ptr(), b, e,
                                 f, nnz, slices, threads, smem,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{tag} {(slices, threads)}: cudaError_t {err}")
                        return out

                    try:
                        run()
                    except RuntimeError as err:  # a grid this build refuses
                        rec[f"{tag}/{slices}x{threads}"] = {"refused": str(err)}
                        continue
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        print(f"{tag} {walk} F={f} {(slices, threads)}: "
                              f"{int((out != want).sum())} entries differ from the row walk",
                              file=sys.stderr)
                        return 1
                    key = f"{tag}/{slices}x{threads}"
                    rec[key] = {"device_us": cs.device_us(run, args.reps, kernels_per_call=1)}
                    if clocked:
                        split = (ctypes.c_ulonglong * 6)()
                        clock(ctypes.addressof(split))
                        run()
                        torch.cuda.synchronize()
                        clock(ctypes.addressof(split))
                        blocks = max(int(split[3]), 1)
                        rec[key]["cycles_a_block"] = {
                            "issued_ptr_in": split[0] / blocks, "staged": split[1] / blocks,
                            "walked": split[2] / blocks, "longest_block": split[4],
                            "longest_walk": split[5]}
            dsup = dense[:b].contiguous()
            if t:
                dsup = dsup.transpose(1, 2).contiguous()
            rec["bmm_bf16_us"] = cs.device_us(lambda: torch.bmm(dsup, xin), args.reps)
            shape[walk] = rec
            timed = [k for k in rec if "/" in k and "device_us" in rec[k]]
            best = min(timed, key=lambda k: rec[k]["device_us"])
            cs.log(f"K4 bf16 {walk} B,E,F={(b, e, f)} on {card['smi']}: row walk "
                   f"{rec['row_walk_us']:.2f} us, torch.bmm bf16 {rec['bmm_bf16_us']:.2f}; "
                   + "; ".join(f"{k} {rec[k]['device_us']:.2f}"
                               + (f" {rec[k]['cycles_a_block']}" if "cycles_a_block" in rec[k]
                                  else "") for k in timed)
                   + f"; best {best}")
        record["shapes"][f"B{b}F{f}"] = shape
    line = json.dumps(record)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
