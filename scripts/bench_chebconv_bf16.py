"""Hold K4's bf16 forward (`csrc/chebconv_bf16.cu`) at each word width V
(1 or 4 bf16 a lane, where F admits it) against each other on one card, in
one process.

The shapes are the bf16 paths' own: the paper batch's sparse extended
support (64 networks, E = 328, 118,936 real entries) at F = 32, and its
first 16 networks at F = 4 (the service's width), narrowed to bf16 as the
bf16 ChebNet narrows it; x is standard normal from a seeded generator.
Every V is first held bit-identical to the others, and to the width the
launcher picks (`mho_chebconv_propagate_bf16`), and within one bf16 ulp
of the plain version (`ops/chebconv.py:chebconv_propagate_plain`); then
each is timed on the card's clock (`chip_smoke.clocks`: device us from the
profiler, call us from CUDA events over a loop, host us), beside the fp32
K4 on the same support widened and `torch.bmm` in bf16 on the dense
support.  One JSON line goes to stdout (and to `--out`).

    python3 scripts/bench_chebconv_bf16.py --out build/k4_bf16.json
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

WIDTHS = (1, 4)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=500)
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_chebconv_bf16: needs an NVIDIA card", file=sys.stderr)
        return 1
    from multihop_offload_tpu_torch.config import Config
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support
    from multihop_offload_tpu_torch.models.chebconv import cast_support, chebyshev_support
    from multihop_offload_tpu_torch.ops import _build
    from multihop_offload_tpu_torch.ops import chebconv as cc

    dev = torch.device("cuda")
    card = cs.device_lines()
    fn = _build.symbol("chebconv_bf16", "mho_chebconv_propagate_bf16_v",
                       [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    paper = load_cases("paper")[:16]
    cfg = Config(arrival_scale=0.15)
    inst, _, _ = request_batch(paper, 4, seed=0, cfg=cfg, device=dev, layout="sparse")
    dinst, _, _ = request_batch(paper, 4, seed=0, cfg=cfg, device=dev)
    sup = cast_support(sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                                csr=inst.sparse.ext_csr), torch.bfloat16)
    dense = chebyshev_support(dinst.adj_ext, dinst.ext_mask, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(14)
    record = {"card": card["smi"], "shapes": {}}
    for f, b in ((32, 64), (4, 16)):
        ptr, cols = sup.csr.row_ptr[:b].contiguous(), sup.edges.cols[:b].contiguous()
        rows, vals = sup.edges.rows[:b].contiguous(), sup.edges.vals[:b].contiguous()
        diag = sup.diag[:b].contiguous()
        e, nnz = diag.shape[1], cols.shape[1]
        x = torch.randn((b, e, f), generator=gen, device=dev).to(torch.bfloat16)

        def run(v, out):
            with torch.cuda.device(dev):
                err = fn(v, ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), diag.data_ptr(),
                         x.data_ptr(), out.data_ptr(), b, e, f, nnz,
                         torch.cuda.current_stream().cuda_stream)
            _build.check_launch("chebconv_bf16", err)
            return out

        plain = cc.chebconv_propagate_plain(rows, cols, vals, diag, x).float()
        widths = [v for v in WIDTHS if f % v == 0]
        outs = {v: run(v, torch.empty_like(x)) for v in widths}
        picked = cc.chebconv_propagate_cuda(ptr, None, cols, vals, diag, x)
        torch.cuda.synchronize()
        ulp = ((outs[1].float() - plain).abs() - (cs.BF16_ULP * plain.abs() + 1e-6)).max()
        same = all(torch.equal(o, outs[1]) for o in (*outs.values(), picked))
        if not same or ulp.item() > 0:
            print(f"F={f}: widths bit-identical {same}, one-ulp excess {ulp.item()}",
                  file=sys.stderr)
            return 1
        shape = {"b": b, "e": e, "f": f, "nnz_real": int((vals != 0).sum())}
        for v in widths:
            buf = torch.empty_like(x)
            shape[f"v{v}"] = cs.clocks(lambda: run(v, buf), args.reps, kernels_per_call=1)
        v32, d32, x32 = vals.float(), diag.float(), x.float()
        shape["fp32_k4"] = cs.clocks(lambda: cc.chebconv_propagate_cuda(
            ptr, None, cols, v32, d32, x32), args.reps, kernels_per_call=1)
        dsup = dense[:b].contiguous()
        shape["bmm_bf16"] = cs.clocks(lambda: torch.bmm(dsup, x), args.reps)
        record["shapes"][f"F{f}"] = shape
        cs.log(f"K4 bf16 F={f} (B={b}, E={e}) on {card['smi']}: every width bit-identical "
               "and within one ulp of plain; device us "
               + ", ".join(f"V={v} {shape[f'v{v}']['device_ms'] * 1e3:.2f}" for v in widths)
               + f"; fp32 K4 {shape['fp32_k4']['device_ms'] * 1e3:.2f}, torch.bmm bf16 "
               f"{shape['bmm_bf16']['device_ms'] * 1e3:.2f}")
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
