"""Chaos entry point (`mho-chaos`): the seeded fault-injection harness.

Port of `multihop_offload_tpu/cli/chaos.py`:

    python -m multihop_offload_tpu_torch.cli.chaos        # the named fault sites
    python -m multihop_offload_tpu_torch.cli.chaos --smoke [--device cpu]
        [--chaos_out F]   # the full drill matrix

The smoke run is the crash-safety proof: every drill of `chaos.drills`
injects one fault class and asserts the matching recovery -- journal
resume to the same terminal state and lineage, quarantine and last-good
fallback, reader continuation, watchdog degrade-then-recover, retry
absorption, re-placement after a device or host loss -- with the global
invariants: decisions never wrong (only honestly degraded) and request
conservation.  JAX's retrace invariant is reported as not applicable (a
compile property).  It runs on CUDA unless `--device cpu` is given; the
record is written only where `--chaos_out` names a file.
"""

from __future__ import annotations

import json

from multihop_offload_tpu_torch.config import Config, build_parser

# every named site the production code exposes to the fault planner, with
# the injection a drill performs there (JAX `:31-54`)
FAULT_SITES = (
    ("capture:mid", "crash", "kill between capture-window ticks"),
    ("refit:mid", "crash", "kill inside the re-fit training loop"),
    ("refit:pre_save", "crash", "kill before the candidate save"),
    ("refit:post_save", "crash", "kill after the candidate save"),
    ("promote:pre_save", "crash", "kill after 'promoting' journaled, "
                                  "before the champion save"),
    ("promote:post_save", "crash", "kill after the champion save, "
                                   "before hot-reload"),
    ("promote:post_reload", "crash", "kill after hot-reload, before "
                                     "'promoted' journaled"),
    ("monitor:mid", "crash", "kill between monitor-window ticks"),
    ("rollback:pre_save", "crash", "kill after 'rolling_back' journaled"),
    ("rollback:post_save", "crash", "kill after the rollback save"),
    ("ckpt:save", "transient I/O", "OSError out of the checkpoint save"),
    ("ckpt:restore", "transient I/O", "OSError out of the checkpoint restore"),
    ("journal:write", "transient I/O", "OSError writing the loop journal"),
    ("events:write", "transient I/O", "OSError writing the run log"),
    ("hot_reload", "transient I/O", "OSError during serve hot-reload"),
    ("ckpt:poison", "semantic", "checksum-valid NaN/Inf/scale weight "
                                "poison (faults.poison_checkpoint)"),
    ("request:fuzz", "semantic", "shape-compatible but invalid requests "
                                 "(faults.fuzz_request)"),
)


def render_sites() -> str:
    lines = ["named fault sites (chaos.faults crashpoint/io_gate):"]
    for site, kind, what in FAULT_SITES:
        lines.append(f"  {site:22s} {kind:14s} {what}")
    lines.append("  run the drill matrix with: python -m "
                 "multihop_offload_tpu_torch.cli.chaos --smoke")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.chaos.drills import run_smoke
    from multihop_offload_tpu_torch.cli.loop import write_record

    p = build_parser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="full chaos drill matrix: every fault class injected, every "
                        "recovery asserted; writes its record where --chaos_out names")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    smoke, device = ns.pop("smoke"), ns.pop("device")
    cfg = Config(**ns)
    if not smoke:
        print(render_sites(), end="")
        return 0
    out = run_smoke(cfg, device=resolve_device(device))
    if cfg.chaos_out:
        write_record(out, cfg.chaos_out)
        print(f"chaos smoke record written to {cfg.chaos_out}")
    print(json.dumps(out["checks"], indent=2))
    for d in out["drills"]:
        na = f" (not applicable: {', '.join(d['not_applicable'])})" if d["not_applicable"] else ""
        print(f"  [{'ok' if d['ok'] else 'FAIL'}] {d['name']}{na}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
