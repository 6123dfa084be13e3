"""Fuzz entry point (`mho-fuzz`): the seeded input-fuzzing harness.

Port of `multihop_offload_tpu/cli/fuzz.py`:

    python -m multihop_offload_tpu_torch.cli.fuzz          # the mutation catalogue
    python -m multihop_offload_tpu_torch.cli.fuzz --smoke [--device cpu]
        [--fuzz_out F]   # the full fuzz matrix

The smoke run is the guardrail proof: every mutation family of
`chaos.faults.REQUEST_MUTATIONS` thrown at the serving front door over
several seeds is refused with exactly the typed reason it predicts, valid
traffic interleaved with the garbage keeps bit-identical decisions, every
admitted request is conserved, a checksum-valid NaN-poisoned checkpoint is
refused at hot reload while a byte-corrupt one is quarantined.  It runs on
CUDA unless `--device cpu` is given; the record is written only where
`--fuzz_out` names a file (JAX's default is a file of its benchmark
folder).
"""

from __future__ import annotations

import json

from multihop_offload_tpu_torch.config import Config, build_parser


def render_catalogue() -> str:
    from multihop_offload_tpu_torch.chaos.faults import POISON_MODES, REQUEST_MUTATIONS
    from multihop_offload_tpu_torch.serve.guards import REASONS

    lines = ["request mutation catalogue (chaos.faults.fuzz_request):"]
    for mutation, reason in REQUEST_MUTATIONS:
        lines.append(f"  {mutation:14s} -> rejected_invalid{{reason={reason}}}")
    lines.append("weight poison modes (chaos.faults.poison_checkpoint): "
                 + ", ".join(POISON_MODES))
    lines.append("admission rejection reasons (serve.guards): " + ", ".join(REASONS))
    lines.append("  run the fuzz matrix with: python -m "
                 "multihop_offload_tpu_torch.cli.fuzz --smoke")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.chaos.fuzz import run_smoke
    from multihop_offload_tpu_torch.cli.loop import write_record

    p = build_parser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="full fuzz matrix: every request mutation refused with its "
                        "typed reason, valid traffic bit-identical, weight poison "
                        "refused; writes its record where --fuzz_out names")
    p.add_argument("--fuzz_out", default="", help="record path for --smoke (\"\" = none)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    smoke, out_path, device = ns.pop("smoke"), ns.pop("fuzz_out"), ns.pop("device")
    cfg = Config(**ns)
    if not smoke:
        print(render_catalogue(), end="")
        return 0
    out = run_smoke(cfg, device=resolve_device(device))
    if out_path:
        write_record(out, out_path)
        print(f"fuzz smoke record written to {out_path}")
    print(json.dumps(out["checks"], indent=2))
    for leg in out["legs"]:
        print(f"  [{'ok' if leg['ok'] else 'FAIL'}] {leg['name']}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
