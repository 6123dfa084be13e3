"""Scenario-matrix entry point.

Port of `multihop_offload_tpu/cli/scenarios.py` (`mho-scenarios`):

    python -m multihop_offload_tpu_torch.cli.scenarios     # the preset table
    python -m multihop_offload_tpu_torch.cli.scenarios --matrix
        # every preset through the analytic evaluator AND FleetSim in one
        # process, on the card (14 presets, 4 lanes, 4 segments x 2 rounds
        # x 300 slots)
    python -m multihop_offload_tpu_torch.cli.scenarios --matrix --smoke \\
        --device cpu
        # the drill on the smoke subset, asserting conservation, both
        # paths, new-family coverage and drift detection

Shapes come from the `scenario_*` settings; `--scenario_names=a,b`
restricts a full run to named presets.  The record is written only where
`--scenario_out` names a file.  It runs on CUDA unless `--device cpu` is
given, and raises when CUDA is absent.
"""

from __future__ import annotations

import json

from multihop_offload_tpu_torch.config import Config, build_parser


def list_presets() -> dict:
    """The registry as a JSON-ready table (the default CLI surface)."""
    from multihop_offload_tpu_torch.scenarios import presets as presets_mod
    from multihop_offload_tpu_torch.scenarios.matrix import _traffic_axes
    from multihop_offload_tpu_torch.scenarios.spec import spec_hash

    rows = []
    for name in presets_mod.preset_names():
        s = presets_mod.preset(name)
        rows.append({
            "name": name,
            "hash": spec_hash(s),
            "family": s.family,
            "n_nodes": s.n_nodes,
            "util": s.util,
            "traffic": _traffic_axes(s.traffic),
            "mu_spread": s.mu_spread,
            "failures": len(s.failures),
            "mobility": s.mobility is not None,
            "objective": not s.objective.is_null,
        })
    return {"presets": rows,
            "new_families": list(presets_mod.NEW_FAMILIES)}


def main(argv=None) -> int:
    from multihop_offload_tpu_torch import obs
    from multihop_offload_tpu_torch._device import resolve_device

    p = build_parser(description=__doc__)
    p.add_argument("--matrix", action="store_true",
                   help="run every preset through both evaluators")
    p.add_argument("--smoke", action="store_true",
                   help="with --matrix: the drill on the smoke subset, asserting "
                        "conservation, both evaluation paths, new-family coverage "
                        "and drift detection")
    p.add_argument("--list", action="store_true",
                   help="print the preset registry (the default)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    matrix, smoke, device = ns.pop("matrix"), ns.pop("smoke"), ns.pop("device")
    ns.pop("list")
    cfg = Config(**ns)

    if not matrix:
        print(json.dumps(list_presets(), indent=2))
        return 0

    from multihop_offload_tpu_torch.cli.loop import write_record
    from multihop_offload_tpu_torch.scenarios.matrix import run_matrix

    dev = resolve_device(device)  # no CPU fallback: raises when CUDA is absent
    runlog = obs.start_run(cfg, role="scenarios")
    try:
        record = run_matrix(cfg, smoke, device=dev)
    finally:
        obs.finish_run(runlog)
    if cfg.scenario_out:
        write_record(record, cfg.scenario_out)
        print(f"scenario matrix record written to {cfg.scenario_out}")
    summary = {
        "scenarios": len(record["scenarios"]),
        "families": record["families"],
        "conservation_ok_all": record["conservation_ok_all"],
        "unexpected_retraces": record["unexpected_retraces"],
        "wall_s": {r["name"]: round(r["wall_s"], 3) for r in record["scenarios"]},
    }
    if smoke:
        summary["checks"] = record["checks"]
        summary["ok"] = record["ok"]
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
