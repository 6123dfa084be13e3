"""The port's static-analysis gate, `mho-lint`'s counterpart.

    python -m multihop_offload_tpu_torch.analysis.cli          # repo rules
        # (JX003, JX005, JX006, JX008, JX011, MP001, SL001, OB001) over
        # multihop_offload_tpu_torch/
    python -m multihop_offload_tpu_torch.analysis.cli --select pyflakes tests
    ... --json [paths...]         # machine-readable findings + counts
    ... --list-rules              # rule table (id, scope, waiver, doc)
    ... --baseline f.json         # suppress findings recorded in f.json
    ... --write-baseline f.json   # record current findings as accepted
    ... --report out.json         # per-rule finding/waiver counts only

Port of `multihop_offload_tpu/analysis/cli.py`: JAX's flags, exit codes
and JSON keys.  Exit status: 0 clean (or everything baselined), 1 live
findings, 2 usage error.  Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from multihop_offload_tpu_torch.analysis.engine import (
    PACKAGE_DIR,
    run_analysis,
    write_baseline,
)
from multihop_offload_tpu_torch.analysis.rules import all_rules, resolve_select


def _list_rules() -> str:
    rows = [("id", "sev", "waiver", "scope", "doc"), ("--", "---", "------",
                                                      "-----", "---")]
    for r in all_rules():
        rows.append((r.id, r.severity, r.waiver + "<why>)" if r.waiver
                     else "-", r.scope, r.doc))
    widths = [max(len(row[i]) for row in rows) for i in range(4)]
    return "\n".join(
        "  ".join(c.ljust(widths[i]) for i, c in enumerate(row[:4]))
        + "  " + row[4]
        for row in rows
    )


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="mho-lint",
        description="static analysis of the PyTorch port of multihop-offload-tpu",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/dirs to scan (default: {PACKAGE_DIR}/)")
    p.add_argument("--select", default=None,
                   help="rule ids (comma-separated) or a group: repo "
                        "(default), pyflakes, all")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings + per-rule counts as JSON")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="suppress findings recorded in FILE")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="record current findings into FILE and exit 0")
    p.add_argument("--report", default=None, metavar="FILE",
                   help="also write per-rule finding/waiver counts to FILE "
                        "(per-rule finding/waiver counts)")
    p.add_argument("--list-rules", action="store_true")
    try:
        args = p.parse_args(argv)
        if args.list_rules:
            print(_list_rules())
            return 0
        resolve_select(args.select)  # fail fast on unknown ids
    except ValueError as e:
        print(f"mho-lint: {e}", file=sys.stderr)
        return 2
    except SystemExit as e:  # argparse: -h exits 0, usage errors exit 2
        return e.code if isinstance(e.code, int) else 2

    roots = args.paths or [PACKAGE_DIR]
    report = run_analysis(roots, select=args.select, baseline=args.baseline)

    if args.write_baseline:
        write_baseline(args.write_baseline, report.findings)
        print(f"mho-lint: wrote {len(report.findings)} suppression(s) to "
              f"{args.write_baseline}")
        return 0

    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump({
                "tool": "mho-lint",
                "select": args.select or "repo",
                "roots": list(roots),
                "files_scanned": report.files_scanned,
                "rules": report.counts(),
            }, fh, indent=2, sort_keys=True)
            fh.write("\n")

    if args.as_json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        for f in report.findings:
            print(f.render())
        n, w = len(report.findings), len(report.waived)
        if n:
            print(f"mho-lint: {n} finding(s), {w} waived site(s), "
                  f"{report.files_scanned} file(s)", file=sys.stderr)
        elif report.suppressed:
            print(f"mho-lint: clean ({len(report.suppressed)} baselined, "
                  f"{w} waived, {report.files_scanned} files)")
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
