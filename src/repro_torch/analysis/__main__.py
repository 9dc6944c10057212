"""CLI of the port's contract checks.

    python -m repro_torch.analysis --device cpu            # on the CPU
    python -m repro_torch.analysis                         # on the card
    python -m repro_torch.analysis --device cpu --json report.json

The checks run at the reference's smoke sizes (``trace_check.SMOKE``);
another size is a ``trace_check.TraceSize`` passed to ``run_trace_checks``.

Exit codes: 0 clean, 1 findings, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import findings as findings_lib
from repro_torch.analysis import trace_check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--device", default="cuda",
                    help="device the checks run on (default cuda)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the full report to this path")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    def note(msg):
        if not args.quiet:
            print(f"[analysis] {msg}", file=sys.stderr)

    size = trace_check.TraceSize(device=args.device)
    found, reports = trace_check.run_trace_checks(log=note, size=size)
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(findings_lib.report_dict(found, reports), fh, indent=2)
            fh.write("\n")
        note(f"report written to {args.json_out}")
    for f in sorted(found):
        print(f.format())
    note(f"{len(found)} finding(s) over {len(reports)} entry runs")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
