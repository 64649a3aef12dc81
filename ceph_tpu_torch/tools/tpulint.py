#!/usr/bin/env python
"""tpulint CLI: run the ceph_tpu_torch.analysis rules over the port.

Usage:
    python -m ceph_tpu_torch.tools.tpulint [paths...]   # lint (default:
                                                        #  ceph_tpu_torch)
    python -m ceph_tpu_torch.tools.tpulint --update-baseline
                                                # grandfather current
                                                #  findings
    python -m ceph_tpu_torch.tools.tpulint --list-rules
    python -m ceph_tpu_torch.tools.tpulint --json

Exit codes: 0 clean (or fully baselined), 1 non-baselined findings,
2 usage error. The tier-1 gate (tests/test_torch_tpulint.py) runs the
same analysis in-process, so CI and this CLI can never disagree.

ceph_tpu_torch's own copy of ``tools/tpulint.py``. Changed: it lints
``ceph_tpu_torch`` by default against its own baseline,
``ceph_tpu_torch/tools/tpulint_baseline.json``, with the port's
analyzer; paths are relative to the repository root.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .. import analysis

_REPO = Path(__file__).resolve().parents[2]

DEFAULT_PATHS = ("ceph_tpu_torch",)
DEFAULT_BASELINE = _REPO / "ceph_tpu_torch" / "tools" / "tpulint_baseline.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpulint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs to lint (default: ceph_tpu_torch)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baselined or not")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from a FULL run (any "
                         "--rules/path filters are ignored so a "
                         "partial run can never erase other entries)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    analysis.preload()
    if args.list_rules:
        for name in analysis.instance().names():
            print(name)
        return 0

    if args.update_baseline:
        # ALWAYS a full run: honoring --rules/path filters here would
        # rewrite the baseline from a subset and silently erase every
        # other grandfathered entry
        full = analysis.run_paths(DEFAULT_PATHS, _REPO)
        analysis.save_baseline(args.baseline, full)
        print(f"baseline updated: {len(full)} finding(s) -> "
              f"{args.baseline}")
        return 0

    only = args.rules.split(",") if args.rules else None
    findings = analysis.run_paths(args.paths, _REPO, only)

    if args.no_baseline:
        new = findings
    else:
        new = analysis.unbaselined(
            findings, analysis.load_baseline(args.baseline))

    if args.as_json:
        print(json.dumps([f.__dict__ for f in new], indent=1))
    else:
        for f in new:
            print(f.render())
        n_base = len(findings) - len(new)
        print(f"tpulint: {len(new)} finding(s)"
              + (f" ({n_base} baselined)" if n_base else ""),
              file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
