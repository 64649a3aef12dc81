"""Committed baseline of grandfathered findings.

The gate is ratcheting: everything the analyzer found when a rule
landed is recorded here (key -> count, line-free so unrelated edits
don't churn it), and only NEW findings fail tier-1. Shrinking the
baseline is always legal; growing it requires a deliberate
``python -m ceph_tpu_torch.tools.tpulint --update-baseline`` in the
diff, which a reviewer sees.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/baseline.py``.
Changed: the regeneration command in this text and in the saved
file's comment is the port's CLI, ``python -m
ceph_tpu_torch.tools.tpulint``.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterable

from .core import Finding

_VERSION = 1


def load_baseline(path: str | Path) -> Counter:
    p = Path(path)
    if not p.exists():
        return Counter()
    data = json.loads(p.read_text(encoding="utf-8"))
    if data.get("version") != _VERSION:
        raise ValueError(
            f"baseline {p} has version {data.get('version')!r}, "
            f"want {_VERSION}")
    return Counter({str(k): int(v)
                    for k, v in data.get("findings", {}).items()})


def save_baseline(path: str | Path,
                  findings: Iterable[Finding]) -> None:
    counts = Counter(f.key for f in findings)
    body = {
        "version": _VERSION,
        "comment": ("grandfathered tpulint findings; regenerate with "
                    "`python -m ceph_tpu_torch.tools.tpulint "
                    "--update-baseline`"),
        "findings": {k: counts[k] for k in sorted(counts)},
    }
    Path(path).write_text(json.dumps(body, indent=1) + "\n",
                          encoding="utf-8")


def unbaselined(findings: Iterable[Finding],
                baseline: Counter) -> list[Finding]:
    """Findings not covered by the baseline. Per key, the first
    ``baseline[key]`` occurrences are grandfathered; extras (the same
    hazard introduced again) fail."""
    budget = Counter(baseline)
    out: list[Finding] = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
        else:
            out.append(f)
    return out
