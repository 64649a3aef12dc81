"""Time the CRUSH rule kernel (csrc/crush_rule.cu) alone at the shapes of
``chip_smoke.py`` phase ``placement``, so that two checkouts' kernels can
be compared on one card in one call:

    python3 ceph_tpu_torch/tools/rule_probe.py [--root DIR] [--tag NAME]
                                               [--group G]

``--root`` imports ``ceph_tpu_torch`` from another checkout (default: the
one holding this file; an earlier one whose ``bulk.rule_rows`` still
takes the arrays and the depth is driven through that form). Run the two
in turns (A, B, B, A). ``--group`` sets the lanes an input takes in
place of ``bulk.group_width``'s choice (a checkout with lane groups). The
map is the placement phase's cluster: 50 hosts x 20 OSDs, 20 OSDs out and 20 at
half weight (drawn from this script's seed), the replicated rule (3) and
the EC 8+3 rule (11); 10 M, 65,536 and 64 inputs. Each shape prints one
JSON line: the median ms per call over CUDA-event-timed single launches,
the draws the kernel counted, a digest of the rows (equal across
checkouts when both are exact), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = (("full", 10_000_000), ("65536", 65_536), ("64", 64))
RULES = {"replicated": (0, 3), "ec_8_3": (1, 11)}
REPS = {"full": 5, "65536": 30, "64": 200}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--group", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.placement import bulk
    from ceph_tpu_torch.placement import crushmap as cm

    if not torch.cuda.is_available():
        raise SystemExit("rule_probe: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    kernels.CRUSH_RULE.load()
    rng = np.random.default_rng(20261020)
    tree = cm.build_hierarchy(osds_per_host=20, n_hosts=50)
    tree.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    tree.add_rule(cm.ec_rule(1, root=-1, failure_domain_type=1))
    rw = np.full(1000, 0x10000, dtype=np.uint32)
    picked = rng.choice(1000, 40, replace=False)
    rw[picked[:20]] = 0
    rw[picked[20:]] = 0x8000
    comp = bulk.CompiledMap(tree)
    arrays = comp.arrays_on(dev)
    old_form = "max_depth" in inspect.signature(bulk.rule_rows).parameters

    def t32(a):
        return torch.from_numpy(a.view(np.int32).copy()).to(dev)

    rw_t = t32(rw)
    xs = t32(rng.integers(0, 2**32, SHAPES[0][1], dtype=np.uint32))
    for name, (ruleno, numrep) in RULES.items():
        rule = comp.compile_rule(ruleno, numrep)

        def run(x, draws=None):
            if old_form:
                return bulk.rule_rows(arrays, rw_t, x, rule, numrep,
                                      comp.max_depth, draws)
            return bulk.rule_rows(comp, rw_t, x, rule, numrep, draws,
                                  args.group or None)

        for size, n in SHAPES:
            x = xs[:n]
            count = torch.zeros(1, dtype=torch.int64, device=dev)
            rows = run(x, count)
            torch.cuda.synchronize()
            digest = hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()
            del rows
            times = []
            for _ in range(REPS[size]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            group = args.group or (None if old_form else bulk.group_width(
                comp.widest(-1), n, bulk.card_lanes(dev)))
            print(json.dumps({"tag": args.tag, "group": group,
                              "rule": name, "inputs": n,
                              "ms": statistics.median(times),
                              "ms_min": min(times), "reps": len(times),
                              "draws": int(count.item()),
                              "rows_sha256": digest[:16],
                              "card": smi}), flush=True)


if __name__ == "__main__":
    main()
