"""Profile the placement kernels alone, in a fresh process, on the card.

    python3 -m ceph_tpu_torch.tools.profile_probe

Builds the kernels, then traces straw2.cu (65,536 inputs over a
1,000-item bucket) and crush_rule.cu (the replicated rule, chooseleaf
firstn host, 3, on a 50 x 20-OSD tree with every OSD in, 65,536 inputs)
under torch.profiler and prints, per trace, how many kernel launches the
host made and how many device records the trace holds, with the mean
device ms of those records. Then it times 20 back-to-back launches of
each with CUDA events (the ms per launch when the card never waits for
the host). One JSON line per measurement. ``chip_smoke.py`` runs the same
kernels late in a long process, where the profiler has dropped records:
this shows what a young process records.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import kernels
from ..ops import crush
from ..placement import bulk
from ..placement import crushmap as cm

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def trace(step, reps: int, **kwargs) -> dict:
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kwargs) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    records = [e for e in prof.events() if e.device_type == cuda]
    return {"reps": reps, "launches": sum(e.name in LAUNCH_CALLS
                                          for e in prof.events()),
            "records": len(records),
            "mean_device_ms": (sum(e.time_range.end - e.time_range.start
                                   for e in records) / len(records) / 1e3
                               if records else None)}


def back_to_back_ms(step, n: int = 20) -> float:
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    print(json.dumps({"build_s": kernels.build_all()}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                .copy()).to(dev)

    items = t32(np.arange(1000, dtype=np.int32))
    weights = t32(rng.integers(1, 4 * 0x10000, 1000, dtype=np.uint32))
    xs = t32(rng.integers(0, 2**32, 65536, dtype=np.uint32))
    tree = cm.build_hierarchy(osds_per_host=20, n_hosts=50)
    tree.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    comp = bulk.CompiledMap(tree)
    rule = comp.compile_rule(0, 3)
    reweights = t32(np.full(1000, 0x10000, np.uint32))
    steps = {
        "straw2": lambda: crush.straw2_choose(items, items, weights, xs, 0),
        "crush_rule": lambda: bulk.rule_rows(comp, reweights, xs, rule, 3),
    }
    for name, step in steps.items():
        for reps in (3, 10):
            print(json.dumps({"kernel": name, **trace(step, reps)}),
                  flush=True)
        print(json.dumps({"kernel": name, "acc_events": True,
                          **trace(step, 3, acc_events=True)}), flush=True)
    for name, step in steps.items():
        print(json.dumps({"kernel": name,
                          "back_to_back_ms": back_to_back_ms(step)}),
              flush=True)


if __name__ == "__main__":
    main()
