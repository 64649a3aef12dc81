"""CrushTester: placement simulation + distribution statistics (the
src/crush/CrushTester.cc role behind `crushtool --test`).

Runs a rule over a range of inputs (host oracle, or the bulk engine
``placement/bulk.py`` on the card when the map compiles) and reports
per-device utilization against weight expectation, bad mappings (short
results), and collision retries — the numbers `--show-utilization` /
`--show-bad-mappings` print."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .crushmap import CrushMap


@dataclass
class TestReport:
    rule: int
    num_rep: int
    total: int
    device_counts: dict[int, int]
    bad_mappings: list[int] = field(default_factory=list)

    @property
    def placed(self) -> int:
        return sum(self.device_counts.values())

    def utilization(self) -> dict[int, float]:
        if not self.placed:
            return {d: 0.0 for d in self.device_counts}
        return {
            d: c / self.placed for d, c in sorted(self.device_counts.items())
        }

    def expected_utilization(self, m: CrushMap) -> dict[int, float]:
        """Weight-proportional expectation over in-map devices."""
        w: dict[int, float] = {}

        def walk(bid: int, scale: float) -> None:
            b = m.buckets[bid]
            total = b.weight() or 1
            for item, wgt in zip(b.items, b.weights):
                frac = scale * wgt / total
                if item >= 0:
                    w[item] = w.get(item, 0.0) + frac
                else:
                    walk(item, frac)

        roots = [bid for bid in m.buckets
                 if not any(bid in b.items for b in m.buckets.values())]
        for r in roots:
            walk(r, 1.0 / len(roots))
        total = sum(w.values()) or 1.0
        return {d: v / total for d, v in sorted(w.items())}

    def max_deviation(self, m: CrushMap) -> float:
        """Largest |actual - expected| utilization across devices."""
        exp = self.expected_utilization(m)
        act = self.utilization()
        return max(
            (abs(act.get(d, 0.0) - e) for d, e in exp.items()),
            default=0.0,
        )


def test_rule(
    m: CrushMap,
    rule: int,
    num_rep: int,
    n_inputs: int = 1024,
    weights: np.ndarray | None = None,
    device=False,
) -> TestReport:
    """crushtool --test --rule <r> --num-rep <n> --max-x <n_inputs>.

    ``device`` False runs the host oracle per input; True runs the bulk
    engine on the CUDA card (kernel ``crush_rule.cu``); a device name or
    ``torch.device`` runs the bulk engine there (``"cpu"``: its plain
    version). The device rows are counted with numpy, to an equal
    report (its counts in device order)."""
    counts: dict[int, int] = {}
    bad: list[int] = []
    if device is not False:
        from .bulk import CompiledMap, do_rule_bulk

        out = np.asarray(do_rule_bulk(
            CompiledMap(m), rule, np.arange(n_inputs, dtype=np.uint32),
            num_rep, weights=weights,
            device=None if device is True else device,
        )).astype(np.int64)
        valid = (out >= 0) & (out < m.max_devices)
        bad = np.flatnonzero(valid.sum(axis=1) < num_rep).tolist()
        placed = np.bincount(out[valid], minlength=m.max_devices)
        counts = {int(d): int(placed[d]) for d in np.flatnonzero(placed)}
    else:
        for x in range(n_inputs):
            row = m.do_rule(rule, x, num_rep, weights=weights)
            placed = [d for d in row if 0 <= d < m.max_devices]
            if len(placed) < num_rep:
                bad.append(x)
            for d in placed:
                counts[d] = counts.get(d, 0) + 1
    return TestReport(rule, num_rep, n_inputs, counts, bad)
