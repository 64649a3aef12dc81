"""Mergeable log-bucket latency histograms (the PerfHistogram role,
src/common/perf_histogram.h, shaped for cross-process merging).

Percentiles do not compose: averaging per-worker p99s is wrong the
moment there is more than one source of load (fast workers dilute a
slow worker's tail). Histograms DO compose — merging is a vector add
of bucket counts, and a percentile read off the merged histogram is
exact to bucket resolution no matter how many processes contributed.
That makes this the ONLY latency currency allowed over the fabric
results pipe (tools/swarm.py worker protocol): workers ship sparse
bucket dicts as JSON, never raw sample lists and never pickled
objects.

Buckets are geometric with 2% growth — ~1160 buckets span 1 µs to
10 s, so worst-case percentile error is 1% of the value itself
(half a bucket), far below run-to-run noise, while a full histogram
serializes in a few KiB.

ceph_tpu_torch's own copy of ``ceph_tpu/utils/lathist.py``.
"""
from __future__ import annotations

import math

#: geometric bucket growth; 1.02 ⇒ percentile error ≤ ~1% of value
GROWTH = 1.02
_LOG_G = math.log(GROWTH)
#: bucket 0 upper bound: 1 µs (in ms) — everything faster is bucket 0
_MS0 = 1e-3


class LatHist:
    """Sparse log-bucket histogram over latencies in milliseconds.

    ``merge`` is exact (bucket-count vector add); ``percentile`` uses
    the same nearest-rank rule the old sorted-list reporter used
    (``sorted[int(p*n)]``), so single-process reports are directly
    comparable across the refactor.
    """

    __slots__ = ("buckets", "count", "total_ms", "min_ms", "max_ms")

    def __init__(self) -> None:
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total_ms = 0.0
        self.min_ms = math.inf
        self.max_ms = 0.0

    # ------------------------------------------------------------ record

    @staticmethod
    def _idx(ms: float) -> int:
        if ms <= _MS0:
            return 0
        # +1: bucket i>0 covers (_MS0*G^(i-1), _MS0*G^i]
        return int(math.log(ms / _MS0) / _LOG_G) + 1

    def note_ms(self, ms: float) -> None:
        ms = max(0.0, float(ms))
        i = self._idx(ms)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.total_ms += ms
        if ms < self.min_ms:
            self.min_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms

    def note_s(self, seconds: float) -> None:
        self.note_ms(seconds * 1e3)

    # ------------------------------------------------------------- query

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile in ms (p in [0,1])."""
        if not self.count:
            return 0.0
        rank = min(self.count - 1, int(p * self.count))
        cum = 0
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum > rank:
                v = _MS0 * GROWTH ** i if i else _MS0
                # clamp to the observed envelope: the top bucket's
                # upper bound can overshoot the true max by 2%
                return min(max(v, self.min_ms), self.max_ms)
        return self.max_ms

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    # ------------------------------------------------------------- merge

    def merge(self, other: "LatHist") -> "LatHist":
        """Fold ``other`` into self (exact; order-independent)."""
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += other.count
        self.total_ms += other.total_ms
        if other.count:
            self.min_ms = min(self.min_ms, other.min_ms)
            self.max_ms = max(self.max_ms, other.max_ms)
        return self

    # -------------------------------------------------------------- wire

    def to_json(self) -> dict:
        """JSON-safe sparse dict (the results-pipe wire form)."""
        return {
            "b": {str(i): n for i, n in self.buckets.items()},
            "n": self.count,
            "sum_ms": round(self.total_ms, 6),
            "min_ms": (round(self.min_ms, 6)
                       if self.count else None),
            "max_ms": round(self.max_ms, 6),
        }

    @classmethod
    def from_json(cls, d: dict) -> "LatHist":
        h = cls()
        h.buckets = {int(i): int(n) for i, n in d.get("b", {}).items()}
        h.count = int(d.get("n", 0))
        h.total_ms = float(d.get("sum_ms", 0.0))
        h.min_ms = (float(d["min_ms"])
                    if d.get("min_ms") is not None else math.inf)
        h.max_ms = float(d.get("max_ms", 0.0))
        return h

    @classmethod
    def merged(cls, hists) -> "LatHist":
        out = cls()
        for h in hists:
            out.merge(h)
        return out
