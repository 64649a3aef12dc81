"""PerfCounters: per-daemon metrics registry (src/common/
perf_counters.h:63 role — u64 counters, gauges, time-averages with
sum+count, and power-of-two histograms), dumpable as plain dicts for
the admin socket's `perf dump` and the exporter.

Counters are plain python ints/floats guarded by one lock per group —
the data path batches device work, so counter traffic is per-batch,
not per-byte.

ceph_tpu_torch's own copy of ``ceph_tpu/utils/perf.py``.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

TYPE_U64 = "u64"          # monotonically increasing counter
TYPE_GAUGE = "gauge"      # settable level
TYPE_TIME_AVG = "timeavg"  # (total_seconds, count) pair
TYPE_HISTOGRAM = "hist"   # log2 buckets of observed values


@dataclass
class _Counter:
    type: str
    desc: str
    value: float = 0
    count: int = 0
    buckets: dict[int, int] = field(default_factory=dict)


class PerfCounters:
    """One named group of counters (e.g. "osd.3")."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, _Counter] = {}

    # ------------------------------------------------------ declaration

    def add_u64_counter(self, key: str, desc: str = "") -> None:
        self._add(key, TYPE_U64, desc)

    def add_gauge(self, key: str, desc: str = "") -> None:
        self._add(key, TYPE_GAUGE, desc)

    def add_time_avg(self, key: str, desc: str = "") -> None:
        self._add(key, TYPE_TIME_AVG, desc)

    def add_histogram(self, key: str, desc: str = "") -> None:
        self._add(key, TYPE_HISTOGRAM, desc)

    def _add(self, key: str, ctype: str, desc: str) -> None:
        with self._lock:
            if key in self._counters:
                raise KeyError(f"counter {key!r} already declared")
            self._counters[key] = _Counter(ctype, desc)

    # --------------------------------------------------------- mutation

    def inc(self, key: str, by: int = 1) -> None:
        with self._lock:
            c = self._counters[key]
            c.value += by

    def set(self, key: str, value: float) -> None:
        with self._lock:
            self._counters[key].value = value

    def tinc(self, key: str, seconds: float) -> None:
        """Add one timed sample (the tinc/avg pattern)."""
        with self._lock:
            c = self._counters[key]
            c.value += seconds
            c.count += 1

    def observe(self, key: str, value: float) -> None:
        bucket = 0 if value < 1 else int(math.log2(value)) + 1
        with self._lock:
            c = self._counters[key]
            c.buckets[bucket] = c.buckets.get(bucket, 0) + 1
            c.value += value
            c.count += 1

    class _Timer:
        def __init__(self, pc: "PerfCounters", key: str):
            self.pc, self.key = pc, key

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.pc.tinc(self.key, time.perf_counter() - self.t0)

    def time(self, key: str) -> "_Timer":
        """with pc.time("op_latency"): ... — scoped tinc."""
        return self._Timer(self, key)

    # ------------------------------------------------------------- dump

    def dump(self) -> dict:
        """`perf dump` shape: {key: value | {avgcount, sum} | hist}."""
        out: dict = {}
        with self._lock:
            for key, c in self._counters.items():
                if c.type in (TYPE_U64, TYPE_GAUGE):
                    out[key] = c.value
                elif c.type == TYPE_TIME_AVG:
                    out[key] = {"avgcount": c.count, "sum": c.value}
                else:
                    out[key] = {
                        "count": c.count,
                        "sum": c.value,
                        "buckets": {
                            f"<2^{b}": n for b, n in sorted(c.buckets.items())
                        },
                    }
        return out


class PerfCountersCollection:
    """Per-process registry of counter groups (the CephContext
    PerfCountersCollection role); the admin socket dumps it whole."""

    def __init__(self) -> None:
        self._groups: dict[str, PerfCounters] = {}
        self._lock = threading.Lock()

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            if name in self._groups:
                raise KeyError(f"perf group {name!r} exists")
            pc = PerfCounters(name)
            self._groups[name] = pc
            return pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)

    def dump(self) -> dict:
        with self._lock:
            groups = dict(self._groups)
        return {name: pc.dump() for name, pc in sorted(groups.items())}
