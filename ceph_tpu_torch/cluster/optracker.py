"""OpTracker: in-flight + historic op timelines (the src/osd/
OpRequest.h / OpTracker role).

Every client op gets a TrackedOp carrying an event timeline
(queued -> dequeued -> started -> sub_ops_sent -> done, each with a
timestamp); completed ops roll into a bounded history ring. The admin
socket dumps both (`dump_ops_in_flight` / `dump_historic_ops`), and
slow ops (age > warn threshold) surface in health.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/optracker.py``.
"""
from __future__ import annotations

import collections
import itertools
import time


class TrackedOp:
    __slots__ = ("seq", "desc", "start", "events", "done_at")

    def __init__(self, seq: int, desc: str):
        self.seq = seq
        self.desc = desc
        self.start = time.time()
        self.events: list[tuple[float, str]] = [(self.start, "queued")]
        self.done_at: float | None = None

    def mark(self, event: str) -> None:
        self.events.append((time.time(), event))

    @property
    def age(self) -> float:
        return (self.done_at or time.time()) - self.start

    def dump(self) -> dict:
        return {
            "seq": self.seq,
            "description": self.desc,
            "age": round(self.age, 6),
            "duration": (round(self.done_at - self.start, 6)
                         if self.done_at else None),
            "events": [
                {"time": t, "event": e} for t, e in self.events
            ],
        }


class OpTracker:
    def __init__(self, history_size: int = 256,
                 slow_op_warn_secs: float = 5.0):
        self._seq = itertools.count(1)
        self.in_flight: dict[int, TrackedOp] = {}
        self.history: collections.deque[TrackedOp] = collections.deque(
            maxlen=history_size
        )
        self.slow_op_warn_secs = slow_op_warn_secs

    def create(self, desc: str) -> TrackedOp:
        op = TrackedOp(next(self._seq), desc)
        self.in_flight[op.seq] = op
        return op

    def finish(self, op: TrackedOp) -> None:
        op.done_at = time.time()
        op.mark("done")
        self.in_flight.pop(op.seq, None)
        self.history.append(op)

    # ------------------------------------------------------------- dumps

    def dump_ops_in_flight(self) -> dict:
        ops = sorted(self.in_flight.values(), key=lambda o: o.seq)
        return {"num_ops": len(ops), "ops": [o.dump() for o in ops]}

    def dump_historic_ops(self, limit: int = 20) -> dict:
        ops = list(self.history)[-limit:]
        return {"num_ops": len(ops), "ops": [o.dump() for o in ops]}

    def slow_ops(self) -> list[TrackedOp]:
        now = time.time()
        return [o for o in self.in_flight.values()
                if now - o.start > self.slow_op_warn_secs]
