"""QoS op scheduling + throttles (the src/osd/scheduler/
mClockScheduler.h:93 + src/common/Throttle roles).

MClockScheduler implements the dmClock tag algebra over service
classes (client / recovery / scrub / best_effort): each class has a
reservation R (ops/s it is guaranteed), a weight W (share of spare
capacity), and a limit L (ops/s cap, 0 = none). Every enqueued item is
stamped with reservation/proportional/limit tags advancing by 1/R,
1/W, 1/L from the class's previous tags (clamped to now after idle);
dequeue serves reservation-eligible items first (smallest R-tag with
tag <= now), then spare capacity by proportional tag among classes
under their limit — exactly the two-phase policy the reference's
dmclock library applies between client IO and background work.

Throttle is the byte-budget gate (Throttle.cc role): async acquire
blocks while the budget is exhausted; an oversized request is admitted
alone when the throttle is empty rather than deadlocking.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/scheduler.py``.
"""
from __future__ import annotations

import asyncio
import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Callable

CLIENT = "client"
RECOVERY = "recovery"
SCRUB = "scrub"
BEST_EFFORT = "best_effort"

#: (reservation ops/s, weight, limit ops/s; 0 = unlimited) — the shape
#: of osd_mclock_profile "balanced" scaled to the lite daemon
DEFAULT_CLASSES: dict[str, tuple[float, float, float]] = {
    CLIENT: (100.0, 2.0, 0.0),
    RECOVERY: (20.0, 1.0, 200.0),
    SCRUB: (10.0, 0.5, 100.0),
    BEST_EFFORT: (0.0, 0.2, 0.0),
}


@dataclass
class _ClassState:
    reservation: float
    weight: float
    limit: float
    r_tag: float = 0.0
    p_tag: float = 0.0
    l_tag: float = 0.0
    queue: list = field(default_factory=list)  # heap of (seq, item)


@dataclass(order=True)
class _Item:
    r_tag: float
    p_tag: float
    l_tag: float
    seq: int
    payload: Any = field(compare=False)
    klass: str = field(compare=False, default=CLIENT)


class MClockScheduler:
    def __init__(self, classes: dict | None = None,
                 clock: Callable[[], float] = time.monotonic):
        spec = classes or DEFAULT_CLASSES
        self._classes = {
            name: _ClassState(*params) for name, params in spec.items()
        }
        self._clock = clock
        self._seq = 0
        self._event = asyncio.Event()

    def __len__(self) -> int:
        return sum(len(c.queue) for c in self._classes.values())

    def add_class(self, name: str, reservation: float, weight: float,
                  limit: float = 0.0) -> None:
        """Install (or retune) a service class at runtime — the
        per-tenant QoS seam: a latency tenant gets a reservation the
        dequeue loop honors FIRST, a bulk tenant gets weight-only
        spare capacity, regardless of queue depth. Retuning keeps the
        queued items and their tags; only future tags move."""
        prev = self._classes.get(name)
        state = _ClassState(float(reservation), float(weight),
                            float(limit))
        if prev is not None:
            state.queue = prev.queue
            state.r_tag, state.p_tag, state.l_tag = (
                prev.r_tag, prev.p_tag, prev.l_tag)
        self._classes[name] = state

    # ---------------------------------------------------------- enqueue

    def enqueue(self, klass: str, payload: Any) -> None:
        c = self._classes[klass]
        now = self._clock()
        self._seq += 1
        # dmClock tag update: advance from the previous tag, clamp to
        # now after idle so a silent class doesn't bank history
        c.r_tag = (max(c.r_tag + 1.0 / c.reservation, now)
                   if c.reservation > 0 else float("inf"))
        c.p_tag = max(c.p_tag + 1.0 / c.weight, now)
        c.l_tag = (max(c.l_tag + 1.0 / c.limit, now)
                   if c.limit > 0 else 0.0)
        heapq.heappush(
            c.queue,
            _Item(c.r_tag, c.p_tag, c.l_tag, self._seq, payload, klass),
        )
        self._event.set()

    # ---------------------------------------------------------- dequeue

    def dequeue(self) -> Any | None:
        """One scheduling decision; None when nothing is eligible (an
        item may still be waiting on its limit tag)."""
        now = self._clock()
        # phase 1: reservations due
        best = None
        for c in self._classes.values():
            if c.queue and c.queue[0].r_tag <= now:
                if best is None or c.queue[0].r_tag < best.queue[0].r_tag:
                    best = c
        if best is not None:
            return heapq.heappop(best.queue).payload
        # phase 2: proportional among classes under limit
        best = None
        for c in self._classes.values():
            if c.queue and c.queue[0].l_tag <= now:
                if best is None or c.queue[0].p_tag < best.queue[0].p_tag:
                    best = c
        if best is not None:
            return heapq.heappop(best.queue).payload
        return None

    def next_eligible_in(self) -> float | None:
        """Seconds until some head item becomes eligible (None = empty)."""
        now = self._clock()
        waits = []
        for c in self._classes.values():
            if c.queue:
                head = c.queue[0]
                waits.append(max(0.0, min(
                    head.r_tag - now if head.r_tag != float("inf")
                    else head.l_tag - now,
                    head.l_tag - now,
                )))
        return min(waits) if waits else None

    async def get(self) -> Any:
        """Async dequeue: waits for eligibility (the ShardedOpWQ
        worker-loop role)."""
        while True:
            item = self.dequeue()
            if item is not None:
                return item
            wait = self.next_eligible_in()
            if wait is None:
                self._event.clear()
                await self._event.wait()
            else:
                await asyncio.sleep(min(wait, 0.05) if wait > 0 else 0)


class Throttle:
    """Async byte/count budget (src/common/Throttle.cc role)."""

    def __init__(self, maximum: int):
        self.max = maximum
        self.current = 0
        self._waiters: list[tuple[int, asyncio.Future]] = []

    async def acquire(self, count: int = 1) -> None:
        if self.max <= 0:
            return
        while not self._admissible(count):
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append((count, fut))
            await fut
        self.current += count

    def _admissible(self, count: int) -> bool:
        if self.current + count <= self.max:
            return True
        # oversized requests go through alone (reference behavior:
        # a request larger than max must not deadlock)
        return count > self.max and self.current == 0

    def release(self, count: int = 1) -> None:
        if self.max <= 0:
            return
        self.current = max(0, self.current - count)
        still = []
        for count_w, fut in self._waiters:
            if not fut.done():
                if self._admissible(count_w):
                    fut.set_result(None)
                else:
                    still.append((count_w, fut))
        self._waiters = still

    def past_midpoint(self) -> bool:
        return self.max > 0 and self.current * 2 >= self.max
