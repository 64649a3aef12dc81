"""AsyncReserver: bounded-concurrency slot reservations with priorities
(src/common/AsyncReserver.h role).

Recovery/backfill must not stampede: a map flip that remaps many PGs
would otherwise start every recovery at once and starve client IO. Each
OSD holds one LOCAL reserver (its own recovery work as primary) and one
REMOTE reserver (inbound backfill pushes it serves as a target); a
recovery runs only while holding a slot in both, mirroring the
reference's local_reserver/remote_reserver pair bounded by
osd_max_backfills.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/reserver.py``.
"""
from __future__ import annotations

import asyncio
import heapq
import itertools
from typing import Hashable


class AsyncReserver:
    def __init__(self, max_allowed: int):
        self.max_allowed = max_allowed
        self._granted: set[Hashable] = set()
        #: min-heap of (-priority, seq, key, future) — higher priority
        #: first, FIFO within a priority
        self._queue: list = []
        self._seq = itertools.count()
        self._waiting: dict[Hashable, asyncio.Future] = {}

    def set_max(self, n: int) -> None:
        self.max_allowed = n
        self._do_queues()

    @property
    def in_use(self) -> int:
        return len(self._granted)

    def _do_queues(self) -> None:
        while self._queue and len(self._granted) < self.max_allowed:
            _, _, key, fut = heapq.heappop(self._queue)
            if fut.cancelled() or key not in self._waiting:
                continue  # cancelled while queued
            self._waiting.pop(key, None)
            self._granted.add(key)
            if not fut.done():
                fut.set_result(None)

    async def request(self, key: Hashable, priority: int = 0) -> None:
        """Wait for a slot. Re-requesting a granted/queued key is a
        no-op wait on the original grant (idempotent, like the
        reference's request_reservation)."""
        if key in self._granted:
            return
        fut = self._waiting.get(key)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._waiting[key] = fut
            heapq.heappush(self._queue,
                           (-priority, next(self._seq), key, fut))
            self._do_queues()
        await fut

    def release(self, key: Hashable) -> None:
        """Release a held (or cancel a queued) reservation."""
        if key in self._granted:
            self._granted.discard(key)
        else:
            fut = self._waiting.pop(key, None)
            if fut is not None and not fut.done():
                fut.cancel()
        self._do_queues()

    def held(self, key: Hashable) -> bool:
        return key in self._granted
