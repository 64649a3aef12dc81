"""Structured logging: per-subsystem levels + crash ring buffer
(the src/common/dout.h + src/log/Log.cc role).

``dout(subsys, level)`` gating is two dict lookups; every emitted entry
also lands in a bounded ring buffer so a crash can dump the recent
history even when the live level filtered it from the stream — the
reference's "gather at high level, print at low level" design: the ring
keeps entries up to `gather_level`, the stream prints up to `level`.

ceph_tpu_torch's own copy of ``ceph_tpu/utils/log.py``.
"""
from __future__ import annotations

import collections
import sys
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class Entry:
    stamp: float
    subsys: str
    level: int
    message: str

    def format(self) -> str:
        lt = time.localtime(self.stamp)
        return (f"{time.strftime('%Y-%m-%dT%H:%M:%S', lt)}"
                f".{int(self.stamp % 1 * 1000):03d} {self.level} "
                f"{self.subsys}: {self.message}")


class Log:
    def __init__(self, default_level: int = 1, gather_level: int = 10,
                 ring_size: int = 10000, stream=None):
        self.default_level = default_level
        self.gather_level = gather_level
        self.levels: dict[str, int] = {}
        self.ring: collections.deque[Entry] = collections.deque(
            maxlen=ring_size
        )
        self.stream = stream if stream is not None else sys.stderr
        self._lock = threading.Lock()

    def set_level(self, subsys: str, level: int) -> None:
        self.levels[subsys] = level

    def level_of(self, subsys: str) -> int:
        return self.levels.get(subsys, self.default_level)

    def should(self, subsys: str, level: int) -> bool:
        return level <= max(self.level_of(subsys), self.gather_level)

    def dout(self, subsys: str, level: int, message: str) -> None:
        if level > self.gather_level and level > self.level_of(subsys):
            return
        e = Entry(time.time(), subsys, level, message)
        with self._lock:
            self.ring.append(e)
        if level <= self.level_of(subsys):
            print(e.format(), file=self.stream)

    def dump_recent(self, limit: int | None = None) -> list[str]:
        """Crash-dump role: the gathered history, newest last."""
        with self._lock:
            entries = list(self.ring)
        if limit is not None:
            entries = entries[-limit:]
        return [e.format() for e in entries]


#: process-wide default logger (daemons may carry their own)
root = Log()


def dout(subsys: str, level: int, message: str) -> None:
    root.dout(subsys, level, message)
