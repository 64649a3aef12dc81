"""FaultInjector: named failure sites armed by tests/config (the
src/common/fault_injector.h:66 role, plus the config-driven error
injection style of bluestore_debug_inject_read_err /
ms_inject_socket_failures in src/common/options/global.yaml.in).

A site is armed with an optional match filter, a trigger budget, and an
optional probability (seeded RNG for deterministic schedules — the
teuthology thrasher stance: same seed, same faults); production code
calls ``hit(site, **attrs)`` at the failure point and raises/returns-
error when it fires. Disarmed sites cost one dict lookup.

``on_fire`` lets the owning daemon turn every injection into a perf
counter (``faults_injected_<site>``) without the call sites knowing
about metrics. ``pause`` is the async delay hook: an arm carrying a
``delay`` stalls the caller — NEVER await it while holding a PG lock
(the JAX package's lint enforces exactly that there).

ceph_tpu_torch's own copy of ``ceph_tpu/utils/fault.py``.
"""
from __future__ import annotations

import asyncio
import random
import threading
from dataclasses import dataclass, field
from typing import Callable


class InjectedError(RuntimeError):
    """An error raised on behalf of an armed fault site — lets handlers
    tell injected failures from organic ones (counter splits)."""


@dataclass
class _Arm:
    remaining: int  # triggers left; <0 = unlimited
    match: dict = field(default_factory=dict)
    fired: int = 0
    p: float = 1.0  # firing probability per eligible hit
    rng: random.Random | None = None
    delay: float = 0.0  # seconds pause() sleeps when this arm fires
    #: (mu, sigma) of a lognormal delay drawn per fire from ``rng``
    #: (the slow-OSD service-time inflation arm: deterministic under a
    #: seeded rng, heavy-tailed like real storage stragglers); takes
    #: precedence over the fixed ``delay``
    delay_log: tuple | None = None


class FaultInjector:
    def __init__(self) -> None:
        self._arms: dict[str, list[_Arm]] = {}
        self._lock = threading.Lock()
        #: called with the site name each time an injection fires —
        #: the OSD points this at its perf counters
        self.on_fire: Callable[[str], None] | None = None

    def arm(self, site: str, count: int = -1, p: float = 1.0,
            rng: random.Random | None = None, delay: float = 0.0,
            delay_log: tuple | None = None, **match) -> None:
        """Arm `site` to fire `count` times (-1 = forever) when every
        key in `match` equals the corresponding hit() attribute; with
        ``p`` < 1 each eligible hit fires with that probability, drawn
        from ``rng`` (pass a seeded one for deterministic replay).
        ``delay_log=(mu, sigma)`` makes pause() draw a lognormal sleep
        per fire instead of the fixed ``delay``."""
        with self._lock:
            self._arms.setdefault(site, []).append(
                _Arm(count, match, p=p, rng=rng, delay=delay,
                     delay_log=delay_log))

    def disarm(self, site: str) -> None:
        with self._lock:
            self._arms.pop(site, None)

    def clear(self) -> None:
        with self._lock:
            self._arms.clear()

    def _fire(self, site: str, attrs: dict) -> _Arm | None:
        arms = self._arms.get(site)
        if not arms:
            return None
        with self._lock:
            for arm in arms:
                if arm.remaining == 0:
                    continue
                if any(attrs.get(k) != v for k, v in arm.match.items()):
                    continue
                if arm.p < 1.0:
                    draw = (arm.rng or random).random()
                    if draw >= arm.p:
                        continue
                if arm.remaining > 0:
                    arm.remaining -= 1
                arm.fired += 1
                return arm
        return None

    def hit(self, site: str, **attrs) -> bool:
        """Called at the failure point; True = inject the failure."""
        arm = self._fire(site, attrs)
        if arm is None:
            return False
        if self.on_fire is not None:
            self.on_fire(site)
        return True

    async def pause(self, site: str, **attrs) -> bool:
        """Async delay site: sleeps the arm's ``delay`` when it fires.
        Callers MUST NOT hold a PG lock across this await (lint-
        enforced) — an injected stall must slow one op, not pin the
        lock for the whole daemon."""
        arm = self._fire(site, attrs)
        if arm is None:
            return False
        if self.on_fire is not None:
            self.on_fire(site)
        if arm.delay_log is not None:
            mu, sigma = arm.delay_log
            await asyncio.sleep(
                (arm.rng or random).lognormvariate(mu, sigma))
        elif arm.delay > 0:
            await asyncio.sleep(arm.delay)
        return True

    def fired(self, site: str) -> int:
        """Total times `site` actually injected (for test assertions)."""
        return sum(a.fired for a in self._arms.get(site, []))

    def fired_all(self) -> dict[str, int]:
        """site -> total injections (thrash verdict accounting)."""
        return {site: self.fired(site)
                for site, arms in self._arms.items()
                if any(a.fired for a in arms)}
