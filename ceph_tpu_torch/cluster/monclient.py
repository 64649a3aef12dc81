"""Shared MonClient-role send hunting (src/mon/MonClient.h:271).

"mon" is whichever paxos leader holds the public alias; during an
election the alias is briefly unbound and a one-shot send throws
SendError. Every mon-facing daemon and client hunts the same way:
retry the alias with backoff, falling back to ranked mon names (a peon
forwards map-mutating requests to the leader and serves map reads from
its replica).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/monclient.py``.
"""
from __future__ import annotations

import asyncio

#: ranked names probed in the fallback sweep. Bounds the hunt, not the
#: cluster: deployments with more mons than this still converge through
#: the "mon" alias; the ranked sweep only narrows the failover window.
MAX_HUNT_RANKS = 16


async def mon_send(bus, src: str, msg, deadline_s: float) -> None:
    """Send ``msg`` from ``src`` to the monitor, hunting until
    ``deadline_s`` elapses. Raises IOError when no monitor answered."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + deadline_s
    delay = 0.02
    while True:
        try:
            await bus.send(src, "mon", msg)
            return
        except Exception:
            pass
        for r in range(MAX_HUNT_RANKS):  # ranked hunt, lowest first
            try:
                await bus.send(src, f"mon.{r}", msg)
                return
            except Exception:
                continue
        if loop.time() >= deadline:
            raise IOError("no monitor reachable")
        await asyncio.sleep(delay)
        delay = min(delay * 2, 0.4)
