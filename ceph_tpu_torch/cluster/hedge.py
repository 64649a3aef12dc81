"""Straggler-proof dispatch: first-sufficient-subset hedged fan-outs.

Every EC sub-read fan-out used to wait for its slowest participant —
the tail-dominance the SSD-array study of online EC systems names as
the production bottleneck (arXiv:1709.05365). This module is the
shared cluster-tier fix: launch the minimal decode plan immediately,
arm EXTRA candidates (d > k) after a delay keyed off a per-peer
latency EWMA, resolve the fan-out on the first decodable subset, and
cancel the losers so hedges never leak tasks or double-apply work.
Reads and reconstructs are idempotent, which is what makes hedging
safe here; write fan-outs are all-ack and must never route through
this helper.

The hedge delay reuses the bounded-backoff shape of the client resend
loops (``client_backoff_base`` / ``client_backoff_max``): the EWMA
scales inside fixed bounds, so one absurd latency sample can neither
disable hedging nor turn it into a thundering herd.

Counter ledger (owned by the calling OSD's perf counters):

- ``ec_hedges_fired``  — hedge (extra) candidates actually launched
- ``ec_hedges_won``    — fired hedges that completed before the
  fan-out resolved (their replies joined the outcome set)
- ``ec_hedges_canceled`` — fired hedges cancelled while pending; by
  construction ``canceled == fired - won`` (every launched hedge
  either completes or is cancelled — the leak-free invariant the
  thrash verdict asserts)
- ``ec_hedges_wasted_bytes`` — payload bytes of completed hedges the
  winning subset did not need (the bandwidth price of the tail cut)

``CEPH_TPU_HEDGE=0`` is the A/B lever: it forces plan-exact fan-outs
(no extras) without touching per-daemon config, so a bench can run
hedged and unhedged arms in one process tree.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/hedge.py``.
"""
from __future__ import annotations

import asyncio
import os
from typing import Awaitable, Callable, Iterable

#: candidate: (key, peer osd id, zero-arg factory -> awaitable outcome)
Candidate = tuple[object, int, Callable[[], Awaitable]]


def hedge_enabled(conf=None) -> bool:
    """The A/B lever: env wins (CEPH_TPU_HEDGE=0 forces off), then the
    ``osd_hedge_reads`` knob, then on."""
    if os.environ.get("CEPH_TPU_HEDGE", "") == "0":
        return False
    if conf is not None:
        try:
            return bool(conf["osd_hedge_reads"])
        except Exception:
            return True
    return True


class PeerLatencyEWMA:
    """Per-peer sub-op reply latency EWMA tracked on the OSD (observed
    by ``await_reply`` on EVERY sub-op wait, so hedge delays adapt to
    what the peer is doing now, not to a boot-time constant)."""

    def __init__(self, conf=None, alpha: float = 0.25):
        self.conf = conf
        self.alpha = alpha
        self._ewma: dict[int, float] = {}

    def observe(self, peer: int, seconds: float) -> None:
        prev = self._ewma.get(peer)
        self._ewma[peer] = (seconds if prev is None
                            else prev + self.alpha * (seconds - prev))

    def latency(self, peer: int) -> float:
        """Current EWMA estimate, 0.0 for a never-seen peer."""
        return self._ewma.get(peer, 0.0)

    def _bounds(self) -> tuple[float, float, float]:
        base, cap, factor = 0.05, 2.0, 2.0
        if self.conf is not None:
            try:
                base = float(self.conf["client_backoff_base"])
                cap = float(self.conf["client_backoff_max"])
                factor = float(self.conf["osd_hedge_delay_factor"])
            except Exception:
                pass
        return base, cap, factor

    def hedge_delay(self, peers: Iterable[int]) -> float:
        """Seconds to wait before launching hedge candidates: the
        MEDIAN planned peer's EWMA x factor, clamped into the
        client_backoff bounded-backoff shape. The median is the
        healthy-plan completion estimate: a plan whose peers are all
        fast hedges early (cheap insurance), a uniformly slow plan
        (loaded cluster) hedges late (no thundering herd) — and one
        known straggler in the plan can NOT postpone the hedge by
        inflating the estimate, which is the exact case the hedge
        exists for (keying on max() made the deadline track the
        straggler it was meant to route around)."""
        base, cap, factor = self._bounds()
        known = sorted(self._ewma[p] for p in peers if p in self._ewma)
        est = known[len(known) // 2] if known else 0.0
        return min(cap, max(base, factor * est))


async def hedged_fanout(osd, primary: list, hedges: list,
                        sufficient: Callable[[dict], bool],
                        nbytes: Callable[[object], int] | None = None,
                        ) -> dict:
    """First-sufficient-subset fan-out with loser cancellation.

    ``primary``: the minimal plan's candidates, launched immediately.
    ``hedges``: extra candidates, launched together once the EWMA
    hedge delay elapses without the plan resolving (skipped entirely
    when hedging is off — the plan-exact legacy fan-out).

    Each candidate factory returns an awaitable producing the
    candidate's outcome; a raising factory records the exception AS
    the outcome (callers keep their own transient-vs-failed triage).
    Factories MUST clean up their reply expectation on cancellation
    (drop_reply in a CancelledError path) — cancellation is how losers
    die, and a leaked pending future would pin the reply map.

    ``sufficient`` is consulted with the {key: outcome} map after
    every completion; returning True resolves the fan-out: every
    still-pending candidate (straggling primaries included) is
    cancelled and awaited to completion, so the caller observes a
    task census identical to before the call.

    Returns the outcome map of everything that completed."""
    loop = asyncio.get_running_loop()
    perf = getattr(osd, "perf", None)
    outcomes: dict = {}
    task_key: dict[asyncio.Task, object] = {}

    def _launch(key, factory) -> asyncio.Task:
        t = loop.create_task(factory())
        task_key[t] = key
        return t

    pending = {_launch(k, f) for k, _p, f in primary}
    armed = list(hedges) if (hedges and hedge_enabled(osd.conf)) else []
    hedge_keys: set = set()
    deadline = (loop.time()
                + osd.hedge_delay([p for _k, p, _f in primary])
                if armed else 0.0)
    try:
        while pending or armed:
            timeout = (max(0.0, deadline - loop.time())
                       if armed else None)
            if pending:
                done, pending = await asyncio.wait(
                    pending, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
            else:
                done = set()
                await asyncio.sleep(timeout or 0.0)
            for t in done:
                key = task_key[t]
                try:
                    outcomes[key] = t.result()
                except BaseException as e:
                    outcomes[key] = e
            if done and sufficient(outcomes):
                break
            if armed and loop.time() >= deadline:
                # the plan is dragging: fire every hedge in one wave
                # (staggering would re-introduce a serial tail)
                for k, _p, f in armed:
                    pending.add(_launch(k, f))
                    hedge_keys.add(k)
                if perf is not None:
                    perf.inc("ec_hedges_fired", len(armed))
                armed = []
    finally:
        # losers die here — straggling primaries AND unfinished hedges
        losers = [t for t in task_key if not t.done()]
        for t in losers:
            t.cancel()
        if losers:
            await asyncio.gather(*losers, return_exceptions=True)
        # settle the ledger IN the finally: even a fan-out cancelled
        # from above (its caller's op died mid-hedge) must close its
        # books, or fired could outrun won + canceled and break the
        # leak-free invariant the thrash verdict asserts
        if perf is not None and hedge_keys:
            won = sum(1 for k in hedge_keys if k in outcomes)
            perf.inc("ec_hedges_won", won)
            perf.inc("ec_hedges_canceled", len(hedge_keys) - won)
            if nbytes is not None:
                # surplus hedges: completed, but the subset stays
                # sufficient without them — their bytes are the
                # bandwidth price of the tail cut
                wasted = 0
                for k in hedge_keys:
                    if k not in outcomes:
                        continue
                    rest = {kk: v for kk, v in outcomes.items()
                            if kk != k}
                    try:
                        if sufficient(rest):
                            wasted += max(0, int(nbytes(outcomes[k])))
                    except Exception:
                        pass
                if wasted:
                    perf.inc("ec_hedges_wasted_bytes", wasted)
    return outcomes
