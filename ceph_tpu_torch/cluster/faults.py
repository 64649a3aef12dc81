"""Fault plane: seeded, deterministic fault injection for the cluster.

The teuthology/OSDThrasher discipline (qa/tasks/ceph_manager.py:202)
brought in-process: one ``FaultPlane`` per cluster threads faults
through the three layers where real clusters break —

- **messenger** (``NetFaultPolicy``): per-peer-pair drop / delay /
  duplicate / reorder and full partitions, honored by both LocalBus and
  TcpMessenger (msg/messenger.py). This replaces the old ad-hoc
  ``LocalBus.blackholes`` set (kept as a compatibility view over the
  policy) with the ms_inject_socket_failures / ms_inject_delay_* role.
- **object store / device** (per-OSD ``FaultInjector`` arms, utils/
  fault.py): injected EIO, bit-flips on read (so hinfo CRC verification
  is actually exercised), torn writes, and EC batch dispatch failures.
  Specs registered on the plane re-arm automatically on OSD revive.
- **daemon lifecycle** (``Thrasher``): randomized kill/revive/flap and
  partition schedules orchestrated through ``vstart.TestCluster``
  (plus mon failover when the cluster runs a Paxos quorum, and —
  with ``chip_loss`` — mesh-chip losses: a dark device maps to EC
  device-dispatch failure on exactly its owning OSDs, see
  ``chip_owners``).

Everything derives from ONE seed: the thrash schedule is generated
upfront as a pure function of (seed, duration, topology) — same seed,
same schedule, same per-link fault draws — which is what makes a
thrash failure replayable (the FaultInjector role of
src/common/fault_injector.h:66, scaled up to a plan).

The ``Thrasher`` runs its schedule under a live write workload with a
client-side oracle (``OracleWorkload``) and then demands convergence:
every PG active, every pg_temp pin cleared, a deep-scrub round finding
zero inconsistencies after one repair pass, and every object reading
byte-equal to the oracle.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/faults.py``.
"""
from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field

from ..utils.fault import FaultInjector

#: fault sites the store/device layer exposes (arm via
#: FaultPlane.store_fault); pg.py / ecbatch.py call fault.hit() here
STORE_SITES = (
    "ec_local_read",    # primary's own shard read -> injected EIO
    "ec_sub_read",      # shard-side sub-read -> injected EIO
    "ec_read_bitflip",  # flip a bit in the chunk BEFORE hinfo verify
    "torn_write",       # persist only a prefix of a shard transaction
    "ec_batch",         # EC batch device dispatch failure
    "op_dispatch_delay",  # stall one client op before it runs
    "straggle",         # slow-OSD arm: lognormal service-time
    #                     inflation on shard-serving sub-reads
)


def flip_bit(chunk: bytes) -> bytes:
    """One-bit rot in the middle of a buffer (enough to break any CRC;
    deterministic so replays corrupt identically)."""
    if not chunk:
        return chunk
    buf = bytearray(chunk)
    buf[len(buf) // 2] ^= 0x01
    return bytes(buf)


@dataclass
class LinkFault:
    """Per-peer-pair fault mix (the ms_inject_* option set)."""

    drop: float = 0.0      # P(message silently dropped)
    dup: float = 0.0       # P(message delivered twice)
    delay: float = 0.0     # fixed added latency (seconds)
    jitter: float = 0.0    # + uniform[0, jitter) extra latency
    reorder: float = 0.0   # P(message additionally held back ~2x delay)


class NetFaultPolicy:
    """Decides the fate of every (src, dst) send. Honored by LocalBus
    (all traffic) and TcpMessenger (its own outgoing sends).

    ``plan(src, dst)`` returns None to drop the message silently, else
    a list of delivery delays in seconds — one entry per copy delivered
    (length 2 = duplicate). All randomness comes from the policy's own
    seeded RNG, and the RNG is consulted ONLY when a matching LinkFault
    is installed, so unfaulted traffic never perturbs the stream.
    """

    def __init__(self, rng: random.Random | None = None):
        self.rng = rng if rng is not None else random.Random(0)
        #: entity-level silent drop (the legacy blackhole verb —
        #: LocalBus.blackholes is a view of this set)
        self.blackholes: set[str] = set()
        #: (src, dst) -> LinkFault; "*" matches any entity
        self._links: dict[tuple[str, str], LinkFault] = {}
        #: bidirectional cuts: (group_a, group_b); "*" in a group
        #: matches every entity not named in the other group
        self._partitions: list[tuple[frozenset, frozenset]] = []
        self.counters: dict[str, int] = {}

    # ------------------------------------------------------ installers

    def set_link(self, src: str, dst: str, *, drop: float = 0.0,
                 dup: float = 0.0, delay: float = 0.0,
                 jitter: float = 0.0, reorder: float = 0.0,
                 symmetric: bool = False) -> None:
        """Install a fault mix on src->dst ("*" wildcards either end);
        ``symmetric`` installs the mirror link too."""
        self._links[(src, dst)] = LinkFault(drop, dup, delay, jitter,
                                            reorder)
        if symmetric and (dst, src) != (src, dst):
            self._links[(dst, src)] = LinkFault(drop, dup, delay,
                                                jitter, reorder)

    def clear_link(self, src: str, dst: str,
                   symmetric: bool = False) -> None:
        self._links.pop((src, dst), None)
        if symmetric:
            self._links.pop((dst, src), None)

    def clear_links(self) -> None:
        self._links.clear()

    def partition(self, a, b) -> None:
        """Full bidirectional cut between entity groups a and b.
        ``partition({"osd.3"}, {"*"})`` isolates osd.3 from everyone."""
        self._partitions.append((frozenset(a), frozenset(b)))

    def heal(self) -> None:
        """Remove every partition (the thrasher's heal verb); link
        faults and blackholes are cleared separately."""
        self._partitions.clear()

    def clear(self) -> None:
        self.heal()
        self.clear_links()
        self.blackholes.clear()

    @property
    def partitions(self) -> list[tuple[frozenset, frozenset]]:
        return list(self._partitions)

    # -------------------------------------------------------- decision

    def _in_group(self, who: str, group: frozenset,
                  other: frozenset) -> bool:
        return who in group or ("*" in group and who not in other)

    def partitioned(self, src: str, dst: str) -> bool:
        for a, b in self._partitions:
            if ((self._in_group(src, a, b) and self._in_group(dst, b, a))
                    or (self._in_group(src, b, a)
                        and self._in_group(dst, a, b))):
                return True
        return False

    def _link_for(self, src: str, dst: str) -> LinkFault | None:
        for key in ((src, dst), (src, "*"), ("*", dst), ("*", "*")):
            f = self._links.get(key)
            if f is not None:
                return f
        return None

    def _count(self, what: str) -> None:
        self.counters[what] = self.counters.get(what, 0) + 1

    def plan(self, src: str, dst: str) -> list[float] | None:
        """Delivery plan for one message: None = silent drop; else the
        delays (seconds) of each copy to deliver."""
        if src in self.blackholes or dst in self.blackholes:
            self._count("blackhole")
            return None
        if self.partitioned(src, dst):
            self._count("partition_drop")
            return None
        f = self._link_for(src, dst)
        if f is None:
            return [0.0]
        r = self.rng
        if f.drop and r.random() < f.drop:
            self._count("drop")
            return None
        d = f.delay
        if f.jitter:
            d += r.random() * f.jitter
        if f.reorder and r.random() < f.reorder:
            # held back long enough to land behind later sends
            d += 2.0 * (f.delay or 0.005) + r.random() * 0.005
            self._count("reorder")
        if d > 0:
            self._count("delay")
        out = [d]
        if f.dup and r.random() < f.dup:
            out.append(d + 0.001)
            self._count("dup")
        return out


class FaultPlane:
    """One seeded fault authority per cluster: the messenger policy,
    the per-OSD store/device fault specs (re-armed on revive), and the
    aggregate injection counters the thrash verdict reports."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        #: derived, independent streams so arming one layer never
        #: shifts another layer's draws
        self.net = NetFaultPolicy(rng=random.Random(seed ^ 0x9E3779B9))
        self._store_rng = random.Random(seed ^ 0x51ED2705)
        #: the slow-OSD arm's own stream: straggler delay draws must
        #: not shift bitrot/torn-write draws (arming stragglers in an
        #: existing schedule keeps every OTHER layer draw-for-draw)
        self._straggle_rng = random.Random(seed ^ 0x57A661E5)
        #: site -> (kwargs for FaultInjector.arm)
        self._store_specs: dict[str, dict] = {}
        #: every injector ever attached (revives append; history kept
        #: so fired counts survive a kill)
        self._injectors: list[tuple[int, FaultInjector]] = []

    # ------------------------------------------------------ store layer

    def attach_osd(self, osd) -> None:
        """Wire a (re)started OSD into the plane: registered store
        fault specs arm on its injector (honoring any OSD scope, so a
        revived OSD whose chip is still dark comes back dark), and
        injections feed its faults_injected_* perf counters."""
        self._injectors.append((osd.id, osd.fault))
        for site, (spec, ids) in self._store_specs.items():
            if ids is None or osd.id in ids:
                osd.fault.arm(site, rng=self._rng_for(site), **spec)

    def _rng_for(self, site: str) -> random.Random:
        """The seeded stream a site's probability/delay draws come
        from (straggle isolated so the slow-OSD arm never shifts the
        other store layers' draws)."""
        return (self._straggle_rng if site == "straggle"
                else self._store_rng)

    def store_fault(self, site: str, count: int = -1, p: float = 1.0,
                    delay: float = 0.0, osd_ids=None,
                    delay_log: tuple | None = None, **match) -> None:
        """Arm a store/device fault site on every attached OSD (and
        every OSD revived later) — or, with ``osd_ids``, only on that
        subset (the chip-loss arm: a dark mesh device maps to faults
        on exactly its owning OSDs). Probability draws come from the
        plane's seeded store RNG. Re-arming a site REPLACES the prior
        spec on live injectors — stacking arms would make live and
        revived OSDs fire at different rates."""
        spec = dict(count=count, p=p, delay=delay,
                    delay_log=delay_log, **match)
        ids = None if osd_ids is None else frozenset(osd_ids)
        self._store_specs[site] = (spec, ids)
        seen: set[int] = set()
        for osd_id, inj in reversed(self._injectors):
            if osd_id in seen:
                continue  # only the newest incarnation is live
            seen.add(osd_id)
            inj.disarm(site)
            if ids is None or osd_id in ids:
                inj.arm(site, rng=self._rng_for(site), **spec)

    def slow_osd(self, osd_ids, scale: float = 0.05,
                 sigma: float = 0.75) -> None:
        """The persistent slow-OSD arm: seeded lognormal service-time
        inflation (median ``scale`` seconds, shape ``sigma``) on the
        victims' shard-serving sub-reads — the straggler, as opposed
        to the failure, the hedged read fan-outs exist to route
        around. Re-armed on revive like every store fault (a victim
        that flaps comes back slow), replaced wholesale on each call:
        ``slow_osd([])`` heals everyone."""
        if not osd_ids:
            self.clear_store_fault("straggle")
            return
        import math

        self.store_fault("straggle", p=1.0, osd_ids=osd_ids,
                         delay_log=(math.log(scale), sigma))

    def clear_store_fault(self, site: str) -> None:
        """Disarm ONE site everywhere (the chip-heal verb: the other
        armed layers — bitrot, delays — keep thrashing)."""
        if self._store_specs.pop(site, None) is None:
            return
        for _osd_id, inj in self._injectors:
            inj.disarm(site)

    def clear_store_faults(self) -> None:
        sites = list(self._store_specs)
        self._store_specs.clear()
        for _osd_id, inj in self._injectors:
            for site in sites:
                inj.disarm(site)

    # ------------------------------------------------------- accounting

    def injected(self) -> dict[str, int]:
        """Aggregate injection counts across layers (net decisions plus
        every OSD incarnation's fired sites)."""
        out = dict(self.net.counters)
        for _osd_id, inj in self._injectors:
            for site, n in inj.fired_all().items():
                out[site] = out.get(site, 0) + n
        return out


# ===================================================== thrash driver ==


@dataclass(frozen=True)
class ThrashEvent:
    t: float      # seconds from thrash start
    kind: str     # kill | revive | partition | heal | mon_flap
    #             # | chip_loss | chip_heal | straggle | unstraggle
    target: int = -1  # osd id (kill/revive/partition/straggle) or
    #                   mesh chip (chip_loss/chip_heal); -1 = n/a


def chip_owners(n_osds: int, n_chips: int, chip: int) -> list[int]:
    """The OSDs whose EC staging is pinned to mesh device ``chip``:
    the serving path binds osd i to chip i % n_chips (the static
    shard-to-device binding of parallel/runtime.py's process-shared
    mesh) — so one chip going dark maps to device-dispatch failure on
    exactly these daemons."""
    return [i for i in range(n_osds) if i % n_chips == chip]


def build_schedule(seed: int, duration: float, n_osds: int,
                   max_unavail: int = 1, gap: tuple[float, float] =
                   (0.4, 1.2), partitions: bool = True,
                   mon_flaps: bool = False, chip_loss: bool = False,
                   n_chips: int = 8,
                   stragglers: int = 0) -> list[ThrashEvent]:
    """Deterministic thrash schedule: a pure function of its arguments
    (same seed => same schedule, the replayability contract). The
    generator tracks the dead/partitioned/dark set so it never
    schedules more than ``max_unavail`` simultaneously-unavailable
    OSDs — an EC pool keeps >= k shards reachable throughout. With
    ``chip_loss``, mesh-chip failures join the mix: a dark chip
    counts every live owning OSD (chip_owners) against the
    availability budget, exactly like a kill of those daemons.

    ``stragglers`` > 0 interleaves straggle/unstraggle events from an
    INDEPENDENT seeded stream (the availability draws above are
    untouched, so legacy schedules stay draw-for-draw identical): at
    most ``min(stragglers, max_unavail)`` OSDs are slow at once. A
    straggling OSD stays up and correct — it just serves slowly
    (FaultPlane.slow_osd lognormal inflation), which is the tail the
    hedged read fan-outs exist to cut."""
    rng = random.Random(seed)
    # an all-dead cluster has nothing left to thrash (and nothing to
    # converge back): always keep at least one OSD reachable
    max_unavail = min(max_unavail, max(0, n_osds - 1))
    events: list[ThrashEvent] = []
    dead: set[int] = set()
    cut: int = -1  # osd currently partitioned, -1 = none
    dark: int = -1  # mesh chip currently lost, -1 = none
    dark_owners: set[int] = set()
    t = 0.0
    while True:
        t += rng.uniform(*gap)
        if t >= duration:
            break
        choices: list[str] = []
        unavail = (len(dead) + (1 if cut >= 0 else 0)
                   + len(dark_owners - dead - ({cut} if cut >= 0
                                               else set())))
        if unavail < max_unavail:
            choices.append("kill")
            if partitions and cut < 0:
                choices.append("partition")
        if chip_loss and dark < 0:
            choices.append("chip_loss")
        if dead:
            choices += ["revive"] * 2  # bias toward healing
        if cut >= 0:
            choices += ["heal"] * 2
        if dark >= 0:
            choices += ["chip_heal"] * 2
        if mon_flaps:
            choices.append("mon_flap")
        if not choices:
            continue
        kind = rng.choice(choices)
        if kind == "kill":
            victim = rng.choice(sorted(set(range(n_osds)) - dead
                                       - {cut}))
            dead.add(victim)
            events.append(ThrashEvent(round(t, 3), "kill", victim))
        elif kind == "revive":
            victim = rng.choice(sorted(dead))
            dead.discard(victim)
            events.append(ThrashEvent(round(t, 3), "revive", victim))
        elif kind == "partition":
            cut = rng.choice(sorted(set(range(n_osds)) - dead))
            events.append(ThrashEvent(round(t, 3), "partition", cut))
        elif kind == "heal":
            events.append(ThrashEvent(round(t, 3), "heal", cut))
            cut = -1
        elif kind == "chip_loss":
            # only chips whose owners fit in the remaining budget (a
            # dark chip's owners are unavailable for EC device work)
            eligible = [
                ch for ch in range(n_chips)
                if (owners := set(chip_owners(n_osds, n_chips, ch)))
                and unavail + len(owners - dead
                                  - ({cut} if cut >= 0 else set()))
                <= max_unavail
            ]
            if eligible:
                dark = rng.choice(eligible)
                dark_owners = set(chip_owners(n_osds, n_chips, dark))
                events.append(ThrashEvent(round(t, 3), "chip_loss",
                                          dark))
        elif kind == "chip_heal":
            events.append(ThrashEvent(round(t, 3), "chip_heal", dark))
            dark = -1
            dark_owners = set()
        elif kind == "mon_flap":
            events.append(ThrashEvent(round(t, 3), "mon_flap"))
    if stragglers > 0:
        # separate stream + separate time walk: straggler scheduling
        # can never shift the availability draws above (the
        # draw-for-draw legacy identity contract)
        srng = random.Random(seed ^ 0x57A66)
        bound = max(1, min(stragglers, max_unavail))
        slowed: set[int] = set()
        sev: list[ThrashEvent] = []
        st = 0.0
        while True:
            st += srng.uniform(1.0, 3.0)
            if st >= duration:
                break
            # bias toward arming while under the bound — a thrash with
            # no straggler exercising nothing is wasted wall-clock
            if slowed and (len(slowed) >= bound
                           or srng.random() >= 0.6):
                victim = srng.choice(sorted(slowed))
                slowed.discard(victim)
                sev.append(ThrashEvent(round(st, 3), "unstraggle",
                                       victim))
            else:
                pool = sorted(set(range(n_osds)) - slowed)
                if not pool:
                    continue
                victim = srng.choice(pool)
                slowed.add(victim)
                sev.append(ThrashEvent(round(st, 3), "straggle",
                                       victim))
        events = sorted(events + sev, key=lambda e: e.t)
    return events


class OracleWorkload:
    """Concurrent EC writers with a client-side oracle.

    Each writer owns a disjoint set of object names and rewrites them
    with seeded payloads, recording content in the oracle only on ack.
    Within one object, generation N+1 is never issued before N acked,
    and the client must be run with an op_timeout longer than the
    thrash (tick-resends keep ONE tid per op, so the PG's reqid dedup
    — not luck — prevents a zombie duplicate from re-applying an old
    generation after a newer one).

    ``verify()`` (run after heal) reads every object back and returns
    the byte-mismatched names — the thrasher's ground truth.
    """

    def __init__(self, client, pool_id: int, seed: int = 0,
                 n_objects: int = 8, size: int = 24 << 10,
                 writers: int = 4):
        self.client = client
        self.pool_id = pool_id
        self.seed = seed
        self.size = size
        self.names = [f"thrash-{i}" for i in range(n_objects)]
        self.writers = max(1, min(writers, n_objects))
        self.oracle: dict[str, bytes] = {}
        self.gens: dict[str, int] = {n: 0 for n in self.names}
        self.inflight: set[str] = set()
        self.writes_acked = 0
        self.write_retries = 0
        self.read_checks = 0
        self.read_mismatches: list[str] = []
        #: one-shot mismatches that read back clean on the immediate
        #: re-read: a race with the write pipeline, not served rot
        self.read_transients = 0
        self._stop = False
        self._tasks: list[asyncio.Task] = []

    def _payload(self, name: str, gen: int) -> bytes:
        # size varies with the generation so shrinking rewrites (the
        # stale-shard hazard's trigger shape) happen under thrash too
        r = random.Random((self.seed << 20)
                          ^ self.names.index(name) * 1009 ^ gen * 7919)
        return r.randbytes(max(1024, self.size - (gen % 3) * 1024))

    async def _write(self, name: str, payload: bytes) -> None:
        self.inflight.add(name)
        try:
            # retry UNTIL ACKED, even across stop(): the oracle's
            # whole contract is that generation N settles before N+1
            # is issued and before verification — an abandoned retry
            # would leave partial-fanout debris as the final state.
            # stop() is called after heal+wait_clean, so the retry
            # always lands; the cap only bounds a truly dead cluster.
            for _attempt in range(200):
                try:
                    await self.client.write_full(self.pool_id, name,
                                                 payload)
                    break
                except (IOError, asyncio.TimeoutError):
                    self.write_retries += 1
                    await asyncio.sleep(0.2)
            else:
                raise IOError(f"write of {name} never acked")
            self.oracle[name] = payload
            self.writes_acked += 1
        finally:
            self.inflight.discard(name)

    async def _writer(self, wid: int) -> None:
        mine = self.names[wid::self.writers]
        while not self._stop:
            for name in mine:
                if self._stop:
                    return
                self.gens[name] += 1
                await self._write(name,
                                  self._payload(name, self.gens[name]))
                await asyncio.sleep(0)

    async def _reader(self) -> None:
        """Opportunistic degraded-read checker: only objects with no
        write in flight and a stable generation across the read are
        byte-compared (anything else is just read-path exercise)."""
        rng = random.Random(self.seed ^ 0xBEEF)
        while not self._stop:
            await asyncio.sleep(0.15)
            acked = [n for n in self.names
                     if n in self.oracle and n not in self.inflight]
            if not acked:
                continue
            name = rng.choice(acked)
            gen0, want = self.gens[name], self.oracle[name]
            try:
                got = await self.client.read(self.pool_id, name)
            except Exception:
                continue  # mid-fault read failure: retried by design
            if name in self.inflight or self.gens[name] != gen0:
                continue  # raced a rewrite: content undefined
            self.read_checks += 1
            if got != want:
                # double-check before convicting: genuinely served rot
                # or stale generations persist across an immediate
                # re-read, while pipeline races read back clean
                try:
                    got2 = await self.client.read(self.pool_id, name)
                except Exception:
                    continue
                if name in self.inflight or self.gens[name] != gen0:
                    continue
                if got2 == want:
                    self.read_transients += 1
                    continue
                self.read_mismatches.append(name)

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._writer(w))
                       for w in range(self.writers)]
        self._tasks.append(loop.create_task(self._reader()))

    async def stop(self) -> None:
        """Stop issuing NEW generations, then wait for every in-flight
        write to ack (run after heal: the oracle must be settled
        before verification)."""
        self._stop = True
        for t in self._tasks:
            try:
                await t
            except Exception:
                t.cancel()
        self._tasks = []

    async def verify(self) -> list[str]:
        bad: list[str] = []
        for name, want in sorted(self.oracle.items()):
            got = await self.client.read(self.pool_id, name)
            if got != want:
                bad.append(name)
        return bad


class Thrasher:
    """Seeded kill/partition/bitrot schedules under a live workload,
    then convergence: active+clean, scrub-clean, oracle byte-equal.

    The cluster must have been built with this plane (TestCluster
    wires its LocalBus and OSD injectors to it)."""

    def __init__(self, cluster, pool_id: int, seed: int = 0,
                 duration: float = 8.0, max_unavail: int = 1,
                 bitrot_p: float = 0.0, partitions: bool = True,
                 mon_flaps: bool = False, n_objects: int = 8,
                 obj_size: int = 24 << 10, writers: int = 4,
                 settle_timeout: float = 90.0,
                 chip_loss: bool = False, n_chips: int = 8,
                 stragglers: int = 0, straggle_scale: float = 0.05,
                 straggle_sigma: float = 0.75):
        self.cluster = cluster
        self.plane: FaultPlane = cluster.faults
        self.pool_id = pool_id
        self.seed = seed
        self.duration = duration
        self.max_unavail = max_unavail
        self.bitrot_p = bitrot_p
        self.partitions = partitions
        self.mon_flaps = mon_flaps and len(cluster.mons) > 1
        self.chip_loss = chip_loss
        self.n_chips = n_chips
        self.settle_timeout = settle_timeout
        self.stragglers = stragglers
        self.straggle_scale = straggle_scale
        self.straggle_sigma = straggle_sigma
        self.workload = OracleWorkload(cluster.client, pool_id,
                                       seed=seed, n_objects=n_objects,
                                       size=obj_size, writers=writers)
        self.schedule = build_schedule(
            seed, duration, cluster.n_osds, max_unavail=max_unavail,
            partitions=partitions, mon_flaps=self.mon_flaps,
            chip_loss=chip_loss, n_chips=n_chips,
            stragglers=stragglers)
        self.applied: list[ThrashEvent] = []
        self._dead_mons: list[int] = []
        self._slowed: set[int] = set()
        self._slowed_at_heal: list[int] = []

    async def _apply(self, ev: ThrashEvent) -> None:
        c = self.cluster
        if ev.kind == "kill":
            if c.osds[ev.target] is not None:
                await c.kill_osd(ev.target)
        elif ev.kind == "revive":
            if c.osds[ev.target] is None:
                await c.revive_osd(ev.target)
        elif ev.kind == "partition":
            self.plane.net.partition({f"osd.{ev.target}"}, {"*"})
        elif ev.kind == "heal":
            self.plane.net.heal()
        elif ev.kind == "chip_loss":
            # a mesh device going dark: every EC device dispatch on
            # the owning OSDs fails (EIO-shaped ec_batch failure) —
            # writes bounce and retry elsewhere in time, degraded
            # reads route around the dark daemons, and repair after
            # chip_heal runs the collective path
            owners = chip_owners(c.n_osds, self.n_chips, ev.target)
            self.plane.store_fault("ec_batch", p=1.0, osd_ids=owners)
        elif ev.kind == "chip_heal":
            self.plane.clear_store_fault("ec_batch")
        elif ev.kind == "straggle":
            # slow, not dead: the OSD keeps serving, just with seeded
            # lognormal inflation — the persistent-straggler arm the
            # hedged fan-outs route around
            self._slowed.add(ev.target)
            self.plane.slow_osd(sorted(self._slowed),
                                scale=self.straggle_scale,
                                sigma=self.straggle_sigma)
        elif ev.kind == "unstraggle":
            self._slowed.discard(ev.target)
            self.plane.slow_osd(sorted(self._slowed),
                                scale=self.straggle_scale,
                                sigma=self.straggle_sigma)
        elif ev.kind == "mon_flap":
            # never break the quorum MAJORITY: killed mons stay down
            # until the final heal, and a second flap on a 3-mon
            # quorum would leave 1/3 — no leader, no map updates, the
            # rest of the schedule silently exercising nothing. A
            # flap drawn while the bound is used up revives the
            # previous victim instead (still a failover event).
            n = len(c.mons)
            majority = n // 2 + 1
            if self._dead_mons and n - len(self._dead_mons) - 1 < majority:
                await c.revive_mon(self._dead_mons.pop(0))
            else:
                ranks = [r for r, m in enumerate(c.mons)
                         if m is not None and m.is_leader()]
                if ranks:
                    await c.kill_mon(ranks[0])
                    self._dead_mons.append(ranks[0])
        self.applied.append(ev)

    async def _heal_everything(self) -> None:
        c = self.cluster
        self.plane.net.clear()
        # snapshot the straggler set for the verdict before the wipe
        # (clear_store_faults drops the straggle arms with the rest)
        self._slowed_at_heal = sorted(self._slowed)
        self._slowed = set()
        self.plane.clear_store_faults()
        for rank in self._dead_mons:
            await c.revive_mon(rank)
        self._dead_mons = []
        for i, osd in enumerate(c.osds):
            if osd is None:
                await c.revive_osd(i)

    async def run(self) -> dict:
        """Run the schedule under workload, heal, demand convergence.
        Returns the machine-readable verdict (tools/thrash.py emits it
        as JSON)."""
        c = self.cluster
        if self.bitrot_p > 0:
            self.plane.store_fault("ec_read_bitflip", p=self.bitrot_p)
        # arm the buffer plane's opt-in codec-symmetry check for the
        # whole thrash: snapshot-view delivery skips the marshal per
        # hop, so the thrasher is where every client-facing message
        # still proves encode -> decode -> re-encode agreement (a
        # divergence fails the send loudly and the verdict with it)
        bus = getattr(c, "bus", None)
        if bus is not None and hasattr(bus, "verify_codec_symmetry"):
            bus.verify_codec_symmetry = True
        self.workload.start()
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for ev in self.schedule:
            delay = t0 + ev.t - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            await self._apply(ev)
        remaining = t0 + self.duration - loop.time()
        if remaining > 0:
            await asyncio.sleep(remaining)

        await self._heal_everything()
        converged = True
        try:
            await c.wait_clean(self.settle_timeout)
        except asyncio.TimeoutError:
            converged = False
        # settle the oracle only once the cluster serves writes again
        await self.workload.stop()

        pg_num = c.mon.osdmap.pools[self.pool_id].pg_num
        inconsistent: list = []
        if converged:
            # round 1 repairs whatever the thrash tore; round 2 is the
            # verdict — deep scrub must find NOTHING left
            for ps in range(pg_num):
                await c.scrub_pg((self.pool_id, ps))
            for ps in range(pg_num):
                report = await c.scrub_pg((self.pool_id, ps))
                inconsistent.extend(report["inconsistent"])

        mismatches = await self.workload.verify() if converged else []
        passed = (converged and not inconsistent and not mismatches
                  and not self.workload.read_mismatches)
        # degraded-tail ledger: sum the hedge counters over the live
        # daemons (kill/revive drops a dead incarnation's counts — the
        # ledger reports what the surviving processes actually did).
        # Leak-free invariant: canceled == fired - won; the straggler
        # thrash test asserts it on this very dict.
        hedge = {k: 0 for k in ("ec_hedges_fired", "ec_hedges_won",
                                "ec_hedges_canceled",
                                "ec_hedges_wasted_bytes")}
        for o in c.osds:
            if o is None:
                continue
            d = o.perf.dump()
            for k in hedge:
                hedge[k] += int(d.get(k, 0))
        return {
            "seed": self.seed,
            "duration": self.duration,
            "events": [[e.t, e.kind, e.target] for e in self.applied],
            "writes_acked": self.workload.writes_acked,
            "write_retries": self.workload.write_retries,
            "client_op_retries": getattr(c.client, "op_retries", 0),
            "read_checks": self.workload.read_checks,
            "read_transients": self.workload.read_transients,
            "read_mismatches": list(self.workload.read_mismatches),
            "converged": converged,
            "scrub_inconsistent": [o.decode(errors="replace")
                                   for o in inconsistent],
            "oracle_mismatches": mismatches,
            "faults_injected": self.plane.injected(),
            "hedge_counters": hedge,
            "stragglers": {
                "requested": self.stragglers,
                "scheduled": sum(1 for e in self.schedule
                                 if e.kind == "straggle"),
                "applied": sum(1 for e in self.applied
                               if e.kind == "straggle"),
                "slowed_at_heal": self._slowed_at_heal,
            },
            "passed": passed,
        }
