"""PaxosMon: replicated monitors with leader election and two-phase
map commits (the src/mon/Paxos.cc:154-890 + Elector roles).

N mons (``mon.0`` .. ``mon.N-1``) form a quorum. The Elector is
rank-based like the reference's classic mode: a mon proposes itself
for an election epoch; peers ack unless a lower rank is in the race
(they counter-propose); majority acks -> victory, broadcast with the
quorum. The winner claims the public ``mon`` bus name, so OSDs and
clients keep talking to "the mon" with no routing changes; leases
(MMonLease) extend its authority and a missed lease triggers a new
election.

Map mutations run the Paxos value path compressed to its load-bearing
arc (collect :154 / begin :613 / accept :772 / commit :847-890):

- On victory the leader collects peers' last_committed and any
  uncommitted (pn, version, value), re-proposes the highest-pn
  uncommitted value first (the recovery obligation), and back-fills
  lagging peers from history.
- commit(inc) = begin: broadcast (pn, version, value) to the quorum,
  wait for MAJORITY accepts (counting itself), then apply + publish
  locally and send MPaxosCommit to peers, which apply the incremental
  to their own replicas. No quorum majority -> the round times out and
  the mutation fails (writes to the cluster map stall, the CP choice
  the reference makes).

Single-mon clusters short-circuit to local commits (quorum of one).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/paxos_mon.py``. The mon
uses no device.
"""
from __future__ import annotations

import asyncio
import time

from ..placement import crushmap as cm
from ..placement import encoding as menc
from ..placement.osdmap import Incremental
from . import messages as M
from .mon import MonLite


class QuorumLost(Exception):
    pass


class PaxosMon(MonLite):
    def __init__(self, bus, n_osds: int, rank: int, n_mons: int,
                 crush: cm.CrushMap | None = None,
                 hb_grace: float = 1.0, out_interval: float = 5.0,
                 lease_interval: float = 0.4,
                 election_timeout: float = 2.0,
                 accept_timeout: float = 3.0,
                 store=None):
        super().__init__(bus, n_osds, crush=crush, hb_grace=hb_grace,
                         out_interval=out_interval, name=f"mon.{rank}",
                         store=store)
        self.rank = rank
        self.n_mons = n_mons
        self.lease_interval = lease_interval
        self.election_timeout = election_timeout
        self.accept_timeout = accept_timeout
        # election state
        self.election_epoch = 0
        self.leader: int | None = None
        self.quorum: set[int] = set()
        self._acks: set[int] = set()
        self._last_lease = 0.0
        self._electing = False
        # paxos state
        self.pn = 100 + rank  # proposal numbers disjoint per rank
        self.promised_pn = 0
        self.accepted_pn = 0
        self.uncommitted: tuple[int, int, bytes] | None = None
        self._accept_waits: dict[tuple[int, int], set[int]] = {}
        self._accept_futs: dict[tuple[int, int], asyncio.Future] = {}
        self._collect_replies: dict[int, M.MPaxosLast] = {}
        self._collect_fut: asyncio.Future | None = None
        self._lease_task: asyncio.Task | None = None
        self._elect_task: asyncio.Task | None = None
        self._commit_lock = asyncio.Lock()
        if self.store is not None:
            # recover Paxos obligations (Paxos.h:24-104 first/last
            # committed + accepted-but-uncommitted value): a peon that
            # acked a begin before the crash re-proposes it on the next
            # collect round
            pn, promised, accepted, uncommitted = self.store.load_paxos()
            self.promised_pn = promised
            self.accepted_pn = accepted
            if uncommitted is not None and \
                    uncommitted[1] <= self.osdmap.epoch:
                uncommitted = None  # already committed before the crash
            self.uncommitted = uncommitted
            # pn restore: strictly above anything seen pre-crash, on
            # this rank's residue class (base 100+rank, step n_mons)
            # so proposal numbers stay globally unique across ranks
            floor = max(pn, promised, accepted)
            base = 100 + rank
            if floor >= base:
                steps = (floor + 1 - base + n_mons - 1) // n_mons
                self.pn = base + steps * n_mons
            self._save_paxos()

    def _save_paxos(self) -> None:
        if self.store is not None:
            self.store.save_paxos(self.pn, self.promised_pn,
                                  self.accepted_pn, self.uncommitted)

    # ---------------------------------------------------------- lifecycle

    @property
    def majority(self) -> int:
        return self.n_mons // 2 + 1

    def is_leader(self) -> bool:
        return self.leader == self.rank

    def peers(self) -> list[int]:
        return [r for r in range(self.n_mons) if r != self.rank]

    def _config_peers(self) -> list[str]:
        return [f"mon.{r}" for r in self.peers()]

    async def start(self) -> None:
        self.bus.register(self.name, self.handle)
        self._watchdog = asyncio.get_running_loop().create_task(
            self._watch_loop()
        )
        self._elect_task = asyncio.get_running_loop().create_task(
            self._election_loop()
        )

    async def stop(self) -> None:
        for t in (self._lease_task, self._elect_task):
            if t:
                t.cancel()
        self._drop_alias()
        await super().stop()

    def _drop_alias(self) -> None:
        """Release the public "mon" name IF we hold it. Ownership-
        checked: by the time a deposed leader processes its loss, the
        new leader may already have claimed the alias, and popping it
        blindly would cut every client off mid-election (a flake
        seen before: MPoolCreate -> SendError while no one held the name)."""
        try:
            if self.bus.entities.get("mon") == self.handle:
                self.bus.unregister("mon")
        except Exception:
            pass

    # ----------------------------------------------------------- election

    async def _election_loop(self) -> None:
        await asyncio.sleep(0.01 * self.rank)  # stagger startup
        while True:
            try:
                now = time.monotonic()
                stale = (now - self._last_lease) > self.election_timeout
                if self.leader is None or (
                    not self.is_leader() and stale
                ):
                    await self._start_election()
                await asyncio.sleep(self.lease_interval)
            except asyncio.CancelledError:
                raise
            except Exception:
                pass

    async def _start_election(self) -> None:
        if self.n_mons == 1:
            self._become_leader({self.rank})
            return
        # NOTE: if we are the (possibly stale) leader we KEEP the
        # public alias while campaigning — clients must never find the
        # name unbound; it moves only when a DIFFERENT leader wins
        self.leader = None
        self.election_epoch += 1
        epoch = self.election_epoch
        self._acks = {self.rank}
        self._electing = True
        try:
            for r in self.peers():
                try:
                    await self.bus.send(
                        self.name, f"mon.{r}",
                        M.MMonElect(epoch=epoch, rank=self.rank),
                    )
                except Exception:
                    pass
            await asyncio.sleep(self.election_timeout / 2)
            if (self.election_epoch == epoch
                    and len(self._acks) >= self.majority
                    and self.leader is None):
                self._become_leader(set(self._acks))
                for r in self.peers():
                    try:
                        await self.bus.send(
                            self.name, f"mon.{r}",
                            M.MMonVictory(epoch=epoch, leader=self.rank,
                                          quorum=sorted(self._acks)),
                        )
                    except Exception:
                        pass
                await self._leader_collect()
        finally:
            self._electing = False

    def _become_leader(self, quorum: set[int]) -> None:
        self.leader = self.rank
        self.quorum = quorum
        self._last_lease = time.monotonic()
        # expect heartbeats from every up OSD from NOW: one that died
        # during the failover never pings the new leader, yet must
        # still trip the watchdog
        now = time.monotonic()
        for osd in range(self.osdmap.n_osds):
            if self.osdmap.osds[osd].up:
                self.last_ping.setdefault(osd, now)
        # claim the public name: clients/OSDs talk to "the mon"
        self.bus.register("mon", self.handle)
        if self._lease_task is None or self._lease_task.done():
            self._lease_task = asyncio.get_running_loop().create_task(
                self._lease_loop()
            )

    async def _lease_loop(self) -> None:
        while self.is_leader():
            for r in self.peers():
                try:
                    await self.bus.send(
                        self.name, f"mon.{r}",
                        M.MMonLease(epoch=self.election_epoch,
                                    leader=self.rank,
                                    last_committed=self.osdmap.epoch),
                    )
                except Exception:
                    pass
            await asyncio.sleep(self.lease_interval)

    async def _leader_collect(self) -> None:
        """Paxos::collect — recover uncommitted state from the quorum,
        back-fill lagging peers, catch OURSELVES up from ahead peers,
        and ratchet the proposal number above any promise out there."""
        loop = asyncio.get_running_loop()
        floor = 0
        for _round in range(3):
            # fresh, globally unique pn on this rank's residue class,
            # strictly above any promise a peon reported (a re-elected
            # leader whose pn trails a prior collector's would have its
            # begins dropped silently — a permanent commit wedge)
            base = 100 + self.rank
            want = max(self.pn + self.n_mons, floor + 1)
            steps = (want - base + self.n_mons - 1) // self.n_mons
            self.pn = base + steps * self.n_mons
            self._save_paxos()
            self._collect_replies = {}
            self._collect_fut = loop.create_future()
            for r in self.peers():
                try:
                    await self.bus.send(
                        self.name, f"mon.{r}",
                        M.MPaxosCollect(
                            pn=self.pn, epoch=self.election_epoch,
                            last_committed=self.osdmap.epoch),
                    )
                except Exception:
                    pass
            try:
                await asyncio.wait_for(self._collect_fut,
                                       self.accept_timeout)
            except asyncio.TimeoutError:
                pass
            floor = max((rep.promised_pn
                         for rep in self._collect_replies.values()),
                        default=0)
            if floor <= self.pn:
                break
        # a revived leader may be BEHIND the quorum it just won: the
        # peons back-filled our gap with MPaxosCommit before their Last
        # replies — wait (bounded) until those have applied, or our
        # next commit would re-propose already-committed epochs and
        # fork the map history
        max_lc = max((rep.last_committed
                      for rep in self._collect_replies.values()),
                     default=0)
        deadline = loop.time() + self.accept_timeout
        while self.osdmap.epoch < max_lc and loop.time() < deadline:
            await asyncio.sleep(0.02)
        if self.osdmap.epoch < max_lc:
            # STILL behind after the wait: proposing now would rebase
            # onto a stale epoch and fork the committed history (peers
            # drop the commit as "stale" while we apply it). Abdicate —
            # the election loop re-runs, and the next collect round
            # gets another back-fill attempt.
            self._drop_alias()
            self.leader = None
            return
        best = self.uncommitted
        for rep in self._collect_replies.values():
            if rep.uncommitted_ver and (
                best is None or rep.uncommitted_pn > best[0]
            ):
                best = (rep.uncommitted_pn, rep.uncommitted_ver,
                        rep.uncommitted_value)
            # back-fill peers that are behind
        for r, rep in self._collect_replies.items():
            for e in range(rep.last_committed + 1,
                           self.osdmap.epoch + 1):
                if e in self.history:
                    try:
                        await self.bus.send(
                            self.name, f"mon.{r}",
                            M.MPaxosCommit(version=e,
                                           value=self.history[e]),
                        )
                    except Exception:
                        pass
        if best is not None and best[1] == self.osdmap.epoch + 1:
            # recovery obligation: finish the in-flight round
            inc, _ = menc.decode_incremental(best[2])
            self.uncommitted = None
            try:
                await self.commit(inc)
            except QuorumLost:
                pass

    # ------------------------------------------------------------- dispatch

    async def handle(self, src: str, msg) -> None:
        if isinstance(msg, M.MMonElect):
            await self._handle_elect(src, msg)
        elif isinstance(msg, M.MMonElectAck):
            if msg.epoch == self.election_epoch:
                self._acks.add(msg.rank)
        elif isinstance(msg, M.MMonVictory):
            self._handle_victory(msg)
        elif isinstance(msg, M.MMonLease):
            self._handle_lease(msg)
        elif isinstance(msg, M.MPaxosCollect):
            await self._handle_collect(src, msg)
        elif isinstance(msg, M.MPaxosLast):
            self._handle_last(msg)
        elif isinstance(msg, M.MPaxosBegin):
            await self._handle_begin(src, msg)
        elif isinstance(msg, M.MPaxosAccept):
            self._handle_accept(msg)
        elif isinstance(msg, M.MPaxosCommit):
            self._handle_commit(msg)
        elif isinstance(msg, M.MOSDMapMsg):
            # follower catch-up: apply the leader's map publication
            for raw in msg.incrementals:
                inc, _ = menc.decode_incremental(raw)
                if inc.epoch == self.osdmap.epoch + 1:
                    self.history[inc.epoch] = raw
                    self.osdmap.apply_incremental(inc)
                    self._persist_commit(inc.epoch, raw)
            if msg.full and self.osdmap.epoch < msg.epoch:
                m, _ = menc.decode_osdmap(msg.full)
                self.osdmap = m
                # full-map catch-up must advance the pool-id watermark
                # and persist like any commit (a failed-over leader
                # must never reuse an existing pool id)
                self._persist_commit(self.osdmap.epoch, None)
        elif isinstance(msg, M.MPing):
            self.subscribers.add(src)
            await super().handle(src, msg)
        elif isinstance(msg, M.MMonGetMap):
            self.subscribers.add(src)
            await super().handle(src, msg)
        elif isinstance(msg, M.MConfig):
            # leader's config mirror (ConfigMonitor paxos-store role):
            # a peon that later wins an election keeps serving the DB
            self.config_db = {(w, k): v for w, k, v in msg.entries}
            if self.store is not None:
                self.store.replace_config(self.config_db)
        elif isinstance(msg, (M.MOSDBoot, M.MFailure, M.MPoolCreate,
                              M.MPoolSnapOp, M.MPoolSet, M.MPGTempClear,
                              M.MConfigSet, M.MUpmapItems, M.MBlocklist,
                              M.MMonCommand, M.MMgrDigest)):
            # map-mutating requests: a peon forwards to the leader
            # (Monitor::forward_request_leader role); commits that race
            # a leadership change fail quietly and the requester retries
            if not self.is_leader():
                await self._forward_to_leader(src, msg)
                return
            try:
                await super().handle(src, msg)
            except QuorumLost:
                pass
        else:
            await super().handle(src, msg)

    async def _forward_to_leader(self, src: str, msg) -> None:
        """Monitor::forward_request_leader role. Mid-election there is
        briefly NO leader; park the request until one is known
        (bounded) instead of silently discarding it — a dropped
        MPoolCreate/MPGTempClear would otherwise cost the requester a
        full op timeout before its own retry."""
        deadline = time.monotonic() + self.election_timeout * 2
        while self.leader is None and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        if self.is_leader():
            try:  # we won the election while the request was parked
                await super().handle(src, msg)
            except QuorumLost:
                pass
            return
        if self.leader is None:
            return  # still electing: the requester's hunt retries
        try:
            await self.bus.send(src, f"mon.{self.leader}", msg)
        except Exception:
            pass

    async def _handle_elect(self, src: str, msg: M.MMonElect) -> None:
        if self.is_leader() and msg.rank > self.rank:
            # a higher rank campaigning means it has no leader: either
            # a latecomer whose ack missed our round, or a revived
            # member that lost its state. FOLD it in and re-announce
            # victory instead of tearing a working leadership down — a
            # full re-election both aborts any in-flight paxos round
            # and can strand the same slow mon again (its ack racing
            # the same window); the re-announce alone tells a revived
            # member who leads
            self.election_epoch = max(self.election_epoch, msg.epoch)
            self.quorum.add(msg.rank)
            for r in self.peers():
                try:
                    await self.bus.send(
                        self.name, f"mon.{r}",
                        M.MMonVictory(epoch=self.election_epoch,
                                      leader=self.rank,
                                      quorum=sorted(self.quorum)),
                    )
                except Exception:
                    pass
            return
        if msg.rank < self.rank:
            # support the better candidate, drop any claim of our own,
            # and DEFER: stop proposing while their round completes
            # (the Elector defer role — without it a higher rank's
            # periodic proposals livelock the lower rank's election)
            if msg.epoch > self.election_epoch or (
                self.leader is None or self.leader >= msg.rank
            ):
                self.election_epoch = max(self.election_epoch, msg.epoch)
                # NOTE: deferring is not losing — keep the public alias
                # until the candidate actually WINS (_handle_victory's
                # ownership-checked drop); unbinding it here would leave
                # the name dangling for a full election round
                self.leader = None
                self._last_lease = time.monotonic()  # defer window
                await self.bus.send(
                    self.name, src,
                    M.MMonElectAck(epoch=msg.epoch, rank=self.rank),
                )
        elif not self._electing and (
                self.leader is None
                or (time.monotonic() - self._last_lease)
                > self.election_timeout):
            # a lower rank (us) should lead: counter-propose — but only
            # when leadership is actually in doubt. A higher rank
            # knocking to REJOIN a healthy quorum is the leader's
            # fold-in to answer; counter-proposing here would tear the
            # quorum down for every join attempt.
            await self._start_election()

    def _handle_victory(self, msg: M.MMonVictory) -> None:
        if msg.leader < self.rank or msg.epoch >= self.election_epoch:
            if msg.leader != self.rank:
                self._drop_alias()
            self.election_epoch = max(self.election_epoch, msg.epoch)
            self.leader = msg.leader
            self.quorum = set(msg.quorum)
            self._last_lease = time.monotonic()

    def _handle_lease(self, msg: M.MMonLease) -> None:
        # a lease extends OUR standing only if the quorum includes us:
        # a mon whose election ack was lost (boot race, partition,
        # CPU-starved under load) gets a victory/quorum that EXCLUDES
        # it — treating the leader's leases as membership would park it
        # outside the quorum forever (observed: quorum [1,2] wedged for
        # minutes with mon.0 alive). Left stale, the election loop
        # calls a rejoin round within election_timeout and the defer
        # rule folds everyone into a full quorum.
        if msg.leader == self.leader and self.rank in self.quorum:
            self._last_lease = time.monotonic()

    async def _handle_collect(self, src: str, msg: M.MPaxosCollect) -> None:
        # a collector BEHIND our committed history must catch up before
        # it proposes anything: back-fill it in order ahead of the Last
        # reply (same ordered connection), so a revived leader rejoins
        # at the quorum's epoch instead of forking numbering. A hole in
        # our own history (we caught up via a full map once) falls back
        # to shipping the full map — a partial back-fill would leave the
        # collector gapped and stalled.
        if msg.last_committed < self.osdmap.epoch:
            span = range(msg.last_committed + 1, self.osdmap.epoch + 1)
            if all(e in self.history for e in span):
                for e in span:
                    try:
                        await self.bus.send(
                            self.name, src,
                            M.MPaxosCommit(version=e,
                                           value=self.history[e]))
                    except Exception:
                        pass
            else:
                try:
                    await self.bus.send(
                        self.name, src,
                        M.MOSDMapMsg(
                            full=menc.encode_osdmap(self.osdmap),
                            incrementals=[], epoch=self.osdmap.epoch))
                except Exception:
                    pass
        if msg.pn > self.promised_pn:
            self.promised_pn = msg.pn
            self._save_paxos()  # promises survive restarts too
        un = self.uncommitted
        try:
            await self.bus.send(
                self.name, src,
                M.MPaxosLast(
                    pn=msg.pn, rank=self.rank,
                    last_committed=self.osdmap.epoch,
                    uncommitted_pn=un[0] if un else 0,
                    uncommitted_ver=un[1] if un else 0,
                    uncommitted_value=un[2] if un else b"",
                    promised_pn=self.promised_pn,
                ),
            )
        except Exception:
            pass  # collector died mid-round; the next election recollects

    def _handle_last(self, msg: M.MPaxosLast) -> None:
        if msg.pn == self.pn:
            self._collect_replies[msg.rank] = msg
            if (len(self._collect_replies) >= len(self.peers())
                    and self._collect_fut
                    and not self._collect_fut.done()):
                self._collect_fut.set_result(None)

    async def _handle_begin(self, src: str, msg: M.MPaxosBegin) -> None:
        if msg.pn < self.promised_pn:
            return  # promised a newer leader; stay silent
        self.promised_pn = msg.pn
        self.accepted_pn = msg.pn
        self.uncommitted = (msg.pn, msg.version, msg.value)
        # the durability obligation: persist BEFORE acking, or a
        # crashed peon could forget a value the leader counts as
        # accepted (Paxos.cc handle_begin stores the txn first)
        self._save_paxos()
        try:
            await self.bus.send(
                self.name, src,
                M.MPaxosAccept(pn=msg.pn, version=msg.version,
                               rank=self.rank),
            )
        except Exception:
            pass  # proposer died mid-round; recovery re-proposes

    def _handle_accept(self, msg: M.MPaxosAccept) -> None:
        key = (msg.pn, msg.version)
        self._accept_waits.setdefault(key, set()).add(msg.rank)
        fut = self._accept_futs.get(key)
        if (fut and not fut.done()
                and len(self._accept_waits[key]) + 1 >= self.majority):
            fut.set_result(None)

    def _handle_commit(self, msg: M.MPaxosCommit) -> None:
        """Follower-side apply (Paxos::handle_commit role)."""
        if msg.version <= self.osdmap.epoch:
            return  # stale
        if msg.version > self.osdmap.epoch + 1:
            # gapped (e.g. a revived replica): pull history from the
            # current leader via the public name
            asyncio.get_running_loop().create_task(
                self._request_catchup()
            )
            return
        inc, _ = menc.decode_incremental(msg.value)
        self.history[msg.version] = msg.value
        self.osdmap.apply_incremental(inc)
        if self.uncommitted and self.uncommitted[1] <= msg.version:
            self.uncommitted = None
        self._persist_commit(msg.version, msg.value)
        self._save_paxos()

    async def _request_catchup(self) -> None:
        try:
            await self.bus.send(
                self.name, "mon",
                M.MMonGetMap(have=self.osdmap.epoch),
            )
        except Exception:
            pass

    # ------------------------------------------------------------- commit

    async def commit(self, inc: Incremental) -> None:
        """Leader-side Paxos round, then the base publish path."""
        async with self._commit_lock:
            if inc.epoch != self.osdmap.epoch + 1:
                # a concurrent commit advanced the map; rebase
                inc.epoch = self.osdmap.epoch + 1
            if self.n_mons > 1:
                if not self.is_leader():
                    raise QuorumLost("not the leader")
                value = menc.encode_incremental(inc)
                key = (self.pn, inc.epoch)
                fut = asyncio.get_running_loop().create_future()
                self._accept_futs[key] = fut
                self._accept_waits.setdefault(key, set())
                self.uncommitted = (self.pn, inc.epoch, value)
                # the leader's own acceptance counts toward the
                # majority, so it carries the same durability
                # obligation as a peon's
                self._save_paxos()
                for r in self.peers():
                    try:
                        await self.bus.send(
                            self.name, f"mon.{r}",
                            M.MPaxosBegin(pn=self.pn, version=inc.epoch,
                                          value=value),
                        )
                    except Exception:
                        pass
                if self.majority > 1:
                    try:
                        await asyncio.wait_for(fut, self.accept_timeout)
                    except asyncio.TimeoutError:
                        self._accept_futs.pop(key, None)
                        raise QuorumLost(
                            f"no majority for epoch {inc.epoch}"
                        ) from None
                self._accept_futs.pop(key, None)
                accepted_by = self._accept_waits.pop(key, set())
                self.uncommitted = None
                self._save_paxos()
                await super().commit(inc)
                value = self.history[inc.epoch]
                for r in self.peers():
                    try:
                        await self.bus.send(
                            self.name, f"mon.{r}",
                            M.MPaxosCommit(version=inc.epoch,
                                           value=value),
                        )
                    except Exception:
                        pass
                del accepted_by
            else:
                await super().commit(inc)
