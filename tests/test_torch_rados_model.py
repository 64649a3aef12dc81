"""The cases of ``tests/test_rados_model.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

Model-based random-op stress client with OSD thrashing.

The ceph_test_rados role (reference src/test/osd/RadosModel.h +
TestRados.cc, driven under thrashing by qa/tasks/ceph_manager.py
OSDThrasher): a random op stream — writes, partial overwrites, zeros,
truncates, appends, deletes, snapshots, snap reads, xattrs — runs
against a live cluster while OSDs are killed and revived, with a
shadow model tracking the expected state of every object; reads are
verified against the model continuously and after the cluster heals.
"""
import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2"}


def run(coro, timeout=300):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


class Model:
    """Shadow state: object bytes + per-snap frozen copies."""

    def __init__(self):
        self.objects: dict[str, bytearray] = {}
        #: snapid -> {name: bytes} frozen at snap time
        self.snaps: dict[int, dict[str, bytes]] = {}
        self.snap_ids: list[int] = []  # live snaps, ascending

    @property
    def snapc(self):
        if not self.snap_ids:
            return None
        return (self.snap_ids[-1], list(reversed(self.snap_ids)))

    def take_snap(self, snapid: int) -> None:
        self.snaps[snapid] = {n: bytes(d)
                              for n, d in self.objects.items()}
        self.snap_ids.append(snapid)

    def drop_snap(self, snapid: int) -> None:
        self.snaps.pop(snapid, None)
        self.snap_ids.remove(snapid)


class Thrasher:
    """OSDThrasher role (ceph_manager.py:202): kill a random non-mon
    OSD, let the cluster run degraded, revive, wait, repeat."""

    def __init__(self, cluster, rng, min_up: int):
        self.c = cluster
        self.rng = rng
        self.min_up = min_up
        self.down: list[int] = []
        self.kills = 0

    async def maybe_thrash(self) -> None:
        up = [i for i, o in enumerate(self.c.osds) if o is not None]
        if self.down and (len(up) <= self.min_up
                          or self.rng.random() < 0.5):
            victim = self.down.pop(0)
            await self.c.revive_osd(victim)
            await self.c.wait_active(60)
        elif len(up) > self.min_up:
            victim = int(self.rng.choice(up))
            await self.c.kill_osd(victim)
            await self.c.wait_down(victim, 30)
            self.down.append(victim)
            self.kills += 1

    async def heal(self) -> None:
        while self.down:
            await self.c.revive_osd(self.down.pop(0))
        await self.c.wait_active(60)


async def _model_run(pool: Pool, n_osds: int, min_up: int, seed: int,
                     rounds: int, with_snaps: bool) -> None:
    c = TestCluster(n_osds=n_osds, device="cpu")
    await c.start()
    await c.client.create_pool(pool)
    await c.wait_active(20)
    pid = pool.id
    rng = np.random.default_rng(seed)
    model = Model()
    thrasher = Thrasher(c, rng, min_up)
    names = [f"obj{i}" for i in range(8)]

    async def verify(name: str) -> None:
        want = model.objects.get(name)
        if want is None:
            with pytest.raises(KeyError):
                await c.client.read(pid, name)
        else:
            got = await c.client.read(pid, name)
            assert got == bytes(want), (
                f"{name}: got {len(got)}B want {len(want)}B")

    async def verify_snap(snapid: int, name: str) -> None:
        frozen = model.snaps[snapid].get(name)
        if frozen is None:
            with pytest.raises(KeyError):
                await c.client.read(pid, name, snapid=snapid)
        else:
            got = await c.client.read(pid, name, snapid=snapid)
            assert got == frozen, f"{name}@{snapid}"

    for step in range(rounds):
        name = str(rng.choice(names))
        cur = model.objects.get(name)
        ops = ["write_full", "write", "append", "zero", "truncate",
               "delete", "read"]
        if with_snaps:
            ops += ["snap_create", "snap_read", "snap_remove"]
        op = str(rng.choice(ops))
        snapc = model.snapc
        if op == "write_full":
            data = bytes(rng.integers(0, 256, int(rng.integers(1, 40_000)),
                                      dtype=np.uint8))
            await c.client.write_full(pid, name, data, snapc=snapc)
            model.objects[name] = bytearray(data)
        elif op == "write" and cur is not None:
            off = int(rng.integers(0, 50_000))
            data = bytes(rng.integers(0, 256, int(rng.integers(1, 9000)),
                                      dtype=np.uint8))
            await c.client.write(pid, name, off, data, snapc=snapc)
            if len(cur) < off + len(data):
                cur.extend(b"\0" * (off + len(data) - len(cur)))
            cur[off : off + len(data)] = data
        elif op == "append" and cur is not None:
            data = bytes(rng.integers(0, 256, int(rng.integers(1, 5000)),
                                      dtype=np.uint8))
            await c.client.append(pid, name, data, snapc=snapc)
            cur.extend(data)
        elif op == "zero" and cur is not None:
            off = int(rng.integers(0, 40_000))
            ln = int(rng.integers(1, 8000))
            await c.client.zero(pid, name, off, ln, snapc=snapc)
            if len(cur) < off + ln:
                cur.extend(b"\0" * (off + ln - len(cur)))
            cur[off : off + ln] = b"\0" * ln
        elif op == "truncate" and cur is not None:
            size = int(rng.integers(0, 45_000))
            await c.client.truncate(pid, name, size, snapc=snapc)
            if size < len(cur):
                del cur[size:]
            else:
                cur.extend(b"\0" * (size - len(cur)))
        elif op == "delete" and cur is not None:
            await c.client.delete(pid, name, snapc=snapc)
            del model.objects[name]
        elif op == "read":
            await verify(name)
        elif op == "snap_create" and len(model.snap_ids) < 3:
            snapid = await c.client.selfmanaged_snap_create(pid)
            model.take_snap(snapid)
        elif op == "snap_read" and model.snap_ids:
            snapid = int(rng.choice(model.snap_ids))
            await verify_snap(snapid, name)
        elif op == "snap_remove" and model.snap_ids:
            snapid = int(rng.choice(model.snap_ids))
            await c.client.selfmanaged_snap_remove(pid, snapid)
            model.drop_snap(snapid)
        if step % 12 == 11:
            await thrasher.maybe_thrash()

    await thrasher.heal()
    assert thrasher.kills > 0, "the thrasher never thrashed"
    for name in names:
        await verify(name)
    for snapid in model.snap_ids:
        for name in names:
            await verify_snap(snapid, name)
    # scrub every PG of the pool: a model run must end CLEAN
    for ps in range(pool.pg_num):
        pgid = (pid, ps)
        _up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        osd = c.osds[primary]
        for key, pg in osd.pgs.items():
            if (key[0], key[1]) == pgid and pg.is_primary():
                report = await pg.scrub()
                assert report["inconsistent"] == [], (pgid, report)
                break
    await c.stop()


def test_rados_model_replicated_thrash():
    run(_model_run(
        Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0),
        n_osds=5, min_up=3, seed=1234, rounds=120, with_snaps=True))


def test_rados_model_ec_thrash():
    run(_model_run(
        Pool(id=2, name="ec", size=5, min_size=3, pg_num=4, crush_rule=1,
             type="erasure", ec_profile=dict(EC_PROFILE)),
        n_osds=6, min_up=5, seed=77, rounds=100, with_snaps=True))
