"""The cases of ``tests/test_sqlite_vfs.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

libcephsqlite role: an unmodified SQLite engine on RADOS via the
ctypes-registered VFS (src/libcephsqlite.cc + SimpleRADOSStriper
behavior: striped db file, exclusive-lock single writer, journal as a
second striped file)."""
import sqlite3

import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.sqlite_vfs import CephVFS, ClusterLoopThread
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

POOL = 1


@pytest.fixture
def vfs():
    bridge = ClusterLoopThread()

    async def mk():
        c = TestCluster(n_osds=3, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=POOL, name="db", size=2, pg_num=8, crush_rule=0))
        await c.wait_active(20)
        return c

    cluster = bridge.call(mk())
    v = CephVFS(bridge, cluster.client, POOL)
    v.register()
    yield v
    v.unregister()
    bridge.call(cluster.stop())
    bridge.stop()


def connect(v: CephVFS, name: str = "testdb") -> sqlite3.Connection:
    return sqlite3.connect(f"file:{name}?vfs={v.name}", uri=True,
                           timeout=2)


def test_crud_and_durability(vfs):
    db = connect(vfs)
    db.execute("create table kv (k text primary key, v int)")
    with db:
        db.executemany("insert into kv values (?, ?)",
                       [(f"key-{i}", i) for i in range(200)])
    assert db.execute(
        "select count(*), sum(v) from kv").fetchone() == (200, 19900)
    with db:
        db.execute("delete from kv where v % 2 = 0")
    assert db.execute("select count(*) from kv").fetchone() == (100,)
    db.close()

    # a NEW connection sees the committed state (pages read back out
    # of RADOS, not an OS page cache)
    db2 = connect(vfs)
    assert db2.execute(
        "select count(*), max(v) from kv").fetchone() == (100, 199)
    db2.close()


def test_pages_live_in_rados_objects(vfs):
    db = connect(vfs, "objcheck")
    with db:
        db.execute("create table t (x)")
        db.execute("insert into t values (zeroblob(100000))")
    db.close()
    objs = vfs.bridge.call(vfs.client.list_objects(POOL))
    names = {o.decode() if isinstance(o, bytes) else o for o in objs}
    assert any(n.startswith("objcheck.0") for n in names), names
    assert "objcheck.size" in names


def test_rollback_via_striped_journal(vfs):
    db = connect(vfs)
    with db:
        db.execute("create table t (x int)")
        db.execute("insert into t values (1)")
    try:
        with db:
            db.execute("insert into t values (2)")
            db.execute("this is not sql")
    except sqlite3.OperationalError:
        pass
    assert db.execute("select count(*) from t").fetchone() == (1,)
    db.close()


def test_single_writer_lock(vfs):
    db = connect(vfs)
    db.execute("create table t (x)")
    # second writer: the RADOS exclusive lock is held -> cannot open
    with pytest.raises(sqlite3.OperationalError):
        db2 = connect(vfs)
        db2.execute("insert into t values (1)")
    db.close()
    # lock released at close: a new writer proceeds
    db3 = connect(vfs)
    with db3:
        db3.execute("insert into t values (1)")
    assert db3.execute("select count(*) from t").fetchone() == (1,)
    db3.close()


def test_two_databases_coexist(vfs):
    a, b = connect(vfs, "dba"), connect(vfs, "dbb")
    with a:
        a.execute("create table t (x)")
        a.execute("insert into t values ('a')")
    with b:
        b.execute("create table t (x)")
        b.execute("insert into t values ('b')")
    assert a.execute("select x from t").fetchone() == ("a",)
    assert b.execute("select x from t").fetchone() == ("b",)
    a.close()
    b.close()


def test_crashed_holder_lock_expires(vfs):
    """A SIGKILLed lock holder must not wedge the database forever:
    the cls lock carries a duration, so an unrenewed grant expires and
    the next opener proceeds (SimpleRADOSStriper timed-lock role)."""
    import time as _time

    vfs.lock_duration_s = 0.5
    db = connect(vfs, "crashdb")
    with db:
        db.execute("create table t (x)")
        db.execute("insert into t values (1)")
    # simulate a crash: kill renewal and drop the handle registry so
    # xClose finds nothing to unlock (the lock is left held, exactly
    # as after a SIGKILL); then close the sqlite side so no dangling
    # connection outlives the VFS (its GC would call freed callbacks)
    h = next(iter(vfs._files.values()))
    if h.renew_task is not None:
        h.renew_task.cancel()
    vfs._files.clear()
    db.close()
    # immediately: still held (renewals stopped but not yet expired)
    with pytest.raises(sqlite3.OperationalError):
        connect(vfs, "crashdb").execute("select * from t")
    _time.sleep(0.8)  # > duration: the grant lapses on its own
    db2 = connect(vfs, "crashdb")
    assert db2.execute("select x from t").fetchone() == (1,)
    db2.close()
