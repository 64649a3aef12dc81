"""The two MDS cases of ``tests/test_multiprocess.py`` on the port
(``ceph_tpu_torch``): a ``ProcCluster`` of one mon, three OSD processes
and one or two MDS processes (``ProcCluster.start_mds``: ``python -m
ceph_tpu_torch.cluster.daemon --role mds``), every one on
``device="cpu"``. In a file of their own, so that ``--dist loadfile``
puts them on a worker of their own. The helpers are
``test_torch_multiprocess.py``'s (the outer deadline of a run 200 s).
Copied with only their imports and device changed. The reference's own
words follow each case's name.
"""
import asyncio

import pytest

from test_torch_multiprocess import make, run


def test_multiprocess_mds_kill9_replay(tmp_path):
    """The CephFS metadata daemon as a real OS process: client ops
    over kernel sockets, kill -9 mid-workload, cold restart replays
    the MDLog journal and the namespace survives (the ceph-mds +
    qa fs-recovery role)."""
    async def t():
        from ceph_tpu_torch.services.fs import FSLite
        from ceph_tpu_torch.services.mds import FSClient

        c = await make(tmp_path)
        try:
            await FSLite(c.client, 1).mkfs()
            await c.start_mds(0, pool=1)
            fs = FSClient(c.bus, c.client, 1, name="fsclient.0",
                          timeout=30.0)
            await fs.connect()
            await fs.mkdir("/proj")
            await fs.create("/proj/a")
            await fs.write("/proj/a", b"payload-one")
            assert await fs.read("/proj/a") == b"payload-one"
            # crash-stop the metadata authority mid-stream
            c.kill_mds(0)
            with pytest.raises((OSError, asyncio.TimeoutError)):
                await asyncio.wait_for(fs.mkdir("/proj/lost"), 3)
            # cold restart: journal replay restores the namespace
            await c.revive_mds(0)
            assert sorted(await fs.listdir("/proj")) == ["a"]
            assert await fs.read("/proj/a") == b"payload-one"
            await fs.mkdir("/proj/sub")
            await fs.create("/proj/sub/b")
            await fs.write("/proj/sub/b", b"after-revival")
            assert await fs.read("/proj/sub/b") == b"after-revival"
            # rename spans two dirfrags: the journaled path, over
            # real sockets
            await fs.rename("/proj/sub/b", "/proj/b2")
            assert await fs.read("/proj/b2") == b"after-revival"
            await fs.close()
        finally:
            await c.stop()

    run(t())


def test_multiprocess_multimds_pin_and_cross_rename(tmp_path):
    """TWO MDS ranks as separate OS processes: a client pins a subtree
    to rank 1 (the ceph.dir.pin role), redirects route over real
    sockets, and a cross-subtree rename runs its peer-request link
    half between the two daemon processes."""
    async def t():
        from ceph_tpu_torch.services.fs import FSLite
        from ceph_tpu_torch.services.mds import FSClient

        c = await make(tmp_path)
        try:
            await FSLite(c.client, 1).mkfs()
            await c.start_mds(0, pool=1)
            await c.start_mds(1, pool=1)
            fs = FSClient(c.bus, c.client, 1, name="fsclient.0",
                          timeout=30.0)
            await fs.connect()
            await fs.mkdir("/a")
            await fs.mkdir("/b")
            await fs.set_subtree_pin("/b", 1)
            # ops in both subtrees, including a cold client whose map
            # says rank 0 for everything
            await fs.create("/b/owned-by-1")
            await fs.write("/b/owned-by-1", b"rank1 data")
            fs2 = FSClient(c.bus, c.client, 1, name="fsclient.1",
                           timeout=30.0)
            await fs2.connect()
            assert await fs2.read("/b/owned-by-1") == b"rank1 data"
            # cross-subtree rename: peer_link travels mds.0 -> mds.1
            # over a kernel socket
            await fs.create("/a/f")
            await fs.write("/a/f", b"crossing")
            await fs.rename("/a/f", "/b/f")
            assert await fs2.read("/b/f") == b"crossing"
            assert await fs2.listdir("/a") == []
            # and back the other way (mds.1 -> mds.0)
            await fs2.rename("/b/f", "/a/back")
            assert await fs.read("/a/back") == b"crossing"
            await fs.close()
            await fs2.close()
        finally:
            await c.stop()

    run(t())


def test_mds_proc_phase_own_cluster_on_the_cpu(monkeypatch):
    """``chip_smoke.mds_proc_phase`` (phase mds's process arm on a
    ProcCluster of its own) on ``device="cpu"``, small: an EC k=2, m=1
    data pool on 3 OSD daemons (the card run: 8+3 on 11), a mon and two
    MDS daemons; every check of the arm holds (reads equal the writes,
    rank 0's kill -9 and revival with the namespace back, cross-subtree
    renames both ways, ``ceph_daemon`` against an MDS socket and the
    exporter against every OSD's, no failed EC batch and no decode on the
    host engine)."""
    import numpy as np

    import chip_smoke

    for name, value in (("MP_FILES", 4), ("MP_FILE_BYTES", 1 << 20),
                        ("MP_OSDS", 3),
                        ("CL_EC_PROFILE", {**chip_smoke.CL_EC_PROFILE,
                                           "k": "2", "m": "1"})):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.mds_proc_phase("cpu", np.random.default_rng(3),
                                    device="cpu")
    assert list(out["lines"]) == ["mds_start", "write", "read",
                                  "kill9_revive", "rename_clis"]
    start = out["lines"]["mds_start"]
    assert set(start["startup"]) == {"mds.0", "mds.1"}
    assert start["startup"]["mds.0"]["daemon_start_s"] >= 0
    assert out["lines"]["rename_clis"]["exporter_osds_up"] == 3
    chip_smoke.mp_check(out)


def test_mds_fit_from_the_measured_memory():
    """``chip_smoke.mp_fits``: two daemons more fit when the host's
    MemAvailable drop since the start, plus two daemons of its mean per
    live daemon, leave MP_FREE_SHARE of the host's memory free; VmRSS and
    Pss, printed beside it, do not enter the decision."""
    import chip_smoke

    gib = 1 << 30
    roles = {"mon": {"Pss": {"sum": 9 * gib, "max": 3 * gib},
                     "VmRSS": {"sum": 9 * gib, "max": 3 * gib}},
             "osd": {"Pss": {"sum": 60 * gib, "max": 5 * gib},
                     "VmRSS": {"sum": 60 * gib, "max": 5 * gib}}}
    before = {"MemTotal_bytes": 100 * gib, "MemAvailable_bytes": 40 * gib}
    for by_role in (roles, {"mon": {}, "osd": {}}):
        fit = chip_smoke.mp_fits({"by_role": by_role, "daemons": 15,
                                  "MemAvailable_bytes": 25 * gib}, before)
        assert fit["daemons_bytes"] == 15 * gib
        assert fit["daemon_bytes"] == gib
        assert fit["need_bytes"] == 17 * gib
        assert fit["room_bytes"] == 30 * gib and fit["fits"]
    fit = chip_smoke.mp_fits({"by_role": roles, "daemons": 15,
                              "MemAvailable_bytes": 10 * gib}, before)
    assert fit["daemon_bytes"] == 2 * gib
    assert fit["need_bytes"] == 34 * gib and not fit["fits"]
