"""One deterministic schedule of the CephFS metadata daemon through the
JAX package's TestCluster, ``MDSLite`` and ``FSClient`` and the port's,
with equal results required.

The schedule: a 12-OSD cluster, the metadata on a replicated size-3 pool
and the file data on an EC k=8, m=3 pool (jerasure reed_sol_van, the main
path's code); ``FSLite.mkfs``, MDS ranks 0 and 1 (``data_pool`` the EC
pool) and two ``FSClient``s, the second with ``cache=True`` (the
ObjectCacher):
- a directory per rank, the second pinned to rank 1
  (``set_subtree_pin``); ragged files written by both clients in both
  subtrees, each client listing and reading what the other made;
- cross-subtree renames, rank 0 to 1 and back;
- a snapshot of a directory, an overwrite and a new file after it, the
  snapshot's listing and bytes read back;
- a bytes quota that refuses the write past it;
- rank 0 crashes mid-rename (``_crash_mid_rename``), a new rank 0 replays
  its journal and the rename completes.

The MDSs run with a ``revoke_timeout`` of 30 s, not the 2 s default: the
JAX package compiles its EC kernels for each new batch shape on the first
write of that shape, and a compile that outlasts a cap revoke would evict
a live client on one side only.

The JAX cluster runs its codec with ``backend=device`` on JAX's CPU; the
port's runs on ``device="cpu"`` (the kernels' plain versions) in a
subprocess that checks that no JAX module and nothing of ``ceph_tpu`` was
imported.

Tolerance: exact. Listings, file bytes (as sha256), stats, the quota's
refusal, the snapshot's listing and bytes; the bytes and omaps of each
rank's journal (``mdslog``, ``mdslog.1``), of the snap table
(``fsmeta.snaps``) and of the subtree table (``fsmeta.subtrees``); and on
every OSD each object's bytes, its omap and, on the EC pool, its
``hash_info`` CRCs per (pg, shard) collection. Masked, because they hold
``time.time()`` (``services/fs.py:168``, ``:213``, ``:227``, ``:247``,
``:269`` and ``services/mds.py:431``, ``:732``, ``:1082``): the
``mtime`` of every stat and the last 8 bytes (the mtime) of every inode
record, that is every omap value of a dirfrag (``fsdir.<ino>``) or of a
snapshot's frozen dirfrag (``fssnap.<snap>.dir.<ino>``). Left out: the PG
meta object (map epochs), versions, logs and every xattr but
``hash_info``.
"""
import asyncio
import hashlib
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

META_POOL, EC_POOL = 1, 2
SEED = 20261019
KIB = 1 << 10
#: bytes of an inode record (ino u64, type u8, size u64, mtime u64)
INODE_BYTES = 25
REVOKE_TIMEOUT = 30.0


def _sha(b: bytes) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def _mask_inode(oid: bytes, v: bytes) -> bytes:
    """An inode record with its mtime zeroed; other values as they are."""
    if ((oid.startswith(b"fsdir.") or oid.startswith(b"fssnap."))
            and len(v) == INODE_BYTES):
        return v[:-8] + bytes(8)
    return v


def _omap_digest(oid: bytes, omap: dict) -> dict:
    return {k.hex(): _mask_inode(oid, v).hex()
            for k, v in sorted(omap.items())}


def _store_digest(pkg: str, stores) -> dict:
    """{osd: {cid: {oid hex: [sha256 of bytes, omap, hinfo CRCs]}}} of
    every object but the PG meta object."""
    st = importlib.import_module(f"{pkg}.cluster.stripe")
    pg = importlib.import_module(f"{pkg}.cluster.pg")
    out = {}
    for i, s in enumerate(stores):
        colls = {}
        for cid in sorted(s.list_collections()):
            objs = {}
            for oid in sorted(s.list_objects(cid)):
                if oid == pg.META_OID:
                    continue
                raw = s.getattrs(cid, oid).get(pg.ATTR_HINFO)
                hinfo = ([] if raw is None
                         else [int(x) for x in st.dec_hinfo(raw)])
                objs[oid.hex()] = [_sha(s.read(cid, oid)),
                                   _omap_digest(oid, s.omap_get(cid, oid)),
                                   hinfo]
            if objs:
                colls[cid] = objs
        out[str(i)] = colls
    return out


def _stat(st: dict) -> dict:
    return {k: (0 if k == "mtime" else v) for k, v in sorted(st.items())}


async def _tables(pkg, c, res):
    """The journals, the snap table and the subtree table as the
    metadata pool holds them."""
    mds = importlib.import_module(f"{pkg}.services.mds")
    out = {}
    for oid in (mds.JOURNAL_OID, mds.JOURNAL_OID + b".1",
                mds.SNAP_TABLE_OID, mds.SUBTREE_OID):
        try:
            data = await c.client.read(META_POOL, oid)
        except KeyError:
            data = None
        try:
            omap = await c.client.omap_get(META_POOL, oid)
        except KeyError:
            omap = None
        out[oid.decode()] = [
            None if data is None else data.hex(),
            None if omap is None else _omap_digest(oid, omap)]
    res["tables"] = out


async def _tree(pkg, a, b, rng, res):
    """Both ranks' subtrees, files by both clients, cross listings."""
    res["files"] = {}
    await a.mkdir("/r0")
    await a.mkdir("/r1")
    await a.set_subtree_pin("/r1", 1)
    for i, size in enumerate((300 * KIB + 17, 64 * KIB, 5000, 1)):
        for cl, d in ((a, "/r0"), (b, "/r1")):
            path = f"{d}/f{i}"
            data = rng.bytes(size)
            await cl.create(path)
            await cl.write(path, data)
            res["files"][path] = data
    # each client lists and reads what the other made
    res["a_lists_r1"] = sorted(await a.listdir("/r1"))
    res["b_lists_r0"] = sorted(await b.listdir("/r0"))
    for path, data in res["files"].items():
        other = b if path.startswith("/r0") else a
        assert await other.read(path) == data, (pkg, path)
        res[f"stat{path}"] = _stat(await other.stat(path))


async def _renames(pkg, a, b, res):
    await a.rename("/r0/f0", "/r1/moved0")
    await b.rename("/r1/f1", "/r0/moved1")
    await b.rename("/r1/moved0", "/r0/back0")
    files = res["files"]
    files["/r0/back0"] = files.pop("/r0/f0")
    files["/r0/moved1"] = files.pop("/r1/f1")
    res["after_renames"] = [sorted(await a.listdir("/r0")),
                            sorted(await b.listdir("/r1"))]
    for path in ("/r0/back0", "/r0/moved1"):
        assert await a.read(path) == files[path], (pkg, path)


async def _snap(pkg, a, b, rng, res):
    files = res["files"]
    res["snapid"] = await a.mksnap("/r0", "s1")
    before = files["/r0/f2"]
    patch = rng.bytes(4096)
    await b.write("/r0/f2", patch, 1024)
    after = bytearray(before)
    after[1024:1024 + 4096] = patch
    files["/r0/f2"] = bytes(after)
    await a.create("/r0/new")
    files["/r0/new"] = b"after the snapshot"
    await a.write("/r0/new", files["/r0/new"])
    res["lssnap"] = await a.lssnap("/r0")
    res["snap_listdir"] = sorted(await a.snap_listdir("/r0", "s1"))
    got = await a.snap_read("/r0", "s1", "f2")
    assert got == before, pkg
    res["snap_read"] = _sha(got)
    res["snap_stat"] = _stat(await a.snap_stat("/r0", "s1", "f2"))
    assert await a.read("/r0/f2") == files["/r0/f2"], pkg


async def _quota(pkg, a, res):
    fslib = importlib.import_module(f"{pkg}.services.fs")
    await a.mkdir("/q")
    await a.set_quota("/q", max_bytes=8192)
    await a.create("/q/x")
    await a.write("/q/x", b"q" * 4096)
    await a._flush(a._paths["/q/x"])
    a._quota_cache.clear()
    try:
        await a.write("/q/big", b"y" * 8192)
    except fslib.QuotaExceeded as e:
        res["quota_refusal"] = [type(e).__name__, str(e)]
    else:
        res["quota_refusal"] = None
    res["quota"] = await a.get_quota("/q")
    res["quota_dirstat"] = await a.dir_stat("/q")
    res["files"]["/q/x"] = b"q" * 4096


async def _crash(pkg, c, mdsmod, m0, a, b, res):
    """Rank 0 dies between the two dirfrag updates of a rename; a new
    rank 0 replays its journal and completes it."""
    await b.mkdir("/r0/d2")
    for cl in (a, b):  # flush the caps and the cache before the crash
        await cl.close()
        await cl.connect()
    m0._crash_mid_rename = True
    try:
        await b.rename("/r0/f3", "/r0/d2/f3")
    except Exception as e:  # the daemon died mid-op
        res["crash"] = type(e).__name__
    else:
        res["crash"] = None
    await m0.stop()
    m0 = mdsmod.MDSLite(c.bus, c.client, META_POOL, name="mds.0",
                        data_pool=EC_POOL, revoke_timeout=REVOKE_TIMEOUT)
    await m0.start()
    res["files"]["/r0/d2/f3"] = res["files"].pop("/r0/f3")
    res["after_replay"] = [sorted(await b.listdir("/r0")),
                           sorted(await b.listdir("/r0/d2"))]
    return m0


async def _schedule(pkg: str, device) -> dict:
    vstart = importlib.import_module(f"{pkg}.cluster.vstart")
    osdmap = importlib.import_module(f"{pkg}.placement.osdmap")
    fslib = importlib.import_module(f"{pkg}.services.fs")
    mdsmod = importlib.import_module(f"{pkg}.services.mds")
    kw = {} if device is None else {"device": device}
    c = vstart.TestCluster(n_osds=12, out_interval=600.0, **kw)
    await c.start()
    res = {}
    try:
        c.client.op_timeout = 120.0
        await c.client.create_pool(osdmap.Pool(
            id=META_POOL, name="meta", size=3, pg_num=8, crush_rule=0))
        await c.client.create_pool(osdmap.Pool(
            id=EC_POOL, name="ec", size=11, min_size=8, pg_num=8,
            crush_rule=1, type="erasure",
            ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "8", "m": "3", "backend": "device"}))
        await c.wait_active(60)
        await fslib.FSLite(c.client, META_POOL, data_pool=EC_POOL).mkfs()
        ranks = []
        for r in range(2):
            m = mdsmod.MDSLite(c.bus, c.client, META_POOL, name=f"mds.{r}",
                               data_pool=EC_POOL,
                               revoke_timeout=REVOKE_TIMEOUT)
            await m.start()
            ranks.append(m)
        a = mdsmod.FSClient(c.bus, c.client, EC_POOL, name="fsclient.a",
                            timeout=120.0)
        b = mdsmod.FSClient(c.bus, c.client, EC_POOL, name="fsclient.b",
                            timeout=120.0, cache=True)
        await a.connect()
        await b.connect()
        rng = np.random.default_rng(SEED)
        await _tree(pkg, a, b, rng, res)
        await _renames(pkg, a, b, res)
        await _snap(pkg, a, b, rng, res)
        await _quota(pkg, a, res)
        ranks[0] = await _crash(pkg, c, mdsmod, ranks[0], a, b, res)
        files = res.pop("files")
        reads = {}
        for path, data in sorted(files.items()):
            got = await a.read(path)
            assert got == data, (pkg, path)
            reads[path] = [_sha(got), _stat(await b.stat(path))]
        res["reads"] = reads
        res["listing"] = {d: sorted(await a.listdir(d))
                          for d in ("/", "/r0", "/r1", "/r0/d2", "/q")}
        await a.close()
        await b.close()
        for m in ranks:
            await m.stop()
        await _tables(pkg, c, res)
        res["stores"] = _store_digest(pkg, c.stores)
    finally:
        await c.stop()
    return res


def run_schedule(pkg: str, device) -> dict:
    return asyncio.run(asyncio.wait_for(_schedule(pkg, device), 600))


def port_main() -> None:
    """The port's side, run in a fresh interpreter: prints the result
    and fails if JAX or the reference package was imported."""
    res = run_schedule("ceph_tpu_torch", "cpu")
    bad = sorted(n for n in sys.modules
                 if n.split(".")[0] in ("jax", "jaxlib", "ceph_tpu"))
    assert not bad, bad
    print(json.dumps(res))


def test_mds_schedule_equals_the_reference():
    # imported here, not at the top: the port's subprocess imports this
    # module and must not pull in the JAX package
    from test_torch_native import jax_library

    jax_library()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.set_num_threads(1)\n"
         "import test_torch_mds_twin as t; t.port_main()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = run_schedule("ceph_tpu", None)
    stores = got.pop("stores"), want.pop("stores")
    assert got == want
    # the schedule did what it says in both packages
    assert want["quota_refusal"][0] == "QuotaExceeded"
    assert want["crash"] is not None
    assert want["after_replay"] == [
        ["back0", "d2", "f1", "f2", "moved1", "new"], ["f3"]]
    assert want["tables"]["mdslog"][0], "rank 0 journaled nothing"
    assert want["tables"]["fsmeta.subtrees"][1], "no subtree table"
    assert want["tables"]["fsmeta.snaps"][1], "no snap table"
    assert stores[0].keys() == stores[1].keys()
    for osd in stores[1]:
        assert stores[0][osd] == stores[1][osd], osd
    # the file data reached the OSDs as EC shards carrying hash_info
    ec = [h for s in stores[1].values() for cid, objs in s.items()
          if cid.startswith(f"{EC_POOL}.") for _, _, h in objs.values()]
    assert sum(1 for h in ec if h) >= 8 * 11


def _count_launches(monkeypatch):
    """The plain versions do not count launches: wrap each kernel's
    wrapper to count its calls as the card's kernels count theirs."""
    import functools

    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.ops import crc32c, rs
    from ceph_tpu_torch.placement import bulk

    for mod, name, k in ((rs, "gf_matmul", kernels.GF_MATMUL),
                         (crc32c, "crc0_cells", kernels.CRC32C),
                         (crc32c, "crc0_words", kernels.CRC32C),
                         (bulk, "do_rule_bulk", kernels.CRUSH_RULE)):
        def counted(*a, _fn=getattr(mod, name), _k=k, **kw):
            _k.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, functools.wraps(
            getattr(mod, name))(counted))


def test_mds_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.mds_phase`` (the in-process arm) on ``device="cpu"``,
    small: every check of the phase holds (listings, every read equal to
    the host's copy, the snapshot's bytes, the quota's refusal, the
    replay after the crash, K1 and K2 launched in ``tree``, ``data`` and
    ``overwrites`` and K1 in ``degraded``, no rs byte-API call, no decode
    on the host engine, no failed placement lookup); ``sv_batch_times``
    then asks for K1 and K2 at the data step's mean encode batch and the
    degraded step's mean decode batch (the timing needs CUDA events, so
    ``batch_times`` records what it is asked)."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _count_launches(monkeypatch)
    timed = []

    def batch_times(dev, rng, codec, b, su, tag, cases):
        timed.append((tag, b, su, cases))
        return {f"{tag}_{c}": {"stripes": b} for c in cases}
    monkeypatch.setattr(chip_smoke, "batch_times", batch_times)
    out = chip_smoke.mds_phase(
        "cpu", np.random.default_rng(5), device="cpu", dirs=4, pinned=1,
        files=8, file_bytes=20_000, caps_files=4, race_files=4,
        data_bytes=16 << 20, data_files=2, overwrites=32, renames=4)
    lines = out["lines"]
    assert list(lines) == ["setup", "tree", "caps", "race", "data",
                           "overwrites", "rename", "snap", "quota", "crash",
                           "degraded"]
    assert lines["race"]["creates"] == 8
    assert lines["caps"]["reads_exact"] + lines["caps"]["reads_short"] == 4
    assert lines["setup"]["prewarmed_pgids"] == 2 * chip_smoke.CL_PG_NUM
    assert lines["rename"]["renames"] == 4
    assert lines["crash"]["replay_s"] > 0
    assert lines["quota"]["refused"]
    assert lines["degraded"]["decode_batches"] > 0
    assert lines["tree"]["caps"]["revokes"] > 0
    assert out["launches"]["crush_rule"] > 0
    chip_smoke.sv_batch_times(lines, np.random.default_rng(6), device="cpu",
                              table=chip_smoke.MD_TIMED)
    assert [t[0] for t in timed] == ["mds_data_wb", "mds_rb"]


async def _evicted(pkg: str, device) -> dict:
    """A cached client writes files and holds their caps; another reads
    them all at once while the MDS's revoke timeout is 1 ms, so every
    recall times out and the holder is evicted (ROADMAP §3 item 11)."""
    vstart = importlib.import_module(f"{pkg}.cluster.vstart")
    osdmap = importlib.import_module(f"{pkg}.placement.osdmap")
    fslib = importlib.import_module(f"{pkg}.services.fs")
    mdsmod = importlib.import_module(f"{pkg}.services.mds")
    kw = {} if device is None else {"device": device}
    c = vstart.TestCluster(n_osds=3, **kw)
    await c.start()
    try:
        await c.client.create_pool(osdmap.Pool(
            id=1, name="fs", size=3, pg_num=8, crush_rule=0))
        await c.wait_active(60)
        await fslib.FSLite(c.client, 1).mkfs()
        mds = mdsmod.MDSLite(c.bus, c.client, 1, revoke_timeout=0.001)
        await mds.start()
        a = mdsmod.FSClient(c.bus, c.client, 1, name="fsclient.a")
        b = mdsmod.FSClient(c.bus, c.client, 1, name="fsclient.b",
                            cache=True)
        await a.connect()
        await b.connect()
        files = {f"/f{i}": bytes([i + 1]) * 20_000 for i in range(8)}
        for p, data in files.items():
            await b.create(p)
            await b.write(p, data)
        got = await asyncio.gather(*(a.read(p) for p in files))
        await b.close()  # its sizes were handed back with the late releases
        again = [await a.read(p) for p in files]
        objs = sorted(o.decode() for o in await c.client.list_objects(1)
                      if o.startswith(b"fsdata."))
        await a.close()
        await mds.stop()
        return {"reads": [len(g) for g in got],
                "after_close": [len(g) for g in again],
                "data_objects": len(objs)}
    finally:
        await c.stop()


def test_cached_client_evicted_by_revoke_timeout_loses_size():
    """ROADMAP §3 item 11, in both packages: a cached FSClient whose cap
    recalls outlast the MDS's revoke timeout is evicted, the MDS drops
    its buffered sizes, and the files read as 0 bytes, then and after the
    holder closes, although their data objects are on the OSDs."""
    for res in (asyncio.run(asyncio.wait_for(_evicted(pkg, dev), 120))
                for pkg, dev in (("ceph_tpu", None),
                                 ("ceph_tpu_torch", "cpu"))):
        # which recalls outlast 1 ms depends on the host's clock: each
        # read is 0 bytes or the whole file, and some stay 0 for good
        assert set(res["reads"]) <= {0, 20_000}
        assert 0 in res["reads"] and 0 in res["after_close"], res
        assert res["data_objects"] >= 8, res


async def _ino_race(pkg: str, device) -> dict:
    """Two clients create files at once on two ranks, each rank with a
    RADOS client of its own (ROADMAP §3 item 12): the ranks read and
    write back one inode counter."""
    vstart = importlib.import_module(f"{pkg}.cluster.vstart")
    osdmap = importlib.import_module(f"{pkg}.placement.osdmap")
    fslib = importlib.import_module(f"{pkg}.services.fs")
    mdsmod = importlib.import_module(f"{pkg}.services.mds")
    kw = {} if device is None else {"device": device}
    c = vstart.TestCluster(n_osds=3, **kw)
    await c.start()
    try:
        await c.client.create_pool(osdmap.Pool(
            id=1, name="fs", size=3, pg_num=8, crush_rule=0))
        await c.wait_active(60)
        await fslib.FSLite(c.client, 1).mkfs()
        client = importlib.import_module(f"{pkg}.cluster.client")
        ranks = []
        for r in range(2):  # a RADOS client each, as MDS daemons have
            cl = client.RadosClient(c.bus, name=f"client.mds{r}", **kw)
            await cl.connect()
            ranks.append(mdsmod.MDSLite(c.bus, cl, 1, name=f"mds.{r}"))
            await ranks[-1].start()
        a = mdsmod.FSClient(c.bus, c.client, 1, name="fsclient.a")
        b = mdsmod.FSClient(c.bus, c.client, 1, name="fsclient.b")
        await a.connect()
        await b.connect()
        await a.mkdir("/r0")
        await a.mkdir("/r1")
        await a.set_subtree_pin("/r1", 1)
        await b.listdir("/r1")  # b learns that rank 1 owns /r1
        paths = [(cl, f"{d}/f{i}") for i in range(16)
                 for cl, d in ((a, "/r0"), (b, "/r1"))]
        await asyncio.gather(*(cl.create(p) for cl, p in paths))
        inos = [(await a.stat(p))["ino"] for _, p in paths]
        await a.write("/r0/f0", b"A" * 5000)
        await b.write("/r1/f0", b"B" * 5000)
        await a.close()
        await b.close()
        for m in ranks:
            await m.stop()
            await m.client.close()
        return {"inos": inos, "r0_f0": await fslib.FSLite(
            c.client, 1).read("/r0/f0")}
    finally:
        await c.stop()


def test_two_ranks_can_allocate_one_ino_twice():
    """ROADMAP §3 item 12, in both packages: ``FSLite._alloc_ino`` reads
    ``fsmeta.nextino`` and writes it back in two ops, and each rank
    serialises only its own mutations, so creates on two ranks at once
    hand out equal inode numbers (each pair's files share their data
    objects: the later write wins both)."""
    for pkg, dev in (("ceph_tpu", None), ("ceph_tpu_torch", "cpu")):
        res = asyncio.run(asyncio.wait_for(_ino_race(pkg, dev), 120))
        assert len(set(res["inos"])) < len(res["inos"]), (pkg, res)
        r0, r1 = res["inos"][0], res["inos"][1]
        if r0 == r1:  # one inode: /r0/f0 reads what /r1/f0's writer wrote
            assert res["r0_f0"] == b"B" * 5000, pkg
