"""One deterministic schedule of the client services (``osdc/`` and
``services/``) through the JAX package's TestCluster and the port's, with
equal results required; and ``chip_smoke.py``'s phase ``services`` on the
CPU at a small size.

The schedule: a 12-OSD cluster with an EC k=8, m=3 pool (jerasure
reed_sol_van, the main path's code) and a replicated size-3 pool, built
and driven on the loop of a ``ClusterLoopThread`` (CephVFS's SQLite
callbacks call into it from another thread):
- FS: FSLite with its metadata on the replicated pool and its data on the
  EC pool; a ragged multi-object write, a 4 KiB overwrite, a truncate and
  a rename, then a directory listing and the file read back;
- striper: a ``RadosStriper`` file on the EC pool, written at an offset
  and read back;
- SQLite: a CephVFS database on the EC pool, a few thousand rows in one
  transaction, an aggregate query, the connection closed and reopened;
- RBD on the replicated pool: an image written, a snapshot, an overwrite,
  a clone of the snapshot with copy-up, a discard and a resize;
- RGW on the replicated pool: PUTs and a multipart upload, each ETag, the
  listing and every object read back.
Both packages also refuse ``RBD.create`` and ``RGWLite.create_bucket`` on
the EC pool with the same ``RadosError`` (-95: an EC pool has no omap).

The JAX cluster runs its codec with ``backend=device`` on JAX's CPU (as
``tests/test_faults.py`` does); the port's runs on ``device="cpu"`` (the
kernels' plain versions) in a subprocess that checks that no JAX module
and nothing of ``ceph_tpu`` was imported.

Tolerance: exact. Client-visible bytes (as sha256), RGW ETags and
listings, SQLite query results, and on every OSD each object's bytes and
``hash_info`` CRCs per (pg, shard) collection. Left out, because they
carry times, random ids or map epochs: the multipart upload's part
objects (``<bucket>//<key>.__part.<upload id>.<n>``) and its
``.__manifest`` (their names and bytes hold the upload id, an md5 of the
time); every omap and xattr (FS inodes carry mtimes, RGW index rows
times, RBD and CephVFS locks random cookies); versions, logs and the PG
meta object (map epochs).
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

EC_POOL, REP_POOL = 2, 1
SEED = 20261018
SQL_ROWS = 2000
MIB = 1 << 20


def _left_out(name: bytes) -> bool:
    """Objects whose names or bytes carry times or random ids."""
    return b".__part." in name or name.endswith(b".__manifest")


def _store_digest(pkg: str, stores) -> dict:
    """{osd: {cid: {oid hex: [sha256 of bytes, hinfo CRCs]}}} of every
    object but the PG meta object and those ``_left_out`` names."""
    st = importlib.import_module(f"{pkg}.cluster.stripe")
    pg = importlib.import_module(f"{pkg}.cluster.pg")
    out = {}
    for i, s in enumerate(stores):
        colls = {}
        for cid in sorted(s.list_collections()):
            objs = {}
            for oid in sorted(s.list_objects(cid)):
                if oid == pg.META_OID or _left_out(oid):
                    continue
                raw = s.getattrs(cid, oid).get(pg.ATTR_HINFO)
                hinfo = ([] if raw is None
                         else [int(x) for x in st.dec_hinfo(raw)])
                objs[oid.hex()] = [
                    hashlib.sha256(s.read(cid, oid)).hexdigest(), hinfo]
            if objs:
                colls[cid] = objs
        out[str(i)] = colls
    return out


def _sha(b: bytes) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


async def _fs(pkg, c, rng, res):
    fsmod = importlib.import_module(f"{pkg}.services.fs")
    fs = fsmod.FSLite(c.client, REP_POOL, data_pool=EC_POOL)
    await fs.mkfs()
    await fs.mkdir("/dir")
    data = bytearray(rng.bytes(9 * MIB + 12_345))
    await fs.write("/dir/a", bytes(data))
    patch = rng.bytes(4096)
    await fs.write("/dir/a", patch, 4096 * 301)
    data[4096 * 301:4096 * 302] = patch
    await fs.truncate("/dir/a", 5 * MIB + 777)
    del data[5 * MIB + 777:]
    await fs.rename("/dir/a", "/dir/b")
    res["fs_list"] = sorted(await fs.listdir("/dir"))
    got = await fs.read("/dir/b")
    assert got == data, pkg
    res["fs_read"] = _sha(got)
    res["fs_size"] = (await fs.stat("/dir/b"))["size"]


async def _striper(pkg, c, rng, res):
    sc = importlib.import_module(f"{pkg}.osdc.striped_client")
    striper = sc.RadosStriper(c.client, EC_POOL)
    data = rng.bytes(3 * MIB + 999)
    await striper.write("striped", data, offset=MIB + 4096)
    got = await striper.read("striped")
    assert got[MIB + 4096:] == data, pkg
    res["striper_read"] = _sha(got)
    res["striper_size"] = await striper.stat("striped")


def _sqlite(pkg, c, bridge, rows, res):
    """Runs in a worker thread: the VFS's callbacks call into the loop."""
    import sqlite3

    vmod = importlib.import_module(f"{pkg}.services.sqlite_vfs")
    vfs = vmod.CephVFS(bridge, c.client, EC_POOL, name=f"twin-{pkg}")
    vfs.register()
    try:
        db = sqlite3.connect(f"file:twin?vfs={vfs.name}", uri=True,
                             timeout=60)
        db.execute("create table t (id integer primary key, k text, "
                   "v integer)")
        with db:
            db.executemany("insert into t values (?, ?, ?)", rows)
        res["sql_agg"] = list(db.execute(
            "select count(*), sum(v), min(k), max(k) from t").fetchone())
        db.close()
        db = sqlite3.connect(f"file:twin?vfs={vfs.name}", uri=True,
                             timeout=60)
        res["sql_reopen"] = list(db.execute(
            "select count(*), sum(v % 1000) from t where v % 7 = 3"
        ).fetchone())
        db.close()
    finally:
        vfs.unregister()


async def _rbd(pkg, c, rng, res):
    rbdmod = importlib.import_module(f"{pkg}.services.rbd")
    rbd = rbdmod.RBD(c.client, REP_POOL)
    size = 24 * MIB
    await rbd.create("vol", size)
    img = await rbd.open("vol")
    data = bytearray(rng.bytes(size))
    await img.write(0, bytes(data))
    await img.snap_create("s1")
    snap = bytes(data)
    fresh = rng.bytes(6 * MIB + 4096)
    await img.write(3 * MIB, fresh)
    data[3 * MIB:3 * MIB + len(fresh)] = fresh
    snap_read = await (await rbd.open("vol", snap="s1")).read(0, size)
    await rbd.clone("vol", "s1", "child")
    child = await rbd.open("child")
    cpatch = rng.bytes(8192)
    await child.write(13 * MIB + 4096, cpatch)
    cdata = bytearray(snap)
    cdata[13 * MIB + 4096:13 * MIB + 4096 + 8192] = cpatch
    await child.discard(18 * MIB, 4 * MIB)
    cdata[18 * MIB:22 * MIB] = bytes(4 * MIB)
    await child.resize(20 * MIB)
    del cdata[20 * MIB:]
    await img.resize(16 * MIB)
    del data[16 * MIB:]
    got = {"head": await img.read(0, size),
           "snap": snap_read,
           "child": await child.read(0, size)}
    assert got["head"] == data and got["snap"] == snap, pkg
    assert got["child"] == cdata, pkg
    res["rbd_reads"] = {k: _sha(v) for k, v in got.items()}
    res["rbd_sizes"] = [img.size, child.size]
    res["rbd_list"] = sorted(await rbd.list())
    await child.release_lock()
    await img.release_lock()


async def _rgw(pkg, c, rng, res):
    rgwmod = importlib.import_module(f"{pkg}.services.rgw")
    rgw = rgwmod.RGWLite(c.client, REP_POOL)
    await rgw.create_bucket("twin")
    objs = {f"k/{i:02d}": rng.bytes(int(n)) for i, n in enumerate(
        (1, 4096, 100_000, 3 * MIB + 17))}
    res["rgw_etags"] = {k: await rgw.put_object("twin", k, v)
                        for k, v in objs.items()}
    up = await rgw.initiate_multipart("twin", "mp")
    parts = [rng.bytes(MIB + 5 * i) for i in range(3)]
    res["rgw_part_etags"] = [await rgw.upload_part("twin", "mp", up, i + 1, p)
                             for i, p in enumerate(parts)]
    res["rgw_mp_etag"] = await rgw.complete_multipart("twin", "mp", up,
                                                      [1, 2, 3])
    objs["mp"] = b"".join(parts)
    ents, _ = await rgw.list_objects("twin")
    res["rgw_list"] = [[e["key"], e["size"], e["etag"]] for e in ents]
    reads = {}
    for k, v in objs.items():
        got, meta = await rgw.get_object("twin", k)
        assert got == v, (pkg, k)
        reads[k] = [_sha(got), meta["etag"]]
    res["rgw_reads"] = reads


async def _refusals(pkg, c, res):
    client = importlib.import_module(f"{pkg}.cluster.client")
    rbdmod = importlib.import_module(f"{pkg}.services.rbd")
    rgwmod = importlib.import_module(f"{pkg}.services.rgw")
    out = {}
    for what, make in (
            ("rbd", lambda: rbdmod.RBD(c.client, EC_POOL).create(
                "refused", 4 * MIB)),
            ("rgw", lambda: rgwmod.RGWLite(c.client, EC_POOL).create_bucket(
                "refused"))):
        try:
            await make()
        except client.RadosError as e:
            out[what] = [type(e).__name__, e.code, str(e)]
        else:
            out[what] = None
    res["ec_refusals"] = out


async def _schedule(pkg: str, device, bridge) -> dict:
    vstart = importlib.import_module(f"{pkg}.cluster.vstart")
    osdmap = importlib.import_module(f"{pkg}.placement.osdmap")
    kw = {} if device is None else {"device": device}
    c = vstart.TestCluster(n_osds=12, out_interval=600.0, **kw)
    await c.start()
    res = {}
    try:
        c.client.op_timeout = 120.0
        await c.client.create_pool(osdmap.Pool(
            id=REP_POOL, name="rep", size=3, pg_num=8, crush_rule=0))
        await c.client.create_pool(osdmap.Pool(
            id=EC_POOL, name="ec", size=11, min_size=8, pg_num=8,
            crush_rule=1, type="erasure",
            ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "8", "m": "3", "backend": "device"}))
        await c.wait_active(60)
        rng = np.random.default_rng(SEED)
        await _refusals(pkg, c, res)
        await _fs(pkg, c, rng, res)
        await _striper(pkg, c, rng, res)
        rows = [(i, f"key-{i:06d}", int(v)) for i, v in enumerate(
            rng.integers(0, 1 << 40, SQL_ROWS))]
        await asyncio.to_thread(_sqlite, pkg, c, bridge, rows, res)
        await _rbd(pkg, c, rng, res)
        await _rgw(pkg, c, rng, res)
        res["stores"] = _store_digest(pkg, c.stores)
    finally:
        await c.stop()
    return res


def run_schedule(pkg: str, device) -> dict:
    vmod = importlib.import_module(f"{pkg}.services.sqlite_vfs")
    bridge = vmod.ClusterLoopThread()
    try:
        return bridge.call(_schedule(pkg, device, bridge), timeout=600)
    finally:
        bridge.stop()


def port_main() -> None:
    """The port's side, run in a fresh interpreter: prints the result
    and fails if JAX or the reference package was imported."""
    res = run_schedule("ceph_tpu_torch", "cpu")
    bad = sorted(n for n in sys.modules
                 if n.split(".")[0] in ("jax", "jaxlib", "ceph_tpu"))
    assert not bad, bad
    print(json.dumps(res))


def test_services_schedule_equals_the_reference():
    # imported here, not at the top: the port's subprocess imports this
    # module and must not pull in the JAX package
    from test_torch_native import jax_library

    jax_library()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.set_num_threads(1)\n"
         "import test_torch_services_twin as t; t.port_main()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = run_schedule("ceph_tpu", None)
    stores = got.pop("stores"), want.pop("stores")
    assert got == want
    # both packages refuse RBD and RGW on the EC pool with EOPNOTSUPP
    for what in ("rbd", "rgw"):
        assert want["ec_refusals"][what][:2] == ["RadosError", -95], what
    assert stores[0].keys() == stores[1].keys()
    for osd in stores[1]:
        assert stores[0][osd] == stores[1][osd], osd
    # the schedule reached the OSDs with EC shards carrying hash_info
    # (an empty object, as the database's lock object, carries none)
    ec = [h for s in stores[1].values() for cid, objs in s.items()
          if cid.startswith(f"{EC_POOL}.") for _, h in objs.values()]
    assert sum(1 for h in ec if h) >= 8 * 11


def test_services_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.services_phase`` on ``device="cpu"``, small: every
    check of the phase holds (reads equal the host's copy, the EC
    refusals, K1 and K2 launched in ``fs``, ``sqlite`` and ``degraded``,
    no rs byte-API call, no decode round on the host engine, no failed
    placement lookup, every EC shard's hash_info against the C++ core);
    ``sv_batch_times`` then asks for K1 and K2 at the fs and sqlite steps'
    mean encode batches and the degraded step's mean decode batch. The
    plain versions do not count launches, so each kernel's wrapper is
    wrapped here to count its calls as the card's kernels count theirs;
    the timing itself needs CUDA events, so ``batch_times`` records what
    it is asked."""
    import functools

    import chip_smoke
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.ops import crc32c, rs
    from ceph_tpu_torch.placement import bulk

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for mod, name, k in ((rs, "gf_matmul", kernels.GF_MATMUL),
                         (crc32c, "crc0_cells", kernels.CRC32C),
                         (crc32c, "crc0_words", kernels.CRC32C),
                         (bulk, "do_rule_bulk", kernels.CRUSH_RULE)):
        def counted(*a, _fn=getattr(mod, name), _k=k, **kw):
            _k.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, functools.wraps(
            getattr(mod, name))(counted))
    timed = []

    def batch_times(dev, rng, codec, b, su, tag, cases):
        timed.append((tag, b, su, codec.k, codec.m, cases))
        return {f"{tag}_{c}": {"stripes": b} for c in cases}
    monkeypatch.setattr(chip_smoke, "batch_times", batch_times)
    out = chip_smoke.services_phase(
        "cpu", np.random.default_rng(5), device="cpu",
        fs_file_bytes=16 * MIB, fs_overwrites=32, fs_files=8, fs_dirs=2,
        rbd_image_bytes=16 * MIB, rbd_randwrites=32, rbd_copyups=2,
        crypt_image_bytes=8 * MIB, mirror_image_bytes=8 * MIB,
        mirror_rounds=2, rgw_puts=4, rgw_object_bytes=MIB,
        rgw_multipart_bytes=4 * MIB, rgw_parts=2, sql_rows=300,
        sql_degraded_rows=50)
    lines = out["lines"]
    steps = ["setup", "fs", "rbd", "mirror", "rgw", "sqlite", "degraded"]
    if "rbd_crypto" in lines:  # the cryptography package imports here
        steps.insert(3, "rbd_crypto")
    assert list(lines) == steps
    assert lines["setup"]["ec_refusals"] == {"rbd": -95, "rgw": -95}
    assert lines["setup"]["prewarmed_pgids"] == 2 * chip_smoke.CL_PG_NUM
    for step in ("fs", "sqlite", "degraded"):
        assert lines[step]["encode_batches"] > 0, step
    assert lines["degraded"]["decode_batches"] > 0
    assert lines["rbd"]["copied_up"] == 2
    assert lines["mirror"]["entries_replayed"] == 2
    assert lines["rgw"]["listed"] == 5
    assert lines["degraded"]["shards_crc_checked"] > 11
    assert out["launches"]["crush_rule"] > 0

    def mean(step, kind):
        line = lines[step]
        return round(line[f"{kind}_stripes"] / line[f"{kind}_batches"])
    out_timed = chip_smoke.sv_batch_times(lines, np.random.default_rng(6),
                                          device="cpu")
    assert timed == [
        ("services_fs_wb", mean("fs", "encode"), chip_smoke.ECB_SU, 8, 3,
         ("write", "crc")),
        ("services_sql_wb", mean("sqlite", "encode"), chip_smoke.ECB_SU, 8,
         3, ("write", "crc")),
        ("services_rb", mean("degraded", "decode"), chip_smoke.ECB_SU, 8, 3,
         ("decode",))]
    assert len(out_timed) == 5
