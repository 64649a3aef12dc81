"""One deterministic cluster schedule through the JAX package's TestCluster
and the port's, with equal results required.

The schedule: a 12-OSD cluster with an EC k=8, m=3 pool (jerasure
reed_sol_van, the main path's code) and a replicated size-3 pool;
objects written to both, a 4 KiB overwrite, two shard OSDs killed, a
degraded read of everything and a degraded write, both OSDs revived,
recovery to active+clean, a deep-scrub of every PG, and a last read.
The JAX cluster runs its codec with ``backend=device`` on JAX's CPU
(as ``tests/test_faults.py`` does); the port's runs on ``device="cpu"``
(the kernels' plain versions) in a subprocess that checks that no JAX
module and nothing of ``ceph_tpu`` was imported.

Tolerance: exact. Client-visible bytes are equal, and so is every OSD's
store: per (pg, shard) collection, each object's bytes and its
``hash_info`` CRCs. Versions, logs and the PG meta object carry map
epochs and are not compared.

Also here: the port's thrash runner (``ceph_tpu_torch.tools.thrash``)
at the seeded verdict's seed, over the rs arm and a bitmatrix arm, and
``chip_smoke.py``'s phase ``cluster`` on the CPU at a small size.
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
import pytest
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

EC_POOL, REP_POOL = 2, 1
KILLED = (1, 6)
SEED = 20260803


def _objects(rng) -> dict[tuple[int, str], bytes]:
    """(pool, name) -> bytes: stripe-aligned, ragged and tiny objects."""
    sizes = (1 << 20, 32768, 100_000, 4096 * 9 + 17, 3)
    out = {}
    for pool in (EC_POOL, REP_POOL):
        for i, n in enumerate(sizes):
            out[(pool, f"obj-{i}")] = rng.integers(
                0, 256, n, dtype=np.uint8).tobytes()
    return out


def _store_digest(pkg: str, stores) -> dict:
    """{osd: {cid: {oid hex: [sha256 of bytes, hinfo CRCs]}}} of every
    user object (the PG meta object is left out)."""
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
                attrs = s.getattrs(cid, oid)
                raw = attrs.get(pg.ATTR_HINFO)
                hinfo = ([] if raw is None
                         else [int(x) for x in st.dec_hinfo(raw)])
                objs[oid.hex()] = [
                    hashlib.sha256(s.read(cid, oid)).hexdigest(), hinfo]
            if objs:
                colls[cid] = objs
        out[str(i)] = colls
    return out


async def _schedule(pkg: str, device) -> dict:
    vstart = importlib.import_module(f"{pkg}.cluster.vstart")
    osdmap = importlib.import_module(f"{pkg}.placement.osdmap")
    kw = {} if device is None else {"device": device}
    c = vstart.TestCluster(n_osds=12, out_interval=600.0, **kw)
    await c.start()
    result = {"reads": {}, "scrub_inconsistent": 0}
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
        objs = _objects(rng)
        for (pool, name), data in objs.items():
            await c.client.write_full(pool, name, data)
        # an aligned 4 KiB overwrite into the middle of the big objects
        patch = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        for pool in (EC_POOL, REP_POOL):
            await c.client.write(pool, "obj-0", 4096 * 37, patch)
            d = bytearray(objs[(pool, "obj-0")])
            d[4096 * 37:4096 * 38] = patch
            objs[(pool, "obj-0")] = bytes(d)
        for i in KILLED:
            await c.kill_osd(i)
        for i in KILLED:
            await c.wait_down(i, timeout=30)

        async def read_all(tag):
            for (pool, name), want in sorted(objs.items()):
                got = bytes(await c.client.read(pool, name))
                result["reads"][f"{tag}:{pool}:{name}"] = \
                    hashlib.sha256(got).hexdigest()
                assert got == want, (tag, pool, name)

        await read_all("degraded")
        late = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
        for pool in (EC_POOL, REP_POOL):
            await c.client.write_full(pool, "late", late)
            objs[(pool, "late")] = late
        for i in KILLED:
            await c.revive_osd(i)
        await c.wait_clean(120)
        for pool in (EC_POOL, REP_POOL):
            for ps in range(8):
                rep = await c.scrub_pg((pool, ps))
                result["scrub_inconsistent"] += len(rep["inconsistent"])
        await read_all("clean")
        result["stores"] = _store_digest(pkg, c.stores)
    finally:
        await c.stop()
    return result


def port_main() -> None:
    """The port's side, run in a fresh interpreter: prints the result
    and fails if JAX or the reference package was imported."""
    res = asyncio.run(asyncio.wait_for(_schedule("ceph_tpu_torch", "cpu"),
                                       600))
    bad = sorted(n for n in sys.modules
                 if n.split(".")[0] in ("jax", "jaxlib", "ceph_tpu"))
    assert not bad, bad
    print(json.dumps(res))


def test_cluster_schedule_equals_the_reference():
    # imported here, not at the top: the port's subprocess imports this
    # module and must not pull in the JAX package
    from test_torch_native import jax_library

    jax_library()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.set_num_threads(1)\n"
         "import test_torch_cluster_twin as t; t.port_main()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = asyncio.run(asyncio.wait_for(_schedule("ceph_tpu", None), 600))
    assert got["reads"] == want["reads"]
    assert got["scrub_inconsistent"] == want["scrub_inconsistent"] == 0
    assert got["stores"].keys() == want["stores"].keys()
    for osd in want["stores"]:
        assert got["stores"][osd] == want["stores"][osd], osd
    # the schedule reached every OSD's store with EC shards and replicas
    ec = [cid for s in want["stores"].values() for cid in s
          if cid.startswith(f"{EC_POOL}.")]
    assert len(ec) >= 8 * 11 // 2
    crcs = [h for s in want["stores"].values() for cid, objs in s.items()
            if cid.startswith(f"{EC_POOL}.") for _, h in objs.values()]
    assert crcs and all(crcs)  # every EC shard carries its hash_info


def _thrash(argv):
    from ceph_tpu_torch.tools import thrash

    return thrash.main(argv)


@pytest.mark.parametrize("profile", ["rs", "liberation"])
def test_thrash_runner_passes_at_the_seeded_verdicts_seed(profile, capsys):
    """The port's thrash runner at seed 20260803 for 4 s (the short
    duration ``tests/test_fabric.py`` uses): the verdict passes, and its
    schedule is the reference's ``build_schedule``."""
    from ceph_tpu.cluster.faults import build_schedule

    argv = ["--seed", str(SEED), "--duration", "4", "--settle", "120",
            "--device", "cpu", "--profile", profile]
    rc = _thrash(argv)
    verdict = json.loads(capsys.readouterr().out)
    assert rc == 0, verdict
    assert verdict["passed"] and verdict["converged"]
    assert verdict["oracle_mismatches"] == []
    assert verdict["scrub_inconsistent"] == []
    m = 2  # rs keeps the runner's default m; liberation forces m = 2
    want = build_schedule(SEED, 4.0, 5, max_unavail=m, partitions=True)
    assert verdict["events"] == [[e.t, e.kind, e.target] for e in want]
    assert verdict["ec_profile"] == profile
    assert verdict["ec_counters"]["ec_batches"] > 0


def test_thrash_runner_schedule_only_equals_the_reference(capsys):
    from ceph_tpu.cluster.faults import build_schedule

    assert _thrash(["--seed", str(SEED), "--schedule-only"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = build_schedule(SEED, 20.0, 5, max_unavail=2)
    assert got["events"] == [[e.t, e.kind, e.target] for e in want]


@pytest.mark.parametrize("flag, item", [("--chip-loss", "item 6"),
                                        ("--proc", "item 4")])
def test_thrash_runner_refuses_what_the_port_lacks(flag, item, monkeypatch,
                                                   capsys):
    """The runner refuses neither flag any more. ROADMAP §1 item 6 (the
    multi-device data plane) has landed: ``--chip-loss`` pins a virtual
    mesh of ``--chips`` slots and goes to the in-process arm (``_run``,
    driven for real by ``test_torch_faults_cluster.py``'s chip-loss
    thrash). Item 4 (the process tier) has landed: ``--proc`` goes to the
    process-tier arm (``_run_proc``, driven for real by
    ``test_torch_fabric_cluster.py``), never to the in-process one."""
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.tools import thrash

    if flag == "--chip-loss":
        seen = []

        async def run(args, max_unavail):
            seen.append((args.chip_loss, args.chips, args.mesh_width,
                         args.device, parallel.virtual_slots() >= args.chips))
            return {"passed": True}

        async def run_proc(args, max_unavail):
            raise AssertionError(f"{flag} ({item}) went to the process arm")

        monkeypatch.setattr(thrash, "_run", run)
        monkeypatch.setattr(thrash, "_run_proc", run_proc)
        assert _thrash(["--seed", "1", "--device", "cpu", flag]) == 0
        assert seen == [(True, 8, 2, "cpu", True)]
        assert json.loads(capsys.readouterr().out) == {"passed": True}
        return
    seen = []

    async def run_proc(args, max_unavail):
        seen.append((args.proc, args.device, max_unavail))
        return {"passed": True}

    async def run(args, max_unavail):
        raise AssertionError("--proc went to the in-process arm")

    monkeypatch.setattr(thrash, "_run_proc", run_proc)
    monkeypatch.setattr(thrash, "_run", run)
    assert _thrash(["--seed", "1", "--device", "cpu", flag]) == 0
    assert seen == [(True, "cpu", 2)]
    assert json.loads(capsys.readouterr().out) == {"passed": True}


def test_cluster_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.cluster_phase`` on ``device="cpu"``, small: every
    step's checks run (bytes, hash_info CRCs against the C++ core, a
    clean scrub, no op failed on placement, every decode round on the
    device engine) and the thrash verdict passes. The rs byte API is
    called in no step: the PG reaches the codec only through the
    ECBatcher."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    out = chip_smoke.cluster_phase(
        "cpu", np.random.default_rng(5), device="cpu", objects=8,
        rep_objects=4, overwrites=32, degraded_writes=4, profile=False)
    lines = out["lines"]
    assert list(lines) == ["setup", "write", "read", "overwrite", "kill",
                           "degraded_read", "degraded_write", "recovery",
                           "scrub", "read_clean", "thrash"]
    for step, line in lines.items():
        assert line["rs_byte_api"] == {"encode_chunks": 0,
                                       "decode_chunks": 0}, step
        assert line["placement_failures"] == 0, step
    assert lines["write"]["encode_batches"] > 0
    assert lines["degraded_read"]["decode_batches"] > 0
    assert lines["recovery"]["decode_batches"] > 0
    assert lines["scrub"]["shards_crc_checked"] == 11 * (8 + 4)
    assert lines["setup"]["prewarmed_pgids"] == 2 * chip_smoke.CL_PG_NUM
    assert out["thrash"]["passed"]
