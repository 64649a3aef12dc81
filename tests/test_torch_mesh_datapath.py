"""Multi-chip data plane on the port: the serving-path mesh
(``ceph_tpu_torch.parallel.runtime`` + the ECBatcher's mesh mode) — twins
of ``tests/test_mesh_datapath.py``'s eight functions on an 8-slot virtual
mesh over the CPU (``pin_virtual(8)``, codecs on ``device="cpu"``).

Unit tier pins the acceptance contract directly: mesh-sharded fused
encode+CRC and collective repair are BYTE-IDENTICAL to the single-device
dispatch over random stripes, results cross to the host only as per-slot
shard views (host_gathers stays 0), occupancy lands evenly across slots,
and a mesh the platform cannot supply RAISES (the reference degrades to
the 1-device path there; the port refuses by decision, ROADMAP
guardrails). Cluster tier proves OSD traffic actually crosses the mesh.
One schedule runs through the JAX package's batcher (on the 8-device
virtual CPU platform ``tests/conftest.py`` pins) and the port's with the
mesh knobs on: equal bytes, CRCs and perf counters. Tolerance: exact.
"""
import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.cluster.ecbatch import ECBatcher as JECBatcher
from ceph_tpu.ec import load_codec as jload_codec
from ceph_tpu.parallel import runtime as jruntime
from ceph_tpu.utils import config as jcfg
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import parallel
from ceph_tpu_torch.cluster.ecbatch import ECBatcher
from ceph_tpu_torch.ec import load_codec
from ceph_tpu_torch.parallel import runtime
from ceph_tpu_torch.utils import config as cfg
from ceph_tpu_torch.utils.perf import PerfCounters

torch.set_num_threads(1)
parallel.pin_virtual(8)

DEV_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2",
               "backend": "device"}


def codec_for(profile=None):
    return load_codec(dict(profile or DEV_PROFILE), device="cpu")


def run(coro, timeout=180):
    asyncio.run(asyncio.wait_for(coro, timeout))


def mesh_conf(n=8, width=2, repair="allgather"):
    conf = cfg.proxy()
    conf.apply({"osd_ec_mesh_devices": n, "osd_ec_mesh_width": width,
                "parallel_repair_mode": repair})
    return conf


def rand_cells(b, k=3, su=256, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (b, k, su), dtype=np.uint8)


# ------------------------------------------------------------ unit tier


@pytest.mark.parametrize("width", [1, 2, 4])
def test_mesh_encode_byte_identical_and_gather_free(width):
    """mesh={stripe, width} fused encode+CRC == the single-device
    dispatch, bit for bit, at every width factoring — and the write
    path never gathers the sharded result through one host buffer."""
    codec = codec_for()
    cells = rand_cells(11, seed=1)
    runtime.STATS.reset()

    async def t():
        meshed = ECBatcher(conf=mesh_conf(width=width))
        single = ECBatcher()
        pm, cm = await meshed.encode_cells(codec, cells)
        ps, cs = await single.encode_cells(codec, cells)
        assert (pm == ps).all()
        assert (cm == cs).all()
        assert meshed.mesh() is not None

    run(t())
    d = runtime.STATS.dump()
    assert d["mesh_encode_dispatches"] == 1
    assert d["mesh_host_gathers"] == 0
    assert d["mesh_encode_stripes"] == 11
    # occupancy is EVEN: the padded batch splits exactly across the
    # stripe rows, every slot owns the same share
    per_dev = set(d["mesh_stripes_per_device"].values())
    assert len(per_dev) == 1
    assert sorted(d["mesh_stripes_per_device"]) == list(range(8))


@pytest.mark.parametrize("method", ["allgather", "psum_bits"])
def test_collective_repair_matches_single_device(method):
    """decode_cells under parallel_repair_mode rebuilds data AND
    wanted-parity rows identically to the single-device stacked-matrix
    decode — including the k'=3-over-width=2 shape, where the chunk
    axis zero-pads to the mesh width."""
    codec = codec_for()
    cells = rand_cells(6, seed=2)
    runtime.STATS.reset()

    async def t():
        meshed = ECBatcher(conf=mesh_conf(width=2, repair=method))
        single = ECBatcher()
        parity, _ = await single.encode_cells(codec, cells)
        every = np.concatenate([cells, parity], axis=1)
        present = (0, 2, 4)  # lost data 1 and parity 3
        surv = np.ascontiguousarray(every[:, list(present), :])
        want = (0, 1, 2, 3)
        got = await meshed.decode_cells(codec, present, want, surv)
        ref = await single.decode_cells(codec, present, want, surv)
        assert (got == ref).all()
        assert (got[:, :3, :] == cells).all()

    run(t())
    d = runtime.STATS.dump()
    assert d["mesh_decode_dispatches"] == 1
    assert d["mesh_host_gathers"] == 0


def test_mesh_single_stripe_pads_to_stripe_row():
    """batch < slots: one stripe still dispatches (padded to a full
    stripe row) and comes back byte-exact."""
    codec = codec_for()
    cells = rand_cells(1, seed=3)

    async def t():
        meshed = ECBatcher(conf=mesh_conf(width=4))
        single = ECBatcher()
        pm, cm = await meshed.encode_cells(codec, cells)
        ps, cs = await single.encode_cells(codec, cells)
        assert (pm == ps).all() and (cm == cs).all()

    run(t())


def test_mesh_unavailable_degrades_to_single_device():
    """The port's decision (ROADMAP guardrails, "no degrade"): a config
    asking for more slots than the platform has (4096, past the pinned
    virtual mesh of 8 and the machine's cards) RAISES to the batch's
    waiters instead of serving on one device. Nothing is cached: the
    next dispatch asks again and fails again, and the one-device batcher
    beside it serves the same cells."""
    codec = codec_for()
    cells = rand_cells(4, seed=4)
    runtime.STATS.reset()

    async def t():
        refused = ECBatcher(conf=mesh_conf(n=4096))
        single = ECBatcher()
        for _ in range(2):
            with pytest.raises(RuntimeError, match="batched EC dispatch"):
                await refused.encode_cells(codec, cells)
        with pytest.raises(RuntimeError, match="pin_virtual"):
            refused.mesh("cpu")
        ps, cs = await single.encode_cells(codec, cells)
        assert ps.shape == (4, 2, 256) and cs.shape == (4, 5)

    run(t())
    assert runtime.STATS.dump()["mesh_encode_dispatches"] == 0


def test_host_engine_ignores_mesh_knobs():
    """The mesh is a device-engine lever: the host C++ core keeps its
    two-pass shape (no CRCs from the dispatch) regardless of knobs."""
    codec = codec_for({**DEV_PROFILE, "backend": "host"})
    cells = rand_cells(3, seed=5)
    runtime.STATS.reset()

    async def t():
        b = ECBatcher(conf=mesh_conf())
        parity, crcs = await b.encode_cells(codec, cells)
        assert crcs is None
        assert parity.shape == (3, 2, 256)

    run(t())
    assert runtime.STATS.dump()["mesh_encode_dispatches"] == 0


def test_repair_mode_off_keeps_single_device_decode():
    codec = codec_for()
    cells = rand_cells(4, seed=6)
    runtime.STATS.reset()

    async def t():
        b = ECBatcher(conf=mesh_conf(repair="off"))
        parity, _ = await b.encode_cells(codec, cells)
        every = np.concatenate([cells, parity], axis=1)
        out = await b.decode_cells(codec, (0, 1, 4), (2,),
                                   np.ascontiguousarray(
                                       every[:, [0, 1, 4], :]))
        assert (out[:, 0, :] == cells[:, 2, :]).all()

    run(t())
    d = runtime.STATS.dump()
    assert d["mesh_encode_dispatches"] == 1  # encode still meshes
    assert d["mesh_decode_dispatches"] == 0  # decode stays 1-device


def test_shard_rows_to_host_dedupes_replicas():
    """Width-replicated results (per-stripe CRCs, repair output) are
    read once per unique shard, not once per replica slot."""
    mesh = parallel.make_mesh(parallel.get_devices(8, "cpu"), width=4)
    arr = parallel.per_stripe(mesh, np.arange(8, dtype=np.uint32))
    runtime.STATS.reset()
    out = runtime.shard_rows_to_host(arr)
    assert (out == np.arange(8, dtype=np.uint32)).all()
    # 2 stripe rows x 4 width replicas = 8 shards, 2 unique reads
    assert runtime.STATS.shard_reads == 2
    assert runtime.STATS.host_gathers == 0
    # and the counted escape hatch counts, as does every other
    # whole-array read of a sharded array
    runtime.host_gather(arr)
    assert runtime.STATS.host_gathers == 1
    assert (arr.numpy() == np.arange(8, dtype=np.uint32)).all()
    assert runtime.STATS.host_gathers == 2


# --------------------------------------------------------- cluster tier


def test_cluster_serves_writes_and_degraded_reads_over_mesh():
    """OSD traffic CROSSES the mesh: a live cluster with the mesh knobs
    on serves client writes through sharded fused encode+CRC dispatches
    — zero host gathers — and a degraded read (one OSD down) rebuilds
    its chunk through the collective repair path, byte-exact."""
    from ceph_tpu_torch.cluster.vstart import TestCluster
    from ceph_tpu_torch.placement.osdmap import Pool

    runtime.STATS.reset()
    payload = np.random.default_rng(7).integers(
        0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()  # two stripes

    async def t():
        c = TestCluster(n_osds=5, osd_conf={
            "osd_ec_mesh_devices": 8,
            "osd_ec_mesh_width": 2,
            "parallel_repair_mode": "allgather",
        }, device="cpu")
        await c.start()
        c.client.op_timeout = 60.0
        await c.client.create_pool(Pool(
            id=2, name="mesh", size=5, min_size=3, pg_num=8,
            crush_rule=1, type="erasure",
            ec_profile={"plugin": "rs_tpu", "k": "3", "m": "2",
                        "backend": "device"}))
        await c.wait_active(30)
        for i in range(4):
            await c.client.write_full(2, f"obj-{i}", payload)
        assert await c.client.read(2, "obj-0") == payload
        gathers_after_writes = runtime.STATS.host_gathers
        # degraded read: kill one OSD, the rebuilt chunk must come
        # through the collective decode and still read byte-exact
        await c.kill_osd(4)
        for i in range(4):
            assert await c.client.read(2, f"obj-{i}") == payload
        await c.stop()
        return gathers_after_writes

    gathers = [None]

    async def outer():
        gathers[0] = await asyncio.wait_for(t(), 150)

    asyncio.run(outer())
    d = runtime.STATS.dump()
    assert d["mesh_encode_dispatches"] > 0, d
    assert gathers[0] == 0, "write path gathered through the host"
    assert d["mesh_decode_dispatches"] > 0, \
        "degraded reads did not use collective repair"
    assert d["mesh_host_gathers"] == 0, d


# ----------------------------------------- one schedule, both packages


def _groups(rng):
    """Groups of submissions, each submitted in one reactor tick and
    awaited before the next: encodes of several sizes (a batch under the
    stripe axis, one over it, merged ticks), then decodes of a data and
    a parity row, and of data only, from their survivors."""
    def cells(b):
        return rng.integers(0, 256, (b, 3, 256), dtype=np.uint8)

    enc = [[cells(1)], [cells(5), cells(2)], [cells(9)]]
    data = np.concatenate([c for g in enc for c in g])
    return enc, data


@pytest.mark.parametrize("method", ["allgather", "psum_bits"])
def test_same_schedule_over_the_mesh_as_the_jax_batcher(method):
    rng = np.random.default_rng(20261017)
    enc, data = _groups(rng)
    knobs = {"osd_ec_batch_window": 0.0, "osd_ec_batch_target_stripes": 8,
             "osd_ec_mesh_devices": 8, "osd_ec_mesh_width": 2,
             "parallel_repair_mode": method}

    async def drive(batcher, codec):
        outs = []
        for group in enc:
            outs.append(await asyncio.gather(
                *[batcher.encode_cells(codec, c) for c in group]))
        parity = np.concatenate([np.asarray(p) for g in outs for p, _ in g])
        every = np.concatenate([data, parity], axis=1)
        for present, want in (((0, 2, 4), (1, 3)), ((1, 2, 3), (0,))):
            surv = np.ascontiguousarray(every[:, list(present)])
            outs.append([await batcher.decode_cells(codec, present, want,
                                                    surv)])
        return outs

    jperf = JPerfCounters("j")
    JECBatcher.declare_counters(jperf)
    jconf = jcfg.proxy()
    jconf.apply(knobs)
    perf = PerfCounters("p")
    ECBatcher.declare_counters(perf)
    conf = cfg.proxy()
    conf.apply(knobs)
    jruntime.STATS.reset()
    runtime.STATS.reset()

    async def both():
        want = await drive(JECBatcher(jperf, conf=jconf),
                           jload_codec(dict(DEV_PROFILE)))
        got = await drive(ECBatcher(perf, conf=conf), codec_for())
        return want, got

    want, got = asyncio.run(asyncio.wait_for(both(), 300))
    for g_got, g_want in zip(got, want):
        for r_got, r_want in zip(g_got, g_want):
            if isinstance(r_want, tuple):
                assert np.array_equal(r_got[0], np.asarray(r_want[0]))
                assert r_got[1].dtype == np.uint32
                assert np.array_equal(r_got[1], np.asarray(r_want[1]))
            else:
                assert np.array_equal(r_got, np.asarray(r_want))
    assert np.array_equal(got[-2][0][:, 0], data[:, 1])
    d, jd = perf.dump(), jperf.dump()
    d.pop("ec_queue_wait_us")
    jd.pop("ec_queue_wait_us")
    assert d == jd
    assert d["ec_mesh_encode_dispatches"] > 0
    assert d["ec_mesh_decode_dispatches"] == 2
    s, js = runtime.STATS.dump(), jruntime.STATS.dump()
    for key in ("mesh_encode_dispatches", "mesh_decode_dispatches",
                "mesh_encode_stripes", "mesh_decode_stripes",
                "mesh_host_gathers"):
        assert s[key] == js[key], key


# ------------------------------------------------- the tools and the card


def test_dryrun_multichip_on_the_cpu():
    """``tools/dryrun_multichip`` over the 8-slot virtual CPU mesh at cut
    shapes: encode, CRC, straw2 primaries, the scrub digest and both
    repair modes each equal the one-device step (it raises otherwise)."""
    from ceph_tpu_torch.tools import dryrun_multichip

    out = dryrun_multichip.dryrun_multichip(8, "cpu", chunk_bytes=1024,
                                            min_stripes=8)
    assert out["ok"] and out["virtual"]
    assert out["mesh"] == {"stripe": 2, "width": 4}
    assert out["batch"] == 8 and out["repair"] == ["allgather", "psum_bits"]


def test_chip_loss_thrash_runner_passes_over_a_virtual_mesh(capsys):
    """``ceph_tpu_torch.tools.thrash --chip-loss`` on the CPU: a virtual
    mesh of 8 slots, the reference's schedule with mesh-chip losses, and
    the reference's verdict, which passes; the verdict's mesh ledger
    shows the writes crossed the mesh with no host gather."""
    import json

    from ceph_tpu.cluster.faults import build_schedule
    from ceph_tpu_torch.tools import thrash

    runtime.STATS.reset()
    rc = thrash.main(["--seed", "4242", "--duration", "3", "--device",
                      "cpu", "--chip-loss", "--no-partitions",
                      "--objects", "4", "--settle", "90"])
    verdict = json.loads(capsys.readouterr().out)
    assert rc == 0 and verdict["passed"], verdict
    want = build_schedule(4242, 3.0, 5, max_unavail=2, partitions=False,
                          chip_loss=True, n_chips=8)
    assert verdict["events"] == [[e.t, e.kind, e.target] for e in want]
    assert verdict["mesh"]["mesh_encode_dispatches"] > 0
    assert verdict["mesh"]["mesh_host_gathers"] == 0


def test_mesh_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.mesh_phase`` on ``device="cpu"``, small: K6's plain
    versions at the phase's edge cases, the write step over the three
    mesh shapes, both repair modes, the batcher in both modes, the
    cluster with the mesh knobs on and the dry run, every check of the
    phase held (it raises otherwise). The plain versions count no
    launches, so the kernels they stand for are counted here."""
    import chip_smoke
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.ops import crc32c, crush, rs, xor_combine
    from ceph_tpu_torch.tools import dryrun_multichip

    def counted(mod, name, kernel):
        fn = getattr(mod, name)

        def call(*a, **kw):
            kernel.launches += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)

    counted(rs, "gf_matmul", kernels.GF_MATMUL)
    counted(crc32c, "crc0_cells", kernels.CRC32C)
    counted(crush, "straw2_choose", kernels.STRAW2)
    for entry in chip_smoke.K6_ENTRIES:
        counted(xor_combine, entry, getattr(kernels, entry.upper()))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=20, warmup=3: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "profile_steps", lambda step, reps=10: {
        **{k: None for k in chip_smoke.PROFILE_CLOCK}, "ms_per_step": {}})
    monkeypatch.setattr(chip_smoke, "device_ms", lambda prof: None)
    for name, value in (("MAIN_B", 16), ("MAIN_CHUNK", 1024),
                        ("MESH_PSUM_B", 8), ("K6_EDGE_N", (1, 33, 1027)),
                        ("MESH_ECB_SUBMITS", 4), ("MESH_ECB_STRIPES", 4),
                        ("MESH_CL_OBJECTS", 4), ("CL_OBJECT_BYTES", 64 << 10)):
        monkeypatch.setattr(chip_smoke, name, value)
    real = dryrun_multichip.setup
    monkeypatch.setattr(dryrun_multichip, "setup",
                        lambda n, dev: real(n, dev, chunk_bytes=1024,
                                            min_stripes=8))
    out = chip_smoke.mesh_phase(torch.device("cpu"),
                                np.random.default_rng(11), "cpu")
    for name in ("gf_matmul", "crc32c", *chip_smoke.K6_ENTRIES):
        assert out["launches"][name] > 0, name
    # the one-device references run before the counts are set to 0:
    # straw2 ran once on each slot of the dry run's mesh, and nowhere else
    assert out["launches"]["straw2"] == chip_smoke.MESH_SLOTS
    assert out["edge_err"] == 0
    assert out["lines"]["cluster"]["mesh_stats"]["mesh_host_gathers"] == 0
    assert set(out["timed"]) == {
        *(f"k6_{e}" for e in chip_smoke.K6_ENTRIES), "gf_mesh_repair",
        "gf_mesh_write", "crc_mesh_write"}
    for line in (out["lines"][f"write_{s}x{w}"]
                 for s, w in chip_smoke.MESH_SHAPES):
        assert line["launches_per_call"] == {
            "gf_matmul": 8, "crc32c": 8, "crc_join": 8}
