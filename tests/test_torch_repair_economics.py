"""The repair-economics pipeline through the port on the CPU: the batched
cell APIs of the bitmatrix, Clay and LRC codecs against the JAX
package's batched APIs and against their own per-stripe byte APIs
(``tests/test_repair_economics.py``, case for case), the codecs routed
through the port's ECBatcher, and one schedule (bitmatrix encode and
decode, a Clay sub-chunk rebuild) through both packages' batchers with
equal bytes, CRCs and perf counters.

``test_slice_subruns_selects_per_cell`` and
``test_cluster_clay_subchunk_recovery_storm`` of that file need
``cluster/pg.py`` and the cluster tier, which are not ported yet.

Clay's batched APIs run their MDS matmuls on the C++ host core on the
"host" backend and through the GF(2^8) kernel's route on the "device"
one, whatever the batch's size; the CPU cases run both (``engine``), the
latter on the kernel's plain version.

Tolerance: exact equality (bytes and uint32 CRCs)."""
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.cluster.ecbatch import ECBatcher as JECBatcher
from ceph_tpu.ec import load_codec as jload_codec
from ceph_tpu.utils import config as jcfg
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import native
from ceph_tpu_torch.cluster.ecbatch import ECBatcher, codec_profile_key
from ceph_tpu_torch.device import tensor_to_words
from ceph_tpu_torch.ec import load_codec as _load_codec
from ceph_tpu_torch.ec.clay_plugin import CLAYCodec
from ceph_tpu_torch.ops import rs
from ceph_tpu_torch.utils import config as cfg
from ceph_tpu_torch.utils.perf import PerfCounters
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


def load_codec(profile):
    return _load_codec(profile, device="cpu")


def run(coro, timeout=120):
    asyncio.run(asyncio.wait_for(coro, timeout))


def host(x) -> np.ndarray:
    """A batched result of either package as host uint32."""
    if isinstance(x, torch.Tensor):
        return tensor_to_words(x)
    return np.asarray(x)


def _su_for(codec, base=1024):
    """A stripe_unit that is a fixed point of get_chunk_size."""
    su = base
    for _ in range(8):
        got = codec.get_chunk_size(codec.k * su)
        if got == su:
            return su
        su = got
    raise AssertionError("stripe unit did not stabilize")


@pytest.fixture(params=["host_core", "device"])
def engine(request) -> dict:
    """Clay's engine, as the profile's ``backend`` names it: the C++
    host core, or the kernels' route (here their plain versions)."""
    return {"backend": "host" if request.param == "host_core"
            else "device"}


# --------------------------------------- batched-vs-reference parity


BM_DRAWS = [
    ("blaum_roth", 3, 2, 4), ("blaum_roth", 5, 2, 6),
    ("liberation", 4, 2, 5), ("liberation", 6, 2, 7),
    ("liber8tion", 5, 2, 8), ("cauchy_bm", 4, 3, 8),
]


@pytest.mark.parametrize("tech,k,m,w", BM_DRAWS)
def test_bitmatrix_batched_parity(tech, k, m, w):
    """encode_crc_batch/decode_batch == the JAX package's batched API
    and the per-stripe encode_chunks/decode_chunks, byte for byte,
    across random erasure draws; the host-engine hooks agree."""
    prof = {"plugin": "bitmatrix", "technique": tech, "k": str(k),
            "m": str(m), "w": str(w)}
    codec, jcodec = load_codec(prof), jload_codec(prof)
    su = _su_for(codec)
    rng = np.random.default_rng(k * 1000 + m * 100 + w)
    cells = rng.integers(0, 256, (4, k, su), dtype=np.uint8)
    ref = np.stack([codec.encode_chunks(c) for c in cells])
    parity_w, crcs = codec.encode_crc_batch(rs.pack_u32(cells), su)
    jparity_w, jcrcs = jcodec.encode_crc_batch(
        jnp.asarray(rs.pack_u32(cells)), su)
    np.testing.assert_array_equal(host(parity_w), host(jparity_w))
    np.testing.assert_array_equal(host(crcs), host(jcrcs))
    parity = rs.unpack_u32(host(parity_w))
    np.testing.assert_array_equal(parity, ref)
    every = np.concatenate([cells, parity], axis=1)
    want_crc = np.stack([native.crc32c_batch(e) for e in every])
    np.testing.assert_array_equal(host(crcs), want_crc)
    np.testing.assert_array_equal(codec.encode_cells_host(cells), ref)
    n = k + m
    for _ in range(4):
        r = int(rng.integers(1, m + 1))
        erase = tuple(sorted(int(i) for i in rng.choice(n, size=r,
                                                         replace=False)))
        present = tuple(i for i in range(n) if i not in erase)[:k]
        surv = np.ascontiguousarray(every[:, list(present), :])
        got_w = codec.decode_batch(present, rs.pack_u32(surv), want=erase)
        np.testing.assert_array_equal(host(got_w), host(jcodec.decode_batch(
            present, jnp.asarray(rs.pack_u32(surv)), want=erase)))
        got = rs.unpack_u32(host(got_w))
        for b in range(len(cells)):
            dec = codec.decode_chunks(list(present), surv[b])
            for wi, g in enumerate(erase):
                np.testing.assert_array_equal(
                    got[b, wi], dec[g], err_msg=f"{tech} erase={erase} {g}")
        np.testing.assert_array_equal(
            codec.decode_cells_host(present, erase, surv), got)


CLAY_DRAWS = [(4, 2, 5), (3, 2, 4), (4, 3, 6), (3, 3, 4)]


@pytest.mark.parametrize("k,m,d", CLAY_DRAWS)
def test_clay_batched_parity(k, m, d, engine):
    """Clay encode_crc_batch/decode_batch == the JAX package's batched
    API and the per-stripe reference across random erasure draws,
    shortened (nu > 0) geometries included; host hooks agree."""
    prof = {"plugin": "clay", "k": str(k), "m": str(m), "d": str(d),
            **engine}
    codec, jcodec = load_codec(prof), jload_codec(prof)
    su = _su_for(codec)
    rng = np.random.default_rng(k * 1009 + m * 31 + d)
    cells = rng.integers(0, 256, (3, k, su), dtype=np.uint8)
    ref = np.stack([codec.encode_chunks(c) for c in cells])
    parity_w, crcs = codec.encode_crc_batch(rs.pack_u32(cells), su)
    assert isinstance(parity_w, torch.Tensor) and isinstance(crcs,
                                                             torch.Tensor)
    jparity_w, jcrcs = jcodec.encode_crc_batch(rs.pack_u32(cells), su)
    np.testing.assert_array_equal(host(parity_w), host(jparity_w))
    np.testing.assert_array_equal(host(crcs), host(jcrcs))
    parity = rs.unpack_u32(host(parity_w))
    np.testing.assert_array_equal(parity, ref)
    every = np.concatenate([cells, parity], axis=1)
    want_crc = np.stack([native.crc32c_batch(e) for e in every])
    np.testing.assert_array_equal(host(crcs), want_crc)
    np.testing.assert_array_equal(codec.encode_cells_host(cells), ref)
    n = k + m
    for _ in range(3):
        r = int(rng.integers(1, m + 1))
        erase = tuple(sorted(int(i) for i in rng.choice(n, size=r,
                                                         replace=False)))
        present = tuple(i for i in range(n) if i not in erase)
        surv = np.ascontiguousarray(every[:, list(present), :])
        got_w = codec.decode_batch(present, rs.pack_u32(surv), want=erase)
        np.testing.assert_array_equal(host(got_w), host(jcodec.decode_batch(
            present, rs.pack_u32(surv), want=erase)))
        got = rs.unpack_u32(host(got_w))
        for b in range(len(cells)):
            dec = codec.decode_chunks(list(present), surv[b])
            for wi, g in enumerate(erase):
                np.testing.assert_array_equal(
                    got[b, wi], dec[g],
                    err_msg=f"clay k={k} m={m} d={d} erase={erase}")
        np.testing.assert_array_equal(
            codec.decode_cells_host(present, erase, surv), got)


def repair_slices(codec, every, lost):
    """(order, (B, d, su/q) helper slices) of a single-loss repair plan,
    or None when the loss does not take the repair path."""
    n = codec.k + codec.m
    avail = sorted(set(range(n)) - {lost})
    if not codec.is_repair({lost}, set(avail)):
        return None
    plan = codec.minimum_to_decode([lost], avail)
    assert lost not in plan and len(plan) == codec.d
    order = sorted(plan)
    runs = plan[order[0]]
    sub = every.shape[-1] // codec.get_sub_chunk_count()
    surv = np.stack([
        np.concatenate([every[:, c, o * sub:(o + cnt) * sub]
                        for o, cnt in runs], axis=1)
        for c in order], axis=1)
    return tuple(order), surv


@pytest.mark.parametrize("k,m,d", CLAY_DRAWS)
def test_clay_repair_batch_parity(k, m, d, engine):
    """repair_batch over is_repair sub-chunk plans == the JAX package's
    repair_batch and the original cells, for every single-loss chunk
    the plan covers — each helper ships exactly 1/q of its cells."""
    prof = {"plugin": "clay", "k": str(k), "m": str(m), "d": str(d),
            **engine}
    codec, jcodec = load_codec(prof), jload_codec(prof)
    su = _su_for(codec)
    rng = np.random.default_rng(k * 7907 + m * 17 + d)
    cells = rng.integers(0, 256, (3, k, su), dtype=np.uint8)
    parity = np.stack([codec.encode_chunks(c) for c in cells])
    every = np.concatenate([cells, parity], axis=1)
    repaired = 0
    for lost in range(k + m):
        planned = repair_slices(codec, every, lost)
        if planned is None:
            continue
        order, surv = planned
        assert surv.shape[-1] == su // codec.q
        got_w = codec.repair_batch(order, rs.pack_u32(surv), (lost,))
        np.testing.assert_array_equal(host(got_w), host(jcodec.repair_batch(
            order, rs.pack_u32(surv), (lost,))))
        got = rs.unpack_u32(host(got_w))
        np.testing.assert_array_equal(got[:, 0, :], every[:, lost, :],
                                      err_msg=f"lost={lost}")
        np.testing.assert_array_equal(
            codec.repair_cells_host(order, (lost,), surv), got)
        repaired += 1
    assert repaired


def test_clay_device_backend_keeps_a_small_batch_off_the_host_core(
        monkeypatch):
    """On the "device" backend a batch of one small stripe runs every
    score round's MDS matmul through ``ops.rs.gf_matmul`` and its CRCs
    through the CRC kernel's route: no batch is too small for the
    kernels, and the C++ host core is never asked. A 24-byte cell
    (3-byte sub-chunks: rounds of an odd lane count) takes the same
    route."""
    codec = load_codec({"plugin": "clay", "k": "4", "m": "2", "d": "5"})
    assert isinstance(codec, CLAYCodec)
    assert codec.resolved_backend() == "device"
    rng = np.random.default_rng(77)
    cases = []
    for su in (_su_for(codec), 24):
        cells = rng.integers(0, 256, (1, 4, su), dtype=np.uint8)
        every = np.concatenate([cells, codec.encode_cells_host(cells)],
                               axis=1)
        cases.append((su, cells, every, repair_slices(codec, every, 1)))
    matmuls = []
    gf_matmul = rs.gf_matmul

    def counted_gf_matmul(*args, **kw):
        matmuls.append(1)
        return gf_matmul(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the device backend reached the host core")

    monkeypatch.setattr(rs, "gf_matmul", counted_gf_matmul)
    monkeypatch.setattr(native, "rs_matmul", refused)
    monkeypatch.setattr(native, "crc32c_batch", refused)
    crcs = []
    for su, cells, every, (order, slices) in cases:
        parity_w, crc = codec.encode_crc_batch(rs.pack_u32(cells), su)
        crcs.append(crc)
        np.testing.assert_array_equal(rs.unpack_u32(host(parity_w)),
                                      every[:, 4:])
        present = (0, 2, 3, 4)
        got = codec.decode_batch(present,
                                 rs.pack_u32(every[:, list(present)]),
                                 want=(1, 5))
        np.testing.assert_array_equal(rs.unpack_u32(host(got)),
                                      every[:, [1, 5]])
        rebuilt = codec.repair_batch(order, rs.pack_u32(slices), (1,))
        np.testing.assert_array_equal(rs.unpack_u32(host(rebuilt))[:, 0],
                                      every[:, 1])
    assert len(matmuls) >= 6
    monkeypatch.undo()
    for crc, (_, _, every, _) in zip(crcs, cases):
        np.testing.assert_array_equal(host(crc),
                                      native.crc32c_batch(every[0])[None])


def test_lrc_batched_local_and_global_parity():
    """LRC's composite generator rides the rs-style batched hooks:
    local repairs consume FEWER than k rows, global decodes any
    spanning set — both byte-identical to the layered decode() and to
    the JAX package's batched API."""
    prof = {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}
    codec, jcodec = load_codec(prof), jload_codec(prof)
    n = codec.k + codec.m
    su = _su_for(codec)
    rng = np.random.default_rng(4242)
    objs = [rng.integers(0, 256, codec.k * su, dtype=np.uint8)
            for _ in range(3)]
    by_pos: dict[int, list] = {}
    for o in objs:
        for p, c in codec.encode(list(range(n)), o.tobytes()).items():
            by_pos.setdefault(p, []).append(c)
    data = np.stack([np.stack(by_pos[codec.chunk_index(i)])
                     for i in range(codec.k)], axis=1)
    parity_w, crcs = codec.encode_crc_batch(rs.pack_u32(data), su)
    jparity_w, jcrcs = jcodec.encode_crc_batch(
        jnp.asarray(rs.pack_u32(data)), su)
    np.testing.assert_array_equal(host(parity_w), host(jparity_w))
    np.testing.assert_array_equal(host(crcs), host(jcrcs))
    for lost_set in ([0], [1], [0, 1], [0, 4]):
        avail = sorted(set(range(n)) - set(lost_set))
        need = sorted(codec.minimum_to_decode(lost_set, avail))
        assert need == sorted(jcodec.minimum_to_decode(lost_set, avail))
        if len(lost_set) == 1:
            assert len(need) < codec.k  # locality: cheaper than MDS
        pg = tuple(codec._position_to_generator(p) for p in need)
        wg = tuple(codec._position_to_generator(p) for p in lost_set)
        surv = np.stack([np.stack(by_pos[p]) for p in need], axis=1)
        got_w = codec.decode_batch(pg, rs.pack_u32(surv), want=wg)
        np.testing.assert_array_equal(host(got_w), host(jcodec.decode_batch(
            pg, jnp.asarray(rs.pack_u32(surv)), want=wg)))
        got = rs.unpack_u32(host(got_w))
        for i, p in enumerate(lost_set):
            np.testing.assert_array_equal(got[:, i, :], np.stack(by_pos[p]),
                                          err_msg=f"lrc lost={lost_set} {p}")


# ------------------------------------------------ ECBatcher routing


def test_batcher_routes_cellwise_codecs():
    """Cellwise codecs dispatch through the SAME bucket machinery as
    rs_tpu on both engines, the repair kind included, and distinct
    geometries (two w's) never share a bucket."""
    k1 = codec_profile_key(load_codec(
        {"plugin": "bitmatrix", "technique": "liberation",
         "k": "4", "m": "2", "w": "5"}))
    k2 = codec_profile_key(load_codec(
        {"plugin": "bitmatrix", "technique": "liberation",
         "k": "4", "m": "2", "w": "7"}))
    assert k1 != k2
    kc1 = codec_profile_key(load_codec(
        {"plugin": "clay", "k": "3", "m": "2", "d": "3"}))
    kc2 = codec_profile_key(load_codec(
        {"plugin": "clay", "k": "3", "m": "2", "d": "4"}))
    assert kc1 != kc2

    async def t(backend):
        perf = PerfCounters("t")
        ECBatcher.declare_counters(perf)
        b = ECBatcher(perf)
        out = {}
        for plug, prof in (
            ("bm", {"plugin": "bitmatrix", "technique": "blaum_roth",
                    "k": "3", "m": "2", "w": "4", "backend": backend}),
            ("clay", {"plugin": "clay", "k": "3", "m": "2",
                      "backend": backend}),
        ):
            codec = load_codec(prof)
            su = _su_for(codec)
            cells = np.random.default_rng(3).integers(
                0, 256, (2, codec.k, su), dtype=np.uint8)
            parity, crcs = await b.encode_cells(codec, cells)
            ref = np.stack([codec.encode_chunks(c) for c in cells])
            np.testing.assert_array_equal(parity, ref)
            if backend == "device":
                assert crcs is not None and crcs.shape == (2, 5)
                every = np.concatenate([cells, parity], axis=1)
                np.testing.assert_array_equal(
                    crcs, np.stack([native.crc32c_batch(e) for e in every]))
            else:
                assert crcs is None  # host engines keep their own pass
            every = np.concatenate([cells, parity], axis=1)
            present = (0, 2, 3)
            dec = await b.decode_cells(
                codec, present, (1,),
                np.ascontiguousarray(every[:, list(present), :]))
            np.testing.assert_array_equal(dec[:, 0, :], cells[:, 1, :])
            out[plug] = codec
        codec = out["clay"]
        su = _su_for(codec)
        cells = np.random.default_rng(5).integers(
            0, 256, (2, codec.k, su), dtype=np.uint8)
        parity, _ = await b.encode_cells(codec, cells)
        every = np.concatenate([cells, parity], axis=1)
        order, surv = repair_slices(codec, every, 0)
        got = await b.repair_cells(codec, order, (0,), surv)
        np.testing.assert_array_equal(got[:, 0, :], every[:, 0, :])
        d = perf.dump()
        assert d["ec_batches"] >= 2
        assert d["ec_decode_batches"] >= 3  # 2 decodes + 1 repair

    run(t("device"))
    run(t("host"))


# ------------------------------------ one schedule through both batchers


def _codec_pair(profile):
    return load_codec(profile), jload_codec(profile)


def test_same_schedule_same_bytes_crcs_and_counters_as_reference():
    """liber8tion encodes (a tick flush and a size flush), cold and
    promoted decodes of one pattern and a wanted parity row, then Clay
    encodes and sub-chunk rebuilds of one lost shard (cold, then on the
    device route), through the JAX package's ECBatcher and the port's:
    equal bytes, uint32 CRCs and perf counters (queue-wait values
    aside)."""
    bm_prof = {"plugin": "jerasure", "technique": "liber8tion", "k": "4",
               "m": "2", "backend": "device"}
    clay_prof = {"plugin": "clay", "k": "4", "m": "2", "d": "5",
                 "backend": "device"}
    rng = np.random.default_rng(20261017)
    bm, jbm = _codec_pair(bm_prof)
    clay, jclay = _codec_pair(clay_prof)
    su_bm, su_clay = _su_for(bm, 512), _su_for(clay, 512)
    enc_bm = [rng.integers(0, 256, (b, 4, su_bm), dtype=np.uint8)
              for b in (1, 3, 5)]
    data = np.concatenate(enc_bm)
    every_bm = np.concatenate([data, np.stack(
        [bm.encode_chunks(c) for c in data])], axis=1)
    present = (0, 2, 4, 5)
    surv = np.ascontiguousarray(every_bm[:, list(present)])
    enc_clay = [rng.integers(0, 256, (b, 4, su_clay), dtype=np.uint8)
                for b in (2, 4)]
    cdata = np.concatenate(enc_clay)
    every_clay = np.concatenate([cdata, np.stack(
        [clay.encode_chunks(c) for c in cdata])], axis=1)
    order, slices = repair_slices(clay, every_clay, 1)
    # (codec slot, kind, present, want, cells); each group goes in one
    # reactor tick and is awaited before the next
    groups = [
        [(0, "enc", None, None, enc_bm[0])],
        [(0, "enc", None, None, enc_bm[1]), (0, "enc", None, None,
                                             enc_bm[2])],
        [(0, "dec", present, (1, 3), surv[:4])],       # cold: host
        [(0, "dec", present, (1, 3), surv)],           # crosses: warm
        [(0, "dec", present, (1, 3), surv)],           # promoted
        [(1, "enc", None, None, c) for c in enc_clay],
        [(1, "rep", order, (1,), slices[:3])],          # cold: host
        [(1, "rep", order, (1,), slices)],              # crosses: warm
        [(1, "rep", order, (1,), slices)],              # promoted
    ]
    knobs = {"osd_ec_batch_window": 0.0, "osd_ec_batch_target_stripes": 4,
             # the first decode and the first repair each reach it
             "osd_ec_cold_shape_bytes": min(surv[:4].nbytes,
                                            slices[:3].nbytes)}

    async def drive(batcher, codecs):
        outs = []
        for group in groups:
            futs = []
            for slot, kind, pres, want, cells in group:
                codec = codecs[slot]
                if kind == "enc":
                    futs.append(batcher.encode_cells(codec, cells))
                elif kind == "dec":
                    futs.append(batcher.decode_cells(codec, pres, want,
                                                     cells))
                else:
                    futs.append(batcher.repair_cells(codec, pres, want,
                                                     cells))
            outs.append(await asyncio.gather(*futs))
            for _ in range(2000):
                if all(batcher._shape_warm.values()):
                    break
                await asyncio.sleep(0.01)
        return outs

    jperf = JPerfCounters("j")
    JECBatcher.declare_counters(jperf)
    jconf = jcfg.proxy()
    jconf.apply(knobs)
    perf = PerfCounters("t")
    ECBatcher.declare_counters(perf)
    conf = cfg.proxy()
    conf.apply(knobs)

    async def both():
        want = await drive(JECBatcher(jperf, conf=jconf), (jbm, jclay))
        got = await drive(ECBatcher(perf, conf=conf), (bm, clay))
        return want, got

    want, got = asyncio.run(asyncio.wait_for(both(), 300))
    for gi, (g_got, g_want) in enumerate(zip(got, want)):
        for r_got, r_want in zip(g_got, g_want):
            if isinstance(r_want, tuple):
                (parity, crcs), (jparity, jcrcs) = r_got, r_want
                assert parity.dtype == np.uint8 and crcs.dtype == np.uint32
                np.testing.assert_array_equal(parity, np.asarray(jparity))
                np.testing.assert_array_equal(crcs, np.asarray(jcrcs))
            else:
                assert r_got.dtype == np.uint8
                np.testing.assert_array_equal(r_got, np.asarray(r_want))
    parity = np.concatenate([p for p, _ in got[0] + got[1]])
    np.testing.assert_array_equal(parity, every_bm[:, 4:])
    np.testing.assert_array_equal(got[4][0], every_bm[:, [1, 3]])
    np.testing.assert_array_equal(got[8][0][:, 0], every_clay[:, 1])
    d, jd = perf.dump(), jperf.dump()
    d.pop("ec_queue_wait_us")
    assert jd.pop("ec_queue_wait_us")["count"] > 0
    assert d == jd
    assert d["ec_decode_cold_host"] == 4  # per kind: cold and crossing
    assert d["ec_decode_batches"] == 6
