"""The CUDA kernels against their plain versions on the card (exact
equality: integer-only functions). These need a CUDA device, nvcc and an
sm_90a card; elsewhere they skip. This file imports neither JAX nor the
JAX package, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import asyncio
import time

import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu_torch import kernels, native
from ceph_tpu_torch.cluster import ECBatcher
from ceph_tpu_torch.device import words_to_tensor
from ceph_tpu_torch.ec import load_codec
from ceph_tpu_torch.models import datapath
from ceph_tpu_torch.ops import crc32c, gf8, rs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, shape, dev):
    return words_to_tensor(rng.integers(0, 2**32, shape, dtype=np.uint32), dev)


@pytest.mark.parametrize("r,c,b,w", [(3, 8, 2, 4096), (1, 2, 1, 1),
                                     (2, 5, 3, 1000), (12, 20, 1, 300),
                                     (40, 60, 1, 33), (8, 8, 2, 257),
                                     (16, 40, 1, 1000), (4, 240, 2, 257),
                                     (3, 8, 1, 6), (256, 256, 1, 9)])
def test_gf_matmul_kernel_equals_plain(cuda, r, c, b, w):
    rng = np.random.default_rng(r * c)
    mat = rng.integers(0, 256, (r, c), dtype=np.uint8)
    mat[0, :] = 0
    x = _words(rng, (b, c, w), cuda)
    before = kernels.GF_MATMUL.launches
    got = rs.gf_matmul(mat, x)
    assert kernels.GF_MATMUL.launches == before + 1
    assert torch.equal(got, rs.gf_matmul_plain(mat, x))


@pytest.mark.parametrize("n,w", [(70000, 1), (3, 100), (4, 16384), (2, 257),
                                 (5, 3), (2, 140000), (300, 1000)])
def test_crc32c_kernel_equals_plain(cuda, n, w):
    x = _words(np.random.default_rng(w), (n, w), cuda)
    before = kernels.CRC32C.launches
    got = crc32c.crc0_words(x)
    assert kernels.CRC32C.launches == before + 1
    assert torch.equal(got, crc32c.crc0_words_plain(x))


@pytest.mark.parametrize("k,m,w", [(8, 3, 4096), (4, 2, 257), (3, 1, 1),
                                   (8, 3, 16384)])
def test_two_source_crcs_equal_crcs_of_the_concatenation(cuda, k, m, w):
    rng = np.random.default_rng(k * m + w)
    data = _words(rng, (3, k, w), cuda)
    parity = _words(rng, (3, m, w), cuda)
    before = kernels.CRC32C.launches
    got = crc32c.crc0_cells(data, parity)
    assert kernels.CRC32C.launches == before + 1
    assert torch.equal(got, crc32c.crc0_words_plain(
        torch.cat([data, parity], dim=1)))


def test_write_and_repair_step_on_the_card(cuda):
    params = datapath.ECParams(k=8, m=3, chunk_bytes=4096)
    data = datapath.example_batch(params, batch=4, device=cuda)
    gf0, crc0 = kernels.GF_MATMUL.launches, kernels.CRC32C.launches
    parity, crcs = datapath.write_step(params, data)
    assert kernels.GF_MATMUL.launches == gf0 + 1  # one launch of each kernel
    assert kernels.CRC32C.launches == crc0 + 1
    cpu_parity, cpu_crcs = datapath.write_step(params, data.cpu())
    assert torch.equal(parity.cpu(), cpu_parity)
    assert torch.equal(crcs.cpu(), cpu_crcs)
    present = (0, 2, 3, 4, 5, 7, 8, 9)
    surv = torch.cat([data, parity], dim=1)[:, list(present)]
    rebuilt, rcrcs = datapath.repair_step(params, present, surv)
    assert torch.equal(rebuilt, data)
    assert torch.equal(rcrcs, crcs[:, :8])


def test_kernel_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((1, 4, 8), dtype=torch.int32, device=cuda)
    frags = words_to_tensor(rs.b1_fragments(gf8.raid6_matrix(4)), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gf_matmul(x.transpose(1, 2), frags, 2)
    with pytest.raises(ValueError):
        kernels.gf_matmul(x, frags, 5)  # frags are for 2 rows: one quad
    with pytest.raises(TypeError):
        kernels.gf_matmul(x.to(torch.int64), frags, 2)
    w = 64
    seg, subs, nseg = crc32c.crc_plan(w)
    cfrags = words_to_tensor(crc32c.b1_fragments(seg), cuda)
    zcols = words_to_tensor(crc32c.join_columns(w), cuda)
    cells = torch.zeros((2, 3, w), dtype=torch.int32, device=cuda)
    args = (cfrags, zcols, seg, subs, nseg.bit_length() - 1)
    assert kernels.crc32c(cells, cells[:, :1].contiguous(), *args).shape == (2, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.crc32c(cells[:, :, ::2], None, *args)
    with pytest.raises(TypeError):
        kernels.crc32c(cells.to(torch.int64), None, *args)
    with pytest.raises(ValueError, match="does not pair"):
        kernels.crc32c(cells, cells[:1], *args)  # stripe counts differ
    with pytest.raises(ValueError, match="does not pair"):
        kernels.crc32c(cells, cells[..., :32].contiguous(), *args)  # widths
    with pytest.raises(ValueError, match="do not pair up"):
        crc32c.crc0_cells(cells, cells.cpu())
    with pytest.raises(ValueError, match="do not fit"):
        kernels.crc32c(cells, None, cfrags, zcols, 2 * seg, subs,
                       nseg.bit_length() - 1)


# ------------------------------------------------- the EC batcher


def _native_parity(codec, cells):
    b, k, su = cells.shape
    flat = np.ascontiguousarray(cells.transpose(1, 0, 2)).reshape(k, -1)
    return native.rs_encode(codec.matrix, flat).reshape(
        codec.m, b, su).transpose(1, 0, 2)


def test_batcher_on_the_card_equals_native_on_a_transposed_view(cuda):
    codec = load_codec({"plugin": "rs_tpu", "k": "8", "m": "3"}, device=cuda)
    rng = np.random.default_rng(3)
    shard_major = rng.integers(0, 256, (8, 64, 4096), dtype=np.uint8)
    view = shard_major.transpose(1, 0, 2)  # the RMW path's (T, k, su)
    gf0, crc0 = kernels.GF_MATMUL.launches, kernels.CRC32C.launches

    async def t():
        b = ECBatcher(conf={"osd_ec_cold_shape_bytes": 0})
        parity, crcs = await b.encode_cells(codec, view)
        every = np.concatenate([view, parity], axis=1)
        present = (0, 2, 3, 4, 5, 7, 8, 9)
        rebuilt = await b.decode_cells(
            codec, present, (1, 6, 10),
            np.ascontiguousarray(every[:, list(present)]))
        return parity, crcs, every, rebuilt

    parity, crcs, every, rebuilt = asyncio.run(t())
    assert kernels.GF_MATMUL.launches == gf0 + 2
    assert kernels.CRC32C.launches == crc0 + 1
    assert parity.dtype == np.uint8 and crcs.dtype == np.uint32
    assert np.array_equal(parity, _native_parity(codec, view))
    assert np.array_equal(crcs, native.crc32c_batch(
        np.ascontiguousarray(every).reshape(-1, 4096)).reshape(64, 11))
    assert np.array_equal(rebuilt, every[:, [1, 6, 10]])


def test_two_buckets_in_flight_stay_exact_on_separate_streams(cuda):
    codecs = [load_codec({"plugin": "rs_tpu", "k": str(k), "m": str(m)},
                         device=cuda) for k, m in ((8, 3), (4, 2))]
    streams = {}
    for codec in codecs:
        real = codec.encode_crc_batch
        real(torch.zeros((1, codec.k, 1024), dtype=torch.int32,
                         device=cuda), 4096)  # build kernels and operands

        def held(x, su, real=real, codec=codec):
            out = real(x, su)
            streams.setdefault(codec.k, set()).add(
                torch.cuda.current_stream().cuda_stream)
            time.sleep(0.2)  # keep this bucket in flight
            return out

        codec.encode_crc_batch = held
    rng = np.random.default_rng(4)
    cells = [rng.integers(0, 256, (32, c.k, 4096), dtype=np.uint8)
             for c in codecs]

    async def t():
        b = ECBatcher()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*[b.encode_cells(c, x)
                                      for c, x in zip(codecs, cells)])
        return outs, time.perf_counter() - t0

    outs, secs = asyncio.run(t())
    assert secs < 0.38  # the two 0.2 s holds overlapped
    assert len(streams[8] | streams[4]) == 2  # one stream per thread
    for codec, x, (parity, crcs) in zip(codecs, cells, outs):
        assert np.array_equal(parity, _native_parity(codec, x))
        every = np.concatenate([x, parity], axis=1)
        assert np.array_equal(crcs, native.crc32c_batch(
            every.reshape(-1, 4096)).reshape(32, codec.k + codec.m))


def test_held_result_is_not_overwritten_by_later_batches(cuda):
    codec = load_codec({"plugin": "rs_tpu", "k": "8", "m": "3"}, device=cuda)
    rng = np.random.default_rng(5)

    async def t():
        b = ECBatcher()
        first = rng.integers(0, 256, (64, 8, 4096), dtype=np.uint8)
        parity, crcs = await b.encode_cells(codec, first)
        held = parity.copy(), crcs.copy()
        for _ in range(8):
            later = rng.integers(0, 256, (64, 8, 4096), dtype=np.uint8)
            p2, _ = await b.encode_cells(codec, later)
            assert not np.shares_memory(p2, parity)
        return first, parity, crcs, held

    first, parity, crcs, held = asyncio.run(t())
    assert np.array_equal(parity, held[0]) and np.array_equal(crcs, held[1])
    assert np.array_equal(parity, _native_parity(codec, first))


# ------------------------------------------------- CRUSH placement


def _u0xffff_xs(ids, r, want=64):
    """Inputs x whose draw hash for the first id is 0xffff: crush_ln's
    x == 0x10000 wrap."""
    from ceph_tpu_torch.ops import crush

    xs = torch.arange(0, 1 << 22, dtype=torch.int64)
    hit = xs[(crush.hash32_3(xs, int(ids[0]), r) & 0xFFFF) == 0xFFFF]
    assert hit.numel() > 0
    return hit[:want].numpy().astype(np.uint32)


@pytest.mark.parametrize("case", ["n1", "ragged", "zero_equal", "ids",
                                  "wrap", "tiles", "all_zero"])
def test_straw2_kernel_equals_plain_and_host(cuda, case):
    from ceph_tpu_torch.ops import crush

    rng = np.random.default_rng(len(case))
    n = {"n1": 1, "tiles": 2500, "all_zero": 5}.get(case, 1000)
    items = np.arange(n, dtype=np.int32) + 7
    ids = (rng.integers(-2**31, 2**31, n).astype(np.int32) if case == "ids"
           else items)
    weights = rng.integers(1, 4 * 0x10000, n, dtype=np.uint32)
    if case == "zero_equal":
        weights[::7] = 0
        weights[1::5] = 0x10000
    if case == "all_zero":
        weights[:] = 0
    nx = 4097 if case == "ragged" else 20000
    xs = rng.integers(0, 2**32, nx, dtype=np.uint32)
    if case == "wrap":
        xs = np.concatenate([_u0xffff_xs(ids, 3), xs])
    r = 3
    t = {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)).to(cuda)
         for k, v in (("items", items), ("ids", ids), ("w", weights),
                      ("xs", xs))}
    before = kernels.STRAW2.launches
    got = crush.straw2_choose(t["items"], t["ids"], t["w"], t["xs"], r)
    assert kernels.STRAW2.launches == before + 1
    plain = crush.straw2_choose_plain(t["items"], t["ids"], t["w"], t["xs"], r)
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy(),
                          native.straw2_bulk(items, weights, xs, r, ids=ids))


def _placement_maps():
    from ceph_tpu_torch.placement import crushmap as cm

    flat = cm.build_flat(10, osd_weights=[1, 2, 3, 4, 0.5, 1, 1, 2, 8, 1])
    flat.add_rule(cm.flat_firstn_rule(0))
    flat.add_rule(cm.ec_rule(1, root=-1, failure_domain_type=0))
    fw = np.full(10, 0x10000, np.uint32)
    fw[[2, 6]] = 0
    fw[5] = 0x8000
    tree = cm.build_hierarchy(osds_per_host=20, n_hosts=50)
    tree.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    tree.add_rule(cm.ec_rule(1, root=-1, failure_domain_type=1))
    tw = np.full(1000, 0x10000, np.uint32)
    outs = np.random.default_rng(9).choice(1000, 40, replace=False)
    tw[outs[:20]] = 0
    tw[outs[20:]] = 0x8000
    legacy = cm.build_hierarchy(osds_per_host=4, n_hosts=5)
    legacy.tunables = cm.Tunables(chooseleaf_stable=0, chooseleaf_vary_r=0)
    legacy.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    return {"flat_firstn": (flat, 0, 4, fw), "flat_indep": (flat, 1, 9, fw),
            "short_reweights": (flat, 0, 3, fw[:7]),
            "host_firstn": (tree, 0, 3, tw), "host_indep": (tree, 1, 11, tw),
            "legacy_tunables": (legacy, 0, 3, None)}


@pytest.mark.parametrize("case", ["flat_firstn", "flat_indep",
                                  "short_reweights", "host_firstn",
                                  "host_indep", "legacy_tunables"])
def test_crush_rule_kernel_equals_plain_and_host(cuda, case):
    from ceph_tpu_torch.placement import bulk

    m, ruleno, numrep, w = _placement_maps()[case]
    comp = bulk.CompiledMap(m)
    xs = np.random.default_rng(len(case)).integers(0, 2**32, 4099,
                                                   dtype=np.uint32)
    before = kernels.CRUSH_RULE.launches
    got = bulk.do_rule_bulk(comp, ruleno, xs, numrep, w, device=cuda)
    assert kernels.CRUSH_RULE.launches == before + 1
    assert np.array_equal(got, bulk.do_rule_bulk(comp, ruleno, xs, numrep, w,
                                                 device="cpu"))
    for i in range(0, len(xs), 97):
        row = m.do_rule(ruleno, int(xs[i]), numrep, w)
        assert list(got[i]) == row + [bulk.ITEM_NONE] * (numrep - len(row))


@pytest.mark.parametrize("case", list(chip_smoke.rule_edge_maps()))
def test_crush_rule_kernel_at_the_group_edges(cuda, case):
    """Buckets either side of one and two groups of 32 lanes, zero weights,
    an empty bucket, uneven depth, rows of 256 and the legacy tunables,
    over a ragged count of inputs, at both widths group_width can choose
    for the map (a batch the card holds whole, one that fills it): rows
    and draw counts equal the plain version's (on the CPU; on the card
    for rows of 256, which take the CPU minutes), rows equal
    CrushMap.do_rule's, one launch per call."""
    from ceph_tpu_torch.placement import bulk

    m, ruleno, numrep, w = chip_smoke.rule_edge_maps()[case]
    comp = bulk.CompiledMap(m)
    if w is None:
        w = np.full(comp.max_devices, 0x10000, np.uint32)
    rule = comp.compile_rule(ruleno, numrep)
    xs = np.random.default_rng(len(case)).integers(
        0, 2**32, chip_smoke.PL_EDGE_X, dtype=np.uint32)
    before = kernels.CRUSH_RULE.launches
    got = bulk.do_rule_bulk(comp, ruleno, xs, numrep, w, device=cuda)
    assert kernels.CRUSH_RULE.launches == before + 1

    def on(dev):
        return [torch.from_numpy(a.view(np.int32)).to(dev) for a in (w, xs)]

    plain_dev = cuda if numrep > 64 else torch.device("cpu")
    plain_draws = torch.zeros(1, dtype=torch.int64, device=plain_dev)
    plain = bulk.rule_rows_plain(comp, *on(plain_dev), rule, numrep,
                                 plain_draws)
    assert np.array_equal(got, plain.cpu().numpy())
    widest, lanes = comp.widest(rule.take), bulk.card_lanes(cuda)
    for n in (1, 10**7):
        group = bulk.group_width(widest, n, lanes)
        before = kernels.CRUSH_RULE.launches
        draws = torch.zeros(1, dtype=torch.int64, device=cuda)
        again = bulk.rule_rows(comp, *on(cuda), rule, numrep, draws, group)
        assert kernels.CRUSH_RULE.launches == before + 1
        assert np.array_equal(again.cpu().numpy(), got), group
        assert int(draws.item()) == int(plain_draws.item()) > 0, group
    for i in range(0, len(xs), 97):
        row = m.do_rule(ruleno, int(xs[i]), numrep, w)
        assert list(got[i]) == row + [bulk.ITEM_NONE] * (numrep - len(row))


def test_crush_rule_wrapper_refuses_a_bad_group(cuda):
    from ceph_tpu_torch.ops import crush
    from ceph_tpu_torch.placement import bulk
    from ceph_tpu_torch.placement import crushmap as cm

    m = cm.build_flat(4)
    m.add_rule(cm.flat_firstn_rule(0))
    comp = bulk.CompiledMap(m)
    arrays = comp.arrays_on(cuda)
    w = torch.full((4,), 0x10000, dtype=torch.int32, device=cuda)
    xs = torch.arange(8, dtype=torch.int32, device=cuda)
    params = {"root_bno": 0, "firstn": 1, "leaf": 0, "numrep": 2,
              "choose_type": 0, "tries": 51, "recurse_tries": 1,
              "vary_r": 1, "stable": 1, "max_depth": comp.max_depth}
    tables = crush.kernel_tables(str(cuda))
    for group in (0, 3, 64):
        with pytest.raises(ValueError, match="power of two"):
            kernels.crush_rule(*arrays, w, xs, tables,
                               dict(params, group=group))
    for group in (1, 4, 32):  # any width gives the same rows
        assert torch.equal(
            kernels.crush_rule(*arrays, w, xs, tables,
                               dict(params, group=group)),
            bulk.rule_rows_plain(comp, w, xs, comp.compile_rule(0, 2), 2))


def test_resolver_device_batches_launch_the_rule_kernel(cuda):
    from ceph_tpu_torch.placement import crushmap as cm
    from ceph_tpu_torch.placement import resolver as rmod
    from ceph_tpu_torch.placement.osdmap import Incremental, OSDMap, Pool

    crush = cm.build_hierarchy(osds_per_host=4, n_hosts=6)
    crush.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    om = OSDMap(crush, 24)
    # one size-target batch (64 pgids) in the prewarm and one in the storm
    om.add_pool(Pool(id=1, name="r", size=3, pg_num=64, crush_rule=0))
    r = rmod.PlacementResolver(batch=True)

    async def run():
        before = kernels.CRUSH_RULE.launches
        assert await r.prewarm(om, [1]) == 64
        om.apply_incremental(Incremental(epoch=2, weights={3: 0}))
        got = await asyncio.gather(*(r.afull(om, (1, ps))
                                     for ps in range(64)))
        return kernels.CRUSH_RULE.launches - before, got

    launches, got = asyncio.run(run())
    assert r.stats.placement_batch_lookups == 2 == launches
    for ps, (up, upp, acting, ap) in enumerate(got):
        assert (up, upp, acting, ap) == om.pg_to_up_acting_full((1, ps))


# ------------------------------------------------- the object store


@pytest.mark.parametrize("n", [1, 1024, 777])
def test_crc32c_kernel_at_the_store_shapes(cuda, n):
    """K2 at the store's checksum shapes, (N, 4 KiB) blocks: one 4 KiB
    overwrite, one 4 MiB object and a ragged count, through the
    Checksummer's device engine against the plain version and the C++
    core."""
    from ceph_tpu_torch.checksum import Checksummer

    blocks = np.random.default_rng(n).integers(0, 256, (n, 4096),
                                               dtype=np.uint8)
    x = words_to_tensor(blocks.view(np.uint32), cuda)
    before = kernels.CRC32C.launches
    assert torch.equal(crc32c.crc0_words(x), crc32c.crc0_words_plain(x))
    assert kernels.CRC32C.launches == before + 1
    cs = Checksummer("crc32c", 4096, device=cuda)
    got = cs.calculate(blocks, device=True)
    assert kernels.CRC32C.launches == before + 2
    assert np.array_equal(got, native.crc32c_batch(blocks))
    assert np.array_equal(got, cs.calculate(blocks))
    built = crc32c._kernel_constants.cache_info().misses
    cs.calculate(blocks, device=True)  # the W = 1,024 plan is cached
    assert crc32c._kernel_constants.cache_info().misses == built


@pytest.mark.parametrize("kind", ["bluestore", "walstore"])
def test_store_with_device_checksums_equals_its_host_twin(cuda, kind,
                                                           tmp_path):
    """One schedule through a store that checksums on the card and a
    twin that checksums on the C++ core: equal reads, equal stored
    checksums (BlueStore onodes, WalStore snapshot bytes), one K2 launch
    per device checksum call, and a flipped byte caught on the card."""
    from ceph_tpu_torch.store import StoreError, create
    from ceph_tpu_torch.store import transaction as tx

    rng = np.random.default_rng(6)
    objs = {b"rbd_data.%016x" % i: rng.integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes() for i in range(8)}
    kw = {"compression": None}
    if kind == "bluestore":
        kw["size"] = 64 << 20
    stores = {"device": create(kind, str(tmp_path / "d"), device_csum=True,
                               device=cuda, **kw),
              "host": create(kind, str(tmp_path / "h"), **kw)}
    before = kernels.CRC32C.launches
    for i, (oid, data) in enumerate(objs.items()):
        t = tx.Transaction()
        if i == 0:
            t.create_collection("1.0")
        t.write("1.0", oid, 0, data)
        t.write("1.0", oid, 4096 * (i + 1), data[:4096])  # one block again
        for s in stores.values():
            s.apply_transaction(t)
    for s in stores.values():
        s.apply_transaction(tx.Transaction().write(
            "1.0", next(iter(objs)), 100, b"small"))
    host = stores["host"]
    want = {oid: host.read("1.0", oid) for oid in objs}
    for oid in objs:
        assert stores["device"].read("1.0", oid) == want[oid]
    if kind == "bluestore":
        # 9 writes + 8 reads on the card, one launch each
        assert kernels.CRC32C.launches == before + 17
        for oid in objs:
            d = stores["device"].colls["1.0"][oid]
            h = stores["host"].colls["1.0"][oid]
            assert d.csums == h.csums
            blocks = np.frombuffer(want[oid], np.uint8).reshape(-1, 4096)
            assert d.csums == native.crc32c_batch(blocks).tolist()
        s = stores["device"]
        oid = next(iter(objs))
        phys = s.colls["1.0"][oid].blocks[3]
        s.umount()
        with open(tmp_path / "d" / "block", "r+b") as f:
            f.seek(phys * 4096)
            f.write(b"\xff\x00")
        s.mount()
        with pytest.raises(StoreError, match="block 3"):
            s.read("1.0", oid)
        host.umount()
    else:
        for s in stores.values():
            s.umount()  # the checkpoint: one launch for the device twin
        assert kernels.CRC32C.launches == before + 1
        assert ((tmp_path / "d" / "snap").read_bytes()
                == (tmp_path / "h" / "snap").read_bytes())
        s = create(kind, str(tmp_path / "d"), device_csum=True, device=cuda,
                   **kw)  # mount verifies on the card
        assert kernels.CRC32C.launches == before + 2
        assert all(s.read("1.0", oid) == want[oid] for oid in objs)
        s.umount()


# ------------------------------------------- the GF(2) XOR kernel (K5)


@pytest.mark.parametrize("case", list(chip_smoke.gf2_edge_cases()))
def test_gf2_xor_kernel_at_the_edges(cuda, case):
    from ceph_tpu_torch.ops import gf2

    plan, shape = chip_smoke.gf2_edge_cases()[case]
    rows = _words(np.random.default_rng(sum(map(ord, case))), shape, cuda)
    before = kernels.GF2_XOR.launches
    got = gf2.gf2_apply(plan, rows)
    assert kernels.GF2_XOR.launches == before + 1
    assert torch.equal(got, gf2.gf2_apply_plain(plan, rows))
    assert torch.equal(got.cpu(), gf2.gf2_apply_plain(plan, rows.cpu()))


def test_gf2_plan_cache_is_built_once_per_plan_and_device(cuda):
    from ceph_tpu_torch.ops import gf2

    gf2._device_plan.cache_clear()
    rows = _words(np.random.default_rng(1), (2, 6, 64), cuda)
    plan = np.array([[0, 1, 6], [2, 3, 4]], np.int32)
    first = gf2.gf2_apply(plan, rows)
    again = gf2.gf2_apply(plan.copy(), rows[:1])  # the same plan's bytes
    info = gf2._device_plan.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert torch.equal(again, first[:1])
    gf2.gf2_apply(plan[::-1].copy(), rows)  # another plan: built once more
    assert gf2._device_plan.cache_info().misses == 2
    cached = gf2._device_plan(plan.tobytes(), 2, 3, str(rows.device))
    assert cached.device == rows.device and cached.dtype == torch.int32


def test_gf2_xor_wrapper_refuses_bad_inputs(cuda):
    rows = torch.zeros((2, 3, 8), dtype=torch.int32, device=cuda)
    plan = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    assert kernels.gf2_xor(rows, plan).shape == (2, 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gf2_xor(rows.transpose(1, 2), plan)
    with pytest.raises(TypeError):
        kernels.gf2_xor(rows, plan.to(torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gf2_xor(rows, plan.cpu())
    with pytest.raises(ValueError, match="at most"):
        kernels.gf2_xor(torch.zeros((1, kernels.GF2_MAX_ROWS + 1, 1),
                                    dtype=torch.int32, device=cuda), plan)


@pytest.mark.parametrize("profile", [
    {"plugin": "jerasure", "technique": "liber8tion", "k": "8", "m": "2"},
    {"plugin": "bitmatrix", "technique": "cauchy_bm", "k": "6", "m": "3"},
    {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    {"plugin": "clay", "k": "4", "m": "2", "d": "5"}],
    ids=lambda p: p.get("technique", p["plugin"]))
def test_codec_batches_on_the_card_equal_the_cpu_codec(cuda, profile):
    card, cpu = load_codec(profile, device=cuda), load_codec(profile,
                                                             device="cpu")
    su = card.get_chunk_size(card.k * 4096)
    cells = np.random.default_rng(3).integers(0, 256, (5, card.k, su),
                                              dtype=np.uint8)
    x = rs.pack_u32(cells)
    k0 = {k.name: k.launches for k in kernels.KERNELS}
    parity, crcs = card.encode_crc_batch(words_to_tensor(x, cuda), su)
    cparity, ccrcs = cpu.encode_crc_batch(x, su)
    assert parity.device.type == "cuda" and crcs.device.type == "cuda"
    assert torch.equal(parity.cpu(), cparity) and torch.equal(crcs.cpu(),
                                                              ccrcs)
    assert kernels.CRC32C.launches > k0["crc32c"]
    used = "gf2_xor" if profile["plugin"] in ("jerasure", "bitmatrix") \
        else "gf_matmul"
    assert {k.name: k.launches for k in kernels.KERNELS}[used] > k0[used]
    every = np.concatenate([cells, rs.unpack_u32(cparity.numpy().view(
        np.uint32))], axis=1)
    present = tuple(range(1, card.k + card.m))  # generator rows
    if profile["plugin"] != "clay":
        present = present[:card.k]
    surv = words_to_tensor(rs.pack_u32(np.ascontiguousarray(
        every[:, list(present)])), cuda)
    got = card.decode_batch(present, surv, want=(0,))
    assert torch.equal(got.cpu(), cpu.decode_batch(present, surv.cpu(),
                                                   want=(0,)))
    assert np.array_equal(rs.unpack_u32(got.cpu().numpy().view(np.uint32)),
                          cells[:, :1])


def test_batcher_repairs_a_clay_cell_on_the_card(cuda):
    conf = chip_smoke_conf(osd_ec_cold_shape_bytes=0)
    codec = load_codec({"plugin": "clay", "k": "4", "m": "2", "d": "5"},
                       device=cuda)
    cells = np.random.default_rng(9).integers(0, 256, (300, 4, 4096),
                                              dtype=np.uint8)
    every = np.concatenate([cells, codec.encode_cells_host(cells)], axis=1)
    order, slices = chip_smoke.repair_slices(codec, every, 5)
    before = kernels.GF_MATMUL.launches
    got = asyncio.run(ECBatcher(conf=conf).repair_cells(codec, order, (5,),
                                                        slices))
    assert kernels.GF_MATMUL.launches > before
    assert np.array_equal(got, codec.repair_cells_host(order, (5,), slices))
    assert np.array_equal(got[:, 0], every[:, 5])


def test_msg_fan_out_on_the_card(cuda):
    """Phase ``msg`` of chip_smoke.py at 8 objects over LocalBus and TCP:
    K1 encodes and rebuilds, K2 checksums, every cell holds against its
    (cell, crc) patch on its receiver and every degraded read rebuilds
    shards 1 and 6 exact (the phase checks all of it and raises)."""
    out = chip_smoke.msg_phase(cuda, np.random.default_rng(8), "gpu test",
                               transports={"localbus": 8, "tcp": 8},
                               profile=False)
    for kind, line in out["lines"].items():
        assert line["launches"]["gf_matmul"] > 0, kind
        assert line["launches"]["crc32c"] > 0, kind
        assert line["cells_crc_checked"] == 8 * 11 * 128
        assert line["rebuilt_cells"] == 8 * 2 * 128
        assert line["objects_cut_from"] == chip_smoke.MSG_OBJECTS
    # every sub-write and read reply carries a shard's 512 KiB of cells
    assert out["lines"]["tcp"]["wire_bytes"] > 8 * 20 * (512 << 10)


def test_cluster_on_the_card(cuda):
    """Phase ``cluster`` of chip_smoke.py, small: a TestCluster of 12 OSDs
    on the card (no device named) writes 8 objects of 4 MiB to the EC
    8+3 pool and 2 to the replicated one, reads them, overwrites 16 cells,
    loses two OSDs, reads degraded, writes 4 more objects a pool, revives
    and recovers, deep-scrubs, reads again (the phase checks every byte,
    every shard's hash_info and the scrub, and raises), then runs the
    thrash runner. K1 and K2 run the EC work, K4 the client's prewarm."""
    out = chip_smoke.cluster_phase(
        "gpu test", np.random.default_rng(9), objects=8, rep_objects=2,
        overwrites=16, degraded_writes=4, profile=False)
    lines = out["lines"]
    assert lines["write"]["launches"]["gf_matmul"] > 0
    assert lines["write"]["launches"]["crc32c"] > 0
    assert lines["degraded_read"]["launches"]["gf_matmul"] > 0
    assert lines["recovery"]["launches"]["gf_matmul"] > 0
    assert lines["setup"]["launches"]["crush_rule"] > 0
    assert lines["scrub"]["shards_crc_checked"] == 11 * (8 + 4)
    assert out["thrash"]["passed"]


def chip_smoke_conf(**knobs):
    from ceph_tpu_torch.utils import config

    conf = config.proxy()
    conf.apply(knobs)
    return conf


# ------------------------------------------------------ K6 and the mesh


@pytest.mark.parametrize("case", list(chip_smoke.k6_edge_cases()))
def test_k6_kernel_at_the_edges(cuda, case):
    entry, n, length = chip_smoke.k6_edge_cases()[case]
    kernel = getattr(kernels, entry.upper())
    before = kernel.launches
    got, want = chip_smoke.k6_case(entry, n, length,
                                   np.random.default_rng(n * 131 + length),
                                   cuda)
    assert kernel.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_k6_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kernels.xor_fold(x.to(torch.int64))
    with pytest.raises(ValueError, match="not \\(n, 32"):
        kernels.plane_parity_pack(torch.zeros((1, 31, 8), dtype=torch.uint8,
                                              device=cuda))
    with pytest.raises(ValueError, match="do not fit"):
        kernels.crc_join(x, torch.zeros((3, 32), dtype=torch.int32,
                                        device=cuda), 0)


@pytest.mark.parametrize("method", ["allgather", "psum_bits"])
def test_mesh_encode_and_repair_on_the_card_equal_one_device(cuda, method):
    """A 2 x 4 virtual mesh over the card: the mesh write step equals the
    one-device write step and collective repair equals the data, slot by
    slot, with K1, K2 and K6 launched on the way."""
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.parallel import runtime, shard_comm

    parallel.pin_virtual(8)
    mesh = parallel.make_mesh(parallel.get_devices(8, cuda), width=4)
    params = datapath.ECParams(k=8, m=3, chunk_bytes=4096 * 3)
    data = datapath.example_batch(params, batch=16, device=cuda)
    parity, crcs = datapath.write_step(params, data)
    kernels.reset_counts()
    p, c = runtime.mesh_encode_crc_batch(mesh, params.matrix,
                                         params.chunk_bytes, data)
    assert all(torch.equal(s.data, parity[s.index]) for s in p.shards)
    assert all(torch.equal(s.data, crcs[s.index]) for s in c.shards)
    present = [0, 2, 3, 4, 5, 7, 8, 9]
    surv = torch.cat([data, parity], dim=1)[:, present]
    out = shard_comm.distributed_repair(mesh, params.matrix, 8, present,
                                        surv, method)
    runtime.finish(mesh)
    assert all(torch.equal(s.data, data[s.index]) for s in out.shards)
    assert kernels.GF_MATMUL.launches == 16
    assert kernels.CRC32C.launches == 8 and kernels.CRC_JOIN.launches == 8
    if method == "allgather":
        assert kernels.XOR_FOLD.launches == 8
    else:
        assert kernels.BIT_PLANES.launches == 8
        assert kernels.PLANE_PARITY_PACK.launches == 8
