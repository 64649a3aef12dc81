"""The port's bulk rule engine (``ceph_tpu_torch.placement.bulk``, its
plain version on the CPU) against the JAX package's engine and the host
oracle, in the cases of tests/test_bulk_placement.py, with every
rejection; on the maps at the edges of the CUDA kernel's lane groups
(``chip_smoke.rule_edge_maps``, which the card tests and ``chip_smoke.py``
use); the kernel's group width; and the plain version's draw count
against counts made by hand and by the host oracle. Maps are built in
the JAX package and carried across as its wire bytes, the edge maps the
other way. Tolerance: exact equality (placements, draw counts)."""
import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu.placement import bulk as jbulk
from ceph_tpu.placement import crushmap as jcm
from ceph_tpu.placement import encoding as jenc
from ceph_tpu_torch import convert, native
from ceph_tpu_torch.ops import crush
from ceph_tpu_torch.placement import bulk
from ceph_tpu_torch.placement import crushmap as cm
from ceph_tpu_torch.placement import encoding as penc
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)

N_X = 384


def _host_rows(m, ruleno, xs, numrep, weights):
    rows = []
    for x in xs:
        got = m.do_rule(ruleno, int(x), numrep, weights)
        rows.append(got + [cm.ITEM_NONE] * (numrep - len(got)))
    return np.asarray(rows, dtype=np.int32)


def _xs(n=N_X):
    return (np.arange(n, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(
        np.uint32)


def _rack_map(rng):
    m = jcm.CrushMap()
    m.add_type(1, "host")
    m.add_type(2, "rack")
    m.add_type(3, "root")
    osd, bid, rack_ids = 0, -2, []
    for r in range(3):
        host_ids = []
        for h in range(3):
            n = int(rng.integers(2, 5))
            m.add_bucket(jcm.Bucket(
                id=bid, type_id=1, items=list(range(osd, osd + n)),
                weights=[int(w) for w in rng.integers(0x8000, 0x30000, n)],
                name=f"h{r}{h}"))
            osd += n
            host_ids.append(bid)
            bid -= 1
        m.add_bucket(jcm.Bucket(
            id=bid, type_id=2, items=host_ids,
            weights=[m.buckets[h].weight() for h in host_ids],
            name=f"rack{r}"))
        rack_ids.append(bid)
        bid -= 1
    m.add_bucket(jcm.Bucket(
        id=bid, type_id=3, items=rack_ids,
        weights=[m.buckets[r].weight() for r in rack_ids], name="root"))
    m.add_rule(jcm.replicated_rule(0, root=bid, failure_domain_type=2))
    m.add_rule(jcm.ec_rule(1, root=bid, failure_domain_type=1))
    return m


def _case(name):
    """-> (JAX map, rule, numrep, reweights or None)."""
    if name == "flat_firstn":
        m = jcm.build_flat(12)
        m.add_rule(jcm.flat_firstn_rule(0))
        return m, 0, 3, None
    if name == "flat_firstn_weighted_reweight":
        m = jcm.build_flat(10, osd_weights=[1, 2, 3, 4, 0.5, 1, 1, 2, 8, 1])
        m.add_rule(jcm.flat_firstn_rule(0))
        w = np.full(10, 0x10000, dtype=np.uint32)
        w[2] = 0
        w[5] = 0x8000
        return m, 0, 4, w
    if name.startswith("hierarchy_chooseleaf_firstn"):
        m = jcm.build_hierarchy(osds_per_host=3, n_hosts=5)
        m.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
        if not name.endswith("outs"):
            return m, 0, 3, None
        w = np.full(15, 0x10000, dtype=np.uint32)
        w[[0, 1, 2]] = 0  # host0 fully out: forces retries
        w[7] = 0x2000
        return m, 0, 3, w
    if name == "hierarchy_chooseleaf_indep":
        m = jcm.build_hierarchy(osds_per_host=3, n_hosts=8)
        m.add_rule(jcm.ec_rule(0, root=-1, failure_domain_type=1))
        w = np.full(24, 0x10000, dtype=np.uint32)
        w[[4, 11]] = 0
        w[17] = 0x4000
        return m, 0, 6, w
    if name.startswith("flat_indep"):
        m = jcm.build_flat(14 if name == "flat_indep" else 8)
        m.add_rule(jcm.ec_rule(0, root=-1, failure_domain_type=0))
        if name == "flat_indep":
            return m, 0, 11, None
        w = np.full(8, 0x10000, dtype=np.uint32)
        w[[1, 4]] = 0  # k+m > up devices: NONE holes must match the C's
        return m, 0, 7, w
    if name == "choose_firstn_host_level":
        m = jcm.build_hierarchy(osds_per_host=2, n_hosts=5)
        m.add_rule(jcm.Rule(0, [jcm.Step(jcm.OP_TAKE, -1),
                                jcm.Step(jcm.OP_CHOOSE_FIRSTN, 0, 1),
                                jcm.Step(jcm.OP_EMIT)]))
        return m, 0, 3, None
    if name.startswith("deep_rack"):
        m = _rack_map(np.random.default_rng(1234))
        return (m, 0, 3, None) if name.endswith("replicated") else (
            m, 1, 5, None)
    if name == "nonstable_tunables":
        m = jcm.build_hierarchy(osds_per_host=4, n_hosts=5)
        m.tunables = jcm.Tunables(chooseleaf_stable=0, chooseleaf_vary_r=0)
        m.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
        return m, 0, 3, None
    if name == "vary_r_2_no_descend_once":
        m = jcm.build_hierarchy(osds_per_host=4, n_hosts=5)
        m.tunables = jcm.Tunables(chooseleaf_vary_r=2,
                                  chooseleaf_descend_once=0)
        m.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
        w = np.full(20, 0x10000, dtype=np.uint32)
        w[[1, 2, 5]] = 0
        return m, 0, 3, w
    if name == "empty_host_bucket":
        m = jcm.build_hierarchy(osds_per_host=3, n_hosts=4)
        root = m.buckets[-1]
        m.add_bucket(jcm.Bucket(id=-6, type_id=1, items=[], weights=[],
                                name="host4"))
        root.items.append(-6)
        root.weights.append(0x30000)  # weighted but empty: rejected picks
        m.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
        m.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=1))
        return m, 1, 4, None
    if name == "short_reweight_vector":
        m = jcm.build_flat(10)
        m.add_rule(jcm.flat_firstn_rule(0))
        return m, 0, 3, np.full(7, 0x10000, dtype=np.uint32)  # 7.. are out
    raise KeyError(name)


#: cases held against the JAX engine too (each costs it one compile)
AGAINST_JAX = {"flat_firstn_weighted_reweight",
               "hierarchy_chooseleaf_firstn_with_outs",
               "hierarchy_chooseleaf_indep", "flat_indep_with_outs"}
CASES = ["flat_firstn", "flat_firstn_weighted_reweight",
         "hierarchy_chooseleaf_firstn",
         "hierarchy_chooseleaf_firstn_with_outs",
         "hierarchy_chooseleaf_indep", "flat_indep", "flat_indep_with_outs",
         "choose_firstn_host_level", "deep_rack_replicated", "deep_rack_ec",
         "nonstable_tunables", "vary_r_2_no_descend_once",
         "empty_host_bucket", "short_reweight_vector"]


@pytest.mark.parametrize("name", CASES)
def test_plain_engine_equals_host_oracle_and_jax(name):
    jmap, ruleno, numrep, weights = _case(name)
    pmap = convert.crushmap_from_reference(jenc.encode_crushmap(jmap))
    xs = _xs(256 if name.startswith("deep_rack") else N_X)
    got = bulk.do_rule_bulk(bulk.CompiledMap(pmap), ruleno, xs, numrep,
                            weights, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, _host_rows(jmap, ruleno, xs, numrep, weights))
    if name in AGAINST_JAX:
        np.testing.assert_array_equal(got, jbulk.do_rule_bulk(
            jbulk.CompiledMap(jmap), ruleno, xs, numrep, weights))


def test_compiled_arrays_equal_jax():
    jmap, _, _, _ = _case("deep_rack_ec")
    mine = bulk.CompiledMap(
        convert.crushmap_from_reference(jenc.encode_crushmap(jmap)))
    theirs = jbulk.CompiledMap(jmap)
    for key in ("items", "weights", "sizes", "btype"):
        assert np.array_equal(getattr(mine, key), getattr(theirs, key))
    assert mine.max_depth == theirs.max_depth == 3
    for ruleno, numrep in ((0, 3), (1, 5)):
        assert (mine.compile_rule(ruleno, numrep).__dict__
                == theirs.compile_rule(ruleno, numrep).__dict__)
    on = mine.arrays_on(torch.device("cpu"))
    assert on is mine.arrays_on(torch.device("cpu"))  # uploaded once
    assert on[1].dtype == torch.int32


def test_unsupported_rejected():
    with pytest.raises(ValueError):
        bulk.CompiledMap(cm.build_flat(4, alg=cm.ALG_UNIFORM))
    local = cm.build_flat(4)
    local.tunables.choose_local_tries = 2
    with pytest.raises(ValueError, match="local retries"):
        bulk.CompiledMap(local)
    m2 = cm.build_flat(4)
    m2.add_rule(cm.Rule(0, [cm.Step(cm.OP_TAKE, -1), cm.Step(cm.OP_EMIT)]))
    with pytest.raises(ValueError, match="take/choose/emit"):
        bulk.CompiledMap(m2).compile_rule(0, 3)
    m3 = cm.build_hierarchy(2, 2)
    m3.add_rule(cm.Rule(0, [cm.Step(cm.OP_TAKE, -1),
                            cm.Step(cm.OP_CHOOSE_FIRSTN, 0, 1),
                            cm.Step(cm.OP_CHOOSELEAF_FIRSTN, 0, 0),
                            cm.Step(cm.OP_EMIT)]))
    with pytest.raises(ValueError, match="single choose"):
        bulk.CompiledMap(m3).compile_rule(0, 3)
    m3.add_rule(cm.Rule(1, [cm.Step(cm.OP_TAKE, -1),
                            cm.Step(cm.OP_CHOOSE_FIRSTN, 0, 1),
                            cm.Step(cm.OP_TAKE, -2), cm.Step(cm.OP_EMIT)]))
    with pytest.raises(ValueError, match="single take"):
        bulk.CompiledMap(m3).compile_rule(1, 3)
    m3.add_rule(cm.Rule(2, [cm.Step(cm.OP_TAKE, -1), cm.Step("bogus"),
                            cm.Step(cm.OP_EMIT)]))
    with pytest.raises(ValueError, match="unsupported op"):
        bulk.CompiledMap(m3).compile_rule(2, 3)


def test_device_above_choose_type_rejected():
    m = cm.build_hierarchy(osds_per_host=2, n_hosts=2)
    root = next(b for b in m.buckets.values() if b.type_id == 2)
    root.items.append(99)  # bare OSD directly under the root
    root.weights.append(0x10000)
    m.max_devices = max(m.max_devices, 100)
    m.add_rule(cm.replicated_rule(0, root=root.id, failure_domain_type=1))
    with pytest.raises(ValueError, match="above choose type"):
        bulk.CompiledMap(m).compile_rule(0, 3)


def test_take_device_rejected():
    m = cm.build_flat(4)
    m.add_rule(cm.Rule(0, [cm.Step(cm.OP_TAKE, 2),
                           cm.Step(cm.OP_CHOOSELEAF_FIRSTN, 0, 1),
                           cm.Step(cm.OP_EMIT)]))
    with pytest.raises(ValueError, match="not a bucket"):
        bulk.CompiledMap(m).compile_rule(0, 3)


def test_rows_wider_than_the_kernel_rejected():
    m = cm.build_flat(300)
    m.add_rule(cm.ec_rule(0, root=-1, failure_domain_type=0))
    comp = bulk.CompiledMap(m)
    assert comp.compile_rule(0, bulk.MAX_REP).op == cm.OP_CHOOSE_INDEP
    with pytest.raises(ValueError, match="at most 256"):
        comp.compile_rule(0, bulk.MAX_REP + 1)
    m.add_rule(cm.Rule(1, [cm.Step(cm.OP_TAKE, -1),
                           cm.Step(cm.OP_CHOOSE_INDEP, 3, 0),
                           cm.Step(cm.OP_EMIT)]))
    comp.compile_rule(1, 1000)  # a numrep argument of 3 caps the width


def test_chunked_dispatch_consistency():
    m = cm.build_flat(9)
    m.add_rule(cm.flat_firstn_rule(0))
    comp = bulk.CompiledMap(m)
    xs = np.arange(1000, dtype=np.uint32)
    a = bulk.do_rule_bulk(comp, 0, xs, 3, chunk=128, device="cpu")
    b = bulk.do_rule_bulk(comp, 0, xs, 3, chunk=1 << 18, device="cpu")
    np.testing.assert_array_equal(a, b)


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = cm.build_flat(4)
    m.add_rule(cm.flat_firstn_rule(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        bulk.do_rule_bulk(bulk.CompiledMap(m), 0, np.arange(4), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        crush.straw2_bulk(np.arange(3), np.ones(3, np.uint32), np.arange(4))


# ------------------------------------- the kernel's edge maps and draws

EDGE_NAMES = list(chip_smoke.rule_edge_maps())
#: inputs an edge map takes here: rows of 256 cost the plain engine about
#: a second an input on the CPU
EDGE_X = {"indep256_flat300": 8}
#: edge maps held against the JAX engine too (each costs it one compile)
EDGE_AGAINST_JAX = {"flat33_firstn", "tree65_indep", "zero_host_indep"}


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_plain_engine_on_the_kernel_edge_maps(name):
    m, ruleno, numrep, weights = chip_smoke.rule_edge_maps()[name]
    jmap, _ = jenc.decode_crushmap(penc.encode_crushmap(m))
    xs = _xs(EDGE_X.get(name, N_X))
    got = bulk.do_rule_bulk(bulk.CompiledMap(m), ruleno, xs, numrep, weights,
                            device="cpu")
    np.testing.assert_array_equal(
        got, _host_rows(jmap, ruleno, xs, numrep, weights))
    if name in EDGE_AGAINST_JAX:
        np.testing.assert_array_equal(got, jbulk.do_rule_bulk(
            jbulk.CompiledMap(jmap), ruleno, xs, numrep, weights))


#: threads of an H100's SMs (132 x 2048), for the group width's bands
LANES = 132 * 2048


@pytest.mark.parametrize("widest,n_inputs,group", [
    # a batch the card holds whole: one lane per slot, at most 32
    (0, 64, 1), (1, 64, 1), (2, 64, 2), (3, 64, 4), (4, 64, 4), (5, 64, 8),
    (8, 64, 8), (9, 64, 16), (16, 64, 16), (17, 64, 32), (31, 64, 32),
    (32, 64, 32), (33, 64, 32), (64, 64, 32), (65, 64, 32), (1000, 64, 32),
    (50, LANES // 32, 32),
    # a batch that fills it: about LANE_SLOTS slots a lane
    (50, LANES // 32 + 1, 8), (1, 10**7, 1), (8, 10**7, 1), (9, 10**7, 2),
    (16, 10**7, 2), (17, 10**7, 4), (32, 10**7, 4), (33, 10**7, 8),
    (50, 10**7, 8), (64, 10**7, 8), (65, 10**7, 16), (128, 10**7, 16),
    (129, 10**7, 32), (1000, 10**7, 32), (50, 65536, 8)])
def test_group_width_bands(widest, n_inputs, group):
    assert bulk.group_width(widest, n_inputs, LANES) == group


def test_widest_bucket_below_a_take():
    edges = chip_smoke.rule_edge_maps()
    for name, widest in (("flat1_firstn", 1), ("flat65_indep", 65),
                         ("tree33_firstn", 33), ("zero_flat_firstn", 5),
                         ("empty_host_firstn", 5), ("uneven_depth_indep", 40),
                         ("indep256_flat300", 300)):
        assert bulk.CompiledMap(edges[name][0]).widest(-1) == widest, name
    comp = bulk.CompiledMap(edges["uneven_depth_firstn"][0])
    assert [comp.widest(b) for b in (-6, -5, -2)] == [40, 2, 3]


def test_plain_engine_edge_maps_cover_both_rules():
    """chip_smoke.py holds the plain engine's draw count against the
    kernel's on the maps of PL_EDGE_PLAIN: each is an edge map, and they
    take both a firstn and an indep rule."""
    edges = chip_smoke.rule_edge_maps()
    assert set(chip_smoke.PL_EDGE_PLAIN) <= set(edges)
    assert {edges[name][1] for name in chip_smoke.PL_EDGE_PLAIN} == {0, 1}


def test_edge_oracle_workers_match_do_rule():
    """chip_smoke.py's edge maps take their expected rows from
    ``CrushMap.do_rule`` in forked workers (``pl_oracle``): on a few maps,
    with chunks that split a map's inputs unevenly, the rows equal
    ``do_rule`` called in this process, padded to numrep."""
    edges = chip_smoke.rule_edge_maps()
    rng = np.random.default_rng(3)
    maps = {}
    for name in ("flat2_indep", "tree33_firstn", "zero_flat_indep"):
        m, ruleno, numrep, w = edges[name]
        w = (np.full(bulk.CompiledMap(m).max_devices, 0x10000,
                     dtype=np.uint32) if w is None else w)
        maps[name] = (m, ruleno, numrep, w,
                      rng.integers(0, 2**32, 23, dtype=np.uint32))
    rows, seconds = chip_smoke.pl_oracle(maps, workers=2, chunk=5)
    assert set(rows) == set(seconds) == set(maps)
    for name, (m, ruleno, numrep, w, xs) in maps.items():
        want = [row + [cm.ITEM_NONE] * (numrep - len(row))
                for row in (m.do_rule(ruleno, int(x), numrep, w)
                            for x in xs)]
        assert rows[name].dtype == np.int32
        assert rows[name].tolist() == want, name


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _plain_draws(m, ruleno, xs, numrep, weights=None) -> int:
    comp = bulk.CompiledMap(m)
    if weights is None:
        weights = np.full(comp.max_devices, 0x10000, dtype=np.uint32)
    draws = torch.zeros(1, dtype=torch.int64)
    bulk.rule_rows(comp, _u32(weights), _u32(xs),
                   comp.compile_rule(ruleno, numrep), numrep, draws=draws)
    return int(draws.item())


def _choose(bucket, x, r) -> int:
    return int(native.straw2_choose(np.asarray(bucket.items, np.int32),
                                    np.asarray(bucket.weights, np.uint32),
                                    int(x), r))


@pytest.mark.parametrize("n", [1, 2, 31, 33, 65])
def test_plain_draws_flat_one_rank(n):
    m = cm.build_flat(n)
    m.add_rule(cm.flat_firstn_rule(0))
    xs = _xs(200)
    assert _plain_draws(m, 0, xs, 1) == len(xs) * n


def test_plain_draws_two_level_one_rank():
    m = cm.build_hierarchy(osds_per_host=7, n_hosts=33)
    m.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    xs = _xs(200)
    assert _plain_draws(m, 0, xs, 1) == len(xs) * (33 + 7)


def test_plain_draws_counted_by_hand_flat_firstn():
    """Nothing out: numrep x n draws an input, and n more for each attempt
    whose pick collides with an earlier rank's (r = rep + ftotal)."""
    n, numrep = 33, 3
    m = cm.build_flat(n)
    m.add_rule(cm.flat_firstn_rule(0))
    xs = _xs(128)
    want = 0
    for x in xs:
        row = []
        for rep in range(numrep):
            for ftotal in range(51):
                want += n
                item = _choose(m.buckets[-1], x, rep + ftotal)
                if item not in row:
                    row.append(item)
                    break
    assert want > len(xs) * numrep * n  # some ranks did collide
    assert _plain_draws(m, 0, xs, numrep) == want


def test_plain_draws_counted_by_hand_two_level_firstn():
    """chooseleaf firstn host, nothing out: root + host draws a rank, and
    the root's draws again for each pick of a host already in the row
    (leaves of distinct hosts never collide, so one leaf try suffices)."""
    hosts, per_host, numrep = 9, 4, 3
    m = cm.build_hierarchy(osds_per_host=per_host, n_hosts=hosts)
    m.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    xs = _xs(128)
    want = 0
    for x in xs:
        row = []
        for rep in range(numrep):
            for ftotal in range(51):
                want += hosts
                host = _choose(m.buckets[-1], x, rep + ftotal)
                if host not in row:
                    want += per_host
                    row.append(host)
                    break
    assert want > len(xs) * numrep * (hosts + per_host)
    assert _plain_draws(m, 0, xs, numrep) == want


@pytest.mark.parametrize("name", [
    "tree2_firstn", "tree33_indep", "flat65_indep", "zero_flat_firstn",
    "zero_host_indep", "empty_host_firstn", "empty_host_indep",
    "uneven_depth_firstn", "uneven_depth_indep", "legacy_tunables",
    "vary_r_2"])
def test_plain_draws_equal_the_host_oracles(name):
    """Every bucket choose the host oracle's loops make (CrushMap.do_rule,
    the C's order) adds the bucket's size: the same count as the plain
    version's, with retries, rejections and empty buckets."""
    m, ruleno, numrep, weights = chip_smoke.rule_edge_maps()[name]
    xs = _xs(96)
    count = 0
    choose = m.bucket_choose

    def counting(b, x, r):
        nonlocal count
        count += b.size
        return choose(b, x, r)

    m.bucket_choose = counting
    for x in xs:
        m.do_rule(ruleno, int(x), numrep, weights)
    assert count > 0
    assert _plain_draws(m, ruleno, xs, numrep, weights) == count
