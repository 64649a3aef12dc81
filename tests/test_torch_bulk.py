"""The port's bulk rule engine (``ceph_tpu_torch.placement.bulk``, its
plain version on the CPU) against the JAX package's engine and the host
oracle, in the cases of tests/test_bulk_placement.py, with every
rejection. Maps are built in the JAX package and carried across as its
wire bytes. Tolerance: exact equality (placements)."""
import numpy as np
import pytest
import torch

from ceph_tpu.placement import bulk as jbulk
from ceph_tpu.placement import crushmap as jcm
from ceph_tpu.placement import encoding as jenc
from ceph_tpu_torch import convert
from ceph_tpu_torch.ops import crush
from ceph_tpu_torch.placement import bulk
from ceph_tpu_torch.placement import crushmap as cm

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
