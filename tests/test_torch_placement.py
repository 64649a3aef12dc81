"""The port's placement package (``ceph_tpu_torch.placement``: crushmap,
osdmap, encoding, compiler, tester) and ``convert``'s map carriers against
the JAX package's, on maps built once in the JAX package and carried
across as its wire bytes. Tolerance: exact equality (placements, bytes,
text)."""
import numpy as np
import pytest
import torch

from ceph_tpu.placement import compiler as jcompiler
from ceph_tpu.placement import crushmap as jcm
from ceph_tpu.placement import encoding as jenc
from ceph_tpu.placement import osdmap as josd
from ceph_tpu.placement import tester as jtester
from ceph_tpu_torch import convert
from ceph_tpu_torch.placement import compiler, encoding
from ceph_tpu_torch.placement import crushmap as cm
from ceph_tpu_torch.placement import osdmap, tester
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)


def _rack_map(mod, seed=7):
    """root -> 3 racks -> 3 hosts -> 2..4 OSDs of random weight."""
    rng = np.random.default_rng(seed)
    m = mod.CrushMap()
    m.add_type(1, "host")
    m.add_type(2, "rack")
    m.add_type(3, "root")
    osd, bid, rack_ids = 0, -2, []
    for r in range(3):
        host_ids = []
        for h in range(3):
            n = int(rng.integers(2, 5))
            m.add_bucket(mod.Bucket(
                id=bid, type_id=1, items=list(range(osd, osd + n)),
                weights=[int(w) for w in rng.integers(0x8000, 0x30000, n)],
                name=f"h{r}{h}"))
            osd += n
            host_ids.append(bid)
            bid -= 1
        m.add_bucket(mod.Bucket(
            id=bid, type_id=2, items=host_ids,
            weights=[m.buckets[h].weight() for h in host_ids],
            name=f"rack{r}"))
        rack_ids.append(bid)
        bid -= 1
    m.add_bucket(mod.Bucket(
        id=bid, type_id=3, items=rack_ids,
        weights=[m.buckets[r].weight() for r in rack_ids], name="root"))
    m.add_rule(mod.replicated_rule(0, root=bid, failure_domain_type=2))
    m.add_rule(mod.ec_rule(1, root=bid, failure_domain_type=1))
    return m


def _jax_maps():
    """name -> (JAX CrushMap, [(rule, numrep)], reweights or None)."""
    flat = jcm.build_flat(10, osd_weights=[1, 2, 3, 4, 0.5, 1, 1, 2, 8, 1])
    flat.add_rule(jcm.flat_firstn_rule(0))
    flat.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=0))
    fw = np.full(10, 0x10000, np.uint32)
    fw[[2, 6]] = 0
    fw[5] = 0x8000
    host = jcm.build_hierarchy(osds_per_host=4, n_hosts=6)
    host.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
    host.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=1))
    hw = np.full(24, 0x10000, np.uint32)
    hw[[0, 1, 2, 3]] = 0  # host0 out: retries
    hw[9] = 0x3000
    rack = _rack_map(jcm)
    rw = np.full(rack.max_devices, 0x10000, np.uint32)
    rw[[1, 5]] = 0
    legacy = jcm.build_hierarchy(osds_per_host=3, n_hosts=5)
    legacy.tunables = jcm.Tunables(chooseleaf_stable=0, chooseleaf_vary_r=0,
                                   chooseleaf_descend_once=0)
    legacy.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
    legacy.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=1))
    return {
        "flat": (flat, [(0, 4), (1, 7)], fw),
        "host": (host, [(0, 3), (1, 5)], hw),
        "rack": (rack, [(0, 3), (1, 5)], rw),
        "legacy_tunables": (legacy, [(0, 3), (1, 4)], None),
    }


def _carry(jmap):
    return convert.crushmap_from_reference(jenc.encode_crushmap(jmap))


def _xs(n=300, seed=3):
    return [int(x) for x in np.random.default_rng(seed).integers(
        0, 2**32, n, dtype=np.uint32)]


@pytest.mark.parametrize("name", ["flat", "host", "rack", "legacy_tunables"])
def test_do_rule_equals_jax(name):
    jmap, rules, weights = _jax_maps()[name]
    pmap = _carry(jmap)
    for ruleno, numrep in rules:
        for x in _xs():
            assert pmap.do_rule(ruleno, x, numrep, weights) == jmap.do_rule(
                ruleno, x, numrep, weights), (name, ruleno, x)


def test_do_rule_with_choose_args_equals_jax():
    jmap = jcm.build_hierarchy(osds_per_host=3, n_hosts=4)
    jmap.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
    jmap.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=1))
    jmap.choose_args["balancer"] = {
        -1: ([0x30000, 0, 0x30000, 0x20000], None),
        -3: ([0x10000, 0x8000, 0x10000], [200, 201, 202]),
    }
    jmap.choose_args["ids"] = {-2: ([0x10000] * 3, [100, 101, 102])}
    pmap = _carry(jmap)
    w = np.full(12, 0x10000, np.uint32)
    w[4] = 0
    for key in ("balancer", "ids"):
        for ruleno, numrep in ((0, 3), (1, 3)):
            for x in _xs(150):
                assert pmap.do_rule(ruleno, x, numrep, w, choose_args=key) \
                    == jmap.do_rule(ruleno, x, numrep, w, choose_args=key)


@pytest.mark.parametrize("alg", [jcm.ALG_UNIFORM, jcm.ALG_LIST, jcm.ALG_TREE,
                                 jcm.ALG_STRAW])
def test_legacy_bucket_algs_equal_jax(alg):
    jmap = jcm.build_flat(7, osd_weights=[1, 2, 1, 3, 1, 1, 0.5], alg=alg)
    if alg == jcm.ALG_UNIFORM:
        jmap = jcm.build_flat(7, alg=alg)
    jmap.add_rule(jcm.flat_firstn_rule(0))
    jmap.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=0))
    pmap = _carry(jmap)
    for x in _xs(200):
        assert pmap.do_rule(0, x, 3) == jmap.do_rule(0, x, 3)
        assert pmap.do_rule(1, x, 4) == jmap.do_rule(1, x, 4)


def test_port_builders_encode_like_jax():
    built = [(cm.build_flat(9), jcm.build_flat(9)),
             (cm.build_hierarchy(5, 4), jcm.build_hierarchy(5, 4)),
             (_rack_map(cm, 11), _rack_map(jcm, 11))]
    for mine, theirs in built:
        mine.add_rule(cm.ec_rule(3, root=-1, failure_domain_type=1))
        theirs.add_rule(jcm.ec_rule(3, root=-1, failure_domain_type=1))
        blob = encoding.encode_crushmap(mine)
        assert blob == jenc.encode_crushmap(theirs)
        # the port's bytes decode in the JAX package and re-encode the same
        again, used = jenc.decode_crushmap(blob)
        assert used == len(blob) and jenc.encode_crushmap(again) == blob


def _jax_osdmap():
    crush = jcm.build_hierarchy(osds_per_host=4, n_hosts=6)
    crush.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
    crush.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=1))
    om = josd.OSDMap(crush, 24, epoch=5)
    om.add_pool(josd.Pool(id=1, name="rbd", size=3, pg_num=64, crush_rule=0))
    om.add_pool(josd.Pool(id=2, name="ec", size=5, min_size=4, pg_num=24,
                          crush_rule=1, type="erasure",
                          ec_profile={"plugin": "rs_tpu", "k": "3",
                                      "m": "2"},
                          snap_seq=4, removed_snaps=[(1, 2)],
                          quota_max_bytes=1 << 30))
    om.osds[3].weight = 0
    om.osds[7].up = False
    om.osds[11].weight = 0x6000
    om.osds[20].exists = False
    om.pg_upmap[(1, 5)] = [1, 9, 17]
    om.pg_upmap[(1, 6)] = [3, 9, 17]  # 3 is out: the whole override drops
    om.pg_upmap_items[(1, 5)] = [(9, 13)]
    om.pg_upmap_items[(1, 8)] = [(0, 2), (4, 5)]
    om.pg_upmap_primaries[(1, 9)] = 14
    om.pg_temp[(1, 10)] = [2, 7, 22]
    om.pg_temp[(2, 3)] = [1, 5, 9, 13, 7]
    om.primary_temp[(2, 3)] = 9
    om.primary_affinity[12] = 0
    om.primary_affinity[16] = 0x4000
    om.blocklist.add("client.4")
    return om


def _all_pgids(om):
    return [(pid, ps) for pid, p in sorted(om.pools.items())
            for ps in range(p.pg_num)]


def test_pg_to_up_acting_full_equals_jax():
    jom = _jax_osdmap()
    pom = convert.osdmap_from_reference(jenc.encode_osdmap(jom))
    assert isinstance(pom, osdmap.OSDMap) and pom.epoch == jom.epoch
    for pgid in _all_pgids(jom):
        assert pom.pg_to_up_acting_full(pgid) == jom.pg_to_up_acting_full(
            pgid), pgid
    for name in ("a", "rbd_data.1", "x" * 40):
        assert pom.object_to_pg(2, name) == jom.object_to_pg(2, name)
        assert osdmap.ceph_str_hash_rjenkins(name.encode()) == \
            josd.ceph_str_hash_rjenkins(name.encode())
    inc = josd.Incremental(
        epoch=6, down=[2], weights={5: 0, 3: 0x10000},
        new_pg_upmap_items={(1, 8): []}, new_pg_temp={(2, 3): []},
        new_primary_temp={(2, 3): -1}, new_primary_affinity={12: 0x10000},
        new_pools=[josd.Pool(id=3, name="new", size=2, pg_num=16)])
    blob = jenc.encode_incremental(inc)
    pinc, used = encoding.decode_incremental(blob)
    assert used == len(blob) and encoding.encode_incremental(pinc) == blob
    jom.apply_incremental(inc)
    pom.apply_incremental(pinc)
    assert encoding.encode_osdmap(pom) == jenc.encode_osdmap(jom)
    for pgid in _all_pgids(jom):
        assert pom.pg_to_up_acting_full(pgid) == jom.pg_to_up_acting_full(
            pgid), pgid


def test_placement_memo_equals_the_map():
    pom = convert.osdmap_from_reference(jenc.encode_osdmap(_jax_osdmap()))
    memo = osdmap.PlacementMemo()
    for pgid in _all_pgids(pom)[:40] * 2:
        assert memo.full(pom, pgid) == pom.pg_to_up_acting_full(pgid)


def test_encoding_both_directions():
    jom = _jax_osdmap()
    blob = jenc.encode_osdmap(jom)
    pom, used = encoding.decode_osdmap(blob)
    assert used == len(blob) and encoding.encode_osdmap(pom) == blob
    pom.pools[1].snap_seq = 9
    pom.primary_affinity[3] = 0x100
    mine = encoding.encode_osdmap(pom)
    theirs, used = jenc.decode_osdmap(mine)
    assert used == len(mine) and jenc.encode_osdmap(theirs) == mine
    inc = osdmap.Incremental(epoch=6, up=[7], new_pg_upmap={(1, 2): [4, 5]},
                             new_pg_upmap_primaries={(1, 9): None},
                             new_blocklist=["client.9"], removed_pools=[2])
    mine = encoding.encode_incremental(inc)
    theirs, used = jenc.decode_incremental(mine)
    assert used == len(mine) and jenc.encode_incremental(theirs) == mine


def test_convert_refuses_altered_bytes():
    jom = _jax_osdmap()
    blob = jenc.encode_osdmap(jom)
    crush_len = len(jenc.encode_crushmap(jom.crush))
    flags_at = 1 + 4 + 4 + crush_len + 4  # version, epoch, crush, count
    assert blob[flags_at] == 3  # osd.0 exists and up
    altered = bytearray(blob)
    altered[flags_at] |= 4  # a flag bit the format does not carry
    with pytest.raises(ValueError, match="re-encode"):
        convert.osdmap_from_reference(bytes(altered))
    with pytest.raises(ValueError, match="trailing"):
        convert.osdmap_from_reference(blob + b"\0")
    with pytest.raises(Exception):
        convert.osdmap_from_reference(blob[:-3])
    cblob = jenc.encode_crushmap(jom.crush)
    assert encoding.encode_crushmap(
        convert.crushmap_from_reference(cblob)) == cblob
    with pytest.raises(ValueError, match="trailing"):
        convert.crushmap_from_reference(cblob + b"\1")
    bad_version = bytes([cblob[0] + 1]) + cblob[1:]
    with pytest.raises(Exception, match="unsupported"):
        convert.crushmap_from_reference(bad_version)


SAMPLE = """
# sample map
tunable choose_total_tries 50
device 0 osd.0
device 1 osd.1
device 2 osd.2 class ssd
device 3 osd.3
device 4 osd.4
device 5 osd.5

type 0 osd
type 1 host
type 2 root

host host0 {
    id -2
    alg straw2
    hash 0
    item osd.0 weight 1.000
    item osd.1 weight 1.000
}
host host1 {
    id -3
    alg list
    hash 0
    item osd.2 weight 2.000
    item osd.3 weight 1.000
}
host host2 {
    id -4
    alg tree
    hash 0
    item osd.4 weight 1.000
    item osd.5 weight 1.500
}
root default {
    id -1
    alg straw2
    hash 0
    item host0 weight 2.000
    item host1 weight 3.000
    item host2 weight 2.500
}

rule replicated_rule {
    id 0
    type replicated
    step take default
    step chooseleaf firstn 0 type host
    step emit
}
rule ec_rule {
    id 1
    type erasure
    step set_chooseleaf_tries 5
    step take default
    step chooseleaf indep 0 type host
    step emit
}
"""


def test_compile_decompile_equal_jax():
    mine, theirs = compiler.compile(SAMPLE), jcompiler.compile(SAMPLE)
    assert encoding.encode_crushmap(mine) == jenc.encode_crushmap(theirs)
    text = compiler.decompile(mine)
    assert text == jcompiler.decompile(theirs)
    assert compiler.decompile(compiler.compile(text)) == text
    for x in _xs(100):
        assert mine.do_rule(0, x, 3) == theirs.do_rule(0, x, 3)
        assert mine.do_rule(1, x, 3) == theirs.do_rule(1, x, 3)
    for bad in ("tunable nope 1", "tunable choose_total_tries"):
        with pytest.raises(compiler.CompileError):
            compiler.compile(bad)
        with pytest.raises(jcompiler.CompileError):
            jcompiler.compile(bad)


def test_tester_host_reports_equal_jax():
    jmap, _, weights = _jax_maps()["host"]
    pmap = _carry(jmap)
    for ruleno, numrep in ((0, 3), (1, 5)):
        mine = tester.test_rule(pmap, ruleno, numrep, n_inputs=400,
                                weights=weights)
        theirs = jtester.test_rule(jmap, ruleno, numrep, n_inputs=400,
                                   weights=weights)
        assert mine.device_counts == theirs.device_counts
        assert mine.bad_mappings == theirs.bad_mappings
        assert mine.max_deviation(pmap) == theirs.max_deviation(jmap)
        on_cpu = tester.test_rule(pmap, ruleno, numrep, n_inputs=400,
                                  weights=weights, device="cpu")
        assert on_cpu.device_counts == mine.device_counts
        assert on_cpu.bad_mappings == mine.bad_mappings
