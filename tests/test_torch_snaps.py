"""The port's snapshot model (``ceph_tpu_torch.cluster.snaps``): the SnapSet
units of ``test_snaps.py`` on the port, and SnapSets, clone oids and
interval sets held against the JAX package's over seeded cases (equal
bytes, equal resolutions). The cluster cases of ``test_snaps.py``
(clone-on-write, read at a snap, trimming, kill and revive) wait for the
cluster tier. Tolerance: exact equality."""
import random

import pytest
import torch

from ceph_tpu.cluster import snaps as jsn
from ceph_tpu_torch.cluster import snaps as sn
from ceph_tpu_torch.store.base import CLONE_PREFIX

torch.set_num_threads(1)


def test_resolve_clone_membership():
    ss = sn.SnapSet(seq=5, clones=[sn.Clone(5, [5, 4, 3])])
    assert ss.resolve(4) == 5
    assert ss.resolve(1) is None
    assert ss.resolve(6) == sn.NOSNAP
    assert ss.resolve(sn.NOSNAP) == sn.NOSNAP


def test_resolve_trimmed_hole():
    ss = sn.SnapSet(seq=5, clones=[sn.Clone(5, [5, 3])])
    assert ss.resolve(4) is None
    assert ss.resolve(3) == 5


def test_resolve_all_clones_trimmed():
    ss = sn.SnapSet(seq=5, clones=[])
    assert ss.resolve(3) is None
    assert ss.resolve(6) == sn.NOSNAP


def test_snapset_encode_roundtrip():
    ss = sn.SnapSet(seq=9, clones=[sn.Clone(4, [4, 2], 100),
                                   sn.Clone(9, [9], 5000)])
    dec, used = sn.SnapSet.decode(ss.encode())
    assert dec == ss and used == len(ss.encode())


def test_interval_ops():
    iv = sn.interval_insert([], 3, 4)
    iv = sn.interval_insert(iv, 7, 8)
    iv = sn.interval_insert(iv, 4, 7)
    assert iv == [(3, 8)]
    assert sn.interval_contains(iv, 5)
    assert not sn.interval_contains(iv, 8)
    assert sn.interval_diff_ids([(3, 8)], [(4, 6)]) == [3, 6, 7]


def test_clone_oid_roundtrip():
    coid = sn.clone_oid(b"my-object", 77)
    assert coid.startswith(CLONE_PREFIX) and sn.is_clone_oid(coid)
    assert not sn.is_clone_oid(b"my-object")
    assert sn.parse_clone_oid(coid) == (b"my-object", 77)


def _snapset(pkg, rng: random.Random):
    seq, clones = 0, []
    for _ in range(rng.randrange(6)):
        seq += rng.randrange(1, 5)
        snaps = sorted(rng.sample(range(max(1, seq - 6), seq + 1),
                                  rng.randrange(1, min(4, seq) + 1)),
                       reverse=True)
        clones.append(pkg.Clone(seq, snaps, rng.randrange(1 << 20)))
    return pkg.SnapSet(seq=seq + rng.randrange(3), clones=clones)


@pytest.mark.parametrize("seed", range(8))
def test_snapsets_equal_the_reference(seed):
    ss = _snapset(sn, random.Random(seed))
    jss = _snapset(jsn, random.Random(seed))
    assert ss.encode() == jss.encode()
    assert sn.SnapSet.decode(jss.encode())[0] == ss
    for snapid in list(range(ss.seq + 3)) + [sn.NOSNAP]:
        assert ss.resolve(snapid) == jss.resolve(snapid)
    assert sn.NOSNAP == jsn.NOSNAP


@pytest.mark.parametrize("seed", range(4))
def test_intervals_and_clone_oids_equal_the_reference(seed):
    rng = random.Random(seed)
    iv, jiv = [], []
    for _ in range(30):
        lo = rng.randrange(100)
        hi = lo + rng.randrange(1, 6)
        iv, jiv = sn.interval_insert(iv, lo, hi), jsn.interval_insert(jiv, lo,
                                                                       hi)
        assert iv == jiv
    other = sn.interval_insert([], 10, 40)
    assert sn.interval_diff_ids(iv, other) == jsn.interval_diff_ids(jiv, other)
    assert [sn.interval_contains(iv, x) for x in range(110)] == \
        [jsn.interval_contains(jiv, x) for x in range(110)]
    oid = rng.randbytes(rng.randrange(1, 30))
    cid = rng.randrange(1 << 63)
    assert sn.clone_oid(oid, cid) == jsn.clone_oid(oid, cid)
    assert sn.parse_clone_oid(jsn.clone_oid(oid, cid)) == (oid, cid)
