"""The port's fault plane (``ceph_tpu_torch.cluster.faults``) held against
the JAX package's: one seed gives equal thrash schedules (among them the
seeded verdict's, ``tools/thrash.py --seed 20260803``) and equal
per-link plans, and the plane's store arms fire draw for draw as the
reference's do. The cases of ``test_faults.py`` that need no cluster run
on the port; ``OracleWorkload`` and ``Thrasher`` take a cluster and wait
for the cluster tier. Tolerance: exact equality."""
import random

import pytest
import torch

from ceph_tpu.cluster import faults as jfaults
from ceph_tpu.utils.fault import FaultInjector as JFaultInjector
from ceph_tpu_torch.cluster import faults
from ceph_tpu_torch.cluster.faults import (FaultPlane, NetFaultPolicy,
                                           build_schedule, chip_owners)
from ceph_tpu_torch.utils.fault import FaultInjector

torch.set_num_threads(1)

#: tools/thrash.py's defaults (5 OSDs, m = 2 so two may be down, 20 s,
#: partitions on) for its seeded verdict, the proc tier's (6 OSDs, no
#: partitions), and the chip-loss, straggler and mon-flap mixes.
SCHEDULES = {
    "thrash_20260803": (20260803, 20.0, 5, dict(max_unavail=2)),
    "proc_20260803": (20260803, 20.0, 6, dict(max_unavail=2,
                                              partitions=False)),
    "chip_loss": (20260803, 20.0, 5, dict(max_unavail=2, chip_loss=True,
                                          n_chips=8)),
    "stragglers": (7, 60.0, 6, dict(max_unavail=2, stragglers=2)),
    "mon_flaps": (42, 60.0, 5, dict(max_unavail=2, mon_flaps=True)),
    "one_osd": (3, 30.0, 1, dict(max_unavail=3)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_equals_the_reference(name):
    seed, duration, n_osds, kw = SCHEDULES[name]
    got = build_schedule(seed, duration, n_osds, **kw)
    want = jfaults.build_schedule(seed, duration, n_osds, **kw)
    assert [(e.t, e.kind, e.target) for e in got] == \
        [(e.t, e.kind, e.target) for e in want]
    if n_osds > 1:
        assert len(got) > 5


def test_schedule_deterministic_and_bounded():
    s1 = build_schedule(42, 60.0, 5, max_unavail=2)
    assert s1 == build_schedule(42, 60.0, 5, max_unavail=2) and len(s1) > 10
    assert build_schedule(43, 60.0, 5, max_unavail=2) != s1
    dead, cut = set(), set()
    for ev in s1:
        if ev.kind == "kill":
            assert ev.target not in dead
            dead.add(ev.target)
        elif ev.kind == "revive":
            dead.discard(ev.target)
        elif ev.kind == "partition":
            assert not cut
            cut = {ev.target}
        elif ev.kind == "heal":
            cut = set()
        assert len(dead) + len(cut - dead) <= 2


def test_chip_loss_schedule_deterministic_and_bounded():
    kw = dict(max_unavail=2, chip_loss=True, n_chips=4)
    s1 = build_schedule(77, 120.0, 5, **kw)
    assert s1 == build_schedule(77, 120.0, 5, **kw)
    assert {"chip_loss", "chip_heal"} <= {e.kind for e in s1}
    assert all(e.kind not in ("chip_loss", "chip_heal")
               for e in build_schedule(77, 120.0, 5, max_unavail=2))
    dead, cut, dark = set(), set(), set()
    for ev in s1:
        if ev.kind == "kill":
            dead.add(ev.target)
        elif ev.kind == "revive":
            dead.discard(ev.target)
        elif ev.kind == "partition":
            cut = {ev.target}
        elif ev.kind == "heal":
            cut = set()
        elif ev.kind == "chip_loss":
            assert not dark
            dark = set(chip_owners(5, 4, ev.target))
            assert dark
        elif ev.kind == "chip_heal":
            dark = set()
        assert len(dead | (cut - dead) | (dark - dead - cut)) <= 2


def test_chip_owners_and_flip_bit_equal_the_reference():
    for n_osds, n_chips in ((5, 4), (12, 8), (3, 8)):
        for chip in range(n_chips):
            assert chip_owners(n_osds, n_chips, chip) == \
                jfaults.chip_owners(n_osds, n_chips, chip)
    for chunk in (b"", b"a", bytes(range(256)) * 3):
        assert faults.flip_bit(chunk) == jfaults.flip_bit(chunk)
    assert faults.flip_bit(b"\x00\x00\x00") == b"\x00\x01\x00"
    assert faults.STORE_SITES == jfaults.STORE_SITES


def _mix(pol):
    pol.set_link("client.0", "*", drop=0.3, dup=0.3, delay=0.002,
                 jitter=0.004, reorder=0.2)
    pol.set_link("osd.1", "osd.2", drop=0.5, symmetric=True)
    return pol


@pytest.mark.parametrize("seed", [11, 12, 20260803])
def test_net_policy_plans_equal_the_reference(seed):
    pol = _mix(NetFaultPolicy(rng=random.Random(seed)))
    ref = _mix(jfaults.NetFaultPolicy(rng=random.Random(seed)))
    pairs = [("client.0", f"osd.{i % 3}") for i in range(64)] + \
        [("osd.2", "osd.1"), ("osd.1", "osd.2"), ("osd.0", "mon")] * 20
    assert [pol.plan(*p) for p in pairs] == [ref.plan(*p) for p in pairs]
    assert pol.counters == ref.counters
    plans = [pol.plan("client.0", "osd.0") for _ in range(64)]
    assert any(x is None for x in plans)
    assert any(x is not None and len(x) == 2 for x in plans)
    assert any(x is not None and x[0] > 0 for x in plans)


def test_unfaulted_traffic_never_draws():
    pol = NetFaultPolicy(rng=random.Random(5))
    pol.set_link("osd.9", "osd.8", drop=1.0)
    state = pol.rng.getstate()
    assert [pol.plan("client.0", "osd.1") for _ in range(10)] == [[0.0]] * 10
    assert pol.rng.getstate() == state
    assert pol.plan("osd.9", "osd.8") is None and pol.counters == {"drop": 1}


def test_partition_blocks_and_heals():
    p = NetFaultPolicy()
    p.partition({"osd.3"}, {"*"})
    assert p.partitions == [(frozenset({"osd.3"}), frozenset({"*"}))]
    assert p.plan("osd.3", "mon") is None
    assert p.plan("client.0", "osd.3") is None
    assert p.plan("client.0", "osd.1") == [0.0]
    assert p.plan("osd.1", "osd.2") == [0.0]
    p.heal()
    assert p.plan("osd.3", "mon") == [0.0]
    p.blackholes.add("osd.4")
    assert p.plan("osd.4", "mon") is None
    p.set_link("a", "b", drop=1.0)
    p.clear()
    assert p.plan("osd.4", "mon") == [0.0] and p.plan("a", "b") == [0.0]
    assert p.counters == {"partition_drop": 2, "blackhole": 1}


class _OSD:
    def __init__(self, osd_id: int, injector):
        self.id, self.fault = osd_id, injector


def test_fault_plane_arms_fire_as_the_reference_draw_for_draw():
    """Store arms on every attached OSD, scoped arms, re-arm on revive,
    single-site heal, and the plane's seeded streams: the port's plane
    and the reference's, driven alike, fire on the same hits."""
    def drive(plane_cls, injector_cls):
        plane = plane_cls(seed=20260803)
        osds = [_OSD(i, injector_cls()) for i in range(4)]
        for o in osds:
            plane.attach_osd(o)
        plane.store_fault("ec_read_bitflip", p=0.3)
        plane.store_fault("ec_batch", p=1.0, osd_ids=[1])
        fired = []
        for step in range(200):
            o = osds[step % 4]
            fired.append((o.fault.hit("ec_read_bitflip", oid=b"x"),
                          o.fault.hit("ec_batch")))
        revived = _OSD(1, injector_cls())
        plane.attach_osd(revived)  # comes back with its scoped arm
        fired.append(revived.fault.hit("ec_batch"))
        counts = plane.injected()  # disarming drops an arm's count
        plane.clear_store_fault("ec_batch")
        fired.append(revived.fault.hit("ec_batch"))
        fired.append([plane.net.plan("a", "b") for _ in range(3)])
        plane.slow_osd([2], scale=0.01)
        plane.slow_osd([])
        plane.clear_store_faults()
        fired.append(osds[0].fault.hit("ec_read_bitflip"))
        return fired, counts

    got, got_counts = drive(FaultPlane, FaultInjector)
    want, want_counts = drive(jfaults.FaultPlane, JFaultInjector)
    assert got == want and got_counts == want_counts
    bitflips = sum(f[0] for f in got[:200])
    assert 30 < bitflips < 90
    assert sum(f[1] for f in got[:200]) == 50  # osd.1's every fourth step
    assert got[200] is True and got[201] is False and got[-1] is False
    assert got_counts == {"ec_batch": 51, "ec_read_bitflip": bitflips}
