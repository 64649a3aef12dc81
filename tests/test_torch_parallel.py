"""The port's parallel/ helpers (``ceph_tpu_torch.parallel``): mesh
factoring, placements, the pads — twins of ``tests/test_parallel.py``'s
seven functions on an 8-slot virtual mesh over the CPU
(``pin_virtual(8)``, ``device="cpu"``). Where the reference checks a
``jax.sharding`` object, the twin checks the port's ``Mesh`` and
placements and holds each slot's piece (index and words) against the
JAX package's shard on the device in the same mesh position, on the
8-device virtual CPU platform ``tests/conftest.py`` pins. Tolerance:
exact equality."""
import jax
import numpy as np
import pytest
import torch

from ceph_tpu import parallel as jparallel
from ceph_tpu_torch import convert, parallel

torch.set_num_threads(1)
parallel.pin_virtual(8)

K, SU_WORDS = 3, 16


@pytest.fixture(scope="module")
def devs():
    return parallel.get_devices(8, "cpu")


@pytest.fixture(scope="module")
def jdevs():
    return jparallel.get_devices(8)


# ------------------------------------------------------------ make_mesh


def test_make_mesh_width_factoring(devs):
    m1 = parallel.make_mesh(devs, width=1)
    assert dict(m1.shape) == {"stripe": 8, "width": 1}
    m4 = parallel.make_mesh(devs, width=4)
    assert dict(m4.shape) == {"stripe": 2, "width": 4}
    m8 = parallel.make_mesh(devs, width=8)
    assert dict(m8.shape) == {"stripe": 1, "width": 8}
    # a mesh over a slot subset factors that subset
    m6 = parallel.make_mesh(devs[:6], width=3)
    assert dict(m6.shape) == {"stripe": 2, "width": 3}
    # slots keep their own ids on one device (a virtual mesh)
    assert [s.id for s in m4.devices.flat] == list(range(8))
    assert {str(s.device) for s in m4.devices.flat} == {"cpu"}
    assert m4.virtual and m4.devices.shape == (2, 4)


def test_make_mesh_rejects_nondividing_width(devs):
    with pytest.raises(ValueError, match="does not divide"):
        parallel.make_mesh(devs, width=3)


# ----------------------------------------------------- placement specs


def _shard_shapes(arr):
    """{index -> local shard shape} with replica dedup by index."""
    seen = {}
    for s in arr.shards:
        seen.setdefault(tuple((sl.start, sl.stop) for sl in s.index),
                        tuple(s.data.shape))
    return list(seen.values())


def _same_as_reference(arr, jarr, jmesh):
    """Slot p's index and words equal the reference's shard on the device
    at mesh position p."""
    by_dev = {s.device: s for s in jarr.addressable_shards}
    pieces = [(by_dev[d].index, np.asarray(by_dev[d].data))
              for d in jmesh.devices.flat]
    twin = convert.sharded_from_shards(arr.mesh, arr.spec, arr.shape, pieces)
    for mine, theirs in zip(convert.shards_of(arr), convert.shards_of(twin)):
        assert mine[0] == theirs[0]
        assert np.array_equal(mine[1], theirs[1])


def test_chunk_batch_vs_per_stripe_vs_replicated_placement(devs, jdevs):
    mesh = parallel.make_mesh(devs, width=4)  # stripe 2, width 4
    jmesh = jparallel.make_mesh(jdevs, width=4)
    batch = np.arange(8 * K * SU_WORDS, dtype=np.uint32).reshape(
        8, K, SU_WORDS)

    cb = parallel.chunk_batch(mesh, batch)
    # batch split over stripe (8/2), words over width (16/4), the
    # chunk axis REPLICATED — the "EC shard axis stays local" layout
    assert _shard_shapes(cb) == [(4, K, 4)] * 8
    assert cb.spec[0] == parallel.STRIPE_AXIS and cb.spec[2] == \
        parallel.WIDTH_AXIS
    _same_as_reference(cb, jax.device_put(
        batch, jparallel.chunk_batch_sharding(jmesh)), jmesh)

    stripes = np.arange(8, dtype=np.uint32)
    ps = parallel.per_stripe(mesh, stripes)
    # per-stripe scalars: one batch block per stripe row, width
    # replicates (2 unique blocks across the 8 slots)
    assert sorted(s[0] for s in _shard_shapes(ps)) == [4, 4]
    _same_as_reference(ps, jax.device_put(
        stripes, jparallel.per_stripe_sharding(jmesh)), jmesh)

    rp = parallel.replicated(mesh, stripes)
    # fully replicated: ONE unique (whole) block
    assert _shard_shapes(rp) == [(8,)]
    _same_as_reference(rp, jax.device_put(
        stripes, jparallel.replicated(jmesh)), jmesh)

    # round-trips preserve content
    assert (cb.numpy() == batch).all()
    assert (ps.numpy() == stripes).all()
    # each slot holds a copy of its own, not a view of the input
    ptrs = {s.data.data_ptr() for s in rp.shards}
    assert len(ptrs) == 8


def test_shard_placement_puts_chunks_on_width_devices(devs, jdevs):
    from ceph_tpu.parallel import shard_comm as jshard_comm
    from ceph_tpu_torch.parallel import shard_comm

    mesh = parallel.make_mesh(devs, width=4)
    jmesh = jparallel.make_mesh(jdevs, width=4)
    batch = np.random.default_rng(1).integers(
        0, 2**32, (4, 8, SU_WORDS), dtype=np.uint32)
    xs = shard_comm.shard_placement(mesh, batch)
    # chunk axis over width: 8 chunks / 4 width slots = 2 resident
    # chunk rows per slot, batch over stripe
    assert _shard_shapes(xs) == [(2, 2, SU_WORDS)] * 8
    _same_as_reference(xs, jax.device_put(
        batch, jshard_comm.shard_placement_sharding(jmesh)), jmesh)


# ------------------------------------------------------------- padding


def test_pad_batch_pow2_is_single_pad(devs, jdevs):
    # no mesh: plain next power of two
    assert [parallel.pad_batch_pow2(n) for n in (1, 2, 3, 5, 8, 9)] \
        == [1, 2, 4, 8, 8, 16]
    m6 = parallel.make_mesh(devs[:6], width=1)  # stripe axis 6
    assert parallel.pad_batch_pow2(5, m6) == 6
    assert parallel.pad_batch_pow2(7, m6) == 12
    assert parallel.pad_batch_pow2(13, m6) == 24
    m8 = parallel.make_mesh(devs, width=2)  # stripe axis 4
    # batch < devices: one stripe still pads to a full stripe row
    assert parallel.pad_batch_pow2(1, m8) == 4
    assert parallel.pad_batch_pow2(5, m8) == 8
    j6 = jparallel.make_mesh(jdevs[:6], width=1)
    j8 = jparallel.make_mesh(jdevs, width=2)
    for n in range(1, 40):
        for mesh, jmesh in ((m6, j6), (m8, j8)):
            p = parallel.pad_batch_pow2(n, mesh)
            assert p == jparallel.pad_batch_pow2(n, jmesh)
            assert p >= n and p % mesh.shape["stripe"] == 0
            share = p // mesh.shape["stripe"]
            assert share & (share - 1) == 0
            assert parallel.pad_batch(n, mesh) == jparallel.pad_batch(n, jmesh)


def test_pow2_pad_uses_mesh_aware_target(devs):
    """The port's batcher pads a mesh batch once, to a multiple of the
    stripe axis (``parallel.pad_batch``), and never to a power of two:
    its kernels take any batch, and the pow2 pad only capped XLA
    recompiles (ROADMAP guardrails). So where the reference's
    ``_pow2_pad`` gives 8 for 5 stripes without a mesh and 6 over a
    6-stripe mesh, the port keeps 5 without a mesh (it does not pad)
    and gives 6 over the mesh; 13 stripes pad to 18, not 24."""
    from ceph_tpu_torch.cluster.ecbatch import ECBatcher

    m6 = parallel.make_mesh(devs[:6], width=1)
    batch = np.zeros((5, K, SU_WORDS), dtype=np.uint32)
    assert len(ECBatcher._mesh_pad(batch, m6)) == 6
    assert ECBatcher._mesh_pad(np.zeros((6, K, 1), np.uint32), m6).shape[0] \
        == 6
    assert len(ECBatcher._mesh_pad(np.zeros((13, K, 1), np.uint32), m6)) \
        == 18
    padded = ECBatcher._mesh_pad(np.ones((7, K, 2), np.uint32), m6)
    assert padded.shape == (12, K, 2)
    assert (padded[7:] == 0).all() and (padded[:7] == 1).all()


def test_pad_chunk_axis_zero_extends_matrix_and_chunks():
    from ceph_tpu_torch.parallel import shard_comm

    mat = np.arange(6, dtype=np.uint8).reshape(2, 3)
    chunks = np.ones((4, 3, SU_WORDS), dtype=np.uint32)
    m2, c2 = shard_comm.pad_chunk_axis(mat, chunks, 2)
    assert m2.shape == (2, 4) and (m2[:, 3] == 0).all()
    assert c2.shape == (4, 4, SU_WORDS) and (c2[:, 3] == 0).all()
    # already divisible: untouched objects pass through
    m1, c1 = shard_comm.pad_chunk_axis(mat, chunks, 3)
    assert m1 is mat and c1 is chunks


# ------------------------------------------------- the port's own choices


def test_get_devices_raises_beyond_the_pinned_virtual_mesh():
    assert len(parallel.get_devices(8, "cpu")) == 8
    with pytest.raises(RuntimeError, match="pin_virtual"):
        parallel.get_devices(parallel.virtual_slots() + 1, "cpu")


def test_placement_refuses_an_uneven_split(devs):
    mesh = parallel.make_mesh(devs, width=4)
    with pytest.raises(ValueError, match="does not split"):
        parallel.chunk_batch(mesh, np.zeros((8, K, 6), np.uint32))
    with pytest.raises(ValueError, match="does not split"):
        parallel.per_stripe(mesh, np.zeros(3, np.uint32))


def test_meshes_over_the_same_slots_are_equal(devs):
    a, b = parallel.make_mesh(devs, width=2), parallel.make_mesh(devs, width=2)
    assert a == b and hash(a) == hash(b)
    assert a != parallel.make_mesh(devs, width=4)
