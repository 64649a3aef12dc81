"""Distributed EC over the port's device mesh
(``ceph_tpu_torch.parallel.shard_comm``): shards resident one group per
slot on the width axis, repair/encode as K1 partials combined across
slots (copies and K6's plain versions here) — twins of
``tests/test_shard_comm.py``'s four functions, bit-exact against the
host oracle for both combine strategies on an 8-slot virtual CPU mesh
(``pin_virtual(8)``, ``device="cpu"``); plus the port against the JAX
package's ``distributed_repair`` and ``distributed_encode`` on the same
numpy inputs, shard by shard through ``convert``, on the 8-device virtual
CPU platform ``tests/conftest.py`` pins. Tolerance: exact equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu import parallel as jparallel
from ceph_tpu.parallel import shard_comm as jshard_comm
from ceph_tpu_torch import convert, native, parallel
from ceph_tpu_torch.ops import gf8, rs
from ceph_tpu_torch.parallel import shard_comm

torch.set_num_threads(1)
parallel.pin_virtual(8)

K, M = 8, 3
W = 256  # words per chunk
BATCH = 8


@pytest.fixture(scope="module")
def mesh4():
    return parallel.make_mesh(parallel.get_devices(8, "cpu"), width=4)


def _setup(rng, k=K, m=M, batch=BATCH, w=W):
    mat = native.rs_matrix_vandermonde(k, m)
    data_b = rng.integers(0, 256, (batch, k, w * 4), dtype=np.uint8)
    parity_b = np.stack([gf8.gf_matmul(mat, d) for d in data_b])
    return mat, data_b, parity_b


@pytest.mark.parametrize("method", ["allgather", "psum_bits"])
def test_distributed_repair_bit_exact(mesh4, method):
    rng = np.random.default_rng(1)
    mat, data_b, parity_b = _setup(rng)
    erased = (1, 6)
    present = [i for i in range(K) if i not in erased] + [K, K + 1]
    surv = np.concatenate(
        [rs.pack_u32(data_b)[:, [i for i in range(K) if i not in erased]],
         rs.pack_u32(parity_b)[:, :2]], axis=1)  # (B, 8, W)
    xs = shard_comm.shard_placement(mesh4, surv)
    out = shard_comm.distributed_repair(mesh4, mat, K, present, xs,
                                        method=method)
    assert (rs.unpack_u32(out.numpy()) == data_b).all()
    # result is batch-sharded, chunk axis whole
    assert out.spec[0] == parallel.STRIPE_AXIS
    assert {tuple(s.data.shape) for s in out.shards} == {(BATCH // 2, K, W)}


@pytest.mark.parametrize("method", ["allgather", "psum_bits"])
def test_distributed_encode_bit_exact(mesh4, method):
    rng = np.random.default_rng(2)
    mat, data_b, parity_b = _setup(rng)
    xs = shard_comm.shard_placement(mesh4, rs.pack_u32(data_b))
    out = shard_comm.distributed_encode(mesh4, mat, xs, method=method)
    assert (rs.unpack_u32(out.numpy()) == parity_b).all()


def test_methods_agree_under_jit(mesh4):
    """The reference jits both methods in one program; the port runs
    eagerly, so the twin runs both on the same resident shards and
    compares every slot's result."""
    rng = np.random.default_rng(3)
    mat, data_b, _ = _setup(rng)
    xs = shard_comm.shard_placement(mesh4, rs.pack_u32(data_b))
    a = shard_comm.distributed_encode(mesh4, mat, xs, "allgather")
    b = shard_comm.distributed_encode(mesh4, mat, xs, "psum_bits")
    assert (a.numpy() == b.numpy()).all()
    for sa, sb in zip(a.shards, b.shards):
        assert sa.index == sb.index and torch.equal(sa.data, sb.data)


def test_uneven_split_rejected(mesh4):
    mat = native.rs_matrix_vandermonde(6, 2)  # 6 chunks over 4 slots
    xs = torch.zeros((BATCH, 6, W), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not split"):
        shard_comm.distributed_encode(mesh4, mat, xs)
    with pytest.raises(ValueError, match="unknown method"):
        shard_comm.distributed_encode(
            mesh4, native.rs_matrix_vandermonde(8, 2),
            torch.zeros((BATCH, 8, W), dtype=torch.int32), "psum")


# ------------------------------------------------ against the JAX package


def _twin(jarr, jmesh, mesh, spec, shape):
    by_dev = {s.device: s for s in jarr.addressable_shards}
    return convert.sharded_from_shards(
        mesh, spec, shape,
        [(by_dev[d].index, np.asarray(by_dev[d].data))
         for d in jmesh.devices.flat])


@pytest.mark.parametrize("method", ["allgather", "psum_bits"])
@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("k,m", [(8, 3), (3, 2)])
def test_repair_and_encode_equal_the_jax_package_shard_by_shard(k, m, width,
                                                                method):
    """k=3 survivors and k=3 data chunks over width 2 or 4 go through
    ``pad_chunk_axis`` on both sides; every slot's (index, words) equals
    the JAX shard on the device in the same mesh position."""
    rng = np.random.default_rng(k * 100 + width)
    mat, data_b, parity_b = _setup(rng, k=k, m=m, batch=8, w=32)
    mesh = parallel.make_mesh(parallel.get_devices(8, "cpu"), width=width)
    jmesh = jparallel.make_mesh(jparallel.get_devices(8), width=width)
    data = rs.pack_u32(data_b)
    lost = (1,) if k == 3 else (1, 6)
    present = [i for i in range(k) if i not in lost] + \
        [k + j for j in range(len(lost))]
    every = np.concatenate([data, rs.pack_u32(parity_b)], axis=1)
    surv = np.ascontiguousarray(every[:, present])
    rmat = gf8.decode_matrix(mat, k, present)
    cases = (("repair", rmat, surv, data), ("encode", mat, data,
                                           rs.pack_u32(parity_b)))
    for what, matrix, chunks, want in cases:
        pm, pc = shard_comm.pad_chunk_axis(matrix, chunks, width)
        if k == 3 and width > 1:
            assert pm.shape[1] == 4  # the padded chunk axis
        got = shard_comm.distributed_matmul(mesh, pm, pc, method)
        jgot = jshard_comm.distributed_matmul(jmesh, pm, pc, method)
        jax.block_until_ready(jgot)
        twin = _twin(jgot, jmesh, mesh, got.spec, got.shape)
        for mine, theirs in zip(convert.shards_of(got),
                                convert.shards_of(twin)):
            assert mine[0] == theirs[0], what
            assert np.array_equal(mine[1], theirs[1]), what
        assert np.array_equal(got.numpy(), want), what
    # the entry points the reference's tests name agree too, where the
    # survivors split without a pad
    if k % width == 0:
        rec = shard_comm.distributed_repair(mesh, mat, k, present, surv,
                                            method)
        jrec = jshard_comm.distributed_repair(
            jmesh, mat, k, present,
            jax.device_put(jnp.asarray(surv),
                           jshard_comm.shard_placement_sharding(jmesh)),
            method)
        assert np.array_equal(rec.numpy(), np.asarray(jrec))
