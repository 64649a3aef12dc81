"""The port's GF(2^8) matmul (plain version, on the CPU) against the JAX
package: the Pallas kernel in interpret mode, the SWAR XLA path and the
host byte oracle. Tolerance: exact equality (integer-only arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf8 as jgf8
from ceph_tpu.ops import rs as jrs
from ceph_tpu_torch import kernels
from ceph_tpu_torch.convert import batch_to_device, batch_to_numpy
from ceph_tpu_torch.ops import rs
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


def _port(mat, words):
    return batch_to_numpy(rs.gf_matmul(mat, batch_to_device(words, "cpu")))


@pytest.mark.parametrize(
    "r,c,w",
    [(3, 8, 1024), (1, 2, 128), (8, 8, 512), (4, 6, 384), (2, 5, 256)],
)
def test_matches_pallas_swar_and_host(r, c, w):
    rng = np.random.default_rng(r * 100 + c)
    mat = rng.integers(0, 256, (r, c), dtype=np.uint8)
    data = rng.integers(0, 256, (3, c, w * 4), dtype=np.uint8)
    words = rs.pack_u32(data)
    got = _port(mat, words)
    pallas = np.asarray(jrs.gf_matmul_pallas(mat, jnp.asarray(words),
                                             interpret=True))
    swar = np.asarray(jrs.gf_matmul_u32(mat, jnp.asarray(words)))
    host = rs.pack_u32(np.stack([jgf8.gf_matmul(mat, d) for d in data]))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, swar)
    assert np.array_equal(got, host)


@pytest.mark.parametrize("lead,w", [((), 1), ((), 37), ((2,), 100),
                                    ((2, 3), 5), ((1,), 1000)])
def test_batch_dims_and_odd_widths(lead, w):
    rng = np.random.default_rng(w)
    mat = jgf8.vandermonde_rs_matrix(6, 3)
    words = rng.integers(0, 2**32, lead + (6, w), dtype=np.uint32)
    got = _port(mat, words)
    assert got.shape == lead + (3, w)
    assert np.array_equal(got, np.asarray(jrs.gf_matmul_u32(
        mat, jnp.asarray(words))))


def test_zero_row_identity_row_and_strided_input():
    rng = np.random.default_rng(4)
    mat = rng.integers(0, 256, (4, 5), dtype=np.uint8)
    mat[1] = 0
    mat[2] = 0
    mat[2, 3] = 1
    words = rng.integers(0, 2**32, (2, 5, 2, 64), dtype=np.uint32)
    strided = batch_to_device(words, "cpu")[:, :, 1]  # not contiguous
    got = batch_to_numpy(rs.gf_matmul(mat, strided))
    want = np.asarray(jrs.gf_matmul_u32(mat, jnp.asarray(words[:, :, 1])))
    assert np.array_equal(got, want)
    assert not got[:, 1].any()
    assert np.array_equal(got[:, 2], words[:, 3, 1])


def test_encode_decode_round_trip_against_jax():
    rng = np.random.default_rng(8)
    mat = jgf8.vandermonde_rs_matrix(8, 3)
    data = rng.integers(0, 2**32, (4, 8, 256), dtype=np.uint32)
    parity = rs.encode(mat, batch_to_device(data, "cpu"))
    assert np.array_equal(batch_to_numpy(parity),
                          np.asarray(jrs.encode(mat, jnp.asarray(data))))
    full = np.concatenate([data, batch_to_numpy(parity)], axis=1)
    present = [0, 2, 3, 4, 5, 7, 8, 9]
    surv = full[:, present]
    got = rs.decode(mat, 8, present, batch_to_device(surv, "cpu"))
    assert np.array_equal(batch_to_numpy(got), data)
    assert np.array_equal(batch_to_numpy(got), np.asarray(
        jrs.decode(mat, 8, present, jnp.asarray(surv))))


@pytest.mark.parametrize("w", [256, 100])
def test_encode_with_crcs_against_jax(w):
    rng = np.random.default_rng(w)
    mat = jgf8.cauchy_good_matrix(4, 2)
    data = rng.integers(0, 2**32, (3, 4, w), dtype=np.uint32)
    parity, crcs = rs.encode_with_crcs(mat, 4 * w, batch_to_device(data, "cpu"))
    jparity, jcrcs = jrs.encode_with_crcs(mat, 4 * w, jnp.asarray(data))
    assert np.array_equal(batch_to_numpy(parity), np.asarray(jparity))
    assert np.array_equal(batch_to_numpy(crcs), np.asarray(jcrcs))


def test_helpers_match_jax():
    for n, parts in [(10, 3), (7, 7), (3, 8), (1, 4), (100, 6)]:
        assert rs.row_blocks(n, parts) == jrs.row_blocks(n, parts)
    b = np.random.default_rng(1).integers(0, 256, (3, 64), dtype=np.uint8)
    assert np.array_equal(rs.pack_u32(b), jrs.pack_u32(b))
    assert np.array_equal(rs.unpack_u32(rs.pack_u32(b)), b)


def test_kernel_wrapper_refuses_cpu_and_other_devices():
    x = torch.zeros((1, 2, 4), dtype=torch.int32)
    frags = torch.zeros((1, 1, 16, 32, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gf_matmul(x, frags, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.crc32c(x, None, torch.zeros((1, 4, 4, 32, 2), dtype=torch.int32),
                       torch.zeros((9, 32), dtype=torch.int32), 32, 1, 0)
    with pytest.raises(ValueError, match="no GF matmul kernel"):
        rs.gf_matmul(np.ones((1, 2), np.uint8), x.to("meta"))
    with pytest.raises(TypeError):
        rs.gf_matmul(np.ones((1, 2), np.uint8), x.to(torch.int64))
