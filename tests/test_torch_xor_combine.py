"""The XOR combines of the port's multi-device data plane
(``ceph_tpu_torch.ops.xor_combine``, K6's plain versions) against numpy,
against the matching lines of the JAX package's ``shard_comm.local_fn``
(the allgather fold, :88-91; the psum_bits planes, sum and repack,
:95-100) run as jnp ops, and ``crc_join`` against ``crc32c_np`` of whole
cells. Inputs come from numpy with a seed. Tolerance: exact equality
(integer and GF(2) functions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu_torch import kernels
from ceph_tpu_torch.device import tensor_to_words, words_to_tensor
from ceph_tpu_torch.ops import crc32c, xor_combine

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)

EDGE_N = (1, 31, 32, 33, 1027)


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("length", EDGE_N)
def test_xor_fold_equals_numpy_and_the_reference_fold(n, length):
    parts = _words(np.random.default_rng(n * 7919 + length), (n, length))
    got = tensor_to_words(xor_combine.xor_fold(words_to_tensor(parts, "cpu")))
    assert np.array_equal(got, np.bitwise_xor.reduce(parts, axis=0))
    # shard_comm.py:88-91: out = parts[0]; out = out ^ parts[i]
    jparts = jnp.asarray(parts)
    out = jparts[0]
    for i in range(1, n):
        out = out ^ jparts[i]
    assert np.array_equal(got, np.asarray(out))


def test_xor_fold_keeps_trailing_axes():
    parts = _words(np.random.default_rng(3), (4, 2, 3, 5))
    got = xor_combine.xor_fold(words_to_tensor(parts, "cpu"))
    assert tuple(got.shape) == (2, 3, 5)
    assert np.array_equal(tensor_to_words(got),
                          np.bitwise_xor.reduce(parts, axis=0))


@pytest.mark.parametrize("length", EDGE_N)
def test_bit_planes_equal_numpy_and_the_reference_planes(length):
    x = _words(np.random.default_rng(length), (2, 3, length))
    got = xor_combine.bit_planes(words_to_tensor(x, "cpu"))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (32,) + x.shape
    want = (x[None] >> np.arange(32, dtype=np.uint32)[:, None, None, None]) & 1
    assert np.array_equal(got.numpy(), want.astype(np.uint8))
    # shard_comm.py:95-96, int32 planes there; equal values here
    shifts = jnp.arange(32, dtype=jnp.uint32)
    ref = ((jnp.asarray(x)[None] >> shifts[:, None, None, None])
           & jnp.uint32(1)).astype(jnp.int32)
    assert np.array_equal(got.numpy().astype(np.int32), np.asarray(ref))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("length", EDGE_N)
def test_plane_parity_pack_equals_the_reference_sum_and_repack(n, length):
    rng = np.random.default_rng(n * 31 + length)
    partials = _words(rng, (n, length))
    planes = np.stack([((p[None] >> np.arange(32, dtype=np.uint32)[:, None])
                        & 1).astype(np.uint8) for p in partials])
    got = xor_combine.plane_parity_pack(torch.from_numpy(planes))
    # shard_comm.py:98-100 with the psum over devices as a sum over the
    # stacked axis
    shifts = jnp.arange(32, dtype=jnp.uint32)
    s = jnp.sum(jnp.asarray(planes.astype(np.int32)), axis=0)
    par = (s & 1).astype(jnp.uint32)
    ref = jnp.sum(par << shifts[:, None], axis=0, dtype=jnp.uint32)
    assert np.array_equal(tensor_to_words(got), np.asarray(ref))
    assert np.array_equal(tensor_to_words(got),
                          np.bitwise_xor.reduce(partials, axis=0))


def test_plane_parity_pack_takes_the_parity_of_any_byte_sum():
    planes = np.random.default_rng(5).integers(0, 256, (3, 32, 40),
                                               dtype=np.uint8)
    got = xor_combine.plane_parity_pack(torch.from_numpy(planes))
    par = planes.astype(np.int64).sum(axis=0) & 1
    want = (par << np.arange(32)[:, None]).sum(axis=0).astype(np.uint32)
    assert np.array_equal(tensor_to_words(got), want)


@pytest.mark.parametrize("method", ["allgather", "psum_bits"])
def test_both_combines_equal_the_xor_of_the_partials(method):
    partials = _words(np.random.default_rng(9), (4, 2, 8, 33))
    t = words_to_tensor(partials, "cpu")
    if method == "allgather":
        got = xor_combine.xor_fold(t)
    else:
        got = xor_combine.plane_parity_pack(torch.stack(
            [xor_combine.bit_planes(p) for p in t]))
    assert np.array_equal(tensor_to_words(got),
                          np.bitwise_xor.reduce(partials, axis=0))


@pytest.mark.parametrize("parts,words", [
    (1, 24), (1, 1000), (2, 8), (2, 40), (2, 1000), (4, 8), (4, 24),
    (4, 200), (4, 1000), (8, 8), (8, 24), (8, 40), (8, 200), (8, 1000)])
def test_crc_join_of_segment_crcs_equals_the_crcs_of_whole_cells(parts,
                                                                 words):
    rng = np.random.default_rng(parts * 1000 + words)
    cells = _words(rng, (5, words))
    seg = words // parts
    crc0 = torch.stack([crc32c.crc0_words(words_to_tensor(
        cells[:, j * seg:(j + 1) * seg], "cpu")) for j in range(parts)])
    zcols = crc32c.segment_shift_columns(words, parts)
    seed = crc32c.zeros_shift(crc32c.CRC_SEED, 4 * words)
    got = tensor_to_words(xor_combine.crc_join(crc0, zcols, seed))
    want = [crc32c.crc32c_np(c.tobytes()) for c in cells]
    assert got.tolist() == want


def test_segment_shift_columns_refuse_an_uneven_cut():
    with pytest.raises(ValueError, match="do not split"):
        crc32c.segment_shift_columns(10, 4)
    last = crc32c.segment_shift_columns(12, 3)[-1]
    assert last.tolist() == [1 << b for b in range(32)]  # the identity


def test_the_kernel_wrappers_take_only_cuda_tensors():
    x = torch.zeros((2, 8), dtype=torch.int32)
    for call in (lambda: kernels.xor_fold(x),
                 lambda: kernels.bit_planes(x[0]),
                 lambda: kernels.plane_parity_pack(
                     torch.zeros((1, 32, 8), dtype=torch.uint8)),
                 lambda: kernels.crc_join(x, torch.zeros((2, 32),
                                                          dtype=torch.int32),
                                          0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_ops_refuse_other_devices_and_types():
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no xor_fold kernel"):
        xor_combine.xor_fold(meta)
    with pytest.raises(TypeError, match="int32"):
        xor_combine.xor_fold(torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="not \\(n, 32"):
        xor_combine.plane_parity_pack(torch.zeros((2, 31, 4),
                                                  dtype=torch.uint8))
