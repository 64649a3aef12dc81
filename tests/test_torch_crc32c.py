"""The port's CRC32C (plain version on the CPU, and the CUDA kernel's
segment product and joins emulated with its own host constants) against
the JAX package. Tolerance: exact equality (integer-only arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import crc32c as jcrc
from ceph_tpu_torch import kernels
from ceph_tpu_torch.convert import batch_to_device, batch_to_numpy
from ceph_tpu_torch.ops import crc32c as crc
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(5, 1024), (3, 4099), (7, 31), (2, 3, 64),
                                   (4, 1), (65536,)])
@pytest.mark.parametrize("seed", [0xFFFFFFFF, 0, 0x12345678])
def test_crc32c_batch_against_jax(shape, seed):
    rng = np.random.default_rng(sum(shape))
    blobs = rng.integers(0, 256, shape, dtype=np.uint8)
    got = crc.crc32c_batch(blobs, seed=seed, device="cpu")
    assert got.dtype == np.uint32 and got.shape == shape[:-1]
    assert np.array_equal(got, jcrc.crc32c_batch(blobs, seed=seed))


@pytest.mark.parametrize("nb,blob", [(5, 1024), (130, 4096)])
def test_crc0_against_pallas_interpret(nb, blob):
    rng = np.random.default_rng(7)
    blobs = rng.integers(0, 256, (nb, blob), dtype=np.uint8)
    words = crc.pack_blobs(blobs)
    got = batch_to_numpy(crc.crc0_words(batch_to_device(words, "cpu")))
    want = np.asarray(jcrc.crc32c_words_pallas(jnp.asarray(words),
                                               interpret=True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w", [1, 3, 100, 1000, 257])
def test_cells_device_non_power_of_two(w):
    rng = np.random.default_rng(w)
    cells = rng.integers(0, 2**32, (2, 3, w), dtype=np.uint32)
    got = crc.crc32c_cells_device(batch_to_device(cells, "cpu"), 4 * w)
    want = jcrc.crc32c_cells_device(jnp.asarray(cells), 4 * w)
    assert np.array_equal(batch_to_numpy(got), np.asarray(want))
    # seed folded with the true length, never the padded one
    one = cells[0, 0].tobytes()
    assert int(batch_to_numpy(got)[0, 0]) == jcrc.crc32c_np(one)


def test_words_device_and_scalar_reference():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**32, (4, 64), dtype=np.uint32)
    shifted = crc.zeros_shift(0xFFFFFFFF, 256)
    got = crc.crc32c_words_device(batch_to_device(words, "cpu"), shifted)
    want = jcrc.crc32c_words_device(jnp.asarray(words), shifted)
    assert np.array_equal(batch_to_numpy(got), np.asarray(want))
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3):
        assert crc.crc32c_np(data) == jcrc.crc32c_np(data)
    # CRC-32C check value (Ceph keeps the state un-inverted)
    assert crc.crc32c_np(b"123456789") ^ 0xFFFFFFFF == 0xE3069283


@pytest.mark.parametrize("n", [0, 1, 3, 255, 256, 4096, 524288, 1 << 20])
def test_zeros_shift_against_jax(n):
    for v in (0xFFFFFFFF, 1, 0x80000000):
        assert crc.zeros_shift(v, n) == jcrc.zeros_shift(v, n)


def test_pack_blobs_matches_jax():
    b = np.random.default_rng(0).integers(0, 256, (3, 37), dtype=np.uint8)
    assert np.array_equal(crc.pack_blobs(b), jcrc.pack_blobs(b))


def _kernel_emulation(words: np.ndarray) -> np.ndarray:
    """crc32c.cu's algorithm in scalar Python with the constants the
    wrapper hands it: front-padded rows of seg-word segments, each
    segment's CRC bit o the parity of popc(word & B) summed over the
    segment's words, segments joined by Z_{4 seg}, rows by the tree."""
    n, w = words.shape
    seg, subs, nseg = crc.crc_plan(w)
    frags = crc.b1_fragments(seg)  # [ch, kk, j, lane 4n+t, h]
    z = crc.join_columns(w)

    def b_word(i: int, out_bit: int) -> int:
        """The 32 K bits of B for word i of a segment, output bit out_bit."""
        ch, rest = divmod(i, 32)
        t, rest = divmod(rest, 8)
        h, kk = divmod(rest, 4)
        j = (out_bit & 7) >> 1
        col = 2 * (out_bit >> 3) + (out_bit & 1)
        return int(frags[ch, kk, j, 4 * col + t, h])

    def apply(cols, x):
        acc = 0
        for b in range(32):
            if (x >> b) & 1:
                acc ^= int(cols[b])
        return acc

    out = []
    for blob in words:
        padded = [0] * (nseg * subs * seg - w) + [int(v) for v in blob]
        part = []
        for r in range(nseg):
            c = 0
            for s_ in range(subs):
                base = (r * subs + s_) * seg
                sub = 0
                for o in range(32):
                    pop = sum(bin(padded[base + i] & b_word(i, o)).count("1")
                              for i in range(seg))
                    sub |= (pop & 1) << o
                c = apply(z[0], c) ^ sub
            part.append(c)
        level = 0
        while len(part) > 1:
            part = [apply(z[1 + level], part[i]) ^ part[i + 1]
                    for i in range(0, len(part), 2)]
            level += 1
        out.append(part[0])
    return np.array(out, dtype=np.uint32)


@pytest.mark.parametrize("w", [1, 3, 100, 256, 600])
def test_kernel_algorithm_and_constants(w):
    rng = np.random.default_rng(w + 1)
    words = rng.integers(0, 2**32, (2, w), dtype=np.uint32)
    want = np.array([jcrc.crc32c_np(b.tobytes(), 0) for b in words],
                    dtype=np.uint32)
    assert np.array_equal(_kernel_emulation(words), want)
    assert crc.join_columns(w).shape == (kernels.CRC_LEVELS + 1, 32)
