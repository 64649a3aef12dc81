"""The port's Checksummer (CPU, plain CRC version) against
``ceph_tpu.checksum.Checksummer`` on both of its paths. Tolerance: exact
equality (integer checksums)."""
import numpy as np
import pytest
import torch

from ceph_tpu.checksum import Checksummer as JChecksummer
from ceph_tpu_torch.checksum import Checksummer, csum_value_size

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


@pytest.mark.parametrize("alg", ["crc32c", "crc32c_16", "crc32c_8"])
@pytest.mark.parametrize("block", [512, 4096, 65536])
def test_calculate_matches_jax(alg, block):
    rng = np.random.default_rng(block)
    data = rng.integers(0, 256, block * 6, dtype=np.uint8)
    got = Checksummer(alg, block, device="cpu").calculate(data)
    ref = JChecksummer(alg, block)
    host = ref.calculate(data)
    dev = ref.calculate(data, device=True)
    assert got.dtype == host.dtype and got.shape == (6,)
    assert np.array_equal(got, host)
    assert np.array_equal(got, dev)
    assert csum_value_size(alg) == got.dtype.itemsize


def test_init_value_and_bytes_input():
    data = bytes(range(256)) * 64
    for init in (0, 0x1234, None):
        got = Checksummer("crc32c", 1024, init_value=init,
                          device="cpu").calculate(data)
        want = JChecksummer("crc32c", 1024, init_value=init).calculate(data)
        assert np.array_equal(got, want)


def test_verify_contract():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 4096 * 5, dtype=np.uint8)
    cs = Checksummer("crc32c", 4096, device="cpu")
    jcs = JChecksummer("crc32c", 4096)
    csums = cs.calculate(data)
    assert cs.verify(data, csums) == (-1, None) == jcs.verify(data, csums)
    bad = data.copy()
    bad[4096 * 3 + 17] ^= 0x40
    off, val = cs.verify(bad, csums)
    joff, jval = jcs.verify(bad, csums)
    assert (off, val) == (joff, jval) and off == 4096 * 3
    with pytest.raises(ValueError):
        cs.verify(data, csums[:2])


def test_none_unaligned_and_unported():
    assert Checksummer("none", 4096, device="cpu").calculate(b"x" * 4096).size == 0
    with pytest.raises(ValueError):
        Checksummer("crc32c", 4096, device="cpu").calculate(b"x" * 100)
    with pytest.raises(ValueError):
        Checksummer("crc32c", 1000, device="cpu")
    with pytest.raises(ValueError):
        Checksummer("md5", 4096, device="cpu")
    for alg in ("xxhash32", "xxhash64"):  # ported: the C++ host core
        data = b"x" * 4096 * 3
        got = Checksummer(alg, 4096, device="cpu").calculate(data)
        assert np.array_equal(got, JChecksummer(alg, 4096).calculate(data))


@pytest.mark.parametrize("alg", ["xxhash32", "xxhash64"])
@pytest.mark.parametrize("init", [None, 0, 0x1234])
def test_xxhash_matches_jax(alg, init):
    data = np.random.default_rng(7).integers(0, 256, 512 * 5, dtype=np.uint8)
    cs = Checksummer(alg, 512, init_value=init, device="cpu")
    want = JChecksummer(alg, 512, init_value=init).calculate(data)
    got = cs.calculate(data)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert csum_value_size(alg) == got.dtype.itemsize
    assert cs.verify(data, got) == (-1, None)
    bad = data.copy()
    bad[512 * 2] ^= 1
    assert cs.verify(bad, got)[0] == 1024
