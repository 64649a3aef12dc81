"""The port's compressor plugins and SloppyCRCMap
(``ceph_tpu_torch.utils.compress`` / ``.sloppy_crc``) against the JAX
package's, as ``test_compress_sloppycrc.py`` runs them. Tolerance: exact
equality (bytes and integers)."""
import numpy as np
import pytest

from ceph_tpu.store import Transaction as JTransaction
from ceph_tpu.store.walstore import WalStore as JWalStore
from ceph_tpu.utils import compress as JC
from ceph_tpu.utils.sloppy_crc import SloppyCRCMap as JSloppyCRCMap
from ceph_tpu_torch.store import Transaction
from ceph_tpu_torch.store.walstore import WalStore
from ceph_tpu_torch.utils import compress as C
from ceph_tpu_torch.utils.sloppy_crc import SloppyCRCMap
from test_torch_native import jax_native_whole  # noqa: F401


@pytest.mark.parametrize("name", ["zlib", "bz2", "lzma"])
def test_compressor_roundtrip(name):
    comp = C.create(name)
    data = b"the quick brown fox " * 500
    packed = comp.compress(data)
    assert len(packed) < len(data)
    assert comp.decompress(packed) == data
    assert packed == JC.create(name).compress(data)  # same stream bytes
    assert JC.create(name).decompress(packed) == data
    assert comp.name == JC.create(name).name


def test_compressor_corrupt_stream():
    comp = C.create("zlib")
    packed = bytearray(comp.compress(b"x" * 10000))
    packed[5] ^= 0xFF
    with pytest.raises(C.CompressError):
        comp.decompress(bytes(packed))


def test_unknown_compressor():
    with pytest.raises(C.CompressError):
        C.create("snappy9000")
    assert "zlib" in C.names()
    assert C.names() == JC.names()


def test_compression_modes():
    assert not C.should_compress(C.MODE_NONE, C.HINT_COMPRESSIBLE)
    assert C.should_compress(C.MODE_FORCE, C.HINT_INCOMPRESSIBLE)
    assert C.should_compress(C.MODE_PASSIVE, C.HINT_COMPRESSIBLE)
    assert not C.should_compress(C.MODE_PASSIVE, C.HINT_NONE)
    assert C.should_compress(C.MODE_AGGRESSIVE, C.HINT_NONE)
    assert not C.should_compress(C.MODE_AGGRESSIVE, C.HINT_INCOMPRESSIBLE)
    for mode in (C.MODE_NONE, C.MODE_PASSIVE, C.MODE_AGGRESSIVE,
                 C.MODE_FORCE):
        for hint in (C.HINT_NONE, C.HINT_COMPRESSIBLE,
                     C.HINT_INCOMPRESSIBLE):
            assert C.should_compress(mode, hint) == JC.should_compress(
                mode, hint)


def test_compress_blob_ratio_gate():
    comp = C.create("zlib")
    assert C.compress_blob(comp, b"A" * 8192) == JC.compress_blob(
        JC.create("zlib"), b"A" * 8192)
    assert C.compress_blob(comp, b"A" * 8192) is not None
    incompressible = np.random.default_rng(1).integers(
        0, 256, 8192, dtype=np.uint8
    ).tobytes()
    assert C.compress_blob(comp, incompressible) is None


def test_walstore_compressed_snapshot(tmp_path):
    """Both packages checkpoint the same objects into byte-equal
    compressed snapshots, and each reads the other's."""
    for name, (store, txn) in {"torch": (WalStore, Transaction),
                               "jax": (JWalStore, JTransaction)}.items():
        s = store(str(tmp_path / name), compression="zlib")
        s.mount()
        t = txn().create_collection("c")
        t.write("c", b"big", 0, b"Z" * 100_000)  # compressible
        t.write("c", b"small", 0, b"tiny")
        s.apply_transaction(t)
        s.umount()
    snap = (tmp_path / "torch" / "snap").read_bytes()
    assert snap == (tmp_path / "jax" / "snap").read_bytes()
    assert len(snap) < 10_000  # 100 KB of Zs squashed
    for name, store in (("jax", WalStore), ("torch", JWalStore)):
        s2 = store(str(tmp_path / name), compression="zlib")
        s2.mount()
        assert s2.read("c", b"big") == b"Z" * 100_000
        assert s2.read("c", b"small") == b"tiny"
        s2.umount()


# ------------------------------------------------------- SloppyCRCMap


def test_sloppy_full_block_writes_tracked():
    m = SloppyCRCMap(block_size=16)
    data = bytes(range(64))
    m.write(0, data)
    assert len(m.crc) == 4
    assert m.read_check(0, data) == []
    bad = bytearray(data)
    bad[20] ^= 1
    assert m.read_check(0, bytes(bad)) == [16]
    jm = JSloppyCRCMap(block_size=16)
    jm.write(0, data)
    assert m.crc == jm.crc


def test_sloppy_partial_write_invalidates():
    m = SloppyCRCMap(block_size=16)
    m.write(0, bytes(64))
    m.write(8, b"xy")  # partial: block 0 forgotten
    assert 0 not in m.crc and 1 in m.crc
    junk = b"j" * 16 + bytes(48)
    assert m.read_check(0, junk) == []  # forgotten block: no report


def test_sloppy_zero_truncate():
    m = SloppyCRCMap(block_size=16)
    m.write(0, bytes(range(16)) * 4)
    m.zero(16, 16)
    assert m.read_check(16, bytes(16)) == []
    m.truncate(40)  # cuts block 2 partially, drops block 3
    assert 3 not in m.crc and 2 not in m.crc
    assert 0 in m.crc and 1 in m.crc


def test_sloppy_encode_decode():
    m = SloppyCRCMap(block_size=32)
    m.write(0, bytes(range(128)))
    m2, used = SloppyCRCMap.decode(m.encode())
    assert used == len(m.encode())
    assert m2.block_size == 32 and m2.crc == m.crc


def test_sloppy_schedule_matches_jax():
    """A seeded schedule of writes, zeros and truncates through both
    maps: equal CRC tables, encodings and read-check reports."""
    rng = np.random.default_rng(5)
    m, jm = SloppyCRCMap(block_size=64), JSloppyCRCMap(block_size=64)
    obj = bytearray(4096)
    for _ in range(60):
        op = rng.integers(0, 3)
        off = int(rng.integers(0, 3000))
        n = int(rng.integers(1, 700))
        if op == 0:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            m.write(off, data)
            jm.write(off, data)
            obj[off:off + n] = data
        elif op == 1:
            m.zero(off, n)
            jm.zero(off, n)
            obj[off:off + n] = bytes(n)
        else:
            m.truncate(off + 1000)
            jm.truncate(off + 1000)
        assert m.crc == jm.crc
    assert m.encode() == jm.encode()
    rot = bytearray(obj)
    rot[1000] ^= 0x10
    assert m.read_check(0, bytes(rot)) == jm.read_check(0, bytes(rot))
