"""The port's native runtime core (``ceph_tpu_torch.native.rt``: KV store,
block device, bitmap allocator) against the JAX package's
(``ceph_tpu.native.rt``), entry by entry as ``test_rt.py`` runs it: the
same calls on both, with equal results and byte-equal files on disk.
Tolerance: exact equality (bytes and integers)."""
import os

import pytest

from ceph_tpu.native import rt as jrt
from ceph_tpu_torch.native import rt
from test_torch_native import jax_native_whole  # noqa: F401

RTS = {"torch": rt, "jax": jrt}


def _files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_library_is_the_ports_own_build():
    path = rt.library()
    assert path.parent.name == "build"
    assert path.parent.parent.name == "ceph_tpu_torch"
    assert path.name.startswith("rt_native-")
    assert "ceph_tpu/native" not in str(rt.lib()._name)
    assert rt.lib()._name == str(path)


# ------------------------------------------------------------------- kv

def test_kv_basics(tmp_path):
    for name, mod in RTS.items():
        kv = mod.NativeKV(tmp_path / name)
        kv.put(b"a", b"1")
        kv.put(b"b", b"2")
        kv.put(b"c\x00x", b"3")  # embedded NUL is legal
        assert kv.get(b"a") == b"1"
        assert kv.get(b"zz") is None
        kv.delete(b"a")
        assert kv.get(b"a") is None
        kv.batch([("put", b"d", b"4"), ("put", b"e", b"5"),
                  ("del", b"b", None)])
        assert kv.get(b"b") is None and kv.get(b"e") == b"5"
        assert [k for k, _ in kv.scan()] == [b"c\x00x", b"d", b"e"]
        assert kv.scan(b"d", b"e") == [(b"d", b"4")]
        assert kv.scan_prefix(b"c") == [(b"c\x00x", b"3")]
        assert kv.count() == 3
        kv.close()
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_kv_reopen_replays_wal(tmp_path):
    for name, mod in RTS.items():
        kv = mod.NativeKV(tmp_path / name)
        kv.put(b"k", b"v")
        kv.compact()
        assert kv.wal_size() == 0
        kv.put(b"post", b"snap")  # lives only in the WAL
        kv.close()
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    # each package replays the other's snapshot + WAL
    for name, mod in (("jax", rt), ("torch", jrt)):
        kv = mod.NativeKV(tmp_path / name)
        assert kv.get(b"k") == b"v" and kv.get(b"post") == b"snap"
        kv.close()


def test_kv_torn_tail_discarded_then_appendable(tmp_path):
    kv = rt.NativeKV(tmp_path / "kv")
    kv.put(b"good", b"1")
    kv.close()
    with open(tmp_path / "kv" / "kv.wal", "ab") as f:
        f.write(b"\x40\x00\x00\x00GARB")  # torn record header + garbage
    kv = rt.NativeKV(tmp_path / "kv")
    assert kv.count() == 1
    kv.put(b"after", b"2")  # must land where the garbage was truncated
    kv.close()
    kv = jrt.NativeKV(tmp_path / "kv")  # the reference reads it back
    assert kv.get(b"after") == b"2" and kv.get(b"good") == b"1"
    kv.close()


def test_kv_corrupt_record_crc(tmp_path):
    kv = rt.NativeKV(tmp_path / "kv")
    kv.put(b"a", b"1")
    kv.put(b"b", b"2")
    kv.close()
    wal = tmp_path / "kv" / "kv.wal"
    blob = bytearray(wal.read_bytes())
    blob[-1] ^= 0xFF  # flip a bit in the last record's body
    wal.write_bytes(bytes(blob))
    kv = rt.NativeKV(tmp_path / "kv")
    assert kv.get(b"a") == b"1"
    assert kv.get(b"b") is None  # corrupt tail record dropped
    kv.close()


def test_kv_corrupt_snapshot_rejected(tmp_path):
    kv = rt.NativeKV(tmp_path / "kv")
    kv.put(b"key", b"value" * 100)
    kv.compact()
    kv.close()
    sst = tmp_path / "kv" / "kv.sst"
    blob = bytearray(sst.read_bytes())
    blob[30] ^= 0x01
    sst.write_bytes(bytes(blob))
    with pytest.raises(rt.KvError):
        rt.NativeKV(tmp_path / "kv")
    with pytest.raises(jrt.KvError):  # the reference refuses it too
        jrt.NativeKV(tmp_path / "kv")


def test_kv_batch_atomic_on_malformed(tmp_path):
    kv = rt.NativeKV(tmp_path / "kv")
    kv.put(b"x", b"1")
    with pytest.raises(ValueError):
        kv.batch([("put", b"y", b"2"), ("nope", b"z", b"3")])
    assert kv.get(b"y") is None  # nothing half-applied
    kv.close()
    with pytest.raises(rt.KvError, match="closed"):
        kv.get(b"x")


@pytest.mark.parametrize("prefix,end", [
    (b"abc", b"abd"), (b"a\xff", b"b"),
    (b"\xff\xff", b""),  # all 0xFF: scan to the end
    (b"", b""), (b"\x00", b"\x01"), (b"z\xff\x00", b"z\xff\x01")])
def test_kv_prefix_end_edge_cases(prefix, end):
    assert rt._prefix_end(prefix) == end == jrt._prefix_end(prefix)


def test_kv_batch_wire_form_matches(tmp_path):
    """Batches of every op kind, many keys: the WAL record bytes (the
    batch payload with its length and CRC framing) equal the
    reference's, and after compaction so do the snapshot bytes."""
    ops = [("put", b"k%03d" % i, bytes([i]) * (i % 17)) for i in range(200)]
    ops += [("del", b"k%03d" % i, None) for i in range(0, 200, 7)]
    for name, mod in RTS.items():
        kv = mod.NativeKV(tmp_path / name)
        kv.batch(ops[:120])
        kv.batch(ops[120:])
        kv.close()
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    for name, mod in RTS.items():
        kv = mod.NativeKV(tmp_path / name)
        kv.compact()
        kv.close()
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


# ------------------------------------------------------------------ blk

def test_blk_sync_and_async(tmp_path):
    dev = rt.BlockDevice(tmp_path / "block", 1 << 20, n_threads=3)
    assert dev.size == 1 << 20
    dev.submit_write(0, b"hello")
    dev.submit_write(4096, b"world" * 100)
    dev.flush()
    assert dev.pread(0, 5) == b"hello"
    assert dev.pread(4096, 500) == b"world" * 100
    assert dev.pread(1 << 19, 16) == b"\x00" * 16  # sparse reads zeros
    dev.pwrite(8192, b"sync")
    assert dev.pread(8192, 4) == b"sync"
    dev.close()
    ref = jrt.BlockDevice(tmp_path / "block", 1 << 20, n_threads=1)
    assert ref.pread(0, 12288) == (tmp_path / "block").read_bytes()[:12288]
    assert ref.pread(8192, 4) == b"sync"
    ref.close()


def test_blk_many_concurrent_writes(tmp_path):
    dev = rt.BlockDevice(tmp_path / "block", 4 << 20, n_threads=4)
    for i in range(256):
        dev.submit_write(i * 4096, bytes([i % 256]) * 4096)
    dev.drain()
    for i in range(0, 256, 37):
        assert dev.pread(i * 4096, 4096) == bytes([i % 256]) * 4096
    dev.close()
    assert (tmp_path / "block").read_bytes()[:256 * 4096] == b"".join(
        bytes([i % 256]) * 4096 for i in range(256))


def test_blk_sparse_file_is_cheap(tmp_path):
    # capability probe, as test_rt.py does: some container filesystems
    # materialize every truncated block, so sparseness is a property of
    # the filesystem, not of the code
    probe = tmp_path / "sparse-probe"
    with open(probe, "wb") as f:
        f.truncate(4 << 20)
    if os.stat(probe).st_blocks * 512 >= 4 << 20:
        pytest.skip("filesystem does not keep truncated files sparse")
    dev = rt.BlockDevice(tmp_path / "block", 1 << 32, n_threads=1)  # 4 GiB
    dev.pwrite(0, b"x")
    dev.close()
    assert os.stat(tmp_path / "block").st_size == 1 << 32
    assert os.stat(tmp_path / "block").st_blocks * 512 < 1 << 20


# ------------------------------------------------------------ allocator

def _alloc_trace(mod) -> list:
    """One schedule of allocations, releases and marks -> every result."""
    al = mod.BitmapAllocator(256)
    out = [al.alloc(10), al.alloc(100), al.alloc(64), al.used]
    al.release(out[1], 100)
    out += [al.used, al.alloc(100), al.used]
    al.mark_used(200, 10)
    al.mark_used(205, 10)  # overlapping mark is idempotent
    out.append(al.used)
    try:
        al.alloc(300)
    except MemoryError:
        out.append("full")
    al.close()
    return out


def test_alloc_contiguous_and_release():
    got = _alloc_trace(rt)
    assert got == _alloc_trace(jrt)
    a, b, c, used = got[:4]
    assert used == 174 and len({a, b, c}) == 3
    assert got[4] == 74 and got[6] == 174
    assert got[7] == 174 + 15 and got[8] == "full"


def test_alloc_word_boundaries():
    for mod in (rt, jrt):
        al = mod.BitmapAllocator(192)  # 3 words
        runs = [al.alloc(63), al.alloc(65), al.alloc(64)]
        assert al.used == 192
        end = 0
        for s, n in sorted(zip(runs, (63, 65, 64))):  # packed, no overlap
            assert s == end
            end = s + n
        with pytest.raises(MemoryError):
            al.alloc(1)
        al.release(64, 64)
        assert al.alloc(64) == 64
        al.close()


def test_alloc_wraps_cursor():
    al = rt.BitmapAllocator(128)
    first = al.alloc(100)
    al.release(first, 100)  # cursor is past the hole; scan must wrap
    assert al.alloc(120) == 0
    al.close()
