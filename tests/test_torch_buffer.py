"""The port's BufferList (``ceph_tpu_torch.utils.buffer``): the BufferList
units of ``test_buffer.py``, and seeded segmentations held against the
JAX package's BufferList (equal bytes, segment counts and flatten
counters). The frame and messenger cases of ``test_buffer.py`` come with
the messenger. Tolerance: exact equality (bytes and integers)."""
import numpy as np
import pytest

from ceph_tpu.utils import buffer as jbuffer
from ceph_tpu_torch.store import transaction as tx
from ceph_tpu_torch.utils.buffer import STATS, BufferList, as_segments, as_view
from test_torch_native import jax_native_whole  # noqa: F401


def test_append_is_zero_copy_and_len_tracks():
    payload = b"x" * 1024
    bl = BufferList()
    bl.append(payload)
    bl.append(memoryview(payload)[10:20])
    bl.append(np.arange(16, dtype=np.uint8))
    assert len(bl) == 1024 + 10 + 16
    assert bl.num_segments == 3
    # the first segment aliases the original bytes object
    assert next(iter(bl.segments())).obj is payload


def test_bytearray_append_snapshots():
    buf = bytearray(b"abcd")
    bl = BufferList(buf)
    buf[0] = ord("z")
    assert bytes(bl) == b"abcd"  # mutable storage was snapshotted


def test_substr_aliases_without_copy():
    a, b = b"hello", b"world!"
    bl = BufferList()
    bl.append(a)
    bl.append(b)
    sub = bl.substr(3, 5)  # crosses the segment boundary
    assert bytes(sub) == b"lowor"
    segs = list(sub.segments())
    assert segs[0].obj is a and segs[1].obj is b


def test_substr_bounds_checked():
    bl = BufferList(b"abc")
    with pytest.raises(ValueError):
        bl.substr(1, 3)
    with pytest.raises(ValueError):
        bl.substr(-1, 1)


def test_splice_across_segment_boundaries():
    bl = BufferList()
    for part in (b"aaaa", b"bbbb", b"cccc"):
        bl.append(part)
    removed = bl.splice(2, 8)  # a|aabb bbcc|cc
    assert bytes(removed) == b"aabbbbcc"
    assert bytes(bl) == b"aacc"
    assert len(bl) == 4
    assert all(type(s.obj) is bytes for s in bl.segments())


def test_mutation_isolation_snapshot_vs_append():
    bl = BufferList(b"base")
    snap = bl.snapshot()
    bl.append(b"-more")
    assert bytes(snap) == b"base"
    assert bytes(bl) == b"base-more"


def test_flatten_idempotent_and_counted():
    STATS.reset()
    bl = BufferList()
    bl.append(b"12")
    bl.append(b"34")
    first = bl.flatten()
    assert first == b"1234"
    assert STATS.flattens == 1
    assert STATS.bytes_flattened == 4
    assert bl.flatten() is first  # cached: no new copy counted
    assert bytes(bl) is first
    assert STATS.flattens == 1
    assert STATS.dump() == {"bl_flattens": 1, "bl_bytes_flattened": 4}


def test_flatten_whole_bytes_segment_is_free():
    STATS.reset()
    payload = b"z" * 64
    bl = BufferList(payload)
    assert bl.flatten() is payload  # no copy at all
    assert STATS.flattens == 0


def test_equality_with_bytes():
    bl = BufferList()
    bl.append(b"ab")
    bl.append(b"cd")
    assert bl == b"abcd"
    assert bl != b"abce"
    assert bl == BufferList(b"abcd")


def test_strided_storage_rejected():
    arr = np.arange(64, dtype=np.uint8).reshape(8, 8)
    with pytest.raises(ValueError):
        BufferList(arr[:, ::2])  # non-contiguous view has no byte form
    with pytest.raises(ValueError):
        BufferList(memoryview(b"abcdef")[::2])
    with pytest.raises(ValueError):  # the store's producers refuse it too
        tx.Transaction().write("c", b"o", 0, arr[:, ::2])


def test_as_view_and_segments_match_jax():
    arr = np.arange(24, dtype=np.uint32).reshape(2, 12)
    for data in (b"abc", bytearray(b"xyz"), arr, memoryview(b"hello")[1:4]):
        got, want = as_view(data), jbuffer.as_view(data)
        assert got.readonly and got.tobytes() == want.tobytes()
        assert got.format == want.format and got.ndim == 1
    bl = BufferList(b"ab").append(b"cd")
    assert [s.tobytes() for s in as_segments(bl)] == [b"ab", b"cd"]


@pytest.mark.parametrize("seed", range(4))
def test_random_segmentations_match_jax(seed):
    """Seeded appends, substrs and splices on both packages'
    BufferLists: equal bytes, lengths, segment counts and flatten
    counters after every step."""
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    STATS.reset()
    jbuffer.STATS.reset()
    a, b = BufferList(), jbuffer.BufferList()
    for _ in range(40):
        op = int(rng.integers(0, 4))
        if op == 0 or len(a) < 8:
            lo = int(rng.integers(0, 4000))
            piece = blob[lo:lo + int(rng.integers(1, 96))]
            a.append(piece)
            b.append(piece)
        elif op == 1:
            off = int(rng.integers(0, len(a) - 4))
            n = int(rng.integers(1, len(a) - off))
            assert bytes(a.substr(off, n)) == bytes(b.substr(off, n))
        elif op == 2:
            off = int(rng.integers(0, len(a) - 4))
            n = int(rng.integers(1, min(64, len(a) - off)))
            assert bytes(a.splice(off, n)) == bytes(b.splice(off, n))
        else:
            assert a.flatten() == b.flatten()
        assert len(a) == len(b) and a.num_segments == b.num_segments
    assert bytes(a) == bytes(b)
    assert STATS.dump() == jbuffer.STATS.dump()
