"""The cases of ``tests/test_striper.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

Striper tests: layout math vs a brute-force per-byte oracle, reverse
mapping, and the striped client over a live TestCluster (the
libradosstriper round-trip role)."""
import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.osdc import (
    FileLayout,
    RadosStriper,
    StripedReadResult,
    extent_to_file,
    file_to_extents,
    get_num_objects,
)
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def byte_oracle(layout: FileLayout, fileoff: int):
    """Where does file byte `fileoff` live? (objectno, object offset) —
    straight from the layout definition, one byte at a time."""
    su, sc, spo = (layout.stripe_unit, layout.stripe_count,
                   layout.stripes_per_object)
    blockno = fileoff // su
    stripeno = blockno // sc
    stripepos = blockno % sc
    objectsetno = stripeno // spo
    objectno = objectsetno * sc + stripepos
    objoff = (stripeno % spo) * su + fileoff % su
    return objectno, objoff


LAYOUTS = [
    FileLayout(stripe_unit=4, stripe_count=3, object_size=8),
    FileLayout(stripe_unit=16, stripe_count=1, object_size=64),
    FileLayout(stripe_unit=8, stripe_count=4, object_size=8),
    FileLayout(stripe_unit=1 << 20, stripe_count=4, object_size=1 << 22),
]


@pytest.mark.parametrize("layout", LAYOUTS[:3])
@pytest.mark.parametrize("offset,length", [
    (0, 1), (0, 100), (3, 29), (7, 64), (25, 3), (0, 0), (128, 256),
])
def test_file_to_extents_matches_byte_oracle(layout, offset, length):
    extents = file_to_extents(layout, offset, length)
    placed = {}
    for ex in extents:
        pos = 0
        for bo, ln in ex.buffer_extents:
            for i in range(ln):
                placed[bo + i] = (ex.objectno, ex.offset + pos + i)
            pos += ln
    assert len(placed) == length
    for b in range(length):
        assert placed[b] == byte_oracle(layout, offset + b), f"byte {b}"


@pytest.mark.parametrize("layout", LAYOUTS[:3])
def test_extent_to_file_inverts(layout):
    rng = np.random.default_rng(42)
    for _ in range(20):
        off = int(rng.integers(0, 200))
        ln = int(rng.integers(1, 120))
        for ex in file_to_extents(layout, off, ln):
            runs = extent_to_file(layout, ex.objectno, ex.offset, ex.length)
            covered = sorted(
                b for fo, fl in runs for b in range(fo, fo + fl)
            )
            want = sorted(
                off + bo + i
                for bo, bln in ex.buffer_extents
                for i in range(bln)
            )
            assert covered == want


def test_get_num_objects():
    lay = FileLayout(stripe_unit=4, stripe_count=3, object_size=8)
    # stripe width 12, object set spans 24 bytes across 3 objects
    assert get_num_objects(lay, 0) == 0
    assert get_num_objects(lay, 1) == 1
    assert get_num_objects(lay, 4) == 1
    assert get_num_objects(lay, 5) == 2
    assert get_num_objects(lay, 12) == 3
    assert get_num_objects(lay, 24) == 3
    assert get_num_objects(lay, 25) == 4
    assert get_num_objects(lay, 48) == 6


def test_striped_read_result_holes():
    r = StripedReadResult(10)
    r.add_partial_result(b"abc", [(0, 3)])
    r.add_partial_result(b"", [(5, 2)])  # short read -> zero hole
    r.add_partial_result(b"XY", [(8, 2)])
    assert r.assemble() == b"abc\0\0\0\0\0XY"


def test_bulk_matches_scalar_big():
    lay = FileLayout(stripe_unit=1 << 16, stripe_count=4,
                     object_size=1 << 18)
    extents = file_to_extents(lay, (1 << 16) * 3 + 17, 5 << 16)
    total = sum(ex.length for ex in extents)
    assert total == 5 << 16
    # spot-check first byte of each extent against the oracle
    for ex in extents:
        bo = ex.buffer_extents[0][0]
        assert byte_oracle(lay, (1 << 16) * 3 + 17 + bo) == \
            (ex.objectno, ex.offset)


# ------------------------------------------------- cluster round-trip


def test_striper_over_cluster():
    from ceph_tpu_torch.cluster.vstart import TestCluster
    from ceph_tpu_torch.placement.osdmap import Pool

    async def t():
        c = TestCluster(n_osds=4, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="rep", size=3, pg_num=8, crush_rule=0)
        )
        await c.wait_active(20)
        lay = FileLayout(stripe_unit=4096, stripe_count=3,
                         object_size=16384)
        st = RadosStriper(c.client, 1, lay)
        rng = np.random.default_rng(7)
        data = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
        await st.write("f", data)
        assert await st.stat("f") == len(data)
        assert await st.read("f") == data
        # partial overwrite crossing object boundaries
        patch = b"P" * 20000
        await st.write("f", patch, offset=30000)
        want = bytearray(data)
        want[30000:50000] = patch
        assert await st.read("f") == bytes(want)
        # ranged read
        assert await st.read("f", 29990, 40) == bytes(want[29990:30030])
        # grow via sparse write past EOF: hole reads back as zeros
        await st.write("f", b"END", offset=150_000)
        got = await st.read("f")
        assert len(got) == 150_003
        assert got[: len(want)] == bytes(want)
        assert got[len(want):150_000] == b"\0" * (150_000 - len(want))
        assert got[150_000:] == b"END"
        await st.remove("f")
        assert await st.stat("f") == 0
        await c.stop()

    asyncio.run(asyncio.wait_for(t(), 120))
