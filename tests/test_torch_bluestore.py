"""The port's BlueStoreLite (``ceph_tpu_torch.store.bluestore``) against the
JAX package's, case by case as ``test_bluestore.py`` runs it: crash-reopen
durability, checksum detection of bit rot on the block file, COW and
deferred writes, allocator accounting, ENOSPC, split/merge and inline
compression. Each case is a twin (``test_torch_store.twins``): one body
runs through both packages' stores and returns what it saw plus the
store's fingerprint (reads, commit counters, KV records, allocator count
and block file bytes), and the two must be equal. Checksum cases run on
both checksum engines of the port (the C++ core, and the plain CRC
version through ``device_csum=True, device="cpu"``). The kill -9 cases
are in ``test_torch_store.py``; ``test_cluster_on_bluestore`` waits for
the cluster tier.

Tolerance: exact equality (bytes and integers)."""
import numpy as np
import pytest

from test_torch_store import (JAX, TORCH, all_op_txn, check_all_op_state,
                              fingerprint, stored_csums_match_core, twins)

BLOCK = 4096


def make_store(P, path, **kw):
    kw.setdefault("size", 32 << 20)
    s = P.BlueStoreLite(str(path), **kw)
    s.mount()
    return s


def rand(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def finish(s) -> dict:
    fp = fingerprint(s)
    s.umount()
    return fp


def test_all_opcodes_survive_remount(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        s.apply_transaction(all_op_txn(P.tx))
        s.umount()
        s2 = make_store(P, path)
        check_all_op_state(s2)
        return finish(s2)

    twins(body, tmp_path)


def test_crash_reopen_without_umount(tmp_path):
    """SIGKILL equivalent: no umount/compact; mount replays the kv WAL."""
    def body(P, path):
        s = make_store(P, path)
        s.apply_transaction(all_op_txn(P.tx))
        t = P.tx.Transaction().create_collection("c2")
        t.write("c2", b"late", 0, b"only in the wal")
        s.apply_transaction(t)
        s2 = make_store(P, path)
        check_all_op_state(s2, extra_colls=["c2"])
        assert s2.read("c2", b"late") == b"only in the wal"
        return finish(s2)

    twins(body, tmp_path)


def test_atomicity_rolls_back_data_and_blocks(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"a", 0, b"first" * 1000)
        s.apply_transaction(t)
        used0 = s.alloc.used
        bad = P.tx.Transaction()
        bad.write("c", b"a", 0, b"SECOND" * 2000)
        bad.remove("c", b"ghost")  # fails -> whole txn rolls back
        with pytest.raises(P.NotFound):
            s.queue_transaction(bad)
        assert s.read("c", b"a") == b"first" * 1000
        assert s.alloc.used == used0  # staged COW blocks were released
        return finish(s)

    twins(body, tmp_path)


def test_cow_remove_releases_blocks(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"big", 0, rand(1, 40 * BLOCK))
        s.apply_transaction(t)
        used = s.alloc.used
        assert used >= 40
        s.apply_transaction(P.tx.Transaction().remove("c", b"big"))
        assert s.alloc.used == used - 40
        return finish(s)

    twins(body, tmp_path)


def test_overwrite_is_cow(tmp_path):
    """Overwriting reallocates; the superseded block is freed after
    commit so total usage stays flat."""
    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"a", 0, b"x" * BLOCK)
        s.apply_transaction(t)
        used = s.alloc.used
        phys0 = s.colls["c"][b"a"].blocks[0]
        s.apply_transaction(P.tx.Transaction().write("c", b"a", 0,
                                                     b"y" * BLOCK))
        phys1 = s.colls["c"][b"a"].blocks[0]
        assert phys1 != phys0
        assert s.alloc.used == used
        assert s.read("c", b"a") == b"y" * BLOCK
        return phys0, phys1, finish(s)

    twins(body, tmp_path)


def test_partial_block_rmw(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        data = rand(2, 3 * BLOCK + 777)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"a", 0, data)
        s.apply_transaction(t)
        patch = rand(3, 100)
        s.apply_transaction(
            P.tx.Transaction().write("c", b"a", BLOCK + 17, patch))
        want = bytearray(data)
        want[BLOCK + 17:BLOCK + 117] = patch
        assert s.read("c", b"a") == bytes(want)
        assert s.read("c", b"a", 1000, 5000) == bytes(want[1000:6000])
        return finish(s)

    twins(body, tmp_path)


def test_zero_punches_holes(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"a", 0, b"q" * (4 * BLOCK))
        s.apply_transaction(t)
        used = s.alloc.used
        s.apply_transaction(
            P.tx.Transaction().zero("c", b"a", BLOCK, 2 * BLOCK))
        assert s.alloc.used == used - 2  # full blocks became holes
        o = s.colls["c"][b"a"]
        assert o.blocks[1] == P.HOLE and o.blocks[2] == P.HOLE
        assert s.read("c", b"a") == (
            b"q" * BLOCK + b"\x00" * (2 * BLOCK) + b"q" * BLOCK)
        return finish(s)

    twins(body, tmp_path)


def test_truncate_zeroes_stale_tail(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"a", 0, b"z" * 3000)
        t.truncate("c", b"a", 1000)
        t.truncate("c", b"a", 2000)  # re-extend within the same block
        s.apply_transaction(t)
        assert s.read("c", b"a") == b"z" * 1000 + b"\x00" * 1000
        return finish(s)

    twins(body, tmp_path)


@pytest.mark.parametrize("device_csum", [False, True])
def test_csum_detects_device_bit_rot(tmp_path, device_csum):
    def body(P, path):
        kw = ({"device_csum": True, "device": "cpu"}
              if P is TORCH and device_csum else {})
        s = make_store(P, path, **kw)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"a", 0, b"R" * (2 * BLOCK))
        s.apply_transaction(t)
        phys = s.colls["c"][b"a"].blocks[1]
        s.umount()
        with open(path / "block", "r+b") as f:
            f.seek(phys * BLOCK + 123)
            f.write(b"\xee")  # cosmic ray
        s2 = make_store(P, path, **kw)
        with pytest.raises(P.StoreError, match="csum mismatch") as err:
            s2.read("c", b"a")
        assert s2.read("c", b"a", 0, BLOCK) == b"R" * BLOCK  # block 0 ok
        s2.umount()
        return phys, str(err.value)

    twins(body, tmp_path)


def test_split_merge_and_alloc_survive_remount(tmp_path):
    from ceph_tpu_torch.placement.osdmap import ceph_str_hash_rjenkins

    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("1.0")
        oids = [b"obj%d" % i for i in range(16)]
        for oid in oids:
            t.write("1.0", oid, 0, oid * 600)  # >1 block each
        s.apply_transaction(t)
        t2 = P.tx.Transaction().create_collection("1.1")
        t2.split_collection("1.0", bits=1, rem=1, dest="1.1")
        s.apply_transaction(t2)
        used = s.alloc.used
        s.umount()
        s2 = make_store(P, path)
        assert s2.alloc.used == used  # allocator rebuilt from block maps
        left = set(s2.list_objects("1.0"))
        right = set(s2.list_objects("1.1"))
        assert left | right == set(oids) and not (left & right)
        assert all(ceph_str_hash_rjenkins(o) & 1 == 1 for o in right)
        for oid in right:
            assert s2.read("1.1", oid) == oid * 600
        s2.apply_transaction(
            P.tx.Transaction().merge_collection("1.1", dest="1.0"))
        assert set(s2.list_objects("1.0")) == set(oids)
        return finish(s2)

    twins(body, tmp_path)


def test_enospc(tmp_path):
    def body(P, path):
        s = make_store(P, path, size=64 * BLOCK)
        s.apply_transaction(P.tx.Transaction().create_collection("c"))
        with pytest.raises(P.StoreError, match="ENOSPC"):
            s.apply_transaction(P.tx.Transaction().write(
                "c", b"big", 0, b"x" * (100 * BLOCK)))
        # store still healthy after the failed txn
        s.apply_transaction(P.tx.Transaction().write("c", b"ok", 0, b"fits"))
        assert s.read("c", b"ok") == b"fits"
        return finish(s)

    twins(body, tmp_path)


def test_aborted_txn_after_split_does_not_corrupt(tmp_path):
    """An aborted transaction that wrote to an object moved by
    split_collection in the same transaction leaves the committed onode
    alone."""
    from ceph_tpu_torch.placement.osdmap import ceph_str_hash_rjenkins

    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("1.0")
        oids = [b"o%d" % i for i in range(8)]
        for oid in oids:
            t.write("1.0", oid, 0, oid * 400)
        s.apply_transaction(t)
        moved = next(o for o in oids if ceph_str_hash_rjenkins(o) & 1 == 1)
        bad = P.tx.Transaction().create_collection("1.1")
        bad.split_collection("1.0", bits=1, rem=1, dest="1.1")
        bad.write("1.1", moved, 0, b"X" * 5000)
        bad.remove("1.1", b"ghost")  # aborts the whole txn
        with pytest.raises(P.NotFound):
            s.queue_transaction(bad)
        for oid in oids:  # committed state intact, csums verify
            assert s.read("1.0", oid) == oid * 400
        assert "1.1" not in s.list_collections()
        return finish(s)

    twins(body, tmp_path)


def test_rmcoll_then_mkcoll_same_txn(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"a", 0, b"old")
        s.apply_transaction(t)
        t2 = P.tx.Transaction()
        t2.remove("c", b"a")
        t2.remove_collection("c")
        t2.create_collection("c")
        t2.write("c", b"b", 0, b"new")
        s.apply_transaction(t2)
        assert s.list_objects("c") == [b"b"]
        s.umount()
        s2 = make_store(P, path)
        assert s2.list_objects("c") == [b"b"]
        assert s2.read("c", b"b") == b"new"
        return finish(s2)

    twins(body, tmp_path)


def test_clone_is_independent(tmp_path):
    def body(P, path):
        s = make_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"src", 0, b"A" * (2 * BLOCK))
        t.clone("c", b"src", b"dup")
        s.apply_transaction(t)
        s.apply_transaction(P.tx.Transaction().write("c", b"src", 0,
                                                     b"B" * 10))
        assert s.read("c", b"dup") == b"A" * (2 * BLOCK)  # unaffected
        assert s.read("c", b"src", 0, 10) == b"B" * 10
        return finish(s)

    twins(body, tmp_path)


def test_kv_auto_compact(tmp_path):
    def body(P, path):
        s = make_store(P, path, kv_compact_bytes=4096)
        s.apply_transaction(P.tx.Transaction().create_collection("c"))
        for i in range(50):
            s.apply_transaction(
                P.tx.Transaction().write("c", b"o%d" % i, 0, b"x" * 200))
        assert s.kv.wal_size() < 4096  # compaction kicked in
        s.umount()
        s2 = make_store(P, path)
        for i in range(50):
            assert s2.read("c", b"o%d" % i) == b"x" * 200
        return finish(s2)

    twins(body, tmp_path)


# ------------------------- deferred small writes (BlueStore.cc:14768)


def test_deferred_small_write_no_cow(tmp_path):
    """A small overwrite of a committed block patches it in place via
    the kv WAL: the same phys block, no new allocation."""
    def body(P, path):
        s = make_store(P, path, size=16 << 20)
        t = P.tx.Transaction()
        t.create_collection("c")
        t.write("c", b"o", 0, b"A" * 20_000)
        s.queue_transaction(t)
        before = list(s.colls["c"][b"o"].blocks)
        s.queue_transaction(P.tx.Transaction().write("c", b"o", 100,
                                                     b"deferred!"))
        assert list(s.colls["c"][b"o"].blocks) == before  # no COW
        want = b"A" * 100 + b"deferred!" + b"A" * (20_000 - 109)
        assert s.read("c", b"o") == want
        s.umount()
        s2 = make_store(P, path, size=16 << 20)
        assert s2.read("c", b"o") == want
        return finish(s2)

    twins(body, tmp_path)


@pytest.mark.parametrize("device_csum", [False, True])
def test_deferred_write_replays_after_crash(tmp_path, device_csum):
    """Crash between the kv commit (defer record durable) and the
    in-place block write: mount replays the record, so the committed
    csum and the device bytes agree."""
    def body(P, path):
        kw = ({"device_csum": True, "device": "cpu"}
              if P is TORCH and device_csum else {})
        s = make_store(P, path, size=16 << 20, **kw)
        t = P.tx.Transaction()
        t.create_collection("c")
        t.write("c", b"o", 0, b"B" * 8192)
        s.queue_transaction(t)
        s._crash_before_deferred = True  # test hook: die before the patch
        s.queue_transaction(P.tx.Transaction().write("c", b"o", 4000,
                                                     b"XYZ"))
        pending = list(s.kv.scan_prefix(b"D"))
        s.dev.close()  # abandon the instance without umount
        s.kv.close()
        s2 = make_store(P, path, size=16 << 20, **kw)  # replays the record
        want = b"B" * 4000 + b"XYZ" + b"B" * (8192 - 4003)
        assert s2.read("c", b"o") == want
        assert not list(s2.kv.scan_prefix(b"D"))
        assert stored_csums_match_core(s2) == 2
        return pending, finish(s2)

    pending, _ = twins(body, tmp_path)
    assert len(pending) == 1


def test_deferred_vs_cow_write_amplification(tmp_path):
    """N small overwrites allocate no new block on the deferred path."""
    def body(P, path):
        s = make_store(P, path, size=16 << 20)
        t = P.tx.Transaction()
        t.create_collection("c")
        t.write("c", b"o", 0, b"C" * 65536)
        s.queue_transaction(t)
        used_before = sum(1 for b in s.colls["c"][b"o"].blocks
                          if b != P.HOLE)
        data = bytearray(b"C" * 65536)
        for i in range(50):
            off = (i * 1117) % 60_000
            s.queue_transaction(P.tx.Transaction().write("c", b"o", off,
                                                         b"x" * 64))
            data[off:off + 64] = b"x" * 64
        blocks = s.colls["c"][b"o"].blocks
        assert sum(1 for b in blocks if b != P.HOLE) == used_before
        assert s.read("c", b"o") == bytes(data)
        return finish(s)

    twins(body, tmp_path)


# ------------------------------------------------------ inline compression


def comp_store(P, path, **kw):
    kw.setdefault("compression", "zlib")
    return make_store(P, path, **kw)


def test_compressed_write_saves_blocks_and_roundtrips(tmp_path):
    def body(P, path):
        s = comp_store(P, path)
        s.apply_transaction(P.tx.Transaction().create_collection("c"))
        used0 = s.alloc.used
        data = b"compress me " * (64 * 1024 // 12 + 1)  # > 64 KiB
        s.apply_transaction(P.tx.Transaction().write("c", b"o", 0, data))
        assert s.alloc.used - used0 < -(-len(data) // BLOCK)
        assert s.read("c", b"o") == data
        assert s.read("c", b"o", 5000, 9000) == data[5000:14000]
        return finish(s)

    twins(body, tmp_path)


def test_compressed_survives_remount_without_write_codec(tmp_path):
    def body(P, path):
        data = bytes(range(256)) * 300  # 75 KiB, compressible
        s = comp_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, data)
        s.apply_transaction(t)
        used = s.alloc.used
        s.umount()
        s2 = make_store(P, path)  # compression off: blobs still decode
        assert s2.alloc.used == used
        assert s2.read("c", b"o") == data
        s2.apply_transaction(P.tx.Transaction().write("c", b"p", 0, data))
        assert s2.read("c", b"p") == data
        return finish(s2)

    twins(body, tmp_path)


def test_incompressible_falls_through_plain(tmp_path):
    def body(P, path):
        s = comp_store(P, path)
        data = rand(7, 128 * 1024)
        s.apply_transaction(P.tx.Transaction().create_collection("c"))
        used0 = s.alloc.used
        s.apply_transaction(P.tx.Transaction().write("c", b"o", 0, data))
        assert s.alloc.used - used0 == len(data) // BLOCK  # stored raw
        assert not s.colls["c"][b"o"].cblobs
        assert s.read("c", b"o") == data
        return finish(s)

    twins(body, tmp_path)


def test_alloc_hint_incompressible_skips_compression(tmp_path):
    def body(P, path):
        data = b"Z" * (64 * 1024)
        s = comp_store(P, path)  # mode=aggressive honors the hint
        t = P.tx.Transaction().create_collection("c")
        t.set_alloc_hint("c", b"o", 0, 0, 2)  # FLAG_INCOMPRESSIBLE
        t.write("c", b"o", 0, data)
        s.apply_transaction(t)
        assert not s.colls["c"][b"o"].cblobs
        assert s.read("c", b"o") == data
        return finish(s)

    twins(body, tmp_path)


def test_partial_overwrite_dissolves_blob(tmp_path):
    def body(P, path):
        data = b"ab" * (48 * 1024 // 2)
        s = comp_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, data)
        s.apply_transaction(t)
        assert s.colls["c"][b"o"].cblobs
        off, patch = 10_000, b"PATCHED!"
        s.apply_transaction(P.tx.Transaction().write("c", b"o", off, patch))
        want = data[:off] + patch + data[off + len(patch):]
        assert s.read("c", b"o") == want
        o = s.colls["c"][b"o"]
        for start, cb in o.cblobs.items():
            assert not start <= off // BLOCK < start + cb.nblocks
        return finish(s)

    twins(body, tmp_path)


def test_full_overwrite_recompresses_and_frees_old(tmp_path):
    def body(P, path):
        d1 = b"first " * (32 * 1024 // 6)
        d2 = b"second" * (32 * 1024 // 6)
        s = comp_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, d1)
        s.apply_transaction(t)
        used1 = s.alloc.used
        s.apply_transaction(P.tx.Transaction().write("c", b"o", 0, d2))
        assert abs(s.alloc.used - used1) <= 1  # old blob blocks freed
        assert s.read("c", b"o") == d2
        return finish(s)

    twins(body, tmp_path)


def test_truncate_into_blob(tmp_path):
    def body(P, path):
        data = b"trunc" * (64 * 1024 // 5)
        s = comp_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, data)
        s.apply_transaction(t)
        cut = 20_000
        s.apply_transaction(P.tx.Transaction().truncate("c", b"o", cut))
        assert s.read("c", b"o") == data[:cut]
        s.apply_transaction(P.tx.Transaction().truncate("c", b"o",
                                                        len(data)))
        assert s.read("c", b"o") == data[:cut] + b"\x00" * (len(data) - cut)
        return finish(s)

    twins(body, tmp_path)


def test_clone_copies_compressed_verbatim(tmp_path):
    def body(P, path):
        data = b"clone me " * (48 * 1024 // 9)
        s = comp_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"src", 0, data)
        t.clone("c", b"src", b"dst")
        s.apply_transaction(t)
        src, dst = s.colls["c"][b"src"], s.colls["c"][b"dst"]
        assert set(src.cblobs) == set(dst.cblobs)
        for st in src.cblobs:
            assert src.cblobs[st].phys != dst.cblobs[st].phys  # no sharing
            assert src.cblobs[st].clen == dst.cblobs[st].clen
        s.apply_transaction(P.tx.Transaction().write("c", b"dst", 0,
                                                     b"X" * 100))
        assert s.read("c", b"src") == data
        assert s.read("c", b"dst")[:100] == b"X" * 100
        return finish(s)

    twins(body, tmp_path)


@pytest.mark.parametrize("device_csum", [False, True])
def test_csum_detects_rot_in_compressed_blob(tmp_path, device_csum):
    def body(P, path):
        kw = ({"device_csum": True, "device": "cpu"}
              if P is TORCH and device_csum else {})
        data = b"rot" * (64 * 1024 // 3)
        s = comp_store(P, path, **kw)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, data)
        s.apply_transaction(t)
        o = s.colls["c"][b"o"]
        assert o.cblobs
        phys = next(iter(o.cblobs.values())).phys[0]
        buf = bytearray(s.dev.pread(phys * BLOCK, BLOCK))
        buf[17] ^= 0x40
        s.dev.pwrite(phys * BLOCK, bytes(buf))
        with pytest.raises(P.StoreError, match="csum mismatch") as err:
            s.read("c", b"o")
        s.umount()
        return str(err.value)

    twins(body, tmp_path)


def test_compressed_remove_releases_blob_blocks(tmp_path):
    def body(P, path):
        data = b"gone " * (64 * 1024 // 5)
        s = comp_store(P, path)
        s.apply_transaction(P.tx.Transaction().create_collection("c"))
        used0 = s.alloc.used
        s.apply_transaction(P.tx.Transaction().write("c", b"o", 0, data))
        s.apply_transaction(P.tx.Transaction().remove("c", b"o"))
        assert s.alloc.used == used0
        return finish(s)

    twins(body, tmp_path)


def test_compressed_crash_reopen(tmp_path):
    """Blob written, no umount: mount rebuilds onode and blob from kv."""
    def body(P, path):
        data = b"durable " * (32 * 1024 // 8)
        s = comp_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, data)
        s.apply_transaction(t)
        s2 = comp_store(P, path)  # no umount of s: crash-equivalent
        assert s2.read("c", b"o") == data
        assert s2.colls["c"][b"o"].cblobs
        return finish(s2)

    twins(body, tmp_path)


def test_truncate_blob_at_partial_tail_block(tmp_path):
    """A blob ending at the truncation block with a partial tail
    dissolves, so the tail zeroing patches a plain block."""
    def body(P, path):
        s = comp_store(P, path)
        t = P.tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, b"tail" * (16 * 1024 // 4))  # one blob
        s.apply_transaction(t)
        assert s.colls["c"][b"o"].cblobs
        cut = 14336  # 3.5 blocks
        s.apply_transaction(P.tx.Transaction().truncate("c", b"o", cut))
        o = s.colls["c"][b"o"]
        assert not o.cblobs
        assert all(b != 0xFFFFFFFE for b in o.blocks)
        assert s.read("c", b"o") == (b"tail" * (16 * 1024 // 4))[:cut]
        s.apply_transaction(P.tx.Transaction().truncate("c", b"o",
                                                        16 * 1024))
        assert s.read("c", b"o", cut) == b"\x00" * (16 * 1024 - cut)
        s.apply_transaction(P.tx.Transaction().write("c", b"o", 0,
                                                     b"X" * 10))
        got = s.read("c", b"o")
        assert got[:10] == b"X" * 10
        assert got[cut:] == b"\x00" * (16 * 1024 - cut)
        return finish(s)

    twins(body, tmp_path)


def test_onode_encoding_matches_jax():
    """The onode record (size, block map, checksums, xattrs, compressed
    blobs) encodes to the reference's bytes and decodes across."""
    from ceph_tpu.store import bluestore as jbs
    from ceph_tpu_torch.store import bluestore as bs

    def onode(mod):
        o = mod.Onode()
        o.size = 123_456
        o.blocks = [5, mod.HOLE, mod.CBLOB, mod.CBLOB, 9]
        o.csums = [0xDEADBEEF, 0, 0, 0, 17]
        o.xattrs = {"_": b"oi", "snapset": b"\x00\x01"}
        o.cblobs = {2: mod.CBlob(2, [11], 3000, "zlib", [0x1234])}
        return o

    blob = onode(bs).encode()
    assert blob == onode(jbs).encode()
    back = bs.Onode.decode(blob)
    assert back.encode() == blob and back.cblobs[2].clen == 3000
    assert jbs.Onode.decode(blob).encode() == blob
    assert bs._okey("1.0", b"a\x00b") == jbs._okey("1.0", b"a\x00b")


def test_both_packages_reject_the_same_corrupt_block(tmp_path):
    """Rot written into one package's block file is caught by the other
    package's read of the same store (the checksums travel in the
    onodes)."""
    s = make_store(TORCH, tmp_path, device_csum=True, device="cpu")
    t = TORCH.tx.Transaction().create_collection("c")
    t.write("c", b"a", 0, rand(9, 5 * BLOCK))
    s.apply_transaction(t)
    phys = s.colls["c"][b"a"].blocks[3]
    s.umount()
    with open(tmp_path / "block", "r+b") as f:
        f.seek(phys * BLOCK)
        f.write(b"\x01")
    j = make_store(JAX, tmp_path)
    with pytest.raises(JAX.StoreError, match="block 3"):
        j.read("c", b"a")
    j.umount()
