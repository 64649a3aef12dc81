"""The port's object store (``ceph_tpu_torch.store``) against the JAX
package's (``ceph_tpu.store``): the Transaction wire form, MemStore,
WalStore and BlueStoreLite, as ``test_store.py`` and ``test_bluestore.py``
run them (BlueStoreLite's own cases are in ``test_torch_bluestore.py``).

Most cases are twins: one body runs through both packages' stores, each
in its own directory, and returns a fingerprint (every object's bytes,
xattrs, omap and header, the commit counters, and the bytes the store
left on disk: WAL, snapshot, KV records, block file). The two
fingerprints must be equal. One schedule that covers every opcode, with
compression, clone, split/merge, zero, truncate and deferred writes, runs
through all three stores, with the port's checksums on the C++ core
(``device_csum=False``) and on the plain CRC version
(``device_csum=True, device="cpu"``). Stores written by either package
mount in the other, and acknowledged writes survive kill -9 of a child
process that imports only ``ceph_tpu_torch``.

Tolerance: exact equality (bytes and integers).
"""
import hashlib
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ceph_tpu.store as jstore
import ceph_tpu_torch.store as pstore
from ceph_tpu import native as jnative
from ceph_tpu.store import bluestore as jbluestore
from ceph_tpu.store import memstore as jmemstore
from ceph_tpu.store import transaction as jtx
from ceph_tpu.store import walstore as jwalstore
from ceph_tpu_torch import native
from ceph_tpu_torch.ops import crc32c as crc_ops
from ceph_tpu_torch.store import bluestore, memstore, walstore
from ceph_tpu_torch.store import transaction as tx
from ceph_tpu_torch.utils import denc
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 4096

TORCH = SimpleNamespace(
    name="torch", tx=tx, MemStore=memstore.MemStore,
    WalStore=walstore.WalStore, BlueStoreLite=bluestore.BlueStoreLite,
    NotFound=pstore.NotFound, StoreError=pstore.StoreError,
    create=pstore.create, HOLE=bluestore.HOLE)
JAX = SimpleNamespace(
    name="jax", tx=jtx, MemStore=jmemstore.MemStore,
    WalStore=jwalstore.WalStore, BlueStoreLite=jbluestore.BlueStoreLite,
    NotFound=jstore.NotFound, StoreError=jstore.StoreError,
    create=jstore.create, HOLE=jbluestore.HOLE)


def all_op_txn(t_mod=tx):
    """One transaction touching every opcode (order matters)."""
    t = t_mod.Transaction()
    t.create_collection("c")
    t.touch("c", b"a")
    t.write("c", b"a", 0, b"hello world")
    t.zero("c", b"a", 5, 3)
    t.truncate("c", b"a", 8)
    t.setattr("c", b"a", "k1", b"v1")
    t.setattrs("c", b"a", {"k2": b"v2", "k3": b"v3"})
    t.rmattr("c", b"a", "k3")
    t.clone("c", b"a", b"b")
    t.clone_range("c", b"a", b"r", 2, 4, 1)
    t.omap_setheader("c", b"a", b"HDR")
    t.omap_setkeys("c", b"a", {b"x": b"1", b"y": b"2", b"z": b"3"})
    t.omap_rmkeys("c", b"a", [b"z"])
    t.omap_rmkeyrange("c", b"a", b"y", b"yz")
    t.touch("c", b"tmp")
    t.remove("c", b"tmp")
    t.create_collection("dead")
    t.remove_collection("dead")
    return t


def check_all_op_state(s, extra_colls=()):
    # write "hello world" -> zero [5,8) -> truncate 8 = "hello\0\0\0"
    assert s.read("c", b"a") == b"hello\0\0\0"
    assert s.stat("c", b"a") == 8
    assert s.getattr("c", b"a", "k1") == b"v1"
    assert s.getattrs("c", b"a") == {"k1": b"v1", "k2": b"v2"}
    assert s.read("c", b"b") == b"hello\0\0\0"
    assert s.getattrs("c", b"b") == {"k1": b"v1", "k2": b"v2"}
    assert s.read("c", b"r") == b"\0llo\0"
    assert s.omap_get_header("c", b"a") == b"HDR"
    assert s.omap_get("c", b"a") == {b"x": b"1"}
    assert not s.exists("c", b"tmp")
    assert s.list_collections() == sorted(["c", *extra_colls])
    assert s.list_objects("c") == [b"a", b"b", b"r"]


# ----------------------------------------------------------- fingerprints


def dump(s) -> dict:
    """Everything a client can read back from a store."""
    out = {"colls": s.list_collections()}
    for cid in out["colls"]:
        for oid in s.list_objects(cid):
            out[(cid, oid)] = (s.read(cid, oid), s.stat(cid, oid),
                               s.getattrs(cid, oid), s.omap_get(cid, oid),
                               s.omap_get_header(cid, oid))
    return out


def commits(s) -> dict:
    """The commit counters, less the flush time (a clock reading)."""
    d = s.commit_stats.dump()
    d.pop("commit_flush_us")
    return d


def digest(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def files(d) -> dict:
    return {p.name: digest(p) for p in sorted(Path(d).iterdir())
            if p.is_file()}


def fingerprint(s) -> dict:
    """A mounted store's readable state, commit counters and on-disk
    bytes (the WAL of a WalStore; the KV records, allocator count and
    block file of a BlueStoreLite)."""
    out = {"dump": dump(s), "commits": commits(s)}
    if isinstance(s, (walstore.WalStore, jwalstore.WalStore)):
        out["wal"] = digest(Path(s.path) / walstore.WAL_NAME)
    if isinstance(s, (bluestore.BlueStoreLite, jbluestore.BlueStoreLite)):
        out["kv"] = s.kv.scan()
        out["used"] = s.alloc.used
        out["block"] = digest(Path(s.path) / "block")
    return out


def differing(got, want, path=()) -> list:
    """Where two results differ: the key paths (fingerprint keys such as
    ``dump``, ``commits``, ``wal``, list positions) down to the first
    values that are not dicts, lists or tuples of one length."""
    if isinstance(got, dict) and isinstance(want, dict):
        keys = sorted(set(got) | set(want), key=repr)
        return [p for k in keys
                for p in (differing(got[k], want[k], path + (k,))
                          if k in got and k in want else [path + (k,)])]
    if (isinstance(got, (list, tuple)) and isinstance(want, (list, tuple))
            and len(got) == len(want)):
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in differing(g, w, path + (i,))]
    return [] if got == want else [path]


def twins(body, tmp_path, *args):
    """Run ``body(P, path, *args)`` for the port and for the JAX package,
    each in a directory of its own; the results must be equal (a failure
    names the keys that differ)."""
    got = body(TORCH, tmp_path / "torch", *args)
    want = body(JAX, tmp_path / "jax", *args)
    assert got == want, f"port and JAX differ at {differing(got, want)}"
    return got


def stored_csums_match_core(s) -> int:
    """Every per-block checksum a BlueStoreLite holds equals the C++
    core's CRC32C of that block as it lies on the block file; returns
    how many were checked."""
    n = 0
    for cid, objs in s.colls.items():
        for oid, o in objs.items():
            pairs = [(p, c) for p, c in zip(o.blocks, o.csums)
                     if p not in (bluestore.HOLE, bluestore.CBLOB)]
            for cb in o.cblobs.values():
                pairs += list(zip(cb.phys, cb.csums))
            for phys, csum in pairs:
                block = s.dev.pread(phys * BLOCK, BLOCK)
                assert csum == native.crc32c(block), (cid, oid, phys)
                n += 1
    return n


# ---------------------------------------------------------- the schedule


def schedule(t_mod, seed: int = 7) -> list:
    """Transactions that cover every opcode, compressible and random
    data, clones, split/merge, zero, truncate, small overwrites of
    committed blocks (BlueStore's deferred path) and one transaction
    that must be rejected; the same bytes for either package."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()

    squashy = b"compress me " * (80 * 1024 // 12)
    T = t_mod.Transaction
    txns = [all_op_txn(t_mod)]
    t = T().create_collection("1.0").create_collection("meta")
    t.create_collection("tmp")
    t.set_alloc_hint("1.0", b"hinted", 4 << 20, 64 << 10, flags=2)
    t.write("1.0", b"hinted", 0, b"Z" * 65536)
    txns.append(t)
    t = T()
    for i in range(12):
        t.write("1.0", b"obj%d" % i, 0, rand(3 * BLOCK + 777 * i + 1))
    t.write("1.0", b"squash", 0, squashy)
    t.write("1.0", b"noise", 0, rand(48 * 1024))
    txns.append(t)
    t = T().setattrs("1.0", b"obj0", {"a": b"1", "b": b"2", "c": b"3"})
    t.setattr("1.0", b"obj2", "x", rand(40))
    t.omap_setkeys("1.0", b"obj1", {b"k%d" % i: rand(8) for i in range(10)})
    t.omap_setheader("1.0", b"obj1", b"HDR")
    t.omap_setkeys("meta", b"pgmeta", {b"epoch": b"7", b"info": rand(64)})
    txns.append(t)
    for i in range(10):  # small overwrites of committed blocks
        txns.append(T().write("1.0", b"obj%d" % (i % 5),
                              int(rng.integers(0, 12000)),
                              rand(rng.integers(1, 300))))
    txns.append(T().write("1.0", b"obj5", 2000, rand(70 * 1024)))
    txns.append(T().write("1.0", b"squash", 10_000, b"PATCHED!"))
    txns.append(T().write("1.0", b"obj10", 3 * BLOCK, rand(BLOCK)))
    txns.append(T().zero("1.0", b"obj6", 100, 50)
                .zero("1.0", b"obj7", BLOCK, 2 * BLOCK))
    txns.append(T().truncate("1.0", b"obj8", 5000)
                .truncate("1.0", b"obj8", 9000)
                .truncate("1.0", b"squash", 20_000))
    t = T().clone("1.0", b"obj0", b"obj0.clone")
    t.clone_range("1.0", b"obj1", b"obj1.part", 100, 5000, 300)
    t.clone("1.0", b"squash", b"squash.clone")
    txns.append(t)
    t = T().rmattr("1.0", b"obj0", "b").rmattrs("1.0", b"obj2")
    t.omap_rmkeys("1.0", b"obj1", [b"k1", b"k2"])
    t.omap_rmkeyrange("1.0", b"obj1", b"k5", b"k8")
    t.remove("1.0", b"obj9")
    txns.append(t)
    bad = T().write("1.0", b"obj3", 0, rand(9000)).remove("1.0", b"ghost")
    txns.append(bad)  # rejected whole: NotFound
    t = T().create_collection("1.1")
    t.split_collection("1.0", 1, 1, "1.1")
    txns.append(t)
    txns.append(T().write("1.1", b"born-in-1.1", 0, rand(5000))
                .omap_clear("1.1", b"obj1"))
    txns.append(T().merge_collection("1.1", "1.0", bits=1))
    txns.append(T().remove_collection("tmp").touch("meta", b"empty"))
    txns.append(T().write("1.0", b"obj11", 0, rand(2 * BLOCK))
                .write("1.0", b"obj11", 100, rand(64)))
    return txns


def run_schedule(P, s, txns) -> list:
    """Apply ``txns`` in order -> per transaction "ok" or the class name
    of the error that rejected it."""
    out = []
    for t in txns:
        try:
            s.apply_transaction(t)
            out.append("ok")
        except P.StoreError as e:
            out.append(type(e).__name__)
    return out


def make(P, kind, path, **kw):
    if kind == "memstore":
        return P.create("memstore")
    if kind == "bluestore":
        kw.setdefault("size", 32 << 20)
    return P.create(kind, str(path), **kw)


@pytest.mark.parametrize("kind", ["memstore", "walstore", "bluestore"])
def test_all_opcodes_match_jax(kind, tmp_path):
    def body(P, path):
        s = make(P, kind, path)
        s.apply_transaction(all_op_txn(P.tx))
        check_all_op_state(s)
        return fingerprint(s)

    twins(body, tmp_path)


@pytest.mark.parametrize("kind,compression,device_csum", [
    ("memstore", None, False),
    *((kind, comp, dev) for kind in ("walstore", "bluestore")
      for comp in (None, "zlib") for dev in (False, True))])
def test_schedule_matches_jax(kind, compression, device_csum, tmp_path,
                              monkeypatch):
    """The schedule through the port's store (checksums on the C++ core,
    or on the plain CRC version with device_csum=True) and the JAX
    package's (C++ core): equal results, reads, commit counters and
    on-disk bytes, before and after a clean remount."""
    device_calls = []
    batch = crc_ops.crc32c_batch

    def counted(*a, **k):
        device_calls.append(k.get("device"))
        return batch(*a, **k)

    monkeypatch.setattr(crc_ops, "crc32c_batch", counted)
    kw = {} if kind == "memstore" else {"compression": compression}

    def body(P, path):
        extra = ({"device_csum": True, "device": "cpu"}
                 if P is TORCH and device_csum else {})
        s = make(P, kind, path, **kw, **extra)
        results = run_schedule(P, s, schedule(P.tx))
        assert results.count("NotFound") == 1
        fp = fingerprint(s)
        if kind == "bluestore":
            fp["csums_checked"] = stored_csums_match_core(s)
        if kind == "memstore":
            return results, fp
        s.umount()
        on_disk = files(path) if kind == "walstore" else files(path / "kv")
        s2 = make(P, kind, path, **kw, **extra)
        reread = dump(s2)
        s2.umount()
        return results, fp, on_disk, reread

    results, fp, *rest = twins(body, tmp_path)
    if rest:
        assert rest[1] == fp["dump"]  # remount reads what was written
    if kind == "bluestore":
        assert fp["csums_checked"] > 50
    # device_csum=True reaches the batched CRC path on the named device
    # for every checksum call; False never does
    if device_csum:
        assert device_calls and set(map(str, device_calls)) == {"cpu"}
    else:
        assert not device_calls


@pytest.mark.parametrize("kind", ["walstore", "bluestore"])
def test_group_commit_counters_match_jax(kind, tmp_path):
    """A group-commit window no transaction reaches: every queued
    transaction is visible at once and all become durable at the one
    explicit flush, in both packages."""
    def body(P, path):
        s = make(P, kind, path, commit_window_ms=60_000.0,
                 commit_max_txns=1000)
        assert s.commits_deferred()
        acked = []
        for i, t in enumerate(schedule(P.tx)[:12]):
            s.queue_transaction(t, lambda i=i: acked.append(i))
        assert acked == []
        s._committer.flush_now()
        assert acked == list(range(12))
        fp = fingerprint(s)
        s.umount()
        return fp

    fp = twins(body, tmp_path)
    assert fp["commits"]["commits"] == 1 and fp["commits"]["txns"] == 12


# ------------------------------------------------------- Transaction wire


def test_transaction_encode_roundtrip():
    t = all_op_txn()
    blob = t.encode()
    t2, off = tx.Transaction.decode(blob)
    assert off == len(blob)
    assert len(t2) == len(t)
    for a, b in zip(t.ops, t2.ops):
        assert (a.code, a.cid, a.oid, a.args) == (b.code, b.cid, b.oid, b.args)


def test_transaction_wire_form_matches_jax():
    """The denc wire form doubles as the WAL record: every transaction of
    the schedule encodes to the reference's bytes, and each package
    decodes the other's."""
    for t, jt in zip(schedule(tx), schedule(jtx)):
        blob = t.encode()
        assert blob == jt.encode()
        assert t.encode_bl().tobytes() == blob
        back, used = jtx.Transaction.decode(blob)
        assert used == len(blob) and back.encode() == blob
        back, used = tx.Transaction.decode(jt.encode())
        assert used == len(blob) and back.encode() == blob


def test_transaction_ops_and_views():
    t4 = tx.Transaction()
    t4.split_collection("1.0", 2, 3, "1.3")
    t4.merge_collection("1.3", "1.0", bits=2)
    t4.set_alloc_hint("1.0", b"obj0", 1 << 22, 4096, flags=3)
    t5, used = tx.Transaction.decode(t4.encode())
    assert used == len(t4.encode())
    assert [op.code for op in t5.ops] == [
        tx.OP_SPLIT_COLL, tx.OP_MERGE_COLL, tx.OP_SETALLOCHINT]
    arr = np.arange(4096, dtype=np.uint8)
    a = tx.Transaction().write("c", b"o", 0, arr).encode()
    b = jtx.Transaction().write("c", b"o", 0, arr.tobytes()).encode()
    assert a == b  # an ndarray payload encodes as its bytes


# --------------------------------------------------------------- MemStore


def test_memstore_all_opcodes():
    s = memstore.MemStore()
    s.apply_transaction(all_op_txn())
    check_all_op_state(s)


def test_memstore_atomicity():
    """A failing op rolls back the whole transaction."""
    s = memstore.MemStore()
    t = tx.Transaction()
    t.create_collection("c")
    t.write("c", b"a", 0, b"first")
    s.apply_transaction(t)
    bad = tx.Transaction()
    bad.write("c", b"a", 0, b"SECOND")
    bad.remove("c", b"nonexistent")
    with pytest.raises(pstore.NotFound):
        s.queue_transaction(bad)
    assert s.read("c", b"a") == b"first"
    bad2 = tx.Transaction()
    bad2.write("c", b"a", 0, b"X")
    bad2.remove_collection("c")  # not empty -> StoreError
    with pytest.raises(pstore.StoreError):
        s.queue_transaction(bad2)
    assert s.read("c", b"a") == b"first"


def test_memstore_errors():
    s = memstore.MemStore()
    with pytest.raises(pstore.NotFound):
        s.read("nope", b"x")
    s.apply_transaction(tx.Transaction().create_collection("c"))
    with pytest.raises(pstore.NotFound):
        s.read("c", b"x")
    with pytest.raises(pstore.NotFound):
        s.getattr("c", b"x", "a")
    with pytest.raises(pstore.StoreError):
        s.queue_transaction(tx.Transaction().create_collection("c"))
    with pytest.raises(ValueError, match="unknown store kind"):
        pstore.create("nostore")


def test_denc_roundtrips():
    assert denc.dec_u8(denc.enc_u8(0xAB), 0) == (0xAB, 1)
    assert denc.dec_u64(denc.enc_u64(2**61 + 5), 0) == (2**61 + 5, 8)
    assert denc.dec_i64(denc.enc_i64(-(2**40)), 0) == (-(2**40), 8)
    assert denc.dec_str(denc.enc_str("héllo"), 0)[0] == "héllo"
    d = {b"k": b"v", b"": b"x"}
    assert denc.dec_map(denc.enc_map(d, denc.enc_bytes, denc.enc_bytes),
                        0, denc.dec_bytes, denc.dec_bytes)[0] == d
    with pytest.raises(denc.DecodeError):
        denc.dec_u32(b"\x01\x02", 0)  # truncated


def test_split_merge_collections(tmp_path):
    """PG split/merge: objects partition by hash bits and reunite on
    merge, in both packages alike."""
    from ceph_tpu_torch.placement.osdmap import ceph_str_hash_rjenkins

    def body(P, path):
        s = P.MemStore()
        t = P.tx.Transaction().create_collection("1.0")
        oids = [b"obj%d" % i for i in range(32)]
        for oid in oids:
            t.write("1.0", oid, 0, oid)
        s.apply_transaction(t)
        t2 = P.tx.Transaction().create_collection("1.1")
        t2.split_collection("1.0", bits=1, rem=1, dest="1.1")
        s.apply_transaction(t2)
        left = set(s.list_objects("1.0"))
        right = set(s.list_objects("1.1"))
        assert left | right == set(oids) and not (left & right)
        assert all(ceph_str_hash_rjenkins(o) & 1 == 0 for o in left)
        assert all(ceph_str_hash_rjenkins(o) & 1 == 1 for o in right)
        for oid in right:
            assert s.read("1.1", oid) == oid
        split = dump(s)
        s.apply_transaction(
            P.tx.Transaction().merge_collection("1.1", dest="1.0"))
        assert set(s.list_objects("1.0")) == set(oids)
        assert "1.1" not in s.list_collections()
        return split, dump(s)

    twins(body, tmp_path)


def test_split_merge_atomicity_with_preexisting_dest():
    """A rejected transaction leaks no object into a pre-existing
    destination collection."""
    s = memstore.MemStore()
    t = tx.Transaction()
    t.create_collection("1.0")
    t.create_collection("1.1")
    for i in range(8):
        t.write("1.1", b"o%d" % i, 0, b"x")
    s.apply_transaction(t)
    bad = tx.Transaction().merge_collection("1.1", dest="1.0")
    bad.remove("1.0", b"nope")
    with pytest.raises(pstore.NotFound):
        s.queue_transaction(bad)
    assert s.list_objects("1.0") == []
    assert len(s.list_objects("1.1")) == 8
    bad2 = tx.Transaction().split_collection("1.1", 1, 1, "1.0")
    bad2.remove("1.0", b"nope")
    with pytest.raises(pstore.NotFound):
        s.queue_transaction(bad2)
    assert s.list_objects("1.0") == []
    assert len(s.list_objects("1.1")) == 8


def test_set_alloc_hint_recorded():
    s = memstore.MemStore()
    t = tx.Transaction().create_collection("c")
    t.set_alloc_hint("c", b"new", 4 << 20, 64 << 10)
    t.write("c", b"new", 0, b"data")
    s.apply_transaction(t)
    hint = s.getattr("c", b"new", "_alloc_hint")
    assert int.from_bytes(hint[:8], "little") == 4 << 20
    assert int.from_bytes(hint[8:16], "little") == 64 << 10


# ---------------------------------------------------------------- WalStore


def make_walstore(path, P=TORCH, **kw):
    s = P.WalStore(str(path), **kw)
    s.mount()
    return s


def test_walstore_replay_after_crash(tmp_path):
    """Reopen without umount: WAL replay restores everything."""
    def body(P, path):
        s = make_walstore(path, P)
        s.apply_transaction(all_op_txn(P.tx))
        t = P.tx.Transaction().create_collection("c2")
        t.write("c2", b"late", 0, b"not checkpointed")
        s.apply_transaction(t)
        s2 = make_walstore(path, P)  # no umount of s: a crash
        check_all_op_state(s2, extra_colls=["c2"])
        assert s2.read("c2", b"late") == b"not checkpointed"
        fp = fingerprint(s2)
        s2.umount()
        return fp

    twins(body, tmp_path)


def test_walstore_snapshot_plus_wal(tmp_path):
    def body(P, path):
        s = make_walstore(path, P)
        s.apply_transaction(all_op_txn(P.tx))
        s.compact()  # snapshot; WAL truncated
        snap = digest(path / "snap")
        t = P.tx.Transaction().create_collection("c2")
        t.write("c2", b"post", 0, b"after snap")
        s.apply_transaction(t)
        s2 = make_walstore(path, P)  # snapshot + 1 WAL record
        check_all_op_state(s2, extra_colls=["c2"])
        assert s2.read("c2", b"post") == b"after snap"
        fp = fingerprint(s2)
        s2.umount()
        return snap, fp

    twins(body, tmp_path)


def test_walstore_torn_tail(tmp_path):
    """A record cut mid-append is discarded; every record before it
    survives."""
    s = make_walstore(tmp_path)
    t1 = tx.Transaction().create_collection("c")
    t1.write("c", b"a", 0, b"durable")
    s.apply_transaction(t1)
    s.apply_transaction(tx.Transaction().write("c", b"a", 0, b"torn away"))
    wal = tmp_path / "wal.log"
    with open(wal, "r+b") as f:
        f.truncate(os.path.getsize(wal) - 3)  # cut into the last record
    s2 = make_walstore(tmp_path)
    assert s2.read("c", b"a") == b"durable"
    s2.umount()


def test_walstore_corrupt_tail_crc(tmp_path):
    s = make_walstore(tmp_path)
    t1 = tx.Transaction().create_collection("c")
    t1.write("c", b"a", 0, b"good")
    s.apply_transaction(t1)
    s.apply_transaction(tx.Transaction().write("c", b"b", 0, b"flipped"))
    with open(tmp_path / "wal.log", "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    s2 = make_walstore(tmp_path)
    assert s2.read("c", b"a") == b"good"
    assert not s2.exists("c", b"b")  # corrupt record dropped
    s2.umount()


def test_walstore_torn_tail_then_more_writes(tmp_path):
    """Mount truncates a torn tail before appending: records written
    after the first crash stay reachable across a second crash."""
    def body(P, path):
        s = make_walstore(path, P)
        t1 = P.tx.Transaction().create_collection("c")
        t1.write("c", b"a", 0, b"one")
        s.apply_transaction(t1)
        s.apply_transaction(P.tx.Transaction().write("c", b"a", 0, b"gone"))
        wal = path / "wal.log"
        with open(wal, "r+b") as f:
            f.truncate(os.path.getsize(wal) - 2)  # tear the second record
        s2 = make_walstore(path, P)  # crash-reopen 1
        assert s2.read("c", b"a") == b"one"
        s2.apply_transaction(P.tx.Transaction().write("c", b"b", 0, b"two"))
        s3 = make_walstore(path, P)  # crash-reopen 2
        assert s3.read("c", b"a") == b"one"
        assert s3.read("c", b"b") == b"two"
        fp = fingerprint(s3)
        s3.umount()
        return fp

    twins(body, tmp_path)


def test_walstore_crash_inside_compact(tmp_path):
    """Crash between snapshot publish and WAL truncate: replay skips the
    pre-snapshot records by their sequence numbers."""
    s = make_walstore(tmp_path)
    t = tx.Transaction().create_collection("c")
    t.write("c", b"a", 0, b"v1")
    s.apply_transaction(t)
    s.apply_transaction(tx.Transaction().write("c", b"a", 0, b"v2"))
    (tmp_path / "snap").write_bytes(s._encode_snapshot())
    s2 = make_walstore(tmp_path)
    assert s2.read("c", b"a") == b"v2"
    s2.apply_transaction(tx.Transaction().write("c", b"a", 0, b"v3"))
    s3 = make_walstore(tmp_path)
    assert s3.read("c", b"a") == b"v3"
    s3.umount()


@pytest.mark.parametrize("device_csum", [False, True])
def test_walstore_snapshot_csum_detects_corruption(tmp_path, device_csum):
    """Blob checksums catch bit rot in the checkpoint file, on either
    checksum engine."""
    kw = {"compression": None, "device_csum": device_csum, "device": "cpu"}
    s = make_walstore(tmp_path, **kw)
    t = tx.Transaction().create_collection("c")
    t.write("c", b"a", 0, b"Z" * 10000)
    s.apply_transaction(t)
    s.umount()  # compacts -> snapshot holds the data
    snap = tmp_path / "snap"
    blob = bytearray(snap.read_bytes())
    idx = blob.find(b"Z" * 100)
    assert idx > 0
    blob[idx + 50] ^= 0x01
    snap.write_bytes(bytes(blob))
    s2 = walstore.WalStore(str(tmp_path), **kw)
    with pytest.raises(pstore.StoreError, match="csum mismatch"):
        s2.mount()


def test_walstore_rejected_txn_not_logged(tmp_path):
    s = make_walstore(tmp_path)
    t = tx.Transaction().create_collection("c")
    t.write("c", b"a", 0, b"ok")
    s.apply_transaction(t)
    size = os.path.getsize(tmp_path / "wal.log")
    with pytest.raises(pstore.NotFound):
        s.queue_transaction(tx.Transaction().remove("c", b"ghost"))
    assert os.path.getsize(tmp_path / "wal.log") == size
    s2 = make_walstore(tmp_path)
    assert s2.read("c", b"a") == b"ok"
    s2.umount()


def test_walstore_auto_compact(tmp_path):
    s = make_walstore(tmp_path, wal_compact_bytes=256)
    s.apply_transaction(tx.Transaction().create_collection("c"))
    for i in range(20):
        s.apply_transaction(
            tx.Transaction().write("c", b"o%d" % i, 0, b"x" * 64))
    if s._compactor is not None:
        s._compactor.join(timeout=60)  # compaction runs off this thread
        assert not s._compactor.is_alive()
    assert os.path.getsize(tmp_path / "wal.log") < 4096
    assert (tmp_path / "snap").exists()
    s2 = make_walstore(tmp_path)
    for i in range(20):
        assert s2.read("c", b"o%d" % i) == b"x" * 64
    s2.umount()


def test_walstore_empty_object_and_omap_snapshot(tmp_path):
    def body(P, path):
        s = make_walstore(path, P)
        t = P.tx.Transaction().create_collection("c")
        t.touch("c", b"empty")
        t.omap_setkeys("c", b"empty", {b"k": b"v"})
        t.omap_setheader("c", b"empty", b"H")
        s.apply_transaction(t)
        s.umount()
        s2 = make_walstore(path, P)
        assert s2.stat("c", b"empty") == 0
        assert s2.omap_get("c", b"empty") == {b"k": b"v"}
        assert s2.omap_get_header("c", b"empty") == b"H"
        s2.umount()
        return digest(path / "snap")

    twins(body, tmp_path)


def test_walstore_snapshot_csums_are_the_cores(tmp_path):
    """The per-block checksums in the port's snapshot, written on the
    plain CRC version (device_csum=True, device="cpu"), equal the C++
    core's CRC32C of each zero-padded 4 KiB block of the object."""
    rng = np.random.default_rng(3)
    objs = {b"o%d" % i: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for i, n in enumerate((1, 4096, 4097, 12288, 20000))}
    s = make_walstore(tmp_path, compression=None, device_csum=True,
                      device="cpu")
    t = tx.Transaction().create_collection("c")
    for oid, data in objs.items():
        t.write("c", oid, 0, data)
    s.apply_transaction(t)
    s.umount()
    buf = (tmp_path / "snap").read_bytes()
    off = 4 + 4 + 8 + 4  # magic, version, seq, collections
    _, off = denc.dec_str(buf, off)
    nobj, off = denc.dec_u32(buf, off)
    assert nobj == len(objs)
    for _ in range(nobj):
        oid, off = denc.dec_bytes(buf, off)
        _, off = denc.dec_u8(buf, off)
        data, off = denc.dec_bytes(buf, off)
        crcs, off = denc.dec_list(buf, off, denc.dec_u32)
        _, off = denc.dec_map(buf, off, denc.dec_str, denc.dec_bytes)
        _, off = denc.dec_map(buf, off, denc.dec_bytes, denc.dec_bytes)
        _, off = denc.dec_bytes(buf, off)
        assert data == objs[oid]
        padded = data + bytes(-len(data) % BLOCK)
        want = [jnative.crc32c(padded[i:i + BLOCK])
                for i in range(0, len(padded), BLOCK)]
        assert crcs == want


# ------------------------------------------------- across the two packages


@pytest.mark.parametrize("kind", ["walstore", "bluestore"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("clean", [True, False], ids=["umount", "crash"])
def test_store_mounts_in_the_other_package(kind, writer, clean, tmp_path):
    """A store directory written by one package mounts and reads in the
    other: after a clean umount (WalStore snapshot; BlueStore compacted
    KV) and after a crash (WAL replay; KV WAL replay with deferred
    records pending)."""
    W, R = (JAX, TORCH) if writer == "jax" else (TORCH, JAX)
    kw = {"compression": "zlib"}
    txns = schedule(W.tx)
    last = W.tx.Transaction().write("1.0", b"obj0", 50, b"at the crash")
    ref = W.MemStore()  # what the store must read back
    run_schedule(W, ref, txns + [last])
    s = make(W, kind, tmp_path, **kw)
    run_schedule(W, s, txns)
    if kind == "bluestore" and not clean:
        # die between the KV commit and the in-place write of a deferred
        # overwrite: its record must replay at the other package's mount
        s._crash_before_deferred = True
    s.apply_transaction(last)
    if clean:
        s.umount()
    r = make(R, kind, tmp_path, **kw)
    assert dump(r) == dump(ref)
    if kind == "bluestore":
        assert not list(r.kv.scan_prefix(b"D"))
        assert stored_csums_match_core(r) > 50
    r.apply_transaction(R.tx.Transaction().write("1.0", b"after", 0,
                                                 b"more" * 3000))
    r.umount()
    back = make(W, kind, tmp_path, **kw)  # and back again
    assert back.read("1.0", b"after") == b"more" * 3000
    assert back.read("1.0", b"obj0") == ref.read("1.0", b"obj0")
    back.umount()
    if not clean:  # let go of the crashed instance's files
        if kind == "bluestore":
            s.kv.close()
            s.dev.close()
        else:
            s._wal.close()


# ------------------------------------------------------------- kill -9


CHILD_HEAD = """
import sys
sys.path.insert(0, %r)
from ceph_tpu_torch.store import transaction as tx
from ceph_tpu_torch.store.bluestore import BlueStoreLite
from ceph_tpu_torch.store.walstore import WalStore
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "ceph_tpu"))
print("imports", ",".join(bad) or "-", flush=True)
"""


def _child(script: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(CHILD_HEAD % str(ROOT))
         + textwrap.dedent(script)],
        stdout=subprocess.PIPE, env=env, cwd=ROOT)
    assert proc.stdout.readline().split() == [b"imports", b"-"]
    return proc


def _kill_after(proc, acks: int) -> int:
    """Let ``acks`` commits through, then SIGKILL -> the last acked."""
    acked = -1
    try:
        for _ in range(acks):
            acked = int(proc.stdout.readline())
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    return acked


def test_sigkill_child_preserves_acked_writes(tmp_path):
    """Real kill -9: a child writes to the port's BlueStoreLite with
    fsync=True and reports each commit; every acked transaction reads
    back after the reopen, in the port's store and in the JAX
    package's."""
    proc = _child(f"""
        s = BlueStoreLite({str(tmp_path / 'bs')!r}, size=32 << 20,
                          fsync=True)
        s.mount()
        s.apply_transaction(tx.Transaction().create_collection("c"))
        i = 0
        while True:
            t = tx.Transaction().write("c", b"o%d" % i, 0, b"v%d" % i * 100)
            if i % 3 == 2:  # and a small overwrite: the deferred path
                t.write("c", b"o%d" % (i - 2), 7, b"patch")
            s.apply_transaction(t)
            print(i, flush=True)
            i += 1
    """)
    acked = _kill_after(proc, 12)

    def versions(i):
        """What object i may read back: transaction i + 2 patches it
        when i % 3 == 0; a transaction past the last ack may or may not
        have committed before the kill."""
        v = b"v%d" % i * 100
        patched = v[:7] + b"patch" + v[12:]
        if i % 3:
            return {v}
        if i + 2 <= acked:
            return {patched}
        return {v, patched}

    for P in (TORCH, JAX):
        s = P.BlueStoreLite(str(tmp_path / "bs"), size=32 << 20)
        s.mount()
        for i in range(acked + 1):
            assert s.read("c", b"o%d" % i) in versions(i)
        s.umount()


def test_sigkill_walstore_child_replays_acked_writes(tmp_path):
    """Real kill -9 of a child writing to the port's WalStore with
    fsync=True: the acked records replay from the WAL, a record torn by
    the kill (or torn here afterwards) is dropped, and the store takes
    writes again."""
    proc = _child(f"""
        s = WalStore({str(tmp_path / 'ws')!r}, fsync=True)
        s.mount()
        s.apply_transaction(tx.Transaction().create_collection("c"))
        i = 0
        while True:
            s.apply_transaction(
                tx.Transaction().write("c", b"o%d" % i, 0, b"w%d" % i * 300))
            print(i, flush=True)
            i += 1
    """)
    acked = _kill_after(proc, 15)
    wal = tmp_path / "ws" / "wal.log"
    with open(wal, "ab") as f:
        f.write(b"\x00\x10\x00\x00torn")  # a torn header past the end
    s = make_walstore(tmp_path / "ws")
    for i in range(acked + 1):
        assert s.read("c", b"o%d" % i) == b"w%d" % i * 300
    assert os.path.getsize(wal) == s._wal_size  # tail cut at mount
    s.apply_transaction(tx.Transaction().write("c", b"new", 0, b"x"))
    s.umount()
    j = make_walstore(tmp_path / "ws", JAX)
    assert j.read("c", b"new") == b"x"
    assert j.read("c", b"o%d" % acked) == b"w%d" % acked * 300
    j.umount()


def test_sigkill_between_kv_commit_and_deferred_write(tmp_path):
    """Real kill -9 after a deferred small overwrite committed to the KV
    but before its in-place block write: the reopen replays the defer
    record, so the bytes and the committed checksum agree."""
    proc = _child(f"""
        import time
        s = BlueStoreLite({str(tmp_path / 'bs')!r}, size=16 << 20,
                          fsync=True)
        s.mount()
        t = tx.Transaction().create_collection("c")
        t.write("c", b"o", 0, b"B" * 8192)
        s.apply_transaction(t)
        s._crash_before_deferred = True
        s.apply_transaction(tx.Transaction().write("c", b"o", 4000, b"XYZ"))
        print(0, flush=True)
        time.sleep(600)
    """)
    assert _kill_after(proc, 1) == 0
    s = bluestore.BlueStoreLite(str(tmp_path / "bs"), size=16 << 20)
    s.mount()
    assert s.read("c", b"o") == b"B" * 4000 + b"XYZ" + b"B" * (8192 - 4003)
    assert not list(s.kv.scan_prefix(b"D"))  # the record was consumed
    assert stored_csums_match_core(s) == 2
    s.umount()
