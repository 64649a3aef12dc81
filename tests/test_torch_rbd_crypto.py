"""The cases of ``tests/test_rbd_crypto.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

RBD encryption tests: LUKS-role format/open, AES-XTS IO with
boundary read-modify-write, passphrase failure, ciphertext-at-rest,
snapshot passthrough (the librbd/crypto test role)."""
import asyncio

import numpy as np
import pytest

# the AES-GCM key wrap and AES-XTS data path both live on the optional
# `cryptography` package (as test_auth treats it): skip, don't
# error, in minimal containers
pytest.importorskip("cryptography")

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.osdc.striper import FileLayout
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services import RBD
from ceph_tpu_torch.services.rbd_crypto import (
    BLOCK,
    WrongPassphrase,
    encryption_format,
    open_encrypted,
)
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

LAYOUT = FileLayout(stripe_unit=16384, stripe_count=1,
                    object_size=16384)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make(size=256 * 1024):
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rbd", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    rbd = RBD(c.client, 1)
    await rbd.create("vault", size, LAYOUT)
    await encryption_format(rbd, "vault", "hunter2")
    return c, rbd


def test_roundtrip_and_at_rest_ciphertext():
    async def t():
        c, rbd = await make()
        img = await open_encrypted(rbd, "vault", "hunter2")
        rng = np.random.default_rng(11)
        data = rng.integers(0, 256, 3 * BLOCK, dtype=np.uint8).tobytes()
        await img.write(0, data)
        assert await img.read(0, len(data)) == data
        # at rest the RADOS object holds CIPHERTEXT, not the plaintext
        plain = await rbd.open("vault")
        raw = await plain.read(0, len(data))
        assert raw != data and len(raw) == len(data)
        await img.release_lock()
        await c.stop()

    run(t())


def test_unaligned_rmw_and_sparse_reads():
    async def t():
        c, rbd = await make()
        img = await open_encrypted(rbd, "vault", "hunter2")
        # never-written regions read as zeros (sparse contract)
        assert await img.read(0, 100) == b"\x00" * 100
        # partial-block writes at odd offsets round-trip, preserving
        # neighbors through the boundary RMW
        await img.write(1000, b"A" * 50)
        await img.write(BLOCK - 7, b"B" * 20)  # spans a block boundary
        assert await img.read(1000, 50) == b"A" * 50
        assert await img.read(BLOCK - 7, 20) == b"B" * 20
        assert await img.read(950, 50) == b"\x00" * 50
        # overwrite inside one block keeps the rest of the block
        await img.write(1010, b"C" * 10)
        assert await img.read(1000, 30) == (
            b"A" * 10 + b"C" * 10 + b"A" * 10)
        await img.release_lock()
        await c.stop()

    run(t())


def test_wrong_passphrase_and_unformatted():
    async def t():
        c, rbd = await make()
        with pytest.raises(WrongPassphrase):
            await open_encrypted(rbd, "vault", "letmein")
        with pytest.raises(IOError, match="already formatted"):
            await encryption_format(rbd, "vault", "again")
        await rbd.create("plain", 64 * 1024, LAYOUT)
        with pytest.raises(IOError, match="not encryption-formatted"):
            await open_encrypted(rbd, "plain", "x")
        # odd-sized images are rejected at format time (XTS blocks)
        await rbd.create("odd", 4096 + 512, LAYOUT)
        with pytest.raises(IOError, match="multiple"):
            await encryption_format(rbd, "odd", "x")
        await c.stop()

    run(t())


def test_concurrent_subblock_writes_and_resize_guard():
    async def t():
        c, rbd = await make()
        img = await open_encrypted(rbd, "vault", "hunter2")
        # two disjoint sub-block writes into the SAME crypto block,
        # issued concurrently: the write lock serializes their RMW so
        # neither erases the other
        await asyncio.gather(img.write(0, b"A" * 100),
                             img.write(200, b"B" * 100))
        assert await img.read(0, 100) == b"A" * 100
        assert await img.read(200, 100) == b"B" * 100
        assert await img.read(100, 100) == b"\x00" * 100
        # resize must hold the crypto-block invariant format enforced
        with pytest.raises(IOError, match="multiple"):
            await img.resize(BLOCK * 3 + 512)
        await img.resize(BLOCK * 4)
        assert img.size == BLOCK * 4
        await img.release_lock()
        await c.stop()

    run(t())


def test_reopen_discard_and_snapshots():
    async def t():
        c, rbd = await make()
        img = await open_encrypted(rbd, "vault", "hunter2")
        payload = bytes(range(256)) * 64  # 16 KiB
        await img.write(2 * BLOCK, payload)
        await img.snap_create("before")
        await img.write(2 * BLOCK, b"\xff" * len(payload))
        # discard: aligned middle becomes a hole, edges re-encrypt
        await img.discard(2 * BLOCK + 100, BLOCK)
        got = await img.read(2 * BLOCK, len(payload))
        assert got[:100] == b"\xff" * 100
        assert got[100:100 + BLOCK] == b"\x00" * BLOCK
        assert got[100 + BLOCK:] == b"\xff" * (len(payload) - BLOCK - 100)
        await img.release_lock()
        # a fresh open with the same passphrase sees the same bytes
        img2 = await open_encrypted(rbd, "vault", "hunter2")
        assert (await img2.read(2 * BLOCK, 100)) == b"\xff" * 100
        # snapshot read-back through an encrypted snap handle
        await img2.release_lock()
        snap = await open_encrypted(rbd, "vault", "hunter2",
                                    snap="before")
        assert await snap.read(2 * BLOCK, len(payload)) == payload
        await c.stop()

    run(t())
