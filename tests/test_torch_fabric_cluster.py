"""The process-tier cases of ``tests/test_fabric.py`` on the port
(``ceph_tpu_torch``): the seeded thrash over a ``ProcCluster`` of daemon
processes on each messenger backend, and one EC write/read cycle
byte-exact across the cluster's messenger backends (LocalBus in one
process, TCP and shm between daemon processes). Every daemon runs on
``device="cpu"`` (the kernels' plain versions). Copied with only their
imports and device changed, and the thrash's outer deadline cut from 300
s to 200 s. Tolerance: exact, as in the reference.
"""
import argparse
import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.cluster.procstart import ProcCluster
from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.tools import thrash

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro, timeout=240):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.mark.parametrize("backend", ["tcp", "shm"])
def test_proccluster_seeded_thrash_converges(backend, tmp_path,
                                             monkeypatch):
    """~5 s seeded thrash over REAL daemon processes on each messenger
    backend: post-heal active+clean, byte-exact oracle, a clean
    deep-scrub round, leak-free hedge ledger."""
    monkeypatch.setenv("CEPH_TPU_SHM_DIR", str(tmp_path))
    args = argparse.Namespace(
        seed=20260803, duration=4.0, osds=5, mons=1, k=3, m=2,
        profile="rs", pg_num=8, objects=6, obj_size=24 << 10,
        writers=2, settle=90.0, backend=backend,
        objectstore="walstore", proc=True, device="cpu")
    verdict = run(thrash._run_proc(args, max_unavail=2), timeout=200)
    assert verdict["converged"], verdict
    assert verdict["byte_exact"], verdict
    assert verdict["scrub_inconsistent"] == 0, verdict
    assert verdict["hedge_leak_free"], verdict["hedges"]
    assert verdict["passed"], verdict


def test_ec_write_read_byte_exact_across_backends(tmp_path, monkeypatch):
    """One EC write/read cycle, three messenger backends, one source
    buffer: every byte identical (the A/B the zero-copy plane must
    not break)."""
    monkeypatch.setenv("CEPH_TPU_SHM_DIR", str(tmp_path))
    data = np.random.default_rng(20).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    pool = dict(id=2, name="ab", size=6, min_size=4, pg_num=8,
                crush_rule=1, type="erasure",
                ec_profile={"plugin": "rs_tpu", "k": "4", "m": "2",
                            "stripe_unit": "65536"})
    results = {}

    async def localbus():
        c = TestCluster(n_osds=6, device="cpu")
        await c.start()
        try:
            await c.client.create_pool(Pool(**pool))
            await c.wait_active(30)
            await c.client.write_full(2, "obj", data)
            results["localbus"] = bytes(await c.client.read(2, "obj"))
        finally:
            await c.stop()

    async def proc(backend):
        d = tmp_path / backend
        d.mkdir()
        c = ProcCluster(str(d), n_osds=6, objectstore="memstore",
                        backend=backend, device="cpu")
        await c.start()
        try:
            await c.client.create_pool(Pool(**pool))
            await c.wait_active(60)
            await c.client.write_full(2, "obj", data)
            results[backend] = bytes(await c.client.read(2, "obj"))
        finally:
            await c.stop()

    run(localbus())
    run(proc("tcp"))
    run(proc("shm"))
    assert results["localbus"] == data
    assert results["tcp"] == data
    assert results["shm"] == data
