"""The port's tpulint (ceph_tpu_torch/analysis, ceph_tpu_torch/tools/
tpulint.py): per-rule fixtures, the twin scan and the port's tier-1 gate.

- The families that are neutral to the framework run each fixture of the
  JAX package's tests (tests/test_tpulint.py) through both analyzers, the
  reference's at the reference's path and the port's at the same path
  under ``ceph_tpu_torch/``: their (rule, symbol, message) lists must be
  equal, and the fixture must fire or stay clean as it does there.
- The three families that named JAX (mesh-discipline, dtype,
  trace-safety) get torch fixtures: a positive and a negative for every
  hazard they read in torch's spellings.
- The twin scan runs both analyzers over every pair of twin files of
  cluster/, msg/, store/, osdc/, utils/ and placement/.
- The gate runs the port's analyzer over ``ceph_tpu_torch`` against its
  own baseline (ceph_tpu_torch/tools/tpulint_baseline.json).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from ceph_tpu import analysis as ref_analysis
from ceph_tpu_torch import analysis
from ceph_tpu_torch.tools import tpulint

REPO = Path(__file__).resolve().parents[1]
BASELINE = REPO / "ceph_tpu_torch" / "tools" / "tpulint_baseline.json"

RULE_IDS = {
    "buffer-discipline", "dispatch-discipline", "dtype",
    "fabric-pipe-pickle", "fabric-shm-release", "fabric-spawn-discipline",
    "hedge-fanout-discipline", "hedge-task-discipline", "lock-discipline",
    "mesh-discipline", "send-discipline", "trace-safety", "wire-parity",
}


def lint(src: str, path: str, only=None):
    return analysis.lint_source(textwrap.dedent(src), path, only)


def msgs(findings):
    return [f.message for f in findings]


def port_path(ref_path: str) -> str:
    """The port's path of a reference path: ``ceph_tpu/x`` ->
    ``ceph_tpu_torch/x``, ``tools/x`` -> ``ceph_tpu_torch/tools/x``."""
    if ref_path.startswith("ceph_tpu/"):
        return "ceph_tpu_torch/" + ref_path[len("ceph_tpu/"):]
    return "ceph_tpu_torch/" + ref_path


def triples(findings):
    return [(f.rule, f.symbol, f.message) for f in findings]


# ------------------------------------------ neutral families, both ways
#
# (id, rule, reference path, source, findings expected on both sides)

NEUTRAL = [
    # wire-parity
    ("wire_symmetric_pair_clean", "wire-parity",
     "ceph_tpu/placement/encoding.py", """
        from ..utils import denc

        def encode_thing(t):
            return denc.enc_u32(t.a) + denc.enc_str(t.b)

        def decode_thing(buf, off=0):
            a, off = denc.dec_u32(buf, off)
            b, off = denc.dec_str(buf, off)
            return (a, b), off
        """, 0),
    ("wire_missing_field_fires", "wire-parity",
     "ceph_tpu/placement/encoding.py", """
        from ..utils import denc

        def encode_thing(t):
            return (denc.enc_u32(t.a) + denc.enc_str(t.b)
                    + denc.enc_u64(t.c))

        def decode_thing(buf, off=0):
            a, off = denc.dec_u32(buf, off)
            b, off = denc.dec_str(buf, off)
            return (a, b), off
        """, 1),
    ("wire_struct_arity_mismatch_fires", "wire-parity",
     "ceph_tpu/msg/frames.py", """
        import struct

        _HDR = struct.Struct("<IHHI")

        def encode_frame(f):
            return _HDR.pack(1, f.type, f.flags, len(f.payload))

        def decode_frame(buf):
            magic, ftype, flags = _HDR.unpack_from(buf, 0)
            return ftype, flags
        """, 1),
    ("wire_unrelated_struct_formats_clean", "wire-parity",
     "ceph_tpu/msg/frames.py", """
        import struct

        def enc_a(x):
            return struct.pack("<I", x)

        def dec_a(buf):
            (x,) = struct.unpack("<I", buf)
            return x

        def dec_b(buf):
            a, b = struct.unpack("<HH", buf)
            return a, b
        """, 0),
    ("wire_out_of_scope_clean", "wire-parity",
     "ceph_tpu/services/encoding.py", """
        from ..utils import denc

        def encode_thing(t):
            return denc.enc_u32(t.a) + denc.enc_u64(t.c)

        def decode_thing(buf, off=0):
            return denc.dec_u32(buf, off)
        """, 0),
    # lock-discipline
    ("lock_unguarded_shared_write_fires", "lock-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        class Daemon:
            def __init__(self):
                self._lock = asyncio.Lock()
                self.epoch = 0

            async def commit(self, e):
                async with self._lock:
                    self.epoch = e

            async def sneaky(self, e):
                self.epoch = e
        """, 1),
    ("lock_init_writes_exempt", "lock-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        class Daemon:
            def __init__(self):
                self._lock = asyncio.Lock()
                self.epoch = 0

            async def commit(self, e):
                async with self._lock:
                    self.epoch = e
        """, 0),
    ("lock_blocking_call_under_lock_fires", "lock-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio, time

        class Daemon:
            def __init__(self):
                self._lock = asyncio.Lock()
                self.n = 0

            async def tick(self):
                async with self._lock:
                    time.sleep(1)
                    self.n += 1
        """, 1),
    ("lock_mu_hint_is_suffix_only", "lock-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        class PG:
            def __init__(self):
                self.lock = asyncio.Lock()
                self.xattr_muts = {}

            async def record(self, k, v):
                async with self.lock:
                    self.xattr_muts = {k: v}

            async def sneaky(self, k, v):
                self.xattr_muts = {k: v}
        """, 1),
    ("lock_fault_hook_awaited_under_lock_fires", "lock-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        class PG:
            def __init__(self):
                self.lock = asyncio.Lock()

            async def do_op(self, osd):
                async with self.lock:
                    await osd.fault.pause("op_delay")
        """, 1),
    ("lock_fault_hook_sync_or_outside_lock_clean", "lock-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        class PG:
            def __init__(self):
                self.lock = asyncio.Lock()

            async def do_op(self, osd):
                await osd.fault.pause("op_delay")
                async with self.lock:
                    if osd.fault.hit("eio"):
                        raise IOError("injected")
        """, 0),
    ("lock_out_of_scope_dir_ignored", "lock-discipline",
     "ceph_tpu/services/fixture.py", """
        import asyncio, time

        class Frontend:
            def __init__(self):
                self._lock = asyncio.Lock()
                self.n = 0

            async def tick(self):
                self.n += 1
        """, 0),
    # send-discipline
    ("send_per_frame_drain_fires", "send-discipline",
     "ceph_tpu/msg/fixture.py", """
        async def _send_all(self, writer, frames):
            for f in frames:
                writer.write(f)
                await writer.drain()
        """, 1),
    ("send_corked_writer_allowlisted", "send-discipline",
     "ceph_tpu/msg/fixture.py", """
        async def _writer_bursts(self, dst, evt, items):
            while True:
                writer.write(b"".join(take_all(self)))
                await writer.drain()
        """, 0),
    ("send_handshake_single_drain_clean", "send-discipline",
     "ceph_tpu/msg/fixture.py", """
        async def _connect(self, dst):
            writer.write(hello)
            await writer.drain()
        """, 0),
    ("send_scoped_to_msg_layer", "send-discipline",
     "ceph_tpu/cluster/fixture.py", """
        async def pump(writer, frames):
            for f in frames:
                writer.write(f)
                await writer.drain()
        """, 0),
    ("send_wal_flush_fires", "send-discipline",
     "ceph_tpu/store/fixture.py", """
        import os

        class S:
            def queue_transaction(self, rec):
                self._wal.write(rec)
                self._wal.flush()
                os.fsync(self._wal.fileno())
        """, 2),
    ("send_committer_hook_clean", "send-discipline",
     "ceph_tpu/store/fixture.py", """
        import os

        class S:
            def _flush_wal(self):
                self._wal.flush()
                os.fsync(self._wal.fileno())

            def compact(self):
                self._wal.truncate(0)
                os.fsync(self._wal.fileno())
        """, 0),
    # buffer-discipline
    ("buffer_payload_coercion_fires", "buffer-discipline",
     "ceph_tpu/msg/fixture.py", """
        def ship(conn, payload):
            wire = bytes(payload)
            conn.send(wire)
        """, 1),
    ("buffer_tobytes_fires_in_cluster_hot_path", "buffer-discipline",
     "ceph_tpu/cluster/pg.py", """
        def stage(t, cid, oid, rows):
            t.write(cid, oid, 0, rows.tobytes())
        """, 1),
    ("buffer_tobytes_fires_in_cluster_fixture", "buffer-discipline",
     "ceph_tpu/cluster/fixture.py", """
        def stage(t, cid, oid, rows):
            t.write(cid, oid, 0, rows.tobytes())
        """, 1),
    ("buffer_identity_and_alloc_clean", "buffer-discipline",
     "ceph_tpu/msg/fixture.py", """
        def route(name, n):
            oid = bytes(name)
            pad = bytes(16)
            return oid, pad
        """, 0),
    ("buffer_flatten_boundary_clean", "buffer-discipline",
     "ceph_tpu/msg/fixture.py", """
        class BL:
            def flatten(self, payload):
                return bytes(payload)

        def _send_now(self, payload):
            return bytes(payload)
        """, 0),
    ("buffer_scoped_to_hot_paths", "buffer-discipline",
     "ceph_tpu/services/fixture.py", """
        def archive(payload):
            return bytes(payload)
        """, 0),
    # dispatch-discipline
    ("dispatch_host_placement_on_client_fires", "dispatch-discipline",
     "ceph_tpu/cluster/client.py", """
        class Client:
            def _calc(self, pgid):
                up, p = self.osdmap.pg_to_up_acting_osds(pgid)
                return p
        """, 1),
    ("dispatch_memo_ctor_and_do_rule_fire_in_osdc", "dispatch-discipline",
     "ceph_tpu/osdc/striper.py", """
        from ceph_tpu.placement.osdmap import PlacementMemo

        class Striper:
            def __init__(self):
                self._memo = PlacementMemo()

            def place(self, crush, rule, pps, size, w):
                return crush.do_rule(rule, pps, size, w)
        """, 2),
    ("dispatch_resolver_path_clean", "dispatch-discipline",
     "ceph_tpu/cluster/client.py", """
        class Client:
            async def _acalc(self, pgid):
                up, p = await self._placement.aup_acting(self.osdmap,
                                                         pgid)
                return p

            def _calc(self, pgid):
                up, p = self._placement.up_acting(self.osdmap, pgid)
                return p
        """, 0),
    ("dispatch_scoped_to_client_tier", "dispatch-discipline",
     "ceph_tpu/cluster/osd.py", """
        def scan(self, pgid):
            return self.osdmap.pg_to_up_acting_osds(pgid)
        """, 0),
    # the three fabric families
    ("fabric_spawn_fork_fires", "fabric-spawn-discipline",
     "tools/fixture.py", """
        import multiprocessing
        import os

        def shard_out():
            pid = os.fork()
            ctx = multiprocessing.get_context("fork")
            return pid, ctx
        """, 2),
    ("fabric_spawn_bare_mp_process_fires_popen_clean",
     "fabric-spawn-discipline", "ceph_tpu/cluster/fixture.py", """
        import multiprocessing
        import subprocess
        import sys

        def workers(n):
            bad = multiprocessing.Process(target=print)
            good = subprocess.Popen([sys.executable, "-m", "x"])
            ctx = multiprocessing.get_context("spawn")
            return bad, good, ctx
        """, 1),
    ("fabric_spawn_out_of_scope_clean", "fabric-spawn-discipline",
     "ceph_tpu/services/fixture.py", """
        import os

        def shard_out():
            return os.fork()
        """, 0),
    ("fabric_pipe_pickle_fires_on_pipe_surface", "fabric-pipe-pickle",
     "tools/swarm.py", """
        import pickle

        def ship(result, pipe):
            pipe.write(pickle.dumps(result))

        def recv(pipe):
            return pickle.loads(pipe.read())
        """, 2),
    ("fabric_pipe_pickle_scoped", "fabric-pipe-pickle",
     "ceph_tpu/store/fixture.py", """
        import pickle

        def snapshot(x):
            return pickle.dumps(x)
        """, 0),
    ("fabric_pipe_json_clean", "fabric-pipe-pickle", "tools/swarm.py", """
        import json

        def ship(result, pipe):
            pipe.write(json.dumps(result).encode())
        """, 0),
    ("fabric_shm_release_missing_fires", "fabric-shm-release",
     "ceph_tpu/msg/fixture.py", """
        def drain(ring, sink):
            for m in ring.recv_all():
                sink.append(bytes(m.view))
        """, 1),
    ("fabric_shm_release_in_finally_clean", "fabric-shm-release",
     "ceph_tpu/msg/fixture.py", """
        def drain(ring, sink):
            for m in ring.recv_all():
                try:
                    sink.append(bytes(m.view))
                finally:
                    m.release()

        def reap(ring):
            ring.recv_all()
            return ring.reclaim_dead()
        """, 0),
    # the two hedge families
    ("hedge_gather_over_reply_waits_fires", "hedge-fanout-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        async def read_shards(osd, waits):
            return await asyncio.gather(
                *(osd.await_reply(t, f, o) for t, f, o in waits))
        """, 1),
    ("hedge_gather_over_writes_clean", "hedge-fanout-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        async def write_shards(osd, subs):
            return await asyncio.gather(*(osd.send_sub(s) for s in subs))
        """, 0),
    ("hedge_orphaned_task_fires", "hedge-task-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        class PG:
            def read(self, shard):
                asyncio.create_task(self._hedge_read(shard))
        """, 1),
    ("hedge_retained_task_clean", "hedge-task-discipline",
     "ceph_tpu/cluster/fixture.py", """
        import asyncio

        class PG:
            def read(self, shard):
                self.tasks.add(asyncio.create_task(self._hedge_read(shard)))
                task = asyncio.ensure_future(self._hedge_read(shard))
                return task
        """, 0),
    ("hedge_out_of_scope_clean", "hedge-fanout-discipline",
     "ceph_tpu/services/fixture.py", """
        import asyncio

        async def read_shards(osd, waits):
            return await asyncio.gather(
                *(osd.await_reply(t, f, o) for t, f, o in waits))
        """, 0),
    # trace-safety's reactor-readback check (framework-neutral)
    ("trace_reactor_readback_fires", "trace-safety",
     "ceph_tpu/cluster/fixture.py", """
        import numpy as np

        class PG:
            async def write_stripes(self, codec, batch):
                return np.asarray(codec.encode_batch(batch))

            async def rebuild(self, codec, present, surv):
                return np.asarray(codec.decode_batch(present, surv))
        """, 2),
    ("trace_reactor_readback_in_executor_clean", "trace-safety",
     "ceph_tpu/cluster/fixture.py", """
        import numpy as np

        class Batcher:
            @staticmethod
            def _encode_sync(codec, batch):
                return np.asarray(codec.encode_batch(batch))

            async def encode(self, loop, codec, batch):
                return await loop.run_in_executor(
                    None, self._encode_sync, codec, batch)
        """, 0),
    ("trace_reactor_readback_skips_nested_sync_def", "trace-safety",
     "ceph_tpu/cluster/fixture.py", """
        import numpy as np

        class Batcher:
            async def encode(self, loop, codec, batch):
                def work():
                    return np.asarray(codec.encode_batch(batch))
                return await loop.run_in_executor(None, work)
        """, 0),
    ("trace_bulk_crush_readback_on_reactor_fires", "trace-safety",
     "ceph_tpu/placement/fixture.py", """
        import numpy as np

        class Resolver:
            async def _run_batch(self, compiled, rule, xs, n, w):
                return np.asarray(
                    bulk.do_rule_bulk(compiled, rule, xs, n, w))
        """, 1),
    ("trace_bulk_crush_executor_shape_clean", "trace-safety",
     "ceph_tpu/placement/fixture.py", """
        import numpy as np

        class Resolver:
            @staticmethod
            def _bulk_sync(compiled, rule, xs, n, w):
                out = bulk.do_rule_bulk(compiled, rule, xs, n, w)
                return np.asarray(out)

            async def _run_batch(self, loop, *a):
                return await loop.run_in_executor(
                    None, self._bulk_sync, *a)
        """, 0),
]


@pytest.mark.parametrize("case", NEUTRAL, ids=[c[0] for c in NEUTRAL])
def test_neutral_fixture_finds_the_same_in_both_analyzers(case):
    _, rule, ref_path, src, n = case
    src = textwrap.dedent(src)
    want = ref_analysis.lint_source(src, ref_path, only=[rule])
    got = analysis.lint_source(src, port_path(ref_path), only=[rule])
    assert triples(got) == triples(want)
    assert len(got) == n, [f.render() for f in got]


def test_neutral_fixtures_cover_every_neutral_family():
    neutral = RULE_IDS - {"mesh-discipline", "dtype"}
    assert {c[1] for c in NEUTRAL} == neutral


def test_port_scopes_do_not_reach_the_reference():
    """A hazard in the reference's tree is none of the port analyzer's
    business, whatever the family."""
    src = textwrap.dedent("""
        import asyncio, time

        class Daemon:
            def __init__(self):
                self._lock = asyncio.Lock()

            async def tick(self):
                async with self._lock:
                    time.sleep(1)
        """)
    assert lint(src, "ceph_tpu/cluster/fixture.py",
                only=["lock-discipline"]) == []
    assert lint(src, "ceph_tpu_torch/cluster/fixture.py",
                only=["lock-discipline"])


def test_fabric_scope_leaves_bench_out():
    """The port has no counterpart of bench.py: it is out of the fabric
    families' scope (the reference's analyzer reads it)."""
    src = textwrap.dedent("""
        import os, pickle

        def run(pipe):
            os.fork()
            pipe.write(pickle.dumps(1))
        """)
    for rule in ("fabric-spawn-discipline", "fabric-pipe-pickle"):
        assert ref_analysis.lint_source(src, "bench.py", only=[rule])
        assert lint(src, "bench.py", only=[rule]) == []
        assert lint(src, "ceph_tpu_torch/tools/swarm.py", only=[rule])


# ------------------------------------------------- mesh-discipline (torch)


@pytest.mark.parametrize("call", ["parity.cpu()", "parity.numpy()",
                                  "parity.tolist()", "crcs.sum().item()",
                                  'parity.to("cpu")',
                                  'parity.to(device="cpu")',
                                  'parity.to(torch.device("cpu"))',
                                  "np.asarray(parity)", "np.array(parity)"])
def test_mesh_discipline_readback_fires(call):
    src = f"""
        import numpy as np
        import torch

        def collect(parity, crcs):
            return {call}
        """
    for path in ("ceph_tpu_torch/parallel/fixture.py",
                 "ceph_tpu_torch/cluster/ecbatch.py"):
        out = lint(src, path, only=["mesh-discipline"])
        assert len(out) == 1, call
        assert "shard views" in out[0].message
        assert out[0].symbol == "collect"


@pytest.mark.parametrize("call", ["parity.cpu()", "parity.numpy()",
                                  'parity.to("cpu")', "np.asarray(parity)"])
@pytest.mark.parametrize("fn", ["shard_rows_to_host", "host_gather",
                                "_encode_sync", "_decode_sync",
                                "_repair_sync", "_dispatch_block",
                                "make_mesh", "_platform_healthy"])
def test_mesh_discipline_sanctioned_boundaries_clean(call, fn):
    out = lint(f"""
        import numpy as np

        def {fn}(parity):
            return {call}
        """, "ceph_tpu_torch/parallel/fixture.py", only=["mesh-discipline"])
    assert out == []


def test_mesh_discipline_device_moves_and_other_calls_clean():
    out = lint("""
        import torch

        def stage(parity, dev, slots):
            a = parity.to(dev)
            b = parity.to("cuda:1", non_blocking=True)
            c = parity.to(torch.int32)
            d = {k: v for k, v in slots.items()}
            return a, b, c, d
        """, "ceph_tpu_torch/parallel/fixture.py", only=["mesh-discipline"])
    assert out == []


def test_mesh_discipline_scoped_to_mesh_path():
    src = """
        import numpy as np

        def collect(parity):
            return parity.cpu(), np.asarray(parity)
        """
    assert lint(src, "ceph_tpu_torch/cluster/pg.py",
                only=["mesh-discipline"]) == []
    assert lint(src, "ceph_tpu/parallel/fixture.py",
                only=["mesh-discipline"]) == []


def test_mesh_discipline_keeps_the_reference_s_asarray_finding():
    src = textwrap.dedent("""
        import numpy as np

        class ECBatcher:
            def _mesh_encode_sync(self, codec, cells, mesh):
                parity, crcs = codec.encode_crc_batch_mesh(cells, 1, mesh)
                return np.asarray(parity), np.asarray(crcs)
        """)
    want = ref_analysis.lint_source(src, "ceph_tpu/cluster/ecbatch.py",
                                    only=["mesh-discipline"])
    got = lint(src, "ceph_tpu_torch/cluster/ecbatch.py",
               only=["mesh-discipline"])
    assert len(got) == 2 and triples(got) == triples(want)


# ------------------------------------------------------------ dtype (torch)


@pytest.mark.parametrize("call", ["torch.zeros(16)", "torch.zeros(2, 3)",
                                  "torch.ones(4, device=dev)",
                                  "torch.empty((2, 2))",
                                  "torch.full((4,), 7)", "torch.arange(8)",
                                  "torch.eye(3)", "torch.tensor([1, 2])",
                                  "torch.frombuffer(buf)"])
def test_dtype_torch_ctor_without_dtype_fires(call):
    out = lint(f"""
        import torch

        def make(buf, dev):
            return {call}
        """, "ceph_tpu_torch/ec/fixture.py", only=["dtype"])
    assert len(out) == 1
    assert "without an explicit dtype defaults to float32" in out[0].message


def test_dtype_torch_ctor_with_dtype_clean():
    out = lint("""
        import torch

        def make(buf, dev):
            a = torch.zeros(16, dtype=torch.uint8)
            b = torch.zeros(2, 3, dtype=torch.int32, device=dev)
            c = torch.arange(8, dtype=torch.int64)
            d = torch.frombuffer(buf, dtype=torch.uint8)
            e = torch.tensor([1, 2], dtype=torch.int32)
            f = torch.zeros_like(a)
            return a, b, c, d, e, f
        """, "ceph_tpu_torch/checksum/fixture.py", only=["dtype"])
    assert out == []


@pytest.mark.parametrize("dtype", ["torch.float16", "torch.float32",
                                   "torch.float64", "torch.float",
                                   "torch.bfloat16", "torch.half",
                                   "torch.double"])
def test_dtype_torch_float_dtypes_fire(dtype):
    out = lint(f"""
        import torch

        def make(x):
            a = torch.zeros(4, dtype={dtype})
            b = x.to({dtype})
            return a, b
        """, "ceph_tpu_torch/placement/fixture.py", only=["dtype"])
    assert len(out) == 2
    assert any("float dtype" in m for m in msgs(out))
    assert any(f"`.to({dtype})`" in m for m in msgs(out))


@pytest.mark.parametrize("cast", ["float", "half", "double", "bfloat16"])
def test_dtype_torch_float_casts_fire(cast):
    out = lint(f"""
        def gather(x):
            return x.{cast}()
        """, "ceph_tpu_torch/ec/fixture.py", only=["dtype"])
    assert len(out) == 1
    assert f"`.{cast}()` in a GF(2^8)/CRC path" == out[0].message


def test_dtype_torch_integer_casts_clean():
    out = lint("""
        import torch

        def words(x, dev):
            return (x.int(), x.long(), x.to(torch.int32), x.to(dev),
                    x.to(torch.uint8), x.float_power)
        """, "ceph_tpu_torch/ec/fixture.py", only=["dtype"])
    assert out == []


def test_dtype_gf2_torch_wide_int_fires_and_narrow_clean():
    out = lint("""
        import torch

        def gf2_apply(plan, rows):
            idx = torch.zeros(4, dtype=torch.int64)
            acc = rows.to(torch.int64)
            return idx, acc
        """, "ceph_tpu_torch/ops/gf2.py", only=["dtype"])
    assert sum("64" in m for m in msgs(out)) == 2
    out = lint("""
        import torch

        def gf2_apply(plan, rows):
            idx = torch.zeros(4, dtype=torch.int32)
            return idx, rows.to(torch.int32)
        """, "ceph_tpu_torch/ops/gf2.py", only=["dtype"])
    assert out == []


def test_dtype_scoped_to_gf_paths():
    src = """
        import torch

        def make(x):
            return torch.zeros(16), x.float()
        """
    assert lint(src, "ceph_tpu_torch/services/fixture.py",
                only=["dtype"]) == []
    assert lint(src, "ceph_tpu_torch/ops/rs.py", only=["dtype"]) == []
    assert len(lint(src, "ceph_tpu_torch/ec/fixture.py",
                    only=["dtype"])) == 2


def test_dtype_numpy_and_gf_arith_checks_are_the_reference_s():
    src = textwrap.dedent("""
        import numpy as np

        def gf_mul_table(a, b):
            t = np.zeros(16)
            u = np.zeros(4, dtype=np.float32)
            return a * b, t, u, a.astype(float)

        def scale(a, b):
            return a * b
        """)
    for ref_path in ("ceph_tpu/ec/fixture.py", "ceph_tpu/ops/gf2.py"):
        want = ref_analysis.lint_source(src, ref_path, only=["dtype"])
        got = lint(src, port_path(ref_path), only=["dtype"])
        assert triples(got) == triples(want)
        assert got
    assert any("XOR / table lookups" in m for m in msgs(
        lint(src, "ceph_tpu_torch/ec/fixture.py", only=["dtype"])))


# ----------------------------------------------------- trace-safety (torch)


@pytest.mark.parametrize("sync,what", [
    ("n = x.sum().item()", ".item()"), ("n = x.tolist()", ".tolist()"),
    ("n = x.cpu()", ".cpu()"), ("n = x.numpy()", ".numpy()"),
    ("n = np.asarray(x)", "np.asarray"), ("n = np.array(x)", "np.array"),
    ("print(x)", "print"), ("n = int(x[0])", "int()"),
    ("n = float(x.sum())", "float()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
])
def test_trace_host_sync_in_a_wrapper_caller_fires(sync, what):
    out = lint(f"""
        import numpy as np
        import torch

        from .. import kernels

        def gf_matmul(matrix, x: torch.Tensor) -> torch.Tensor:
            {sync}
            return kernels.gf_matmul(x, frags(matrix), 3)
        """, "ceph_tpu_torch/ops/fixture.py", only=["trace-safety"])
    assert len(out) == 1, msgs(out)
    assert what in out[0].message
    assert "device function" in out[0].message or "sync" in out[0].message
    assert out[0].symbol == "gf_matmul"


@pytest.mark.parametrize("sync", ["n = x.sum().item()", "n = x.cpu()",
                                  "print(x)", "n = int(x[0])",
                                  "torch.cuda.synchronize()"])
def test_trace_host_sync_outside_device_functions_clean(sync):
    out = lint(f"""
        import torch

        from .. import kernels

        def report(x: torch.Tensor):
            {sync}
            return x

        def plain(matrix, x: torch.Tensor):
            return gf_matmul_plain(matrix, x)
        """, "ceph_tpu_torch/ops/fixture.py", only=["trace-safety"])
    assert out == []


@pytest.mark.parametrize("name", ["gf_matmul", "gf2_xor", "crc32c",
                                  "straw2", "crush_rule", "xor_fold",
                                  "bit_planes", "plane_parity_pack",
                                  "crc_join"])
def test_trace_launch_wrappers_are_device_functions(name):
    src = f"""
        import torch

        def {name}(x: torch.Tensor, rows: int) -> torch.Tensor:
            n = int(x[0])
            LAUNCH.launch(x.device, x.data_ptr(), rows)
            return x

        def helper(x: torch.Tensor):
            return int(x[0])
        """
    out = lint(src, "ceph_tpu_torch/kernels.py", only=["trace-safety"])
    assert [f.symbol for f in out] == [name]
    # the same name elsewhere is no wrapper
    assert lint(src, "ceph_tpu_torch/ops/fixture.py",
                only=["trace-safety"]) == []


def test_trace_imported_wrapper_alias_and_nested_call():
    out = lint("""
        import torch

        from ..kernels import crc32c as k2

        def crc(x: torch.Tensor):
            out = k2(x, None, F, Z, 1, 1, 0)
            return out, out.tolist()

        def outer(x: torch.Tensor):
            def inner():
                return kernels.xor_fold(x).item()
            return inner
        """, "ceph_tpu_torch/ops/fixture.py", only=["trace-safety"])
    assert [(f.symbol, f.message.split("`")[1]) for f in out] == [
        ("crc", ".tolist()"), ("outer.inner", ".item()")]


def test_trace_static_metadata_and_host_params_clean():
    """int() on shapes, sizes and numel, or on a parameter that is no
    tensor, is no sync; nor is mutating self (torch re-runs a wrapper's
    Python body every call: the reference's re-trace checks do not
    apply)."""
    out = lint("""
        import torch

        from .. import kernels

        class Engine:
            def step(self, x: torch.Tensor, rows: int, words):
                n = int(x.shape[0]) * int(x.ndim) + int(x.numel())
                m = int(x.size(1)) + int(rows) + int(words)
                self.count = self.count + 1
                global LAST
                LAST = n
                return kernels.gf_matmul(x, F, n + m)
        """, "ceph_tpu_torch/ops/fixture.py", only=["trace-safety"])
    assert out == []


def test_trace_reactor_readback_of_a_tensor_method_fires():
    out = lint("""
        class PG:
            async def write_stripes(self, codec, batch):
                return codec.encode_batch(batch).cpu()

            async def place(self, bulk, compiled, xs):
                return bulk.do_rule_bulk(compiled, 0, xs, 3, W).tolist()

            async def fine(self, loop, codec, batch):
                def work():
                    return codec.encode_batch(batch).cpu()
                return await loop.run_in_executor(None, work)
        """, "ceph_tpu_torch/cluster/fixture.py", only=["trace-safety"])
    assert [f.symbol for f in out] == ["PG.write_stripes", "PG.place"]
    assert all("reactor thread" in m for m in msgs(out))


@pytest.mark.parametrize("rel", ["ceph_tpu_torch/kernels.py",
                                 "ceph_tpu_torch/ops/rs.py",
                                 "ceph_tpu_torch/ops/crc32c.py",
                                 "ceph_tpu_torch/ops/crush.py",
                                 "ceph_tpu_torch/ops/gf2.py",
                                 "ceph_tpu_torch/ops/xor_combine.py",
                                 "ceph_tpu_torch/placement/bulk.py"])
def test_trace_real_device_functions_are_clean(rel):
    src = (REPO / rel).read_text(encoding="utf-8")
    assert lint(src, rel, only=["trace-safety"]) == []


def test_trace_finds_every_wrapper_and_caller_of_the_port():
    """The device functions the rule reads in the port: the nine launch
    wrappers and the ops that launch them."""
    import ast

    from ceph_tpu_torch.analysis import rules_trace

    found = set()
    for path in sorted((REPO / "ceph_tpu_torch").rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        tree = ast.parse(path.read_text(encoding="utf-8"))
        aliases = rules_trace._kernel_aliases(tree)
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and (
                    (rel == "ceph_tpu_torch/kernels.py"
                     and node.name in rules_trace._WRAPPERS)
                    or rules_trace._launches(node, aliases)):
                found.add(f"{rel}:{node.name}")
    wrappers = {f"ceph_tpu_torch/kernels.py:{n}"
                for n in rules_trace._WRAPPERS}
    assert wrappers <= found
    assert {"ceph_tpu_torch/ops/rs.py:gf_matmul",
            "ceph_tpu_torch/ops/crc32c.py:_crc_kernel",
            "ceph_tpu_torch/ops/gf2.py:gf2_apply",
            "ceph_tpu_torch/ops/crush.py:straw2_choose",
            "ceph_tpu_torch/placement/bulk.py:rule_rows"} <= found


# ------------------------------------------------------ real wire and dtype


@pytest.mark.parametrize("rel", ["ceph_tpu_torch/placement/encoding.py",
                                 "ceph_tpu_torch/msg/frames.py",
                                 "ceph_tpu_torch/msg/messages.py"])
def test_wire_parity_real_wire_layer_is_clean(rel):
    src = (REPO / rel).read_text(encoding="utf-8")
    assert lint(src, rel, only=["wire-parity"]) == []


def test_dtype_real_gf2_kernel_module_is_clean():
    rel = "ceph_tpu_torch/ops/gf2.py"
    src = (REPO / rel).read_text(encoding="utf-8")
    assert lint(src, rel, only=["dtype"]) == []


# ------------------------------------------------------------- twin scan

TWIN_DIRS = ("cluster", "msg", "store", "osdc", "utils", "placement")


def _twins():
    out = []
    for sub in TWIN_DIRS:
        for path in sorted((REPO / "ceph_tpu_torch" / sub).glob("*.py")):
            if (REPO / "ceph_tpu" / sub / path.name).exists():
                out.append(f"{sub}/{path.name}")
    return out


#: Findings only the port's file gives, each from a decided device seam:
#: ``ECBatcher._stage`` is the port's single-device staging (one copy into
#: pinned host memory, the results copied back into pinned tensors); it
#: runs only under the sanctioned ``_encode_sync``/``_decode_sync``/
#: ``_repair_sync``, and its ``.numpy()`` calls are views of host tensors,
#: not readbacks of the card. The JAX package stages inside those
#: functions themselves.
SEAM_ONLY_IN_PORT = {
    "cluster/ecbatch.py": [("mesh-discipline", "ECBatcher._stage",
                            "`.numpy()` readback inside the mesh data "
                            "path: results must cross to the host as "
                            "per-device shard views (shard_rows_to_host)"
                            " or through the counted host_gather "
                            "boundary")] * 3,
}


@pytest.mark.parametrize("rel", _twins())
def test_twin_scan_finds_the_same_in_both_packages(rel):
    ref_path, path = f"ceph_tpu/{rel}", f"ceph_tpu_torch/{rel}"
    want = ref_analysis.lint_source(
        (REPO / ref_path).read_text(encoding="utf-8"), ref_path)
    got = analysis.lint_source(
        (REPO / path).read_text(encoding="utf-8"), path)
    extra = SEAM_ONLY_IN_PORT.get(rel, [])
    got_t = triples(got)
    for t in extra:
        got_t.remove(t)
    assert got_t == triples(want)


def test_twin_scan_covers_the_six_directories():
    twins = _twins()
    assert {t.split("/")[0] for t in twins} == set(TWIN_DIRS)
    assert len(twins) >= 60
    assert set(SEAM_ONLY_IN_PORT) <= set(twins)


# ------------------------------------------------------------- registry


def test_registry_rejects_duplicates_and_lists_rules():
    analysis.preload()
    reg = analysis.instance()
    assert set(reg.names()) == RULE_IDS
    with pytest.raises(KeyError):
        reg.add("dtype", analysis.Rule)
    with pytest.raises(KeyError):
        reg.get("no-such-rule")


def test_unknown_rule_id_raises():
    with pytest.raises(KeyError):
        analysis.lint_source("x = 1", "ceph_tpu_torch/ec/f.py",
                             only=["bogus"])


def test_port_registry_is_its_own():
    """The port's registry and rule classes are its own objects: the JAX
    package's are not imported by the port's analyzer."""
    ref_analysis.preload()
    analysis.preload()
    assert analysis.instance() is not ref_analysis.instance()
    assert set(ref_analysis.instance().names()) == RULE_IDS
    for rule in analysis.instance().rules():
        assert type(rule).__module__.startswith("ceph_tpu_torch.analysis.")


def test_syntax_error_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    out = analysis.run_paths([bad], tmp_path)
    assert [(f.rule, f.path) for f in out] == [("syntax", "broken.py")]


# ------------------------------------------------------------- baseline


def test_baseline_roundtrip_and_ratchet(tmp_path):
    f1 = analysis.Finding("dtype", "a.py", 3, "f", "m1")
    f2 = analysis.Finding("dtype", "a.py", 9, "f", "m1")  # same key
    f3 = analysis.Finding("dtype", "a.py", 5, "g", "m2")
    p = tmp_path / "b.json"
    analysis.save_baseline(p, [f1, f2])
    base = analysis.load_baseline(p)
    assert analysis.unbaselined([f1, f2], base) == []
    assert analysis.unbaselined([f1, f2, f2, f3], base) == [f2, f3]
    assert analysis.load_baseline(tmp_path / "nope.json") == {}
    body = json.loads(p.read_text())
    assert "python -m ceph_tpu_torch.tools.tpulint" in body["comment"]


def test_baseline_rejects_another_version(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"version": 2, "findings": {}}))
    with pytest.raises(ValueError, match="version"):
        analysis.load_baseline(p)


def test_update_baseline_ignores_filters(tmp_path):
    """A filtered run (``--rules dtype ceph_tpu_torch/ec
    --update-baseline``) still writes the FULL baseline."""
    out = tmp_path / "b.json"
    rc = tpulint.main(["--rules", "dtype", "ceph_tpu_torch/ec",
                       "--baseline", str(out), "--update-baseline"])
    assert rc == 0
    assert analysis.load_baseline(out) == analysis.load_baseline(BASELINE)


def test_port_baseline_is_its_own():
    """The port's baseline keys name only the port's files, and hold the
    port's copies of the reference's five lock-discipline entries."""
    base = analysis.load_baseline(BASELINE)
    ref = ref_analysis.load_baseline(REPO / "tools" /
                                     "tpulint_baseline.json")
    assert tpulint.DEFAULT_BASELINE == BASELINE
    assert all(k.split(":")[1].startswith("ceph_tpu_torch/") for k in base)
    copied = {k.replace(":ceph_tpu/", ":ceph_tpu_torch/", 1): v
              for k, v in ref.items()}
    assert {k: base[k] for k in copied} == copied


# ------------------------------------------------------------------ CLI


def test_cli_list_rules_names_all_13(capsys):
    assert tpulint.main(["--list-rules"]) == 0
    names = capsys.readouterr().out.split()
    assert names == sorted(RULE_IDS) and len(names) == 13


def test_cli_json_and_exit_1_on_a_new_finding(tmp_path, capsys):
    bad = tmp_path / "fixture.py"
    bad.write_text(textwrap.dedent("""
        import torch

        from .. import kernels

        def crc(x: torch.Tensor):
            return kernels.crc_join(x, Z, 0).item()
        """))
    assert tpulint.main(["--json", str(bad)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [(f["rule"], f["symbol"], f["line"]) for f in out] == [
        ("trace-safety", "crc", 7)]
    assert out[0]["path"] == bad.resolve().as_posix()
    assert tpulint.main([str(bad)]) == 1
    text = capsys.readouterr()
    assert "[trace-safety] crc: host sync `.item()`" in text.out
    assert "tpulint: 1 finding(s)" in text.err


def test_cli_baseline_grandfathers_and_no_baseline_reports(tmp_path,
                                                           capsys):
    assert tpulint.main([]) == 0
    err = capsys.readouterr().err
    n = sum(analysis.load_baseline(BASELINE).values())
    assert f"tpulint: 0 finding(s) ({n} baselined)" in err
    assert tpulint.main(["--no-baseline", "--json"]) == 1
    assert len(json.loads(capsys.readouterr().out)) == n
    assert tpulint.main(["--rules", "wire-parity,trace-safety"]) == 0


def test_cli_usage_error_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        tpulint.main(["--no-such-flag"])
    assert e.value.code == 2


def test_cli_module_runs_on_the_tree():
    res = subprocess.run([sys.executable, "-m", "ceph_tpu_torch.tools.tpulint"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout == ""


# ------------------------------------------------------------ port gate


def test_repo_gate_no_new_findings():
    """Tier-1 gate: ``python -m ceph_tpu_torch.tools.tpulint`` must be
    clean at HEAD modulo the port's committed baseline."""
    findings = analysis.run_paths(["ceph_tpu_torch"], REPO)
    new = analysis.unbaselined(findings, analysis.load_baseline(BASELINE))
    assert new == [], (
        "new tpulint findings (fix them or deliberately run "
        "`python -m ceph_tpu_torch.tools.tpulint --update-baseline`):\n"
        + "\n".join(f.render() for f in new))


def test_repo_gate_baseline_not_stale():
    """The baseline may not carry entries for findings that no longer
    exist, nor more of a key than there are."""
    findings = analysis.run_paths(["ceph_tpu_torch"], REPO)
    base = analysis.load_baseline(BASELINE)
    live = {}
    for f in findings:
        live[f.key] = live.get(f.key, 0) + 1
    stale = sorted(k for k in base if live.get(k, 0) < base[k])
    assert stale == [], (
        "baseline entries with no matching finding — regenerate with "
        "`python -m ceph_tpu_torch.tools.tpulint --update-baseline`:\n"
        + "\n".join(stale))
