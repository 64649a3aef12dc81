"""ECBatcher: the coalescing EC encode/decode dispatcher of the OSD
data path, on the port's torch device.

The card amortizes host<->device latency only when many stripes ride one
dispatch, but the op stream hands the daemon stripes a few at a time.
This module closes that gap NIC-interrupt-coalescing style:

- **Cross-tick adaptive coalescing.** Stripes are held up to a size
  target (``osd_ec_batch_target_stripes``) or a deadline
  (``osd_ec_batch_window`` seconds) instead of flushing every reactor
  tick. An mClock-aware fast-flush keeps latency honest: when the op
  scheduler reports nothing else queued that could contribute stripes,
  waiting out the window is pure added latency and the batch goes now.
- **Double buffering.** While one batch is in flight on the executor,
  the next accumulates; completion drains it immediately, so the
  in-flight time itself is the accumulation window under load.
- **Fused encode+CRC.** The device path makes ONE codec call that
  returns parity cells AND the per-cell CRC32Cs of data+parity (one
  launch of each kernel) — no second host pass over the encoded cells.
  The host engine keeps its two-pass shape (parity only; the caller
  runs its own multithreaded CRC pass).
- **Batched decode.** Degraded reads, recovery and scrub repair submit
  (B, k', su) rebuild batches through the same bucket machinery instead
  of one ``codec.decode`` per object; wanted parity rows fold into the
  recovery matrix host-side (one stacked matmul).
- **Mesh mode** (``osd_ec_mesh_devices`` > 1, parallel/runtime.py).
  Each bucket's staging batch is placed slot-resident under a (stripe,
  width) mesh — stripes land sharded, the fused encode+CRC runs on every
  slot so each shard row's cells and CRCs are produced on the slot that
  owns them, and results come back through per-slot shard views
  (``shard_rows_to_host``), never a whole-array host gather
  (``runtime.STATS.host_gathers`` proves it). ``parallel_repair_mode``
  (off/allgather/psum_bits) additionally routes the decode side through
  shard_comm's distributed GF matmul: recovery partials combine via
  collectives over the mesh instead of messenger fan-in. Both mesh paths
  are byte-identical to the single-device dispatch.

The device half is the port's own (the flush policy, fail-closed
isolation, over-decomposition and the cold-shape shield above it are
the JAX package's, line for line):

- **Staging.** A batch of (B, k, su) uint8 numpy cells -- often a
  transposed view of the caller's shard-major buffer -- is copied ONCE
  into a freshly allocated pinned host tensor (that one pass also makes
  it contiguous), sent with ``.to(device, non_blocking=True)`` and
  viewed as (B, k, su/4) int32 words for the codec seam
  (``encode_crc_batch`` / ``decode_batch`` / ``repair_batch``). Results
  come back with ``non_blocking`` copies into fresh pinned host tensors;
  the worker thread waits on an event recorded after them, never the
  reactor. Pinned blocks come from PyTorch's caching host allocator,
  which hands a block out again only after its copies completed and its
  tensor was freed, so no later batch can overwrite a result a caller
  still holds.
- **Streams.** Each executor thread dispatches on its own
  ``torch.cuda.Stream`` (thread-local), so the batches of two buckets in
  flight at once overlap on the card; the kernels launch on the current
  stream.
- **No pow2 pad.** The JAX package pads every batch to a power of two to
  cap XLA recompiles per batch size. The CUDA kernels take any B, so the
  port dispatches each batch at its own size; a mesh batch pads only to
  a multiple of the stripe axis (``parallel.pad_batch``).
- **Mesh.** The mesh resolves on the codec's device at the first
  dispatch (``runtime.serving_mesh``): n cards, or a virtual mesh of n
  slots on one device after ``parallel.pin_virtual``. A mesh that cannot
  be had raises to the batch's waiters; nothing drops to the one-device
  path.
- **CPU.** On a CPU codec (the tests) the same code runs without pinning
  or streams, through the kernels' plain versions. The device is always
  the codec's.

Buckets are keyed by a stable codec *profile* tuple, never ``id(codec)``
— a GC'd codec's address can be reused by a different one, and two
codecs from the same profile must share a bucket anyway.

Perf counters (declared by :meth:`ECBatcher.declare_counters`) record
batch occupancy, flush reason, queue wait, and failures, so a run can
report WHY batches are the size they are.
"""
from __future__ import annotations

import asyncio
import concurrent.futures as cf
import os
import threading
import time

import numpy as np
import torch

from .. import native
from ..ops import rs
from ..utils.fault import InjectedError

_FAILED = object()

#: flush reasons, each with an ``ec_flush_<reason>`` counter:
#: size      — the queued stripe count reached the target
#: deadline  — the batch window expired
#: fast      — mClock queue idle: nothing else could contribute stripes
#: tick      — per-reactor-tick flush (window disabled)
#: drain     — an in-flight batch completed and the next buffer flushed
FLUSH_REASONS = ("size", "deadline", "fast", "tick", "drain")

#: a decode/repair survivor pattern promotes from the host engine to
#: the device engine only after it has moved this many bytes through
#: the batcher. A quarter-GiB of ONE erasure pattern is a recovery storm
#: rebuilding a whole OSD, not a run of degraded reads: storms cross
#: this within their first stacked rounds, while the one-off patterns
#: hedge substitution manufactures never do and never pay the device
#: path's first-use cost for a pattern (on the card: the host matrix
#: inversion and the kernel's B operands, built and copied over).
#: Override: osd_ec_cold_shape_bytes (0 disables the shield).
COLD_SHAPE_BYTES = 256 << 20


def codec_profile_key(codec) -> tuple:
    """Stable bucket identity of a codec: exactly the fields that
    determine its generator matrix and execution engine. ``id(codec)``
    can alias two codecs if one is GC'd and a new one reuses the
    address — the profile tuple cannot. Codecs whose geometry goes
    beyond (k, m) — bitmatrix w, Clay d, LRC layer layout — append it
    via ``profile_key_extra`` so two different codes never share a
    bucket."""
    extra = getattr(codec, "profile_key_extra", None)
    return (
        codec.profile.get("plugin", type(codec).__name__),
        getattr(codec, "technique", ""),
        codec.k,
        codec.m,
        getattr(codec, "backend", ""),
    ) + (tuple(extra()) if extra is not None else ())


class ECBatcher:
    """Collects EC stripe work per (codec profile, cell geometry)
    bucket and runs each bucket as one batched dispatch on the engine
    the codec resolves to (the device kernels, or the multithreaded C++
    host core for a backend=host codec). Dispatch + readback run in a
    worker thread so the reactor keeps serving ops while batches are in
    flight."""

    def __init__(self, perf=None, conf=None, idle_probe=None,
                 fault=None) -> None:
        #: bucket key -> [(codec, cells, fut, t_enqueue)]
        self._pending: dict[tuple, list] = {}
        #: bucket key -> (reason, TimerHandle) for an armed flush timer
        self._timers: dict[tuple, tuple] = {}
        self._scheduled: set[tuple] = set()
        self._inflight: set[tuple] = set()
        #: ops currently parked on a batcher future (queued OR riding
        #: an in-flight dispatch) — the daemon's idle probe compares
        #: this against its op-tracker to tell "everyone who could
        #: contribute stripes is already aboard" from "more coming"
        self._parked = 0
        self.perf = perf
        self.conf = conf
        #: () -> bool: True when the op scheduler has nothing queued
        #: that could contribute more stripes (mClock-aware fast flush)
        self.idle_probe = idle_probe
        #: optional FaultInjector (the owning OSD's): site "ec_batch"
        #: fails a dispatch, exercising the fail-closed isolation path
        self.fault = fault
        #: cumulative bytes dispatched per decode/repair survivor
        #: pattern — the cold-shape shield's ledger (see _cold_shape)
        self._shape_bytes: dict[tuple, int] = {}
        #: promotion state per pattern: False = device path warming in
        #: the background, True = warm (device path open)
        self._shape_warm: dict[tuple, bool] = {}
        #: wall seconds of each pattern's background warm dispatch
        self.warm_seconds: dict[tuple, float] = {}
        #: per executor thread: its own CUDA stream per device
        self._local = threading.local()
        #: serving-mesh resolution state: resolved lazily on the first
        #: device-engine dispatch, on the codec's device, and cached (a
        #: mesh that cannot be had raises and is not cached)
        self._mesh_resolved = False
        self._mesh_cached = None

    @staticmethod
    def declare_counters(perf) -> None:
        """Declare every counter this batcher mutates (shared by the
        daemon and the unit tests so the two can never drift)."""
        perf.add_u64_counter("ec_batches", "batched EC encode dispatches")
        perf.add_histogram("ec_batch_stripes", "stripes per EC encode batch")
        perf.add_u64_counter("ec_batch_failures",
                             "EC batch dispatches that failed")
        perf.add_u64_counter("ec_batch_failures_injected",
                             "op stripe-groups failed by an INJECTED "
                             "dispatch error (fault site ec_batch)")
        perf.add_u64_counter("ec_batch_failures_dispatch",
                             "op stripe-groups failed by an organic "
                             "device/executor dispatch error")
        perf.add_u64_counter("ec_batch_isolated",
                             "stripe-groups that recovered via "
                             "per-item isolation after a batch failure")
        perf.add_u64_counter("ec_mesh_encode_dispatches",
                             "fused encode+CRC dispatches run sharded "
                             "under the device mesh")
        perf.add_u64_counter("ec_mesh_decode_dispatches",
                             "decode/repair dispatches run as mesh "
                             "collectives (parallel_repair_mode)")
        perf.add_u64_counter("ec_overdecompose_rounds",
                             "decode/repair dispatches run rateless-"
                             "over-decomposed into row-block sub-tasks")
        perf.add_u64_counter("ec_overdecompose_subtasks",
                             "row-block sub-task copies dispatched by "
                             "over-decomposed rounds (primary + hedge "
                             "duplicate per block)")
        perf.add_u64_counter("ec_overdecompose_shed",
                             "stale sub-task copies shed (cancelled, "
                             "or landed after their block had already "
                             "resolved)")
        perf.add_u64_counter("ec_decode_cold_host",
                             "decode/repair rounds dispatched on the "
                             "host engine because their survivor "
                             "pattern was still cold (cold-shape "
                             "shield: a waiting read never stalls on "
                             "a pattern's first device dispatch)")
        perf.add_u64_counter("ec_decode_batches",
                             "batched EC decode dispatches")
        perf.add_histogram("ec_decode_stripes",
                           "stripes per EC decode batch")
        perf.add_histogram("ec_queue_wait_us",
                           "per-stripe-group wait in the batch queue (us)")
        for reason in FLUSH_REASONS:
            perf.add_u64_counter(f"ec_flush_{reason}",
                                 f"EC batch flushes triggered by {reason}")

    # ------------------------------------------------------------ knobs

    def _target_stripes(self) -> int:
        if self.conf is None:
            return 0
        try:
            return int(self.conf["osd_ec_batch_target_stripes"])
        except Exception:
            return 0

    def _window(self) -> float:
        if self.conf is None:
            return 0.0
        try:
            return float(self.conf["osd_ec_batch_window"])
        except Exception:
            return 0.0

    def _overdecompose_factor(self) -> int:
        if self.conf is None:
            return 0
        try:
            return int(self.conf["osd_ec_overdecompose"])
        except Exception:
            return 0

    def _cold_shape_bytes(self) -> int:
        if self.conf is None:
            return COLD_SHAPE_BYTES
        try:
            return int(self.conf["osd_ec_cold_shape_bytes"])
        except Exception:
            return COLD_SHAPE_BYTES

    def _repair_mode(self) -> str:
        if self.conf is None:
            return "off"
        try:
            mode = str(self.conf["parallel_repair_mode"])
        except Exception:
            return "off"
        return mode if mode in ("allgather", "psum_bits") else "off"

    def mesh(self, device=None):
        """The serving mesh this batcher stages onto, or None (single-
        device path). Resolved once from the osd_ec_mesh_* knobs via
        parallel/runtime.py on ``device`` (the codec's, which every
        dispatch passes; the card when none is given) — the process-level
        cache means every OSD in a test cluster shares one mesh, like
        chips on a host. A mesh that cannot be had raises; it is not
        cached, so the next dispatch asks again."""
        if not self._mesh_resolved:
            n = w = 0
            if self.conf is not None:
                try:
                    n = int(self.conf["osd_ec_mesh_devices"])
                    w = int(self.conf["osd_ec_mesh_width"])
                except Exception:
                    n = 0
            if n > 1:
                from ..parallel import runtime

                self._mesh_cached = runtime.serving_mesh(n, max(1, w),
                                                         device)
            self._mesh_resolved = True
        return self._mesh_cached

    # ------------------------------------------------------- submission

    async def encode_cells(self, codec, cells: np.ndarray):
        """(B, k, su) uint8 data cells -> (parity, crcs):
        parity (B, m, su) uint8; crcs (B, k+m) uint32 per-cell CRC32Cs
        of data+parity from the fused device dispatch, or None on the
        host engine (whose callers keep their own multithreaded CRC
        pass).

        The fixed stripe_unit layout (cluster/stripe.py) means every
        caller in the cluster shares one cell shape, so stripes from
        different objects/PGs/ticks merge into ONE dispatch."""
        key = ("enc", codec_profile_key(codec), cells.shape[-1])
        return await self._submit(key, codec, cells)

    async def decode_cells(self, codec, present, want,
                           cells: np.ndarray) -> np.ndarray:
        """(B, k', su) uint8 surviving cells -> (B, len(want), su)
        uint8 rebuilt cells. ``present`` are the generator indices of
        the survivor rows (exactly k of them), ``want`` the generator
        indices to rebuild — parity rows fold into the recovery matrix
        host-side, so a wanted parity chunk is STILL one matmul."""
        key = ("dec", codec_profile_key(codec), cells.shape[-1],
               tuple(present), tuple(want))
        return await self._submit(key, codec, cells)

    async def repair_cells(self, codec, present, want,
                           cells: np.ndarray) -> np.ndarray:
        """Bandwidth-optimal sub-chunk repair (regenerating codes):
        (B, d, su/q) uint8 helper SLICES — each row a cell's repair
        planes — rebuild the single lost cell (B, 1, su) uint8. A
        recovery storm's stripes amortize into one stacked dispatch
        per (pattern, slice-geometry) bucket; counted with the decode
        counters (it IS the degraded path's dispatch). Clay has the
        batched sub-chunk repair (``repair_batch`` on its device route,
        ``repair_cells_host`` on the host engine); for a codec with
        neither the dispatch fails with "no batched sub-chunk repair"."""
        key = ("rep", codec_profile_key(codec), cells.shape[-1],
               tuple(present), tuple(want))
        return await self._submit(key, codec, cells)

    def parked(self) -> int:
        """Ops currently awaiting a batcher future (see _parked).

        Counts BOTH client encode/decode waits and background
        (recovery/scrub) decode waits — the idle probe compares this
        against the client-only op tracker, so a parked background
        decode can make the probe read "idle" one op early and settle-
        flush a slightly smaller batch. That erring direction costs a
        little occupancy, never latency, and the size/deadline triggers
        still bound both."""
        return self._parked

    def close(self) -> None:
        """Daemon shutdown: cancel armed flush timers/scheduled flushes
        and fail every queued waiter so nothing fires into a stopped
        daemon or hangs a caller. In-flight executor batches finish on
        their own; their completion drain finds the queues empty."""
        for _, handle in self._timers.values():
            handle.cancel()
        self._timers.clear()
        self._scheduled.clear()
        pending, self._pending = self._pending, {}
        for items in pending.values():
            for _, _, fut, _ in items:
                if not fut.done():
                    fut.set_result(_FAILED)

    async def _submit(self, key: tuple, codec, cells: np.ndarray):
        # cells pass through AS A VIEW (the zero-copy staging contract:
        # callers hand over ownership and never mutate after submit) —
        # the RMW path submits the (T, k, su) transpose of its
        # shard-major staging buffer; the one copy into pinned staging
        # (or the host engine's shard-major flatten) reads it as it lies
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.setdefault(key, []).append(
            (codec, cells, fut, loop.time()))
        self._parked += 1
        try:
            self._poke(key)
            result = await fut
        finally:
            self._parked -= 1
        if result is _FAILED:
            raise RuntimeError("batched EC dispatch failed")
        return result

    # ---------------------------------------------------- flush policy

    def _poke(self, key: tuple, drain: bool = False) -> None:
        """Decide whether the bucket flushes now, later, or not yet."""
        queue = self._pending.get(key)
        if not queue or key in self._scheduled:
            return
        if key in self._inflight:
            return  # double-buffer: accumulate; completion drains us
        if drain:
            self._arm_now(key, "drain")
            return
        target = self._target_stripes()
        if target > 0 and sum(len(c) for _, c, _, _ in queue) >= target:
            self._arm_now(key, "size")
            return
        window = self._window()
        if window <= 0:
            self._arm_now(key, "tick")
            return
        armed = self._timers.get(key)
        if self.idle_probe is not None and self.idle_probe():
            # nothing else queued that could contribute stripes: do NOT
            # wait out the window — but settle for a few ms first, so a
            # cohort still in client transit (invisible to the op
            # tracker until it arrives) can land in the same batch
            # (adaptive interrupt coalescing, not a bare fast path).
            # An already-armed fast timer stays: re-arming on every
            # arrival would defer the flush unboundedly.
            if armed is None or armed[0] == "deadline":
                if armed is not None:
                    armed[1].cancel()
                settle = min(window * 0.1, 0.005)
                self._timers[key] = ("fast",
                                     asyncio.get_running_loop().call_later(
                                         settle, self._flush, key, "fast"))
            return
        if armed is None:
            self._timers[key] = ("deadline",
                                 asyncio.get_running_loop().call_later(
                                     window, self._flush, key, "deadline"))

    def _arm_now(self, key: tuple, reason: str) -> None:
        """Flush on the next tick (coalesces same-tick submissions)."""
        self._scheduled.add(key)
        asyncio.get_running_loop().call_soon(self._flush, key, reason)

    def _flush(self, key: tuple, reason: str) -> None:
        self._scheduled.discard(key)
        timer = self._timers.pop(key, None)
        if timer is not None:
            timer[1].cancel()
        items = self._pending.pop(key, None)
        if not items:
            return
        if key in self._inflight:
            # a deadline fired while the drain path held the bucket:
            # put the work back; completion will drain it
            self._pending.setdefault(key, [])[:0] = items
            return
        self._inflight.add(key)
        if self.perf is not None:
            self.perf.inc(f"ec_flush_{reason}")
        asyncio.get_running_loop().create_task(self._run(key, items))

    # ------------------------------------------------------- execution

    async def _dispatch_once(self, loop, key: tuple, codec,
                             cells: np.ndarray):
        """One executor dispatch of a cell batch (shared by the normal
        batched path and the per-item isolation retries); the armed
        ``ec_batch`` fault site fails it with an InjectedError."""
        if self.fault is not None and self.fault.hit(
                "ec_batch", kind=key[0], stripes=len(cells)):
            raise InjectedError("injected EC batch dispatch failure")
        if key[0] == "enc":
            return await loop.run_in_executor(
                None, self._encode_sync, codec, cells)
        if key[0] == "rep":
            return await loop.run_in_executor(
                None, self._repair_sync, codec, key[3], key[4], cells)
        return await loop.run_in_executor(
            None, self._decode_sync, codec, key[3], key[4], cells)

    def _count_cause(self, exc: BaseException) -> None:
        if self.perf is not None:
            self.perf.inc("ec_batch_failures_injected"
                          if isinstance(exc, InjectedError)
                          else "ec_batch_failures_dispatch")

    async def _fail_closed(self, loop, key: tuple, items: list,
                           batch_exc: BaseException) -> None:
        """Fail closed: a poisoned batch must fail ONLY the stripes of
        the ops that still fail alone. Each submission group is retried
        as its own dispatch, so one op's bad stripes never reject its
        batch-mates, every waiter resolves exactly once, and the
        coalescing queue keeps flowing (callers never hold a PG lock
        across batcher awaits, so no lock can leak either way)."""
        kind = key[0]
        for codec, cells, fut, _t0 in items:
            if fut.done():
                continue
            if len(items) == 1:
                # alone in the batch: the batch failure IS this op's
                self._count_cause(batch_exc)
                fut.set_result(_FAILED)
                continue
            try:
                out = await self._dispatch_once(loop, key, codec, cells)
            except Exception as e:
                self._count_cause(e)
                fut.set_result(_FAILED)
                continue
            if self.perf is not None:
                self.perf.inc("ec_batch_isolated")
                if kind == "enc":
                    self.perf.inc("ec_batches")
                    self.perf.observe("ec_batch_stripes", len(cells))
                else:
                    self.perf.inc("ec_decode_batches")
                    self.perf.observe("ec_decode_stripes", len(cells))
            fut.set_result(out)

    async def _run(self, key: tuple, items: list) -> None:
        loop = asyncio.get_running_loop()
        if self.perf is not None:
            now = loop.time()
            for _, _, _, t0 in items:
                self.perf.observe("ec_queue_wait_us",
                                  max(0.0, (now - t0) * 1e6))
        kind = key[0]
        codec = items[0][0]
        cells = (items[0][1] if len(items) == 1
                 else np.concatenate([c for _, c, _, _ in items]))
        released = False
        try:
            out = await self._dispatch_once(loop, key, codec, cells)
        except Exception as e:
            # failed dispatches are NOT throughput: count the failure
            # (split by cause per finally-failed group), never the
            # batch, and resolve every waiter exactly once — innocent
            # batch-mates recover via per-item isolation. Release the
            # bucket FIRST: fresh stripes must keep dispatching while
            # the serial isolation retries grind through the wreck —
            # and release exactly ONCE: by the time _fail_closed
            # returns, a fresh batch for this key may be in flight,
            # and discarding its marker would let a third _run launch
            # concurrently.
            if self.perf is not None:
                self.perf.inc("ec_batch_failures")
            released = True
            self._inflight.discard(key)
            self._poke(key, drain=True)
            await self._fail_closed(loop, key, items, e)
            return
        finally:
            if not released:
                self._inflight.discard(key)
                self._poke(key, drain=True)
        # perf accounting strictly after success
        if self.perf is not None:
            if kind == "enc":
                self.perf.inc("ec_batches")
                self.perf.observe("ec_batch_stripes", len(cells))
            else:
                self.perf.inc("ec_decode_batches")
                self.perf.observe("ec_decode_stripes", len(cells))
        row = 0
        for _, c, fut, _ in items:
            b = len(c)
            if not fut.done():
                if kind == "enc":
                    parity, crcs = out
                    fut.set_result((
                        parity[row : row + b],
                        None if crcs is None else crcs[row : row + b]))
                else:
                    fut.set_result(out[row : row + b])
            row += b

    # ------------------------------------------------- sync dispatches
    # (worker-thread only: the C++ core — ctypes releases the GIL — and
    # the card's copies and kernels overlap the reactor; the thread, not
    # the reactor, waits for the card)

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        """The calling thread's own CUDA stream on ``device``."""
        streams = self._local.__dict__.setdefault("streams", {})
        stream = streams.get(str(device))
        if stream is None:
            stream = streams[str(device)] = torch.cuda.Stream(device)
        return stream

    def _stage(self, device: torch.device, cells: np.ndarray, run) -> tuple:
        """One device dispatch of a (B, C, su) uint8 cell batch: copy the
        cells once into a host tensor (pinned for a CUDA device), send
        them to ``device`` as (B, C, su/4) int32 words, call ``run(words)``
        (a tuple of int32 tensors on ``device``) and bring every result
        back as a host numpy int32 array of its own. On a CUDA device
        everything runs on this thread's stream and the thread waits for
        it."""
        cuda = device.type == "cuda"
        host = torch.empty(cells.shape, dtype=torch.uint8, pin_memory=cuda)
        np.copyto(host.numpy(), cells)
        words = host.view(torch.int32)
        if not cuda:
            return tuple(t.contiguous().numpy() for t in run(words))
        stream = self._stream(device)
        with torch.cuda.stream(stream):
            outs = run(words.to(device, non_blocking=True))
            back = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    .copy_(t, non_blocking=True) for t in outs]
            done = torch.cuda.Event(blocking=True)
            done.record(stream)
        done.synchronize()
        return tuple(t.numpy() for t in back)

    def _encode_sync(self, codec, cells: np.ndarray):
        """(B, k, su) u8 -> (parity (B, m, su) u8, crcs | None)."""
        engine = getattr(codec, "resolved_backend", lambda: "device")()
        b, k, su = cells.shape
        if engine == "host" or not hasattr(codec, "encode_crc_batch"):
            if getattr(codec, "bytewise_linear", False):
                # GF(2^8) matrix codes: ONE multithreaded C++ matmul
                # over the shard-major flatten (reads the RMW staging
                # buffer's contiguous storage back without a copy)
                flat = np.ascontiguousarray(
                    cells.transpose(1, 0, 2)).reshape(k, b * su)
                par = native.rs_encode(codec.matrix, flat,
                                       threads=os.cpu_count() or 1)
                parity = np.ascontiguousarray(
                    par.reshape(codec.m, b, su).transpose(1, 0, 2))
                return parity, None
            # cellwise codecs: the plugin's own vectorized host batch;
            # CRCs stay the caller's separate multithreaded pass, like
            # every host engine
            host = getattr(codec, "encode_cells_host", None)
            if host is not None:
                return host(cells), None
            return np.stack([codec.encode_chunks(c) for c in cells]), \
                None
        mesh = self.mesh(codec.device)
        if mesh is not None and hasattr(codec, "encode_crc_batch_mesh"):
            return self._mesh_encode_sync(codec, cells, mesh)
        parity, crcs = self._stage(codec.device, cells,
                                   lambda x: codec.encode_crc_batch(x, su))
        return parity.view(np.uint8), crcs.view(np.uint32)

    @staticmethod
    def _mesh_pad(batch: np.ndarray, mesh) -> np.ndarray:
        """Pad the batch axis to a multiple of the mesh's stripe axis
        (``parallel.pad_batch``; zero stripes encode/decode to zero cells
        and are sliced away by the caller). No pow2 pad: the kernels take
        any per-slot batch."""
        from ..parallel import pad_batch

        n = len(batch)
        target = pad_batch(n, mesh)
        if target == n:
            return batch
        pad = np.zeros((target - n,) + batch.shape[1:], dtype=batch.dtype)
        return np.concatenate([batch, pad])

    def _mesh_encode_sync(self, codec, cells: np.ndarray, mesh):
        """Slot-resident shard staging: ONE pad (stripe-divisible), one
        placement so batched stripes land on their owning slots, one
        fused encode+CRC over the mesh — each of the k+m shard rows'
        cells and CRCs are produced where they live, and the results come
        back as per-slot shard views with NO whole-array host gather."""
        from ..parallel import runtime

        b, k, su = cells.shape
        batch = ECBatcher._mesh_pad(rs.pack_u32(cells), mesh)
        parity_w, crcs_d = codec.encode_crc_batch_mesh(batch, su, mesh)
        parity = runtime.shard_rows_to_host(parity_w)
        crcs = runtime.shard_rows_to_host(crcs_d)
        runtime.STATS.bump(encode_stripes=b)
        if self.perf is not None:
            self.perf.inc("ec_mesh_encode_dispatches")
        return rs.unpack_u32(parity[:b]), crcs[:b]

    def _overdecomposed(self, cells: np.ndarray, run, device=None):
        """Rateless recovery over-decomposition (arXiv:1804.10331) —
        the device-tier half of straggler-proof dispatch. The batched
        recovery matmul splits along its batch axis into
        ``osd_ec_overdecompose`` x workers row blocks (rs.row_blocks);
        every block is dispatched TWICE across a bounded worker pool
        (primary + one hedge duplicate), the first copy per block to
        land wins, and stale copies are shed — so a straggling worker
        (slow stream, contended core) sheds work instead of gating the
        round. Byte-exact by construction: both copies of a block run
        the SAME kernel over the SAME rows, and the blocks partition
        the batch. Returns None when the knob is off or the batch is
        too small to split (the single dispatch). ``device`` is the
        codec's, on which the mesh that sizes the pool resolves."""
        factor = self._overdecompose_factor()
        n = len(cells)
        if factor <= 0 or n < 2:
            return None
        devs = getattr(self.mesh(device), "devices", None)
        workers = int(getattr(devs, "size", 0) or 0)
        if workers <= 0:
            workers = min(4, os.cpu_count() or 1)
        blocks = rs.row_blocks(n, factor * workers)
        if len(blocks) <= 1:
            return None
        if self.perf is not None:
            self.perf.inc("ec_overdecompose_rounds")
            self.perf.inc("ec_overdecompose_subtasks", 2 * len(blocks))
        results: list = [None] * len(blocks)
        remaining = [2] * len(blocks)
        shed = 0
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            futs = {}
            for i, (lo, hi) in enumerate(blocks):
                for _copy in range(2):
                    futs[pool.submit(run, cells[lo:hi])] = i
            pending = set(futs)
            try:
                while pending:
                    done, pending = cf.wait(
                        pending, return_when=cf.FIRST_COMPLETED)
                    for f in done:
                        i = futs[f]
                        remaining[i] -= 1
                        if results[i] is not None:
                            shed += 1  # landed after its twin won
                            continue
                        try:
                            results[i] = f.result()
                        except Exception:
                            # one copy of a block failing is survivable
                            # (its twin may land); both failing is the
                            # dispatch failure — propagate it and let
                            # _run's fail-closed isolation take over
                            if remaining[i] == 0:
                                raise
                    if all(r is not None for r in results):
                        # every pending copy is now stale: cancelled if
                        # unstarted, else drained by pool shutdown with
                        # its result discarded — shed either way
                        shed += len(pending)
                        break
            finally:
                for f in pending:
                    f.cancel()
        if self.perf is not None and shed:
            self.perf.inc("ec_overdecompose_shed", shed)
        return np.concatenate(results)

    def _cold_shape(self, key: tuple, nbytes: int, warm) -> bool:
        """True while a decode/repair survivor pattern is still cold —
        the cold-shape shield. A pattern's first device dispatch pays
        for its recovery matrix (host inversion) and, on the card, the
        kernel's B operands (built on the host, copied over); a hedged
        read that just cut an 80 ms straggler wait must not spend the
        savings on that (hedge substitution is exactly what
        manufactures novel survivor patterns at client-latency-critical
        time). A pattern stays on the host engine until its cumulative
        bytes cross osd_ec_cold_shape_bytes, and even then the
        promotion runs ``warm`` (one device dispatch) on a background
        thread first, so the first-use cost never sits on a waiting
        read: rounds keep landing host until the pattern is warm. Storm
        patterns (one erasure hit across a PG's objects) promote within
        a few stacked rounds; the one-off patterns hedging manufactures
        never do. ``warm_seconds`` keeps each warm's wall time."""
        threshold = self._cold_shape_bytes()
        if threshold <= 0:
            return False
        seen = self._shape_bytes.get(key, 0)
        if seen < threshold:
            self._shape_bytes[key] = seen + nbytes
            return True
        state = self._shape_warm.get(key)
        if state is True:
            return False
        if state is None:
            self._shape_warm[key] = False

            def _warm_kernel():
                t0 = time.perf_counter()
                try:
                    warm()
                finally:
                    self.warm_seconds[key] = time.perf_counter() - t0
                    # even a failed warm opens the device path: the
                    # real dispatch will surface the error (and the
                    # shield must not pin a pattern to the host
                    # forever on a transient)
                    self._shape_warm[key] = True
            threading.Thread(target=_warm_kernel, daemon=True,
                             name="ec-shape-warm").start()
        return True

    def _host_decode_block(self, codec, present: tuple, want: tuple,
                           kp: int, su: int):
        """Host-engine row-block dispatcher for decode, or None when
        the codec has no host hook."""
        if getattr(codec, "bytewise_linear", False):
            mat = codec.decode_matrix_for(present, want)

            def _dispatch_block(blk: np.ndarray) -> np.ndarray:
                bb = len(blk)
                flat = np.ascontiguousarray(
                    blk.transpose(1, 0, 2)).reshape(kp, bb * su)
                out = native.rs_matmul(mat, flat,
                                       threads=os.cpu_count() or 1)
                return np.ascontiguousarray(
                    out.reshape(len(want), bb, su)
                    .transpose(1, 0, 2))
            return _dispatch_block
        host = getattr(codec, "decode_cells_host", None)
        if host is None:
            return None

        def _dispatch_block(blk: np.ndarray) -> np.ndarray:
            return host(present, want, blk)
        return _dispatch_block

    def _host_repair_block(self, codec, present: tuple, want: tuple):
        """Host-engine row-block dispatcher for sub-chunk repair, or
        None when the codec has no host hook."""
        host = getattr(codec, "repair_cells_host", None)
        if host is None:
            return None

        def _dispatch_block(blk: np.ndarray) -> np.ndarray:
            return host(present, want, blk)
        return _dispatch_block

    def _decode_sync(self, codec, present: tuple, want: tuple,
                     cells: np.ndarray) -> np.ndarray:
        """(B, k', su) u8 survivors -> (B, len(want), su) u8."""
        engine = getattr(codec, "resolved_backend", lambda: "device")()
        dev = getattr(codec, "device", None)
        b, kp, su = cells.shape
        if engine == "host" or not hasattr(codec, "decode_batch"):
            _dispatch_block = self._host_decode_block(codec, present,
                                                      want, kp, su)
            if _dispatch_block is None:
                raise RuntimeError(
                    f"codec {type(codec).__name__} has no batched "
                    "decode")
        else:
            mesh = self.mesh(dev)
            mode = self._repair_mode()
            if (mesh is not None and mode != "off"
                    and hasattr(codec, "decode_batch_mesh")):
                # the collective path already distributes ONE matmul
                # across every slot with its own combine — slicing its
                # batch would serialize collectives, so it keeps its
                # own distribution and skips over-decomposition (and
                # the cold-shape shield: mesh rounds are storm-sized)
                return self._mesh_decode_sync(codec, present, want,
                                              cells, mesh, mode)

            def _dispatch_block(blk: np.ndarray) -> np.ndarray:
                (out,) = self._stage(codec.device, blk, lambda x: (
                    codec.decode_batch(present, x, want=want),))
                return out.view(np.uint8)
            if ((getattr(codec, "bytewise_linear", False)
                    or getattr(codec, "decode_cells_host", None)
                    is not None)
                    and self._cold_shape(
                        ("dec", codec_profile_key(codec), su,
                         present, want), cells.nbytes,
                        lambda blk=cells: _dispatch_block(blk))):
                shield = self._host_decode_block(codec, present, want,
                                                 kp, su)
                if self.perf is not None:
                    self.perf.inc("ec_decode_cold_host")
                out = self._overdecomposed(cells, shield, dev)
                return out if out is not None else shield(cells)
        out = self._overdecomposed(cells, _dispatch_block, dev)
        return (out if out is not None
                else _dispatch_block(cells))

    def _repair_sync(self, codec, present: tuple, want: tuple,
                     cells: np.ndarray) -> np.ndarray:
        """(B, d, su/q) u8 helper slices -> (B, 1, su) u8 rebuilt
        cells — the regenerating-code sub-chunk repair dispatch."""
        engine = getattr(codec, "resolved_backend", lambda: "device")()
        dev = getattr(codec, "device", None)
        if engine == "host" or not hasattr(codec, "repair_batch"):
            _dispatch_block = self._host_repair_block(codec, present,
                                                      want)
            if _dispatch_block is None:
                raise RuntimeError(
                    f"codec {type(codec).__name__} has no batched "
                    "sub-chunk repair")
        else:
            def _dispatch_block(blk: np.ndarray) -> np.ndarray:
                (out,) = self._stage(codec.device, blk, lambda x: (
                    codec.repair_batch(present, x, want),))
                return out.view(np.uint8)
            if (getattr(codec, "repair_cells_host", None) is not None
                    and self._cold_shape(
                        ("rep", codec_profile_key(codec),
                         cells.shape[-1], present, want), cells.nbytes,
                        lambda blk=cells: _dispatch_block(blk))):
                shield = self._host_repair_block(codec, present, want)
                if self.perf is not None:
                    self.perf.inc("ec_decode_cold_host")
                out = self._overdecomposed(cells, shield, dev)
                return out if out is not None else shield(cells)
        out = self._overdecomposed(cells, _dispatch_block, dev)
        return (out if out is not None
                else _dispatch_block(cells))

    def _mesh_decode_sync(self, codec, present: tuple, want: tuple,
                          cells: np.ndarray, mesh,
                          method: str) -> np.ndarray:
        """Collective repair: survivors staged one chunk-group per width
        slot, the stacked recovery matmul distributed across the mesh
        with partials XOR-combined by ``method`` — the messenger-fan-in-
        free decode side of the serving mesh."""
        from ..parallel import runtime

        b, kp, su = cells.shape
        batch = ECBatcher._mesh_pad(rs.pack_u32(cells), mesh)
        out = codec.decode_batch_mesh(present, batch, want, mesh, method)
        host = runtime.shard_rows_to_host(out)
        runtime.STATS.bump(decode_stripes=b)
        if self.perf is not None:
            self.perf.inc("ec_mesh_decode_dispatches")
        return rs.unpack_u32(host[:b])
