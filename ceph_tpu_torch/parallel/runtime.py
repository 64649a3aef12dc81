"""Serving-path mesh runtime: the piece that promotes the ``parallel``
layouts from dry-run validation to the OSD data path.

ceph_tpu_torch's own copy of ``ceph_tpu/parallel/runtime.py``. The
ECBatcher (cluster/ecbatch.py) talks to the mesh exclusively through this
module:

- :func:`serving_mesh` resolves the configured device mesh once per
  process, on the codec's device, and RAISES when the platform cannot
  supply the slots (too few cards and no ``pin_virtual``): the reference
  degrades to the single-device path there; the port refuses, so no
  quiet one-device run hides a mesh an operator asked for.
- :func:`mesh_encode_crc_batch` runs the fused encode+CRC on every slot:
  stripe batches are staged slot-resident (``chunk_batch`` — batch over
  ``stripe``, chunk words over ``width``), each slot runs K1 and K2 on
  its (B/s, k, W/w) block, so each slot produces the shard cells it owns
  and the seed-0 CRCs of its word segment of every cell; the width
  join (copies of the segment CRCs onto every width slot and K6's
  ``crc_join``) is the one place bytes move between slots.
- :func:`mesh_decode_cells` is collective repair: survivors resident one
  chunk-group per width slot (``shard_placement``), recovery as
  shard_comm's distributed GF matmul with partials combined by
  ``allgather`` or ``psum_bits`` — collectives where the reference fans
  recovery sub-ops over sockets.
- :func:`shard_rows_to_host` is the SANCTIONED device->host boundary: it
  materializes a sharded result by reading each slot's resident piece —
  per-slot readbacks, the thing each shard's owning OSD does to persist
  its own rows — never one whole-array gather through a single host
  buffer. ``host_gather`` (``Sharded.numpy()``) is the counted escape
  hatch; the write path proves its counter stays 0.

Each slot's kernels run on its device's current stream; a dispatch waits
for every slot's work before it releases ``_dispatch_lock``. Everything
here runs on the CPU in the tests: ``pin_virtual(8)`` and
``device="cpu"`` give an 8-slot mesh of plain versions.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve
from ..ops import crc32c as crc_ops
from ..ops import rs
from ..ops import xor_combine
from . import shard_comm
from . import (STRIPE_AXIS, WIDTH_AXIS, Shard, Sharded, chunk_batch,
               chunk_batch_spec, get_devices, make_mesh, per_stripe_spec,
               slot_index)

#: combine strategies the repair knob accepts (cluster config
#: ``parallel_repair_mode``); "off" keeps the single-device decode
REPAIR_MODES = ("off", "allgather", "psum_bits")


class MeshStats:
    """Process-wide mesh data-plane ledger (the buffer plane's STATS
    shape): dispatch counts, per-slot stripe occupancy, and the
    host-gather counter the write-path acceptance demands stay zero.
    Mutation goes through :meth:`bump` under the ledger's own lock —
    every OSD's batcher worker writes here concurrently, and a bare
    ``+=`` across threads loses increments."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.encode_dispatches = 0
            self.decode_dispatches = 0
            self.encode_stripes = 0          # real (pre-pad) stripes
            self.encode_stripes_padded = 0   # slot-resident incl. pad
            self.decode_stripes = 0          # real (pre-pad) stripes
            self.decode_stripes_padded = 0
            self.host_gathers = 0            # whole-array gathers (MUST
            #                                  be 0 on the write path)
            self.shard_reads = 0             # per-slot shard reads
            #: slot id -> stripes that slot owned across dispatches (keyed
            #: by the slot, not its torch device: a virtual mesh's slots
            #: share one)
            self.stripes_per_device: dict[int, int] = {}

    def bump(self, **deltas: int) -> None:
        with self._lock:
            for key, d in deltas.items():
                setattr(self, key, getattr(self, key) + d)

    def _occupancy(self, mesh, per_dev: int) -> None:
        with self._lock:
            for dev in mesh.devices.flat:
                d = self.stripes_per_device
                d[dev.id] = d.get(dev.id, 0) + per_dev

    def dump(self) -> dict:
        with self._lock:
            return {
                "mesh_encode_dispatches": self.encode_dispatches,
                "mesh_decode_dispatches": self.decode_dispatches,
                "mesh_encode_stripes": self.encode_stripes,
                "mesh_encode_stripes_padded": self.encode_stripes_padded,
                "mesh_decode_stripes": self.decode_stripes,
                "mesh_decode_stripes_padded": self.decode_stripes_padded,
                "mesh_host_gathers": self.host_gathers,
                "mesh_shard_reads": self.shard_reads,
                "mesh_stripes_per_device": dict(
                    sorted(self.stripes_per_device.items())),
            }


STATS = MeshStats()

_mesh_lock = threading.Lock()
_meshes: dict[tuple[int, int, str], object] = {}

#: ONE mesh dispatch in flight at a time, every slot's work finished
#: before release: the reference needs it because XLA's cross-device
#: collectives rendezvous per (executable, run) and deadlock under
#: concurrent host threads; the port keeps it so that a dispatch's copies
#: between slots never interleave with another's, and so the ledger and
#: the launch counts of one dispatch stay its own. Every OSD's batcher
#: worker funnels its sharded dispatch through this lock; single-device
#: dispatches are unaffected.
_dispatch_lock = threading.Lock()


def serving_mesh(n_devices: int, width: int = 1, device=None):
    """The (stripe, width) mesh the OSD serving path runs on, or ``None``
    when the config disables the mesh (n_devices <= 1).

    A width that does not divide the device count is a CONFIG error and
    raises. A platform that cannot supply ``n_devices`` slots on
    ``device`` (the card unless named) raises too: the port does not
    degrade to the 1-device path, and a failure is not cached, so the
    next dispatch tries again.

    Resolution is cached per (n, width, device) and shared by every OSD
    in the process — chips are a host resource, not a daemon one."""
    if n_devices <= 1 or width < 1:
        return None
    if n_devices % width:
        raise ValueError(
            f"osd_ec_mesh_width={width} does not divide "
            f"osd_ec_mesh_devices={n_devices}")
    dev = resolve(device)
    key = (int(n_devices), int(width), str(dev))
    with _mesh_lock:
        if key not in _meshes:
            _meshes[key] = make_mesh(get_devices(key[0], dev), width=key[1])
        return _meshes[key]


def reset_meshes() -> None:
    """Test hook: drop cached meshes."""
    with _mesh_lock:
        _meshes.clear()


def finish(mesh) -> None:
    """Wait for every slot's queued work (each distinct card's current
    stream); the CPU's is done when queued."""
    for dev in {str(s.device): s.device for s in mesh.devices.flat}.values():
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


# ------------------------------------------------------------- encode


def mesh_encode_crc_batch(mesh, matrix: np.ndarray, cell_bytes: int,
                          batch) -> tuple[Sharded, Sharded]:
    """(B, k, W) packed words (host uint32 or an int32 tensor), B divisible
    by the stripe axis -> (parity (B, m, W), crcs (B, k+m)) as MESH-
    SHARDED arrays: the staging copies land each (stripe, width) block on
    its owning slot, where K1 makes its parity block and K2 the seed-0
    CRCs of its word segment of every data and parity cell; each width
    slot then gathers its stripe row's segment CRCs and joins them with
    K6 (``crc_join``: segment j shifted past the 4 (W - end_j) true bytes
    after it, then the cell's seed term). Parity stays chunk_batch-sharded
    (each slot holds the rows it computed), CRCs come back per-stripe,
    whole on every width slot. Consumption goes through
    shard_rows_to_host (per-slot views), never a whole-array gather."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    b, k, w = batch.shape
    n_w = mesh.shape[WIDTH_AXIS]
    zcols = crc_ops.segment_shift_columns(w, n_w)
    seed = crc_ops.zeros_shift(crc_ops.CRC_SEED, int(cell_bytes))
    xs = chunk_batch(mesh, batch)
    slots = list(mesh.devices.flat)
    with _dispatch_lock:
        parity, crc0 = [], []
        for shard in xs.shards:
            p = rs.gf_matmul(m, shard.data)                  # K1
            parity.append(p)
            crc0.append(crc_ops.crc0_cells(shard.data, p))   # K2
        events = [shard_comm.mark(slot.device) for slot in slots]
        crcs = []
        for p, slot in enumerate(slots):
            row = mesh.position(p)[0] * n_w
            parts = shard_comm.gather(crc0[row:row + n_w], events[row:row + n_w],
                           slot.device)
            crcs.append(xor_combine.crc_join(parts, zcols, seed))  # K6
        finish(mesh)
    STATS.bump(encode_dispatches=1, encode_stripes_padded=b)
    STATS._occupancy(mesh, b // mesh.shape[STRIPE_AXIS])
    pshape, cshape = (b, m.shape[0], w), (b, k + m.shape[0])
    pspec, cspec = chunk_batch_spec(), per_stripe_spec()
    return (
        Sharded(mesh, pspec, pshape, [
            Shard(s, slot_index(mesh, pspec, pshape, p), t)
            for p, (s, t) in enumerate(zip(slots, parity))]),
        Sharded(mesh, cspec, cshape, [
            Shard(s, slot_index(mesh, cspec, cshape, p), t)
            for p, (s, t) in enumerate(zip(slots, crcs))]))


# ------------------------------------------------------------- decode


def mesh_decode_cells(mesh, rmat: np.ndarray, batch: np.ndarray,
                      method: str) -> Sharded:
    """Collective repair: (B, k', W) uint32 survivor batch times the
    (R, k') recovery matrix as shard_comm's distributed GF matmul —
    survivors resident one chunk-group per width slot, partials
    XOR-combined across the mesh by ``method`` (allgather / psum_bits).
    The chunk axis is zero-padded to the width when k' does not divide
    it (GF zero columns are inert). Returns the (B, R, W) result
    batch-sharded."""
    n_w = mesh.shape[WIDTH_AXIS]
    rmat, batch = shard_comm.pad_chunk_axis(
        np.ascontiguousarray(rmat, dtype=np.uint8), batch, n_w)
    with _dispatch_lock:
        out = shard_comm.distributed_matmul(mesh, rmat, batch, method)
        finish(mesh)
    STATS.bump(decode_dispatches=1, decode_stripes_padded=len(batch))
    return out


# ---------------------------------------------------- host boundaries


def shard_rows_to_host(arr: Sharded,
                       out: np.ndarray | None = None) -> np.ndarray:
    """SANCTIONED device->host boundary of the mesh data path: read each
    slot's RESIDENT piece and scatter it into the host staging — the
    per-slot readback each shard row's owning OSD performs to persist its
    own cells, in place of one whole-array gather through a single host
    buffer. Replicated placements (the width-replicated repair result,
    per-stripe CRCs under width > 1) deduplicate by shard index: one
    owner reads, replicas are skipped. Packed words come back uint32."""
    out = arr.read_shards(out)
    STATS.bump(shard_reads=len(arr.unique_shards()))
    return out


def host_gather(arr: Sharded) -> np.ndarray:
    """The UNSANCTIONED whole-array gather, kept only as a counted escape
    hatch: every call is a host gather the write path is not allowed to
    make (its counter must stay 0 in a write phase). It is
    ``Sharded.numpy()``, which counts it."""
    return arr.numpy()
