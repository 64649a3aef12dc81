"""Device-mesh layouts for the data path, on the port's torch devices.

ceph_tpu_torch's own copy of ``ceph_tpu/parallel/__init__.py``. The
reference scales with processes and sockets (AsyncMessenger fan-out of
sub-ops to shard OSDs, SURVEY.md §2.5); this data plane scales with a
device mesh. Two mesh axes cover the storage analogs of dp/sp:

- ``stripe`` — the stripe-batch axis (hash-sharding analog: many objects'
  stripes processed as one batch, one shard of the batch per slot).
- ``width`` — the intra-chunk byte axis (striping / sequence-parallel
  analog: one chunk's words split across slots, the way
  Striper::file_to_extents RAID-0s a byte range, osdc/Striper.h:28).

The EC shard axis (k+m chunks) stays *unsharded* on purpose: coding
chunks are linear combinations of all k data chunks, so sharding it would
force a gather per parity row; keeping it local makes encode purely
elementwise over (stripe, width) — the layout that moves bytes between
slots only where reductions genuinely need it (CRC joins, scrub digests,
collective repair).

The reference runs on a ``jax.sharding.Mesh`` and lets XLA place arrays
and insert collectives. The port has no such compiler, so this module
spells the pieces out:

- A ``Mesh`` is a (stripe, width) array of **slots**. A slot has its own
  ``id`` and a torch ``device``. Over n cards each slot is a card; on a
  *virtual* mesh several slots share one device (one card, or the CPU in
  the tests), each with its own tensors, so the mesh moves the bytes a
  real one moves. One controller (this process) dispatches to every slot,
  as JAX's single-controller mesh does.
- A placement cuts a host array or a tensor into one tensor per slot, each
  with its index (a tuple of slices into the whole): ``chunk_batch``
  (batch over stripe, chunk words over width), ``per_stripe``,
  ``replicated`` and ``shard_placement`` (chunks over width). The result
  is a ``Sharded``; ``Sharded.numpy`` puts the pieces back together.
- A virtual mesh exists only after ``pin_virtual(n)`` (the counterpart of
  the reference's ``pin_virtual_cpu``): ``get_devices`` hands out n
  distinct cards when the machine has them, else n slots of one device if
  the process pinned that many, and raises otherwise.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve

STRIPE_AXIS = "stripe"
WIDTH_AXIS = "width"

_pin_lock = threading.Lock()
_virtual_slots = 0


@dataclass(frozen=True)
class Slot:
    """One mesh position: its id (unique in the mesh) and its device."""

    id: int
    device: torch.device


def pin_virtual(n: int) -> None:
    """Allow this process a virtual mesh of up to ``n`` slots on one
    device. Process-wide and only ever raised; the tests, chip_smoke.py,
    the thrash runner's ``--chip-loss`` and the multi-chip dry run call
    it, nothing else does."""
    global _virtual_slots
    with _pin_lock:
        _virtual_slots = max(_virtual_slots, int(n))


def virtual_slots() -> int:
    """The most slots a virtual mesh of this process may have."""
    return _virtual_slots


def get_devices(n: int, device: torch.device | str | None = None
                ) -> list[Slot]:
    """n slots for a mesh: n distinct cards when ``device`` is CUDA and
    the machine has them (from ``device``'s index on), else n slots of
    ``device`` when the process pinned a virtual mesh that large. Raises
    otherwise: nothing here drops to fewer devices."""
    dev = resolve(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    first = dev.index or 0
    if cards - first >= n:
        return [Slot(i, torch.device("cuda", first + i)) for i in range(n)]
    if _virtual_slots >= n:
        return [Slot(i, dev) for i in range(n)]
    raise RuntimeError(
        f"need {n} devices; have {max(0, cards - first)} cards from {dev} "
        f"and a virtual mesh of {_virtual_slots} slots (pin_virtual)")


class Mesh:
    """A (stripe, width) array of slots. ``shape`` maps each axis to its
    size, ``devices`` is the numpy object array of slots."""

    axis_names = (STRIPE_AXIS, WIDTH_AXIS)

    def __init__(self, devices: np.ndarray) -> None:
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D slot array, got "
                             f"shape {devices.shape}")
        ids = [s.id for s in devices.flat]
        if len(set(ids)) != len(ids):
            raise ValueError(f"slot ids {ids} repeat")
        self.devices = devices
        self.shape = {STRIPE_AXIS: devices.shape[0],
                      WIDTH_AXIS: devices.shape[1]}
        self._key = (tuple(devices.flat), devices.shape)

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def virtual(self) -> bool:
        """True when slots share a device."""
        devs = [str(s.device) for s in self.devices.flat]
        return len(set(devs)) < len(devs)

    def position(self, p: int) -> tuple[int, int]:
        """(stripe, width) coordinates of the p-th slot in flat order."""
        return divmod(p, self.shape[WIDTH_AXIS])

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{sorted({str(s.device) for s in self.devices.flat})})")


def make_mesh(devices=None, width: int = 1) -> Mesh:
    """2D mesh over the given slots (every card when None): (stripe,
    width). width divides the slot count; the remainder goes to the
    stripe axis. width=1 (default) is the pure batch-parallel layout."""
    if devices is None:
        devices = [Slot(i, torch.device("cuda", i))
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one slot")
    if n % width:
        raise ValueError(f"width={width} does not divide device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(n // width, width))


# ------------------------------------------------------------ placements


def chunk_batch_spec() -> tuple:
    """(B, k, W) chunk batches: batch over stripe, chunk axis
    replicated, words over width."""
    return (STRIPE_AXIS, None, WIDTH_AXIS)


def per_stripe_spec() -> tuple:
    """Per-stripe scalars/ids: (B, ...) over stripe."""
    return (STRIPE_AXIS,)


def replicated_spec() -> tuple:
    return ()


def shard_placement_spec() -> tuple:
    """(B, k, W) with erasure-code shards resident one (group) per slot
    along the width axis (batch still over stripe)."""
    return (STRIPE_AXIS, WIDTH_AXIS, None)


@dataclass
class Shard:
    """One slot's piece of a sharded array: ``data`` on the slot's
    device, ``index`` the slices of the whole it holds."""

    slot: Slot
    index: tuple
    data: torch.Tensor


def _key(index: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in index)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A slot's tensor on the host; int32 packed words come back as
    uint32 (the port's numpy convention, device.py)."""
    a = t.detach().cpu().contiguous().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


class Sharded:
    """An array laid out over a mesh: one ``Shard`` per slot, in the
    mesh's flat slot order (the port's ``addressable_shards``)."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple,
                 shards: list[Shard]) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].data.dtype

    def unique_shards(self) -> list[Shard]:
        """One shard per distinct index (replicas skipped)."""
        seen, out = set(), []
        for shard in self.shards:
            key = _key(shard.index)
            if key not in seen:
                seen.add(key)
                out.append(shard)
        return out

    def numpy(self, out: np.ndarray | None = None) -> np.ndarray:
        """The whole array on the host in one buffer: a host gather,
        counted in ``runtime.STATS.host_gathers``. The serving path reads
        its results with ``runtime.shard_rows_to_host`` instead."""
        from . import runtime

        runtime.STATS.bump(host_gathers=1)
        return self.read_shards(out)

    def read_shards(self, out: np.ndarray | None = None) -> np.ndarray:
        """Each distinct shard read once from its slot into ``out`` (a new
        host array when None); counts nothing."""
        shards = self.unique_shards()
        if out is None:
            first = to_host(shards[0].data)
            out = np.empty(self.shape, first.dtype)
            out[shards[0].index] = first
            shards = shards[1:]
        for shard in shards:
            out[shard.index] = to_host(shard.data)
        return out


def slot_index(mesh: Mesh, spec: tuple, shape: tuple, p: int) -> tuple:
    """The slices of an array of ``shape`` that slot p holds under
    ``spec``. Raises when a sharded axis does not split evenly."""
    pos = dict(zip(Mesh.axis_names, mesh.position(p)))
    index = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            index.append(slice(0, n))
            continue
        parts = mesh.shape[axis]
        if n % parts:
            raise ValueError(f"axis {d} of length {n} does not split over "
                             f"{parts} {axis} slots")
        step = n // parts
        index.append(slice(pos[axis] * step, (pos[axis] + 1) * step))
    return tuple(index)


def to_slot(part, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``part`` (numpy or tensor) on ``device``; numpy
    uint32 words become int32 tensors with the same bits."""
    if isinstance(part, np.ndarray):
        a = np.array(part, copy=True, order="C")
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)
    return torch.empty(part.shape, dtype=part.dtype,
                       device=device).copy_(part)


def place(mesh: Mesh, x, spec: tuple) -> Sharded:
    """Cut ``x`` (numpy or tensor) over the mesh under ``spec``: each slot
    gets a copy of its piece on its own device (the port's device_put)."""
    shape = tuple(x.shape)
    shards = []
    for p, slot in enumerate(mesh.devices.flat):
        index = slot_index(mesh, spec, shape, p)
        shards.append(Shard(slot, index, to_slot(x[index], slot.device)))
    return Sharded(mesh, spec, shape, shards)


def chunk_batch(mesh: Mesh, x) -> Sharded:
    return place(mesh, x, chunk_batch_spec())


def per_stripe(mesh: Mesh, x) -> Sharded:
    return place(mesh, x, per_stripe_spec())


def replicated(mesh: Mesh, x) -> Sharded:
    return place(mesh, x, replicated_spec())


def shard_placement(mesh: Mesh, x) -> Sharded:
    return place(mesh, x, shard_placement_spec())


# ------------------------------------------------------------- padding


def pad_batch(n: int, mesh: Mesh) -> int:
    """Smallest batch >= n divisible by the stripe-axis size."""
    s = mesh.shape[STRIPE_AXIS]
    return math.ceil(n / s) * s


def pad_batch_pow2(n: int, mesh: Mesh | None = None) -> int:
    """The reference's ONE pad decision for its batched data path: the
    smallest batch >= n that satisfies BOTH the jit shape-bucketing cap
    and, when a mesh is given, divisibility by the stripe-axis size
    (stripe_size * next_pow2(ceil(n / stripe))). Without a mesh this is
    the plain next power of two. The port's batcher does not call it:
    its kernels take any batch, so it pads with ``pad_batch`` alone. Kept
    for the reference's API; only the twin tests call it."""
    if mesh is None:
        return 1 << max(0, (n - 1)).bit_length()
    s = mesh.shape[STRIPE_AXIS]
    per_dev = math.ceil(n / s)
    return s * (1 << max(0, (per_dev - 1)).bit_length())
