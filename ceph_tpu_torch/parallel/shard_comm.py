"""Device-resident EC shard communication over the mesh (the device
half of SURVEY §2.5's "Communication backend": where the reference fans
sub-ops to shard OSDs over TCP sockets, here each mesh slot HOLDS a
shard and reconstruction is a collective over the slots).

ceph_tpu_torch's own copy of ``ceph_tpu/parallel/shard_comm.py``.

Placement: chunk batches (B, k, W) with the CHUNK axis sharded over the
``width`` mesh axis — one (or k/n) erasure-code shards per slot, the
shard-to-device binding that replaces per-connection sockets. Repair of
missing shards (and parity generation) is then a distributed GF(2^8)
matrix-vector product: each slot computes its LOCAL partial (its matrix
columns times its resident chunks, on K1), and partials combine across
the width slots with XOR — GF(2^8) addition.

No collective reducer has an XOR combiner, so two strategies, each a
copy of every width slot's partial onto every width slot (on the slot's
stream, after an event recorded behind the partial: a peer copy over
NVLink between cards, a copy on the card on a virtual mesh, a memcpy on
the CPU) and a K6 combine (``ops/xor_combine.py``):

- ``allgather``: copy the partials, ``xor_fold`` them. Traffic per slot
  O(n_dev * B * W) — right for the small shard groups real pools use
  (k+m <= ~20 over a few devices).
- ``psum_bits``: expand each partial into 32 one-bit planes
  (``bit_planes``), copy the planes, take the parity of their sum and
  repack (``plane_parity_pack``). The reference's psum makes this
  traffic independent of the device count; done with copies it is not
  (the port has no reduce-scatter), but the result is the same.

Both are bit-exact vs the host oracle; tests pin them against each other,
the single-device kernel and the JAX package's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import gf8, rs
from ..ops import xor_combine
from . import (STRIPE_AXIS, WIDTH_AXIS, Mesh, Shard, Sharded,
               shard_placement, shard_placement_spec, slot_index)

METHODS = ("allgather", "psum_bits")


@functools.lru_cache(maxsize=4096)  # sized like rs._device_fragments
def _plan(mesh: Mesh, matrix_bytes: bytes, rows: int,
          cols: int) -> tuple[np.ndarray, ...]:
    """One plan per (mesh, matrix) — the erasure-pattern-keyed cache the
    single-device decode path gets from rs._device_fragments: the
    matrix's column block of each width slot, with K1's B operands built
    on every slot's card that multiplies by it (both methods share it)."""
    matrix = np.frombuffer(matrix_bytes, np.uint8).reshape(rows, cols)
    blocks = tuple(rs.column_blocks(matrix, mesh.shape[WIDTH_AXIS]))
    for p, slot in enumerate(mesh.devices.flat):
        if slot.device.type == "cuda":
            block = blocks[mesh.position(p)[1]]
            rs._device_fragments(block.tobytes(), rows, block.shape[1],
                                 str(slot.device))
    return blocks


def mark(device: torch.device):
    """An event behind the work queued so far on ``device``'s current
    stream (None on the CPU, where work is done when queued)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def gather(parts: list[torch.Tensor], events: list,
           device: torch.device) -> torch.Tensor:
    """(n, *shape) on ``device``: a copy of each of ``parts`` (alike in
    shape and type, one per slot), each copy queued on ``device``'s
    stream after its source's event. A copy is made even where the
    source shares the device, so no slot aliases another's tensor."""
    out = torch.empty((len(parts),) + tuple(parts[0].shape),
                      dtype=parts[0].dtype, device=device)
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for ev in events:
            if ev is not None:
                stream.wait_event(ev)
    for r, t in enumerate(parts):
        out[r].copy_(t, non_blocking=True)
    return out


def _combine(mesh: Mesh, partials: list[torch.Tensor],
             method: str) -> list[torch.Tensor]:
    """Every slot's partial -> every slot's XOR of its width row's
    partials (its stripe row's whole product)."""
    n_w = mesh.shape[WIDTH_AXIS]
    slots = list(mesh.devices.flat)
    if method == "psum_bits":
        staged = [xor_combine.bit_planes(part) for part in partials]
    else:
        staged = partials
    del partials  # the caller keeps none: on one card the planes replace them
    events = [mark(slot.device) for slot in slots]
    out = []
    for p, slot in enumerate(slots):
        row = mesh.position(p)[0] * n_w
        parts = gather(staged[row:row + n_w], events[row:row + n_w],
                       slot.device)
        if method == "psum_bits":
            out.append(xor_combine.plane_parity_pack(parts))
        else:
            out.append(xor_combine.xor_fold(parts))
        del parts  # a virtual mesh frees each slot's gather in turn
    return out


def pad_chunk_axis(matrix: np.ndarray,
                   chunks: np.ndarray,
                   n_dev: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad the survivor/chunk axis so it splits evenly over the
    width slots: zero matrix COLUMNS multiply zero chunk ROWS, and a GF
    zero column contributes nothing to any output — the padded product
    is bit-identical to the unpadded one. This is what lets collective
    repair serve any k' (e.g. k'=3 survivors over width=2, or a k+m that
    is not a multiple of the mesh width)."""
    c = matrix.shape[1]
    pad = (-c) % n_dev
    if not pad:
        return matrix, chunks
    m = np.concatenate(
        [matrix, np.zeros((matrix.shape[0], pad), dtype=np.uint8)],
        axis=1)
    z = np.zeros(chunks.shape[:-2] + (pad, chunks.shape[-1]),
                 dtype=chunks.dtype)
    return m, np.concatenate([chunks, z], axis=-2)


def distributed_matmul(mesh: Mesh, matrix: np.ndarray, chunks,
                       method: str = "allgather") -> Sharded:
    """Public serving-path entry: (B, C, W) packed words — a ``Sharded``
    already laid out shard_placement over ``mesh``, or a host array
    (uint32) or tensor (int32) to be placed that way — times an (R, C)
    GF matrix, partials combined across the width axis by ``method``.
    Returns (B, R, W) batch-sharded, whole on every width slot. The chunk
    axis must already divide the mesh width (pad_chunk_axis)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if m.shape[1] % mesh.shape[WIDTH_AXIS]:
        raise ValueError(
            f"{m.shape[1]} chunks do not split over "
            f"{mesh.shape[WIDTH_AXIS]} devices")
    if not isinstance(chunks, Sharded):
        chunks = shard_placement(mesh, chunks)
    if chunks.spec != shard_placement_spec() or chunks.mesh != mesh:
        raise ValueError("chunks must lie shard_placement on this mesh")
    blocks = _plan(mesh, m.tobytes(), m.shape[0], m.shape[1])
    combined = _combine(mesh, [  # K1 on each slot's resident shards
        rs.gf_matmul(blocks[mesh.position(p)[1]], shard.data)
        for p, shard in enumerate(chunks.shards)], method)
    b, _, w = chunks.shape
    spec = (STRIPE_AXIS, None, None)
    shape = (b, m.shape[0], w)
    return Sharded(mesh, spec, shape, [
        Shard(shard.slot, slot_index(mesh, spec, shape, p), out)
        for p, (shard, out) in enumerate(zip(chunks.shards, combined))])


def distributed_repair(mesh: Mesh, matrix: np.ndarray, k: int,
                       present: list[int], chunks,
                       method: str = "allgather") -> Sharded:
    """Reconstruct all k data chunks from survivors resident across the
    mesh (ECBackend.cc:2405's cross-OSD reconstruct, as collectives
    instead of sub-op sockets).

    matrix: (m, k) coding matrix (host). present: survivor chunk ids in
    the order they are stacked on chunks' axis 1. chunks: (B, k, W)
    words laid out shard_placement (or to be placed so). Returns (B, k,
    W) data, batch-sharded, whole on every width slot.
    """
    rmat = gf8.decode_matrix(matrix, k, list(present))
    return distributed_matmul(mesh, rmat, chunks, method)


def distributed_encode(mesh: Mesh, matrix: np.ndarray, data,
                       method: str = "allgather") -> Sharded:
    """Parity for data shards resident across the width axis: each slot
    contributes its columns' partial parity. Returns (B, m, W) whole on
    every width slot (each shard-holder persists its row). The reference's
    name for ``distributed_matmul`` with the coding matrix; only the twin
    tests call it (the mesh's write path is runtime.mesh_encode_crc_batch)."""
    return distributed_matmul(mesh, matrix, data, method)
