"""Carry the reference's state across to the port.

This system holds no weights: its state is the coding matrix, the
stripe data and the cluster maps. ``params_from_reference`` rebuilds the
port's ``ECParams`` and checks that the matrix the reference used equals
the port's own for that technique; ``batch_to_device`` /
``batch_to_numpy`` move stripe batches of uint32 words in and out as
int32 tensors; ``crushmap_from_reference`` / ``osdmap_from_reference``
decode the reference's wire bytes of a CRUSH map or an OSDMap with the
port's decoder and refuse bytes that do not re-encode to themselves;
``sharded_from_shards`` / ``shards_of`` carry a mesh-sharded array across
as its per-device pieces (numpy, each with its index), so two meshes'
results compare shard by shard.
"""
from __future__ import annotations

import numpy as np

from .device import tensor_to_words, words_to_tensor
from .models.datapath import ECParams
from .parallel import Mesh, Shard, Sharded, slot_index, to_host, to_slot
from .placement import encoding
from .placement.crushmap import CrushMap
from .placement.osdmap import OSDMap


def params_from_reference(k: int, m: int, chunk_bytes: int, technique: str,
                          matrix: np.ndarray) -> ECParams:
    """The port's ECParams for a reference configuration; raises if the
    reference's coding matrix differs from the port's."""
    params = ECParams(k=k, m=m, chunk_bytes=chunk_bytes, technique=technique)
    given = np.asarray(matrix)
    if given.shape != params.matrix.shape or not np.array_equal(
            given.astype(np.uint8), params.matrix):
        raise ValueError(
            f"reference matrix for {technique} k={k} m={m} differs from "
            "the port's")
    return params


#: (..., W) numpy uint32 words -> int32 tensor on a device, and back.
batch_to_device = words_to_tensor
batch_to_numpy = tensor_to_words


def _carried(blob: bytes, decode, encode, what: str):
    blob = bytes(blob)
    obj, used = decode(blob)
    if used != len(blob):
        raise ValueError(f"{what}: {len(blob) - used} trailing bytes")
    again = encode(obj)
    if again != blob:
        first = next((i for i, (a, b) in enumerate(zip(blob, again))
                      if a != b), min(len(blob), len(again)))
        raise ValueError(f"{what} does not re-encode to the reference's "
                         f"bytes (first difference at byte {first})")
    return obj


def crushmap_from_reference(blob: bytes) -> CrushMap:
    """The port's CrushMap from the reference's encode_crushmap bytes;
    raises unless re-encoding gives the same bytes."""
    return _carried(blob, encoding.decode_crushmap, encoding.encode_crushmap,
                    "crush map")


def osdmap_from_reference(blob: bytes) -> OSDMap:
    """The port's OSDMap from the reference's encode_osdmap bytes; raises
    unless re-encoding gives the same bytes."""
    return _carried(blob, encoding.decode_osdmap, encoding.encode_osdmap,
                    "OSD map")


def _normal_index(index: tuple, shape: tuple) -> tuple:
    """An index as explicit (start, stop) slices: a reference shard's
    ``slice(None)`` over an unsharded axis becomes ``slice(0, n)``."""
    index = tuple(index) + (slice(None),) * (len(shape) - len(index))
    return tuple(slice(*sl.indices(n)[:2]) for sl, n in zip(index, shape))


def sharded_from_shards(mesh: Mesh, spec: tuple, shape: tuple,
                        shards: list) -> Sharded:
    """The port's ``Sharded`` form of a reference mesh-sharded array:
    ``shards`` are its per-device pieces as (index, numpy array) pairs in
    the order of the reference mesh's flat devices, which the port's
    ``mesh`` slots take up position by position. Each piece lands on its
    slot's device (uint32 words as int32 tensors); raises when a piece's
    index differs from the one the port's placement gives that slot."""
    shape = tuple(shape)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    out = []
    for p, (slot, (index, piece)) in enumerate(zip(mesh.devices.flat,
                                                  shards)):
        index = _normal_index(index, shape)
        if index != slot_index(mesh, spec, shape, p):
            raise ValueError(f"shard {p} holds {index}, the port's slot "
                             f"{slot.id} would hold "
                             f"{slot_index(mesh, spec, shape, p)}")
        out.append(Shard(slot, index, to_slot(np.asarray(piece),
                                                slot.device)))
    return Sharded(mesh, spec, shape, out)


def shards_of(arr: Sharded) -> list[tuple[tuple, np.ndarray]]:
    """The per-slot pieces of a ``Sharded`` as (index, numpy) pairs in the
    mesh's flat slot order (int32 words come back uint32), the form a
    reference array's ``addressable_shards`` give."""
    return [(sh.index, to_host(sh.data)) for sh in arr.shards]
