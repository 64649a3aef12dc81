"""Carry the reference's state across to the port.

This system holds no weights: its state is the coding matrix, the
stripe data and the cluster maps. ``params_from_reference`` rebuilds the
port's ``ECParams`` and checks that the matrix the reference used equals
the port's own for that technique; ``batch_to_device`` /
``batch_to_numpy`` move stripe batches of uint32 words in and out as
int32 tensors; ``crushmap_from_reference`` / ``osdmap_from_reference``
decode the reference's wire bytes of a CRUSH map or an OSDMap with the
port's decoder and refuse bytes that do not re-encode to themselves.
"""
from __future__ import annotations

import numpy as np

from .device import tensor_to_words, words_to_tensor
from .models.datapath import ECParams
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
