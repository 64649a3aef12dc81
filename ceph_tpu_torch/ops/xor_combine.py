"""XOR combines of the multi-device data plane, with their CUDA kernel (K6).

GF(2^8) addition is XOR, and no collective reducer has it. The JAX
package's mesh code (``ceph_tpu/parallel/shard_comm.py``) combines the
partial products of the width slots with XOR inside ``shard_map``, and
its CRC tree joins a cell's width segments across devices. The port
gathers with copies and combines with these four functions:

- ``xor_fold``: parts (n, ...) -> (...), the XOR of the n partials
  (``allgather``'s fold, shard_comm.py:88-91; the scrub digest).
- ``bit_planes``: x (...) -> (32, ...) uint8, bit b of every word as a
  0/1 plane (``psum_bits``' planes, :95-96; one byte an element where the
  reference has int32: only a plane sum's parity is read).
- ``plane_parity_pack``: planes (n, 32, ...) -> (...), bit b = (sum over
  the n stacks) & 1, repacked (:98-100).
- ``crc_join``: parts (w, M) seed-0 CRCs of a cell's w segments, zcols
  (w, 32) the columns of each segment's shift operator, a seed term ->
  (M,) CRCs (the cross-width levels of ``crc32c.py:158``'s tree).

Each takes int32 packed words (``device.py``) and runs
``csrc/xor_combine.cu`` for a CUDA tensor, its plain torch version (the
``*_plain`` function beside it) for a CPU one. The device of the tensor
decides the path; a CUDA tensor never takes the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import i32
from . import crc32c as crc_ops
from .rs import _u32_as_i32


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return False


def _words(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32 packed words, got {t.dtype}")


# ---------------------------------------------------------------- xor_fold


def xor_fold_plain(parts: torch.Tensor) -> torch.Tensor:
    """parts (n, ...) int32 -> (...), XOR over axis 0, in torch ops."""
    _words(parts, "parts")
    out = parts[0].clone()
    for j in range(1, parts.shape[0]):
        out ^= parts[j]
    return out


def xor_fold(parts: torch.Tensor) -> torch.Tensor:
    """XOR of the n partials along axis 0: (n, ...) int32 -> (...)."""
    _words(parts, "parts")
    if parts.dim() < 1 or parts.shape[0] < 1:
        raise ValueError(f"parts {tuple(parts.shape)} hold no partial")
    if not _route(parts, "xor_fold"):
        return xor_fold_plain(parts)
    lead = parts.shape[1:]
    out = kernels.xor_fold(parts.reshape(parts.shape[0], -1).contiguous())
    return out.reshape(lead)


# -------------------------------------------------------------- bit planes

def bit_planes_plain(x: torch.Tensor) -> torch.Tensor:
    """x (...) int32 -> (32, ...) uint8, plane b = (x >> b) & 1 (bit b
    alone survives the mask, so the arithmetic shift of int32 is safe)."""
    _words(x, "x")
    out = torch.empty((32,) + tuple(x.shape), dtype=torch.uint8,
                      device=x.device)
    for b in range(32):
        out[b] = ((x >> b) & 1).to(torch.uint8)
    return out


def bit_planes(x: torch.Tensor) -> torch.Tensor:
    """The 32 one-bit planes of the words of ``x``: (...) int32 ->
    (32, ...) uint8."""
    _words(x, "x")
    if not _route(x, "bit_planes"):
        return bit_planes_plain(x)
    return kernels.bit_planes(x.reshape(-1).contiguous()).reshape(
        (32,) + tuple(x.shape))


def plane_parity_pack_plain(planes: torch.Tensor) -> torch.Tensor:
    """planes (n, 32, ...) uint8 -> (...) int32: sum the n stacks, keep
    bit b = sum & 1, pack (the reference's psum, ``& 1`` and shift-sum).
    The parity of a sum is the XOR of the addends' low bits, which is how
    it is taken here: no temporary wider than the planes."""
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be uint8, got {planes.dtype}")
    par = planes[0] & 1
    for j in range(1, planes.shape[0]):
        par = par ^ (planes[j] & 1)
    out = torch.zeros(par.shape[1:], dtype=torch.int64, device=planes.device)
    for b in range(32):
        out |= par[b].to(torch.int64) << b
    return _u32_as_i32(out)


def plane_parity_pack(planes: torch.Tensor) -> torch.Tensor:
    """Parity of n summed plane stacks, repacked into words: (n, 32, ...)
    uint8 -> (...) int32."""
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be uint8, got {planes.dtype}")
    if planes.dim() < 2 or planes.shape[0] < 1 or planes.shape[1] != 32:
        raise ValueError(f"planes {tuple(planes.shape)} are not (n, 32, ...)")
    if not _route(planes, "plane_parity_pack"):
        return plane_parity_pack_plain(planes)
    lead = planes.shape[2:]
    out = kernels.plane_parity_pack(
        planes.reshape(planes.shape[0], 32, -1).contiguous())
    return out.reshape(lead)


# ---------------------------------------------------------------- crc_join


def crc_join_plain(parts: torch.Tensor, zcols: np.ndarray,
                   seed_term: int) -> torch.Tensor:
    """parts (w, ...) int32 seed-0 segment CRCs, zcols (w, 32) uint32 ->
    (...) int32: seed_term ^ XOR_j Z_j(parts[j]), in torch ops."""
    _words(parts, "parts")
    zcols = np.asarray(zcols, dtype=np.uint32)
    out = torch.full_like(parts[0], i32(seed_term))
    for j in range(parts.shape[0]):
        out ^= crc_ops._apply_cols(zcols[j], parts[j])
    return out


def crc_join(parts: torch.Tensor, zcols: np.ndarray,
             seed_term: int) -> torch.Tensor:
    """CRC32Cs of cells cut into w segments: parts (w, ...) int32 holds
    each segment's seed-0 CRC, zcols (w, 32) uint32 each segment's shift
    operator past the bytes after it (``crc32c.segment_shift_columns``),
    seed_term the cells' seed contribution. -> (...) int32."""
    _words(parts, "parts")
    zcols = np.ascontiguousarray(zcols, dtype=np.uint32)
    if parts.dim() < 1 or zcols.shape != (parts.shape[0], 32):
        raise ValueError(f"parts {tuple(parts.shape)} and zcols "
                         f"{zcols.shape} do not pair up")
    if not _route(parts, "crc_join"):
        return crc_join_plain(parts, zcols, seed_term)
    lead = parts.shape[1:]
    dz = crc_ops.device_columns(zcols, str(parts.device))
    out = kernels.crc_join(parts.reshape(parts.shape[0], -1).contiguous(),
                           dz, seed_term)
    return out.reshape(lead)
