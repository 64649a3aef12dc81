"""Typed Checksummer over data blocks (reference: src/common/Checksummer.h).

Same contracts as the reference (Checksummer.h:15-193) for crc32c /
crc32c_16 (low 16 bits) / crc32c_8 (low 8 bits) / none: computed per
csum_block over a buffer with init value -1 (Checksummer.h:203 default),
verify returning the byte offset of the first bad block and its actual
checksum (Checksummer.h:236-271 contract: -1 == clean).

Two engines for the crc32c family, picked per call as in the JAX
package (``calculate(data, device=False)``):
- host (the default): the port's C++ core (``native.crc32c_batch``,
  SSE4.2 where the host has it);
- device (``device=True``): the batched CRC path (``ops/crc32c.py``) on
  the Checksummer's ``device``, the CUDA kernel on the card (thousands of
  blocks per launch) or the plain version on the CPU. That device is
  resolved at the first ``device=True`` call, so a host-only Checksummer
  needs no card; with no device named and no card, that call raises.

xxhash32/xxhash64 run on the C++ core, one call per block, on either
engine, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..ops import crc32c as crc32c_ops

CSUM_NONE = "none"
CSUM_XXHASH32 = "xxhash32"
CSUM_XXHASH64 = "xxhash64"
CSUM_CRC32C = "crc32c"
CSUM_CRC32C_16 = "crc32c_16"
CSUM_CRC32C_8 = "crc32c_8"

_VALUE_DTYPE = {
    CSUM_NONE: None,
    CSUM_XXHASH32: np.uint32,
    CSUM_XXHASH64: np.uint64,
    CSUM_CRC32C: np.uint32,
    CSUM_CRC32C_16: np.uint16,
    CSUM_CRC32C_8: np.uint8,
}

ALGORITHMS = tuple(_VALUE_DTYPE)


def csum_value_size(alg: str) -> int:
    """Bytes per checksum value (Checksummer.h:64-74)."""
    dt = _VALUE_DTYPE[alg]
    return 0 if dt is None else np.dtype(dt).itemsize


def _check_alg(alg: str) -> None:
    if alg not in _VALUE_DTYPE:
        raise ValueError(f"unknown csum algorithm {alg!r}; know {ALGORITHMS}")


@dataclass
class Checksummer:
    """Per-block checksum engine for one (algorithm, block size) config.
    ``device`` is where ``device=True`` calls compute (the CUDA card
    unless the caller names another), resolved at the first such call."""

    alg: str = CSUM_CRC32C
    csum_block_size: int = 4096
    # Reference default is -1 of the per-alg init_value_t (Checksummer.h:203):
    # 2^64-1 for xxhash64 (uint64_t), 2^32-1 for everything else.
    init_value: int | None = None
    device: torch.device | str | None = None

    def __post_init__(self):
        _check_alg(self.alg)
        if self.init_value is None:
            self.init_value = (
                (1 << 64) - 1 if self.alg == CSUM_XXHASH64 else 0xFFFFFFFF
            )
        bs = self.csum_block_size
        if bs <= 0 or bs & (bs - 1):
            raise ValueError(f"csum_block_size must be a power of two, got {bs}")

    def torch_device(self) -> torch.device:
        """The device of ``device=True`` calls, resolved once (raises with
        no device named and no card)."""
        if not isinstance(self.device, torch.device):
            self.device = resolve(self.device)
        return self.device

    def _blocks(self, data: np.ndarray, length: int) -> np.ndarray:
        if length % self.csum_block_size:
            raise ValueError(
                f"length {length} not a multiple of block size {self.csum_block_size}"
            )
        return data[:length].reshape(-1, self.csum_block_size)

    def calculate(self, data, device: bool = False) -> np.ndarray:
        """Checksum every csum_block of ``data`` (length must be aligned).

        Returns a typed array, one value per block. device=True routes the
        crc32c family through the batched CRC path on ``torch_device()``.
        """
        data = _as_u8(data)
        if self.alg == CSUM_NONE:
            return np.zeros(0, dtype=np.uint8)
        blocks = self._blocks(data, data.size)
        seed = self.init_value
        if self.alg in (CSUM_CRC32C, CSUM_CRC32C_16, CSUM_CRC32C_8):
            if device:
                crcs = crc32c_ops.crc32c_batch(blocks, seed=seed,
                                               device=self.torch_device())
            else:
                crcs = native.crc32c_batch(blocks, seed=seed)
            if self.alg == CSUM_CRC32C_16:
                return (crcs & 0xFFFF).astype(np.uint16)
            if self.alg == CSUM_CRC32C_8:
                return (crcs & 0xFF).astype(np.uint8)
            return crcs.astype(np.uint32)
        if self.alg == CSUM_XXHASH32:
            return np.array([native.xxhash32(b, seed=seed) for b in blocks],
                            dtype=np.uint32)
        return np.array([native.xxhash64(b, seed=seed) for b in blocks],
                        dtype=np.uint64)

    def verify(self, data, csums: np.ndarray, device: bool = False):
        """Recompute and compare. Returns (-1, None) when clean, else
        (byte_offset_of_first_bad_block, actual_csum) — the
        Checksummer::verify contract (Checksummer.h:236)."""
        got = self.calculate(data, device=device)
        want = np.asarray(csums)
        if got.shape != want.shape:
            raise ValueError(f"csum count mismatch: {got.shape} vs {want.shape}")
        bad = np.nonzero(got != want)[0]
        if bad.size == 0:
            return -1, None
        first = int(bad[0])
        return first * self.csum_block_size, got[first]


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
