"""Typed Checksummer over data blocks (reference: src/common/Checksummer.h).

Same contracts as the reference (Checksummer.h:15-193) for crc32c /
crc32c_16 (low 16 bits) / crc32c_8 (low 8 bits) / none: computed per
csum_block over a buffer with init value -1 (Checksummer.h:203 default),
verify returning the byte offset of the first bad block and its actual
checksum (Checksummer.h:236-271 contract: -1 == clean).

The crc32c family runs on the port's batched CRC path (``ops/crc32c.py``)
on the checksummer's device: the CUDA kernel on the card, thousands of
blocks per launch, or the plain version on the CPU. xxhash32/xxhash64 run
on the port's C++ host core (``native``), one call per block, as in the
JAX package.
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
    """Per-block checksum engine for one (algorithm, block size) config,
    computing on ``device`` (the CUDA card unless the caller names
    another)."""

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
        self.device = resolve(self.device)

    def _blocks(self, data: np.ndarray, length: int) -> np.ndarray:
        if length % self.csum_block_size:
            raise ValueError(
                f"length {length} not a multiple of block size {self.csum_block_size}"
            )
        return data[:length].reshape(-1, self.csum_block_size)

    def calculate(self, data) -> np.ndarray:
        """Checksum every csum_block of ``data`` (length must be aligned).

        Returns a typed array, one value per block."""
        data = _as_u8(data)
        if self.alg == CSUM_NONE:
            return np.zeros(0, dtype=np.uint8)
        blocks = self._blocks(data, data.size)
        if self.alg == CSUM_XXHASH32:
            return np.array([native.xxhash32(b, seed=self.init_value)
                             for b in blocks], dtype=np.uint32)
        if self.alg == CSUM_XXHASH64:
            return np.array([native.xxhash64(b, seed=self.init_value)
                             for b in blocks], dtype=np.uint64)
        crcs = crc32c_ops.crc32c_batch(blocks, seed=self.init_value,
                                       device=self.device)
        if self.alg == CSUM_CRC32C_16:
            return (crcs & 0xFFFF).astype(np.uint16)
        if self.alg == CSUM_CRC32C_8:
            return (crcs & 0xFF).astype(np.uint8)
        return crcs.astype(np.uint32)

    def verify(self, data, csums: np.ndarray):
        """Recompute and compare. Returns (-1, None) when clean, else
        (byte_offset_of_first_bad_block, actual_csum) — the
        Checksummer::verify contract (Checksummer.h:236)."""
        got = self.calculate(data)
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
