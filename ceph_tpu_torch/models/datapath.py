"""The flagship pipeline: batched EC write / repair steps on the card.

One "step" is what the EC backend ships to the device per stripe batch
(reference write path: ECBackend::submit_transaction → ECUtil::encode →
jerasure/ISA-L, then per-chunk CRCs into the shard hinfo; read-repair path:
ECUtil::decode). Over a (B, k, W) stripe batch of packed words:

    write_step:  data (B, k, W) -> parity (B, m, W), crcs (B, k+m)
    repair_step: surviving (B, k, W) -> data (B, k, W), crcs (B, k)

Each step is one launch of the GF(2^8) kernel and one of the CRC32C kernel
on the card (``ops/rs.py``, ``ops/crc32c.py``); on a CPU tensor both run
their plain versions.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve, words_to_tensor
from ..ops import crc32c as crc_ops
from ..ops import gf8, rs


@dataclass(frozen=True)
class ECParams:
    k: int = 8
    m: int = 3
    chunk_bytes: int = 512 * 1024  # 4 MiB stripe / k=8
    technique: str = "reed_sol_van"

    @property
    def words(self) -> int:
        return self.chunk_bytes // 4

    @functools.cached_property
    def matrix(self) -> np.ndarray:
        if self.technique == "reed_sol_van":
            return gf8.vandermonde_rs_matrix(self.k, self.m)
        if self.technique == "cauchy":
            return gf8.cauchy_rs_matrix(self.k, self.m)
        raise ValueError(f"unknown technique {self.technique!r}")


def write_step(params: ECParams, data: torch.Tensor):
    """data (B, k, W) int32 -> (parity (B, m, W), crcs (B, k+m) int32).

    crcs cover data chunks then parity chunks, the per-shard hash_info
    the EC backend persists next to each shard.
    """
    return rs.encode_with_crcs(params.matrix, params.chunk_bytes, data)


@functools.lru_cache(maxsize=1024)
def _recovery_matrix(params: ECParams, present: tuple[int, ...]) -> np.ndarray:
    """The k x k recovery matrix of one erasure pattern, inverted on the
    host once per (params, present) rather than on every step."""
    rmat = gf8.decode_matrix(params.matrix, params.k, list(present))
    rmat.setflags(write=False)
    return rmat


def repair_step(params: ECParams, present: tuple[int, ...],
                surviving: torch.Tensor):
    """surviving (B, k, W) int32 (rows in ``present`` order) -> (data
    (B, k, W), crcs (B, k)). The decode matrix is built on the host from
    the erasure pattern (tiny k x k inversion, cached per pattern); the
    bulk math is the same kernel as encode."""
    data = rs.gf_matmul(_recovery_matrix(params, tuple(present)), surviving)
    return data, crc_ops.crc32c_cells_device(data, params.chunk_bytes)


def example_batch(params: ECParams, batch: int = 4, seed: int = 0,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """The JAX package's example batch (same numpy seed, same words) as an
    int32 tensor on ``device``."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**32, (batch, params.k, params.words), dtype=np.uint32)
    return words_to_tensor(raw, resolve(device))
