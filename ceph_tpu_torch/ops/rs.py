"""Reed-Solomon GF(2^8) encode/decode in PyTorch, with its CUDA kernel.

A GF(2^8) multiply by a constant coefficient c is linear over GF(2), so

    y = mul(c, x) = XOR_{b=0..7} bit_b(x) * mul(c, 1 << b)

With four bytes packed per uint32 word (SWAR), ``bit_b`` of all four bytes
is ``(x >> b) & 0x01010101`` and the per-byte multiply by the constant
byte ``mul(c, 1 << b) < 256`` is an ordinary integer multiply with no
carries between bytes: integer-only and bit-exact by construction. That is
``gf_matmul_plain``, the plain version (the JAX package's
``gf_matmul_u32``).

The same linearity makes every output bit a GF(2) inner product of the
input bits with a row of the lifted bit-matrix (``lift_bitmatrix``, the JAX
package's ``_lift_bitmatrix``). ``csrc/gf_matmul.cu`` computes those on the
binary tensor cores; ``b1_fragments`` lays the lifted matrix out as the
kernel's B operand (cached per matrix on the card).

``gf_matmul`` computes ``(..., C, W) -> (..., R, W)``: the kernel for a
CUDA tensor, the plain version for a CPU one. The device of the tensor
decides the path.

Decode = host-side inversion of the surviving-rows generator submatrix
(ops/gf8.py) + the same kernel with the recovery matrix.

Data layout: chunks are (..., k, W) int32 tensors holding uint32 words,
W = chunk_bytes / 4, little-endian byte packing (see ``device.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import words_to_tensor
from . import crc32c as crc_ops
from . import gf8


def lift_bitmatrix(matrix: np.ndarray) -> np.ndarray:
    """(R, C) GF(2^8) matrix -> (8R, 8C) GF(2) bit-matrix, uint8: column
    8c+j of block row r holds the bits of M[r, c] * x^j, so out_bit[8r+i]
    = XOR_{c, j} BM[8r+i, 8c+j] * in_bit[8c+j] (the JAX package's
    ``_lift_bitmatrix``)."""
    rows, cols = matrix.shape
    out = np.zeros((rows * 8, cols * 8), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v = int(matrix[r, c])
            for j in range(8):
                for i in range(8):
                    out[r * 8 + i, c * 8 + j] = (v >> i) & 1
                v = gf8.gf_mul(v, 2)
    return out


def b1_fragments(matrix: np.ndarray) -> np.ndarray:
    """The B operand of csrc/gf_matmul.cu for an (R, C) GF(2^8) matrix:
    (ceil(R/4), ceil(C/8), 16, 32, 2) uint32, indexed [quad q, K-step k,
    n-tile j, lane 4n+t, half h], bit b of each word.

    K: (k, h, t, b) is bit b of input word c = 8k + 4h + t (raw words, all
    four bytes). N: column n of n-tile j is output row r = 4q + (n >> 1),
    output bit 2j + (n & 1). The bit is set when input and output bits lie
    in the same byte lane p and BM[8r + i, 8c + j'] is set (i, j' the bit
    within the byte): the lifted matrix, block-diagonal over byte lanes."""
    rows, cols = matrix.shape
    quads, ksteps = -(-rows // 4), -(-cols // 8)
    bm = np.zeros((quads * 32, ksteps * 64), dtype=np.uint8)
    bm[:rows * 8, :cols * 8] = lift_bitmatrix(matrix)
    k = np.arange(ksteps).reshape(-1, 1, 1, 1, 1, 1)
    j = np.arange(16).reshape(1, -1, 1, 1, 1, 1)
    n = np.arange(8).reshape(1, 1, -1, 1, 1, 1)
    t = np.arange(4).reshape(1, 1, 1, -1, 1, 1)
    h = np.arange(2).reshape(1, 1, 1, 1, -1, 1)
    b = np.arange(32).reshape(1, 1, 1, 1, 1, -1)
    out_bit = 2 * j + (n & 1)
    c = 8 * k + 4 * h + t
    words = np.zeros((quads, ksteps, 16, 8, 4, 2), dtype=np.uint64)
    for q in range(quads):  # one quad at a time bounds the temporaries
        r = 4 * q + (n >> 1)
        bits = np.where((out_bit >> 3) == (b >> 3),
                        bm[8 * r + (out_bit & 7), 8 * c + (b & 7)], 0)
        words[q] = (bits.astype(np.uint64) << b.astype(np.uint64)).sum(
            axis=-1, dtype=np.uint64)
    return words.astype(np.uint32).reshape(quads, ksteps, 16, 32, 2)


# Sized above the erasure-pattern count for supported k+m (C(11,8)=165
# recovery matrices for k=8,m=3 before present-orderings).
@functools.lru_cache(maxsize=4096)
def _device_fragments(matrix_bytes: bytes, rows: int, cols: int,
                      device: str) -> torch.Tensor:
    # A blocking copy: the cached tensor is complete before any stream
    # (each EC batcher thread has its own) reads it.
    matrix = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(rows, cols)
    return words_to_tensor(b1_fragments(matrix), device)


def _check(matrix: np.ndarray, chunks: torch.Tensor) -> np.ndarray:
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    if matrix.ndim != 2:
        raise ValueError(f"matrix must be 2-D, got shape {matrix.shape}")
    if chunks.dtype != torch.int32:
        raise TypeError(f"chunks must be int32 packed words, got {chunks.dtype}")
    if chunks.dim() < 2 or chunks.shape[-2] != matrix.shape[1]:
        raise ValueError(f"chunks shape {tuple(chunks.shape)} does not fit "
                         f"matrix {matrix.shape}")
    return matrix


def _u32_as_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def gf_matmul_plain(matrix: np.ndarray, chunks: torch.Tensor) -> torch.Tensor:
    """The SWAR GF(2^8) product in plain torch ops, on ``chunks``' device.

    Computes in int64 (words masked to 32 bits), so no shift or product
    wraps; a matrix row of all zeros yields zero words."""
    matrix = _check(matrix, chunks)
    rows, cols = matrix.shape
    x = chunks.to(torch.int64) & 0xFFFFFFFF
    acc: list[torch.Tensor | None] = [None] * rows
    for c in range(cols):
        col = x[..., c, :]
        planes = None
        for r in range(rows):
            coeff = int(matrix[r, c])
            if coeff == 0:
                continue
            if coeff == 1:
                term = col
            else:
                if planes is None:
                    planes = [(col >> b) & 0x01010101 for b in range(8)]
                term = planes[0] * gf8.gf_mul(coeff, 1)
                for b in range(1, 8):
                    term = term ^ (planes[b] * gf8.gf_mul(coeff, 1 << b))
            acc[r] = term if acc[r] is None else acc[r] ^ term
    zeros = torch.zeros_like(x[..., 0, :])
    out = torch.stack([zeros if a is None else a for a in acc], dim=-2)
    return _u32_as_i32(out)


def gf_matmul(matrix: np.ndarray, chunks: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix x packed byte streams: matrix (R, C) uint8, chunks
    (..., C, W) int32 -> (..., R, W) int32, out[r] = XOR_c mul(M[r, c],
    chunks[c]) bytewise. The CUDA kernel for a CUDA tensor, the plain
    version for a CPU one."""
    matrix = _check(matrix, chunks)
    if chunks.device.type == "cpu":
        return gf_matmul_plain(matrix, chunks)
    if chunks.device.type != "cuda":
        raise ValueError(f"no GF matmul kernel for device {chunks.device}")
    rows, cols = matrix.shape
    lead, w = chunks.shape[:-2], chunks.shape[-1]
    frags = _device_fragments(matrix.tobytes(), rows, cols, str(chunks.device))
    out = kernels.gf_matmul(chunks.reshape(-1, cols, w).contiguous(), frags,
                            rows)
    return out.reshape(*lead, rows, w)


def encode(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Parity chunks for systematic RS: data (..., k, W) -> (..., m, W)."""
    return gf_matmul(matrix, data)


def encode_with_crcs(matrix: np.ndarray, cell_bytes: int,
                     data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode + per-cell checksum: data (..., k, W) int32 -> (parity
    (..., m, W), crcs (..., k+m)), the CRC32Cs of the data cells then the
    parity cells (the hash_info the EC backend persists per shard). The
    CRC reads data and parity where they lie: nothing is copied."""
    parity = gf_matmul(matrix, data)
    return parity, crc_ops.crc32c_cells_device(data, cell_bytes, parity)


def decode(matrix: np.ndarray, k: int, present: list[int],
           chunks: torch.Tensor) -> torch.Tensor:
    """Recover all k data chunks from any k surviving chunks.

    matrix: the m x k coding matrix. present: chunk indices (0..k-1 data,
    k..k+m-1 parity) of the surviving chunks, in the order they are
    stacked on chunks' axis -2. chunks: (..., k, W). Returns (..., k, W).
    """
    return gf_matmul(gf8.decode_matrix(matrix, k, list(present)), chunks)


def column_blocks(matrix: np.ndarray, parts: int) -> list[np.ndarray]:
    """Split an (R, C) GF matrix into ``parts`` contiguous column blocks of
    C/parts columns: block j multiplies the chunks that width slot j holds
    (the port's form of the JAX package's ``_block_bitmatrices``,
    ``parallel/shard_comm.py:57``; K1 takes each block as a GF matrix)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    c = matrix.shape[1]
    if parts < 1 or c % parts:
        raise ValueError(f"{c} chunks do not split over {parts} devices")
    cl = c // parts
    return [np.ascontiguousarray(matrix[:, d * cl:(d + 1) * cl])
            for d in range(parts)]


def row_blocks(n: int, parts: int) -> list[tuple[int, int]]:
    """Balanced contiguous partition of an ``n``-row batch axis into at
    most ``parts`` non-empty ``(lo, hi)`` blocks; sizes differ by at most
    one row."""
    parts = max(1, min(parts, n))
    base, extra = divmod(n, parts)
    blocks: list[tuple[int, int]] = []
    lo = 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        blocks.append((lo, hi))
        lo = hi
    return blocks


def pack_u32(chunks_bytes: np.ndarray) -> np.ndarray:
    """(..., L) uint8 with L % 4 == 0 -> (..., L/4) uint32 little-endian."""
    a = np.ascontiguousarray(chunks_bytes, dtype=np.uint8)
    return a.view("<u4").reshape(a.shape[:-1] + (a.shape[-1] // 4,))


def unpack_u32(words: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(words, dtype="<u4")
    return a.view(np.uint8).reshape(a.shape[:-1] + (a.shape[-1] * 4,))
