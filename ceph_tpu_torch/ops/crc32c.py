"""Batched CRC32C (Castagnoli) in PyTorch, with its CUDA kernel.

The host algebra is the port's own copy of ``ceph_tpu/ops/crc32c.py``:
CRC is linear over GF(2), so

- the contribution of one little-endian uint32 word processed from state 0
  is ``c0(w) = XOR_{b set in w} A_b`` with 32 constant columns A_b;
- CRCs of adjacent segments combine as ``crc(L||R) = Z_{|R|}(crc(L)) ^
  crc(R)``, where Z_n (append n zero bytes) is a constant 32x32 GF(2)
  matrix.

``crc0_words`` is the seed-0 CRC of each blob, ``crc0_cells`` that of the
cells of two batches (data and parity) read where they lie. On a CUDA
tensor they launch ``csrc/crc32c.cu``: segment CRCs as one GF(2) product
on the binary tensor cores, with the B operand ``b1_fragments`` built
here, joined by Z operators. On a CPU tensor they run the plain torch
version of the JAX tree fold (``crc0_words_plain``): per-word columns,
then a log2(W)-level pairwise tree. Both treat a word count that does not
fill their cut as front-padded with zero words (leading zeros are no-ops
from state 0).

Seeds fold in on the host: crc(seed, blob) = Z_len(seed) ^ crc0(blob), with
``len`` the TRUE byte length of the blob, never the padded one.

Packed words travel as int32 tensors holding the uint32 bit pattern
(``device.py``); the plain version masks after every right shift, since
``>>`` on int32 is arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import i32, resolve, tensor_to_words, words_to_tensor

CRC_POLY_REFLECTED = 0x82F63B78
CRC_SEED = 0xFFFFFFFF  # the standard seed every checksum in the tree uses


@functools.lru_cache(maxsize=None)
def _table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC_POLY_REFLECTED if c & 1 else 0)
        t[i] = c
    return t.astype(np.uint32)


def crc32c_np(data, seed: int = 0xFFFFFFFF) -> int:
    """Scalar numpy/python reference (tests + host-side small inputs)."""
    t = _table()
    crc = seed & 0xFFFFFFFF
    for b in np.frombuffer(bytes(data), dtype=np.uint8):
        crc = (crc >> 8) ^ int(t[(crc ^ int(b)) & 0xFF])
    return crc


def _zeros_op_columns(nbytes: int) -> np.ndarray:
    """Columns of the GF(2) operator 'append nbytes zero bytes'."""
    t = _table()
    cols = np.zeros(32, dtype=np.uint64)
    for b in range(32):
        crc = 1 << b
        for _ in range(nbytes):
            crc = (crc >> 8) ^ int(t[crc & 0xFF])
        cols[b] = crc
    return cols.astype(np.uint32)


def _compose(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """Column representation of outer∘inner over GF(2)."""
    out = np.zeros(32, dtype=np.uint64)
    for b in range(32):
        v = int(inner[b])
        acc = 0
        for j in range(32):
            if (v >> j) & 1:
                acc ^= int(outer[j])
        out[b] = acc
    return out.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _word_columns() -> np.ndarray:
    """A_b = crc (seed 0) of the 4-byte LE word with only bit b set."""
    t = _table()
    cols = np.zeros(32, dtype=np.uint64)
    for b in range(32):
        word = 1 << b
        crc = 0
        for byte_i in range(4):
            byte = (word >> (8 * byte_i)) & 0xFF
            crc = (crc >> 8) ^ int(t[(crc ^ byte) & 0xFF])
        cols[b] = crc
    return cols.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _level_columns(level: int) -> np.ndarray:
    """Z operator for appending 4*2^level zero bytes, by repeated squaring."""
    if level == 0:
        return _zeros_op_columns(4)
    prev = _level_columns(level - 1)
    return _compose(prev, prev)


@functools.lru_cache(maxsize=None)
def _zeros_cols(nbytes: int) -> np.ndarray:
    """Columns of Z_nbytes by square-and-multiply over Z_1 (powers of one
    matrix commute, so composition order is free). Cached per length."""
    if nbytes <= 0:
        raise ValueError(f"zero-append length must be positive, got {nbytes}")
    ops = _zeros_op_columns(1)
    result: np.ndarray | None = None
    n = nbytes
    while n:
        if n & 1:
            result = ops if result is None else _compose(result, ops)
        n >>= 1
        if n:
            ops = _compose(ops, ops)
    return result


def zeros_shift(crc: int, nbytes: int) -> int:
    """Host scalar: crc after appending nbytes zero bytes (seed folding)."""
    result = crc & 0xFFFFFFFF
    if nbytes < 256:
        t = _table()
        for _ in range(nbytes):
            result = (result >> 8) ^ int(t[result & 0xFF])
        return result
    cols = _zeros_cols(nbytes)
    acc = 0
    for b in range(32):
        if (result >> b) & 1:
            acc ^= int(cols[b])
    return acc


def pack_blobs(blobs: np.ndarray) -> np.ndarray:
    """(..., L) uint8 -> (..., W) uint32 LE with W a power of two.

    Front-pads with zero bytes (CRC-neutral from state 0).
    """
    l = blobs.shape[-1]
    w = max(1, -(-l // 4))
    wp = 1 << (w - 1).bit_length()
    pad = wp * 4 - l
    if pad:
        blobs = np.concatenate(
            [np.zeros(blobs.shape[:-1] + (pad,), np.uint8), blobs], axis=-1
        )
    a = np.ascontiguousarray(blobs, dtype=np.uint8)
    return a.view("<u4").reshape(a.shape[:-1] + (wp,))


# ------------------------------------------------------------ plain version


def _apply_cols(cols: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """y = M x over GF(2), M given by 32 uint32 columns; x int32 words."""
    acc = None
    for b in range(32):
        col = int(cols[b])
        if col == 0:
            continue
        term = ((x >> b) & 1) * i32(col)
        acc = term if acc is None else acc ^ term
    return torch.zeros_like(x) if acc is None else acc


def crc0_words_plain(words: torch.Tensor) -> torch.Tensor:
    """Seed-0 CRC of each blob, words (..., W) int32 -> (...) int32: the
    JAX tree fold in plain torch ops, on whatever device ``words`` is."""
    w = words.shape[-1]
    wp = 1 << max(0, w - 1).bit_length()
    if wp != w:
        zeros = words.new_zeros(words.shape[:-1] + (wp - w,))
        words = torch.cat([zeros, words], dim=-1)
    c = _apply_cols(_word_columns(), words)
    level = 0
    while c.shape[-1] > 1:
        c = _apply_cols(_level_columns(level), c[..., 0::2]) ^ c[..., 1::2]
        level += 1
    return c[..., 0]


# --------------------------------------------------------------- the kernel


def crc_plan(w: int) -> tuple[int, int, int]:
    """How csrc/crc32c.cu cuts a blob of ``w`` words: (seg, subs, nseg).

    A blob is nseg rows (a power of two, at most CRC_ROWS); a row is subs
    segments of seg words (a multiple of 32, at most CRC_MAX_SEG), the
    unit of one B operand. nseg * subs * seg >= w; the rest is front
    padding. Rows are made as long as CRC_MAX_SEG words before a blob is
    cut into more of them: a block's loads then run longer between its
    joins, and short blobs share a block."""
    if w < 1:
        raise ValueError("blobs must hold at least one word")
    rows = -(-w // kernels.CRC_MAX_SEG)
    nseg = min(kernels.CRC_ROWS, 1 << (rows - 1).bit_length())
    per_row = -(-w // nseg)
    seg = min(kernels.CRC_MAX_SEG, -(-per_row // 32) * 32)
    return seg, -(-per_row // seg), nseg


@functools.lru_cache(maxsize=None)
def segment_columns(seg: int) -> np.ndarray:
    """(seg, 32) uint32: row i holds the 32 columns Z_{4(seg-1-i)}(A_b),
    the crc0 contribution of bit b of word i of a seg-word segment (the
    JAX package's ``_crc_bitmatrix`` for one segment)."""
    z4 = _zeros_op_columns(4)
    cols = np.zeros((seg, 32), dtype=np.uint32)
    cols[seg - 1] = _word_columns()
    for i in range(seg - 2, -1, -1):
        cols[i] = _compose(z4, cols[i + 1])
    return cols


@functools.lru_cache(maxsize=None)
def b1_fragments(seg: int) -> np.ndarray:
    """The B operand of csrc/crc32c.cu for seg-word segments:
    (seg/32, 4, 4, 32, 2) uint32 indexed [chunk ch, K-step kk, n-tile j,
    lane 4n+t, half h], bit b of each word.

    K: (ch, kk, h, t, b) is bit b of word 32ch + 8t + 4h + kk of the
    segment (each lane loads words 8t..8t+7 of a chunk as two 16 B loads).
    N: column n of n-tile j is crc bit 8(n >> 1) + 2j + (n & 1)."""
    cols = segment_columns(seg)
    ch = np.arange(seg // 32).reshape(-1, 1, 1, 1, 1, 1, 1)
    kk = np.arange(4).reshape(1, -1, 1, 1, 1, 1, 1)
    j = np.arange(4).reshape(1, 1, -1, 1, 1, 1, 1)
    n = np.arange(8).reshape(1, 1, 1, -1, 1, 1, 1)
    t = np.arange(4).reshape(1, 1, 1, 1, -1, 1, 1)
    h = np.arange(2).reshape(1, 1, 1, 1, 1, -1, 1)
    b = np.arange(32).reshape(1, 1, 1, 1, 1, 1, -1)
    word = 32 * ch + 8 * t + 4 * h + kk
    out_bit = 8 * (n >> 1) + 2 * j + (n & 1)
    bits = (cols[word, b].astype(np.uint64) >> out_bit.astype(np.uint64)) & 1
    words = (bits << b.astype(np.uint64)).sum(axis=-1, dtype=np.uint64)
    return words.astype(np.uint32).reshape(seg // 32, 4, 4, 32, 2)


def join_columns(w: int) -> np.ndarray:
    """(CRC_LEVELS + 1, 32) join operators of csrc/crc32c.cu for a blob of
    ``w`` words: Z_{4 seg} (segments within a row), then Z_{4 seg subs
    2^l} for the tree levels l = 0..CRC_LEVELS-1."""
    seg, subs, _ = crc_plan(w)
    row_bytes = 4 * seg * subs
    return np.stack([_zeros_cols(4 * seg)]
                    + [_zeros_cols(row_bytes << level)
                       for level in range(kernels.CRC_LEVELS)])


@functools.lru_cache(maxsize=256)
def _kernel_constants(w: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    # Blocking copies: the cached tensors are complete before any stream
    # (each EC batcher thread has its own) reads them.
    seg = crc_plan(w)[0]
    return (words_to_tensor(b1_fragments(seg), device),
            words_to_tensor(join_columns(w), device))


def _crc_kernel(src0: torch.Tensor, src1: torch.Tensor | None) -> torch.Tensor:
    """The kernel over (B, r0, W) and optional (B, r1, W) cells where they
    lie -> (B, r0 + r1) seed-0 CRCs."""
    w = src0.shape[-1]
    frags, zcols = _kernel_constants(w, str(src0.device))
    seg, subs, nseg = crc_plan(w)
    return kernels.crc32c(src0, src1, frags, zcols, seg, subs,
                          nseg.bit_length() - 1)


def _check_words(words: torch.Tensor) -> None:
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32 packed words, got {words.dtype}")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no CRC32C kernel for device {words.device}")


def crc0_words(words: torch.Tensor) -> torch.Tensor:
    """Seed-0 CRC32C of each blob: words (..., W) int32 -> (...) int32.

    A CUDA tensor goes through the CUDA kernel, a CPU tensor through
    ``crc0_words_plain``. Any W >= 1."""
    _check_words(words)
    if words.device.type == "cpu":
        return crc0_words_plain(words)
    lead, w = words.shape[:-1], words.shape[-1]
    out = _crc_kernel(words.reshape(-1, 1, w).contiguous(), None)
    return out.reshape(lead)


def crc0_cells(data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """Seed-0 CRC32C of the cells of two batches read where they lie:
    data (..., k, W) and parity (..., m, W) int32 -> (..., k+m), the data
    cells' CRCs then the parity cells' (what the CRCs of their
    concatenation along -2 would be, with no copy made)."""
    _check_words(data)
    _check_words(parity)
    if (data.dim() < 2 or data.shape[:-2] != parity.shape[:-2]
            or data.shape[-1] != parity.shape[-1]
            or data.device != parity.device):
        raise ValueError(f"cells {tuple(data.shape)} on {data.device} and "
                         f"{tuple(parity.shape)} on {parity.device} do not "
                         "pair up")
    lead, k, w = data.shape[:-2], data.shape[-2], data.shape[-1]
    if data.device.type == "cpu":
        out = data.new_empty(lead + (k + parity.shape[-2],))
        out[..., :k] = crc0_words_plain(data)
        out[..., k:] = crc0_words_plain(parity)
        return out
    out = _crc_kernel(data.reshape(-1, k, w).contiguous(),
                      parity.reshape(-1, parity.shape[-2], w).contiguous())
    return out.reshape(lead + (out.shape[-1],))


# ------------------------------------------------- cells cut into segments


def segment_shift_columns(words: int, parts: int) -> np.ndarray:
    """(parts, 32) uint32 for cells of ``words`` words cut into ``parts``
    equal segments (the width slots of a mesh): row j holds the columns
    of Z_{4 (words - end_j)}, which carries segment j's seed-0 CRC past
    the true bytes after it (the identity for the last segment). Then
    crc0(cell) = XOR_j Z_j(crc0(segment j)): segments are never padded as
    if each were a cell."""
    if parts < 1 or words % parts:
        raise ValueError(f"{words} words do not split into {parts} segments")
    seg = words // parts
    identity = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return np.stack([_zeros_cols(4 * (words - (j + 1) * seg))
                     if j < parts - 1 else identity for j in range(parts)])


@functools.lru_cache(maxsize=256)
def _device_columns(cols_bytes: bytes, device: str) -> torch.Tensor:
    # A blocking copy, as _kernel_constants.
    cols = np.frombuffer(cols_bytes, dtype=np.uint32).reshape(-1, 32)
    return words_to_tensor(cols, device)


def device_columns(cols: np.ndarray, device: str) -> torch.Tensor:
    """(n, 32) uint32 operator columns as an int32 tensor on ``device``,
    cached per (columns, device)."""
    return _device_columns(np.ascontiguousarray(cols, np.uint32).tobytes(),
                           device)


def crc32c_batch(blobs: np.ndarray, seed: int = CRC_SEED,
                 device: torch.device | str | None = None) -> np.ndarray:
    """Per-blob CRC32C: blobs (..., L) uint8 -> (...,) uint32, computed on
    ``device`` (the card unless the caller names another)."""
    blobs = np.asarray(blobs, dtype=np.uint8)
    words = words_to_tensor(pack_blobs(blobs), resolve(device))
    seed_part = zeros_shift(seed & 0xFFFFFFFF, blobs.shape[-1])
    return tensor_to_words(crc0_words(words) ^ i32(seed_part))


def crc32c_words_device(words: torch.Tensor, seed_shifted: int) -> torch.Tensor:
    """Pre-packed words + pre-shifted seed constant (zeros_shift(seed, L))
    -> per-blob CRC32C, staying on the tensor's device."""
    return crc0_words(words) ^ i32(seed_shifted)


def crc32c_cells_device(cells: torch.Tensor, cell_bytes: int,
                        parity: torch.Tensor | None = None) -> torch.Tensor:
    """Per-cell CRC32C (standard seed) of (..., W) int32 cells with ANY
    word count. ``cell_bytes`` is the true cell length (4 * W): the seed
    folds with it, not with a padded length. With ``parity`` the cells are
    two batches, (..., k, W) and (..., m, W), read where they lie, and the
    result is (..., k+m) (``crc0_cells``)."""
    seed = i32(zeros_shift(CRC_SEED, cell_bytes))
    if parity is None:
        return crc0_words(cells) ^ seed
    return crc0_cells(cells, parity) ^ seed
