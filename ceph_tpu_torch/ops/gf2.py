"""GF(2) XOR-schedule kernels for the bitmatrix erasure-code family.

A bitmatrix code (blaum_roth / liberation / liber8tion / cauchy_bm,
ec/bitmatrix_plugin.py) computes every output packet row as the XOR of
a fixed subset of input packet rows -- row r of the (R, C) binary
matrix selects the inputs. The host reference walks the matrix row by
row; the device shape here is the XOR-schedule optimization of
arXiv:2108.02692 precomputed into tensors:

- **XOR plan** (:func:`xor_plan`): at ``init()`` the binary matrix is
  lowered to a dense (R, T) gather-index tensor, T = max row popcount.
  Rows with fewer terms pad with index C, which addresses an appended
  all-zero row -- XOR-inert, so no masking is needed.
- **One launch** (:func:`gf2_apply`): on a CUDA tensor the whole stripe
  batch goes through ``csrc/gf2_xor.cu`` (K5), which reads each input
  packet word from device memory once and writes every output row; on a
  CPU tensor through :func:`gf2_apply_plain`, the JAX package's own
  arithmetic (append a zero row, gather, fold with XOR).
- **Encode + CRC** (:func:`encode_with_crcs`): like
  ``rs.encode_with_crcs``, parity AND the per-cell CRC32Cs of
  data+parity, the CRC kernel reading data and parity where they lie.

Packed words are int32 tensors holding the uint32 bit pattern
(``device.py``); plans are int32.

Layout contract: a cell of ``su`` bytes packs to W = su/4 words and
splits into w packet rows of W/w words (su % (4*w) == 0 -- the plugin's
k*w*4 alignment guarantees it). Packing little-endian bytes first and
then reshaping words is identical to splitting bytes first and packing
each row, because rows are word-aligned.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import crc32c as crc_ops


def xor_plan(matrix: np.ndarray) -> np.ndarray:
    """(R, C) binary matrix -> (R, T) int32 gather-index plan.

    T is the max row popcount; short rows pad with index C (the
    appended zero row). An all-zero matrix row becomes a row of pads
    and correctly produces zeros."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    rows, cols = m.shape
    terms = [np.nonzero(m[r])[0] for r in range(rows)]
    t = max((len(ix) for ix in terms), default=0) or 1
    plan = np.full((rows, t), cols, dtype=np.int32)
    for r, ix in enumerate(terms):
        plan[r, : len(ix)] = ix.astype(np.int32)
    return plan


def _check(plan: np.ndarray, rows: torch.Tensor) -> np.ndarray:
    plan = np.ascontiguousarray(plan, dtype=np.int32)
    if plan.ndim != 2 or plan.shape[1] < 1:
        raise ValueError(f"plan must be (R, T) with T >= 1, got {plan.shape}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32 packed words, got {rows.dtype}")
    if rows.dim() < 2:
        raise ValueError(f"rows must be (..., C, L), got {tuple(rows.shape)}")
    c = rows.shape[-2]
    if plan.size and (plan.min() < 0 or plan.max() > c):
        raise ValueError(f"plan indices outside 0..{c} (index {c} is the "
                         "zero row)")
    return plan


# Sized like rs._device_fragments: one plan per (pattern, want) decode
# plus the encode plans of the codecs in use.
@functools.lru_cache(maxsize=4096)
def _device_plan(plan_bytes: bytes, rows: int, terms: int,
                 device: str) -> torch.Tensor:
    # A blocking copy: the cached tensor is complete before any stream
    # (each EC batcher thread has its own) reads it.
    plan = np.frombuffer(plan_bytes, dtype=np.int32).reshape(rows, terms)
    return torch.from_numpy(plan.copy()).to(device)


def gf2_apply_plain(plan: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``gf2_apply`` in plain torch ops, on ``rows``'
    device: append a zero row, gather every term of every output row,
    fold the term axis with XOR. rows (..., C, L) int32 -> (..., R, L)."""
    plan = _check(plan, rows)
    zero = rows.new_zeros(rows.shape[:-2] + (1, rows.shape[-1]))
    ext = torch.cat([rows, zero], dim=-2)
    idx = torch.from_numpy(np.ascontiguousarray(plan.reshape(-1),
                                                dtype=np.int32)).to(rows.device)
    gathered = ext.index_select(-2, idx).reshape(
        rows.shape[:-2] + plan.shape + (rows.shape[-1],))
    acc = gathered[..., 0, :]
    for t in range(1, plan.shape[1]):
        acc = acc ^ gathered[..., t, :]
    return acc.contiguous()


def gf2_apply(plan: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    """XOR-combine packet rows per a gather plan: plan (R, T) int32 indices
    into axis -2 of ``rows`` (index C = zero row), rows (..., C, L) int32
    -> (..., R, L) int32, out[r] = XOR over t of rows_ext[plan[r, t]].
    The CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    plan = _check(plan, rows)
    if rows.device.type == "cpu":
        return gf2_apply_plain(plan, rows)
    if rows.device.type != "cuda":
        raise ValueError(f"no GF(2) XOR kernel for device {rows.device}")
    lead, c, l = rows.shape[:-2], rows.shape[-2], rows.shape[-1]
    dplan = _device_plan(plan.tobytes(), plan.shape[0], plan.shape[1],
                         str(rows.device))
    out = kernels.gf2_xor(rows.reshape(-1, c, l).contiguous(), dplan)
    return out.reshape(*lead, plan.shape[0], l)


def gf2_encode_cells(plan: np.ndarray, w: int, out_rows: int,
                     data: torch.Tensor) -> torch.Tensor:
    """Cell-level entry: data (..., k, W) int32 cells -> coding
    (..., R/w, W) int32 cells, each cell split into its w packet rows of
    W/w words as a view (W % w == 0 by the plugin's alignment)."""
    lead = data.shape[:-2]
    c, words = data.shape[-2], data.shape[-1]
    if words % w:
        raise ValueError(f"cell of {words} words does not split into "
                         f"w={w} packet rows")
    rows = data.reshape(*lead, c * w, words // w)
    out = gf2_apply(plan, rows)
    return out.reshape(*lead, out_rows, words)


def encode_with_crcs(plan: np.ndarray, w: int, m_rows: int, cell_bytes: int,
                     data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bitmatrix encode + per-cell CRC32C: data (..., k, W) int32 ->
    (parity (..., m, W), crcs (..., k+m)), the GF(2) analog of
    ``rs.encode_with_crcs``. The CRC reads data and parity where they
    lie: nothing is copied."""
    parity = gf2_encode_cells(plan, w, m_rows, data)
    return parity, crc_ops.crc32c_cells_device(data, cell_bytes, parity)


# -------------------- numpy reference (host engine) --------------------


def gf2_apply_np(plan: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Host-batched reference with the same plan semantics: rows
    (..., C, L) uint8/uint32 -> (..., R, L). One vectorized gather +
    XOR-reduce -- the bit-exactness oracle the device path is pinned
    against, and the batcher's host-engine shape for these codecs."""
    zero = np.zeros(rows.shape[:-2] + (1, rows.shape[-1]),
                    dtype=rows.dtype)
    ext = np.concatenate([rows, zero], axis=-2)
    return np.bitwise_xor.reduce(np.take(ext, plan, axis=-2), axis=-2)


def gf2_apply_np_blocked(plan: np.ndarray, rows: np.ndarray,
                         block: int = 256) -> np.ndarray:
    """Batch-blocked host apply: byte-identical to ``gf2_apply_np``,
    but the (..., R, terms, L) gather intermediate is materialized at
    most ``block`` stripes at a time -- a recovery storm's host decode
    keeps bounded scratch instead of scaling it with the batch, and
    the over-decomposed dispatch's row blocks reuse the same grain."""
    if rows.ndim < 3 or len(rows) <= block:
        return gf2_apply_np(plan, rows)
    return np.concatenate([gf2_apply_np(plan, rows[i:i + block])
                           for i in range(0, len(rows), block)])


def gf2_encode_cells_np(plan: np.ndarray, w: int,
                        cells: np.ndarray) -> np.ndarray:
    """Host cell-level entry: cells (..., k, su) uint8 -> coding
    (..., R/w, su) uint8."""
    lead = cells.shape[:-2]
    c, su = cells.shape[-2], cells.shape[-1]
    rows = cells.reshape(*lead, c * w, su // w)
    out = gf2_apply_np_blocked(plan, rows)
    return out.reshape(*lead, plan.shape[0] // w, su)
