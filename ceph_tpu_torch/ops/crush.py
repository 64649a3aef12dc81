"""CRUSH straw2 placement in PyTorch, with its CUDA kernel.

The reference computes placement one object at a time in C
(bucket_straw2_choose, src/crush/mapper.c:339-363; Jenkins hash
src/crush/hash.c; fixed-point crush_ln + tables src/crush/mapper.c:226,
crush_ln_table.h). The math is integer-only and independent per object,
so the bulk form is one straw2 choose per placement input ``x``.

The plain versions here are torch ops on int64 tensors that carry uint32
bit patterns, masked after every operation (CPU torch has no uint32
shifts): the Jenkins hashes, ``crush_ln`` with its tables as a plain
gather, and the draw as an exact int64 floor division of a non-negative
numerator. ``straw2_choose`` runs ``csrc/straw2.cu`` for a CUDA tensor and
the plain version for a CPU one; ``straw2_bulk`` is the numpy surface
(north-star config 5: 10 M objects over a 1 K-OSD bucket).

The full rule engine (firstn/indep retries over a bucket hierarchy,
mapper.c:438,633) lives in ceph_tpu_torch/placement/bulk.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import resolve
from ..native import gen_tables

HASH_SEED = 1315423911
INT64_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF
#: draws per chunk of the plain straw2 choose (bounds its temporaries)
_PLAIN_CHUNK = 1 << 22


# ------------------------------------------------------------------ tables


@functools.lru_cache(maxsize=None)
def ln_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(RH[129], LH[129], LL[256]) int64, same source as the C header."""
    rhlh = gen_tables.rh_lh_tables()
    ll = gen_tables.ll_table()
    rh = np.array([a for a, _ in rhlh], dtype=np.int64)
    lh = np.array([b for _, b in rhlh], dtype=np.int64)
    return rh, lh, np.array(ll, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def kernel_tables(device: str) -> torch.Tensor:
    """RH, LH and LL back to back, (514,) int64 on ``device``: the table
    operand of the CUDA kernels, and the plain version's tables. A
    blocking copy, so any thread's stream may read it."""
    return torch.from_numpy(np.concatenate(ln_tables())).to(device)


def _u32(*vs) -> list[torch.Tensor]:
    """Integer tensors, arrays or ints -> int64 tensors of their uint32
    values, broadcast together on the device of the first tensor."""
    dev = next((v.device for v in vs if isinstance(v, torch.Tensor)), None)
    ts = [(v if isinstance(v, torch.Tensor)
           else torch.as_tensor(np.asarray(v))).to(dev or "cpu", torch.int64)
          & _M32 for v in vs]
    return list(torch.broadcast_tensors(*ts))


# ------------------------------------------------------------- jenkins hash


def _hashmix(a, b, c):
    """Robert Jenkins' 96-bit mix; uint32 wraparound in int64."""
    a = ((a - b - c) & _M32) ^ (c >> 13)
    b = ((b - c - a) & _M32) ^ ((a << 8) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 13)
    a = ((a - b - c) & _M32) ^ (c >> 12)
    b = ((b - c - a) & _M32) ^ ((a << 16) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 5)
    a = ((a - b - c) & _M32) ^ (c >> 3)
    b = ((b - c - a) & _M32) ^ ((a << 10) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 15)
    return a, b, c


def hash32_2(a, b) -> torch.Tensor:
    """crush_hash32_2 (reference src/crush/hash.c), elementwise; int64
    tensor of uint32 values."""
    a, b = _u32(a, b)
    h = HASH_SEED ^ a ^ b
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _hashmix(a, b, h)
    x, a, h = _hashmix(x, a, h)
    b, y, h = _hashmix(b, y, h)
    return h


def hash32_3(a, b, c) -> torch.Tensor:
    """crush_hash32_3 — the straw2 draw hash, elementwise."""
    a, b, c = _u32(a, b, c)
    h = HASH_SEED ^ a ^ b ^ c
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _hashmix(a, b, h)
    c, x, h = _hashmix(c, x, h)
    y, a, h = _hashmix(y, a, h)
    b, x, h = _hashmix(b, x, h)
    y, c, h = _hashmix(y, c, h)
    return h


# ---------------------------------------------------------------- crush_ln


def crush_ln(u) -> torch.Tensor:
    """2^44 * log2(x+1) in 16.44 fixed point (mapper.c:226), elementwise.

    u is the 16-bit hash value (hash & 0xffff); returns int64. Matches
    ct_crush_ln bit for bit, including the x == 0x10000 wrap of the
    reference's (int64)x * RH: only the low byte of the product's bits
    48.. is used, and the wrapped product keeps it."""
    x = (_u32(u)[0] & 0xFFFF) + 1  # 1..0x10000
    tables = kernel_tables(str(x.device))
    rh_t, lh_t, ll_t = tables[:129], tables[129:258], tables[258:]
    hb = torch.zeros_like(x)  # floor(log2(x)), as clz would give it
    for k in range(1, 17):
        hb = hb + ((x >> k) > 0).to(torch.int64)
    big = x >= 0x8000
    xs = torch.where(big, x, x << (15 - hb).clamp(min=0))
    iexpon = torch.where(big, torch.full_like(hb, 15), hb)
    idx1 = (xs >> 8) - 128
    rh, lh = rh_t[idx1], lh_t[idx1]
    ll = ll_t[((xs * rh) >> 48) & 0xFF]
    return (iexpon << 44) + ((lh + ll) >> 4)


# ------------------------------------------------------------------ straw2


def straw2_draw(x, item_id, r, weight) -> torch.Tensor:
    """Per-(x, item, r) straw length (mapper.c:313-337), int64.

    weight is 16.16 fixed point (uint32). Zero weight draws INT64_MIN so
    the item can never win (the reference skips it). The numerator
    2^48 - ln is never negative, so C truncation of (ln - 2^48) / w is
    minus an exact floor division."""
    h = hash32_3(x, item_id, r)
    ln = crush_ln(h & 0xFFFF)
    w = _u32(weight, h)[0]
    q = -torch.div((1 << 48) - ln, w.clamp(min=1), rounding_mode="floor")
    return torch.where(w == 0, torch.full_like(q, INT64_MIN), q)


def straw2_choose_plain(items: torch.Tensor, ids: torch.Tensor,
                        weights: torch.Tensor, xs: torch.Tensor,
                        r: int) -> torch.Tensor:
    """bucket_straw2_choose for every x in plain torch, on ``xs``' device:
    the argmax of the draws, first wins on ties, an all-zero bucket
    returns slot 0. items/ids (n,) int32, weights (n,) int32 holding
    uint32 16.16, xs (N,) int32 holding uint32 -> (N,) int32 items."""
    n = items.shape[0]
    slot = torch.arange(n, device=xs.device)
    out = []
    step = max(1, _PLAIN_CHUNK // max(n, 1))
    for lo in range(0, xs.shape[0], step):
        part = xs[lo:lo + step]
        draws = straw2_draw(part[:, None], ids[None, :], r, weights[None, :])
        top = draws.max(dim=1, keepdim=True).values
        win = torch.where(draws == top, slot, n).min(dim=1).values
        out.append(items[win])
    if not out:
        return torch.empty(0, dtype=torch.int32, device=xs.device)
    return torch.cat(out).to(torch.int32)


def _check_bucket(items, ids, weights, xs) -> None:
    for name, t in (("items", items), ("ids", ids), ("weights", weights),
                    ("xs", xs)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != xs.device:
            raise ValueError(f"{name} on {t.device}, xs on {xs.device}")
    n = items.shape[0]
    if n < 1 or ids.shape[0] != n or weights.shape[0] != n:
        raise ValueError(f"bucket of items {tuple(items.shape)}, ids "
                         f"{tuple(ids.shape)}, weights {tuple(weights.shape)}")


def straw2_choose(items: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, xs: torch.Tensor,
                  r: int) -> torch.Tensor:
    """One straw2 choose per x: the CUDA kernel for CUDA tensors, the
    plain version for CPU ones. Shapes and types as
    ``straw2_choose_plain``."""
    _check_bucket(items, ids, weights, xs)
    if xs.device.type == "cpu":
        return straw2_choose_plain(items, ids, weights, xs, r)
    if xs.device.type != "cuda":
        raise ValueError(f"no straw2 kernel for device {xs.device}")
    return kernels.straw2(items.contiguous(), ids.contiguous(),
                          weights.contiguous(), xs.contiguous(), r,
                          kernel_tables(str(xs.device)))


def _i32_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(a, dtype=dtype).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def straw2_bulk(items: np.ndarray, weights: np.ndarray, xs: np.ndarray,
                r: int = 0, ids: np.ndarray | None = None,
                device=None) -> np.ndarray:
    """Bulk placement: one straw2 choose per x. Matches native.straw2_bulk.

    items (n,) int32, weights (n,) uint32 16.16 fixed point, xs (N,)
    uint32 -> (N,) int32. Runs on the card unless ``device`` names
    another (``"cpu"``: the plain version)."""
    dev = resolve(device)
    items_t = _i32_tensor(items, np.int32, dev)
    ids_t = items_t if ids is None else _i32_tensor(ids, np.int32, dev)
    out = straw2_choose(items_t, ids_t, _i32_tensor(weights, np.uint32, dev),
                        _i32_tensor(xs, np.uint32, dev), r)
    return out.cpu().numpy()
