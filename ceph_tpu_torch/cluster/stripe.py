"""Stripe arithmetic + mutation overlays for the EC RMW write path.

The stripe_info_t role (reference src/osd/ECUtil.h:27-141): an EC object
is striped into fixed-width stripes of ``stripe_width = k * stripe_unit``
bytes; stripe ``s`` splits into k cells of ``stripe_unit`` bytes, cell j
living at offset ``s * stripe_unit`` of shard j's file, plus m parity
cells computed per stripe.  A partial overwrite therefore touches only
``O(write / stripe_width)`` stripes: read those stripes' old cells,
re-encode them, ship per-shard cell deltas (the ECBackend.cc:1898
``start_rmw`` shape).

Device-first consequence of the fixed stripe_unit: every encode in the
cluster, regardless of object size, is a batch of identically-shaped
(k, stripe_unit) codewords — one cell shape (one set of kernel B
operands) services the whole data path, and stripes from different
objects/PGs batch together in the ECBatcher.  The reference's variable chunk_size-per-object cannot do
this (ErasureCodeJerasure.cc:80 sizes chunks per call).

Integrity is per-cell: each shard keeps a u32 CRC32C per cell (the
hash_info role, ECUtil.h HashInfo) so partial overwrites only recompute
the touched cells' CRCs — a cumulative whole-chunk digest would force an
O(object) re-hash per small write.

``Overlay`` accumulates an op vector's logical data mutations
(write/zero/truncate) without materializing the object: the PG runs the
vector against it, then the backends turn the normalized extents into
op-granular transactions (ReplicatedBackend.cc:465 ships the transaction,
not the object).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/stripe.py``, over the
port's C++ host core.
"""
from __future__ import annotations

import numpy as np

from .. import native

DEFAULT_STRIPE_UNIT = 4096


def effective_stripe_unit(codec, requested: int = DEFAULT_STRIPE_UNIT) -> int:
    """Round ``requested`` up so one stripe (object of k*su bytes) yields
    cells of exactly su bytes under the codec's alignment rules — i.e. su
    is a fixed point of ``get_chunk_size(k * su)``."""
    su = max(4, int(requested))
    for _ in range(8):
        got = codec.get_chunk_size(codec.k * su)
        if got == su:
            return su
        su = got
    raise ValueError(f"stripe_unit {requested} does not stabilize")


class StripeInfo:
    """Fixed-layout stripe math for one (k, stripe_unit) geometry."""

    def __init__(self, k: int, m: int, stripe_unit: int):
        self.k = k
        self.m = m
        self.su = stripe_unit
        self.width = k * stripe_unit  # logical bytes per stripe

    # ------------------------------------------------------------ sizes

    def nstripes(self, size: int) -> int:
        """Stripes (= cells per shard) covering a logical size."""
        return -(-size // self.width) if size else 0

    def shard_size(self, size: int) -> int:
        return self.nstripes(size) * self.su

    def stripe_span(self, offset: int, length: int) -> tuple[int, int]:
        """[s0, s1) stripe range overlapping byte range [offset, offset+length)."""
        if length <= 0:
            return (0, 0)
        return (offset // self.width, -(-(offset + length) // self.width))

    # ------------------------------------------------- layout transforms

    def to_cells(self, data: np.ndarray, s0: int, s1: int) -> np.ndarray:
        """Logical bytes of stripes [s0, s1) (zero-padded to full width)
        -> (s1-s0, k, su) uint8 cells. ``data`` is the logical byte range
        starting at stripe s0 (may be short; padded)."""
        n = s1 - s0
        buf = np.zeros(n * self.width, dtype=np.uint8)
        buf[: data.size] = data
        return buf.reshape(n, self.k, self.su)

    def from_cells(self, cells: np.ndarray) -> np.ndarray:
        """(n, k, su) data cells -> contiguous logical bytes (padded)."""
        return np.ascontiguousarray(cells).reshape(-1)

    # ---------------------------------------------------- per-cell CRCs

    @staticmethod
    def cell_crcs(shard_bytes: np.ndarray, su: int) -> np.ndarray:
        """u32 CRC32C per su-sized cell of a shard file (one native
        multithreaded batch call, not a python loop per cell)."""
        import os

        cells = np.ascontiguousarray(shard_bytes).reshape(-1, su)
        return native.crc32c_batch(cells, threads=os.cpu_count() or 1)

    def crc_of_cell(self, cell: np.ndarray) -> int:
        return int(native.crc32c(np.ascontiguousarray(cell)))


ZERO_CELL_CRC_CACHE: dict[int, int] = {}


def zero_cell_crc(su: int) -> int:
    """CRC32C of an all-zero cell (memoized: every zero-extend uses it)."""
    crc = ZERO_CELL_CRC_CACHE.get(su)
    if crc is None:
        crc = int(native.crc32c(np.zeros(su, dtype=np.uint8)))
        ZERO_CELL_CRC_CACHE[su] = crc
    return crc


# hinfo attr codec: concat of LE u32 per cell
def enc_hinfo(crcs: np.ndarray) -> bytes:
    return np.asarray(crcs, dtype="<u4").tobytes()


def dec_hinfo(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype="<u4").copy()


class Overlay:
    """Logical data mutations of one op vector, without the object.

    Tracks virtual object size through write/zero/truncate ops and keeps
    the written extents as a sorted, non-overlapping list of
    ``(offset, bytes | int-length-of-zeros)``.  Later ops shadow earlier
    ones; truncate drops extents beyond the new size.  ``extents()``
    yields the normalized final mutations, ``apply()`` materializes
    against old bytes (for reads-after-writes inside the vector).
    """

    def __init__(self, old_size: int):
        self.old_size = old_size
        self.size = old_size
        #: list[(off, payload: bytes | zero-length int)]
        self._ext: list[tuple[int, bytes | int]] = []
        self.truncated = False  # any truncate below a prior size happened

    # ------------------------------------------------------------- ops

    def write(self, offset: int, data: bytes) -> None:
        if not len(data):
            return
        if not isinstance(data, (bytes, memoryview)):
            # mutable (bytearray) or array storage: snapshot; immutable
            # payloads and read-only views ride the extent list as-is
            # (the client's write body lands here un-copied)
            data = bytes(data)
        self._insert(offset, data)
        self.size = max(self.size, offset + len(data))

    def zero(self, offset: int, length: int) -> None:
        if length <= 0:
            return
        self._insert(offset, int(length))
        self.size = max(self.size, offset + length)

    def truncate(self, new_size: int) -> None:
        if new_size < self.size:
            self.truncated = True
            kept: list[tuple[int, bytes | int]] = []
            for off, p in self._ext:
                ln = p if isinstance(p, int) else len(p)
                if off >= new_size:
                    continue
                if off + ln > new_size:
                    keep = new_size - off
                    p = keep if isinstance(p, int) else p[:keep]
                kept.append((off, p))
            self._ext = kept
            if new_size < self.old_size:
                # old bytes beyond the cut are dead: if the object grows
                # back, that region must read as zeros, not resurrect
                self._insert(new_size, int(self.old_size - new_size))
        elif new_size > self.size:
            # extend-with-zeros is an explicit zero extent so backends
            # see it (stores may or may not zero-fill on truncate-up)
            self._insert(self.size, int(new_size - self.size))
        self.size = new_size

    # -------------------------------------------------------- accessors

    def extents(self) -> list[tuple[int, bytes | int]]:
        return list(self._ext)

    @property
    def empty(self) -> bool:
        return not self._ext and not self.truncated \
            and self.size == self.old_size

    def written_ranges(self) -> list[tuple[int, int]]:
        """[(offset, length)] of mutated extents clamped to the final
        size (sorted, disjoint)."""
        out = []
        for off, p in self._ext:
            ln = p if isinstance(p, int) else len(p)
            if off >= self.size:
                continue
            out.append((off, min(ln, self.size - off)))
        return out

    def apply(self, old: bytes | bytearray) -> bytearray:
        """Materialize: old bytes + this overlay."""
        data = bytearray(old)
        if len(data) < self.size:
            data.extend(b"\0" * (self.size - len(data)))
        elif len(data) > self.size:
            del data[self.size:]
        for off, p in self._ext:
            ln = p if isinstance(p, int) else len(p)
            if off >= self.size:
                continue
            ln = min(ln, self.size - off)
            if isinstance(p, int):
                data[off : off + ln] = b"\0" * ln
            else:
                data[off : off + ln] = p[:ln]
        return data

    def apply_range(self, start: int, end: int, old: bytes) -> bytes:
        """Final bytes of [start, end) (end <= size): ``old`` is the OLD
        object's bytes from ``start`` (may be short — zero-extended), the
        overlay's extents are laid on top."""
        out = bytearray(end - start)
        n = min(len(old), max(0, min(end, self.old_size) - start))
        out[:n] = old[:n]
        for off, p in self._ext:
            ln = p if isinstance(p, int) else len(p)
            lo = max(off, start)
            hi = min(off + ln, end, self.size)
            if lo >= hi:
                continue
            if isinstance(p, int):
                out[lo - start : hi - start] = b"\0" * (hi - lo)
            else:
                out[lo - start : hi - start] = p[lo - off : hi - off]
        return bytes(out)

    def covers(self, offset: int, length: int) -> bool:
        """Do the extents fully cover [offset, offset+length)?"""
        pos = offset
        end = offset + length
        for off, p in self._ext:
            ln = p if isinstance(p, int) else len(p)
            if off > pos:
                break
            if off + ln > pos:
                pos = off + ln
                if pos >= end:
                    return True
        return pos >= end

    def slice(self, offset: int, length: int) -> bytes:
        """Bytes of [offset, offset+length) assuming covers() is True."""
        out = bytearray(length)
        for off, p in self._ext:
            ln = p if isinstance(p, int) else len(p)
            lo = max(off, offset)
            hi = min(off + ln, offset + length)
            if lo >= hi:
                continue
            if not isinstance(p, int):
                out[lo - offset : hi - offset] = p[lo - off : hi - off]
        return bytes(out)

    # --------------------------------------------------------- internals

    def scatter(self, dst: np.ndarray, tlist: list[int],
                si: "StripeInfo", old_runs) -> tuple[int, int]:
        """Materialize this overlay straight into the shard-major EC
        staging rows: ONE vectorized application of all of the op's
        extents, not an ``apply_range`` round-trip per stripe (the
        round-9 profile's second residual cost).

        ``dst`` is the staging buffer's data rows ``(k, T, su)``,
        zero-filled, whose columns back the sorted touched stripes
        ``tlist``; ``old_runs`` is ``[(first_stripe, bytes)]`` — the
        old stripe data fetched for partially-covered stripes, laid
        first so the extents shadow it exactly like ``apply_range``.
        Logical byte ``x`` of stripe ``s`` lands at
        ``dst[(x % width) // su, col(s), x % su]``; whole interior
        cells go as one strided assign (stripe-aligned runs) or one
        fancy-indexed scatter, so the Python cost is O(extents), not
        O(stripes x extents). Returns (extents, columns) for the
        ``ov_apply_*`` perf ledger."""
        k, su, width = si.k, si.su, si.width
        cols = np.asarray(tlist, dtype=np.int64)
        size = self.size

        def put(lo: int, hi: int, payload) -> None:
            # scatter logical [lo, hi) (payload None = zeros, else the
            # bytes starting at logical lo)
            src = (None if payload is None
                   else np.frombuffer(payload, dtype=np.uint8))
            pos = lo
            if pos % su:  # head partial cell
                g = pos // su
                n = min(hi, (g + 1) * su) - pos
                i = int(np.searchsorted(cols, g // k))
                if src is None:
                    dst[g % k, i, pos % su: pos % su + n] = 0
                else:
                    dst[g % k, i, pos % su: pos % su + n] = \
                        src[pos - lo: pos - lo + n]
                pos += n
            nfull = (hi - pos) // su
            if nfull > 0:
                g0 = pos // su
                s0 = g0 // k
                i0 = int(np.searchsorted(cols, s0))
                gs = np.arange(g0, g0 + nfull)
                rows = gs % k
                ci = i0 + (gs // k - s0)
                if src is None:
                    dst[rows, ci, :] = 0
                elif g0 % k == 0 and nfull % k == 0:
                    # stripe-aligned interior (the writefull shape):
                    # one strided assign, no index arrays at all
                    mid = src[pos - lo: pos - lo + nfull * su]
                    dst[:, i0: i0 + nfull // k, :] = \
                        mid.reshape(nfull // k, k, su).transpose(1, 0, 2)
                else:
                    dst[rows, ci, :] = \
                        src[pos - lo: pos - lo + nfull * su] \
                        .reshape(nfull, su)
                pos += nfull * su
            if pos < hi:  # tail partial cell
                g = pos // su
                i = int(np.searchsorted(cols, g // k))
                if src is None:
                    dst[g % k, i, : hi - pos] = 0
                else:
                    dst[g % k, i, : hi - pos] = src[pos - lo: hi - lo]

        old_clip = min(self.old_size, size)
        for s0, data in old_runs:
            lo = s0 * width
            hi = min(lo + len(data), old_clip)
            if hi > lo:
                put(lo, hi, data)
        n_ext = 0
        for off, p in self._ext:
            ln = p if isinstance(p, int) else len(p)
            lo, hi = off, min(off + ln, size)
            if hi <= lo:
                continue
            n_ext += 1
            put(lo, hi, None if isinstance(p, int) else p)
        return n_ext, len(tlist)

    def _insert(self, offset: int, payload: bytes | int) -> None:
        """Insert an extent, splitting/trimming whatever it shadows."""
        ln = payload if isinstance(payload, int) else len(payload)
        end = offset + ln
        out: list[tuple[int, bytes | int]] = []
        for off, p in self._ext:
            pln = p if isinstance(p, int) else len(p)
            pend = off + pln
            if pend <= offset or off >= end:
                out.append((off, p))
                continue
            if off < offset:  # keep head
                keep = offset - off
                out.append((off, keep if isinstance(p, int) else p[:keep]))
            if pend > end:  # keep tail
                keep = pend - end
                out.append(
                    (end, keep if isinstance(p, int) else p[pln - keep:])
                )
        out.append((offset, payload))
        out.sort(key=lambda e: e[0])
        self._ext = out
