"""SloppyCRCMap: opportunistic whole-object CRC tracking
(src/common/SloppyCRCMap.h role).

Tracks crc32c per fixed-size block of an object as writes flow by:
block-aligned writes record exact CRCs; unaligned edges invalidate the
touched blocks (recorded as the `zero` sentinel-free "unknown" state by
deletion). read-side check compares stored CRCs against actual data
and reports mismatching offsets — cheap bit-rot tripwire where full
digests would cost too much, exactly the reference's sloppiness
contract. zero() and truncate() mirror the reference surface.

ceph_tpu_torch's own copy of ``ceph_tpu/utils/sloppy_crc.py``.
"""
from __future__ import annotations

import numpy as np

from .. import native
from . import denc


class SloppyCRCMap:
    def __init__(self, block_size: int = 65536):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.crc: dict[int, int] = {}  # block index -> crc32c

    # ------------------------------------------------------------ write

    def write(self, offset: int, data: bytes) -> None:
        bs = self.block_size
        end = offset + len(data)
        first, last = offset // bs, (end - 1) // bs if data else offset // bs
        for b in range(first, last + 1):
            blk_lo = b * bs
            blk_hi = blk_lo + bs
            if offset <= blk_lo and end >= blk_hi:
                chunk = data[blk_lo - offset : blk_hi - offset]
                self.crc[b] = native.crc32c(
                    np.frombuffer(chunk, np.uint8)
                )
            else:
                # partial coverage: CRC unknowable without a read
                self.crc.pop(b, None)

    def zero(self, offset: int, length: int) -> None:
        self.write(offset, b"\0" * length)

    def truncate(self, offset: int) -> None:
        bs = self.block_size
        cut = -(-offset // bs)
        for b in [b for b in self.crc if b >= cut]:
            del self.crc[b]
        if offset % bs:
            self.crc.pop(offset // bs, None)

    def clear(self) -> None:
        self.crc.clear()

    # ------------------------------------------------------------- read

    def read_check(self, offset: int, data: bytes) -> list[int]:
        """Offsets of blocks whose stored CRC mismatches `data`
        (fully-covered, tracked blocks only)."""
        bs = self.block_size
        end = offset + len(data)
        bad: list[int] = []
        first = -(-offset // bs)  # first fully covered block
        b = first
        while (b + 1) * bs <= end:
            want = self.crc.get(b)
            if want is not None:
                chunk = data[b * bs - offset : (b + 1) * bs - offset]
                got = native.crc32c(np.frombuffer(chunk, np.uint8))
                if got != want:
                    bad.append(b * bs)
            b += 1
        return bad

    # ------------------------------------------------------------- wire

    def encode(self) -> bytes:
        parts = [denc.enc_u32(self.block_size),
                 denc.enc_u32(len(self.crc))]
        for b in sorted(self.crc):
            parts.append(denc.enc_u64(b))
            parts.append(denc.enc_u32(self.crc[b]))
        return b"".join(parts)

    @classmethod
    def decode(cls, buf: bytes, off: int = 0) -> tuple["SloppyCRCMap", int]:
        bs, off = denc.dec_u32(buf, off)
        n, off = denc.dec_u32(buf, off)
        m = cls(bs)
        for _ in range(n):
            b, off = denc.dec_u64(buf, off)
            crc, off = denc.dec_u32(buf, off)
            m.crc[b] = crc
        return m, off
