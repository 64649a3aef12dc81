"""Length-prefixed, CRC32C-protected frames (the msgr2 frames_v2 role).

Layout (little-endian, reference frames_v2.h:94-145 compressed to one
segment on the wire — scatter/gather now lives ABOVE the layout: a
frame encodes into a BufferList whose payload segments are views over
the sender's storage, and flattens exactly once at the socket):

    magic   u32   0x43545046 ("FPTC" LE)
    type    u16   message type id
    flags   u16   reserved
    length  u32   payload byte count
    payload bytes
    crc     u32   CRC32C(seed 0xFFFFFFFF) over type..payload

The CRC uses the same Castagnoli core as everything else in the tree
(host: native/ct_native.cc SSE4.2 path; device: ops/crc32c.py), so a
frame captured on the wire can be batch-verified on TPU. Encoding
chains the CRC across segments (crc32c(a+b) == crc32c(b, seed=
crc32c(a)) — no pre/post conditioning in the core), so the payload is
never concatenated just to checksum it; decoding checksums and returns
the payload as views over the receive buffer.

ceph_tpu_torch's own copy of ``ceph_tpu/msg/frames.py``.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

from .. import native
from ..utils.buffer import BufferList

MAGIC = 0x43545046
_HDR = struct.Struct("<IHHI")
CRC_SEED = 0xFFFFFFFF


class FrameError(Exception):
    pass


@dataclass
class Frame:
    type: int
    #: bytes on the decode side of cold paths; a memoryview (view over
    #: the receive buffer) from decode_frame; bytes | memoryview |
    #: BufferList on the encode side
    payload: bytes
    flags: int = 0


def encode_frame_bl(f: Frame) -> BufferList:
    """Frame -> BufferList [hdr, payload segments..., crc]: payload
    views ride through untouched; the CRC chains across segments."""
    body = f.payload if isinstance(f.payload, BufferList) \
        else BufferList(f.payload)
    hdr = _HDR.pack(MAGIC, f.type, f.flags, len(body))
    crc = native.crc32c(hdr[4:], seed=CRC_SEED)
    for seg in body.segments():
        crc = native.crc32c(seg, seed=crc)
    out = BufferList(hdr)
    out.append(body)
    out.append(struct.pack("<I", crc))
    return out


def encode_frame(f: Frame) -> bytes:
    """Flattened compat form (auth handshakes, tests, signed frames —
    anything that needs the whole frame as one buffer)."""
    return bytes(encode_frame_bl(f))


def decode_frame(buf: bytes | memoryview) -> tuple[Frame, int]:
    """-> (frame, bytes consumed). Raises FrameError on corruption,
    IncompleteFrame if more bytes are needed. The returned payload is
    a read-only VIEW over ``buf`` (zero-copy); callers that outlive
    the buffer or need bytes semantics materialize it themselves."""
    if len(buf) < _HDR.size:
        raise IncompleteFrame(_HDR.size)
    magic, ftype, flags, length = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic:#x}")
    total = _HDR.size + length + 4
    if len(buf) < total:
        raise IncompleteFrame(total)
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    payload = mv[_HDR.size : _HDR.size + length].toreadonly()
    (crc,) = struct.unpack_from("<I", buf, _HDR.size + length)
    want = native.crc32c(mv[4 : _HDR.size + length], seed=CRC_SEED)
    if crc != want:
        raise FrameError(f"crc mismatch {crc:#x} != {want:#x}")
    return Frame(ftype, payload, flags), total


class IncompleteFrame(FrameError):
    """Need at least .needed bytes to decode."""

    def __init__(self, needed: int):
        super().__init__(f"need {needed} bytes")
        self.needed = needed
