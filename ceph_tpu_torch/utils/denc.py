"""Little-endian binary encoding (the reference's denc.h/encoding.h role).

Explicit wire/disk formats instead of pickles: fixed-width LE ints,
length-prefixed bytes/strings, and homogeneous containers. Every encoder
has a matching bounded decoder; decoders take (buf, offset) and return
(value, new_offset) so records compose without copying.
"""
from __future__ import annotations

import struct

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")


class DecodeError(Exception):
    pass


def _pack(st: struct.Struct, v: int) -> bytes:
    return st.pack(v)


def _unpack(st: struct.Struct, buf, off: int):
    if off + st.size > len(buf):
        raise DecodeError(f"short buffer at {off}")
    return st.unpack_from(buf, off)[0], off + st.size


def enc_u8(v):
    return _pack(_U8, v)


def enc_u16(v):
    return _pack(_U16, v)


def enc_u32(v):
    return _pack(_U32, v)


def enc_u64(v):
    return _pack(_U64, v)


def enc_i32(v):
    return _pack(_I32, v)


def enc_i64(v):
    return _pack(_I64, v)


def dec_u8(buf, off):
    return _unpack(_U8, buf, off)


def dec_u16(buf, off):
    return _unpack(_U16, buf, off)


def dec_u32(buf, off):
    return _unpack(_U32, buf, off)


def dec_u64(buf, off):
    return _unpack(_U64, buf, off)


def dec_i32(buf, off):
    return _unpack(_I32, buf, off)


def dec_i64(buf, off):
    return _unpack(_I64, buf, off)


def enc_bytes(b: bytes) -> bytes:
    b = bytes(b)
    return _U32.pack(len(b)) + b


def dec_bytes(buf, off):
    n, off = dec_u32(buf, off)
    if off + n > len(buf):
        raise DecodeError(f"short bytes at {off} (want {n})")
    return bytes(buf[off : off + n]), off + n


def dec_bytes_view(buf, off):
    """Zero-copy variant of :func:`dec_bytes` for payload BODIES (the
    bufferlist stance): returns a read-only memoryview over ``buf``
    instead of a copied ``bytes``. The view pins ``buf`` alive; cold
    paths call ``bytes()`` on it at their own boundary."""
    n, off = dec_u32(buf, off)
    if off + n > len(buf):
        raise DecodeError(f"short bytes at {off} (want {n})")
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    return mv[off : off + n].toreadonly(), off + n


def enc_str(s: str) -> bytes:
    return enc_bytes(s.encode())


def dec_str(buf, off):
    b, off = dec_bytes(buf, off)
    return b.decode(), off


def enc_list(items, enc) -> bytes:
    out = [_U32.pack(len(items))]
    out += [enc(i) for i in items]
    return b"".join(out)


def dec_list(buf, off, dec):
    n, off = dec_u32(buf, off)
    items = []
    for _ in range(n):
        v, off = dec(buf, off)
        items.append(v)
    return items, off


def enc_map(d: dict, enc_k, enc_v) -> bytes:
    out = [_U32.pack(len(d))]
    for k, v in d.items():
        out.append(enc_k(k))
        out.append(enc_v(v))
    return b"".join(out)


def dec_map(buf, off, dec_k, dec_v):
    n, off = dec_u32(buf, off)
    d = {}
    for _ in range(n):
        k, off = dec_k(buf, off)
        v, off = dec_v(buf, off)
        d[k] = v
    return d, off
