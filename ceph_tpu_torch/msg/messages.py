"""Typed messages over denc: declarative fields, auto round-trip.

The reference hand-writes encode_payload/decode_payload for 170 Message
subclasses (src/messages/, e.g. MOSDOp.h:37). Here a message declares
FIELDS = ((name, kind), ...) and the base class derives both directions
from utils.denc — one source of truth per message, bounded
decoding, no pickling.

Kinds: u8 u16 u32 u64 i32 i64 str bytes body, "list:<kind>",
"map:<k>:<v>", "pair:<a>:<b>", or a (encode, decode[, encode_bl]) tuple
for custom formats (decode takes (buf, off) -> (value, off); encode_bl
takes (value, BufferList) and appends wire segments without copying the
payload). Concrete messages live with their owning subsystem
(mon/osd/client) and self-register; the registry maps frame type ids
back to classes for dispatch.

Buffer plane (utils/buffer.py): "body" marks a big payload field —
it encodes into the frame BufferList as a VIEW (no copy; the field may
hold bytes, a memoryview, a contiguous ndarray, or a BufferList) and
decodes back out as a read-only memoryview over the frame buffer. All
other kinds keep their bytes semantics (oids and map keys must stay
hashable). ``encode_bl`` builds the whole message as segment views;
``encode`` is the flattened compat form. ``snapshot`` produces an
isolated structural copy that SHARES payload storage — what LocalBus
delivers in place of an encode+decode round-trip per hop.

ceph_tpu_torch's own copy of ``ceph_tpu/msg/messages.py``.
"""
from __future__ import annotations

from ..utils import denc
from ..utils.buffer import BufferList

_REGISTRY: dict[int, type["Message"]] = {}


def _enc_bytes_bl(v, bl: BufferList) -> None:
    """Length-prefixed bytes as wire segments: the 4-byte prefix is
    built, the payload rides as a view."""
    n = (len(v) if isinstance(v, (bytes, BufferList))
         else len(memoryview(v).cast("B")))
    bl.append(denc.enc_u32(n))
    if n:
        bl.append(v)


def _codec(kind):
    if isinstance(kind, tuple):
        return kind
    if kind.startswith("list:"):
        enc_i, dec_i = _codec(kind[5:])[:2]
        return (
            lambda v: denc.enc_list(v, enc_i),
            lambda b, o: denc.dec_list(b, o, dec_i),
        )
    if kind.startswith("map:"):
        k_kind, v_kind = kind[4:].split(":", 1)
        enc_k, dec_k = _codec(k_kind)[:2]
        enc_v, dec_v = _codec(v_kind)[:2]
        return (
            lambda d: denc.enc_map(d, enc_k, enc_v),
            lambda b, o: denc.dec_map(b, o, dec_k, dec_v),
        )
    if kind.startswith("pair:"):
        a_kind, b_kind = kind[5:].split(":", 1)
        enc_a, dec_a = _codec(a_kind)[:2]
        enc_b, dec_b = _codec(b_kind)[:2]

        def enc(p):
            return enc_a(p[0]) + enc_b(p[1])

        def dec(buf, off):
            a, off = dec_a(buf, off)
            b, off = dec_b(buf, off)
            return (a, b), off

        return enc, dec
    return {
        "u8": (denc.enc_u8, denc.dec_u8),
        "u16": (denc.enc_u16, denc.dec_u16),
        "u32": (denc.enc_u32, denc.dec_u32),
        "u64": (denc.enc_u64, denc.dec_u64),
        "i32": (denc.enc_i32, denc.dec_i32),
        "i64": (denc.enc_i64, denc.dec_i64),
        "str": (denc.enc_str, denc.dec_str),
        "bytes": (denc.enc_bytes, denc.dec_bytes, _enc_bytes_bl),
        # payload BODY: encodes as a view, decodes as a view (the
        # bufferlist seam — same wire format as "bytes")
        "body": (lambda v: denc.enc_bytes(bytes(v)),
                 denc.dec_bytes_view, _enc_bytes_bl),
    }[kind]


class Message:
    """Base message; subclasses set TYPE (unique u16) and FIELDS."""

    TYPE: int = 0
    FIELDS: tuple = ()

    #: optional per-field defaults (e.g. trace contexts) — lets a field
    #: be added to a message without touching every constructor site
    DEFAULTS: dict = {}

    def __init__(self, **kw):
        names = [n for n, _ in self.FIELDS]
        unknown = set(kw) - set(names)
        if unknown:
            raise TypeError(f"{type(self).__name__}: unknown fields {unknown}")
        for n, _ in self.FIELDS:
            if n not in kw:
                if n in self.DEFAULTS:
                    setattr(self, n, self.DEFAULTS[n])
                    continue
                raise TypeError(f"{type(self).__name__}: missing field {n!r}")
            setattr(self, n, kw[n])

    #: (name, enc, dec, enc_bl) per field, compiled once at
    #: registration — resolving the codec per field per message was
    #: measurable on the data path (round-5 profile)
    _CODECS: tuple = ()

    @classmethod
    def _compile_codecs(cls) -> None:
        compiled = []
        for name, kind in cls.FIELDS:
            c = _codec(kind)
            enc, dec = c[0], c[1]
            if len(c) > 2:
                enc_bl = c[2]
            else:
                def enc_bl(v, bl, _enc=enc):
                    bl.append(_enc(v))
            compiled.append((name, enc, dec, enc_bl))
        cls._CODECS = tuple(compiled)

    def encode(self) -> bytes:
        if len(self._CODECS) != len(self.FIELDS):
            type(self)._compile_codecs()
        return b"".join(
            enc(getattr(self, name)) for name, enc, _, _ in self._CODECS
        )

    def encode_bl(self, bl: BufferList | None = None) -> BufferList:
        """Encode into a BufferList: scalar fields marshal into small
        byte segments, payload bodies ("body" kind / BL-aware custom
        codecs) ride as views — no copy until the socket/WAL boundary
        flattens."""
        if len(self._CODECS) != len(self.FIELDS):
            type(self)._compile_codecs()
        if bl is None:
            bl = BufferList()
        for name, _enc, _dec, enc_bl in self._CODECS:
            enc_bl(getattr(self, name), bl)
        return bl

    @classmethod
    def decode(cls, buf: bytes, off: int = 0) -> "Message":
        if len(cls._CODECS) != len(cls.FIELDS):
            cls._compile_codecs()
        kw = {}
        for name, _, dec, _bl in cls._CODECS:
            kw[name], off = dec(buf, off)
        if off != len(buf):
            raise denc.DecodeError(
                f"{cls.__name__}: {len(buf) - off} trailing bytes"
            )
        return cls(**kw)

    def snapshot(self) -> "Message":
        """An isolated copy carrying THIS instant's field values:
        containers are structurally copied, payload storage (bytes /
        read-only views) is shared — the zero-copy stand-in for the
        encode+decode round-trip LocalBus used to pay per hop. The
        sender may keep mutating its own message (the client's MOSDOp
        resend path re-stamps ``epoch``) without the delivered copy
        ever seeing it. Falls back to a full marshal round-trip when a
        field holds something it cannot structurally copy."""
        cls = type(self)
        new = cls.__new__(cls)
        try:
            for n, _ in self.FIELDS:
                setattr(new, n, _snap_value(getattr(self, n)))
        except _Unsnapshottable:
            return decode_message(self.TYPE, self.encode())
        return new

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{n}={_short(getattr(self, n))}" for n, _ in self.FIELDS
        )
        return f"{type(self).__name__}({fields})"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for n, _ in self.FIELDS
        )


class _Unsnapshottable(Exception):
    pass


#: leaf types a snapshot shares by reference: immutable, so aliasing
#: between the sender's retained message and the delivered copy is safe
_SNAP_LEAVES = (bytes, str, int, float, bool, type(None), frozenset)


def _snap_value(v):
    """Structural copy for Message.snapshot: containers copied one
    level at a time, payload storage shared. A bytearray is the one
    mutable leaf the wire kinds admit — snapshotted to bytes."""
    if isinstance(v, _SNAP_LEAVES):
        return v
    if isinstance(v, tuple):
        return tuple(_snap_value(x) for x in v)
    if isinstance(v, list):
        return [_snap_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _snap_value(x) for k, x in v.items()}
    if isinstance(v, memoryview):
        return v.toreadonly()
    if isinstance(v, bytearray):
        return bytes(v)
    if isinstance(v, BufferList):
        return v.snapshot()
    raise _Unsnapshottable(type(v).__name__)


def _short(v):
    if isinstance(v, (bytes, bytearray)) and len(v) > 16:
        return f"<{len(v)}B>"
    r = repr(v)
    return r if len(r) <= 48 else r[:45] + "..."


def register_message(cls: type[Message]) -> type[Message]:
    if cls.TYPE in _REGISTRY and _REGISTRY[cls.TYPE] is not cls:
        raise ValueError(
            f"message type {cls.TYPE} already bound to "
            f"{_REGISTRY[cls.TYPE].__name__}"
        )
    cls._compile_codecs()
    _REGISTRY[cls.TYPE] = cls
    return cls


def decode_message(ftype: int, payload: bytes) -> Message:
    cls = _REGISTRY.get(ftype)
    if cls is None:
        raise denc.DecodeError(f"unknown message type {ftype}")
    return cls.decode(payload)
