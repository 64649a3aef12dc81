"""Transaction: the redo-log of object store mutations.

Mirrors the reference op set (src/os/Transaction.h:110-155) with the ops
the data path needs: touch/write/zero/truncate/remove, xattr ops, clone
and clone_range, collection create/remove, and the omap family. A
Transaction is a list of op records built by fluent methods and applied
atomically by an ObjectStore (all-or-nothing, in order).

ceph_tpu_torch's own copy of ``ceph_tpu/store/transaction.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

from ..utils.buffer import BufferList, as_view

# opcodes (names mirror Transaction.h)
OP_TOUCH = "touch"
OP_WRITE = "write"
OP_ZERO = "zero"
OP_TRUNCATE = "truncate"
OP_REMOVE = "remove"
OP_SETATTR = "setattr"
OP_SETATTRS = "setattrs"
OP_RMATTR = "rmattr"
OP_RMATTRS = "rmattrs"
OP_CLONE = "clone"
OP_CLONERANGE = "clone_range"
OP_MKCOLL = "mkcoll"
OP_RMCOLL = "rmcoll"
OP_SPLIT_COLL = "split_coll"
OP_MERGE_COLL = "merge_coll"
OP_SETALLOCHINT = "set_alloc_hint"
OP_OMAP_CLEAR = "omap_clear"
OP_OMAP_SETKEYS = "omap_setkeys"
OP_OMAP_RMKEYS = "omap_rmkeys"
OP_OMAP_RMKEYRANGE = "omap_rmkeyrange"
OP_OMAP_SETHEADER = "omap_setheader"


@dataclass
class Op:
    code: str
    cid: str
    oid: bytes | None = None
    args: dict[str, Any] = field(default_factory=dict)


@dataclass
class Transaction:
    """Ordered mutation log; composable via append()."""

    ops: list[Op] = field(default_factory=list)

    def _add(self, code: str, cid: str, oid: bytes | None = None, **args):
        self.ops.append(Op(code, cid, oid, args))
        return self

    # ------------------------------------------------------------ data ops

    def touch(self, cid: str, oid: bytes):
        return self._add(OP_TOUCH, cid, oid)

    def write(self, cid: str, oid: bytes, offset: int, data):
        """``data`` may be bytes, a memoryview, a contiguous ndarray,
        or a BufferList — views ride the transaction un-copied (the
        bufferlist stance); stores materialize at their own durability
        boundary. A bytearray is snapshotted (its owner may mutate)."""
        return self._add(OP_WRITE, cid, oid, offset=offset,
                         data=_as_payload(data))

    def zero(self, cid: str, oid: bytes, offset: int, length: int):
        return self._add(OP_ZERO, cid, oid, offset=offset, length=length)

    def truncate(self, cid: str, oid: bytes, size: int):
        return self._add(OP_TRUNCATE, cid, oid, size=size)

    def remove(self, cid: str, oid: bytes):
        return self._add(OP_REMOVE, cid, oid)

    def clone(self, cid: str, oid: bytes, dest: bytes):
        return self._add(OP_CLONE, cid, oid, dest=dest)

    def clone_range(
        self, cid: str, oid: bytes, dest: bytes,
        src_off: int, length: int, dst_off: int,
    ):
        return self._add(
            OP_CLONERANGE, cid, oid, dest=dest,
            src_off=src_off, length=length, dst_off=dst_off,
        )

    # ----------------------------------------------------------- xattr ops

    def setattr(self, cid: str, oid: bytes, name: str, value: bytes):
        return self._add(OP_SETATTR, cid, oid, name=name, value=bytes(value))

    def setattrs(self, cid: str, oid: bytes, attrs: dict[str, bytes]):
        return self._add(
            OP_SETATTRS, cid, oid,
            attrs={k: bytes(v) for k, v in attrs.items()},
        )

    def rmattr(self, cid: str, oid: bytes, name: str):
        return self._add(OP_RMATTR, cid, oid, name=name)

    def rmattrs(self, cid: str, oid: bytes):
        return self._add(OP_RMATTRS, cid, oid)

    # ------------------------------------------------------ collection ops

    def create_collection(self, cid: str):
        return self._add(OP_MKCOLL, cid)

    def remove_collection(self, cid: str):
        return self._add(OP_RMCOLL, cid)

    def split_collection(self, cid: str, bits: int, rem: int, dest: str):
        """PG split (Transaction::split_collection role): objects whose
        hash matches `rem` under a `bits`-wide mask move to `dest`."""
        return self._add(OP_SPLIT_COLL, cid, bits=bits, rem=rem,
                         dest_cid=dest)

    def merge_collection(self, cid: str, dest: str, bits: int = 0):
        """PG merge: every object of `cid` moves into `dest`, then
        `cid` is removed (Transaction::merge_collection role)."""
        return self._add(OP_MERGE_COLL, cid, bits=bits, dest_cid=dest)

    def set_alloc_hint(self, cid: str, oid: bytes,
                       expected_object_size: int,
                       expected_write_size: int, flags: int = 0):
        """Advisory allocation hint (OP_SETALLOCHINT role): recorded on
        the object for allocator-aware stores."""
        return self._add(OP_SETALLOCHINT, cid, oid,
                         expected_object_size=expected_object_size,
                         expected_write_size=expected_write_size,
                         flags=flags)

    # ------------------------------------------------------------ omap ops

    def omap_clear(self, cid: str, oid: bytes):
        return self._add(OP_OMAP_CLEAR, cid, oid)

    def omap_setkeys(self, cid: str, oid: bytes, kv: dict[bytes, bytes]):
        return self._add(
            OP_OMAP_SETKEYS, cid, oid,
            kv={bytes(k): bytes(v) for k, v in kv.items()},
        )

    def omap_rmkeys(self, cid: str, oid: bytes, keys: Iterable[bytes]):
        return self._add(OP_OMAP_RMKEYS, cid, oid, keys=[bytes(k) for k in keys])

    def omap_rmkeyrange(self, cid: str, oid: bytes, first: bytes, last: bytes):
        return self._add(
            OP_OMAP_RMKEYRANGE, cid, oid, first=bytes(first), last=bytes(last)
        )

    def omap_setheader(self, cid: str, oid: bytes, header: bytes):
        return self._add(OP_OMAP_SETHEADER, cid, oid, header=bytes(header))

    # -------------------------------------------------------------- compose

    def append(self, other: "Transaction"):
        self.ops.extend(other.ops)
        return self

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def empty(self) -> bool:
        return not self.ops

    # --------------------------------------------------------------- wire

    def encode(self) -> bytes:
        """Explicit LE binary form (the denc role) for WAL/wire."""
        return bytes(self.encode_bl())

    def encode_bl(self, bl: BufferList | None = None) -> BufferList:
        """Wire/WAL form as a BufferList: op headers and small args
        marshal into byte segments, OP_WRITE payloads ride as views —
        the flatten happens at the WAL fsync / socket boundary, not
        here."""
        from ..utils import denc

        if bl is None:
            bl = BufferList()
        bl.append(denc.enc_u32(len(self.ops)))
        for op in self.ops:
            head = b"".join((
                denc.enc_str(op.code),
                denc.enc_str(op.cid),
                denc.enc_bytes(op.oid if op.oid is not None else b""),
                denc.enc_u8(op.oid is not None),
            ))
            if op.code == OP_WRITE:
                # schema order (offset, data): the data body is a view
                data = op.args["data"]
                n = len(data)
                bl.append(head + denc.enc_u64(op.args["offset"])
                          + denc.enc_u32(n))
                if n:
                    bl.append(data)
            else:
                bl.append(head + _encode_args(op.code, op.args))
        return bl

    @classmethod
    def decode(cls, buf: bytes, off: int = 0) -> tuple["Transaction", int]:
        from ..utils import denc

        n, off = denc.dec_u32(buf, off)
        t = cls()
        for _ in range(n):
            code, off = denc.dec_str(buf, off)
            cid, off = denc.dec_str(buf, off)
            oid, off = denc.dec_bytes(buf, off)
            has_oid, off = denc.dec_u8(buf, off)
            args, off = _decode_args(code, buf, off)
            t.ops.append(Op(code, cid, oid if has_oid else None, args))
        return t, off


def _as_payload(data):
    """Normalize a write payload to something with byte ``len()`` that
    the transaction can hold without copying: bytes and BufferList pass
    through, everything else goes through the buffer plane's one
    normalization (flat read-only view; bytearray snapshotted;
    non-contiguous storage rejected at the producer)."""
    if isinstance(data, (bytes, BufferList)):
        return data
    return as_view(data)


# arg schemas: name -> (encoder, decoder) pairs per op code
def _arg_schema():
    from ..utils import denc

    b = (denc.enc_bytes, denc.dec_bytes)
    s = (denc.enc_str, denc.dec_str)
    u = (denc.enc_u64, denc.dec_u64)
    kvmap = (
        lambda d: denc.enc_map(d, denc.enc_bytes, denc.enc_bytes),
        lambda buf, off: denc.dec_map(buf, off, denc.dec_bytes, denc.dec_bytes),
    )
    strmap = (
        lambda d: denc.enc_map(d, denc.enc_str, denc.enc_bytes),
        lambda buf, off: denc.dec_map(buf, off, denc.dec_str, denc.dec_bytes),
    )
    keylist = (
        lambda xs: denc.enc_list(xs, denc.enc_bytes),
        lambda buf, off: denc.dec_list(buf, off, denc.dec_bytes),
    )
    return {
        OP_TOUCH: {},
        OP_WRITE: {"offset": u, "data": b},
        OP_ZERO: {"offset": u, "length": u},
        OP_TRUNCATE: {"size": u},
        OP_REMOVE: {},
        OP_SETATTR: {"name": s, "value": b},
        OP_SETATTRS: {"attrs": strmap},
        OP_RMATTR: {"name": s},
        OP_RMATTRS: {},
        OP_CLONE: {"dest": b},
        OP_CLONERANGE: {"dest": b, "src_off": u, "length": u, "dst_off": u},
        OP_MKCOLL: {},
        OP_RMCOLL: {},
        OP_SPLIT_COLL: {"bits": u, "rem": u, "dest_cid": s},
        OP_MERGE_COLL: {"bits": u, "dest_cid": s},
        OP_SETALLOCHINT: {"expected_object_size": u,
                          "expected_write_size": u, "flags": u},
        OP_OMAP_CLEAR: {},
        OP_OMAP_SETKEYS: {"kv": kvmap},
        OP_OMAP_RMKEYS: {"keys": keylist},
        OP_OMAP_RMKEYRANGE: {"first": b, "last": b},
        OP_OMAP_SETHEADER: {"header": b},
    }


_SCHEMA_CACHE = None


def _schema():
    global _SCHEMA_CACHE
    if _SCHEMA_CACHE is None:
        _SCHEMA_CACHE = _arg_schema()
    return _SCHEMA_CACHE


def _encode_args(code: str, args: dict) -> bytes:
    schema = _schema()[code]
    return b"".join(schema[name][0](args[name]) for name in schema)


def _decode_args(code: str, buf: bytes, off: int):
    schema = _schema()[code]
    args = {}
    for name, (_, dec) in schema.items():
        args[name], off = dec(buf, off)
    return args, off
