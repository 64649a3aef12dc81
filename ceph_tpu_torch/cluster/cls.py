"""cls object classes: server-side stored procedures executed inside
the OSD's op vector (the src/objclass + src/cls + osd/ClassHandler
roles).

A class method registers as (cls, method, flags) -> handler(ctx, in) ->
out bytes; clients invoke it with the "call" op. The handler sees the
object through ClsContext — the objclass API surface (read/write/
xattr/omap/exists) — against the op vector's working state, so class
mutations commit atomically with the rest of the vector and read ops
inside the vector observe them.

Built-in classes mirror the reference's most-used ones:
- ``lock``: advisory object locks (cls_lock role) — exclusive/shared
  with owner+cookie, lock/unlock/break_lock/get_info.
- ``refcount``: tag-based reference counting (cls_refcount role) —
  get/put, object removal when the last tag drops.
- ``version``: per-object version counter with compare gates
  (cls_version role).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/cls.py``.
"""
from __future__ import annotations

import time

from ..utils import denc

RD = 1
WR = 2


class ClsError(Exception):
    def __init__(self, code: int, what: str = ""):
        super().__init__(what or str(code))
        self.code = code


_EBUSY = -16
_ENOENT = -2
_EINVAL = -22
_ECANCELED = -125

_REGISTRY: dict[tuple[str, str], tuple] = {}


def register(cls: str, method: str, flags: int):
    """@register("lock", "lock", RD | WR) — the cls_register_cxx_method
    role."""

    def deco(fn):
        _REGISTRY[(cls, method)] = (fn, flags)
        return fn

    return deco


def lookup(cls: str, method: str):
    return _REGISTRY.get((cls, method))


def methods() -> list[str]:
    return sorted(f"{c}.{m}" for c, m in _REGISTRY)


class ClsContext:
    """objclass API over the op vector's working object state."""

    def __init__(self, state: dict, exists: bool):
        self._state = state
        self.exists = exists
        self.mutated = False
        self.removed = False

    # -------------------------------------------------------- data ops

    def read(self, offset: int = 0, length: int = -1) -> bytes:
        data = self._state["data"]
        if length < 0:
            return bytes(data[offset:])
        return bytes(data[offset : offset + length])

    def write_full(self, data: bytes) -> None:
        self._state["data"][:] = data
        self.mutated = True

    def remove(self) -> None:
        self.removed = True
        self.mutated = True

    def stat(self) -> int:
        return len(self._state["data"])

    # ------------------------------------------------------- xattr ops

    def getxattr(self, key: str) -> bytes | None:
        return self._state["xattrs"].get(key)

    def setxattr(self, key: str, value: bytes) -> None:
        self._state["xattrs"][key] = bytes(value)
        self.mutated = True

    def rmxattr(self, key: str) -> None:
        self._state["xattrs"].pop(key, None)
        self.mutated = True

    # -------------------------------------------------------- omap ops

    def omap_get(self, key: bytes) -> bytes | None:
        return self._state["omap"].get(bytes(key))

    def omap_set(self, key: bytes, value: bytes) -> None:
        self._state["omap"][bytes(key)] = bytes(value)
        self.mutated = True

    def omap_rm(self, key: bytes) -> None:
        self._state["omap"].pop(bytes(key), None)
        self.mutated = True

    def omap_keys(self) -> list[bytes]:
        return sorted(self._state["omap"])

    def omap_get_header(self) -> bytes:
        return self._state["omap_header"]

    def omap_set_header(self, header: bytes) -> None:
        self._state["omap_header"] = bytes(header)
        self.mutated = True


# ===================================================== built-in: lock


def _lock_attr(name: str) -> str:
    return f"lock.{name}"


def _enc_lock(ltype: str,
              holders: list[tuple[str, str, int]]) -> bytes:
    """Holder = (owner, cookie, expiry_ms). expiry_ms == 0 means the
    lock never expires (cls_lock's duration=0 semantics)."""
    return denc.enc_str(ltype) + denc.enc_list(
        holders,
        lambda h: (denc.enc_str(h[0]) + denc.enc_str(h[1])
                   + denc.enc_u64(h[2])),
    )


def _dec_lock(b: bytes):
    ltype, off = denc.dec_str(b, 0)

    def one(buf, o):
        owner, o = denc.dec_str(buf, o)
        cookie, o = denc.dec_str(buf, o)
        expiry, o = denc.dec_u64(buf, o)
        return (owner, cookie, expiry), o

    holders, _ = denc.dec_list(b, off, one)
    return ltype, holders


def _live_holders(holders):
    """Drop expired holders (cls_lock duration role): a holder that
    never renewed past its expiry no longer holds anything — this is
    what makes a SIGKILLed lock owner self-healing."""
    now_ms = int(time.time() * 1000)
    return [h for h in holders if h[2] == 0 or h[2] > now_ms]


@register("lock", "lock", RD | WR)
def lock_lock(ctx: ClsContext, inp: bytes) -> bytes:
    """input: name, type("exclusive"|"shared"), owner, cookie
    [, duration_ms] — a nonzero duration makes the grant auto-expire
    unless renewed (re-locking with the same owner+cookie refreshes
    the expiry, the renewal arc)."""
    name, off = denc.dec_str(inp, 0)
    ltype, off = denc.dec_str(inp, off)
    owner, off = denc.dec_str(inp, off)
    cookie, off = denc.dec_str(inp, off)
    duration_ms = 0
    if off < len(inp):
        duration_ms, off = denc.dec_u64(inp, off)
    expiry = (int(time.time() * 1000) + duration_ms
              if duration_ms else 0)
    if ltype not in ("exclusive", "shared"):
        raise ClsError(_EINVAL, f"lock type {ltype!r}")
    raw = ctx.getxattr(_lock_attr(name))
    holders = _live_holders(_dec_lock(raw)[1]) if raw else []
    cur_type = _dec_lock(raw)[0] if raw else ltype
    mine = [h for h in holders if (h[0], h[1]) == (owner, cookie)]
    if mine:
        holders.remove(mine[0])  # renewal: refresh the expiry below
    elif holders and (cur_type == "exclusive" or ltype == "exclusive"):
        raise ClsError(_EBUSY, f"lock {name} held")
    holders.append((owner, cookie, expiry))
    ctx.setxattr(_lock_attr(name),
                 _enc_lock(cur_type if holders[:-1] else ltype,
                           holders))
    return b""


@register("lock", "unlock", RD | WR)
def lock_unlock(ctx: ClsContext, inp: bytes) -> bytes:
    name, off = denc.dec_str(inp, 0)
    owner, off = denc.dec_str(inp, off)
    cookie, _ = denc.dec_str(inp, off)
    raw = ctx.getxattr(_lock_attr(name))
    if raw is None:
        raise ClsError(_ENOENT, f"lock {name}")
    ltype, holders = _dec_lock(raw)
    holders = _live_holders(holders)
    mine = [h for h in holders if (h[0], h[1]) == (owner, cookie)]
    if not mine:
        raise ClsError(_ENOENT, f"{owner}/{cookie} does not hold {name}")
    holders.remove(mine[0])
    if holders:
        ctx.setxattr(_lock_attr(name), _enc_lock(ltype, holders))
    else:
        ctx.rmxattr(_lock_attr(name))
    return b""


@register("lock", "break_lock", RD | WR)
def lock_break(ctx: ClsContext, inp: bytes) -> bytes:
    name, off = denc.dec_str(inp, 0)
    owner, _ = denc.dec_str(inp, off)
    raw = ctx.getxattr(_lock_attr(name))
    if raw is None:
        raise ClsError(_ENOENT, f"lock {name}")
    ltype, holders = _dec_lock(raw)
    holders = _live_holders(holders)
    keep = [h for h in holders if h[0] != owner]
    if len(keep) == len(holders):
        raise ClsError(_ENOENT, f"{owner} holds nothing on {name}")
    if keep:
        ctx.setxattr(_lock_attr(name), _enc_lock(ltype, keep))
    else:
        ctx.rmxattr(_lock_attr(name))
    return b""


@register("lock", "get_info", RD)
def lock_get_info(ctx: ClsContext, inp: bytes) -> bytes:
    name, _ = denc.dec_str(inp, 0)
    raw = ctx.getxattr(_lock_attr(name))
    if raw is None:
        return _enc_lock("none", [])
    ltype, holders = _dec_lock(raw)
    live = _live_holders(holders)
    return _enc_lock(ltype if live else "none", live)


# ================================================= built-in: refcount


_REF_ATTR = "refcount"


@register("refcount", "get", RD | WR)
def refcount_get(ctx: ClsContext, inp: bytes) -> bytes:
    tag, _ = denc.dec_str(inp, 0)
    raw = ctx.getxattr(_REF_ATTR) or denc.enc_list([], denc.enc_str)
    tags, _ = denc.dec_list(raw, 0, denc.dec_str)
    if tag not in tags:
        tags.append(tag)
        ctx.setxattr(_REF_ATTR, denc.enc_list(tags, denc.enc_str))
    return b""


@register("refcount", "put", RD | WR)
def refcount_put(ctx: ClsContext, inp: bytes) -> bytes:
    tag, _ = denc.dec_str(inp, 0)
    raw = ctx.getxattr(_REF_ATTR)
    if raw is None:
        # untagged object: a put removes it (reference behavior for
        # the implicit ref)
        ctx.remove()
        return b""
    tags, _ = denc.dec_list(raw, 0, denc.dec_str)
    if tag not in tags:
        raise ClsError(_ENOENT, f"tag {tag!r}")
    tags.remove(tag)
    if tags:
        ctx.setxattr(_REF_ATTR, denc.enc_list(tags, denc.enc_str))
    else:
        ctx.remove()  # last reference dropped
    return b""


@register("refcount", "read", RD)
def refcount_read(ctx: ClsContext, inp: bytes) -> bytes:
    raw = ctx.getxattr(_REF_ATTR) or denc.enc_list([], denc.enc_str)
    return raw


# ================================================== built-in: version


_VER_ATTR = "objver"


@register("version", "set", RD | WR)
def version_set(ctx: ClsContext, inp: bytes) -> bytes:
    ver, _ = denc.dec_u64(inp, 0)
    ctx.setxattr(_VER_ATTR, denc.enc_u64(ver))
    return b""


@register("version", "inc", RD | WR)
def version_inc(ctx: ClsContext, inp: bytes) -> bytes:
    raw = ctx.getxattr(_VER_ATTR)
    cur = denc.dec_u64(raw, 0)[0] if raw else 0
    ctx.setxattr(_VER_ATTR, denc.enc_u64(cur + 1))
    return b""


@register("version", "read", RD)
def version_read(ctx: ClsContext, inp: bytes) -> bytes:
    raw = ctx.getxattr(_VER_ATTR)
    return raw if raw is not None else denc.enc_u64(0)


@register("version", "check_eq", RD)
def version_check_eq(ctx: ClsContext, inp: bytes) -> bytes:
    want, _ = denc.dec_u64(inp, 0)
    raw = ctx.getxattr(_VER_ATTR)
    cur = denc.dec_u64(raw, 0)[0] if raw else 0
    if cur != want:
        raise ClsError(_ECANCELED, f"version {cur} != {want}")
    return b""


# ================================================== built-in: journal


@register("journal", "trim", RD | WR)
def journal_trim(ctx: ClsContext, inp: bytes) -> bytes:
    """Atomically drop journal history before a LOGICAL offset: rewrite
    the record stream and advance the `journal.base` xattr in one op
    (the Journaler trim role). Server-side because a client-side
    read-modify-writefull would race concurrent appends and destroy
    records landed between the read and the write."""
    upto, _ = denc.dec_u64(inp, 0)
    raw = ctx.getxattr("journal.base")
    base = denc.dec_u64(raw, 0)[0] if raw else 0
    cut = upto - base
    if cut <= 0:
        return b""
    data = ctx.read()
    if cut > len(data):
        raise ClsError(_EINVAL, f"trim {upto} past tail {base + len(data)}")
    ctx.write_full(data[cut:])
    ctx.setxattr("journal.base", denc.enc_u64(upto))
    return b""


# ================================================== built-in: rgw
#
# The cls_rgw role (src/cls/rgw/): the bucket index lives in the index
# object's omap and every update is a SERVER-SIDE method, so the entry
# write and the bucket-stats accounting commit in one atomic op vector
# — a client-side omap update could never keep stats consistent under
# concurrent writers. Entry format contract (services/rgw.py
# _enc_entry): the first 8 bytes are the LE u64 object size; the rest
# is opaque to this class.

_RGW_STATS_HDR = 24  # header: u64 count, u64 bytes, u64 generation


def _rgw_stats(ctx: ClsContext) -> tuple[int, int, int]:
    hdr = ctx.omap_get_header()
    if len(hdr) < _RGW_STATS_HDR:
        return (0, 0, 0)
    count, off = denc.dec_u64(hdr, 0)
    nbytes, off = denc.dec_u64(hdr, off)
    gen, _ = denc.dec_u64(hdr, off)
    return (count, nbytes, gen)


def _rgw_put_stats(ctx: ClsContext, count: int, nbytes: int,
                   gen: int) -> None:
    ctx.omap_set_header(denc.enc_u64(count) + denc.enc_u64(nbytes)
                        + denc.enc_u64(gen))


@register("rgw", "index_update", RD | WR)
def rgw_index_update(ctx: ClsContext, inp: bytes) -> bytes:
    """One bucket-index mutation: op 0 = put (key, entry), 1 = delete
    (key). Maintains the stats header atomically with the entry."""
    op, off = denc.dec_u8(inp, 0)
    key, off = denc.dec_bytes(inp, off)
    count, nbytes, gen = _rgw_stats(ctx)
    old = ctx.omap_get(key)
    if old is not None:
        count -= 1
        nbytes -= denc.dec_u64(old, 0)[0]
    if op == 0:
        entry, off = denc.dec_bytes(inp, off)
        ctx.omap_set(key, entry)
        count += 1
        nbytes += denc.dec_u64(entry, 0)[0]
    elif op == 1:
        if old is None:
            raise ClsError(_ENOENT, key.decode(errors="replace"))
        ctx.omap_rm(key)
    else:
        raise ClsError(_EINVAL, f"rgw op {op}")
    _rgw_put_stats(ctx, max(count, 0), max(nbytes, 0), gen + 1)
    return b""


@register("rgw", "index_get", RD)
def rgw_index_get(ctx: ClsContext, inp: bytes) -> bytes:
    key, _ = denc.dec_bytes(inp, 0)
    entry = ctx.omap_get(key)
    if entry is None:
        raise ClsError(_ENOENT, key.decode(errors="replace"))
    return entry


@register("rgw", "index_list", RD)
def rgw_index_list(ctx: ClsContext, inp: bytes) -> bytes:
    """Server-side filtered listing (ListObjectsV2 engine): input
    (prefix, marker, max u32) -> enc_list of (key, entry) + u8
    truncated. Filtering at the OSD keeps the wire O(page), not
    O(bucket)."""
    prefix, off = denc.dec_bytes(inp, off := 0)
    marker, off = denc.dec_bytes(inp, off)
    maxk, off = denc.dec_u32(inp, off)
    keys = [k for k in ctx.omap_keys()  # omap_keys is already sorted
            if k.startswith(prefix) and k > marker]
    page = keys[:maxk]
    truncated = len(keys) > maxk
    out = [denc.enc_u32(len(page))]
    for k in page:
        out.append(denc.enc_bytes(k))
        out.append(denc.enc_bytes(ctx.omap_get(k)))
    out.append(denc.enc_u8(1 if truncated else 0))
    return b"".join(out)


@register("rgw", "bucket_stats", RD)
def rgw_bucket_stats(ctx: ClsContext, inp: bytes) -> bytes:
    count, nbytes, gen = _rgw_stats(ctx)
    return denc.enc_u64(count) + denc.enc_u64(nbytes) + denc.enc_u64(gen)


# ============================================ built-in: rgw datalog
#
# The cls_log/rgw_datalog role (src/cls/log/, src/rgw/driver/rados/
# rgw_datalog.cc): an append-only change log whose sequence counter
# lives in the log object's omap header, so allocation of the next seq
# and the entry write commit atomically — concurrent writers can never
# mint the same seq. Entries are opaque to this class; keys are
# 16-hex-digit seqs so omap order IS log order.


def _datalog_head(ctx: ClsContext) -> int:
    hdr = ctx.omap_get_header()
    return denc.dec_u64(hdr, 0)[0] if len(hdr) >= 8 else 0


@register("rgw", "datalog_add", RD | WR)
def rgw_datalog_add(ctx: ClsContext, inp: bytes) -> bytes:
    seq = _datalog_head(ctx)
    ctx.omap_set(f"{seq:016x}".encode(), inp)
    ctx.omap_set_header(denc.enc_u64(seq + 1))
    return denc.enc_u64(seq)


@register("rgw", "datalog_list", RD)
def rgw_datalog_list(ctx: ClsContext, inp: bytes) -> bytes:
    """Input (from_seq u64, max u32) -> u64 head (next seq to be
    minted), enc_u32 n, n x (u64 seq, enc_bytes entry), u8 truncated.
    ``head`` lets a syncer snapshot "where the log ends NOW" before a
    full sync, closing the bootstrap gap."""
    from_seq, off = denc.dec_u64(inp, 0)
    maxn, _ = denc.dec_u32(inp, off)
    lo = f"{from_seq:016x}".encode()
    keys = [k for k in ctx.omap_keys() if k >= lo]
    page = keys[:maxn]
    out = [denc.enc_u64(_datalog_head(ctx)), denc.enc_u32(len(page))]
    for k in page:
        out.append(denc.enc_u64(int(k, 16)))
        out.append(denc.enc_bytes(ctx.omap_get(k)))
    out.append(denc.enc_u8(1 if len(keys) > maxn else 0))
    return b"".join(out)


@register("rgw", "datalog_trim", RD | WR)
def rgw_datalog_trim(ctx: ClsContext, inp: bytes) -> bytes:
    """Drop entries with seq < upto (applied history; the head counter
    never rewinds)."""
    upto, _ = denc.dec_u64(inp, 0)
    hi = f"{upto:016x}".encode()
    for k in ctx.omap_keys():
        if k < hi:
            ctx.omap_rm(k)
        else:
            break
    return b""
