"""ObjectCacher: client-side write-back / read-ahead object cache (the
src/osdc/ObjectCacher.h:52 role, used by librbd and the CephFS client).

The cache interposes on a RadosClient's per-object data ops:

- **reads** serve from cached content; a miss fetches the WHOLE object
  (read-ahead at object granularity — the rbd/cephfs access pattern is
  many sub-object reads against few objects) and inserts it clean.
  Absent objects are negatively cached and re-raise KeyError so clone
  parent-fallthrough semantics are untouched.
- **writes** buffer dirty extents (write-back); crossing ``max_dirty``
  flushes oldest-first down to ``target_dirty`` (the dirty/target
  throttle pair of the reference). ``flush()`` forces everything out —
  THE FENCE HOOK: rbd calls it before releasing the exclusive lock and
  before snapshots, the fs client on cap revoke/close, so no buffered
  byte can survive past an ownership or snapshot boundary.
- clean objects evict LRU when the cache exceeds ``max_bytes``.

Coherence stance (same as the reference): the cache is only valid
while the caller holds exclusive ownership of the objects (rbd
exclusive lock / fs write caps). On losing ownership the caller must
``flush()`` + ``invalidate()``; both integrations do.

ceph_tpu_torch's own copy of ``ceph_tpu/osdc/object_cacher.py``.
"""
from __future__ import annotations

from collections import OrderedDict


class _CachedObject:
    __slots__ = ("data", "fetched", "dirty", "absent", "full_rewrite",
                 "snapc")

    def __init__(self) -> None:
        #: server content (once fetched) merged with the dirty overlay
        self.data = bytearray()
        #: whole-object fetch happened: ``data`` is authoritative
        self.fetched = False
        #: sorted disjoint [(off, end)] dirty ranges awaiting flush
        self.dirty: list[tuple[int, int]] = []
        #: negative cache: the object does not exist server-side
        self.absent = False
        #: flush as one write_full (a full overwrite buffered)
        self.full_rewrite = False
        #: SnapContext in force when THIS object's dirty data was
        #: buffered — flushes must carry it (a cacher-global context
        #: would mistime clones for older buffered extents)
        self.snapc = None

    def dirty_bytes(self) -> int:
        return sum(e - o for o, e in self.dirty)

    def add_dirty(self, off: int, end: int) -> None:
        merged = []
        for o, e in self.dirty:
            if e < off or o > end:
                merged.append((o, e))
            else:
                off, end = min(off, o), max(end, e)
        merged.append((off, end))
        self.dirty = sorted(merged)

    def covers(self, lo: int, hi: int) -> bool:
        """Do the DIRTY ranges fully cover [lo, hi)?"""
        pos = lo
        for o, e in self.dirty:
            if o > pos:
                return False
            pos = max(pos, e)
            if pos >= hi:
                return True
        return pos >= hi


class ObjectCacher:
    def __init__(self, client, pool_id: int,
                 max_bytes: int = 64 << 20,
                 max_dirty: int = 16 << 20,
                 target_dirty: int = 8 << 20):
        self.client = client
        self.pool_id = pool_id
        self.max_bytes = max_bytes
        self.max_dirty = max_dirty
        self.target_dirty = target_dirty
        #: oid -> _CachedObject, LRU order (move_to_end on touch)
        self._objs: "OrderedDict[bytes, _CachedObject]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        # running totals — write/evict paths consult these on every op,
        # so they must be O(1), not a sweep of the table
        self._cached = 0
        self._dirty = 0

    # ------------------------------------------------------------- state

    @staticmethod
    def _norm(name) -> bytes:
        return name.encode() if isinstance(name, str) else bytes(name)

    def _touch(self, oid: bytes) -> _CachedObject:
        obj = self._objs.get(oid)
        if obj is None:
            obj = self._objs[oid] = _CachedObject()
        self._objs.move_to_end(oid)
        return obj

    def cached_bytes(self) -> int:
        return self._cached

    def dirty_bytes(self) -> int:
        return self._dirty

    def _drop(self, oid: bytes) -> None:
        obj = self._objs.pop(oid, None)
        if obj is not None:
            self._cached -= len(obj.data)
            self._dirty -= obj.dirty_bytes()

    # -------------------------------------------------------------- read

    async def read(self, name, offset: int = 0,
                   length: int = -1, snapid=None) -> bytes:
        if snapid is not None:
            # snap reads bypass: snapshots are immutable server-side
            # state the write-back cache knows nothing about
            return await self.client.read(self.pool_id, name,
                                          offset=offset, length=length,
                                          snapid=snapid)
        oid = self._norm(name)
        obj = self._touch(oid)
        if obj.absent and not obj.dirty:
            self.hits += 1
            raise KeyError(name)
        served_locally = obj.fetched or obj.full_rewrite or (
            length >= 0 and obj.covers(offset, offset + length))
        if not served_locally:
            await self._fetch_merge(oid, obj, name)
        else:
            self.hits += 1
        end = (len(obj.data) if length < 0
               else min(offset + length, len(obj.data)))
        return bytes(obj.data[offset:end])

    async def _fetch_merge(self, oid: bytes, obj: _CachedObject,
                           name) -> None:
        """Whole-object fetch (read-ahead unit), dirty overlay wins."""
        self.misses += 1
        try:
            blob = await self.client.read(self.pool_id, name)
        except KeyError:
            if not obj.dirty:
                obj.absent = True
                raise
            blob = b""
        base = bytearray(blob)
        if len(obj.data) > len(base):
            base.extend(bytes(len(obj.data) - len(base)))
        for o, e in obj.dirty:
            base[o:e] = obj.data[o:e]
        self._cached += len(base) - len(obj.data)
        obj.data = base
        obj.fetched = True
        await self._evict_clean()

    # ------------------------------------------------------------- write

    async def write(self, name, offset: int, data: bytes,
                    snapc=None) -> None:
        oid = self._norm(name)
        obj = self._touch(oid)
        obj.absent = False
        end = offset + len(data)
        if len(obj.data) < end:
            self._cached += end - len(obj.data)
            obj.data.extend(bytes(end - len(obj.data)))
        obj.data[offset:end] = data
        before = obj.dirty_bytes()
        obj.add_dirty(offset, end)
        self._dirty += obj.dirty_bytes() - before
        obj.snapc = snapc
        if self.dirty_bytes() > self.max_dirty:
            await self._flush_down_to(self.target_dirty)
        await self._evict_clean()

    async def write_full(self, name, data: bytes, snapc=None) -> None:
        oid = self._norm(name)
        obj = self._touch(oid)
        obj.absent = False
        self._cached += len(data) - len(obj.data)
        self._dirty += len(data) - obj.dirty_bytes()
        obj.data = bytearray(data)
        obj.fetched = False
        obj.full_rewrite = True
        obj.dirty = [(0, len(data))]
        obj.snapc = snapc
        if self.dirty_bytes() > self.max_dirty:
            await self._flush_down_to(self.target_dirty)
        await self._evict_clean()

    # ------------------------------------------------------------- flush

    async def flush(self, name=None) -> None:
        """Write every dirty extent out. The FENCE: callers invoke this
        before any ownership or snapshot boundary."""
        if name is not None:
            await self._flush_obj(self._norm(name))
            return
        for oid in list(self._objs):
            await self._flush_obj(oid)

    async def _flush_obj(self, oid: bytes) -> None:
        obj = self._objs.get(oid)
        if obj is None or not obj.dirty:
            return
        # snapshot-and-clear BEFORE awaiting: a concurrent write during
        # the awaits below lands new ranges on obj.dirty, which a
        # trailing wholesale clear would silently drop — buffered data
        # lost past a fence. The byte payloads snapshot with the ranges
        # for the same reason.
        pending, obj.dirty = obj.dirty, []
        self._dirty -= sum(e - o for o, e in pending)
        full, obj.full_rewrite = obj.full_rewrite, False
        snapc = obj.snapc
        payload = (bytes(obj.data) if full
                   else [(o, e, bytes(obj.data[o:e]))
                         for o, e in pending])
        try:
            if full:
                await self.client.write_full(self.pool_id, oid,
                                             payload, snapc=snapc)
                obj.fetched = True
            else:
                for o, e, chunk in payload:
                    await self.client.write(self.pool_id, oid, o,
                                            chunk, snapc=snapc)
        except BaseException:
            # failed flush: the data is still dirty — re-merge so a
            # later flush retries it
            before = obj.dirty_bytes()
            for o, e in pending:
                obj.add_dirty(o, e)
            self._dirty += obj.dirty_bytes() - before
            obj.full_rewrite = obj.full_rewrite or full
            raise

    async def _flush_down_to(self, target: int) -> None:
        for oid in list(self._objs):
            if self.dirty_bytes() <= target:
                break
            await self._flush_obj(oid)

    async def _evict_clean(self) -> None:
        while self.cached_bytes() > self.max_bytes:
            for oid, obj in list(self._objs.items()):
                if not obj.dirty:
                    self._drop(oid)
                    break
            else:  # everything dirty: flush, then retry eviction
                await self._flush_down_to(0)

    # ------------------------------------------------------- invalidation

    def invalidate(self, name=None) -> None:
        """Drop cached state (dirty included — call flush first unless
        discarding is the point, e.g. after losing the lock)."""
        if name is None:
            self._objs.clear()
            self._cached = 0
            self._dirty = 0
        else:
            self._drop(self._norm(name))

    def invalidate_clean(self) -> None:
        """Drop every CLEAN cached byte but keep dirty overlays: the
        next read re-fetches fresh server content and merges the
        still-buffered writes over it. This is the right fence after a
        server-side mutation behind the cache (truncate/rollback):
        a full invalidate would silently discard acknowledged writes
        that were buffered while the mutation's awaits were in flight,
        and no invalidate at all serves doomed bytes."""
        for oid in [o for o, obj in self._objs.items()
                    if not obj.dirty]:
            self._drop(oid)
        for obj in self._objs.values():
            obj.fetched = False  # the dirty overlay itself persists
            obj.absent = False


class CacheIo:
    """RadosClient-shaped facade routing per-object data ops through
    an ObjectCacher (what ObjectCacher is to Objecter in the
    reference); everything else passes through to the real client.
    Both rbd and the fs client wrap their data IO in one of these."""

    def __init__(self, client, cacher: ObjectCacher):
        self._client = client
        self.cacher = cacher

    async def read(self, pool_id, name, offset=0, length=-1,
                   snapid=None):
        return await self.cacher.read(name, offset=offset,
                                      length=length, snapid=snapid)

    async def write(self, pool_id, name, offset, data, snapc=None):
        await self.cacher.write(name, offset, data, snapc=snapc)

    async def write_full(self, pool_id, name, data, snapc=None):
        await self.cacher.write_full(name, data, snapc=snapc)

    async def zero(self, pool_id, name, offset, length, snapc=None):
        # no buffered representation for holes: flush what we have,
        # drop the object, let the server do it
        await self.cacher.flush(name)
        self.cacher.invalidate(name)
        await self._client.zero(pool_id, name, offset, length,
                                snapc=snapc)

    async def delete(self, pool_id, name, snapc=None):
        self.cacher.invalidate(name)
        await self._client.delete(pool_id, name, snapc=snapc)

    def __getattr__(self, attr):
        return getattr(self._client, attr)
