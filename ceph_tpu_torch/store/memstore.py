"""MemStore: dict-backed ObjectStore (the reference src/os/memstore role).

The cluster-free test double (SURVEY.md §4 tier 2): transactions apply
synchronously under one lock with all-or-nothing semantics. Staging is
object-granular copy-on-touch — an overlay of cloned objects over the
committed collections, folded in on success — so a transaction costs
O(objects it touches), not O(objects in the PG) (the same txc shape as
BlueStoreLite; the previous whole-collection deep clone made every
write linear in PG population, the dominant term of write latency
under the bench).

ceph_tpu_torch's own copy of ``ceph_tpu/store/memstore.py``.
"""
from __future__ import annotations

import threading
from typing import Callable

from . import transaction as tx
from .base import Collection, NotFound, Obj, ObjectStore


class _TxnObjects:
    """Dict-like view of one collection's objects for the op
    interpreter: reads fall through to committed state, any access
    clones the object into the overlay first (the interpreter mutates
    in place), deletions are tombstones (None)."""

    def __init__(self, committed: dict[bytes, Obj] | None):
        self.committed = committed if committed is not None else {}
        self.overlay: dict[bytes, Obj | None] = {}

    def _live(self, oid: bytes) -> Obj | None:
        if oid in self.overlay:
            return self.overlay[oid]
        o = self.committed.get(oid)
        if o is not None:  # copy-on-first-touch
            o = o.clone()
            self.overlay[oid] = o
        return o

    def peek(self, oid: bytes) -> Obj | None:
        """Read-only view WITHOUT cloning into the overlay (for clone
        sources and existence probes — a pure read must not drag an
        untouched object through the commit fold)."""
        if oid in self.overlay:
            return self.overlay[oid]
        return self.committed.get(oid)

    def get(self, oid: bytes) -> Obj | None:
        return self._live(oid)

    def __contains__(self, oid: bytes) -> bool:
        if oid in self.overlay:
            return self.overlay[oid] is not None
        return oid in self.committed

    def __getitem__(self, oid: bytes) -> Obj:
        o = self._live(oid)
        if o is None:
            raise KeyError(oid)
        return o

    def __setitem__(self, oid: bytes, o: Obj) -> None:
        self.overlay[oid] = o

    def __delitem__(self, oid: bytes) -> None:
        if oid not in self:
            raise KeyError(oid)
        self.overlay[oid] = None

    def setdefault(self, oid: bytes, default: Obj) -> Obj:
        o = self._live(oid)
        if o is None:
            o = default
            self.overlay[oid] = o
        return o

    def pop(self, oid: bytes) -> Obj:
        o = self._live(oid)
        if o is None:
            raise KeyError(oid)
        self.overlay[oid] = None
        return o

    def update(self, other: "_TxnObjects") -> None:
        for oid in list(other):
            self[oid] = other[oid]

    def __iter__(self):
        for oid in self.committed:
            if self.overlay.get(oid, ...) is not None:
                yield oid
        for oid, o in self.overlay.items():
            if o is not None and oid not in self.committed:
                yield oid

    def __bool__(self) -> bool:
        return next(iter(self), None) is not None

    def keys(self):
        return iter(self)


class _TxnColl:
    """Collection stand-in handed to the shared op interpreter."""

    def __init__(self, cid: str, committed: Collection | None):
        self.cid = cid
        self.objects = _TxnObjects(
            committed.objects if committed is not None else None)


class _Staging(dict):
    """cid -> _TxnColl view over the committed coll map, with lazy view
    creation and add/remove tracking for commit time."""

    def __init__(self, store: "MemStore"):
        super().__init__()
        self.store = store
        self.removed: set[str] = set()
        self.added: set[str] = set()

    def __contains__(self, cid) -> bool:
        if dict.__contains__(self, cid):
            return True
        return cid not in self.removed and cid in self.store.colls

    def get(self, cid, default=None):
        if dict.__contains__(self, cid):
            return dict.__getitem__(self, cid)
        if cid in self.removed or cid not in self.store.colls:
            return default
        view = _TxnColl(cid, self.store.colls[cid])
        dict.__setitem__(self, cid, view)
        return view

    def __getitem__(self, cid):
        v = self.get(cid)
        if v is None:
            raise KeyError(cid)
        return v

    def __setitem__(self, cid, coll) -> None:
        # MKCOLL inserts a fresh empty Collection; a populated one
        # would silently lose its objects here, so refuse it loudly
        assert not coll.objects, "only empty collections can be staged"
        view = _TxnColl(cid, None)
        dict.__setitem__(self, cid, view)
        self.added.add(cid)
        self.removed.discard(cid)

    def __delitem__(self, cid) -> None:
        if dict.__contains__(self, cid):
            dict.__delitem__(self, cid)
        self.removed.add(cid)
        self.added.discard(cid)


class MemStore(ObjectStore):
    def __init__(self) -> None:
        super().__init__()
        self.colls: dict[str, Collection] = {}
        self.lock = threading.RLock()

    # ------------------------------------------------------------- writes

    def queue_transaction(
        self, t: tx.Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        with self.lock:
            self._commit_stage(self._stage(t))
        if on_commit:
            on_commit()

    def _stage(self, t: tx.Transaction) -> _Staging:
        """All-or-nothing staging: run the ops against copy-on-touch
        views; nothing committed is mutated until _commit_stage."""
        with self.lock:
            staging = _Staging(self)
            for op in t.ops:
                self._do_op(staging, op)
            return staging

    def _commit_stage(self, staging: _Staging) -> None:
        for cid in staging.removed:
            self.colls.pop(cid, None)
        for cid in staging.added:
            self.colls[cid] = Collection(cid)
        for cid, view in staging.items():
            if cid in staging.removed:
                continue
            base = self.colls.get(cid)
            if base is None:  # re-created under an added cid above
                continue
            for oid, o in view.objects.overlay.items():
                if o is None:
                    base.objects.pop(oid, None)
                else:
                    base.objects[oid] = o


    # -------------------------------------------------------------- reads

    def _coll(self, cid: str) -> Collection:
        c = self.colls.get(cid)
        if c is None:
            raise NotFound(f"collection {cid}")
        return c

    def _obj(self, cid: str, oid: bytes):
        o = self._coll(cid).objects.get(oid)
        if o is None:
            raise NotFound(repr(oid))
        return o

    def read(self, cid: str, oid: bytes, offset: int = 0, length: int = -1) -> bytes:
        with self.lock:
            o = self._obj(cid, oid)
            if length < 0:
                return bytes(o.data[offset:])
            return bytes(o.data[offset : offset + length])

    def stat(self, cid: str, oid: bytes) -> int:
        with self.lock:
            return len(self._obj(cid, oid).data)

    def getattr(self, cid: str, oid: bytes, name: str) -> bytes:
        with self.lock:
            attrs = self._obj(cid, oid).xattrs
            if name not in attrs:
                raise NotFound(name)
            return attrs[name]

    def getattrs(self, cid: str, oid: bytes) -> dict[str, bytes]:
        with self.lock:
            return dict(self._obj(cid, oid).xattrs)

    def omap_get(self, cid: str, oid: bytes) -> dict[bytes, bytes]:
        with self.lock:
            return dict(self._obj(cid, oid).omap)

    def omap_get_header(self, cid: str, oid: bytes) -> bytes:
        with self.lock:
            return self._obj(cid, oid).omap_header

    def list_collections(self) -> list[str]:
        with self.lock:
            return sorted(self.colls)

    def list_objects(self, cid: str) -> list[bytes]:
        with self.lock:
            return sorted(self._coll(cid).objects)
