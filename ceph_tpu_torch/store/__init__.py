"""Local object store layer.

Mirrors the reference's ObjectStore seam (src/os/ObjectStore.h:63):
collections (one per PG) hold objects with three facets — byte data,
xattrs, and omap (sorted key/value) — and all mutations flow through
transactional redo logs (src/os/Transaction.h:110-155 op set) applied
atomically by ``queue_transaction`` (ObjectStore.h:223).

Implementations:
- ``MemStore`` (memstore.py) — dict-backed test double, the reference's
  src/os/memstore role; used by OSD-lite processes and tests.
- ``WalStore`` (walstore.py) — persistent directory-backed store with a
  CRC-framed write-ahead log, checkpoint snapshots, and batched CRC32C
  blob checksums through the Checksummer (a FileStore-shaped middle
  tier: whole-store snapshots, data in the checkpoint file).
- ``BlueStoreLite`` (bluestore.py) — the BlueStore role proper: object
  data in 4 KiB blocks on a raw block device (native C++ IO thread
  pool, src/blk role) placed by a native bitmap allocator, metadata in
  the native embedded KV (src/kv role), COW writes, per-block crc32c
  verified on read.

Factory: ``create(kind, path)`` mirroring ObjectStore::create
(src/os/ObjectStore.cc:30-62).

ceph_tpu_torch's own copy of ``ceph_tpu/store``. The durable stores take
the JAX package's ``device_csum`` (False: checksums on the C++ core) and
``device``, where ``device_csum=True`` checksums run (the CUDA card
unless the caller names another, ``device="cpu"`` for the plain
version).
"""
from __future__ import annotations

from .transaction import Transaction  # noqa: F401
from .base import ObjectStore, StoreError, NotFound, Collection  # noqa: F401
from .memstore import MemStore  # noqa: F401


def create(kind: str, path: str | None = None, **kw) -> ObjectStore:
    """ObjectStore::create-style factory (os/ObjectStore.cc:30); ``kw``
    go to the store (``device_csum``, ``device``, ...)."""
    if kind == "memstore":
        return MemStore()
    if kind in ("walstore", "filestore"):
        from .walstore import WalStore

        s = WalStore(path, **kw)
        s.mount()
        return s
    if kind == "bluestore":
        from .bluestore import BlueStoreLite

        s = BlueStoreLite(path, **kw)
        s.mount()
        return s
    raise ValueError(f"unknown store kind {kind!r}")
