"""ctypes bindings for the port's native runtime core (``rt_native.cc``):
embedded KV store (src/kv KeyValueDB + RocksDB role), async block
device (src/blk BlockDevice role), bitmap allocator (BlueStore
fastbmap allocator role). See rt_native.cc for the durability
contracts.

``rt_native.cc`` is the port's own copy of the JAX package's. The
library is built at first use, as the host core is (``native``:
``g++`` into ``ceph_tpu_torch/build/``, named by a digest of source and
flags, through a temporary file and a rename).
"""
from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

from . import build_library, library_path

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "rt_native.cc",)

_u8p = ctypes.POINTER(ctypes.c_uint8)


def library() -> Path:
    """Path of the runtime library for the current source and flags."""
    return library_path("rt_native", SOURCES)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(library(), SOURCES[0])))
    b, u32, u64, vp, cp = (ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
                           ctypes.c_void_p, ctypes.c_char_p)
    lib.ctkv_open.restype = vp
    lib.ctkv_open.argtypes = [cp, ctypes.c_int]
    lib.ctkv_close.argtypes = [vp]
    lib.ctkv_batch.restype = ctypes.c_int
    lib.ctkv_batch.argtypes = [vp, b, u64]
    lib.ctkv_put.restype = ctypes.c_int
    lib.ctkv_put.argtypes = [vp, b, u32, b, u32]
    lib.ctkv_del.restype = ctypes.c_int
    lib.ctkv_del.argtypes = [vp, b, u32]
    lib.ctkv_get.restype = vp
    lib.ctkv_get.argtypes = [vp, b, u32, ctypes.POINTER(u64)]
    lib.ctkv_buf_free.argtypes = [vp]
    lib.ctkv_scan.restype = vp
    lib.ctkv_scan.argtypes = [vp, b, u32, b, u32, u64,
                              ctypes.POINTER(u64), ctypes.POINTER(u64)]
    lib.ctkv_compact.restype = ctypes.c_int
    lib.ctkv_compact.argtypes = [vp]
    lib.ctkv_count.restype = u64
    lib.ctkv_count.argtypes = [vp]
    lib.ctkv_wal_size.restype = u64
    lib.ctkv_wal_size.argtypes = [vp]

    lib.ctblk_open.restype = vp
    lib.ctblk_open.argtypes = [cp, u64, ctypes.c_int]
    lib.ctblk_close.argtypes = [vp]
    lib.ctblk_size.restype = u64
    lib.ctblk_size.argtypes = [vp]
    lib.ctblk_submit_write.restype = u64
    lib.ctblk_submit_write.argtypes = [vp, u64, b, u64]
    lib.ctblk_drain.restype = ctypes.c_int
    lib.ctblk_drain.argtypes = [vp]
    lib.ctblk_flush.restype = ctypes.c_int
    lib.ctblk_flush.argtypes = [vp]
    lib.ctblk_pwrite.restype = ctypes.c_int
    lib.ctblk_pwrite.argtypes = [vp, u64, b, u64]
    lib.ctblk_pread.restype = ctypes.c_int
    lib.ctblk_pread.argtypes = [vp, u64, vp, u64]

    lib.ctalloc_new.restype = vp
    lib.ctalloc_new.argtypes = [u64]
    lib.ctalloc_free_handle.argtypes = [vp]
    lib.ctalloc_alloc.restype = u64
    lib.ctalloc_alloc.argtypes = [vp, u64]
    lib.ctalloc_release.argtypes = [vp, u64, u64]
    lib.ctalloc_mark_used.argtypes = [vp, u64, u64]
    lib.ctalloc_used.restype = u64
    lib.ctalloc_used.argtypes = [vp]
    lib.ctalloc_total.restype = u64
    lib.ctalloc_total.argtypes = [vp]
    return lib


_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use (thread-safe)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load()
        return _lib


NO_BLOCK = (1 << 64) - 1  # ctalloc_alloc failure sentinel


class KvError(Exception):
    pass


class NativeKV:
    """Ordered KV with atomic batches, WAL durability, snapshot
    compaction. The KeyValueDB seam (src/kv/KeyValueDB.h role)."""

    def __init__(self, path: str, fsync: bool = False):
        self._lib = lib()
        self._h = self._lib.ctkv_open(str(path).encode(), int(fsync))
        if not self._h:
            raise KvError(f"ctkv_open({path}) failed (corrupt snapshot?)")

    def close(self) -> None:
        if self._h:
            self._lib.ctkv_close(self._h)
            self._h = None

    def _handle(self):
        if not self._h:
            raise KvError("kv store is closed")
        return self._h

    def put(self, key: bytes, value: bytes) -> None:
        if self._lib.ctkv_put(self._handle(), key, len(key), value,
                              len(value)):
            raise KvError("put failed")

    def delete(self, key: bytes) -> None:
        if self._lib.ctkv_del(self._handle(), key, len(key)):
            raise KvError("delete failed")

    def get(self, key: bytes) -> bytes | None:
        vlen = ctypes.c_uint64()
        p = self._lib.ctkv_get(self._handle(), key, len(key),
                               ctypes.byref(vlen))
        if not p:
            return None
        try:
            return ctypes.string_at(p, vlen.value)
        finally:
            self._lib.ctkv_buf_free(p)

    def batch(self, ops: list[tuple[str, bytes, bytes | None]]) -> None:
        """Atomically apply [(op, key, value)] where op is "put"/"del"
        (value ignored for del). One WAL record."""
        parts = [struct.pack("<I", len(ops))]
        for op, k, v in ops:
            if op == "put":
                parts.append(b"\x00" + struct.pack("<I", len(k)) + k
                             + struct.pack("<I", len(v)) + v)
            elif op == "del":
                parts.append(b"\x01" + struct.pack("<I", len(k)) + k)
            else:
                raise ValueError(f"unknown batch op {op!r}")
        payload = b"".join(parts)
        rc = self._lib.ctkv_batch(self._handle(), payload, len(payload))
        if rc:
            raise KvError(f"batch failed (rc={rc})")

    def scan(self, lo: bytes = b"", hi: bytes = b"",
             max_items: int = 1 << 62) -> list[tuple[bytes, bytes]]:
        """Sorted items with lo <= key < hi (empty hi = to the end)."""
        count = ctypes.c_uint64()
        buflen = ctypes.c_uint64()
        p = self._lib.ctkv_scan(self._handle(), lo, len(lo), hi, len(hi),
                                max_items, ctypes.byref(count),
                                ctypes.byref(buflen))
        try:
            buf = ctypes.string_at(p, buflen.value)
        finally:
            self._lib.ctkv_buf_free(p)
        out = []
        off = 0
        for _ in range(count.value):
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = buf[off:off + klen]
            off += klen
            (vlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            out.append((k, buf[off:off + vlen]))
            off += vlen
        return out

    def scan_prefix(self, prefix: bytes,
                    max_items: int = 1 << 62) -> list[tuple[bytes, bytes]]:
        return self.scan(prefix, _prefix_end(prefix), max_items)

    def compact(self) -> None:
        if self._lib.ctkv_compact(self._handle()):
            raise KvError("compact failed")

    def count(self) -> int:
        return self._lib.ctkv_count(self._handle())

    def wal_size(self) -> int:
        return self._lib.ctkv_wal_size(self._handle())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _prefix_end(prefix: bytes) -> bytes:
    """Smallest key greater than every key starting with prefix."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return b""  # prefix of all-0xFF: scan to the end
    p[-1] += 1
    return bytes(p)


class BlkError(OSError):
    pass


class BlockDevice:
    """Raw block file with an IO thread pool for async writes and a
    drain/flush barrier (src/blk/BlockDevice.h KernelDevice role)."""

    def __init__(self, path: str, size: int, n_threads: int = 4):
        self._lib = lib()
        self._h = self._lib.ctblk_open(str(path).encode(), size, n_threads)
        if not self._h:
            raise BlkError(f"ctblk_open({path}) failed")
        self.size = self._lib.ctblk_size(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ctblk_close(self._h)
            self._h = None

    def submit_write(self, offset: int, data: bytes) -> int:
        return self._lib.ctblk_submit_write(self._h, offset, data, len(data))

    def drain(self) -> None:
        err = self._lib.ctblk_drain(self._h)
        if err:
            raise BlkError(err, "async write failed")

    def flush(self) -> None:
        err = self._lib.ctblk_flush(self._h)
        if err:
            raise BlkError(err, "flush failed")

    def pwrite(self, offset: int, data: bytes) -> None:
        err = self._lib.ctblk_pwrite(self._h, offset, data, len(data))
        if err:
            raise BlkError(err, "pwrite failed")

    def pread(self, offset: int, length: int) -> bytes:
        buf = ctypes.create_string_buffer(length)
        err = self._lib.ctblk_pread(self._h, offset, buf, length)
        if err:
            raise BlkError(err, "pread failed")
        return buf.raw

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BitmapAllocator:
    """First-fit contiguous block allocator over a native bitmap
    (BlueStore fastbmap_allocator_impl role)."""

    def __init__(self, n_blocks: int):
        self._lib = lib()
        self._h = self._lib.ctalloc_new(n_blocks)
        self.n_blocks = n_blocks

    def close(self) -> None:
        if self._h:
            self._lib.ctalloc_free_handle(self._h)
            self._h = None

    def alloc(self, n: int) -> int:
        """Start block of a contiguous n-block run; raises when full."""
        start = self._lib.ctalloc_alloc(self._h, n)
        if start == NO_BLOCK:
            raise MemoryError(f"no contiguous run of {n} blocks free")
        return start

    def release(self, start: int, n: int) -> None:
        self._lib.ctalloc_release(self._h, start, n)

    def mark_used(self, start: int, n: int) -> None:
        self._lib.ctalloc_mark_used(self._h, start, n)

    @property
    def used(self) -> int:
        return self._lib.ctalloc_used(self._h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
