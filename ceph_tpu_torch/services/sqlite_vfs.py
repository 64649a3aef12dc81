"""libcephsqlite role: SQLite database files striped over RADOS.

The reference (src/libcephsqlite.cc) registers a custom SQLite VFS
("ceph") whose file primitives are SimpleRADOSStriper operations, so
an unmodified SQLite engine runs with its database pages living in a
RADOS pool, single-writer arbitration via the RADOS exclusive lock.

Same design here, TPU-build style: the VFS is registered against the
process's ``libsqlite3`` **through ctypes** (no C shim needed — the
stdlib ``sqlite3`` module links the same shared library, so
``sqlite3.connect("file:name?vfs=...", uri=True)`` routes straight
into these callbacks), and the file primitives are `RadosStriper`
calls (osdc/striped_client.py) bridged from SQLite's synchronous
callbacks onto the cluster's asyncio loop:

- xRead/xWrite/xTruncate/xFileSize → striper read/write/truncate/stat
  (pages fan out across RADOS objects; partial-page updates ride the
  PG op-vector RMW);
- single-writer arbitration → cls "lock" exclusive lock on a
  per-database lock object (SimpleRADOSStriper's exclusive-lock role),
  taken at open of the main DB for writing, released at close;
- the rollback journal is just another striped file; hot-journal
  detection works because xAccess reports a file only once it has
  been written.

WAL mode is unsupported (no shared-memory primitives over RADOS) —
same stance as the reference; SQLite falls back to rollback journals.

ceph_tpu_torch's own copy of ``ceph_tpu/services/sqlite_vfs.py``.
"""
from __future__ import annotations

import asyncio
import ctypes as ct
import os
import threading
import time
import uuid

from ..utils import denc

# ----------------------------------------------------- sqlite constants

SQLITE_OK = 0
SQLITE_BUSY = 5
SQLITE_IOERR = 10
SQLITE_NOTFOUND = 12
SQLITE_CANTOPEN = 14
SQLITE_IOERR_SHORT_READ = 522

OPEN_READONLY = 0x1
OPEN_READWRITE = 0x2
OPEN_CREATE = 0x4
OPEN_DELETEONCLOSE = 0x8
OPEN_MAIN_DB = 0x100

_LOCK_NAME = "striper.lock"  # SimpleRADOSStriper biglock role


class _File(ct.Structure):
    """sqlite3_file: sqlite allocates szOsFile bytes; we stash a
    handle into the VFS's file registry after the method pointer."""

    _fields_ = [("pMethods", ct.c_void_p), ("handle", ct.c_uint64)]


_FP = ct.POINTER(_File)

_XCLOSE = ct.CFUNCTYPE(ct.c_int, _FP)
_XREAD = ct.CFUNCTYPE(ct.c_int, _FP, ct.c_void_p, ct.c_int, ct.c_longlong)
_XWRITE = ct.CFUNCTYPE(ct.c_int, _FP, ct.c_void_p, ct.c_int, ct.c_longlong)
_XTRUNCATE = ct.CFUNCTYPE(ct.c_int, _FP, ct.c_longlong)
_XSYNC = ct.CFUNCTYPE(ct.c_int, _FP, ct.c_int)
_XFILESIZE = ct.CFUNCTYPE(ct.c_int, _FP, ct.POINTER(ct.c_longlong))
_XLOCK = ct.CFUNCTYPE(ct.c_int, _FP, ct.c_int)
_XCHECKLOCK = ct.CFUNCTYPE(ct.c_int, _FP, ct.POINTER(ct.c_int))
_XFILECTL = ct.CFUNCTYPE(ct.c_int, _FP, ct.c_int, ct.c_void_p)
_XSECTOR = ct.CFUNCTYPE(ct.c_int, _FP)


class _IoMethods(ct.Structure):
    _fields_ = [
        ("iVersion", ct.c_int),
        ("xClose", _XCLOSE), ("xRead", _XREAD), ("xWrite", _XWRITE),
        ("xTruncate", _XTRUNCATE), ("xSync", _XSYNC),
        ("xFileSize", _XFILESIZE), ("xLock", _XLOCK),
        ("xUnlock", _XLOCK), ("xCheckReservedLock", _XCHECKLOCK),
        ("xFileControl", _XFILECTL), ("xSectorSize", _XSECTOR),
        ("xDeviceCharacteristics", _XSECTOR),
    ]


class _Vfs(ct.Structure):
    pass


_VP = ct.POINTER(_Vfs)

_XOPEN = ct.CFUNCTYPE(ct.c_int, _VP, ct.c_char_p, _FP, ct.c_int,
                      ct.POINTER(ct.c_int))
_XDELETE = ct.CFUNCTYPE(ct.c_int, _VP, ct.c_char_p, ct.c_int)
_XACCESS = ct.CFUNCTYPE(ct.c_int, _VP, ct.c_char_p, ct.c_int,
                        ct.POINTER(ct.c_int))
_XFULLPATH = ct.CFUNCTYPE(ct.c_int, _VP, ct.c_char_p, ct.c_int,
                          ct.c_void_p)
_XRANDOM = ct.CFUNCTYPE(ct.c_int, _VP, ct.c_int, ct.c_void_p)
_XSLEEP = ct.CFUNCTYPE(ct.c_int, _VP, ct.c_int)
_XCURTIME = ct.CFUNCTYPE(ct.c_int, _VP, ct.POINTER(ct.c_double))
_XLASTERR = ct.CFUNCTYPE(ct.c_int, _VP, ct.c_int, ct.c_void_p)

_Vfs._fields_ = [
    ("iVersion", ct.c_int), ("szOsFile", ct.c_int),
    ("mxPathname", ct.c_int), ("pNext", ct.c_void_p),
    ("zName", ct.c_char_p), ("pAppData", ct.c_void_p),
    ("xOpen", _XOPEN), ("xDelete", _XDELETE), ("xAccess", _XACCESS),
    ("xFullPathname", _XFULLPATH),
    ("xDlOpen", ct.c_void_p), ("xDlError", ct.c_void_p),
    ("xDlSym", ct.c_void_p), ("xDlClose", ct.c_void_p),
    ("xRandomness", _XRANDOM), ("xSleep", _XSLEEP),
    ("xCurrentTime", _XCURTIME), ("xGetLastError", _XLASTERR),
]


class ClusterLoopThread:
    """Owns an asyncio loop in a daemon thread so synchronous callers
    (the SQLite callbacks, CLI tools) can drive the async cluster.
    Create the cluster/client INSIDE this loop via call()."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, daemon=True)
        self._thread.start()

    def call(self, coro, timeout: float = 120.0):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=10)


class _StripedHandle:
    """One open SQLite file = one striped RADOS file."""

    def __init__(self, vfs: "CephVFS", name: str, flags: int):
        self.vfs = vfs
        self.name = name
        self.flags = flags
        self.locked = False
        self.cookie = uuid.uuid4().hex
        self.renew_task = None


def _enc_lock(*fields: str) -> bytes:
    return b"".join(denc.enc_str(f) for f in fields)


class CephVFS:
    """Register a SQLite VFS whose backing store is a RADOS pool.

    >>> bridge = ClusterLoopThread()          # cluster's asyncio home
    >>> ...create cluster + client inside bridge.call(...)
    >>> vfs = CephVFS(bridge, client, pool_id)
    >>> vfs.register()
    >>> db = sqlite3.connect(f"file:mydb?vfs={vfs.name}", uri=True)
    """

    def __init__(self, bridge: ClusterLoopThread, client, pool_id: int,
                 name: str | None = None, layout=None,
                 lock_duration_s: float = 30.0):
        from ..osdc.striped_client import RadosStriper
        from ..osdc.striper import FileLayout

        self.bridge = bridge
        self.client = client
        self.pool_id = pool_id
        self.name = name or f"ceph-{id(self):x}"
        self.striper = RadosStriper(
            client, pool_id,
            layout or FileLayout(stripe_unit=64 << 10, stripe_count=2,
                                 object_size=1 << 20))
        self.lock_duration_s = lock_duration_s
        self._files: dict[int, _StripedHandle] = {}
        self._next = 1
        self._registered = False
        self._lib = ct.CDLL("libsqlite3.so.0")
        self._lib.sqlite3_vfs_register.argtypes = [ct.c_void_p, ct.c_int]
        self._lib.sqlite3_vfs_unregister.argtypes = [ct.c_void_p]
        self._build()

    # ----------------------------------------------------- file helpers

    def _lock_oid(self, name: str) -> str:
        return name + ".striper.lockobj"

    def _lock_input(self, h: _StripedHandle) -> bytes:
        return (_enc_lock(_LOCK_NAME, "exclusive",
                          getattr(self.client, "name", "client"),
                          h.cookie)
                + denc.enc_u64(int(self.lock_duration_s * 1000)))

    def _acquire(self, h: _StripedHandle) -> int:
        """Take the per-database exclusive lock WITH a duration
        (SimpleRADOSStriper's timed biglock role): a holder that dies
        without unlocking simply expires — re-locking with the same
        owner+cookie renews, and a background task on the bridge loop
        keeps renewing while the handle is open."""
        from ..cluster.client import RadosError

        try:
            self.bridge.call(self.client.execute(
                self.pool_id, self._lock_oid(h.name), "lock", "lock",
                self._lock_input(h)))
        except RadosError as e:
            if e.code == -16:  # EBUSY: a live writer holds the DB
                return SQLITE_BUSY
            raise
        h.locked = True

        async def renew():
            try:
                while True:
                    await asyncio.sleep(self.lock_duration_s / 3)
                    await self.client.execute(
                        self.pool_id, self._lock_oid(h.name),
                        "lock", "lock", self._lock_input(h))
            except asyncio.CancelledError:
                raise
            except Exception:
                return  # lost the lock/cluster: stop renewing

        h.renew_task = asyncio.run_coroutine_threadsafe(
            renew(), self.bridge.loop)
        return SQLITE_OK

    def _release(self, h: _StripedHandle) -> None:
        from ..cluster.client import RadosError

        if not h.locked:
            return
        if h.renew_task is not None:
            h.renew_task.cancel()
            try:
                # WAIT for an in-flight renewal to settle before the
                # unlock: a renewal landing after it would re-grant the
                # lock to this dead cookie for a full duration
                h.renew_task.result(timeout=10)
            except Exception:
                pass
            h.renew_task = None
        try:
            self.bridge.call(self.client.execute(
                self.pool_id, self._lock_oid(h.name), "lock", "unlock",
                _enc_lock(_LOCK_NAME,
                          getattr(self.client, "name", "client"),
                          h.cookie)))
        except RadosError:
            # lock object vanished with the db, or the grant already
            # expired — either way the duration bounds any leak
            pass
        h.locked = False

    # ------------------------------------------------------ io methods

    def _h(self, fp) -> _StripedHandle:
        return self._files[fp.contents.handle]

    def _x_close(self, fp) -> int:
        try:
            h = self._files.pop(fp.contents.handle, None)
            if h is None:
                return SQLITE_OK
            self._release(h)
            if h.flags & OPEN_DELETEONCLOSE:
                self.bridge.call(self.striper.remove(h.name))
            return SQLITE_OK
        except Exception:
            return SQLITE_IOERR

    def _x_read(self, fp, buf, amt, off) -> int:
        try:
            h = self._h(fp)
            # the striper zero-fills holes, so EOF must come from the
            # logical size: sqlite distinguishes "new db" / "no hot
            # journal" by short reads. pread fans the data and size
            # reads out concurrently — one round-trip latency.
            data, _ = self.bridge.call(
                self.striper.pread(h.name, off, amt))
            if data:
                ct.memmove(buf, data, len(data))
            if len(data) < amt:
                ct.memset(buf + len(data), 0, amt - len(data))
                return SQLITE_IOERR_SHORT_READ
            return SQLITE_OK
        except Exception:
            return SQLITE_IOERR

    def _x_write(self, fp, buf, amt, off) -> int:
        try:
            h = self._h(fp)
            data = ct.string_at(buf, amt)
            self.bridge.call(self.striper.write(h.name, data, off))
            return SQLITE_OK
        except Exception:
            return SQLITE_IOERR

    def _x_truncate(self, fp, size) -> int:
        try:
            h = self._h(fp)
            self.bridge.call(self.striper.truncate(h.name, size))
            return SQLITE_OK
        except Exception:
            return SQLITE_IOERR

    def _x_sync(self, fp, flags) -> int:
        # every write is acked by the acting set before returning:
        # there is nothing volatile to flush (BlueStore txc ack role)
        return SQLITE_OK

    def _x_filesize(self, fp, psize) -> int:
        try:
            h = self._h(fp)
            psize[0] = self.bridge.call(self.striper.stat(h.name))
            return SQLITE_OK
        except Exception:
            return SQLITE_IOERR

    def _x_lock(self, fp, level) -> int:
        # arbitration is the RADOS exclusive lock taken at open; the
        # in-process lock ladder is a no-op (same as the reference,
        # which holds the striper biglock for the handle's lifetime)
        return SQLITE_OK

    def _x_unlock(self, fp, level) -> int:
        return SQLITE_OK

    def _x_checklock(self, fp, pres) -> int:
        pres[0] = 0
        return SQLITE_OK

    def _x_filectl(self, fp, op, parg) -> int:
        return SQLITE_NOTFOUND  # take sqlite's defaults

    def _x_sector(self, fp) -> int:
        return 4096

    def _x_devchar(self, fp) -> int:
        return 0

    # ------------------------------------------------------ vfs methods

    def _x_open(self, vfs, zname, fp, flags, pout) -> int:
        try:
            name = (zname.decode() if zname
                    else f"temp-{uuid.uuid4().hex}")
            h = _StripedHandle(self, name, flags)
            if flags & OPEN_MAIN_DB:
                # EVERY main-db open takes the exclusive lock — readers
                # included: with no in-band page locking (_x_lock is a
                # no-op), an unlocked reader could see a writer's torn
                # page set mid-commit (SimpleRADOSStriper holds its
                # biglock for read-only opens too)
                rc = self._acquire(h)
                if rc != SQLITE_OK:
                    return rc
            hid = self._next
            self._next += 1
            self._files[hid] = h
            fp.contents.pMethods = ct.cast(
                ct.byref(self._iomethods), ct.c_void_p)
            fp.contents.handle = hid
            if pout:
                pout[0] = flags
            return SQLITE_OK
        except Exception:
            return SQLITE_CANTOPEN

    def _x_delete(self, vfs, zname, syncdir) -> int:
        try:
            self.bridge.call(self.striper.remove(zname.decode()))
            return SQLITE_OK
        except Exception:
            return SQLITE_IOERR

    def _x_access(self, vfs, zname, flags, pres) -> int:
        try:
            pres[0] = 1 if self.bridge.call(
                self.striper.exists(zname.decode())) else 0
            return SQLITE_OK
        except Exception:
            return SQLITE_IOERR

    def _x_fullpath(self, vfs, zname, nout, zout) -> int:
        path = zname[:nout - 1] + b"\x00"
        ct.memmove(zout, path, len(path))
        return SQLITE_OK

    def _x_random(self, vfs, n, buf) -> int:
        ct.memmove(buf, os.urandom(n), n)
        return n

    def _x_sleep(self, vfs, us) -> int:
        time.sleep(us / 1e6)
        return us

    def _x_curtime(self, vfs, pt) -> int:
        pt[0] = 2440587.5 + time.time() / 86400.0
        return SQLITE_OK

    def _x_lasterr(self, vfs, n, buf) -> int:
        return 0

    # -------------------------------------------------------- plumbing

    def _build(self) -> None:
        self._iomethods = _IoMethods(
            iVersion=1,
            xClose=_XCLOSE(self._x_close),
            xRead=_XREAD(self._x_read),
            xWrite=_XWRITE(self._x_write),
            xTruncate=_XTRUNCATE(self._x_truncate),
            xSync=_XSYNC(self._x_sync),
            xFileSize=_XFILESIZE(self._x_filesize),
            xLock=_XLOCK(self._x_lock),
            xUnlock=_XLOCK(self._x_unlock),
            xCheckReservedLock=_XCHECKLOCK(self._x_checklock),
            xFileControl=_XFILECTL(self._x_filectl),
            xSectorSize=_XSECTOR(self._x_sector),
            xDeviceCharacteristics=_XSECTOR(self._x_devchar),
        )
        self._zname = self.name.encode()
        self._vfs = _Vfs(
            iVersion=1,
            szOsFile=ct.sizeof(_File),
            mxPathname=512,
            pNext=None,
            zName=self._zname,
            pAppData=None,
            xOpen=_XOPEN(self._x_open),
            xDelete=_XDELETE(self._x_delete),
            xAccess=_XACCESS(self._x_access),
            xFullPathname=_XFULLPATH(self._x_fullpath),
            xDlOpen=None, xDlError=None, xDlSym=None, xDlClose=None,
            xRandomness=_XRANDOM(self._x_random),
            xSleep=_XSLEEP(self._x_sleep),
            xCurrentTime=_XCURTIME(self._x_curtime),
            xGetLastError=_XLASTERR(self._x_lasterr),
        )

    def register(self) -> None:
        rc = self._lib.sqlite3_vfs_register(ct.byref(self._vfs), 0)
        if rc != SQLITE_OK:
            raise RuntimeError(f"sqlite3_vfs_register: rc={rc}")
        self._registered = True

    def unregister(self) -> None:
        if self._registered:
            self._lib.sqlite3_vfs_unregister(ct.byref(self._vfs))
            self._registered = False
