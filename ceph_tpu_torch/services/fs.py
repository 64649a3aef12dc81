"""FS-lite: the MDS's metadata EXECUTOR on RADOS (the portion of the
src/mds role that turns namespace ops into omap mutations).

Layout mirrors CephFS's on-RADOS shape: every directory is an object
whose omap maps dentry name -> encoded inode (the CephFS dirfrag
role); file data is striped across data objects keyed by inode number
(``fsdata.<ino:x>``) through the osdc Striper, exactly how the
reference stripes file content into ``<ino>.<frag>`` objects. Inode
numbers allocate from a counter object.

THIS IS NOT THE CLIENT SURFACE. The CephFS client is
``services.mds.FSClient``, which routes every metadata op through the
MDS daemon (MDSLite) — that is where cap-mediated multi-client
coherence, the metadata journal, and snapshots live. Driving FSLite
directly is the single-writer shortcut the MDS itself uses server-side
(and what cluster-free unit tests drive); two FSLite instances have NO
coherence guarantees between them.

Surface: mkdir/rmdir/listdir/stat/create/write/read/truncate/unlink/
rename, nested paths, directory non-empty checks, file sizes.

ceph_tpu_torch's own copy of ``ceph_tpu/services/fs.py``.
"""
from __future__ import annotations

import time

from ..osdc.striper import FileLayout
from ..osdc.striped_client import RadosStriper
from ..utils import denc

ROOT_INO = 1
T_DIR = 1
T_FILE = 2


class FSError(Exception):
    pass


class NotADir(FSError):
    pass


class NotEmpty(FSError):
    pass


class NoEnt(FSError, KeyError):
    pass


class QuotaExceeded(FSError):
    """ceph.quota.max_bytes / max_files limit reached (EDQUOT role)."""


class Exists(FSError):
    pass


def _dir_oid(ino: int) -> bytes:
    return b"fsdir.%x" % ino


def _data_name(ino: int) -> str:
    return f"fsdata.{ino:x}"


def _enc_inode(ino: int, typ: int, size: int, mtime: float) -> bytes:
    return (denc.enc_u64(ino) + denc.enc_u8(typ) + denc.enc_u64(size)
            + denc.enc_u64(int(mtime)))


def _dec_inode(b: bytes) -> dict:
    ino, off = denc.dec_u64(b, 0)
    typ, off = denc.dec_u8(b, off)
    size, off = denc.dec_u64(b, off)
    mtime, _ = denc.dec_u64(b, off)
    return {"ino": ino, "type": typ, "size": size, "mtime": mtime}


class FSLite:
    def __init__(self, client, pool_id: int,
                 layout: FileLayout | None = None,
                 data_pool: int | None = None):
        self.client = client
        self.pool_id = pool_id
        #: file DATA may live in a different pool than the metadata
        #: (CephFS data vs metadata pools); the striper targets it
        self.data_pool = pool_id if data_pool is None else data_pool
        self.striper = RadosStriper(
            client, self.data_pool,
            layout or FileLayout(stripe_unit=1 << 20, stripe_count=2,
                                 object_size=1 << 22),
        )
        #: optional () -> (seq, [snap ids]) provider; the MDS wires its
        #: snap table here so DESTRUCTIVE data ops (unlink/truncate)
        #: preserve snapshot clones instead of erasing them
        self.snapc_cb = None

    def _snapc(self):
        return self.snapc_cb() if self.snapc_cb is not None else None

    # ------------------------------------------------------------- setup

    async def mkfs(self) -> None:
        """Create the root directory + inode allocator."""
        await self.client.write_full(self.pool_id, b"fsmeta.nextino",
                                     denc.enc_u64(2))
        await self.client.write_full(self.pool_id, _dir_oid(ROOT_INO),
                                     b"")

    async def _alloc_ino(self) -> int:
        from ..cluster.client import ObjectOperation

        # read-increment via compound op (atomic on the allocator)
        op = ObjectOperation().read()
        raw = (await self.client.operate(self.pool_id,
                                         b"fsmeta.nextino", op))[0]
        ino = denc.dec_u64(raw, 0)[0]
        await self.client.write_full(self.pool_id, b"fsmeta.nextino",
                                     denc.enc_u64(ino + 1))
        return ino

    # ------------------------------------------------------------ lookup

    def _split(self, path: str) -> list[str]:
        parts = [p for p in path.split("/") if p]
        return parts

    async def _dentry(self, dir_ino: int, name: str) -> dict:
        try:
            omap = await self.client.omap_get(self.pool_id,
                                              _dir_oid(dir_ino))
        except KeyError:
            raise NoEnt(f"dir ino {dir_ino}") from None
        raw = omap.get(name.encode())
        if raw is None:
            raise NoEnt(name)
        return _dec_inode(raw)

    async def _walk(self, parts: list[str]) -> int:
        """Resolve a directory path to its inode number."""
        ino = ROOT_INO
        for name in parts:
            ent = await self._dentry(ino, name)
            if ent["type"] != T_DIR:
                raise NotADir("/".join(parts))
            ino = ent["ino"]
        return ino

    async def _resolve(self, path: str) -> tuple[int, str]:
        """-> (parent dir ino, basename)."""
        parts = self._split(path)
        if not parts:
            raise FSError("root has no parent")
        return await self._walk(parts[:-1]), parts[-1]

    # ---------------------------------------------------------- metadata

    async def mkdir(self, path: str) -> None:
        parent, name = await self._resolve(path)
        if await self._exists(parent, name):
            raise Exists(path)
        ino = await self._alloc_ino()
        await self.client.write_full(self.pool_id, _dir_oid(ino), b"")
        await self.client.omap_set(
            self.pool_id, _dir_oid(parent),
            {name.encode(): _enc_inode(ino, T_DIR, 0, time.time())},
        )

    async def rmdir(self, path: str) -> None:
        parent, name = await self._resolve(path)
        ent = await self._dentry(parent, name)
        if ent["type"] != T_DIR:
            raise NotADir(path)
        children = await self.client.omap_get(self.pool_id,
                                              _dir_oid(ent["ino"]))
        if children:
            raise NotEmpty(path)
        await self.client.delete(self.pool_id, _dir_oid(ent["ino"]))
        await self.client.omap_rm(self.pool_id, _dir_oid(parent),
                                  [name.encode()])

    async def listdir(self, path: str = "/") -> list[str]:
        ino = await self._walk(self._split(path))
        omap = await self.client.omap_get(self.pool_id, _dir_oid(ino))
        return sorted(k.decode() for k in omap)

    async def stat(self, path: str) -> dict:
        parts = self._split(path)
        if not parts:
            return {"ino": ROOT_INO, "type": T_DIR, "size": 0,
                    "mtime": 0}
        parent = await self._walk(parts[:-1])
        return await self._dentry(parent, parts[-1])

    async def _exists(self, parent: int, name: str) -> bool:
        try:
            await self._dentry(parent, name)
            return True
        except NoEnt:
            return False

    async def rename(self, src: str, dst: str) -> None:
        sp, sn = await self._resolve(src)
        dp, dn = await self._resolve(dst)
        ent = await self._dentry(sp, sn)
        if await self._exists(dp, dn):
            raise Exists(dst)
        await self.client.omap_set(
            self.pool_id, _dir_oid(dp),
            {dn.encode(): _enc_inode(ent["ino"], ent["type"],
                                     ent["size"], time.time())},
        )
        await self.client.omap_rm(self.pool_id, _dir_oid(sp),
                                  [sn.encode()])

    # --------------------------------------------------------------- files

    async def create(self, path: str) -> int:
        parent, name = await self._resolve(path)
        if await self._exists(parent, name):
            raise Exists(path)
        ino = await self._alloc_ino()
        await self.client.omap_set(
            self.pool_id, _dir_oid(parent),
            {name.encode(): _enc_inode(ino, T_FILE, 0, time.time())},
        )
        return ino

    async def write(self, path: str, data: bytes,
                    offset: int = 0) -> None:
        parent, name = await self._resolve(path)
        try:
            ent = await self._dentry(parent, name)
        except NoEnt:
            await self.create(path)
            ent = await self._dentry(parent, name)
        if ent["type"] != T_FILE:
            raise FSError(f"{path} is a directory")
        await self.striper.write(_data_name(ent["ino"]), data, offset,
                                 snapc=self._snapc())
        new_size = max(ent["size"], offset + len(data))
        await self.client.omap_set(
            self.pool_id, _dir_oid(parent),
            {name.encode(): _enc_inode(ent["ino"], T_FILE, new_size,
                                       time.time())},
        )

    async def read(self, path: str, offset: int = 0,
                   length: int = -1) -> bytes:
        ent = await self.stat(path)
        if ent["type"] != T_FILE:
            raise FSError(f"{path} is a directory")
        if length < 0:
            length = max(0, ent["size"] - offset)
        length = min(length, max(0, ent["size"] - offset))
        return await self.striper.read(_data_name(ent["ino"]), offset,
                                       length)

    async def truncate(self, path: str, size: int) -> None:
        parent, name = await self._resolve(path)
        ent = await self._dentry(parent, name)
        if ent["type"] != T_FILE:
            raise FSError(f"{path} is a directory")
        await self.client.omap_set(
            self.pool_id, _dir_oid(parent),
            {name.encode(): _enc_inode(ent["ino"], T_FILE, size,
                                       time.time())},
        )
        if size == 0:
            await self.striper.remove(_data_name(ent["ino"]),
                                      snapc=self._snapc())
        elif size < ent["size"]:
            # physically cut the data tail: a later re-extending write
            # must read zeros in the gap, not the pre-truncate bytes
            # (grow stays logical: holes already read zero)
            await self.striper.truncate(_data_name(ent["ino"]), size,
                                        snapc=self._snapc())

    async def unlink(self, path: str) -> None:
        parent, name = await self._resolve(path)
        ent = await self._dentry(parent, name)
        if ent["type"] == T_DIR:
            raise FSError(f"{path} is a directory (use rmdir)")
        await self.striper.remove(_data_name(ent["ino"]),
                                  snapc=self._snapc())
        await self.client.omap_rm(self.pool_id, _dir_oid(parent),
                                  [name.encode()])

    # ------------------------------------------------------------ quotas

    ATTR_QUOTA = "fs.quota"

    async def _dir_ino_of(self, path: str) -> int:
        parts = self._split(path)
        if not parts:
            return ROOT_INO
        ino = await self._walk(parts)
        return ino

    async def set_quota(self, path: str, max_bytes: int = 0,
                        max_files: int = 0) -> None:
        """Set/clear the dir's quota (ceph.quota.max_bytes/max_files
        vxattr role; 0 = unlimited, both 0 clears the realm)."""
        import json

        ino = await self._dir_ino_of(path)
        await self.client.setxattr(
            self.pool_id, _dir_oid(ino), self.ATTR_QUOTA,
            json.dumps({"max_bytes": max_bytes,
                        "max_files": max_files}).encode())

    async def get_quota_ino(self, ino: int) -> dict | None:
        import json

        try:
            raw = await self.client.getxattr(
                self.pool_id, _dir_oid(ino), self.ATTR_QUOTA)
        except (KeyError, IOError):
            return None
        q = json.loads(raw)
        return q if q.get("max_bytes") or q.get("max_files") else None

    async def nearest_quota(self, path: str
                            ) -> tuple[str, dict] | None:
        """Deepest quota realm at or above ``path`` (the snaprealm-
        style quota-realm lookup of Client::get_quota_root)."""
        best = None
        q = await self.get_quota_ino(ROOT_INO)
        if q is not None:
            best = ("/", q)
        ino, prefix = ROOT_INO, ""
        for part in self._split(path):
            try:
                ent = await self._dentry(ino, part)
            except NoEnt:
                break
            if ent["type"] != T_DIR:
                break
            ino = ent["ino"]
            prefix += "/" + part
            q = await self.get_quota_ino(ino)
            if q is not None:
                best = (prefix, q)
        return best

    async def subtree_stats(self, path: str) -> tuple[int, int, int]:
        """(rbytes, rfiles, rsubdirs) — the rstat role, computed by a
        walk. The reference maintains these incrementally (rstats in
        CDir fnodes); at this build's scale an on-demand walk keeps
        the metadata path simpler and is exact at query time (modulo
        client-buffered sizes not yet flushed through caps)."""
        rbytes = rfiles = rsubdirs = 0
        todo = [await self._dir_ino_of(path)]
        while todo:
            ino = todo.pop()
            try:
                omap = await self.client.omap_get(self.pool_id,
                                                  _dir_oid(ino))
            except KeyError:
                continue
            for raw in omap.values():
                ent = _dec_inode(raw)
                if ent["type"] == T_DIR:
                    rsubdirs += 1
                    todo.append(ent["ino"])
                else:
                    rfiles += 1
                    rbytes += ent["size"]
        return rbytes, rfiles, rsubdirs
