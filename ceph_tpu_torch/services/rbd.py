"""RBD-lite: block images on RADOS (the src/librbd role).

Exclusive lock (src/librbd/ExclusiveLock.h:20 + exclusive_lock/ state
machines): a writable image handle arbitrates ownership through the cls
``lock`` class on the header object. Acquisition is lazy (first write),
release is cooperative (the holder watches its header and releases when
another handle notifies ``request_lock``), and an UNRESPONSIVE holder is
stolen from: break_lock + an osdmap blocklist entry fence the old
holder so its in-flight writes can never land (the reference's
blocklist-on-steal arc).

Object map (src/librbd/ObjectMap.h): a per-image bitmap of which data
objects exist, maintained under the exclusive lock in the
``rbd_object_map.<name>`` object. remove/flatten/rollback consult it
instead of stat-ing every object (fast-diff role).


An image is a FileLayout-striped set of data objects
(``rbd_data.<name>.<objectno:016x>``, default 4 MiB object size /
stripe_count 1 — the rbd default layout) plus a header object
(``rbd_header.<name>``) carrying size/layout/snap/parent metadata in
xattrs (portable to EC data pools, where omap is unsupported).

Covered surface (librbd/Operations.cc + io/ dispatch roles):
- create / remove / resize / stat / list
- Image.read / write / discard at byte offsets (striped fan-out via
  the osdc Striper)
- snapshots: snap_create / snap_list / snap_remove / snap_rollback,
  read-at-snap (``Image(..., snap=...)``) — snapshot objects are
  full-copy at snap time (object granularity), the lite stand-in for
  the reference's librados self-managed snaps
- layering: clone(parent@snap -> child) with object-granularity
  copy-up on first write (librbd parent overlap semantics), reads
  falling through to the parent snapshot, and flatten()

ceph_tpu_torch's own copy of ``ceph_tpu/services/rbd.py``.
"""
from __future__ import annotations

import asyncio
import secrets
import time

from ..osdc.striper import (
    FileLayout,
    StripedReadResult,
    extent_to_file,
    file_to_extents,
)
from ..utils import denc


class ImageNotFound(KeyError):
    pass


class ImageExists(Exception):
    pass


ATTR_SIZE = "rbd.size"
ATTR_LAYOUT = "rbd.layout"
ATTR_SNAPS = "rbd.snaps"  # list of (name, RADOS selfmanaged snap id)
ATTR_SNAPSEQ = "rbd.snapseq"  # image SnapContext seq (monotone)
ATTR_PARENT = "rbd.parent"  # "name@snap" of the clone source

LOCK_NAME = "rbd_lock"  # the cls lock name (librbd RBD_LOCK_NAME)
NOTIFY_REQUEST_LOCK = b"request_lock"
ATTR_OMAP_BITS = "rbd.objectmap"  # 1 byte/object: 1 = exists
ATTR_GROUP = "rbd.group"  # consistency-group back-pointer
ATTR_MIGRATING = "rbd.migrating"  # on the SOURCE: "pool/dst" target
ATTR_MIGRATION_SOURCE = "rbd.migration_source"  # on the DST: "pool/src"
ATTR_MIGRATION_EXECUTED = "rbd.migration_executed"


class LockBusy(Exception):
    """The exclusive lock is held by a live peer (EBUSY surface)."""


class _LockGuard:
    """Pins an Image's exclusive lock for the span of one mutating op:
    release_lock (cooperative or explicit) drains guards before the
    lock moves, so a peer can never observe a half-applied op."""

    def __init__(self, img: "Image"):
        self._img = img

    async def __aenter__(self):
        self._img._lock_users += 1
        return self

    async def __aexit__(self, *_exc):
        self._img._lock_users -= 1
        if self._img._lock_users == 0:
            self._img._idle_ev.set()
        return False


def _enc_snaps(pairs: list[tuple[str, int]]) -> bytes:
    return denc.enc_list(
        pairs, lambda p: denc.enc_str(p[0]) + denc.enc_u64(p[1])
    )


def _dec_snaps(raw: bytes) -> list[tuple[str, int]]:
    def one(b, o):
        nm, o = denc.dec_str(b, o)
        sid, o = denc.dec_u64(b, o)
        return (nm, sid), o

    return denc.dec_list(raw, 0, one)[0]

DEFAULT_LAYOUT = FileLayout(stripe_unit=1 << 22, stripe_count=1,
                            object_size=1 << 22)


def _header(name: str) -> str:
    return f"rbd_header.{name}"


def retained_bytes(layout: FileLayout, upto: int,
                   objno: int) -> int:
    """Highest in-object offset any byte of file range [0, upto) maps
    to in ``objno`` under striping — closed form, O(1) per object (an
    extent enumeration would walk upto/stripe_unit rows). Property-
    checked against file_to_extents over randomized layouts in
    test_rbd.py."""
    if upto <= 0:
        return 0
    su, sc = layout.stripe_unit, layout.stripe_count
    upo = layout.object_size // su  # stripe units per object
    nunits = -(-upto // su)         # touched file stripe units
    setno, pos = objno // sc, objno % sc
    limit = nunits - 1 - pos
    if limit < 0:
        return 0
    r = limit // sc - setno * upo   # last in-object unit with data
    if r < 0:
        return 0
    r = min(upo - 1, r)
    f = (setno * upo + r) * sc + pos  # its file unit index
    if f > nunits - 1:
        return 0
    return r * su + (su if f < nunits - 1 else upto - f * su)


def object_count(layout: FileLayout, size: int) -> int:
    """Objects a ``size``-byte image can touch. NOT
    ceil(size/object_size): striping round-robins stripe units across
    ``stripe_count`` objects per object SET, so a small image on a
    wide layout still spreads over the whole first set
    (Striper::get_num_objects role)."""
    if not size:
        return 0
    setsize = layout.object_size * layout.stripe_count
    full, rem = divmod(size, setsize)
    n = full * layout.stripe_count
    if rem:
        n += min(layout.stripe_count, -(-rem // layout.stripe_unit))
    return n


def _data_fmt(name: str) -> str:
    return f"rbd_data.{name}." + "{objectno:016x}"


def _omap_oid(name: str) -> str:
    return f"rbd_object_map.{name}"


def _enc_lock_input(*fields: str) -> bytes:
    return b"".join(denc.enc_str(f) for f in fields)


class RBD:
    """Pool-level image operations (the librbd::RBD role).

    ``namespace`` scopes every image (header, data, object map, trash,
    groups) to a RADOS namespace within the pool (rbd pool namespaces:
    librbd's RBD_NAMESPACE role) — tenants share a pool without
    sharing a flat image directory. The namespace registry itself
    lives in the pool's default namespace."""

    NAMESPACE_DIR = "rbd_namespace"

    def __init__(self, client, pool_id: int, namespace: str = ""):
        # the raw (default-namespace) client serves the registry; all
        # image objects ride the scoped IoCtx
        self._raw = getattr(client, "_client", client)
        self.namespace = namespace
        self.client = (client.ioctx(pool_id, namespace) if namespace
                       else client)
        self.pool_id = pool_id

    # ---------------------------------------------------- namespaces

    async def _namespaces(self) -> dict[bytes, bytes]:
        try:
            return await self._raw.omap_get(self.pool_id,
                                            self.NAMESPACE_DIR)
        except KeyError:
            return {}

    async def namespace_create(self, name: str) -> None:
        if not name:
            raise ValueError("namespace name must be non-empty")
        if name.encode() in await self._namespaces():
            raise ImageExists(f"namespace {name}")
        await self._raw.omap_set(self.pool_id, self.NAMESPACE_DIR,
                                 {name.encode(): b""})

    async def namespace_list(self) -> list[str]:
        return sorted(k.decode() for k in await self._namespaces())

    async def namespace_remove(self, name: str) -> None:
        if name.encode() not in await self._namespaces():
            raise ImageNotFound(f"namespace {name}")
        ns = RBD(self._raw, self.pool_id, namespace=name)
        if await ns.list() or await ns.trash_list():
            raise RuntimeError(f"namespace {name} is not empty")
        await self._raw.omap_rm(self.pool_id, self.NAMESPACE_DIR,
                                [name.encode()])

    async def create(self, name: str, size: int,
                     layout: FileLayout | None = None) -> None:
        layout = layout or DEFAULT_LAYOUT
        from ..cluster.client import ObjectOperation

        op = (ObjectOperation()
              .create()
              .setxattr(ATTR_SIZE, denc.enc_u64(size))
              .setxattr(ATTR_LAYOUT, _enc_layout(layout))
              .setxattr(ATTR_SNAPS, _enc_snaps([]))
              .setxattr(ATTR_SNAPSEQ, denc.enc_u64(0)))
        if await self._trash_reserved(name):
            # a trashed image's data objects still carry this name —
            # a fresh image would silently share them (see trash note)
            raise ImageExists(f"{name} (reserved by trash)")
        try:
            await self.client.operate(self.pool_id, _header(name), op)
        except IOError as e:
            if "-17" in str(e):
                raise ImageExists(name) from None
            raise
        # seed an all-absent object map: the image is known empty here,
        # which spares the first lock holder the full stat sweep the
        # fresh-map rebuild would otherwise run (fast-diff from byte 0)
        nobj = object_count(layout, size)
        seed = (ObjectOperation()
                .create(exclusive=False)
                .setxattr(ATTR_OMAP_BITS, bytes(nobj)))
        await self.client.operate(self.pool_id, _omap_oid(name), seed)

    async def open(self, name: str, snap: str | None = None,
                   cache: bool = False) -> "Image":
        img = Image(self.client, self.pool_id, name, snap=snap,
                    cache=cache)
        await img.refresh()
        return img

    async def list(self) -> list[str]:
        """Image names in the pool (rbd ls role) via the PGLS sweep."""
        prefix = b"rbd_header."
        return sorted(
            oid[len(prefix):].decode()
            for oid in await self.client.list_objects(self.pool_id)
            if oid.startswith(prefix))

    async def _image_group(self, name: str) -> str:
        try:
            hdr = await self.client.getxattrs(self.pool_id,
                                              _header(name))
        except KeyError:
            return ""
        return hdr.get(ATTR_GROUP, b"").decode()

    async def remove(self, name: str) -> None:
        img = await self.open(name)
        if img.snaps:
            raise RuntimeError(f"image {name} has snapshots")
        if await self._image_group(name):
            raise RuntimeError(f"image {name} is in a group")
        await img.acquire_lock()  # loads/rebuilds the object map
        async with img._io_guard():
            await img._remove_objects()
        await img.release_lock()
        try:
            await self.client.delete(self.pool_id, _omap_oid(name))
        except KeyError:
            pass
        await self.client.delete(self.pool_id, _header(name))

    # --------------------------------------------------------------- trash
    #
    # librbd Trash.cc role. Data objects are keyed by image NAME here
    # (the reference keys by immutable id), so a trashed image's name
    # stays RESERVED (create() refuses it) until restore or purge —
    # otherwise a new same-name image would share rbd_data.<name>.*
    # with the corpse. Restore is therefore to the original name only.

    TRASH_DIR = "rbd_trash"

    @staticmethod
    def _trash_header(tid: str) -> str:
        return f"rbd_trash_header.{tid}"

    @staticmethod
    def _enc_trash(name: str, ts: float, defer_end: float) -> bytes:
        return (denc.enc_str(name) + denc.enc_u64(int(ts))
                + denc.enc_u64(int(defer_end)))

    @staticmethod
    def _dec_trash(b: bytes) -> dict:
        name, off = denc.dec_str(b, 0)
        ts, off = denc.dec_u64(b, off)
        de, _ = denc.dec_u64(b, off)
        return {"name": name, "trashed_at": ts, "defer_end": de}

    async def _trash_entries(self) -> dict[bytes, bytes]:
        try:
            return await self.client.omap_get(self.pool_id,
                                              self.TRASH_DIR)
        except KeyError:
            return {}

    async def _trash_reserved(self, name: str) -> bool:
        return any(self._dec_trash(v)["name"] == name
                   for v in (await self._trash_entries()).values())

    async def trash_move(self, name: str, delay_s: float = 0.0) -> str:
        """Defer-delete an image (`rbd trash mv`): the header moves
        aside, the image vanishes from `list`, data stays. Returns the
        trash id. ``delay_s`` sets the deferment window `trash rm`
        honors without --force."""
        # open() validates existence and refuses mid-migration images
        img = await self.open(name)
        if await self._image_group(name):
            raise RuntimeError(f"image {name} is in a group")
        # fence live writers like remove() does: the exclusive lock is
        # taken (stealing from dead holders) before the header goes —
        # otherwise a holder would keep mutating the corpse's data
        # objects and its lock record would die with the header
        await img.acquire_lock()
        try:
            xattrs = await self.client.getxattrs(self.pool_id,
                                                 _header(name))
            now = time.time()
            tid = secrets.token_hex(8)
            from ..cluster.client import ObjectOperation

            op = ObjectOperation().create()
            for k, v in xattrs.items():
                if k.startswith("lock."):
                    # never preserve cls lock state: the restored
                    # image must come back unlocked, not haunted by
                    # this (about-to-die) handle's ownership record
                    continue
                op = op.setxattr(k, v)
            await self.client.operate(self.pool_id,
                                      self._trash_header(tid), op)
            await self.client.omap_set(
                self.pool_id, self.TRASH_DIR,
                {tid.encode():
                 self._enc_trash(name, now, now + delay_s)})
            # the dir entry is durable before the visible name
            # disappears: a crash between the two leaves both headers,
            # restore wins
            await self.client.delete(self.pool_id, _header(name))
        finally:
            try:
                await img.release_lock()
            except Exception:
                pass  # the lock record went with the header
        return tid

    async def trash_list(self) -> list[dict]:
        out = []
        for k, v in sorted((await self._trash_entries()).items()):
            ent = self._dec_trash(v)
            ent["id"] = k.decode()
            out.append(ent)
        return out

    async def _trash_materialize(self, tid: str) -> str:
        """Recreate the live header from the trash header (no
        directory-entry change); returns the original name."""
        ents = await self._trash_entries()
        raw = ents.get(tid.encode())
        if raw is None:
            raise ImageNotFound(tid)
        name = self._dec_trash(raw)["name"]
        xattrs = await self.client.getxattrs(
            self.pool_id, self._trash_header(tid))
        from ..cluster.client import ObjectOperation

        op = ObjectOperation().create(exclusive=False)
        for k, v in xattrs.items():
            op = op.setxattr(k, v)
        await self.client.operate(self.pool_id, _header(name), op)
        return name

    async def _trash_drop_entry(self, tid: str) -> None:
        try:
            await self.client.delete(self.pool_id,
                                     self._trash_header(tid))
        except KeyError:
            pass
        await self.client.omap_rm(self.pool_id, self.TRASH_DIR,
                                  [tid.encode()])

    async def trash_restore(self, tid: str) -> str:
        """`rbd trash restore`: the header returns under its original
        name (reserved meanwhile, so it cannot be taken)."""
        name = await self._trash_materialize(tid)
        await self._trash_drop_entry(tid)
        return name

    async def trash_remove(self, tid: str, force: bool = False) -> None:
        """`rbd trash rm`: delete the image + its data for good;
        refuses inside the deferment window unless forced."""
        ents = await self._trash_entries()
        raw = ents.get(tid.encode())
        if raw is None:
            raise ImageNotFound(tid)
        ent = self._dec_trash(raw)
        if not force and time.time() < ent["defer_end"]:
            raise RuntimeError(
                f"{ent['name']} deferred until {ent['defer_end']}")
        # materialize under the (reserved) original name so the normal
        # removal path tears down data + object map + header — but the
        # TRASH ENTRY is dropped only after the teardown succeeds: a
        # failure mid-removal must leave the image findable in trash
        # (retryable), never silently resurrected as live
        name = await self._trash_materialize(tid)
        img = await self.open(name)
        for s in list(img.snaps):
            await img.snap_remove(s)
        await self.remove(name)
        await self._trash_drop_entry(tid)

    async def trash_purge(self) -> list[str]:
        """Remove every trash entry whose deferment has passed."""
        removed = []
        now = time.time()
        for ent in await self.trash_list():
            if now >= ent["defer_end"]:
                await self.trash_remove(ent["id"])
                removed.append(ent["name"])
        return removed

    # -------------------------------------------------------------- groups
    #
    # librbd api/Group.cc + cls_rbd group directory role: a pool-level
    # directory object maps group name -> group object; the group
    # object's omap holds members ("image.<name>") and group snapshots
    # ("snap.<name>" -> [(image, image-snap)]).

    GROUP_DIR = "rbd_group_directory"

    @staticmethod
    def _group_oid(group: str) -> str:
        return f"rbd_group.{group}"

    async def _group_members(self, group: str) -> list[str]:
        dirmap = await self._group_dir()
        if group.encode() not in dirmap:
            raise ImageNotFound(f"group {group}")
        try:
            omap = await self.client.omap_get(self.pool_id,
                                              self._group_oid(group))
        except KeyError:
            return []
        return sorted(k.decode()[6:] for k in omap
                      if k.startswith(b"image."))

    async def _group_dir(self) -> dict[bytes, bytes]:
        try:
            return await self.client.omap_get(self.pool_id,
                                              self.GROUP_DIR)
        except KeyError:
            return {}

    async def group_create(self, group: str) -> None:
        if group.encode() in await self._group_dir():
            raise ImageExists(f"group {group}")
        await self.client.write_full(self.pool_id,
                                     self._group_oid(group), b"")
        await self.client.omap_set(self.pool_id, self.GROUP_DIR,
                                   {group.encode(): b""})

    async def group_list(self) -> list[str]:
        return sorted(k.decode() for k in await self._group_dir())

    async def group_remove(self, group: str) -> None:
        """Remove a group; member images are detached (their group
        back-pointer clears), group snapshots must be removed first."""
        for snap in await self.group_snap_list(group):
            raise RuntimeError(
                f"group {group} has snapshot {snap['name']}")
        for name in await self._group_members(group):
            await self.group_image_remove(group, name)
        await self.client.delete(self.pool_id, self._group_oid(group))
        await self.client.omap_rm(self.pool_id, self.GROUP_DIR,
                                  [group.encode()])

    async def group_image_add(self, group: str, name: str) -> None:
        await self._group_members(group)  # group must exist
        hdr = await self.client.getxattrs(self.pool_id, _header(name))
        if ATTR_GROUP in hdr and hdr[ATTR_GROUP].decode():
            raise ImageExists(
                f"{name} already in group {hdr[ATTR_GROUP].decode()}")
        await self.client.setxattr(self.pool_id, _header(name),
                                   ATTR_GROUP, group.encode())
        await self.client.omap_set(self.pool_id,
                                   self._group_oid(group),
                                   {b"image." + name.encode(): b""})

    async def group_image_remove(self, group: str, name: str) -> None:
        await self._group_members(group)
        await self.client.omap_rm(self.pool_id, self._group_oid(group),
                                  [b"image." + name.encode()])
        try:
            await self.client.setxattr(self.pool_id, _header(name),
                                       ATTR_GROUP, b"")
        except KeyError:
            pass  # image already deleted

    async def group_image_list(self, group: str) -> list[str]:
        return await self._group_members(group)

    async def group_snap_create(self, group: str, snap: str) -> None:
        """Crash-consistent snapshot across every member: exclusive
        locks on ALL members are taken first (sorted — no ABBA), so no
        writer mutates any member between the first and last image
        snap (the group quiesce barrier of api/Group.cc)."""
        members = await self._group_members(group)
        key = b"snap." + snap.encode()
        omap = await self.client.omap_get(self.pool_id,
                                          self._group_oid(group))
        if key in omap:
            raise ImageExists(f"{group}@{snap}")
        imgs = []
        pairs: list[tuple[str, str]] = []
        try:
            for name in members:  # sorted by _group_members
                img = await self.open(name)
                await img.acquire_lock()
                imgs.append(img)
            for img in imgs:
                isnap = f".group.{group}.{snap}"
                await img.snap_create(isnap)
                pairs.append((img.name, isnap))
            await self.client.omap_set(
                self.pool_id, self._group_oid(group),
                {key: denc.enc_list(
                    pairs, lambda p: denc.enc_str(p[0])
                    + denc.enc_str(p[1]))})
            pairs = []  # committed: nothing to unwind
        finally:
            # partial failure: roll back already-taken member snaps,
            # or a retry would hit snapshot-exists forever with no
            # group entry recording the orphans
            for img in imgs:
                taken = next((s for n, s in pairs if n == img.name),
                             None)
                if taken is not None:
                    try:
                        await img.snap_remove(taken)
                    except Exception:
                        pass
                try:
                    await img.release_lock()
                except Exception:
                    pass

    async def group_snap_list(self, group: str) -> list[dict]:
        await self._group_members(group)
        try:
            omap = await self.client.omap_get(self.pool_id,
                                              self._group_oid(group))
        except KeyError:
            return []
        out = []

        def one(b, o):
            img, o = denc.dec_str(b, o)
            sn, o = denc.dec_str(b, o)
            return (img, sn), o

        for k, v in sorted(omap.items()):
            if not k.startswith(b"snap."):
                continue
            pairs, _ = denc.dec_list(v, 0, one)
            out.append({"name": k[5:].decode(), "members": pairs})
        return out

    async def group_snap_remove(self, group: str, snap: str) -> None:
        for ent in await self.group_snap_list(group):
            if ent["name"] != snap:
                continue
            for img_name, isnap in ent["members"]:
                try:
                    img = await self.open(img_name)
                    await img.snap_remove(isnap)
                except (ImageNotFound, KeyError):
                    pass  # member deleted since the snap
            await self.client.omap_rm(
                self.pool_id, self._group_oid(group),
                [b"snap." + snap.encode()])
            return
        raise KeyError(snap)

    async def group_snap_rollback(self, group: str, snap: str) -> None:
        """Roll every member back to the group snapshot, under the
        same all-member lock barrier as create."""
        ent = next((e for e in await self.group_snap_list(group)
                    if e["name"] == snap), None)
        if ent is None:
            raise KeyError(snap)
        imgs = []
        try:
            for img_name, _ in sorted(ent["members"]):
                img = await self.open(img_name)
                await img.acquire_lock()
                imgs.append(img)
            for img, (_n, isnap) in zip(imgs, sorted(ent["members"])):
                await img.snap_rollback(isnap)
        finally:
            for img in imgs:
                try:
                    await img.release_lock()
                except Exception:
                    pass

    async def clone(self, parent: str, snap: str, child: str) -> None:
        """Layered child image backed by parent@snap (librbd clone
        role); unwritten extents read through to the parent."""
        p = await self.open(parent)
        if snap not in p.snaps:
            raise KeyError(f"{parent}@{snap}")
        await self.create(child, p.size, p.layout)
        await self.client.setxattr(
            self.pool_id, _header(child), ATTR_PARENT,
            f"{parent}@{snap}".encode(),
        )

    # ------------------------------------------- deep copy + migration

    async def deep_copy(self, src_name: str, dst_name: str,
                        dst_rbd: "RBD | None" = None,
                        layout: FileLayout | None = None) -> None:
        """Full image copy INCLUDING snapshot history, optionally to
        another pool and/or a new layout (librbd DeepCopyRequest role,
        src/librbd/DeepCopyRequest.cc): each source snapshot level
        replays oldest-first into the destination and is re-frozen
        there, so dst@s matches src@s for every s."""
        dst_rbd = dst_rbd or self
        src = await self.open(src_name)
        try:
            await dst_rbd.open(dst_name)
            raise ImageExists(dst_name)
        except ImageNotFound:
            pass
        await dst_rbd.create(dst_name, src.size, layout or src.layout)
        dst = await dst_rbd.open(dst_name)
        await dst.acquire_lock()
        try:
            await self._replay_levels(src_name, dst)
        finally:
            await dst.release_lock()

    async def _replay_levels(self, src_name: str, dst: "Image") -> None:
        """Replay every source snapshot level then the head into dst
        (dst's lock must be held). Objects dst ALREADY owns are left
        alone — for a migration target that means a client write made
        after prepare wins over history replay (its object's snapshot
        levels collapse onto the written content; the reference keeps
        per-snap object states, the lite tier documents the collapse)."""
        src0 = Image(self.client, self.pool_id, src_name,
                     allow_migrating=True)
        await src0.refresh()
        async def probe(objno: int):
            try:
                await self.client.stat(dst.pool_id, dst._oid(objno))
                return objno
            except KeyError:
                return None

        owned = set(
            o for o in await asyncio.gather(
                *(probe(i) for i in range(dst._object_count())))
            if o is not None)
        prev: dict[int, bytes] = {}
        levels: list[str | None] = list(src0.snaps) + [None]
        for snap in levels:
            src = Image(self.client, self.pool_id, src_name,
                        snap=snap, allow_migrating=True)
            await src.refresh()
            for objno in range(dst._object_count()):
                if objno in owned:
                    continue
                runs = extent_to_file(dst.layout, objno, 0,
                                      dst.layout.object_size)
                parts = await asyncio.gather(
                    *(src.read(fo, fl) for fo, fl in runs))
                content = b"".join(
                    p + b"\x00" * (fl - len(p))
                    for p, (_fo, fl) in zip(parts, runs)
                ).rstrip(b"\x00")
                if content == prev.get(objno, b""):
                    continue  # unchanged at this level: snap shares it
                await dst._omap_prewrite((objno,))
                await self.client.write_full(
                    dst.pool_id, dst._oid(objno), content,
                    snapc=dst._snapc())
                dst._omap_settle(objno, True)  # exists (maybe empty)
                prev[objno] = content
            if snap is not None:
                await dst.snap_create(snap)

    async def migration_prepare(self, src_name: str, dst_name: str,
                                dst_rbd: "RBD | None" = None,
                                layout: FileLayout | None = None
                                ) -> None:
        """Link src -> dst for live migration (librbd migration role,
        src/librbd/api/Migration.cc): after prepare, clients open the
        TARGET (the source refuses opens); target reads fall through
        to the source at byte level (layout may differ), writes
        copy-up. execute() moves the remaining data + snapshot
        history in the background; commit() retires the source."""
        dst_rbd = dst_rbd or self
        src = await self.open(src_name)
        try:
            await dst_rbd.open(dst_name)
            raise ImageExists(dst_name)
        except ImageNotFound:
            pass
        await dst_rbd.create(dst_name, src.size, layout or src.layout)
        await dst_rbd.client.setxattr(
            dst_rbd.pool_id, _header(dst_name), ATTR_MIGRATION_SOURCE,
            f"{self.pool_id}/{src_name}".encode())
        await self.client.setxattr(
            self.pool_id, _header(src_name), ATTR_MIGRATING,
            f"{dst_rbd.pool_id}/{dst_name}".encode())

    async def migration_execute(self, dst_name: str) -> None:
        """Copy everything still unowned from the source (snapshot
        levels first, then head), under the target's exclusive lock."""
        dst = await self.open(dst_name)
        if dst._mig_src is None:
            raise RuntimeError(f"{dst_name} is not a migration target")
        src = dst._mig_src
        src_rbd = RBD(self.client, src.pool_id)
        await dst.acquire_lock()
        try:
            await src_rbd._replay_levels(src.name, dst)
            await self.client.setxattr(
                self.pool_id, _header(dst_name),
                ATTR_MIGRATION_EXECUTED, b"1")
        finally:
            await dst.release_lock()

    async def migration_commit(self, dst_name: str) -> None:
        """Retire the source image; the target stands alone."""
        dst = await self.open(dst_name)
        if dst._mig_src is None:
            raise RuntimeError(f"{dst_name} is not a migration target")
        try:
            await self.client.getxattr(
                self.pool_id, _header(dst_name),
                ATTR_MIGRATION_EXECUTED)
        except (KeyError, IOError):  # ENODATA: xattr absent
            raise RuntimeError(
                f"{dst_name}: migration not executed yet") from None
        src = dst._mig_src
        src_rbd = RBD(self.client, src.pool_id)
        await src_rbd._remove_migrating_source(src.name)
        await self.client.rmxattr(
            self.pool_id, _header(dst_name), ATTR_MIGRATION_SOURCE)
        await self.client.rmxattr(
            self.pool_id, _header(dst_name), ATTR_MIGRATION_EXECUTED)

    async def migration_abort(self, dst_name: str) -> None:
        """Tear the target down and give the source back to clients."""
        dst = await self.open(dst_name)
        if dst._mig_src is None:
            raise RuntimeError(f"{dst_name} is not a migration target")
        src = dst._mig_src
        await self.client.rmxattr(
            src.pool_id, _header(src.name), ATTR_MIGRATING)
        dst._mig_src = None  # keep remove() from re-resolving it
        for snap in list(dst.snaps):  # replayed levels die with it
            await dst.snap_remove(snap)
        await self.remove(dst_name)

    async def _remove_migrating_source(self, name: str) -> None:
        img = Image(self.client, self.pool_id, name,
                    allow_migrating=True)
        await img.refresh()
        for snap in list(img.snaps):
            await img.snap_remove(snap)
        await img.acquire_lock()
        async with img._io_guard():
            await img._remove_objects()
        await img.release_lock()
        try:
            await self.client.delete(self.pool_id, _omap_oid(name))
        except KeyError:
            pass
        await self.client.delete(self.pool_id, _header(name))


def _enc_layout(lo: FileLayout) -> bytes:
    return (denc.enc_u64(lo.stripe_unit) + denc.enc_u64(lo.stripe_count)
            + denc.enc_u64(lo.object_size))


def _dec_layout(b: bytes) -> FileLayout:
    su, off = denc.dec_u64(b, 0)
    sc, off = denc.dec_u64(b, off)
    os_, _ = denc.dec_u64(b, off)
    return FileLayout(stripe_unit=su, stripe_count=sc, object_size=os_)


class Image:
    """One open image (librbd::Image role)."""

    def __init__(self, client, pool_id: int, name: str,
                 snap: str | None = None, exclusive: bool = True,
                 cache: bool = False, allow_migrating: bool = False):
        self.client = client
        self.pool_id = pool_id
        self.name = name
        #: internal opens during migration bypass the mid-migration
        #: guard (clients must open the TARGET, librbd migration role)
        self._allow_migrating = allow_migrating
        #: source Image handle while THIS image is a migration target
        self._mig_src: "Image | None" = None
        #: optional write-back/read-ahead data cache (ObjectCacher
        #: role); only served while the exclusive lock is OWNED (cached
        #: reads acquire it, librbd's exclusive-lock+cache behavior),
        #: flushed + invalidated at every ownership/snapshot boundary.
        #: _io is the data-path client: the CacheIo facade when caching,
        #: the raw client otherwise — call sites never branch.
        self._cacher = None
        self._io = client
        if cache and snap is None:
            from ..osdc.object_cacher import CacheIo, ObjectCacher

            self._cacher = ObjectCacher(client, pool_id)
            self._io = CacheIo(client, self._cacher)
        self.snap = snap
        self.size = 0
        self.layout = DEFAULT_LAYOUT
        self.snaps: list[str] = []
        self.snap_ids: dict[str, int] = {}
        self.snap_seq = 0
        self.parent: tuple[str, str] | None = None
        self._parent_snapid: int | None = None
        #: exclusive-lock state (ExclusiveLock.h:20 role). The owner is
        #: the CLIENT entity (what the blocklist fences); the cookie
        #: distinguishes handles of one client.
        self.exclusive = exclusive
        self.lock_owned = False
        self._lock_cookie = secrets.token_hex(8)
        self._watch_cookie: int | None = None
        self._releasing = False
        #: object-map state bytes (valid only while lock_owned);
        #: 0 = absent, 1 = exists, 2 = pending (see the object-map
        #: section's invariants)
        self._omap: bytearray | None = None
        self._omap_dirty = False
        #: in-flight guarded ops: release_lock drains these before the
        #: lock changes hands (exclusivity across whole ops)
        self._lock_users = 0
        self._idle_ev = asyncio.Event()
        self._acquire_mu = asyncio.Lock()

    # ----------------------------------------------------- exclusive lock

    async def acquire_lock(self, timeout: float = 5.0,
                           steal_dead: bool = True) -> None:
        """Take the exclusive lock (lazily called by the write path).

        Cooperative transition: on EBUSY, notify the header — a LIVE
        holder releases when its in-flight IO drains and we retry. The
        steal deadline applies PER HOLDER (it resets whenever the
        observed holder changes): only an owner that sat unresponsive
        through the whole window is broken + BLOCKLISTED (the
        reference's acquire->request->break->blocklist arc); a fenced
        holder's late writes bounce EBLOCKLISTED at every OSD."""
        from ..cluster.client import RadosError

        if self.snap is not None:
            return
        async with self._acquire_mu:
            if self.lock_owned:
                return
            await self._acquire_locked(timeout, steal_dead, RadosError)

    async def _acquire_locked(self, timeout, steal_dead,
                              RadosError) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        last_holder: tuple[str, str] | None = None
        while True:
            try:
                await self.client.execute(
                    self.pool_id, _header(self.name), "lock", "lock",
                    _enc_lock_input(LOCK_NAME, "exclusive",
                                    self.client.name, self._lock_cookie))
                break
            except RadosError as e:
                if e.code != -16:  # not EBUSY
                    raise
            holder = await self._lock_holder()
            if holder is None:
                continue  # released between attempts
            if holder != last_holder:
                # a DIFFERENT owner took it (e.g. another waiter won a
                # steal): it deserves its own full cooperative window —
                # stealing from a live, freshly-acquired holder would
                # blocklist a healthy client
                last_holder = holder
                deadline = loop.time() + timeout
            # cooperative: ask the holder to let go
            try:
                await self.client.notify(
                    self.pool_id, _header(self.name), NOTIFY_REQUEST_LOCK)
            except Exception:
                pass
            await asyncio.sleep(0.05)
            if loop.time() > deadline:
                if not steal_dead:
                    raise LockBusy(f"{self.name}: lock held by "
                                   f"{holder[0]}/{holder[1]}")
                await self._steal_lock(holder)
        # the map and watch must be READY before lock_owned flips: a
        # concurrent op passing _ensure_lock the instant the flag turns
        # would otherwise write with _omap None, skipping the persisted
        # pending bit remove() trusts
        await self._load_object_map()
        if self._watch_cookie is None:
            self._watch_cookie = await self.client.watch(
                self.pool_id, _header(self.name), self._header_notify)
        self.lock_owned = True

    async def _steal_lock(self, holder: tuple[str, str]) -> None:
        """Fence-then-break (ExclusiveLock break_lock + blocklist):
        the ORDER matters — blocklist first, so the dead holder's
        in-flight writes can no longer land when the lock changes
        hands."""
        from ..cluster.client import RadosError

        owner, _cookie = holder
        if owner == self.client.name:
            # our own other handle holds it and is not releasing: a
            # steal cannot be made safe (fencing the entity would fence
            # US too) — surface it instead of running two writers
            raise LockBusy(
                f"{self.name}: lock held by another handle of "
                f"{owner}; release it there")
        await self.client.blocklist_add(owner)
        try:
            await self.client.execute(
                self.pool_id, _header(self.name), "lock", "break_lock",
                _enc_lock_input(LOCK_NAME, owner))
        except KeyError:
            pass  # ENOENT: released while we were fencing
        except RadosError as e:
            if e.code != -2:
                raise

    async def release_lock(self) -> None:
        if not self.lock_owned or self._releasing:
            return
        # _releasing gates BOTH duplicate cooperative releases and new
        # ops starting mid-release (_ensure_lock waits on it): without
        # it a write beginning during the awaits below would run
        # unlocked behind the next owner's back
        self._releasing = True
        try:
            # drain: the exclusivity contract means no write of OURS
            # may still be in flight when the next owner starts — wait
            # for guarded ops (ExclusiveLock pre-release hook role)
            while self._lock_users:
                self._idle_ev.clear()
                await self._idle_ev.wait()
            if self._cacher is not None:
                # the cache fence: buffered writes land before the
                # lock can change hands, then nothing stale survives
                await self._cacher.flush()
                self._cacher.invalidate()
            await self._save_object_map()
            self.lock_owned = False
            self._omap = None
            self._omap_dirty = False
            try:
                await self.client.execute(
                    self.pool_id, _header(self.name), "lock", "unlock",
                    _enc_lock_input(LOCK_NAME, self.client.name,
                                    self._lock_cookie))
            except (KeyError, IOError):
                pass  # already broken/stolen: nothing to release
            if self._watch_cookie is not None:
                try:
                    await self.client.unwatch(
                        self.pool_id, _header(self.name),
                        self._watch_cookie)
                except Exception:
                    pass
                self._watch_cookie = None
        finally:
            self._releasing = False

    def _header_notify(self, _oid, _notify_id, payload) -> None:
        """Watch callback: a peer wants the lock — release once the
        in-flight guarded IO drains (cooperative transition)."""
        if payload == NOTIFY_REQUEST_LOCK and self.lock_owned \
                and not self._releasing:
            asyncio.get_running_loop().create_task(self.release_lock())

    async def _lock_holder(self) -> tuple[str, str] | None:
        raw = await self.client.execute(
            self.pool_id, _header(self.name), "lock", "get_info",
            _enc_lock_input(LOCK_NAME))
        ltype, off = denc.dec_str(raw, 0)
        if ltype == "none":
            return None

        def one(b, o):
            owner, o = denc.dec_str(b, o)
            cookie, o = denc.dec_str(b, o)
            _expiry, o = denc.dec_u64(b, o)  # rbd locks never expire
            return (owner, cookie), o

        holders, _ = denc.dec_list(raw, off, one)
        return holders[0] if holders else None

    async def _ensure_lock(self) -> None:
        if not self.exclusive:
            return
        while self._releasing:
            # a cooperative handover is mid-flight: let it finish, then
            # re-acquire — jumping in now would write behind the new
            # owner's back
            await asyncio.sleep(0.01)
        if not self.lock_owned:
            await self.acquire_lock()
            if self._omap is None and self.snap is None:
                # paranoia tripwire for the acquire/ensure contract
                raise RuntimeError("lock acquired without object map")

    def _io_guard(self) -> "_LockGuard":
        """Async context every mutating op runs under: it pins the lock
        (release waits for zero guards) so exclusivity holds across the
        WHOLE op, not just its first await."""
        return _LockGuard(self)

    # --------------------------------------------------------- object map
    #
    # Two-state bits (ObjectMap.h OBJECT_EXISTS / OBJECT_PENDING role):
    #   0 = nonexistent, 1 = exists (verified), 2 = pending (a write
    #   was INTENDED; whether it landed is unknown).
    # Invariants: a data write is preceded by a persisted >=pending bit
    # (so remove() can trust 0 bits absolutely), and copy-up/flatten
    # skip only on EXISTS (a pending bit proves nothing about content —
    # trusting it after a crash mid-copy-up would detach the parent
    # over a hole and silently lose data). Pending bits left behind by
    # a crash are resolved by stat on the next load.

    async def _load_object_map(self) -> None:
        nobj = self._object_count()
        try:
            raw = await self.client.getxattr(
                self.pool_id, _omap_oid(self.name), ATTR_OMAP_BITS)
            bits = bytearray(raw)
        except (KeyError, IOError):
            bits = bytearray()
        fresh = not bits and nobj > 0
        if len(bits) != nobj:
            old = bits
            bits = bytearray(nobj)
            bits[: min(len(old), nobj)] = old[: min(len(old), nobj)]
        unknown = ([i for i in range(nobj)] if fresh
                   else [i for i, b in enumerate(bits) if b == 2])
        if unknown:
            # resolve by stat: fresh map rebuild, or pending bits left
            # by a crashed/fenced holder (rebuild-object-map role)
            async def probe(i):
                try:
                    await self.client.stat(self.pool_id, self._oid(i))
                    bits[i] = 1
                except KeyError:
                    bits[i] = 0
            await asyncio.gather(*(probe(i) for i in unknown))
        self._omap = bits
        self._omap_dirty = fresh or bool(unknown)

    async def _save_object_map(self) -> None:
        if self._omap is None or not self._omap_dirty:
            return
        from ..cluster.client import ObjectOperation

        op = (ObjectOperation()
              .create(exclusive=False)
              .setxattr(ATTR_OMAP_BITS, bytes(self._omap)))
        await self.client.operate(
            self.pool_id, _omap_oid(self.name), op)
        self._omap_dirty = False

    async def _omap_prewrite(self, objectnos) -> None:
        """Mark every object an op is about to touch as PENDING and
        persist ONCE before any data lands (one round trip per op, not
        per object)."""
        if self._omap is None:
            return
        changed = False
        for objectno in objectnos:
            if objectno >= len(self._omap):
                self._omap.extend(
                    bytearray(objectno + 1 - len(self._omap)))
            if self._omap[objectno] == 0:
                self._omap[objectno] = 2
                changed = True
        if changed:
            self._omap_dirty = True
            await self._save_object_map()

    def _omap_settle(self, objectno: int, exists: bool) -> None:
        """Record the VERIFIED outcome after the data op returned
        (in-memory; persisted at the next save point — a crash loses
        only the pending->exists refinement, which reloads via stat)."""
        if self._omap is None:
            return
        if objectno >= len(self._omap):
            self._omap.extend(bytearray(objectno + 1 - len(self._omap)))
        want = 1 if exists else 0
        if self._omap[objectno] != want:
            self._omap[objectno] = want
            self._omap_dirty = True

    async def flush(self) -> None:
        """Force buffered cache writes out (librbd flush role); no-op
        without the cache."""
        if self._cacher is not None:
            await self._cacher.flush()

    def object_map(self) -> bytes | None:
        """Fast-diff surface: per-object state bytes (0 absent,
        1 exists, 2 pending); None when not authoritative (lock not
        held)."""
        return bytes(self._omap) if self._omap is not None else None

    # ------------------------------------------------------------- meta

    def _snapc(self) -> tuple[int, list[int]]:
        """The image's write SnapContext: data-object writes carry it so
        RADOS makes lazy clones (librbd sits on selfmanaged snaps —
        ImageCtx::snapc role)."""
        return (self.snap_seq,
                sorted(self.snap_ids.values(), reverse=True))

    async def refresh(self) -> None:
        try:
            attrs = await self.client.getxattrs(
                self.pool_id, _header(self.name)
            )
        except KeyError:
            raise ImageNotFound(self.name) from None
        if attrs.get(ATTR_MIGRATING) and not self._allow_migrating:
            raise RuntimeError(
                f"image {self.name} is mid-migration; open the target "
                f"{attrs[ATTR_MIGRATING].decode()!r}")
        raw_src = attrs.get(ATTR_MIGRATION_SOURCE)
        if raw_src and self._mig_src is None:
            spool, sname = raw_src.decode().split("/", 1)
            src = Image(self.client, int(spool), sname,
                        allow_migrating=True)
            await src.refresh()
            self._mig_src = src
        elif not raw_src:
            self._mig_src = None
        self.size = denc.dec_u64(attrs[ATTR_SIZE], 0)[0]
        self.layout = _dec_layout(attrs[ATTR_LAYOUT])
        pairs = _dec_snaps(attrs[ATTR_SNAPS])
        self.snaps = [nm for nm, _ in pairs]
        self.snap_ids = dict(pairs)
        self.snap_seq = denc.dec_u64(
            attrs.get(ATTR_SNAPSEQ, denc.enc_u64(0)), 0)[0]
        if self.snap is not None and self.snap not in self.snaps:
            raise KeyError(f"{self.name}@{self.snap}")
        raw = attrs.get(ATTR_PARENT)
        if raw:
            pname, psnap = raw.decode().split("@", 1)
            self.parent = (pname, psnap)
            # resolve the parent snap's RADOS id once per refresh; a
            # vanished parent snapshot must fail loudly, not silently
            # read the parent's live head
            pattrs = await self.client.getxattrs(
                self.pool_id, _header(pname))
            pids = dict(_dec_snaps(pattrs[ATTR_SNAPS]))
            if psnap not in pids:
                raise ImageNotFound(
                    f"clone source {pname}@{psnap} is gone")
            self._parent_snapid = pids[psnap]
        else:
            self.parent = None
            self._parent_snapid = None

    async def stat(self) -> dict:
        await self.refresh()
        return {"size": self.size, "snaps": list(self.snaps),
                "parent": self.parent,
                "object_size": self.layout.object_size}

    async def resize(self, new_size: int) -> None:
        self._writable()
        await self._ensure_lock()
        async with self._io_guard():
            await self._resize_locked(new_size)

    async def _resize_locked(self, new_size: int) -> None:
        old = self.size
        if new_size < old and self._cacher is not None:
            # shrink mutates objects server-side behind the cache:
            # land buffered writes first (they precede the resize);
            # cached content drops AFTER the objects are cut, below
            await self._cacher.flush()
        if new_size < old:
            # per-object retained byte counts under STRIPING: an
            # object keeps the highest in-object offset any stripe
            # unit of [0, new_size) maps to — the old sequential
            # first_dead/boundary math deleted live mid-set objects
            # on wide layouts; closed-form per object, not an extent
            # walk
            lo = self.layout
            for objno in range(object_count(lo, old)):
                want = retained_bytes(lo, new_size, objno)
                if want == 0:
                    await self._rm_object(objno)
                elif want < retained_bytes(lo, old, objno):
                    try:
                        await self.client.truncate(
                            self.pool_id, self._oid(objno), want,
                            snapc=self._snapc(),
                        )
                    except KeyError:
                        pass
            if self._cacher is not None:
                # objects are cut: NOW drop clean cache content
                # (before the cut, a concurrent read could re-cache
                # doomed bytes; a FULL invalidate here would discard
                # writes buffered during the cut's awaits — clean-only
                # keeps those overlays)
                self._cacher.invalidate_clean()
        await self.client.setxattr(
            self.pool_id, _header(self.name), ATTR_SIZE,
            denc.enc_u64(new_size),
        )
        self.size = new_size
        if self._omap is not None:
            nobj = self._object_count()
            if len(self._omap) > nobj:
                del self._omap[nobj:]
                self._omap_dirty = True
            await self._save_object_map()

    # --------------------------------------------------------------- io

    def _writable(self) -> None:
        if self.snap is not None:
            raise IOError("snapshot handles are read-only")

    def _oid(self, objectno: int) -> bytes:
        return _data_fmt(self.name).format(objectno=objectno).encode()

    async def write(self, offset: int, data: bytes) -> None:
        self._writable()
        if offset + len(data) > self.size:
            raise IOError(
                f"write past end of image ({offset + len(data)} > "
                f"{self.size})"
            )
        await self._ensure_lock()
        async with self._io_guard():
            extents = file_to_extents(self.layout, offset, len(data),
                                      _data_fmt(self.name))
            await self._omap_prewrite(ex.objectno for ex in extents)

            async def put(ex):
                piece = bytearray(ex.length)
                pos = 0
                for bo, ln in ex.buffer_extents:
                    piece[pos : pos + ln] = data[bo : bo + ln]
                    pos += ln
                await self._copy_up(ex.objectno)
                await self._io.write(self.pool_id, ex.oid, ex.offset,
                                     bytes(piece),
                                     snapc=self._snapc())
                self._omap_settle(ex.objectno, True)

            await asyncio.gather(*(put(ex) for ex in extents))

    async def _copy_up(self, objectno: int) -> None:
        """Clone COW: first write to an object absent in the child
        copies the parent's data (read at the parent's RADOS snap id)
        up into the child (librbd CopyupRequest role)."""
        if self.parent is None and self._mig_src is None:
            return
        if (self._omap is not None and objectno < len(self._omap)
                and self._omap[objectno] == 1):
            # EXISTS (verified): the child owns it, no stat needed.
            # A PENDING bit proves nothing (a fenced holder may have
            # died between marking and writing) — fall through to stat.
            return
        try:
            await self.client.stat(self.pool_id, self._oid(objectno))
            return  # child already owns this object
        except KeyError:
            pass
        if self.parent is not None:
            pname, _psnap = self.parent
            src = _data_fmt(pname).format(objectno=objectno).encode()
            try:
                blob = await self.client.read(
                    self.pool_id, src, snapid=self._parent_snapid)
            except KeyError:
                return  # parent hole: child object starts empty
        else:  # migration target: pull the object's bytes from the
            #    source image through ITS layout
            blob = await self._read_from_source(
                objectno, 0, self.layout.object_size)
            if not blob:
                return  # source hole
        await self._omap_prewrite((objectno,))
        await self._io.write_full(
            self.pool_id, self._oid(objectno), blob,
            snapc=self._snapc(),
        )
        self._omap_settle(objectno, True)

    async def read(self, offset: int, length: int) -> bytes:
        length = max(0, min(length, self.size - offset))
        if length == 0:
            return b""
        fmt = _data_fmt(self.name)
        extents = file_to_extents(self.layout, offset, length, fmt)
        result = StripedReadResult(length)

        async def get(ex):
            data = await self._read_object(ex)
            result.add_partial_result(data, ex.buffer_extents)

        await asyncio.gather(*(get(ex) for ex in extents))
        return result.assemble()

    async def _read_object(self, ex) -> bytes:
        snapid = self.snap_ids.get(self.snap) if self.snap else None
        if self._cacher is not None and snapid is None:
            # cached reads are only coherent while WE own the lock (a
            # peer's writes flush at ITS release, but our cached clean
            # bytes would never invalidate): acquire before serving
            await self._ensure_lock()
        try:
            return await self._io.read(
                self.pool_id, ex.oid, offset=ex.offset,
                length=ex.length, snapid=snapid,
            )
        except KeyError:
            pass
        if self.parent is not None:
            # parent fallthrough applies to snap reads too: a child
            # object absent at the snap (never copied up before it, or
            # copied up after) held the parent's clone-time content
            pname, _psnap = self.parent
            src = _data_fmt(pname).format(objectno=ex.objectno).encode()
            try:
                return await self.client.read(
                    self.pool_id, src, offset=ex.offset,
                    length=ex.length, snapid=self._parent_snapid,
                )
            except KeyError:
                pass
        if self._mig_src is not None:
            # migration fallthrough at BYTE level: the target may use
            # a different layout/pool than the source, so the absent
            # object's range maps back to file offsets and reads
            # through the source image's own striping
            return await self._read_from_source(ex.objectno, ex.offset,
                                                ex.length)
        return b""  # hole

    async def _read_from_source(self, objectno: int, off: int,
                                length: int) -> bytes:
        runs = extent_to_file(self.layout, objectno, off, length)
        parts = await asyncio.gather(
            *(self._mig_src.read(fo, fl) for fo, fl in runs))
        return b"".join(
            p + b"\x00" * (fl - len(p))
            for p, (_fo, fl) in zip(parts, runs)
        ).rstrip(b"\x00")

    async def discard(self, offset: int, length: int) -> None:
        """Zero a byte range (librbd discard role; object-interior
        ranges zero, whole objects could be removed — lite keeps
        zeroing uniform)."""
        self._writable()
        await self._ensure_lock()
        async with self._io_guard():
            extents = file_to_extents(self.layout, offset, length,
                                      _data_fmt(self.name))
            for ex in extents:
                await self._copy_up(ex.objectno)
                try:
                    await self._io.zero(
                        self.pool_id, ex.oid, ex.offset, ex.length,
                        snapc=self._snapc())
                except KeyError:
                    pass  # never written: already zero

    # ---------------------------------------------------------- objects

    def _object_count(self) -> int:
        return object_count(self.layout, self.size)

    async def _rm_object(self, objno: int):
        try:
            await self._io.delete(self.pool_id, self._oid(objno),
                                  snapc=self._snapc())
        except KeyError:
            pass
        self._omap_settle(objno, False)

    async def _remove_objects(self) -> None:
        # fast-diff: only objects the map says MAY exist (exists or
        # pending) need deleting; 0 bits are trustworthy because every
        # data write is preceded by a persisted pending bit
        which = (
            [i for i in range(min(self._object_count(),
                                  len(self._omap)))
             if self._omap[i]]
            if self._omap is not None
            else range(self._object_count()))
        await asyncio.gather(*(self._rm_object(i) for i in which))

    # -------------------------------------------------------- snapshots
    #
    # Image snapshots sit directly on RADOS selfmanaged snaps
    # (librbd's actual design): snap_create is O(1) metadata — the mon
    # allocates an id, subsequent writes carry it in their SnapContext
    # and the OSDs make lazy clones on first overwrite. No data moves
    # at snapshot time; snap_remove hands reclamation to the RADOS
    # snap trimmer.

    async def snap_create(self, snap: str) -> None:
        self._writable()
        await self._ensure_lock()
        async with self._io_guard():
            if self._cacher is not None:
                # snapshot boundary: buffered writes must be part of
                # the snapshot (librbd flushes its cache here too)
                await self._cacher.flush()
            await self.refresh()
            if snap in self.snaps:
                raise ImageExists(f"{self.name}@{snap}")
            snapid = await self.client.selfmanaged_snap_create(
                self.pool_id)
            self.snaps.append(snap)
            self.snap_ids[snap] = snapid
            self.snap_seq = max(self.snap_seq, snapid)
            await self._save_snaps()

    async def snap_remove(self, snap: str) -> None:
        await self._ensure_lock()
        async with self._io_guard():
            await self.refresh()
            if snap not in self.snaps:
                raise KeyError(snap)
            snapid = self.snap_ids.pop(snap)
            self.snaps.remove(snap)
            await self._save_snaps()
        await self.client.selfmanaged_snap_remove(self.pool_id, snapid)

    async def snap_rollback(self, snap: str) -> None:
        self._writable()
        await self._ensure_lock()
        async with self._io_guard():
            await self._rollback_locked(snap)

    async def _rollback_locked(self, snap: str) -> None:
        if self._cacher is not None:
            # rollback rewrites objects server-side via the RAW client:
            # flush pre-rollback buffered writes (they happened before
            # the rollback); the invalidate comes AFTER the rewrite so
            # a concurrent read can't re-cache pre-rollback bytes
            await self._cacher.flush()
        await self.refresh()
        if snap not in self.snaps:
            raise KeyError(snap)
        snapid = self.snap_ids[snap]

        async def rb(objno):
            try:
                blob = await self.client.read(
                    self.pool_id, self._oid(objno), snapid=snapid
                )
            except KeyError:
                await self._rm_object(objno)
                return
            await self._omap_prewrite((objno,))
            await self.client.write_full(self.pool_id, self._oid(objno),
                                         blob, snapc=self._snapc())
            self._omap_settle(objno, True)

        await asyncio.gather(
            *(rb(i) for i in range(self._object_count())))
        if self._cacher is not None:
            self._cacher.invalidate_clean()  # see flush note above

    async def snap_list(self) -> list[str]:
        await self.refresh()
        return list(self.snaps)

    async def _save_snaps(self) -> None:
        from ..cluster.client import ObjectOperation

        pairs = [(nm, self.snap_ids[nm]) for nm in self.snaps]
        op = (ObjectOperation()
              .setxattr(ATTR_SNAPS, _enc_snaps(pairs))
              .setxattr(ATTR_SNAPSEQ, denc.enc_u64(self.snap_seq)))
        await self.client.operate(self.pool_id, _header(self.name), op)

    # --------------------------------------------------------- flatten

    async def flatten(self) -> None:
        """Detach from the parent by copying up every still-shared
        object (librbd flatten role); the object map prunes the sweep
        to objects the child does NOT yet own (fast-diff role)."""
        self._writable()
        if self.parent is None:
            return
        await self._ensure_lock()
        async with self._io_guard():
            await asyncio.gather(*(
                self._copy_up(i) for i in range(self._object_count())
            ))
            await self.client.rmxattr(self.pool_id, _header(self.name),
                                      ATTR_PARENT)
            self.parent = None
