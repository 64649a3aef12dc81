"""RGW multisite sync (the rgw data-sync role).

The reference replicates S3 zones asynchronously: every bucket-index
mutation marks a datalog shard dirty (src/rgw/driver/rados/
rgw_datalog.cc), and a per-peer sync agent tails the log, fetches the
source-of-truth object state, and applies it locally, tracking its
position in persistent sync markers (rgw_data_sync.cc RGWDataSyncCR
machinery). This module is that design over RGWLite zones:

- ``DataLog`` (services/rgw.py) appends (bucket, key) per index
  mutation via the server-side cls method, key-granular where the
  reference is shard-granular.
- ``RGWSyncAgent`` tails a source zone's log and RECONCILES each dirty
  key: it makes the destination's state for that key equal the
  source's — version rows copied/removed by version id, delete markers
  included, the current pointer mirrored verbatim. State-based replay
  makes every entry idempotent and order-insensitive per key, exactly
  why the reference logs "shard dirty" rather than op bodies.
- Bootstrap is a full sync (list + reconcile every bucket) after
  snapshotting the log head FIRST, so changes landing mid-scan are
  replayed incrementally — no gap (rgw_data_sync.cc full-sync ->
  incremental transition).
- The agent applies through a QUIET destination handle (no datalog),
  so two agents in opposite directions don't echo each other's writes
  — the sync-loop guard the reference implements as zone trace ids.

Entry etags/mtimes are preserved verbatim on the destination (the
agent writes data + index rows directly rather than re-PUTting), so
cross-zone comparison — and a later failback sync — converges instead
of ping-ponging.

ceph_tpu_torch's own copy of ``ceph_tpu/services/rgw_sync.py``.
"""
from __future__ import annotations

import asyncio

from ..utils import denc
from .rgw import (
    _VSEP,
    STRIPE_THRESHOLD,
    RGWError,
    RGWLite,
    _data_oid,
    _enc_entry,
    _ver_index_key,
    _ver_oid,
)


def _marker_oid(zone: str) -> bytes:
    return f".rgw.sync.{zone}".encode()


class RGWSyncAgent:
    """One-direction zone replication: ``src`` -> ``dst``. Run two
    agents for active-active. ``trim=True`` trims applied source log
    entries (single-peer deployments only — a second peer would lose
    history)."""

    def __init__(self, src: RGWLite, dst: RGWLite, trim: bool = False):
        if src.datalog is None:
            raise ValueError("source zone has no datalog "
                             "(RGWLite(..., datalog=True))")
        self.src = src
        # quiet handle: replicated applies must not re-enter the
        # destination zone's own datalog
        self.dst = RGWLite(dst.client, dst.pool_id, zone=dst.zone)
        self.trim = trim
        self._task: asyncio.Task | None = None
        self.last_error: BaseException | None = None
        self.marker_oid = _marker_oid(src.zone)
        #: per-batch caches: bucket sets + src versioning status; one
        #: snapshot per drained page instead of two ROOT_OID reads per
        #: dirty key
        self._bsets: tuple[set[str], set[str]] | None = None
        self._vercache: dict[str, str] = {}

    def _invalidate(self) -> None:
        self._bsets = None
        self._vercache.clear()

    async def _bucket_sets(self) -> tuple[set[str], set[str]]:
        if self._bsets is None:
            self._bsets = (set(await self.src.list_buckets()),
                           set(await self.dst.list_buckets()))
        return self._bsets

    async def _src_versioning(self, bucket: str) -> str:
        if bucket not in self._vercache:
            self._vercache[bucket] = \
                await self.src.get_bucket_versioning(bucket)
        return self._vercache[bucket]

    # ------------------------------------------------------------ markers

    async def _load_marker(self) -> int | None:
        try:
            raw = await self.dst.client.read(self.dst.pool_id,
                                             self.marker_oid)
        except (KeyError, IOError):
            return None
        return denc.dec_u64(raw, 0)[0]

    async def _save_marker(self, marker: int) -> None:
        await self.dst.client.write_full(self.dst.pool_id,
                                         self.marker_oid,
                                         denc.enc_u64(marker))

    # ---------------------------------------------------------- main loop

    async def sync_once(self, max_entries: int = 1000) -> dict:
        """One pass: bootstrap full sync if no marker yet, then drain
        the incremental log. Returns {"applied": n, "marker": seq}."""
        applied = 0
        marker = await self._load_marker()
        if marker is None:
            # snapshot the head BEFORE scanning: anything logged while
            # the full sync runs is replayed incrementally after it
            head, _ents, _tr = await self.src.datalog.list(0, 1)
            applied += await self._full_sync()
            marker = head
            await self._save_marker(marker)
            if self.trim:
                await self.src.datalog.trim(marker)
        while True:
            _head, ents, truncated = await self.src.datalog.list(
                marker, max_entries)
            if not ents:
                break
            self._invalidate()  # fresh snapshot per drained page
            seen: set[tuple[str, str]] = set()
            for seq, bucket, key in ents:
                if (bucket, key) in seen:
                    continue
                seen.add((bucket, key))
                if key == "":
                    await self._reconcile_bucket(bucket)
                else:
                    await self._reconcile_key(bucket, key)
                applied += 1
            marker = ents[-1][0] + 1
            await self._save_marker(marker)
            if self.trim:
                await self.src.datalog.trim(marker)
            if not truncated:
                break
        return {"applied": applied, "marker": marker}

    def start(self, interval: float = 1.0) -> None:
        """Background tailing loop (the radosgw sync-thread role)."""

        async def loop() -> None:
            while True:
                try:
                    await self.sync_once()
                    self.last_error = None
                except asyncio.CancelledError:
                    raise
                except BaseException as e:  # noqa: BLE001
                    # ANY failure (decode errors included) must not
                    # kill the tailer silently — record and retry
                    self.last_error = e
                await asyncio.sleep(interval)

        self._task = asyncio.get_running_loop().create_task(loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # ----------------------------------------------------------- full sync

    async def _full_sync(self) -> int:
        n = 0
        self._invalidate()
        src_buckets = set(await self.src.list_buckets())
        dst_buckets = set(await self.dst.list_buckets())
        for bucket in sorted(src_buckets):
            await self._reconcile_bucket(bucket)
            n += 1
            for key in sorted(await self._plain_keys(self.src, bucket)):
                await self._reconcile_key(bucket, key)
                n += 1
        for bucket in sorted(dst_buckets - src_buckets):
            await self._reconcile_bucket(bucket)
            n += 1
        return n

    async def _plain_keys(self, zone: RGWLite, bucket: str) -> set[str]:
        """Every distinct plain key with any index row (current
        pointers AND version rows)."""
        keys: set[str] = set()
        marker = ""
        while True:
            page, truncated = await zone.index.list(bucket, "", marker,
                                                    1000)
            if not page:
                break
            for ent in page:
                marker = ent["key"]
                keys.add(ent["key"].split(_VSEP, 1)[0])
            if not truncated:
                break
        return keys

    # ------------------------------------------------- bucket reconcile

    async def _reconcile_bucket(self, bucket: str) -> None:
        """Make dst's bucket existence + config match src (the mdlog
        sync role)."""
        self._invalidate()  # a bucket-level change: re-snapshot
        src_set, dst_set = await self._bucket_sets()
        src_has, dst_has = bucket in src_set, bucket in dst_set
        if src_has:
            if not dst_has:
                await self.dst.create_bucket(bucket)
                self._invalidate()
            ver = await self.src.get_bucket_versioning(bucket)
            dst_ver = await self.dst.get_bucket_versioning(bucket)
            if ver and ver != dst_ver:
                await self.dst.put_bucket_versioning(bucket, ver)
            elif not ver and dst_ver:
                # src was deleted + recreated unversioned: the S3 API
                # cannot unset versioning, so clear the attr directly
                # or dst accumulates marker rows src will never have
                from .rgw import _index_oid

                await self.dst.client.setxattr(
                    self.dst.pool_id, _index_oid(bucket),
                    self.dst.ATTR_VERSIONING, b"")
            lc = await self.src.get_lifecycle(bucket)
            if lc != await self.dst.get_lifecycle(bucket):
                await self.dst.put_lifecycle(bucket, lc)
            pol = await self.src.get_bucket_acl(bucket)
            if pol != ("", "") and \
                    pol != await self.dst.get_bucket_acl(bucket):
                await self.dst.put_bucket_acl(bucket, *pol)
        elif dst_has:
            # src deleted it (which required empty): the source is
            # authoritative, purge everything local and drop the bucket
            for key in sorted(await self._plain_keys(self.dst, bucket)):
                await self._purge_key(bucket, key)
            try:
                await self.dst.delete_bucket(bucket)
            except RGWError:
                pass  # raced with fresh writes; a later entry retries
            self._invalidate()

    async def _purge_key(self, bucket: str, key: str) -> None:
        """Remove every row + data object ``key`` has on dst."""
        rows = await self._version_rows(self.dst, bucket, key)
        for order, ent in rows.items():
            if (not ent["delete_marker"]
                    and ent["version_id"] not in ("", "null")):
                try:
                    await self.dst.client.delete(
                        self.dst.pool_id,
                        _ver_oid(bucket, key, ent["version_id"]))
                except (KeyError, IOError):
                    pass
            await self._del_row(bucket, _ver_index_key(key, order))
        if await self._raw_current(bucket, key) is not None:
            try:
                await self.dst.client.delete(self.dst.pool_id,
                                             _data_oid(bucket, key))
            except (KeyError, IOError):
                pass
            await self.dst.striper.remove(_data_oid(bucket, key))
            await self._del_row(bucket, key)

    # ---------------------------------------------------- key reconcile

    async def _reconcile_key(self, bucket: str, key: str) -> None:
        """Make dst's complete state for ``key`` equal src's."""
        src_set, dst_set = await self._bucket_sets()
        if bucket not in src_set:
            return  # bucket-level entry handles teardown
        if bucket not in dst_set:
            await self._reconcile_bucket(bucket)
        if await self._src_versioning(bucket) != "":
            await self._reconcile_versioned(bucket, key)
        else:
            await self._reconcile_plain(bucket, key)

    @staticmethod
    def _ent_sig(ent: dict) -> tuple:
        """Replication identity of an entry: content (etag/size) AND
        the metadata the index row carries — a metadata-only PUT
        (content-type, x-amz-meta, mtime) must replicate even when the
        bytes are unchanged."""
        return (ent["etag"], ent["size"], ent["mtime"],
                ent["content_type"], ent["meta"],
                ent.get("owner", ""), ent.get("acl", ""))

    async def _reconcile_plain(self, bucket: str, key: str) -> None:
        src_ent = await self._current(self.src, bucket, key)
        dst_ent = await self._current(self.dst, bucket, key)
        if src_ent is None:
            if dst_ent is not None:
                await self.dst.delete_object(bucket, key)
            return
        if dst_ent is not None and \
                self._ent_sig(dst_ent) == self._ent_sig(src_ent):
            return
        data, meta = await self.src.get_object(bucket, key)
        await self._put_plain(bucket, key, data, meta)

    async def _current(self, zone: RGWLite, bucket: str,
                       key: str) -> dict | None:
        try:
            return await zone.head_object(bucket, key)
        except RGWError:
            return None

    async def _put_plain(self, bucket: str, key: str, data: bytes,
                         ent: dict) -> None:
        """Write object data + current row preserving the source entry
        verbatim (etag/mtime/attrs). Multipart sources land assembled
        (multipart=False) — the etag keeps its "-N" form, so equality
        still holds across zones."""
        await self._put_plain_data(bucket, key, data)
        await self.dst.index.put(
            bucket, key,
            _enc_entry(ent["size"], ent["etag"], ent["mtime"],
                       vid=ent.get("version_id", ""),
                       ctype=ent["content_type"], meta=ent["meta"],
                       owner=ent.get("owner", ""),
                       acl=ent.get("acl", "")))

    # ----------------------------------------- versioned key reconcile

    async def _version_rows(self, zone: RGWLite, bucket: str,
                            key: str) -> dict[str, dict]:
        """row-order -> entry for every version row of ``key`` (the
        order string after the NUL separator: the vid for regular
        versions, the mtime-derived order for preserved nulls)."""
        rows: dict[str, dict] = {}
        marker = ""
        prefix = key + _VSEP
        while True:
            page, truncated = await zone.index.list(bucket, prefix,
                                                    marker, 1000)
            if not page:
                break
            for ent in page:
                marker = ent["key"]
                rows[ent["key"].split(_VSEP, 1)[1]] = ent
            if not truncated:
                break
        return rows

    async def _reconcile_versioned(self, bucket: str, key: str) -> None:
        src_rows = await self._version_rows(self.src, bucket, key)
        dst_rows = await self._version_rows(self.dst, bucket, key)
        for order in sorted(src_rows.keys() - dst_rows.keys(),
                            reverse=True):  # oldest first
            await self._copy_version(bucket, key, order,
                                     src_rows[order])
        # rows present on BOTH sides can still differ in place (an
        # ACL/metadata rewrite of an existing version row): re-copy on
        # signature mismatch
        for order in src_rows.keys() & dst_rows.keys():
            if self._ent_sig(src_rows[order]) != \
                    self._ent_sig(dst_rows[order]):
                await self._copy_version(bucket, key, order,
                                         src_rows[order])
        for order in sorted(dst_rows.keys() - src_rows.keys()):
            ent = dst_rows[order]
            if (not ent["delete_marker"]
                    and ent["version_id"] not in ("", "null")):
                try:
                    await self.dst.client.delete(
                        self.dst.pool_id,
                        _ver_oid(bucket, key, ent["version_id"]))
                except (KeyError, IOError):
                    pass
            await self._del_row(bucket, _ver_index_key(key, order))
        await self._mirror_current(bucket, key)

    async def _copy_version(self, bucket: str, key: str, order: str,
                            ent: dict) -> None:
        vid = ent["version_id"]
        if ent["delete_marker"]:
            row = _enc_entry(0, "", ent["mtime"], vid=vid, marker=True)
        elif vid == "null":
            # preserved pre-versioning object: its data lives at the
            # PLAIN oid on both sides
            data, meta = await self.src.get_object(bucket, key,
                                                   version_id="null")
            await self._put_plain_data(bucket, key, data)
            # landed assembled even if the source null was multipart
            row = _enc_entry(ent["size"], ent["etag"], ent["mtime"],
                             vid="null", ctype=ent["content_type"],
                             meta=ent["meta"],
                             owner=ent.get("owner", ""),
                             acl=ent.get("acl", ""))
        else:
            try:
                data = await self.src.client.read(
                    self.src.pool_id, _ver_oid(bucket, key, vid))
            except (KeyError, IOError):
                return  # deleted under us; a newer log entry follows
            await self.dst.client.write_full(
                self.dst.pool_id, _ver_oid(bucket, key, vid), data)
            row = _enc_entry(len(data), ent["etag"], ent["mtime"],
                             vid=vid, ctype=ent["content_type"],
                             meta=ent["meta"],
                             owner=ent.get("owner", ""),
                             acl=ent.get("acl", ""))
        await self.dst.index.put(bucket, _ver_index_key(key, order),
                                 row)

    async def _put_plain_data(self, bucket: str, key: str,
                              data: bytes) -> None:
        oid = _data_oid(bucket, key)
        if len(data) > STRIPE_THRESHOLD:
            await self.dst.striper.write(oid, data)
        else:
            await self.dst.striper.remove(oid)
            await self.dst.client.write_full(self.dst.pool_id, oid,
                                             data)

    async def _del_row(self, bucket: str, row_key: str) -> None:
        try:
            await self.dst.index.delete(bucket, row_key)
        except (RGWError, IOError, KeyError):
            pass

    async def _mirror_current(self, bucket: str, key: str) -> None:
        """Copy the source's current pointer verbatim (including its
        plain-oid data when the current predates versioning)."""
        try:
            cur = await self.src.index.get(bucket, key)
        except RGWError:
            cur = None
        if cur is None:
            dst_cur = await self._raw_current(bucket, key)
            if dst_cur is not None:
                if (not dst_cur["version_id"]
                        and not dst_cur["delete_marker"]):
                    # plain data current: drop its data too
                    try:
                        await self.dst.client.delete(
                            self.dst.pool_id, _data_oid(bucket, key))
                    except (KeyError, IOError):
                        pass
                    await self.dst.striper.remove(_data_oid(bucket,
                                                            key))
                await self._del_row(bucket, key)
            return
        multipart = cur["multipart"]
        if not cur["version_id"] and not cur["delete_marker"]:
            data, _meta = await self.src.get_object(bucket, key)
            await self._put_plain_data(bucket, key, data)
            multipart = False  # landed assembled; no manifest on dst
        await self.dst.index.put(
            bucket, key,
            _enc_entry(cur["size"], cur["etag"], cur["mtime"],
                       multipart=multipart,
                       vid=cur["version_id"],
                       marker=cur["delete_marker"],
                       ctype=cur["content_type"], meta=cur["meta"],
                       owner=cur.get("owner", ""),
                       acl=cur.get("acl", "")))

    async def _raw_current(self, bucket: str, key: str) -> dict | None:
        try:
            return await self.dst.index.get(bucket, key)
        except RGWError:
            return None
