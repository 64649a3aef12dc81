"""RGW-lite: S3-role object gateway on RADOS (the src/rgw role).

The storage layout mirrors the reference's shape: a root registry
object holds the bucket set in omap; each bucket has an index object
whose omap is the sorted key -> entry mapping (the cls_rgw bucket-index
role: size, etag, mtime per key); object data lives in per-key RADOS
objects, striped through RadosStriper above the threshold. Multipart
uploads store parts as separate objects and a manifest at complete
time (the RGW manifest role).

Surface (rgw_op.cc verbs): create/delete/list buckets, put/get/head/
delete/copy objects, ListObjects with prefix/marker/max_keys +
lexicographic ordering straight from the omap, multipart
initiate/upload_part/complete/abort. ETags are content MD5s
(multipart: md5-of-md5s with the -N suffix, the S3 convention).

S3Frontend (rgw_asio_frontend role) serves a minimal REST dialect of
it over asyncio TCP: GET/PUT/HEAD/DELETE on /bucket and /bucket/key,
ListBuckets on /, ListObjectsV2 query parameters, XML responses.

ceph_tpu_torch's own copy of ``ceph_tpu/services/rgw.py``.
"""
from __future__ import annotations

import asyncio
import calendar
import hashlib
import json
import time
import urllib.parse
import xml.etree.ElementTree as ET

from ..osdc.striper import FileLayout
from ..osdc.striped_client import RadosStriper
from ..utils import denc
from . import rgw_acl

ROOT_OID = b".rgw.root"
STRIPE_THRESHOLD = 1 << 22  # larger objects stripe


# ----------------------------------------------------------- AWS sigv4
#
# The rgw_auth_s3.h:262 role: canonical request -> string-to-sign ->
# HMAC key derivation chain, byte-compatible with the AWS spec so any
# standard S3 SDK signature validates against the frontend.

import hmac as _hmac


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _hmac256(key: bytes, msg: bytes) -> bytes:
    return _hmac.new(key, msg, hashlib.sha256).digest()


def sigv4_signing_key(secret: str, date: str, region: str,
                      service: str = "s3") -> bytes:
    k = _hmac256(("AWS4" + secret).encode(), date.encode())
    k = _hmac256(k, region.encode())
    k = _hmac256(k, service.encode())
    return _hmac256(k, b"aws4_request")


def sigv4_canonical_request(method: str, path: str, query: str,
                            headers: dict[str, str],
                            signed_headers: list[str],
                            payload_hash: str) -> str:
    qs_pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    canon_qs = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(qs_pairs))
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([
        method,
        urllib.parse.quote(path, safe="/-_.~"),
        canon_qs,
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def sigv4_signature(secret: str, date: str, region: str,
                    amz_date: str, canonical: str) -> str:
    """scope + string-to-sign + final HMAC — shared by the client-side
    signer and the frontend validator so the two can never drift."""
    scope = f"{date}/{region}/s3/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                      _sha256(canonical.encode())])
    return _hmac.new(sigv4_signing_key(secret, date, region),
                     sts.encode(), hashlib.sha256).hexdigest()


def presign_url(method: str, path: str, host: str, access_key: str,
                secret: str, expires: int = 900,
                amz_date: str | None = None,
                region: str = "us-east-1") -> str:
    """Build a presigned URL (the S3 query-string auth flow,
    rgw_auth_s3 presigned role): the signature covers method, path,
    the X-Amz-* query params, and the host header; the payload is
    UNSIGNED-PAYLOAD, so any body works within the expiry window."""
    amz_date = amz_date or time.strftime("%Y%m%dT%H%M%SZ",
                                         time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    params = [("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
              ("X-Amz-Credential", f"{access_key}/{scope}"),
              ("X-Amz-Date", amz_date),
              ("X-Amz-Expires", str(expires)),
              ("X-Amz-SignedHeaders", "host")]
    q = urllib.parse.urlencode(params, quote_via=urllib.parse.quote)
    canon = sigv4_canonical_request(method, path, q, {"host": host},
                                    ["host"], "UNSIGNED-PAYLOAD")
    sig = sigv4_signature(secret, date, region, amz_date, canon)
    return (f"http://{host}{urllib.parse.quote(path)}"
            f"?{q}&X-Amz-Signature={sig}")


def sigv4_sign(method: str, path: str, query: str,
               headers: dict[str, str], payload: bytes,
               access_key: str, secret: str, amz_date: str,
               region: str = "us-east-1",
               signed_headers: list[str] | None = None) -> str:
    """Build the Authorization header value (client side / tests)."""
    signed = sorted(signed_headers or ["host", "x-amz-content-sha256",
                                       "x-amz-date"])
    payload_hash = _sha256(payload)
    canon = sigv4_canonical_request(method, path, query, headers,
                                    signed, payload_hash)
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    sig = sigv4_signature(secret, date, region, amz_date, canon)
    return (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")


class RGWError(Exception):
    def __init__(self, code: str, status: int = 400, what: str = ""):
        super().__init__(what or code)
        self.code = code
        self.status = status


def _index_oid(bucket: str) -> bytes:
    return f".bucket.index.{bucket}".encode()


def _data_oid(bucket: str, key: str) -> str:
    return f"{bucket}//{key}"


def _ver_oid(bucket: str, key: str, vid: str) -> str:
    return f"{bucket}//{key}.__v.{vid}"


#: version-index rows live right after their plain key in the sorted
#: omap: "key\0v<order>"; order = inverted nanoseconds hex so the
#: NEWEST version sorts (and lists) first, the S3 ListObjectVersions
#: order. "\0" cannot appear in S3 keys, so the namespace is disjoint.
_VSEP = "\x00v"


def _ver_index_key(key: str, order: str) -> str:
    return f"{key}{_VSEP}{order}"


def _is_ver_index_key(key: str) -> bool:
    return _VSEP in key


def _new_vid(now: float) -> str:
    """Version id = inverted-nanoseconds hex (newest sorts first) plus
    a random suffix; the WHOLE id is the version-row sort key, so two
    puts in the same clock quantum still get distinct rows."""
    import secrets as _secrets

    return (format((1 << 63) - int(now * 1e9), "016x")
            + _secrets.token_hex(4))


def _null_order(mtime: float) -> str:
    """Row key for a preserved pre-versioning ("null") object, derived
    from its mtime so it sorts into the version timeline where it
    belongs."""
    return format((1 << 63) - int(mtime * 1e9), "016x") + "00000000"


def _enc_entry(size: int, etag: str, mtime: float,
               multipart: bool = False, vid: str = "",
               marker: bool = False, ctype: str = "",
               meta: dict[str, str] | None = None,
               owner: str = "", acl: str = "",
               tags: dict[str, str] | None = None) -> bytes:
    """Index entry: size/etag/mtime/multipart plus the versioning
    fields (rgw_bucket_dir_entry role): ``vid`` names the version the
    entry points at ("" = unversioned/null version at the plain data
    oid) and ``marker`` flags an S3 delete marker. ``ctype``/``meta``
    carry the content type and user metadata (x-amz-meta-* /
    X-Object-Meta-* — the rgw attrs role, indexed so HEAD/listings
    never touch the data objects).  ``owner``/``acl`` are the
    per-object access-control policy (rgw_acl.h ACLOwner role; see
    services/rgw_acl.py).  Tail stages are positional: a stage is
    emitted whenever it or any LATER stage carries data."""
    out = (denc.enc_u64(size) + denc.enc_str(etag)
           + denc.enc_u64(int(mtime)) + denc.enc_u8(multipart)
           + denc.enc_str(vid) + denc.enc_u8(marker))
    if ctype or meta or owner or acl or tags:
        out += denc.enc_str(ctype) + denc.enc_map(
            meta or {}, denc.enc_str, denc.enc_str)
    if owner or acl or tags:
        out += denc.enc_str(owner) + denc.enc_str(acl)
    if tags:
        out += denc.enc_map(tags, denc.enc_str, denc.enc_str)
    return out


def _dec_entry(b: bytes) -> dict:
    size, off = denc.dec_u64(b, 0)
    etag, off = denc.dec_str(b, off)
    mtime, off = denc.dec_u64(b, off)
    multipart, off = denc.dec_u8(b, off)
    vid, marker, ctype, meta = "", 0, "", {}
    owner, acl = "", ""
    if off < len(b):  # entries written before versioning lack these
        vid, off = denc.dec_str(b, off)
        marker, off = denc.dec_u8(b, off)
    if off < len(b):  # and older ones lack the attrs tail
        ctype, off = denc.dec_str(b, off)
        meta, off = denc.dec_map(b, off, denc.dec_str, denc.dec_str)
    if off < len(b):  # and older still lack the acl tail
        owner, off = denc.dec_str(b, off)
        acl, off = denc.dec_str(b, off)
    tags: dict[str, str] = {}
    if off < len(b):  # and older still lack the tag tail
        tags, off = denc.dec_map(b, off, denc.dec_str, denc.dec_str)
    return {"size": size, "etag": etag, "mtime": mtime,
            "multipart": bool(multipart), "version_id": vid,
            "delete_marker": bool(marker), "content_type": ctype,
            "meta": meta, "owner": owner, "acl": acl, "tags": tags}


DATALOG_OID = b".rgw.datalog"


class ClsLog:
    """Atomic-seq append log over the server-side ``rgw.datalog_*``
    cls methods (the cls_log/cls_queue role): opaque entries keyed by
    a sequence the OSD allocates atomically with the write. Backs the
    multisite DataLog and notification topic queues."""

    def __init__(self, client, pool_id: int, oid: bytes):
        self.client = client
        self.pool_id = pool_id
        self.oid = oid

    async def append(self, entry: bytes) -> int:
        raw = await self.client.execute(
            self.pool_id, self.oid, "rgw", "datalog_add", entry)
        return denc.dec_u64(raw, 0)[0]

    async def entries(self, from_seq: int, max_entries: int = 1000
                      ) -> tuple[int, list[tuple[int, bytes]], bool]:
        """(head, [(seq, raw entry)], truncated); head = the next seq
        the log will mint (exclusive end of what exists now)."""
        try:
            raw = await self.client.execute(
                self.pool_id, self.oid, "rgw", "datalog_list",
                denc.enc_u64(from_seq) + denc.enc_u32(max_entries))
        except KeyError:
            return 0, [], False  # log object not created yet
        head, off = denc.dec_u64(raw, 0)
        n, off = denc.dec_u32(raw, off)
        out = []
        for _ in range(n):
            seq, off = denc.dec_u64(raw, off)
            ent, off = denc.dec_bytes(raw, off)
            out.append((seq, ent))
        truncated, _ = denc.dec_u8(raw, off)
        return head, out, bool(truncated)

    async def trim(self, upto: int) -> None:
        await self.client.execute(
            self.pool_id, self.oid, "rgw", "datalog_trim",
            denc.enc_u64(upto))


class DataLog(ClsLog):
    """Zone change log (the rgw_datalog.cc role): every index mutation
    appends the touched (bucket, plain key) so a sync peer can replay
    changes incrementally. Entries mark keys DIRTY — the syncer fetches
    source-of-truth state per key, so replay is idempotent and a
    coarse "key touched" record is enough (exactly the reference's
    shard-marker stance, at key rather than shard granularity)."""

    def __init__(self, client, pool_id: int):
        super().__init__(client, pool_id, DATALOG_OID)

    async def add(self, bucket: str, key: str) -> int:
        return await self.append(
            denc.enc_str(bucket) + denc.enc_str(key)
            + denc.enc_u64(int(time.time())))

    async def list(self, from_seq: int, max_entries: int = 1000
                   ) -> tuple[int, list[tuple[int, str, str]], bool]:
        """(head, [(seq, bucket, key)], truncated)."""
        head, raw, truncated = await self.entries(from_seq,
                                                  max_entries)
        out = []
        for seq, ent in raw:
            bucket, o = denc.dec_str(ent, 0)
            key, o = denc.dec_str(ent, o)
            out.append((seq, bucket, key))
        return head, out, truncated


class _ClsIndex:
    """Bucket index operations through the server-side cls_rgw class
    (cluster/cls.py "rgw"): every update is atomic WITH the bucket
    stats accounting inside one OSD op vector — the index is no longer
    a client-maintained omap. ``log`` (a DataLog or None) records the
    touched plain key after each mutation for multisite sync."""

    def __init__(self, client, pool_id: int, log: DataLog | None = None):
        self.client = client
        self.pool_id = pool_id
        self.log = log

    async def _log(self, bucket: str, key: str) -> None:
        if self.log is not None:
            # version rows ("key\0v<order>") dirty their plain key
            await self.log.add(bucket, key.split(_VSEP, 1)[0])

    async def put(self, bucket: str, key: str, entry: bytes) -> None:
        # dirty-mark BEFORE mutating: a crash between the two ops then
        # leaves at worst a spurious log entry (reconciled to a no-op),
        # never a committed change the sync peer will miss forever
        await self._log(bucket, key)
        await self.client.execute(
            self.pool_id, _index_oid(bucket), "rgw", "index_update",
            denc.enc_u8(0) + denc.enc_bytes(key.encode())
            + denc.enc_bytes(entry))

    async def delete(self, bucket: str, key: str) -> None:
        await self._log(bucket, key)
        await self.client.execute(
            self.pool_id, _index_oid(bucket), "rgw", "index_update",
            denc.enc_u8(1) + denc.enc_bytes(key.encode()))

    async def get(self, bucket: str, key: str) -> dict:
        try:
            raw = await self.client.execute(
                self.pool_id, _index_oid(bucket), "rgw", "index_get",
                denc.enc_bytes(key.encode()))
        except KeyError:
            raise RGWError("NoSuchKey", 404) from None
        except IOError as e:
            # transient op failure is NOT absence — do not tell an S3
            # client the object is gone when the op merely failed
            raise RGWError("InternalError", 500, str(e)) from None
        return _dec_entry(raw)

    async def list(self, bucket: str, prefix: str, marker: str,
                   max_keys: int) -> tuple[list[dict], bool]:
        raw = await self.client.execute(
            self.pool_id, _index_oid(bucket), "rgw", "index_list",
            denc.enc_bytes(prefix.encode())
            + denc.enc_bytes(marker.encode())
            + denc.enc_u32(max_keys))
        n, off = denc.dec_u32(raw, 0)
        out = []
        for _ in range(n):
            k, off = denc.dec_bytes(raw, off)
            e, off = denc.dec_bytes(raw, off)
            ent = _dec_entry(e)
            ent["key"] = k.decode()
            out.append(ent)
        truncated, _ = denc.dec_u8(raw, off)
        return out, bool(truncated)

    async def stats(self, bucket: str) -> dict:
        raw = await self.client.execute(
            self.pool_id, _index_oid(bucket), "rgw", "bucket_stats")
        count, off = denc.dec_u64(raw, 0)
        nbytes, off = denc.dec_u64(raw, off)
        gen, _ = denc.dec_u64(raw, off)
        return {"count": count, "bytes": nbytes, "generation": gen}


class RGWLite:
    def __init__(self, client, pool_id: int, zone: str = "default",
                 datalog: bool = False):
        """``datalog=True`` makes this instance a multisite-capable
        zone: every index mutation also appends to the zone's change
        log (see DataLog / services/rgw_sync.py)."""
        self.zone = zone
        #: bucket -> (expiry, rules) notification-config TTL cache
        #: (rgw_notify role; see services/rgw_notify.py)
        self._notif_cache: dict[str, tuple[float, list]] = {}
        self.datalog = DataLog(client, pool_id) if datalog else None
        self.index = _ClsIndex(client, pool_id, log=self.datalog)
        self.client = client
        self.pool_id = pool_id
        self.striper = RadosStriper(
            client, pool_id,
            FileLayout(stripe_unit=1 << 20, stripe_count=4,
                       object_size=1 << 22),
        )

    # ------------------------------------------------------------ buckets

    async def create_bucket(self, bucket: str, owner: str = "",
                            acl: str = "") -> None:
        if not bucket or "/" in bucket:
            raise RGWError("InvalidBucketName")
        existing = await self._buckets()
        if bucket.encode() in existing:
            raise RGWError("BucketAlreadyExists", 409)
        await self._log_bucket(bucket)
        await self.client.omap_set(
            self.pool_id, ROOT_OID,
            {bucket.encode(): denc.enc_u64(int(time.time()))},
        )
        await self.client.write_full(self.pool_id, _index_oid(bucket),
                                     b"")
        if owner or acl:
            await self.put_bucket_acl(bucket, owner, acl)

    async def delete_bucket(self, bucket: str) -> None:
        await self._require_bucket(bucket)
        idx = await self.client.omap_get(self.pool_id,
                                         _index_oid(bucket))
        if idx:
            raise RGWError("BucketNotEmpty", 409)
        await self._log_bucket(bucket)
        await self.client.delete(self.pool_id, _index_oid(bucket))
        await self.client.omap_rm(self.pool_id, ROOT_OID,
                                  [bucket.encode()])

    async def _log_bucket(self, bucket: str) -> None:
        """Bucket-level change (create/delete/config): a datalog entry
        with key "" — the metadata-log (mdlog) role folded into the
        datalog; the syncer reconciles bucket existence + attrs.
        Logged BEFORE the mutation (dirty-mark-first, like the index
        hook): a spurious entry reconciles to a no-op, a lost one
        diverges the peer forever."""
        if self.datalog is not None:
            await self.datalog.add(bucket, "")

    async def list_buckets(self) -> list[str]:
        return sorted(b.decode() for b in (await self._buckets()))

    async def _buckets(self) -> dict[bytes, bytes]:
        try:
            return await self.client.omap_get(self.pool_id, ROOT_OID)
        except KeyError:
            return {}

    async def _require_bucket(self, bucket: str) -> None:
        if bucket.encode() not in await self._buckets():
            raise RGWError("NoSuchBucket", 404)

    # --------------------------------------------------------- versioning

    ATTR_VERSIONING = "rgw.versioning"
    ATTR_LIFECYCLE = "rgw.lifecycle"

    async def put_bucket_versioning(self, bucket: str,
                                    status: str) -> None:
        """Enable/suspend versioning (rgw_op.cc RGWSetBucketVersioning
        role); status is "Enabled" or "Suspended"."""
        if status not in ("Enabled", "Suspended"):
            raise RGWError("IllegalVersioningConfigurationException")
        await self._require_bucket(bucket)
        await self._log_bucket(bucket)
        await self.client.setxattr(self.pool_id, _index_oid(bucket),
                                   self.ATTR_VERSIONING, status.encode())

    async def get_bucket_versioning(self, bucket: str) -> str:
        await self._require_bucket(bucket)
        try:
            raw = await self.client.getxattr(
                self.pool_id, _index_oid(bucket), self.ATTR_VERSIONING)
            return raw.decode()
        except (KeyError, IOError):
            return ""  # never configured (S3: empty config)

    async def _versioning_enabled(self, bucket: str) -> bool:
        return await self.get_bucket_versioning(bucket) == "Enabled"

    # ------------------------------------------------------ access control

    ATTR_OWNER = "rgw.owner"
    ATTR_ACL = "rgw.acl"

    async def put_bucket_acl(self, bucket: str, owner: str,
                             acl: str) -> None:
        """Set bucket owner + grant list (rgw_acl_s3.cc policy-attr
        role; grant-list text format per services/rgw_acl.py)."""
        await self._require_bucket(bucket)
        await self._log_bucket(bucket)
        oid = _index_oid(bucket)
        await self.client.setxattr(self.pool_id, oid,
                                   self.ATTR_OWNER, owner.encode())
        await self.client.setxattr(self.pool_id, oid,
                                   self.ATTR_ACL, acl.encode())

    async def _bucket_xattr(self, bucket: str, attr: str) -> str:
        try:
            raw = await self.client.getxattr(
                self.pool_id, _index_oid(bucket), attr)
        except (KeyError, IOError):
            raw = b""
        return raw.decode()

    async def bucket_owner(self, bucket: str) -> str:
        """Owner xattr only, no existence re-check — for callers that
        already hold the bucket name from a listing."""
        return await self._bucket_xattr(bucket, self.ATTR_OWNER)

    async def get_bucket_acl(self, bucket: str) -> tuple[str, str]:
        """Returns (owner, grant-list text); ("", "") when never set
        (open / pre-ACL bucket).  One batched xattr fetch — this sits
        on every authorized request's path."""
        await self._require_bucket(bucket)
        try:
            xattrs = await self.client.getxattrs(
                self.pool_id, _index_oid(bucket))
        except (KeyError, IOError):
            xattrs = {}
        return (xattrs.get(self.ATTR_OWNER, b"").decode(),
                xattrs.get(self.ATTR_ACL, b"").decode())

    async def put_object_acl(self, bucket: str, key: str, owner: str,
                             acl: str, version_id: str = "",
                             _ent: dict | None = None) -> None:
        """Rewrite the index entry's acl tail (RGWPutACLs role).  On a
        versioned bucket with an explicit version_id the named version
        row is updated; the bucket's CURRENT pointer is rewritten only
        when the named version actually is the current one (naming a
        historical version must never resurrect its data as current)."""
        ent = (_ent if _ent is not None
               else await self.head_object(bucket, key, version_id))

        def build(vid: str, marker: bool) -> bytes:
            return _enc_entry(ent["size"], ent["etag"], ent["mtime"],
                              multipart=ent["multipart"], vid=vid,
                              marker=marker,
                              ctype=ent["content_type"],
                              meta=ent["meta"], owner=owner, acl=acl,
                              tags=ent.get("tags") or None)

        await self._rewrite_entry_rows(bucket, key, ent, build)

    async def _rewrite_entry_rows(self, bucket: str, key: str,
                                  ent: dict, build) -> None:
        """Rewrite the index row(s) a resolved entry lives at (shared
        by the ACL and tagging writers). ``build(vid, marker)`` must
        return the new encoded entry with the given ON-DISK vid field:
        the preserved pre-versioning "null" object's data may still
        sit at the plain current row, whose stored vid must KEEP "" —
        writing "null" there would corrupt the current pointer. A
        named version's row is always updated; the bucket's CURRENT
        pointer is rewritten only when that version actually is
        current (naming a historical version must never resurrect its
        data as current)."""
        vid = ent["version_id"]
        try:
            cur = await self.index.get(bucket, key)
        except RGWError:
            cur = None
        if vid == "null":
            if cur is not None and not cur["version_id"] \
                    and not cur["delete_marker"]:
                await self.index.put(bucket, key, build("", False))
            else:
                await self.index.put(
                    bucket,
                    _ver_index_key(key, _null_order(ent["mtime"])),
                    build("null", ent["delete_marker"]))
            return
        if vid:
            row = build(vid, ent["delete_marker"])
            await self.index.put(bucket, _ver_index_key(key, vid),
                                 row)
            if cur is not None and cur["version_id"] == vid:
                await self.index.put(bucket, key, row)
            return
        await self.index.put(bucket, key,
                             build("", ent["delete_marker"]))

    async def get_object_acl(self, bucket: str, key: str,
                             version_id: str = "") -> tuple[str, str]:
        """Returns the object's (owner, grants); falls back to the
        BUCKET policy when the entry predates ACLs (legacy rows)."""
        ent = await self.head_object(bucket, key, version_id)
        if ent["owner"] or ent["acl"]:
            return ent["owner"], ent["acl"]
        return await self.get_bucket_acl(bucket)

    # ----------------------------------------------------------- tagging

    ATTR_TAGGING = "rgw.tagging"
    ATTR_CORS = "rgw.cors"

    @staticmethod
    def _validate_tags(tags: dict[str, str], max_n: int = 10) -> None:
        """S3 tag-set limits (rgw_tag_s3 role): <=10 object tags
        (50 for buckets), key <=128, value <=256 chars."""
        if len(tags) > max_n:
            raise RGWError("InvalidTag", 400, "too many tags")
        for k, v in tags.items():
            if not k or len(k) > 128 or len(v) > 256:
                raise RGWError("InvalidTag", 400, k)

    async def put_object_tagging(self, bucket: str, key: str,
                                 tags: dict[str, str],
                                 version_id: str = "") -> str:
        """Replace the object's tag set (RGWPutObjTags role); tags
        ride the index entry like the ACL tail, so reads/listings
        never touch the data object. Returns the affected version id
        ("" on unversioned buckets)."""
        await self._require_bucket(bucket)
        self._validate_tags(tags)
        ent = await self.head_object(bucket, key, version_id)

        def build(vid: str, marker: bool) -> bytes:
            return _enc_entry(ent["size"], ent["etag"], ent["mtime"],
                              multipart=ent["multipart"], vid=vid,
                              marker=marker,
                              ctype=ent["content_type"],
                              meta=ent["meta"], owner=ent["owner"],
                              acl=ent["acl"], tags=tags or None)

        await self._rewrite_entry_rows(bucket, key, ent, build)
        return ent["version_id"]

    async def get_object_tagging(self, bucket: str, key: str,
                                 version_id: str = ""
                                 ) -> dict[str, str]:
        ent = await self.head_object(bucket, key, version_id)
        return dict(ent.get("tags") or {})

    async def delete_object_tagging(self, bucket: str, key: str,
                                    version_id: str = "") -> str:
        return await self.put_object_tagging(bucket, key, {},
                                             version_id=version_id)

    async def put_bucket_tagging(self, bucket: str,
                                 tags: dict[str, str]) -> None:
        """Bucket tag set (<=50 per S3); stored as a bucket attr."""
        self._validate_tags(tags, max_n=50)
        await self._require_bucket(bucket)
        await self._log_bucket(bucket)
        await self.client.setxattr(
            self.pool_id, _index_oid(bucket), self.ATTR_TAGGING,
            json.dumps(tags).encode())

    async def get_bucket_tagging(self, bucket: str) -> dict[str, str]:
        await self._require_bucket(bucket)
        raw = await self._bucket_xattr(bucket, self.ATTR_TAGGING)
        return json.loads(raw) if raw else {}

    async def delete_bucket_tagging(self, bucket: str) -> None:
        await self.put_bucket_tagging(bucket, {})

    # -------------------------------------------------------------- CORS

    async def put_bucket_cors(self, bucket: str,
                              rules: list[dict]) -> None:
        """Store the CORS rule list (rgw_cors.h RGWCORSConfiguration
        role). Each rule: allowed_origins / allowed_methods /
        allowed_headers / expose_headers (lists) + max_age_seconds."""
        if len(rules) > 100:
            raise RGWError("InvalidRequest", 400, "too many rules")
        for r in rules:
            if not r.get("allowed_origins") \
                    or not r.get("allowed_methods"):
                raise RGWError(
                    "MalformedXML", 400,
                    "rule needs AllowedOrigin and AllowedMethod")
        await self._require_bucket(bucket)
        await self._log_bucket(bucket)
        await self.client.setxattr(
            self.pool_id, _index_oid(bucket), self.ATTR_CORS,
            json.dumps(rules).encode())

    async def get_bucket_cors(self, bucket: str) -> list[dict]:
        await self._require_bucket(bucket)
        raw = await self._bucket_xattr(bucket, self.ATTR_CORS)
        return json.loads(raw) if raw else []

    async def delete_bucket_cors(self, bucket: str) -> None:
        await self.put_bucket_cors(bucket, [])

    @staticmethod
    def cors_match(rules: list[dict], origin: str, method: str,
                   req_headers: list[str]) -> dict[str, str] | None:
        """First rule matching (origin, method, headers) -> response
        headers (rgw_cors.cc RGWCORSRule::is_origin_present +
        header filtering role); None = no match (403 preflight)."""

        def origin_ok(pat: str) -> bool:
            if pat == "*" or pat == origin:
                return True
            if "*" in pat:  # single-wildcard glob, e.g. https://*.a.com
                head, _, tail = pat.partition("*")
                return (origin.startswith(head) and origin.endswith(tail)
                        and len(origin) >= len(head) + len(tail))
            return False

        for r in rules:
            if not any(origin_ok(p) for p in r["allowed_origins"]):
                continue
            if method not in r["allowed_methods"]:
                continue
            allowed = [h.lower() for h in r.get("allowed_headers", [])]
            if req_headers and "*" not in allowed and not all(
                    h.lower() in allowed for h in req_headers):
                continue
            out = {
                "access-control-allow-origin":
                    "*" if "*" in r["allowed_origins"] else origin,
                "access-control-allow-methods":
                    ", ".join(r["allowed_methods"]),
            }
            if req_headers:
                out["access-control-allow-headers"] = \
                    ", ".join(req_headers)
            if r.get("expose_headers"):
                out["access-control-expose-headers"] = \
                    ", ".join(r["expose_headers"])
            if r.get("max_age_seconds"):
                out["access-control-max-age"] = \
                    str(r["max_age_seconds"])
            return out
        return None

    async def list_object_versions(self, bucket: str, prefix: str = "",
                                   max_keys: int = 1000) -> list[dict]:
        """All versions + delete markers, newest first per key
        (ListObjectVersions role). The current pointer decides
        is_latest."""
        await self._require_bucket(bucket)
        out: list[dict] = []
        marker = ""
        current: dict[str, str] = {}
        while len(out) < max_keys:
            page, truncated = await self.index.list(
                bucket, prefix, marker, 1000)
            if not page:
                break
            for ent in page:
                k = ent["key"]
                marker = k
                if not _is_ver_index_key(k):
                    current[k] = ent["version_id"]
                    if not ent["version_id"] and not ent["delete_marker"]:
                        # pre-versioning ("null") object: it IS a
                        # version in S3 terms
                        ent["is_latest"] = True
                        out.append(ent)
                    continue
                key = k.split(_VSEP, 1)[0]
                ent["key"] = key
                ent["is_latest"] = \
                    current.get(key) == ent["version_id"]
                out.append(ent)
            if not truncated:
                break
        return out[:max_keys]

    # ------------------------------------------------------------ objects

    async def put_object(self, bucket: str, key: str, data: bytes,
                         content_type: str = "",
                         meta: dict[str, str] | None = None,
                         owner: str = "", acl: str = "",
                         tags: dict[str, str] | None = None,
                         _event: str = "s3:ObjectCreated:Put"
                         ) -> str | tuple[str, str]:
        """Returns the etag; on a versioning-enabled bucket returns
        (etag, version_id). ``content_type``/``meta`` ride the index
        entry (Swift X-Object-Meta-* / S3 x-amz-meta-* role)."""
        await self._require_bucket(bucket)
        etag = hashlib.md5(data).hexdigest()
        if "\x00" in key:
            # the version-row namespace relies on NUL never appearing
            # in keys (true for real S3 too: XML cannot carry it)
            raise RGWError("InvalidObjectName")
        if await self._versioning_enabled(bucket):
            now = time.time()
            vid = _new_vid(now)
            await self._preserve_null_version(bucket, key)
            await self.client.write_full(
                self.pool_id, _ver_oid(bucket, key, vid), data)
            entry = _enc_entry(len(data), etag, now, vid=vid,
                               ctype=content_type, meta=meta,
                               owner=owner, acl=acl, tags=tags)
            # the version row, then the current pointer
            await self.index.put(bucket, _ver_index_key(key, vid),
                                 entry)
            await self.index.put(bucket, key, entry)
            await self._notify(bucket, key, _event, size=len(data),
                               etag=etag, version_id=vid)
            return etag, vid
        oid = _data_oid(bucket, key)
        if len(data) > STRIPE_THRESHOLD:
            await self.striper.write(oid, data)
        else:
            await self.striper.remove(oid)  # drop stale striped form
            await self.client.write_full(self.pool_id, oid, data)
        await self.index.put(bucket, key,
                             _enc_entry(len(data), etag, time.time(),
                                        ctype=content_type, meta=meta,
                                        owner=owner, acl=acl,
                                        tags=tags))
        await self._notify(bucket, key, _event, size=len(data),
                           etag=etag)
        return etag

    async def _notify(self, bucket: str, key: str, event: str,
                      size: int = 0, etag: str = "",
                      version_id: str = "") -> None:
        """Bucket-notification emission (rgw_notify role); lazy import
        breaks the module cycle. Reliable like the reference's
        persistent topics: a failed queue append fails the op."""
        from . import rgw_notify

        await rgw_notify.emit(self, bucket, key, event, size=size,
                              etag=etag, version_id=version_id)

    async def _preserve_null_version(self, bucket: str,
                                     key: str) -> None:
        """A pre-versioning object about to be shadowed by a versioned
        write/marker becomes the addressable "null" version (S3 keeps
        it; its data stays at the plain oid)."""
        try:
            cur = await self.index.get(bucket, key)
        except RGWError:
            return
        if cur["version_id"] or cur["delete_marker"]:
            return  # already versioned / already preserved
        row = _enc_entry(cur["size"], cur["etag"], cur["mtime"],
                         multipart=cur["multipart"], vid="null",
                         ctype=cur["content_type"], meta=cur["meta"],
                         owner=cur["owner"], acl=cur["acl"],
                         tags=cur.get("tags") or None)
        await self.index.put(
            bucket, _ver_index_key(key, _null_order(cur["mtime"])),
            row)

    async def get_object(self, bucket: str, key: str,
                         version_id: str = "",
                         _meta: dict | None = None
                         ) -> tuple[bytes, dict]:
        meta = (_meta if _meta is not None
                else await self.head_object(bucket, key, version_id))
        if meta["delete_marker"]:
            raise RGWError("NoSuchKey", 404)  # named marker version
        if meta["version_id"] and meta["version_id"] != "null":
            data = await self.client.read(
                self.pool_id,
                _ver_oid(bucket, key, meta["version_id"]))
            return data, meta
        oid = _data_oid(bucket, key)
        if meta["multipart"]:
            data = await self._read_multipart(bucket, key)
        elif meta["size"] > STRIPE_THRESHOLD:
            data = await self.striper.read(oid)
        else:
            data = await self.client.read(self.pool_id, oid)
        return data, meta

    async def head_object(self, bucket: str, key: str,
                          version_id: str = "") -> dict:
        await self._require_bucket(bucket)
        if version_id:
            ent = await self._find_version(bucket, key, version_id)
            if ent is None:
                raise RGWError("NoSuchVersion", 404)
            return ent
        ent = await self.index.get(bucket, key)
        if ent["delete_marker"]:
            # the current IS a delete marker: the key reads as absent
            # on every un-versioned access, HEAD included
            raise RGWError("NoSuchKey", 404)
        return ent

    async def _find_version(self, bucket: str, key: str,
                            vid: str) -> dict | None:
        if vid == "null":
            # the preserved pre-versioning object: either still the
            # plain current (vid "") or a preserved "null" row — a
            # bounded scan of the key's version rows finds it
            try:
                cur = await self.index.get(bucket, key)
                if not cur["version_id"] and not cur["delete_marker"]:
                    cur["key"] = key
                    cur["version_id"] = "null"
                    return cur
            except RGWError:
                pass
            page, _tr = await self.index.list(
                bucket, key + _VSEP, "", 1000)
            for ent in page:
                if ent["key"].split(_VSEP, 1)[0] != key:
                    break
                if ent["version_id"] == "null":
                    ent["key"] = key
                    return ent
            return None
        # the vid IS the row's sort component: addressed directly
        try:
            ent = _dec_entry(await self.client.execute(
                self.pool_id, _index_oid(bucket), "rgw", "index_get",
                denc.enc_bytes(_ver_index_key(key, vid).encode())))
        except (KeyError, IOError):
            return None
        if ent["version_id"] != vid:
            return None
        ent["key"] = key
        return ent

    async def bucket_stats(self, bucket: str) -> dict:
        """Server-maintained bucket accounting (cls_rgw stats role):
        object count + total bytes, kept atomically with every index
        update."""
        await self._require_bucket(bucket)
        return await self.index.stats(bucket)

    async def delete_object(self, bucket: str, key: str,
                            version_id: str = "") -> str:
        """S3 delete semantics (rgw_op.cc RGWDeleteObj versioned
        paths). Unversioned bucket: remove data + entry. Versioned, no
        version_id: insert a DELETE MARKER as the new current (data
        untouched) and return its version id. With version_id: remove
        exactly that version; if it was current, promote the next-
        newest version (or marker) to current."""
        await self._require_bucket(bucket)
        versioned = await self.get_bucket_versioning(bucket) != ""
        if versioned and not version_id:
            now = time.time()
            vid = _new_vid(now)
            await self._preserve_null_version(bucket, key)
            entry = _enc_entry(0, "", now, vid=vid, marker=True)
            await self.index.put(bucket, _ver_index_key(key, vid),
                                 entry)
            await self.index.put(bucket, key, entry)
            await self._notify(bucket, key,
                               "s3:ObjectRemoved:DeleteMarkerCreated",
                               version_id=vid)
            return vid
        if versioned and version_id:
            ent = await self._find_version(bucket, key, version_id)
            if ent is None:
                raise RGWError("NoSuchVersion", 404)
            if ent["version_id"] == "null":
                # the preserved pre-versioning object: its data lives
                # in the PLAIN oid forms
                await self._delete_plain_data(bucket, key, ent)
                row = _ver_index_key(key, _null_order(ent["mtime"]))
                await self.index.delete(bucket, row)
            else:
                if not ent["delete_marker"]:
                    try:
                        await self.client.delete(
                            self.pool_id,
                            _ver_oid(bucket, key, version_id))
                    except KeyError:
                        pass
                await self.index.delete(
                    bucket, _ver_index_key(key, version_id))
            try:
                cur = await self.index.get(bucket, key)
            except RGWError:
                return version_id
            if cur["version_id"] == ent["version_id"] or (
                    version_id == "null" and not cur["version_id"]):
                await self._promote_newest(bucket, key)
            await self._notify(bucket, key, "s3:ObjectRemoved:Delete",
                               version_id=version_id)
            return version_id
        # unversioned bucket
        meta = await self.head_object(bucket, key)
        await self._delete_plain_data(bucket, key, meta)
        await self.index.delete(bucket, key)
        await self._notify(bucket, key, "s3:ObjectRemoved:Delete")
        return ""

    async def _delete_plain_data(self, bucket: str, key: str,
                                 meta: dict) -> None:
        oid = _data_oid(bucket, key)
        if meta["multipart"]:
            await self._delete_multipart(bucket, key)
        elif meta["size"] > STRIPE_THRESHOLD:
            await self.striper.remove(oid)
        else:
            try:
                await self.client.delete(self.pool_id, oid)
            except KeyError:
                pass

    async def _promote_newest(self, bucket: str, key: str) -> None:
        """The current version was deleted: the newest remaining
        version row (they sort newest-first) becomes current; none
        left -> the key disappears."""
        page, _tr = await self.index.list(
            bucket, key + _VSEP, "", 1)
        if page and page[0]["key"].split(_VSEP, 1)[0] == key:
            ent = page[0]
            await self.index.put(
                bucket, key,
                _enc_entry(ent["size"], ent["etag"], ent["mtime"],
                           multipart=ent["multipart"],
                           vid=ent["version_id"],
                           marker=ent["delete_marker"],
                           ctype=ent["content_type"],
                           meta=ent["meta"], owner=ent["owner"],
                           acl=ent["acl"],
                           tags=ent.get("tags") or None))
        else:
            await self.index.delete(bucket, key)

    async def copy_object(self, src_bucket: str, src_key: str,
                          dst_bucket: str, dst_key: str,
                          meta: dict[str, str] | None = None,
                          owner: str = "", acl: str = "") -> str:
        """Server-side copy; source attrs carry over unless ``meta``
        replaces them (x-amz-metadata-directive REPLACE role).  The
        ACL does NOT carry over — like S3, the copy is a fresh write
        owned by the copier."""
        data, src = await self.get_object(src_bucket, src_key)
        return await self.put_object(
            dst_bucket, dst_key, data,
            content_type=src["content_type"],
            meta=src["meta"] if meta is None else meta,
            owner=owner, acl=acl,
            tags=src.get("tags") or None,  # S3 copies the tag set
            _event="s3:ObjectCreated:Copy")

    async def list_objects(self, bucket: str, prefix: str = "",
                           marker: str = "", max_keys: int = 1000):
        """(entries, truncated) in lexicographic key order, filtered
        SERVER-SIDE by the cls_rgw index_list method (ListObjectsV2
        role) — the wire carries one page, not the whole bucket.
        Version rows and delete-marker currents are invisible here
        (the S3 non-versioned listing view)."""
        await self._require_bucket(bucket)
        out: list[dict] = []
        truncated = True
        while len(out) < max_keys and truncated:
            page, truncated = await self.index.list(
                bucket, prefix, marker, max_keys)
            if not page:
                break
            for ent in page:
                marker = ent["key"]
                if _is_ver_index_key(ent["key"]) \
                        or ent["delete_marker"]:
                    continue
                out.append(ent)
                if len(out) == max_keys:
                    # more rows may remain: report truncation so the
                    # caller pages on (its marker = last key returned)
                    truncated = True
                    break
        return out, truncated

    # ---------------------------------------------------------- lifecycle

    async def put_lifecycle(self, bucket: str,
                            rules: list[dict]) -> None:
        """Store the bucket's LC rules (RGWPutLC role). Each rule:
        {"id": str, "prefix": str, "days": float,
         "noncurrent_days": float} — ``days`` expires CURRENT objects
        (versioned buckets get a delete marker, unversioned delete),
        ``noncurrent_days`` expires non-current versions for good.
        Either may be absent/None. Fractional days are allowed (the
        reference's lc_debug_interval testing knob)."""
        await self._require_bucket(bucket)
        enc = denc.enc_list(rules, lambda r: (
            denc.enc_str(r.get("id", ""))
            + denc.enc_str(r.get("prefix", ""))
            + denc.enc_str(str(r["days"])
                           if r.get("days") is not None else "")
            + denc.enc_str(str(r["noncurrent_days"])
                           if r.get("noncurrent_days") is not None
                           else "")))
        await self._log_bucket(bucket)
        await self.client.setxattr(self.pool_id, _index_oid(bucket),
                                   self.ATTR_LIFECYCLE, enc)

    async def get_lifecycle(self, bucket: str) -> list[dict]:
        await self._require_bucket(bucket)
        try:
            raw = await self.client.getxattr(
                self.pool_id, _index_oid(bucket), self.ATTR_LIFECYCLE)
        except (KeyError, IOError):
            return []

        def one(b, o):
            rid, o = denc.dec_str(b, o)
            prefix, o = denc.dec_str(b, o)
            days, o = denc.dec_str(b, o)
            ncdays, o = denc.dec_str(b, o)
            return {"id": rid, "prefix": prefix,
                    "days": float(days) if days else None,
                    "noncurrent_days":
                        float(ncdays) if ncdays else None}, o

        return denc.dec_list(raw, 0, one)[0]

    async def lc_process(self, now: float | None = None) -> dict:
        """One lifecycle pass over every bucket (the rgw_lc.cc
        RGWLC::process role, driven by the rgw_lc mgr module's tick):
        expire current objects past ``days`` and non-current versions
        past ``noncurrent_days``. Returns per-bucket action counts."""
        now = time.time() if now is None else now
        report: dict[str, dict] = {}
        for bucket in await self.list_buckets():
            rules = await self.get_lifecycle(bucket)
            if not rules:
                continue
            expired = markers = 0
            for rule in rules:
                days = rule.get("days")
                if days is not None:
                    cutoff = now - days * 86400
                    ents, _tr = await self.list_objects(
                        bucket, prefix=rule.get("prefix", ""),
                        max_keys=10_000)
                    for ent in ents:
                        if ent["mtime"] < cutoff:
                            await self.delete_object(bucket,
                                                     ent["key"])
                            markers += 1
                nc = rule.get("noncurrent_days")
                if nc is not None:
                    cutoff = now - nc * 86400
                    vers = await self.list_object_versions(
                        bucket, prefix=rule.get("prefix", ""),
                        max_keys=10_000)
                    for ent in vers:
                        if (not ent["is_latest"]
                                and ent["version_id"]
                                and ent["mtime"] < cutoff):
                            await self.delete_object(
                                bucket, ent["key"],
                                version_id=ent["version_id"])
                            expired += 1
            report[bucket] = {"expired_current": markers,
                              "expired_noncurrent": expired}
        return report

    # ---------------------------------------------------------- multipart

    def _part_oid(self, bucket: str, key: str, upload_id: str,
                  part: int) -> str:
        return f"{bucket}//{key}.__part.{upload_id}.{part:05d}"

    async def initiate_multipart(self, bucket: str, key: str) -> str:
        await self._require_bucket(bucket)
        if "\x00" in key:
            raise RGWError("InvalidObjectName")
        upload_id = hashlib.md5(
            f"{bucket}/{key}/{time.time()}".encode()
        ).hexdigest()[:16]
        return upload_id

    async def upload_part(self, bucket: str, key: str, upload_id: str,
                          part: int, data: bytes) -> str:
        if not 1 <= part <= 10000:
            raise RGWError("InvalidPartNumber")
        oid = self._part_oid(bucket, key, upload_id, part)
        await self.client.write_full(self.pool_id, oid, data)
        return hashlib.md5(data).hexdigest()

    async def complete_multipart(self, bucket: str, key: str,
                                 upload_id: str,
                                 parts: list[int]) -> str:
        """Write the manifest; data stays in the part objects (the RGW
        manifest stance — no copy at complete time)."""
        total = 0
        md5s = b""
        manifest = []
        for p in parts:
            oid = self._part_oid(bucket, key, upload_id, p)
            try:
                size = await self.client.stat(self.pool_id, oid)
            except KeyError:
                raise RGWError("InvalidPart") from None
            data = await self.client.read(self.pool_id, oid)
            md5s += hashlib.md5(data).digest()
            total += size
            manifest.append((oid, size))
        etag = f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"
        if await self._versioning_enabled(bucket):
            # versioned complete: assemble into a regular version (one
            # copy at complete time — the lite trade for per-version
            # manifests) and reclaim the parts
            data = b"".join(await asyncio.gather(*(
                self.client.read(self.pool_id, oid)
                for oid, _sz in manifest)))
            now = time.time()
            vid = _new_vid(now)
            await self._preserve_null_version(bucket, key)
            await self.client.write_full(
                self.pool_id, _ver_oid(bucket, key, vid), data)
            entry = _enc_entry(total, etag, now, vid=vid)
            await self.index.put(bucket, _ver_index_key(key, vid),
                                 entry)
            await self.index.put(bucket, key, entry)
            for oid, _sz in manifest:
                try:
                    await self.client.delete(self.pool_id, oid)
                except KeyError:
                    pass
            await self._notify(
                bucket, key,
                "s3:ObjectCreated:CompleteMultipartUpload",
                size=total, etag=etag, version_id=vid)
            return etag, vid
        enc = denc.enc_list(
            manifest,
            lambda e: denc.enc_str(e[0]) + denc.enc_u64(e[1]),
        )
        await self.client.write_full(
            self.pool_id, _data_oid(bucket, key) + ".__manifest", enc
        )
        await self.index.put(bucket, key,
                             _enc_entry(total, etag, time.time(),
                                        multipart=True))
        await self._notify(
            bucket, key, "s3:ObjectCreated:CompleteMultipartUpload",
            size=total, etag=etag)
        return etag

    async def _read_multipart(self, bucket: str, key: str) -> bytes:
        raw = await self.client.read(
            self.pool_id, _data_oid(bucket, key) + ".__manifest"
        )

        def one(b, o):
            oid, o = denc.dec_str(b, o)
            size, o = denc.dec_u64(b, o)
            return (oid, size), o

        manifest, _ = denc.dec_list(raw, 0, one)
        chunks = await asyncio.gather(*(
            self.client.read(self.pool_id, oid) for oid, _ in manifest
        ))
        return b"".join(chunks)

    async def _delete_multipart(self, bucket: str, key: str) -> None:
        raw = await self.client.read(
            self.pool_id, _data_oid(bucket, key) + ".__manifest"
        )

        def one(b, o):
            oid, o = denc.dec_str(b, o)
            size, o = denc.dec_u64(b, o)
            return (oid, size), o

        manifest, _ = denc.dec_list(raw, 0, one)
        for oid, _size in manifest:
            try:
                await self.client.delete(self.pool_id, oid)
            except KeyError:
                pass
        await self.client.delete(
            self.pool_id, _data_oid(bucket, key) + ".__manifest"
        )


# ================================================== HTTP frontend


def _xml(root: ET.Element) -> bytes:
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root))


class HttpFrontend:
    """Shared asyncio HTTP/1.1 server plumbing (rgw_asio_frontend
    role): request framing + keep-alive; dialects (S3 XML, Swift)
    subclass and implement ``_handle``."""

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._writers: set[asyncio.StreamWriter] = set()
        self._server = await asyncio.start_server(self._conn, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return host, self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # sever live keep-alive connections: wait_closed() blocks
            # on every open handler, and a client that parked an idle
            # connection (urllib holding a response object, a browser
            # pool) would hang shutdown forever otherwise
            for w in list(getattr(self, "_writers", ())):
                try:
                    w.close()
                except Exception:
                    pass
            await self._server.wait_closed()

    async def _handle(self, method: str, target: str, headers: dict,
                      body: bytes) -> tuple[int, dict, bytes]:
        raise NotImplementedError

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            await self._serve_conn(reader, writer)
        finally:
            self._writers.discard(writer)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                method, target, _ = line.decode().split(" ", 2)
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, v = h.decode().split(":", 1)
                    headers[k.strip().lower()] = v.strip()
                body = b""
                n = int(headers.get("content-length", "0"))
                if n:
                    body = await reader.readexactly(n)
                status, rheaders, rbody = await self._handle(
                    method, target, headers, body)
                reason = {200: "OK", 201: "Created", 202: "Accepted",
                          204: "No Content", 404: "Not Found",
                          400: "Bad Request", 401: "Unauthorized",
                          403: "Forbidden",
                          409: "Conflict"}.get(status, "Error")
                head = [f"HTTP/1.1 {status} {reason}"]
                rheaders.setdefault("content-length", str(len(rbody)))
                rheaders.setdefault("connection", "keep-alive")
                for k, v in rheaders.items():
                    head.append(f"{k}: {v}")
                payload = b"" if method == "HEAD" else rbody
                writer.write(("\r\n".join(head) + "\r\n\r\n").encode()
                             + payload)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                ValueError):
            pass
        finally:
            writer.close()


class S3Frontend(HttpFrontend):
    """Minimal S3 REST dialect over asyncio TCP (rgw_asio_frontend
    role): virtual-path addressing, XML bodies, and AWS sigv4 request
    authentication when a user table is configured (rgw_auth_s3.h:262
    role; without users the frontend stays open, the DummyAuth tier)."""

    #: max tolerated |request time - server time| before a signed
    #: request is rejected (RequestTimeTooSkewed) — the reference RGW's
    #: ~15-minute clock-skew window; without it a captured signed
    #: request replays forever
    CLOCK_SKEW_S = 900.0

    def __init__(self, rgw: RGWLite,
                 users: dict[str, str] | None = None):
        self.rgw = rgw
        #: access_key -> secret (the RGWUserInfo table role)
        self.users = users or {}
        self._server: asyncio.AbstractServer | None = None
        self.port = 0
        #: test hook: fake "now" for the skew check (None = wall clock)
        self._now = None
        #: bucket -> (expiry, rules) — CORS configs change rarely, and
        #: browsers send Origin on EVERY request; without this cache
        #: each cross-origin GET would pay two extra RADOS reads
        self._cors_cache: dict[str, tuple[float, list]] = {}
        #: bucket -> write generation. A preflight may suspend in the
        #: store read across a concurrent cors PUT/DELETE in EITHER
        #: order; it may only cache what it read if no write completed
        #: since it started (invalidate-then-insert races both ways —
        #: only the generation check closes both interleavings).
        self._cors_gen: dict[str, int] = {}

    async def _cors_rules(self, bucket: str) -> list[dict]:
        hit = self._cors_cache.get(bucket)
        now = time.monotonic()
        if hit is not None and now < hit[0]:
            return hit[1]
        gen = self._cors_gen.get(bucket, 0)
        try:
            rules = await self.rgw.get_bucket_cors(bucket)
        except RGWError:
            rules = []
        if self._cors_gen.get(bucket, 0) == gen:
            if len(self._cors_cache) >= 1024:
                # bounded: bucket names here are attacker-controlled
                # via the unauthenticated OPTIONS path — an unbounded
                # dict would be a memory-exhaustion vector
                self._cors_cache.pop(next(iter(self._cors_cache)))
            self._cors_cache[bucket] = (now + 5.0, rules)
        return rules

    def _authenticate(self, method: str, target: str, headers: dict,
                      body: bytes) -> tuple[str | None, str | None]:
        """Validate sigv4; returns (error-code | None, principal).
        A request carrying NO signature at all is not an error — it is
        the ANONYMOUS principal (None), and the ACL layer decides what
        anonymous may touch (rgw_auth.cc anonymous-engine role)."""
        # presigned dispatch keys on the ACTUAL query parameter, not a
        # substring — an object key may legally contain the literal
        # text "X-Amz-Signature="
        qkeys = {k for k, _v in urllib.parse.parse_qsl(
            urllib.parse.urlsplit(target).query,
            keep_blank_values=True)}
        if "X-Amz-Signature" in qkeys:
            return self._authenticate_presigned(method, target,
                                                headers)
        auth = headers.get("authorization", "")
        if not auth:
            return None, None  # anonymous
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return "AccessDenied", None
        try:
            fields = dict(
                kv.strip().split("=", 1)
                for kv in auth[len("AWS4-HMAC-SHA256 "):].split(","))
            cred = fields["Credential"].split("/")
            access, date, region = cred[0], cred[1], cred[2]
            signed = fields["SignedHeaders"].split(";")
            given_sig = fields["Signature"]
        except (KeyError, IndexError, ValueError):
            return "AuthorizationHeaderMalformed", None
        secret = self.users.get(access)
        if secret is None:
            return "InvalidAccessKeyId", None
        amz_date = headers.get("x-amz-date", "")
        if not amz_date.startswith(date):
            return "SignatureDoesNotMatch", None
        # request freshness: reject timestamps outside the skew window
        try:
            ts = calendar.timegm(
                time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        except ValueError:
            return "AuthorizationHeaderMalformed", None
        now = self._now if self._now is not None else time.time()
        if abs(now - ts) > self.CLOCK_SKEW_S:
            return "RequestTimeTooSkewed", None
        # content hash must match the body (payload integrity)
        want_hash = headers.get("x-amz-content-sha256", "")
        if want_hash not in ("UNSIGNED-PAYLOAD", _sha256(body)):
            return "XAmzContentSHA256Mismatch", None
        parsed = urllib.parse.urlsplit(target)
        payload_hash = (want_hash if want_hash else _sha256(body))
        canon = sigv4_canonical_request(
            method, urllib.parse.unquote(parsed.path), parsed.query,
            headers, signed, payload_hash)
        sig = sigv4_signature(secret, date, region, amz_date, canon)
        if not _hmac.compare_digest(sig, given_sig):
            return "SignatureDoesNotMatch", None
        return None, access

    def _authenticate_presigned(
            self, method: str, target: str,
            headers: dict) -> tuple[str | None, str | None]:
        """Query-string sigv4 (presigned URLs): the signature lives in
        the query, the payload is UNSIGNED, and the expiry window is
        part of the signed material — a tampered X-Amz-Expires fails
        the signature, not just the clock check."""
        parsed = urllib.parse.urlsplit(target)
        pairs = urllib.parse.parse_qsl(parsed.query,
                                       keep_blank_values=True)
        qd = dict(pairs)
        if qd.get("X-Amz-Algorithm") != "AWS4-HMAC-SHA256":
            return "AuthorizationHeaderMalformed", None
        cred = qd.get("X-Amz-Credential", "").split("/")
        if len(cred) < 3:
            return "AuthorizationHeaderMalformed", None
        access, date, region = cred[0], cred[1], cred[2]
        secret = self.users.get(access)
        if secret is None:
            return "InvalidAccessKeyId", None
        amz_date = qd.get("X-Amz-Date", "")
        try:
            ts = calendar.timegm(
                time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
            expires = int(qd.get("X-Amz-Expires", "0"))
        except ValueError:
            return "AuthorizationHeaderMalformed", None
        now = self._now if self._now is not None else time.time()
        if now > ts + expires or ts - now > self.CLOCK_SKEW_S:
            return "AccessDenied", None  # expired / from the future
        signed = qd.get("X-Amz-SignedHeaders", "host").split(";")
        # canonical query = every param EXCEPT the signature itself
        q = urllib.parse.urlencode(
            [(k, v) for k, v in pairs if k != "X-Amz-Signature"],
            quote_via=urllib.parse.quote)
        canon = sigv4_canonical_request(
            method, urllib.parse.unquote(parsed.path), q, headers,
            signed, "UNSIGNED-PAYLOAD")
        sig = sigv4_signature(secret, date, region, amz_date, canon)
        if not _hmac.compare_digest(sig,
                                    qd.get("X-Amz-Signature", "")):
            return "SignatureDoesNotMatch", None
        return None, access

    async def _handle(self, method: str, target: str, headers: dict,
                      body: bytes) -> tuple[int, dict, bytes]:
        if method == "OPTIONS":
            # CORS preflight: unauthenticated by design (browsers
            # send no credentials on preflight)
            try:
                return await self._preflight(target, headers)
            except RGWError as e:
                el = ET.Element("Error")
                ET.SubElement(el, "Code").text = e.code
                return e.status, {"content-type": "application/xml"}, \
                    _xml(el)
        err, principal = (
            self._authenticate(method, target, headers, body)
            if self.users else (None, None))
        if err is not None:
            el = ET.Element("Error")
            ET.SubElement(el, "Code").text = err
            return 403, {"content-type": "application/xml"}, _xml(el)
        status, rh, data = await self._route(method, target, headers,
                                             body, principal)
        origin = headers.get("origin")
        if origin:
            # simple (non-preflight) cross-origin request: attach the
            # allow headers when a bucket CORS rule matches
            path = urllib.parse.unquote(
                urllib.parse.urlsplit(target).path)
            parts = [p for p in path.split("/") if p]
            if parts:
                allow = RGWLite.cors_match(
                    await self._cors_rules(parts[0]), origin, method,
                    [])
                if allow:
                    rh = {**rh,
                          "access-control-allow-origin":
                              allow["access-control-allow-origin"]}
                    if "access-control-expose-headers" in allow:
                        rh["access-control-expose-headers"] = allow[
                            "access-control-expose-headers"]
        return status, rh, data

    # ------------------------------------------------------ authorization
    #
    # rgw_op.cc verify_bucket/object_permission role.  Enforcement is
    # active only when a user table exists; the open (DummyAuth)
    # frontend stays fully permissive.

    def _enforce(self, acl: "rgw_acl.Acl", principal: str | None,
                 perm: str) -> None:
        """The ONE owner of the "is enforcement on" rule: no user
        table = permissive.  The `if self.users` in _authz_* is purely
        a policy-FETCH skip, never the decision."""
        if self.users and not acl.allows(principal, perm):
            raise RGWError("AccessDenied", 403)

    async def _bucket_policy(self, bucket: str) -> "rgw_acl.Acl":
        owner, text = await self.rgw.get_bucket_acl(bucket)
        return rgw_acl.Acl.parse(owner, text)

    async def _authz_bucket(self, bucket: str, principal: str | None,
                            perm: str) -> None:
        if self.users:
            self._enforce(await self._bucket_policy(bucket),
                          principal, perm)

    async def _head_guarded(self, bucket: str, key: str, vid: str,
                            principal: str | None) -> dict:
        """head_object with the S3 404-vs-403 rule: a key's ABSENCE
        (or an unknown version) is disclosed only to principals
        holding READ (list) on the bucket — everyone else gets
        AccessDenied, closing the key-existence oracle the anonymous
        path would otherwise open."""
        try:
            return await self.rgw.head_object(bucket, key,
                                              version_id=vid)
        except RGWError as e:
            if self.users and e.status == 404 \
                    and e.code != "NoSuchBucket":
                self._enforce(await self._bucket_policy(bucket),
                              principal, "READ")
            raise

    async def _authz_object(self, bucket: str, key: str, vid: str,
                            principal: str | None,
                            perm: str) -> dict | None:
        """Guarded head + enforce; returns the fetched entry so the
        caller can reuse it (one index round trip per request)."""
        if not self.users:
            return None
        meta = await self._head_guarded(bucket, key, vid, principal)
        self._enforce(await self._policy_of(bucket, meta),
                      principal, perm)
        return meta

    async def _policy_of(self, bucket: str,
                         ent: dict) -> "rgw_acl.Acl":
        """Policy from an already-fetched index entry (no second
        index round trip on the read path), bucket fallback for
        pre-ACL rows."""
        if ent["owner"] or ent["acl"]:
            return rgw_acl.Acl.parse(ent["owner"], ent["acl"])
        return await self._bucket_policy(bucket)

    def _canned_grants(self, headers: dict,
                       principal: str | None) -> str:
        """Expand an x-amz-acl header into grant-list text (canned-ACL
        role); absent header = private."""
        name = headers.get("x-amz-acl", "") or "private"
        try:
            return rgw_acl.Acl.canned(principal or "", name).dump()
        except KeyError:
            raise RGWError("InvalidArgument") from None

    async def _route(self, method: str, target: str, headers: dict,
                     body: bytes, principal: str | None = None):
        parsed = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(parsed.path)
        query = urllib.parse.parse_qs(parsed.query,
                                      keep_blank_values=True)
        parts = [p for p in path.split("/") if p]
        try:
            if not parts:
                if method == "GET":
                    if self.users and principal is None:
                        # S3 ListBuckets is per-account; anonymous
                        # gets nothing
                        raise RGWError("AccessDenied", 403)
                    return await self._list_buckets(principal)
                return 400, {}, b""
            bucket = parts[0]
            key = "/".join(parts[1:])
            if not key:
                if "acl" in query:
                    return await self._bucket_acl_route(
                        method, bucket, headers, body, principal)
                if "versioning" in query:
                    await self._authz_bucket(
                        bucket, principal,
                        "FULL_CONTROL" if method == "PUT" else "READ")
                    return await self._bucket_versioning(
                        method, bucket, body)
                if "lifecycle" in query:
                    await self._authz_bucket(
                        bucket, principal,
                        "FULL_CONTROL" if method == "PUT" else "READ")
                    return await self._bucket_lifecycle(
                        method, bucket, body)
                if "tagging" in query:
                    await self._authz_bucket(
                        bucket, principal,
                        "READ" if method == "GET" else "FULL_CONTROL")
                    return await self._bucket_tagging(
                        method, bucket, body)
                if "cors" in query:
                    await self._authz_bucket(
                        bucket, principal,
                        "READ" if method == "GET" else "FULL_CONTROL")
                    resp = await self._bucket_cors(
                        method, bucket, body)
                    if method in ("PUT", "DELETE"):
                        # invalidate AFTER the store write (popping
                        # first lets a racing preflight re-cache the
                        # OLD rules during the write), and bump the
                        # generation so a preflight that READ before
                        # this write refuses to cache its stale copy
                        if len(self._cors_gen) >= 8192 \
                                and bucket not in self._cors_gen:
                            # bounded like _cors_cache; a reader
                            # racing an evicted entry merely declines
                            # to cache (gen mismatch), never serves
                            # stale
                            self._cors_gen.pop(
                                next(iter(self._cors_gen)))
                        self._cors_gen[bucket] = \
                            self._cors_gen.get(bucket, 0) + 1
                        self._cors_cache.pop(bucket, None)
                    return resp
                if "versions" in query:
                    await self._authz_bucket(bucket, principal,
                                             "READ")
                    return await self._list_versions(bucket, query)
                if method == "PUT":
                    if self.users and principal is None:
                        # anonymous principals never own buckets
                        raise RGWError("AccessDenied", 403)
                    await self.rgw.create_bucket(
                        bucket, owner=principal or "",
                        acl=self._canned_grants(headers, principal))
                    return 200, {}, b""
                if method == "DELETE":
                    await self._authz_bucket(bucket, principal,
                                             "FULL_CONTROL")
                    await self.rgw.delete_bucket(bucket)
                    # drop the bucket's CORS state with it, or a
                    # create/put-cors/delete loop over fresh names
                    # leaks a generation entry per iteration
                    self._cors_cache.pop(bucket, None)
                    self._cors_gen.pop(bucket, None)
                    return 204, {}, b""
                if method == "GET":
                    await self._authz_bucket(bucket, principal,
                                             "READ")
                    return await self._list_objects(bucket, query)
                return 400, {}, b""
            vid = query.get("versionId", [""])[0]
            if "acl" in query:
                return await self._object_acl_route(
                    method, bucket, key, vid, headers, body,
                    principal)
            if "tagging" in query:
                return await self._object_tagging_route(
                    method, bucket, key, vid, body, principal)
            if method == "PUT":
                await self._authz_bucket(bucket, principal, "WRITE")
                grants = self._canned_grants(headers, principal)
                src = headers.get("x-amz-copy-source")
                if src:
                    sb, _, sk = src.strip("/").partition("/")
                    await self._authz_object(sb, sk, "", principal,
                                             "READ")
                    etag = await self.rgw.copy_object(
                        sb, sk, bucket, key,
                        owner=principal or "", acl=grants)
                else:
                    tags = None
                    th = headers.get("x-amz-tagging")
                    if th:  # url-encoded tag set on the PUT itself
                        tags = dict(urllib.parse.parse_qsl(th))
                        RGWLite._validate_tags(tags)
                    umeta = {k[len("x-amz-meta-"):]: v
                             for k, v in headers.items()
                             if k.startswith("x-amz-meta-")}
                    etag = await self.rgw.put_object(
                        bucket, key, body,
                        content_type=headers.get("content-type", ""),
                        meta=umeta or None,
                        owner=principal or "", acl=grants, tags=tags)
                rh = {}
                if isinstance(etag, tuple):
                    etag, new_vid = etag
                    rh["x-amz-version-id"] = new_vid
                rh["etag"] = f'"{etag}"'
                return 200, rh, b""
            if method == "GET":
                meta = await self._authz_object(bucket, key, vid,
                                                principal, "READ")
                data, meta = await self.rgw.get_object(
                    bucket, key, version_id=vid, _meta=meta)
                rh = {"etag": f'"{meta["etag"]}"'}
                if meta["version_id"]:
                    rh["x-amz-version-id"] = meta["version_id"]
                if meta["content_type"]:
                    rh["content-type"] = meta["content_type"]
                for mk, mv in (meta["meta"] or {}).items():
                    rh[f"x-amz-meta-{mk}"] = mv
                if meta.get("tags"):
                    rh["x-amz-tagging-count"] = str(len(meta["tags"]))
                return 200, rh, data
            if method == "HEAD":
                meta = await self._authz_object(bucket, key, vid,
                                                principal, "READ")
                if meta is None:  # open frontend: fetch for headers
                    meta = await self.rgw.head_object(
                        bucket, key, version_id=vid)
                return 200, {
                    "etag": f'"{meta["etag"]}"',
                    "content-length": str(meta["size"]),
                }, b""
            if method == "DELETE":
                await self._authz_bucket(bucket, principal, "WRITE")
                marker_vid = await self.rgw.delete_object(
                    bucket, key, version_id=vid)
                rh = {}
                if marker_vid:
                    rh["x-amz-version-id"] = marker_vid
                    if not vid:
                        rh["x-amz-delete-marker"] = "true"
                return 204, rh, b""
            return 400, {}, b""
        except RGWError as e:
            err = ET.Element("Error")
            ET.SubElement(err, "Code").text = e.code
            return e.status, {"content-type": "application/xml"}, \
                _xml(err)

    async def _acl_route(self, method: str, headers: dict,
                         body: bytes, principal: str | None,
                         policy: "rgw_acl.Acl", store):
        """Shared GET/PUT ?acl machinery (RGWGetACLs / RGWPutACLs
        role) for buckets AND objects — ``policy`` is the current
        policy, ``store`` persists a new grant list.  The owner is
        immutable — a PUT replaces only the grant list, from either an
        XML AccessControlPolicy body or an x-amz-acl canned header.
        A body that does not parse as a policy is a 400
        MalformedACLError, never a dropped connection or a silently
        thinned grant list."""
        if method == "GET":
            self._enforce(policy, principal, "READ_ACP")
            return 200, {"content-type": "application/xml"}, \
                policy.to_xml()
        if method != "PUT":
            return 400, {}, b""
        self._enforce(policy, principal, "WRITE_ACP")
        if body:
            try:
                grants = rgw_acl.Acl.from_xml(
                    body, policy.owner).dump()
            except (ET.ParseError, ValueError):
                raise RGWError("MalformedACLError") from None
        else:
            grants = self._canned_grants(headers, principal)
        await store(policy.owner, grants)
        return 200, {}, b""

    async def _bucket_acl_route(self, method: str, bucket: str,
                                headers: dict, body: bytes,
                                principal: str | None):
        policy = await self._bucket_policy(bucket)

        async def store(owner, grants):
            await self.rgw.put_bucket_acl(bucket, owner, grants)

        return await self._acl_route(method, headers, body, principal,
                                     policy, store)

    async def _object_acl_route(self, method: str, bucket: str,
                                key: str, vid: str, headers: dict,
                                body: bytes, principal: str | None):
        meta = await self._head_guarded(bucket, key, vid, principal)
        policy = await self._policy_of(bucket, meta)

        async def store(owner, grants):
            await self.rgw.put_object_acl(bucket, key, owner, grants,
                                          version_id=vid, _ent=meta)

        return await self._acl_route(method, headers, body, principal,
                                     policy, store)

    async def _bucket_versioning(self, method: str, bucket: str,
                                 body: bytes):
        if method == "PUT":
            status = "Enabled" if b"Enabled" in body else "Suspended"
            await self.rgw.put_bucket_versioning(bucket, status)
            return 200, {}, b""
        status = await self.rgw.get_bucket_versioning(bucket)
        root = ET.Element("VersioningConfiguration")
        if status:
            ET.SubElement(root, "Status").text = status
        return 200, {"content-type": "application/xml"}, _xml(root)

    async def _bucket_lifecycle(self, method: str, bucket: str,
                                body: bytes):
        if method == "PUT":
            rules = []
            for r in ET.fromstring(body).iter("Rule"):
                days = r.findtext("Expiration/Days")
                nc = r.findtext(
                    "NoncurrentVersionExpiration/NoncurrentDays")
                rules.append({
                    "id": r.findtext("ID") or "",
                    "prefix": (r.findtext("Filter/Prefix")
                               or r.findtext("Prefix") or ""),
                    "days": float(days) if days else None,
                    "noncurrent_days": float(nc) if nc else None,
                })
            await self.rgw.put_lifecycle(bucket, rules)
            return 200, {}, b""
        rules = await self.rgw.get_lifecycle(bucket)
        root = ET.Element("LifecycleConfiguration")
        for r in rules:
            el = ET.SubElement(root, "Rule")
            ET.SubElement(el, "ID").text = r["id"]
            ET.SubElement(el, "Prefix").text = r["prefix"]
            if r["days"] is not None:
                exp = ET.SubElement(el, "Expiration")
                ET.SubElement(exp, "Days").text = str(r["days"])
            if r["noncurrent_days"] is not None:
                nce = ET.SubElement(el, "NoncurrentVersionExpiration")
                ET.SubElement(nce, "NoncurrentDays").text = \
                    str(r["noncurrent_days"])
        return 200, {"content-type": "application/xml"}, _xml(root)

    # --------------------------------------------------- tagging + cors

    @staticmethod
    def _parse_tagging_xml(body: bytes) -> dict[str, str]:
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise RGWError("MalformedXML") from None
        tags: dict[str, str] = {}
        for tag in root.iter("Tag"):
            k = tag.findtext("Key") or ""
            tags[k] = tag.findtext("Value") or ""
        return tags

    @staticmethod
    def _render_tagging_xml(tags: dict[str, str]) -> bytes:
        root = ET.Element("Tagging")
        ts = ET.SubElement(root, "TagSet")
        for k, v in sorted(tags.items()):
            el = ET.SubElement(ts, "Tag")
            ET.SubElement(el, "Key").text = k
            ET.SubElement(el, "Value").text = v
        return _xml(root)

    async def _bucket_tagging(self, method: str, bucket: str,
                              body: bytes):
        if method == "PUT":
            await self.rgw.put_bucket_tagging(
                bucket, self._parse_tagging_xml(body))
            return 204, {}, b""
        if method == "DELETE":
            await self.rgw.delete_bucket_tagging(bucket)
            return 204, {}, b""
        tags = await self.rgw.get_bucket_tagging(bucket)
        if not tags:
            raise RGWError("NoSuchTagSet", 404)
        return 200, {"content-type": "application/xml"}, \
            self._render_tagging_xml(tags)

    async def _object_tagging_route(self, method: str, bucket: str,
                                    key: str, vid: str, body: bytes,
                                    principal: str | None):
        perm = "READ" if method == "GET" else "WRITE"
        await self._authz_object(bucket, key, vid, principal, perm)
        if method == "PUT":
            avid = await self.rgw.put_object_tagging(
                bucket, key, self._parse_tagging_xml(body),
                version_id=vid)
            rh = {"x-amz-version-id": avid} if avid else {}
            return 200, rh, b""
        if method == "DELETE":
            await self.rgw.delete_object_tagging(bucket, key,
                                                 version_id=vid)
            return 204, {}, b""
        tags = await self.rgw.get_object_tagging(bucket, key,
                                                 version_id=vid)
        return 200, {"content-type": "application/xml"}, \
            self._render_tagging_xml(tags)

    async def _bucket_cors(self, method: str, bucket: str,
                           body: bytes):
        if method == "PUT":
            try:
                root = ET.fromstring(body)
            except ET.ParseError:
                raise RGWError("MalformedXML") from None
            rules = []
            for r in root.iter("CORSRule"):
                rule = {
                    "allowed_origins": [
                        e.text or "" for e in r.findall("AllowedOrigin")],
                    "allowed_methods": [
                        e.text or "" for e in r.findall("AllowedMethod")],
                    "allowed_headers": [
                        e.text or "" for e in r.findall("AllowedHeader")],
                    "expose_headers": [
                        e.text or "" for e in r.findall("ExposeHeader")],
                }
                age = r.findtext("MaxAgeSeconds")
                if age:
                    rule["max_age_seconds"] = int(age)
                rules.append(rule)
            await self.rgw.put_bucket_cors(bucket, rules)
            return 200, {}, b""
        if method == "DELETE":
            await self.rgw.delete_bucket_cors(bucket)
            return 204, {}, b""
        rules = await self.rgw.get_bucket_cors(bucket)
        if not rules:
            raise RGWError("NoSuchCORSConfiguration", 404)
        root = ET.Element("CORSConfiguration")
        for r in rules:
            el = ET.SubElement(root, "CORSRule")
            for o in r["allowed_origins"]:
                ET.SubElement(el, "AllowedOrigin").text = o
            for m in r["allowed_methods"]:
                ET.SubElement(el, "AllowedMethod").text = m
            for h in r.get("allowed_headers", []):
                ET.SubElement(el, "AllowedHeader").text = h
            for h in r.get("expose_headers", []):
                ET.SubElement(el, "ExposeHeader").text = h
            if r.get("max_age_seconds"):
                ET.SubElement(el, "MaxAgeSeconds").text = \
                    str(r["max_age_seconds"])
        return 200, {"content-type": "application/xml"}, _xml(root)

    async def _preflight(self, target: str,
                         headers: dict) -> tuple[int, dict, bytes]:
        """OPTIONS preflight (rgw_cors RGWOptionsCORS role):
        unauthenticated by design — browsers send no credentials."""
        origin = headers.get("origin", "")
        acrm = headers.get("access-control-request-method", "")
        if not origin or not acrm:
            raise RGWError("InvalidRequest", 403)
        path = urllib.parse.unquote(
            urllib.parse.urlsplit(target).path)
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise RGWError("InvalidRequest", 403)
        rules = await self._cors_rules(parts[0])
        req_hdrs = [h.strip() for h in headers.get(
            "access-control-request-headers", "").split(",")
            if h.strip()]
        allow = RGWLite.cors_match(rules, origin, acrm, req_hdrs)
        if allow is None:
            raise RGWError("AccessForbidden", 403)
        return 200, allow, b""

    async def _list_versions(self, bucket: str, query: dict):
        vers = await self.rgw.list_object_versions(
            bucket,
            prefix=query.get("prefix", [""])[0],
            max_keys=int(query.get("max-keys", ["1000"])[0]))
        root = ET.Element("ListVersionsResult")
        ET.SubElement(root, "Name").text = bucket
        for e in vers:
            tag = ("DeleteMarker" if e["delete_marker"]
                   else "Version")
            el = ET.SubElement(root, tag)
            ET.SubElement(el, "Key").text = e["key"]
            ET.SubElement(el, "VersionId").text = \
                e["version_id"] or "null"
            ET.SubElement(el, "IsLatest").text = \
                "true" if e.get("is_latest") else "false"
            if not e["delete_marker"]:
                ET.SubElement(el, "Size").text = str(e["size"])
                ET.SubElement(el, "ETag").text = f'"{e["etag"]}"'
        return 200, {"content-type": "application/xml"}, _xml(root)

    async def _list_buckets(self, principal: str | None = None):
        """ListBuckets is per-account: only the principal's own
        buckets (plus ownerless pre-ACL ones) appear when a user
        table is configured.  Owners come from one CONCURRENT xattr
        sweep — no per-bucket re-fetch of the bucket registry."""
        names = await self.rgw.list_buckets()
        owners = ([""] * len(names) if not self.users else
                  await asyncio.gather(
                      *(self.rgw.bucket_owner(b) for b in names)))
        root = ET.Element("ListAllMyBucketsResult")
        buckets = ET.SubElement(root, "Buckets")
        for b, owner in zip(names, owners):
            if self.users and owner and owner != principal:
                continue
            el = ET.SubElement(buckets, "Bucket")
            ET.SubElement(el, "Name").text = b
        return 200, {"content-type": "application/xml"}, _xml(root)

    async def _list_objects(self, bucket: str, query: dict):
        entries, truncated = await self.rgw.list_objects(
            bucket,
            prefix=query.get("prefix", [""])[0],
            marker=query.get("marker", [""])[0]
            or query.get("start-after", [""])[0],
            max_keys=int(query.get("max-keys", ["1000"])[0]),
        )
        root = ET.Element("ListBucketResult")
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated else "false"
        for e in entries:
            el = ET.SubElement(root, "Contents")
            ET.SubElement(el, "Key").text = e["key"]
            ET.SubElement(el, "Size").text = str(e["size"])
            ET.SubElement(el, "ETag").text = f'"{e["etag"]}"'
        return 200, {"content-type": "application/xml"}, _xml(root)
