"""The cases of ``tests/test_rgw.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

RGW-lite tests: bucket/object API, listings, multipart, and the
HTTP frontend driven over a real socket (the s3-tests role, shrunk)."""
import asyncio
import hashlib

import numpy as np
import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.rgw import RGWError, RGWLite, S3Frontend
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make():
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rgw", size=3, pg_num=8, crush_rule=0)
    )
    await c.wait_active(20)
    return c, RGWLite(c.client, 1)


def test_bucket_lifecycle():
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("alpha")
        await rgw.create_bucket("beta")
        with pytest.raises(RGWError, match="BucketAlreadyExists"):
            await rgw.create_bucket("alpha")
        with pytest.raises(RGWError, match="InvalidBucketName"):
            await rgw.create_bucket("bad/name")
        assert await rgw.list_buckets() == ["alpha", "beta"]
        await rgw.put_object("alpha", "k", b"v")
        with pytest.raises(RGWError, match="BucketNotEmpty"):
            await rgw.delete_bucket("alpha")
        await rgw.delete_object("alpha", "k")
        await rgw.delete_bucket("alpha")
        assert await rgw.list_buckets() == ["beta"]
        with pytest.raises(RGWError, match="NoSuchBucket"):
            await rgw.put_object("gone", "k", b"v")
        await c.stop()

    run(t())


def test_object_roundtrip_and_listing():
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b")
        data = b"hello s3 world"
        etag = await rgw.put_object("b", "docs/readme.txt", data)
        assert etag == hashlib.md5(data).hexdigest()
        got, meta = await rgw.get_object("b", "docs/readme.txt")
        assert got == data and meta["etag"] == etag
        for k in ("docs/a", "docs/b", "logs/1", "logs/2", "zzz"):
            await rgw.put_object("b", k, k.encode())
        entries, trunc = await rgw.list_objects("b")
        keys = [e["key"] for e in entries]
        assert keys == sorted(keys) and not trunc
        docs, _ = await rgw.list_objects("b", prefix="docs/")
        assert [e["key"] for e in docs] == ["docs/a", "docs/b",
                                           "docs/readme.txt"]
        page1, trunc = await rgw.list_objects("b", max_keys=2)
        assert len(page1) == 2 and trunc
        page2, _ = await rgw.list_objects("b", marker=page1[-1]["key"])
        assert page2[0]["key"] > page1[-1]["key"]
        # overwrite changes etag; copy preserves content
        await rgw.put_object("b", "zzz", b"new")
        await rgw.copy_object("b", "zzz", "b", "zzz-copy")
        got2, _ = await rgw.get_object("b", "zzz-copy")
        assert got2 == b"new"
        await rgw.delete_object("b", "zzz")
        with pytest.raises(RGWError, match="NoSuchKey"):
            await rgw.get_object("b", "zzz")
        await c.stop()

    run(t())


def test_multipart_upload():
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("mp")
        upload = await rgw.initiate_multipart("mp", "big")
        rng = np.random.default_rng(5)
        parts = [rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
                 for _ in range(3)]
        for i, p in enumerate(parts, start=1):
            await rgw.upload_part("mp", "big", upload, i, p)
        etag = await rgw.complete_multipart("mp", "big", upload,
                                            [1, 2, 3])
        assert etag.endswith("-3")
        got, meta = await rgw.get_object("mp", "big")
        assert got == b"".join(parts)
        assert meta["size"] == 150_000 and meta["multipart"]
        await rgw.delete_object("mp", "big")
        entries, _ = await rgw.list_objects("mp")
        assert entries == []
        await c.stop()

    run(t())


async def http(host, port, method, path, body=b"", headers=None):
    reader, writer = await asyncio.open_connection(host, port)
    head = [f"{method} {path} HTTP/1.1", f"host: {host}",
            f"content-length: {len(body)}"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1])
    rheaders = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        k, v = h.decode().split(":", 1)
        rheaders[k.strip().lower()] = v.strip()
    n = int(rheaders.get("content-length", "0"))
    # HEAD advertises the entity length but carries no body
    rbody = await reader.readexactly(n) if n and method != "HEAD" else b""
    writer.close()
    return status, rheaders, rbody


def test_http_frontend():
    async def t():
        c, rgw = await make()
        fe = S3Frontend(rgw)
        host, port = await fe.start()
        assert (await http(host, port, "PUT", "/photos"))[0] == 200
        st, hd, _ = await http(host, port, "PUT", "/photos/cat.jpg",
                               b"MEOW" * 100)
        assert st == 200 and hd["etag"].strip('"') == hashlib.md5(
            b"MEOW" * 100
        ).hexdigest()
        st, hd, body = await http(host, port, "GET", "/photos/cat.jpg")
        assert st == 200 and body == b"MEOW" * 100
        st, hd, _ = await http(host, port, "HEAD", "/photos/cat.jpg")
        assert st == 200 and hd["content-length"] == "400"
        # copy via x-amz-copy-source
        st, _, _ = await http(host, port, "PUT", "/photos/cat2.jpg",
                              headers={"x-amz-copy-source":
                                       "/photos/cat.jpg"})
        assert st == 200
        st, _, body = await http(host, port, "GET",
                                 "/photos?prefix=cat")
        assert st == 200 and b"<Key>cat.jpg</Key>" in body \
            and b"<Key>cat2.jpg</Key>" in body
        st, _, body = await http(host, port, "GET", "/")
        assert b"<Name>photos</Name>" in body
        assert (await http(host, port, "DELETE",
                           "/photos/cat.jpg"))[0] == 204
        st, _, body = await http(host, port, "GET", "/photos/cat.jpg")
        assert st == 404 and b"NoSuchKey" in body
        await fe.stop()
        await c.stop()

    run(t())


def test_cls_bucket_index_stats():
    """The bucket index is cls-served: every update maintains count and
    byte totals atomically server-side (cls_rgw stats role)."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("s")
        st = await rgw.bucket_stats("s")
        assert (st["count"], st["bytes"]) == (0, 0)
        await rgw.put_object("s", "a", b"x" * 100)
        await rgw.put_object("s", "b", b"y" * 250)
        st = await rgw.bucket_stats("s")
        assert (st["count"], st["bytes"]) == (2, 350)
        await rgw.put_object("s", "a", b"z" * 10)  # overwrite re-accounts
        st = await rgw.bucket_stats("s")
        assert (st["count"], st["bytes"]) == (2, 260)
        await rgw.delete_object("s", "b")
        st = await rgw.bucket_stats("s")
        assert (st["count"], st["bytes"]) == (1, 10)
        assert st["generation"] == 4  # one bump per index mutation
        await c.stop()

    run(t())


def _signed_headers(method, path, query, body, host, access, secret,
                    amz_date=None):
    import time as _time

    from ceph_tpu_torch.services.rgw import _sha256, sigv4_sign

    if amz_date is None:  # fresh: inside the frontend's skew window
        amz_date = _time.strftime("%Y%m%dT%H%M%SZ", _time.gmtime())
    headers = {
        "host": host,
        "x-amz-content-sha256": _sha256(body),
        "x-amz-date": amz_date,
    }
    headers["authorization"] = sigv4_sign(
        method, path, query, headers, body, access, secret, amz_date)
    return headers


def test_sigv4_auth():
    """Frontend with a user table: correctly signed requests pass,
    bad signatures / unknown keys / tampered bodies get 403."""
    async def t():
        import urllib.request

        c, rgw = await make()
        fe = S3Frontend(rgw, users={"AKIDEXAMPLE": "s3cr3t"})
        host, port = await fe.start()
        base = f"http://{host}:{port}"
        hosthdr = f"{host}:{port}"

        def req(method, path, body=b"", headers=None, query=""):
            url = base + path + (f"?{query}" if query else "")
            r = urllib.request.Request(url, data=body or None,
                                       method=method)
            for k, v in (headers or {}).items():
                r.add_header(k, v)
            try:
                with urllib.request.urlopen(r) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        loop = asyncio.get_running_loop()

        async def areq(*a, **kw):
            return await loop.run_in_executor(None,
                                              lambda: req(*a, **kw))

        # unauthenticated: rejected
        status, body = await areq("PUT", "/b1")
        assert status == 403 and b"AccessDenied" in body
        # signed bucket create + object put + get round-trip
        h = _signed_headers("PUT", "/b1", "", b"", hosthdr,
                            "AKIDEXAMPLE", "s3cr3t")
        status, _ = await areq("PUT", "/b1", headers=h)
        assert status == 200
        payload = b"signed payload"
        h = _signed_headers("PUT", "/b1/k", "", payload, hosthdr,
                            "AKIDEXAMPLE", "s3cr3t")
        status, _ = await areq("PUT", "/b1/k", body=payload, headers=h)
        assert status == 200
        h = _signed_headers("GET", "/b1/k", "", b"", hosthdr,
                            "AKIDEXAMPLE", "s3cr3t")
        status, body = await areq("GET", "/b1/k", headers=h)
        assert status == 200 and body == payload
        # wrong secret -> 403
        h = _signed_headers("GET", "/b1/k", "", b"", hosthdr,
                            "AKIDEXAMPLE", "WRONG")
        status, body = await areq("GET", "/b1/k", headers=h)
        assert status == 403 and b"SignatureDoesNotMatch" in body
        # unknown access key -> 403
        h = _signed_headers("GET", "/b1/k", "", b"", hosthdr,
                            "NOBODY", "s3cr3t")
        status, body = await areq("GET", "/b1/k", headers=h)
        assert status == 403 and b"InvalidAccessKeyId" in body
        # tampered body (hash mismatch) -> 403
        h = _signed_headers("PUT", "/b1/k2", "", b"original", hosthdr,
                            "AKIDEXAMPLE", "s3cr3t")
        status, body = await areq("PUT", "/b1/k2", body=b"tampered",
                                  headers=h)
        assert status == 403
        # stale replay: a validly signed request whose x-amz-date is
        # outside the 15-min skew window is rejected (without this a
        # captured request replays forever)
        import time as _time

        old = _time.strftime("%Y%m%dT%H%M%SZ",
                             _time.gmtime(_time.time() - 3600))
        h = _signed_headers("GET", "/b1/k", "", b"", hosthdr,
                            "AKIDEXAMPLE", "s3cr3t", amz_date=old)
        status, body = await areq("GET", "/b1/k", headers=h)
        assert status == 403 and b"RequestTimeTooSkewed" in body
        await fe.stop()
        await c.stop()

    run(t())


def test_object_versioning():
    """Versioned buckets (rgw_op.cc versioned paths): PUT stacks
    versions, GET serves current or a named version, DELETE without a
    version inserts a delete marker, deleting the marker restores, and
    deleting a specific version promotes the next-newest."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b")
        assert await rgw.get_bucket_versioning("b") == ""
        await rgw.put_bucket_versioning("b", "Enabled")
        assert await rgw.get_bucket_versioning("b") == "Enabled"

        _, v1 = await rgw.put_object("b", "k", b"one")
        await asyncio.sleep(0.002)
        _, v2 = await rgw.put_object("b", "k", b"two")
        assert v1 != v2
        data, meta = await rgw.get_object("b", "k")
        assert data == b"two" and meta["version_id"] == v2
        data, _ = await rgw.get_object("b", "k", version_id=v1)
        assert data == b"one"

        vers = await rgw.list_object_versions("b")
        assert [e["version_id"] for e in vers] == [v2, v1]
        assert [e["is_latest"] for e in vers] == [True, False]

        # delete -> marker; key vanishes from plain listings but all
        # versions remain readable by id
        marker_vid = await rgw.delete_object("b", "k")
        with pytest.raises(RGWError, match="NoSuchKey"):
            await rgw.get_object("b", "k")
        ents, _tr = await rgw.list_objects("b")
        assert ents == []
        assert (await rgw.get_object("b", "k", version_id=v2))[0] \
            == b"two"
        vers = await rgw.list_object_versions("b")
        assert vers[0]["delete_marker"] and vers[0]["is_latest"]

        # deleting the MARKER undeletes (S3 semantics)
        await rgw.delete_object("b", "k", version_id=marker_vid)
        data, _ = await rgw.get_object("b", "k")
        assert data == b"two"
        ents, _tr = await rgw.list_objects("b")
        assert [e["key"] for e in ents] == ["k"]

        # deleting the CURRENT version promotes the previous one
        await rgw.delete_object("b", "k", version_id=v2)
        data, meta = await rgw.get_object("b", "k")
        assert data == b"one" and meta["version_id"] == v1
        # and deleting the last version removes the key entirely
        await rgw.delete_object("b", "k", version_id=v1)
        with pytest.raises(RGWError):
            await rgw.get_object("b", "k")
        assert await rgw.list_object_versions("b") == []
        await c.stop()

    run(t())


def test_lifecycle_expiration():
    """LC rules (rgw_lc.cc role): ``days`` expires current objects
    (marker on versioned buckets), ``noncurrent_days`` reaps old
    versions for good; driven one pass at a time via lc_process (the
    rgw_lc mgr module's tick calls exactly this)."""
    async def t():
        import time as _time

        c, rgw = await make()
        await rgw.create_bucket("b")
        await rgw.put_bucket_versioning("b", "Enabled")
        _, v1 = await rgw.put_object("b", "old", b"x" * 100)
        await asyncio.sleep(0.002)
        _, v2 = await rgw.put_object("b", "old", b"y" * 100)
        await rgw.put_object("b", "tmp/scratch", b"z")

        await rgw.put_lifecycle("b", [
            {"id": "expire-tmp", "prefix": "tmp/", "days": 1},
            {"id": "reap-old-versions", "prefix": "old",
             "noncurrent_days": 2},
        ])
        got = await rgw.get_lifecycle("b")
        assert [r["id"] for r in got] == ["expire-tmp",
                                         "reap-old-versions"]

        # nothing is old enough yet: a pass is a no-op
        rep = await rgw.lc_process()
        assert rep["b"] == {"expired_current": 0,
                            "expired_noncurrent": 0}
        ents, _ = await rgw.list_objects("b")
        assert [e["key"] for e in ents] == ["old", "tmp/scratch"]

        # jump 1.5 days: tmp/ current expires (delete marker), old's
        # noncurrent v1 survives (needs 2 days)
        rep = await rgw.lc_process(now=_time.time() + 1.5 * 86400)
        assert rep["b"]["expired_current"] == 1
        ents, _ = await rgw.list_objects("b")
        assert [e["key"] for e in ents] == ["old"]
        assert (await rgw.get_object("b", "old", version_id=v1))[0] \
            == b"x" * 100

        # jump 3 days: noncurrent v1 reaped; current v2 still there
        # (the "old" rule has no current-expiration days)
        rep = await rgw.lc_process(now=_time.time() + 3 * 86400)
        assert rep["b"]["expired_noncurrent"] >= 1
        with pytest.raises(RGWError, match="NoSuchVersion"):
            await rgw.get_object("b", "old", version_id=v1)
        assert (await rgw.get_object("b", "old"))[0] == b"y" * 100
        await c.stop()

    run(t())


def test_versioning_rest_surface():
    """The REST dialect: ?versioning, ?versions, ?lifecycle and
    versionId= routing."""
    async def t():
        import urllib.parse

        c, rgw = await make()
        fe = S3Frontend(rgw)
        host, port = await fe.start()

        async def req(method, target, body=b""):
            r, w = await asyncio.open_connection(host, port)
            w.write(
                f"{method} {target} HTTP/1.1\r\n"
                f"host: {host}\r\ncontent-length: {len(body)}\r\n"
                "\r\n".encode() + body)
            await w.drain()
            status = int((await r.readline()).split()[1])
            hdrs = {}
            while True:
                line = await r.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, v = line.decode().split(":", 1)
                hdrs[k.strip().lower()] = v.strip()
            data = await r.readexactly(int(hdrs.get("content-length",
                                                    "0")))
            w.close()
            return status, hdrs, data

        assert (await req("PUT", "/vb"))[0] == 200
        assert (await req(
            "PUT", "/vb?versioning",
            b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>"))[0] == 200
        st, _, body = await req("GET", "/vb?versioning")
        assert st == 200 and b"Enabled" in body

        st, h1, _ = await req("PUT", "/vb/k", b"one")
        v1 = h1["x-amz-version-id"]
        st, h2, _ = await req("PUT", "/vb/k", b"two")
        v2 = h2["x-amz-version-id"]
        st, _, data = await req(
            "GET", f"/vb/k?versionId={urllib.parse.quote(v1)}")
        assert st == 200 and data == b"one"
        st, _, body = await req("GET", "/vb?versions")
        assert body.count(b"<Version>") == 2
        assert v2.encode() in body

        st, h, _ = await req("DELETE", "/vb/k")
        assert h.get("x-amz-delete-marker") == "true"
        assert (await req("GET", "/vb/k"))[0] == 404
        st, _, body = await req("GET", "/vb?versions")
        assert b"<DeleteMarker>" in body

        assert (await req(
            "PUT", "/vb?lifecycle",
            b"<LifecycleConfiguration><Rule><ID>r1</ID>"
            b"<Prefix>tmp/</Prefix><Expiration><Days>7</Days>"
            b"</Expiration></Rule></LifecycleConfiguration>"))[0] == 200
        st, _, body = await req("GET", "/vb?lifecycle")
        assert st == 200 and b"<Days>7.0</Days>" in body
        await fe.stop()
        await c.stop()

    run(t())


def test_rgw_lc_mgr_module_drives_expiration(tmp_path):
    """The rgw_lc mgr module (background LC on the mgr tick) runs the
    same pass via its admin command."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b")
        await rgw.put_object("b", "tmp/x", b"data")
        await rgw.put_lifecycle("b", [
            {"id": "r", "prefix": "tmp/", "days": 0}])
        await asyncio.sleep(0.002)  # make mtime strictly < cutoff

        from ceph_tpu_torch.utils.admin import admin_command

        await c.mgr.start_admin(str(tmp_path / "mgr.sock"))
        rep = await admin_command(c.mgr.admin.path, "lc process",
                                  pool=1)
        assert rep["b"]["expired_current"] == 1
        ents, _ = await rgw.list_objects("b")
        assert ents == []
        await c.stop()

    run(t())


def test_null_version_preserved_and_addressable():
    """S3 null-version semantics: an object written BEFORE versioning
    was enabled stays addressable as versionId=null, survives versioned
    overwrites and delete markers, and its data/row clean up when
    deleted by id."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b")
        await rgw.put_object("b", "k", b"pre-versioning")
        await rgw.put_bucket_versioning("b", "Enabled")

        # addressable as null while still current
        data, meta = await rgw.get_object("b", "k", version_id="null")
        assert data == b"pre-versioning"

        # a versioned overwrite preserves it as the null version
        _, v1 = await rgw.put_object("b", "k", b"v1-data")
        assert (await rgw.get_object("b", "k"))[0] == b"v1-data"
        data, _ = await rgw.get_object("b", "k", version_id="null")
        assert data == b"pre-versioning"
        vers = await rgw.list_object_versions("b")
        assert [e["version_id"] for e in vers] == [v1, "null"]

        # HEAD on a marker-current key 404s like GET
        await rgw.delete_object("b", "k")
        with pytest.raises(RGWError, match="NoSuchKey"):
            await rgw.head_object("b", "k")

        # deleting the versioned v1 and the marker promotes null back
        marker_vid = next(
            e["version_id"]
            for e in await rgw.list_object_versions("b")
            if e["delete_marker"])
        await rgw.delete_object("b", "k", version_id=v1)
        await rgw.delete_object("b", "k", version_id=marker_vid)
        data, meta = await rgw.get_object("b", "k")
        assert data == b"pre-versioning"

        # deleting the null version by id removes it for good
        await rgw.delete_object("b", "k", version_id="null")
        with pytest.raises(RGWError):
            await rgw.get_object("b", "k")
        assert await rgw.list_object_versions("b") == []
        # keys with NUL are rejected (version-row namespace guard)
        with pytest.raises(RGWError, match="InvalidObjectName"):
            await rgw.put_object("b", "k\x00v123", b"x")
        await c.stop()

    run(t())


def test_versioned_multipart_complete():
    """Multipart complete on a versioning-enabled bucket produces a
    real version (with id) and reclaims the part objects."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b")
        await rgw.put_bucket_versioning("b", "Enabled")
        up = await rgw.initiate_multipart("b", "big")
        await rgw.upload_part("b", "big", up, 1, b"A" * 1000)
        await rgw.upload_part("b", "big", up, 2, b"B" * 1000)
        etag, vid = await rgw.complete_multipart("b", "big", up, [1, 2])
        assert etag.endswith("-2") and vid
        data, meta = await rgw.get_object("b", "big")
        assert data == b"A" * 1000 + b"B" * 1000
        assert meta["version_id"] == vid
        await c.stop()

    run(t())


def test_presigned_urls():
    """Query-string sigv4 (presigned URL role): GET/PUT with no auth
    headers, expiry enforcement, tamper rejection."""
    async def t():
        import urllib.parse as up

        from ceph_tpu_torch.services.rgw import presign_url

        c, rgw = await make()
        await rgw.create_bucket("pub")
        await rgw.put_object("pub", "doc.txt", b"shared content")
        fe = S3Frontend(rgw, users={"AK": "s3cr3t"})
        host, port = await fe.start()

        def target(url):
            p = up.urlsplit(url)
            return p.path + "?" + p.query

        # un-authenticated requests are still refused
        st, _h, _b = await http(host, port, "GET", "/pub/doc.txt")
        assert st == 403
        # presigned GET: no headers beyond host
        url = presign_url("GET", "/pub/doc.txt", host, "AK", "s3cr3t")
        st, _h, body = await http(host, port, "GET", target(url))
        assert st == 200 and body == b"shared content"
        # presigned PUT uploads without credentials in the request
        url = presign_url("PUT", "/pub/up.bin", host, "AK", "s3cr3t")
        st, _h, _b = await http(host, port, "PUT", target(url),
                                body=b"uploaded")
        assert st == 200
        got, _m = await rgw.get_object("pub", "up.bin")
        assert got == b"uploaded"
        # expired link: signed long ago with a short window
        import time as _t

        old = _t.strftime("%Y%m%dT%H%M%SZ", _t.gmtime(_t.time() - 600))
        url = presign_url("GET", "/pub/doc.txt", host, "AK", "s3cr3t",
                          expires=60, amz_date=old)
        st, _h, _b = await http(host, port, "GET", target(url))
        assert st == 403
        # tampering with the signed expiry breaks the signature
        url = presign_url("GET", "/pub/doc.txt", host, "AK", "s3cr3t",
                          expires=60, amz_date=old)
        st, _h, _b = await http(host, port, "GET",
                                target(url).replace(
                                    "X-Amz-Expires=60",
                                    "X-Amz-Expires=6000"))
        assert st == 403
        # a presigned GET cannot be replayed as a DELETE
        url = presign_url("GET", "/pub/doc.txt", host, "AK", "s3cr3t")
        st, _h, _b = await http(host, port, "DELETE", target(url))
        assert st == 403
        await fe.stop()
        await c.stop()

    run(t())


def test_object_and_bucket_tagging():
    """S3 tag sets (rgw_tag_s3 role): per-object tags ride the index
    entry, survive copies and version promotion, and bucket tags live
    on the bucket attr."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b")
        await rgw.put_object("b", "k", b"v",
                             tags={"env": "prod", "team": "storage"})
        assert await rgw.get_object_tagging("b", "k") == {
            "env": "prod", "team": "storage"}
        # replace + delete
        await rgw.put_object_tagging("b", "k", {"env": "dev"})
        assert await rgw.get_object_tagging("b", "k") == {"env": "dev"}
        await rgw.delete_object_tagging("b", "k")
        assert await rgw.get_object_tagging("b", "k") == {}
        # limits
        with pytest.raises(RGWError) as ei:
            await rgw.put_object_tagging(
                "b", "k", {f"t{i}": "x" for i in range(11)})
        assert ei.value.code == "InvalidTag"
        with pytest.raises(RGWError) as ei:
            await rgw.put_object_tagging("b", "k", {"k" * 129: "v"})
        assert ei.value.code == "InvalidTag"
        # copy carries the tag set (S3 default COPY directive)
        await rgw.put_object_tagging("b", "k", {"a": "1"})
        await rgw.copy_object("b", "k", "b", "k2")
        assert await rgw.get_object_tagging("b", "k2") == {"a": "1"}
        # bucket tags
        await rgw.put_bucket_tagging("b", {"owner": "me"})
        assert await rgw.get_bucket_tagging("b") == {"owner": "me"}
        await rgw.delete_bucket_tagging("b")
        assert await rgw.get_bucket_tagging("b") == {}
        await c.stop()

    run(t())


def test_tagging_versioned_rows():
    """Tagging a NAMED version updates that row; the current pointer
    follows only when the named version is current."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b")
        await rgw.put_bucket_versioning("b", "Enabled")
        _, v1 = await rgw.put_object("b", "k", b"one")
        _, v2 = await rgw.put_object("b", "k", b"two")
        await rgw.put_object_tagging("b", "k", {"gen": "1"},
                                     version_id=v1)
        await rgw.put_object_tagging("b", "k", {"gen": "2"},
                                     version_id=v2)
        assert await rgw.get_object_tagging("b", "k",
                                            version_id=v1) == {"gen": "1"}
        # current (= v2) reflects v2's tags, not v1's
        assert await rgw.get_object_tagging("b", "k") == {"gen": "2"}
        # deleting current promotes v1 WITH its tags intact
        await rgw.delete_object("b", "k", version_id=v2)
        assert await rgw.get_object_tagging("b", "k") == {"gen": "1"}
        await c.stop()

    run(t())


def test_tagging_and_cors_http_routes():
    """?tagging / ?cors subresources + OPTIONS preflight over a real
    socket (s3-tests CORS cases, shrunk)."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("web")
        fe = S3Frontend(rgw)
        host, port = await fe.start()
        try:
            # object tagging via x-amz-tagging header on PUT
            st, rh, _ = await http(
                host, port, "PUT", "/web/o", b"data",
                headers={"x-amz-tagging": "k1=v1&k2=v2"})
            assert st == 200
            st, _, body = await http(host, port, "GET",
                                     "/web/o?tagging")
            assert st == 200 and b"<Key>k1</Key>" in body \
                and b"<Value>v2</Value>" in body
            # PUT ?tagging replaces; DELETE clears
            xml = (b"<Tagging><TagSet><Tag><Key>env</Key>"
                   b"<Value>prod</Value></Tag></TagSet></Tagging>")
            st, _, _ = await http(host, port, "PUT", "/web/o?tagging",
                                  xml)
            assert st == 200
            st, _, body = await http(host, port, "GET",
                                     "/web/o?tagging")
            assert b"env" in body and b"k1" not in body
            st, _, _ = await http(host, port, "DELETE",
                                  "/web/o?tagging")
            assert st == 204
            # GET object advertises the tag count
            st, rh, _ = await http(host, port, "PUT", "/web/o2", b"x",
                                   headers={"x-amz-tagging": "a=1"})
            st, rh, _ = await http(host, port, "GET", "/web/o2")
            assert rh.get("x-amz-tagging-count") == "1"
            # bucket tagging
            st, _, _ = await http(
                host, port, "PUT", "/web?tagging",
                b"<Tagging><TagSet><Tag><Key>t</Key><Value>b</Value>"
                b"</Tag></TagSet></Tagging>")
            assert st == 204
            st, _, body = await http(host, port, "GET",
                                     "/web?tagging")
            assert st == 200 and b"<Key>t</Key>" in body
            # CORS config
            cors = (b"<CORSConfiguration><CORSRule>"
                    b"<AllowedOrigin>https://*.example.com"
                    b"</AllowedOrigin>"
                    b"<AllowedMethod>GET</AllowedMethod>"
                    b"<AllowedHeader>*</AllowedHeader>"
                    b"<ExposeHeader>etag</ExposeHeader>"
                    b"<MaxAgeSeconds>300</MaxAgeSeconds>"
                    b"</CORSRule></CORSConfiguration>")
            st, _, _ = await http(host, port, "PUT", "/web?cors", cors)
            assert st == 200
            st, _, body = await http(host, port, "GET", "/web?cors")
            assert st == 200 and b"AllowedOrigin" in body
            # preflight: matching origin+method allowed
            st, rh, _ = await http(
                host, port, "OPTIONS", "/web/o",
                headers={"origin": "https://app.example.com",
                         "access-control-request-method": "GET",
                         "access-control-request-headers":
                             "x-custom"})
            assert st == 200
            assert rh["access-control-allow-origin"] \
                == "https://app.example.com"
            assert rh["access-control-max-age"] == "300"
            # preflight: method not allowed -> 403
            st, _, _ = await http(
                host, port, "OPTIONS", "/web/o",
                headers={"origin": "https://app.example.com",
                         "access-control-request-method": "DELETE"})
            assert st == 403
            # preflight: origin not allowed -> 403
            st, _, _ = await http(
                host, port, "OPTIONS", "/web/o",
                headers={"origin": "https://evil.com",
                         "access-control-request-method": "GET"})
            assert st == 403
            # simple cross-origin GET gets the allow + expose headers
            st, rh, _ = await http(
                host, port, "GET", "/web/o2",
                headers={"origin": "https://app.example.com"})
            assert rh.get("access-control-allow-origin") \
                == "https://app.example.com"
            assert rh.get("access-control-expose-headers") == "etag"
            # DELETE ?cors; preflight then refuses
            st, _, _ = await http(host, port, "DELETE", "/web?cors")
            assert st == 204
            st, _, body = await http(host, port, "GET", "/web?cors")
            assert st == 404
            st, _, _ = await http(
                host, port, "OPTIONS", "/web/o",
                headers={"origin": "https://app.example.com",
                         "access-control-request-method": "GET"})
            assert st == 403
        finally:
            await fe.stop()
            await c.stop()

    run(t())


def test_cors_cache_invalidated_after_store_write():
    """Regression (race): a preflight that re-reads the OLD rules
    while a cors PUT is mid-write must not leave them cached past the
    write — invalidation happens AFTER the store write completes, so
    the racing entry is popped and the next preflight re-reads."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("web")
        fe = S3Frontend(rgw)
        host, port = await fe.start()
        try:
            cors = (b"<CORSConfiguration><CORSRule>"
                    b"<AllowedOrigin>https://a.example</AllowedOrigin>"
                    b"<AllowedMethod>GET</AllowedMethod>"
                    b"</CORSRule></CORSConfiguration>")
            st, _, _ = await http(host, port, "PUT", "/web?cors", cors)
            assert st == 200
            # the racing preflight: re-caches the CURRENT (soon stale)
            # rules exactly between the route's cache handling and the
            # store write finishing
            real_put = rgw.put_bucket_cors
            stale = await rgw.get_bucket_cors("web")

            async def racing_put(bucket, rules):
                fe._cors_cache[bucket] = (1e18, stale)
                await real_put(bucket, rules)

            rgw.put_bucket_cors = racing_put
            cors2 = cors.replace(b"https://a.example",
                                 b"https://b.example")
            st, _, _ = await http(host, port, "PUT", "/web?cors",
                                  cors2)
            assert st == 200
            rgw.put_bucket_cors = real_put
            # the post-write pop evicted the racing entry: preflight
            # serves the NEW origin, not the stale cache
            st, rh, _ = await http(
                host, port, "OPTIONS", "/web/o",
                headers={"origin": "https://b.example",
                         "access-control-request-method": "GET"})
            assert st == 200
            assert rh.get("access-control-allow-origin") \
                == "https://b.example"
            # mirrored interleaving: a preflight READS the old rules,
            # suspends, the PUT completes (pop + generation bump), the
            # preflight resumes — it must NOT cache its stale copy
            real_get = rgw.get_bucket_cors
            hold = asyncio.Event()

            async def slow_get(bucket):
                rules = await real_get(bucket)
                await hold.wait()
                return rules

            rgw.get_bucket_cors = slow_get
            fe._cors_cache.pop("web", None)
            reader = asyncio.create_task(fe._cors_rules("web"))
            await asyncio.sleep(0.05)  # reader holds the OLD rules
            rgw.get_bucket_cors = real_get
            cors3 = cors.replace(b"https://a.example",
                                 b"https://c.example")
            st, _, _ = await http(host, port, "PUT", "/web?cors",
                                  cors3)
            assert st == 200
            hold.set()
            await reader  # returns stale rules to ITS caller only
            st, rh, _ = await http(
                host, port, "OPTIONS", "/web/o",
                headers={"origin": "https://c.example",
                         "access-control-request-method": "GET"})
            assert st == 200
            assert rh.get("access-control-allow-origin") \
                == "https://c.example"
        finally:
            await fe.stop()
            await c.stop()

    run(t())
