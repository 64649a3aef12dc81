"""The cases of ``tests/test_rgw_swift.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

Swift dialect over the shared RGW core (rgw_rest_swift role):
tempauth tokens, container/object CRUD with metadata, listings,
account stats, and S3<->Swift namespace unification."""
import asyncio
import json

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.rgw import RGWLite, S3Frontend
from ceph_tpu_torch.services.rgw_swift import SwiftFrontend

from test_torch_rgw import http
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make(users=None):
    c = TestCluster(n_osds=3, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rgw", size=2, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    rgw = RGWLite(c.client, 1)
    sw = SwiftFrontend(rgw, users=users)
    host, port = await sw.start()
    return c, rgw, sw, host, port


def test_tempauth_and_container_lifecycle():
    async def t():
        c, rgw, sw, host, port = await make(
            users={"test:tester": "testing"})
        # no token -> 401
        st, _, _ = await http(host, port, "GET", "/v1/AUTH_test")
        assert st == 401
        # wrong key -> 401
        st, _, _ = await http(host, port, "GET", "/auth/v1.0",
                              headers={"x-auth-user": "test:tester",
                                       "x-auth-key": "wrong"})
        assert st == 401
        st, hd, _ = await http(host, port, "GET", "/auth/v1.0",
                               headers={"x-auth-user": "test:tester",
                                        "x-auth-key": "testing"})
        assert st == 200 and hd["x-auth-token"].startswith("AUTH_tk")
        tok = {"x-auth-token": hd["x-auth-token"]}

        st, _, _ = await http(host, port, "PUT", "/v1/AUTH_test/box",
                              headers=tok)
        assert st == 201
        st, _, _ = await http(host, port, "PUT", "/v1/AUTH_test/box",
                              headers=tok)
        assert st == 202  # Swift: existing container accepted
        st, _, body = await http(host, port, "GET", "/v1/AUTH_test",
                                 headers=tok)
        assert st == 200 and body == b"box\n"
        st, _, _ = await http(host, port, "DELETE",
                              "/v1/AUTH_test/box", headers=tok)
        assert st == 204
        await sw.stop()
        await c.stop()

    run(t())


def test_object_crud_metadata_and_listing():
    async def t():
        c, rgw, sw, host, port = await make()
        await http(host, port, "PUT", "/v1/AUTH_test/media")
        st, hd, _ = await http(
            host, port, "PUT", "/v1/AUTH_test/media/pic.jpg",
            body=b"JPEGDATA" * 100,
            headers={"content-type": "image/jpeg",
                     "x-object-meta-camera": "tpu-cam",
                     "x-object-meta-iso": "400"})
        assert st == 201 and hd["etag"]
        st, hd, body = await http(host, port, "GET",
                                  "/v1/AUTH_test/media/pic.jpg")
        assert st == 200 and body == b"JPEGDATA" * 100
        assert hd["content-type"] == "image/jpeg"
        assert hd["x-object-meta-camera"] == "tpu-cam"
        st, hd, body = await http(host, port, "HEAD",
                                  "/v1/AUTH_test/media/pic.jpg")
        assert st == 200 and body == b""
        assert hd["content-length"] == str(800)
        assert hd["x-object-meta-iso"] == "400"

        await http(host, port, "PUT", "/v1/AUTH_test/media/a.txt",
                   body=b"aaa")
        st, _, body = await http(host, port, "GET",
                                 "/v1/AUTH_test/media?format=json")
        rows = json.loads(body)
        assert [r["name"] for r in rows] == ["a.txt", "pic.jpg"]
        assert rows[1]["bytes"] == 800
        assert rows[1]["content_type"] == "image/jpeg"
        st, _, body = await http(host, port, "GET",
                                 "/v1/AUTH_test/media?prefix=pic")
        assert body == b"pic.jpg\n"

        # container + account stats
        st, hd, _ = await http(host, port, "HEAD",
                               "/v1/AUTH_test/media")
        assert st == 204 and hd["x-container-object-count"] == "2"
        assert hd["x-container-bytes-used"] == str(803)
        st, hd, _ = await http(host, port, "HEAD", "/v1/AUTH_test")
        assert st == 204 and hd["x-account-object-count"] == "2"

        # non-empty container cannot be deleted
        st, _, _ = await http(host, port, "DELETE",
                              "/v1/AUTH_test/media")
        assert st == 409
        await sw.stop()
        await c.stop()

    run(t())


def test_copy_verb_and_x_copy_from():
    async def t():
        c, rgw, sw, host, port = await make()
        await http(host, port, "PUT", "/v1/AUTH_test/src")
        await http(host, port, "PUT", "/v1/AUTH_test/dst")
        await http(host, port, "PUT", "/v1/AUTH_test/src/orig",
                   body=b"payload",
                   headers={"x-object-meta-k": "v"})
        st, _, _ = await http(host, port, "COPY",
                              "/v1/AUTH_test/src/orig",
                              headers={"destination": "/dst/copy1"})
        assert st == 201
        st, hd, body = await http(host, port, "GET",
                                  "/v1/AUTH_test/dst/copy1")
        assert body == b"payload"
        assert hd["x-object-meta-k"] == "v"  # attrs carried over
        # PUT + X-Copy-From with replacement metadata
        st, _, _ = await http(host, port, "PUT",
                              "/v1/AUTH_test/dst/copy2",
                              headers={"x-copy-from": "/src/orig",
                                       "x-object-meta-k": "new"})
        assert st == 201
        _, hd, body = await http(host, port, "GET",
                                 "/v1/AUTH_test/dst/copy2")
        assert body == b"payload" and hd["x-object-meta-k"] == "new"
        st, _, _ = await http(host, port, "DELETE",
                              "/v1/AUTH_test/dst/copy1")
        assert st == 204
        st, _, _ = await http(host, port, "GET",
                              "/v1/AUTH_test/dst/copy1")
        assert st == 404
        await sw.stop()
        await c.stop()

    run(t())


def test_s3_and_swift_share_one_namespace():
    """The reference serves both dialects over one bucket index; an
    object PUT via S3 lists and reads through Swift."""
    async def t():
        c, rgw, sw, host, port = await make()
        s3 = S3Frontend(rgw)
        s3host, s3port = await s3.start()
        st, _, _ = await http(s3host, s3port, "PUT", "/shared")
        assert st == 200
        st, _, _ = await http(s3host, s3port, "PUT", "/shared/from-s3",
                              body=b"via s3")
        assert st == 200
        st, _, body = await http(host, port, "GET",
                                 "/v1/AUTH_test/shared")
        assert st == 200 and body == b"from-s3\n"
        st, _, body = await http(host, port, "GET",
                                 "/v1/AUTH_test/shared/from-s3")
        assert st == 200 and body == b"via s3"
        # and the other direction
        await http(host, port, "PUT", "/v1/AUTH_test/shared/from-sw",
                   body=b"via swift")
        st, _, body = await http(s3host, s3port, "GET",
                                 "/shared/from-sw")
        assert st == 200 and body == b"via swift"
        await s3.stop()
        await sw.stop()
        await c.stop()

    run(t())


def test_versioned_delete_preserves_promoted_metadata():
    """Deleting the current version promotes the previous one WITH its
    content-type and user metadata."""
    async def t():
        c, rgw, sw, host, port = await make()
        await rgw.create_bucket("vb")
        await rgw.put_bucket_versioning("vb", "Enabled")
        _, v1 = await rgw.put_object(
            "vb", "doc", b"one", content_type="text/plain",
            meta={"rev": "1"})
        _, v2 = await rgw.put_object(
            "vb", "doc", b"two", content_type="text/html",
            meta={"rev": "2"})
        await rgw.delete_object("vb", "doc", version_id=v2)
        m = await rgw.head_object("vb", "doc")
        assert m["content_type"] == "text/plain"
        assert m["meta"] == {"rev": "1"}
        _, hd, body = await http(host, port, "GET",
                                 "/v1/AUTH_test/vb/doc")
        assert body == b"one" and hd["x-object-meta-rev"] == "1"
        await sw.stop()
        await c.stop()

    run(t())


def test_bad_limit_returns_400():
    async def t():
        c, rgw, sw, host, port = await make()
        await http(host, port, "PUT", "/v1/AUTH_test/c1")
        st, _, body = await http(host, port, "GET",
                                 "/v1/AUTH_test/c1?limit=abc")
        assert st == 400 and body == b"InvalidLimit\n"
        # the keep-alive connection survives for the next request
        st, _, _ = await http(host, port, "GET", "/v1/AUTH_test/c1")
        assert st == 200
        await sw.stop()
        await c.stop()

    run(t())
