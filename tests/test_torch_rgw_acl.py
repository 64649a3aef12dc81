"""The cases of ``tests/test_rgw_acl.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

S3 ACL tests: the ownership/grant model (rgw_acl.h role) and its
enforcement at the frontend (rgw_op.cc verify_*_permission role)."""
import asyncio

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.rgw import RGWLite, S3Frontend
from ceph_tpu_torch.services.rgw_acl import ALL_USERS, AUTH_USERS, Acl

from test_torch_rgw import _signed_headers, http
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


# ------------------------------------------------------------ unit model


def test_acl_model():
    a = Acl("alice", [("bob", "READ")])
    assert a.allows("alice", "WRITE")          # owner: everything
    assert a.allows("alice", "WRITE_ACP")
    assert a.allows("bob", "READ")
    assert not a.allows("bob", "WRITE")
    assert not a.allows("carol", "READ")
    assert not a.allows(None, "READ")          # anonymous
    # groups
    pub = Acl("alice", [(ALL_USERS, "READ")])
    assert pub.allows(None, "READ") and pub.allows("bob", "READ")
    auth = Acl("alice", [(AUTH_USERS, "READ")])
    assert auth.allows("bob", "READ") and not auth.allows(None, "READ")
    # FULL_CONTROL grant implies every permission
    fc = Acl("alice", [("bob", "FULL_CONTROL")])
    for p in ("READ", "WRITE", "READ_ACP", "WRITE_ACP"):
        assert fc.allows("bob", p)
    # unset policy = legacy data: any authenticated principal, never
    # anonymous (the pre-ACL frontend contract)
    unset = Acl("", [])
    assert unset.allows("anyone", "WRITE")
    assert not unset.allows(None, "READ")


def test_acl_coding():
    a = Acl("alice", [("bob", "READ"), (ALL_USERS, "READ"),
                      ("carol", "FULL_CONTROL")])
    assert Acl.parse("alice", a.dump()).grants == a.grants
    b = Acl.from_xml(a.to_xml(), "alice")
    assert b.owner == "alice" and b.grants == a.grants
    # the implicit-owner elision keys on the PERSISTED owner: a body
    # declaring a different owner cannot get its real grant dropped
    spoof = Acl("bob", [("bob", "FULL_CONTROL")])
    parsed = Acl.from_xml(spoof.to_xml(), "alice")
    assert ("bob", "FULL_CONTROL") in parsed.grants
    assert parsed.owner == "alice"
    # canned expansion
    assert Acl.canned("o", "private").grants == []
    assert Acl.canned("o", "public-read").grants == [(ALL_USERS, "READ")]
    assert (ALL_USERS, "WRITE") in Acl.canned(
        "o", "public-read-write").grants
    assert Acl.canned("o", "authenticated-read").grants == \
        [(AUTH_USERS, "READ")]


# ------------------------------------------------------- enforcement


USERS = {"alice": "sk-alice", "bob": "sk-bob"}


async def sreq(host, port, user, method, path, body=b"", extra=None,
               query=""):
    """Signed request through the raw-socket helper."""
    h = _signed_headers(method, path, query, body, host, user,
                        USERS[user])
    h.update(extra or {})
    target = path + (f"?{query}" if query else "")
    return await http(host, port, method, target, body=body, headers=h)


def test_acl_enforcement():
    """Multi-user frontend: ownership gates access; canned ACLs open
    it selectively; per-object ownership holds inside a shared
    bucket; ?acl GET/PUT round-trips grants."""
    async def t():
        c, rgw = await make()
        fe = S3Frontend(rgw, users=dict(USERS))
        host, port = await fe.start()

        # alice creates a private bucket and an object
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/priv")
        assert st == 200
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/priv/k",
                                b"secret")
        assert st == 200
        owner, grants = await rgw.get_bucket_acl("priv")
        assert owner == "alice" and grants == ""

        # bob: no list, no read, no write, no delete-bucket
        st, _h, _b = await sreq(host, port, "bob", "GET", "/priv")
        assert st == 403
        st, _h, _b = await sreq(host, port, "bob", "GET", "/priv/k")
        assert st == 403
        st, _h, _b = await sreq(host, port, "bob", "PUT", "/priv/x",
                                b"nope")
        assert st == 403
        st, _h, _b = await sreq(host, port, "bob", "DELETE", "/priv")
        assert st == 403
        # anonymous: nothing
        st, _h, _b = await http(host, port, "GET", "/priv/k")
        assert st == 403
        st, _h, _b = await http(host, port, "PUT", "/anon-b")
        assert st == 403  # anonymous principals never own buckets

        # canned object ACLs: public-read / authenticated-read
        st, _h, _b = await sreq(host, port, "alice", "PUT",
                                "/priv/pub", b"open",
                                extra={"x-amz-acl": "public-read"})
        assert st == 200
        st, _h, b = await http(host, port, "GET", "/priv/pub")
        assert st == 200 and b == b"open"
        st, _h, _b = await sreq(host, port, "alice", "PUT",
                                "/priv/auth", b"half-open",
                                extra={"x-amz-acl":
                                       "authenticated-read"})
        assert st == 200
        st, _h, b = await sreq(host, port, "bob", "GET", "/priv/auth")
        assert st == 200 and b == b"half-open"
        st, _h, _b = await http(host, port, "GET", "/priv/auth")
        assert st == 403

        # shared bucket: bob may write, but his objects are HIS —
        # the bucket owner holds no implicit read on them (S3)
        st, _h, _b = await sreq(
            host, port, "alice", "PUT", "/shared",
            extra={"x-amz-acl": "public-read-write"})
        assert st == 200
        st, _h, _b = await sreq(host, port, "bob", "PUT", "/shared/b1",
                                b"bobs data")
        assert st == 200
        st, _h, b = await sreq(host, port, "bob", "GET", "/shared/b1")
        assert st == 200 and b == b"bobs data"
        st, _h, _b = await sreq(host, port, "alice", "GET",
                                "/shared/b1")
        assert st == 403
        owner, _g = await rgw.get_object_acl("shared", "b1")
        assert owner == "bob"

        # ?acl round-trip: bob grants alice READ via an XML PUT
        pol = Acl("bob", [("alice", "READ")])
        st, _h, _b = await sreq(host, port, "bob", "PUT", "/shared/b1",
                                pol.to_xml(), query="acl")
        assert st == 200
        st, _h, b = await sreq(host, port, "bob", "GET", "/shared/b1",
                               query="acl")
        assert st == 200 and b"alice" in b
        st, _h, b = await sreq(host, port, "alice", "GET",
                               "/shared/b1")
        assert st == 200 and b == b"bobs data"
        # alice still cannot rewrite bob's ACL (no WRITE_ACP)
        st, _h, _b = await sreq(host, port, "alice", "PUT",
                                "/shared/b1", pol.to_xml(),
                                query="acl")
        assert st == 403

        # deletion: bob CAN delete in the public-read-write bucket
        # (WRITE on bucket governs deletes); only alice may delete the
        # bucket itself
        st, _h, _b = await sreq(host, port, "bob", "DELETE",
                                "/shared/b1")
        assert st == 204
        st, _h, _b = await sreq(host, port, "bob", "DELETE", "/shared")
        assert st == 403
        st, _h, _b = await sreq(host, port, "alice", "DELETE",
                                "/shared")
        assert st == 204

        await fe.stop()
        await c.stop()

    run(t())


def test_acl_namespaced_xml():
    """Real SDK AccessControlPolicy bodies carry the S3 default xmlns;
    parsing must match on local names or a PUT ?acl silently wipes
    every grant."""
    body = (b'<AccessControlPolicy '
            b'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            b'<Owner><ID>alice</ID></Owner><AccessControlList>'
            b'<Grant><Grantee><ID>bob</ID></Grantee>'
            b'<Permission>READ</Permission></Grant>'
            b'<Grant><Grantee>'
            b'<URI>http://acs.amazonaws.com/groups/global/AllUsers'
            b'</URI></Grantee><Permission>READ</Permission></Grant>'
            b'</AccessControlList></AccessControlPolicy>')
    a = Acl.from_xml(body)
    assert a.owner == "alice"
    assert a.grants == [("bob", "READ"), (ALL_USERS, "READ")]


def test_acl_listing_and_config_privacy():
    """Anonymous clients cannot enumerate buckets; each principal's
    listing shows only its own buckets; bucket config (versioning)
    is unreadable without READ."""
    async def t():
        c, rgw = await make()
        fe = S3Frontend(rgw, users=dict(USERS))
        host, port = await fe.start()
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/a-b")
        assert st == 200
        st, _h, _b = await sreq(host, port, "bob", "PUT", "/b-b")
        assert st == 200
        # anonymous: no listing, no config reads
        st, _h, _b = await http(host, port, "GET", "/")
        assert st == 403
        st, _h, _b = await http(host, port, "GET", "/a-b?versioning")
        assert st == 403
        st, _h, _b = await http(host, port, "GET", "/a-b?lifecycle")
        assert st == 403
        # per-account listing
        st, _h, b = await sreq(host, port, "alice", "GET", "/")
        assert st == 200 and b"a-b" in b and b"b-b" not in b
        st, _h, b = await sreq(host, port, "bob", "GET", "/")
        assert st == 200 and b"b-b" in b and b"a-b" not in b
        # bob cannot read alice's versioning config either
        st, _h, _b = await sreq(host, port, "bob", "GET", "/a-b",
                                query="versioning")
        assert st == 403
        await fe.stop()
        await c.stop()

    run(t())


def test_object_acl_versioned_no_clobber():
    """PUT ?acl naming a HISTORICAL version must update only that
    version's row — never resurrect its data as the bucket-current
    entry."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b", owner="alice")
        await rgw.put_bucket_versioning("b", "Enabled")
        _e1, v1 = await rgw.put_object("b", "k", b"one",
                                       owner="alice")
        _e2, v2 = await rgw.put_object("b", "k", b"two",
                                       owner="alice")
        await rgw.put_object_acl("b", "k", "alice", "bob:READ",
                                 version_id=v1)
        # current still serves v2's data
        data, meta = await rgw.get_object("b", "k")
        assert data == b"two" and meta["version_id"] == v2
        # v1's row carries the grant; v2's does not
        o1, g1 = await rgw.get_object_acl("b", "k", version_id=v1)
        assert g1 == "bob:READ"
        _o2, g2 = await rgw.get_object_acl("b", "k", version_id=v2)
        assert g2 == ""
        # naming the CURRENT version does update the pointer
        await rgw.put_object_acl("b", "k", "alice", "bob:READ",
                                 version_id=v2)
        _oc, gc = await rgw.get_object_acl("b", "k")
        assert gc == "bob:READ"
        data, _m = await rgw.get_object("b", "k")
        assert data == b"two"
        await c.stop()

    run(t())


def test_object_acl_null_version_keeps_current():
    """PUT ?acl with versionId=null on a still-plain object (the
    standard S3 spelling for pre-versioning objects) must keep the
    current pointer's vid="" — not rewrite it as "null", which would
     404 later null reads and break null preservation."""
    async def t():
        c, rgw = await make()
        await rgw.create_bucket("b", owner="alice")
        await rgw.put_object("b", "k", b"plain", owner="alice")
        await rgw.put_object_acl("b", "k", "alice", "bob:READ",
                                 version_id="null")
        # the current entry still reads as the plain object
        data, meta = await rgw.get_object("b", "k")
        assert data == b"plain" and meta["version_id"] == ""
        assert meta["acl"] == "bob:READ"
        # null addressing still resolves
        data, _m = await rgw.get_object("b", "k", version_id="null")
        assert data == b"plain"
        # and a later versioned write still preserves the null version
        await rgw.put_bucket_versioning("b", "Enabled")
        await rgw.put_object("b", "k", b"v2", owner="alice")
        vers = await rgw.list_object_versions("b")
        assert any(v["version_id"] == "null" for v in vers)
        data, _m = await rgw.get_object("b", "k", version_id="null")
        assert data == b"plain"
        await c.stop()

    run(t())


def test_acl_malformed_bodies():
    """Unparseable or invalid ?acl bodies are a 400 MalformedACLError
    — not a dropped connection, not a silently thinned grant list."""
    async def t():
        c, rgw = await make()
        fe = S3Frontend(rgw, users=dict(USERS))
        host, port = await fe.start()
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/b")
        assert st == 200
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/b/k",
                                b"data")
        assert st == 200
        # not XML at all
        st, _h, b = await sreq(host, port, "alice", "PUT", "/b",
                               b"not-xml", query="acl")
        assert st == 400 and b"MalformedACLError" in b
        # a typoed permission must not turn the policy private
        bad = (b"<AccessControlPolicy><Owner><ID>alice</ID></Owner>"
               b"<AccessControlList><Grant><Grantee><ID>bob</ID>"
               b"</Grantee><Permission>FULLCONTROL</Permission>"
               b"</Grant></AccessControlList></AccessControlPolicy>")
        st, _h, b = await sreq(host, port, "alice", "PUT", "/b/k",
                               bad, query="acl")
        assert st == 400 and b"MalformedACLError" in b
        await fe.stop()
        await c.stop()

    run(t())


def test_acl_existence_oracle_closed():
    """404-vs-403: a principal without READ (list) on the bucket gets
    AccessDenied for missing AND present keys alike, so absence leaks
    nothing."""
    async def t():
        c, rgw = await make()
        fe = S3Frontend(rgw, users=dict(USERS))
        host, port = await fe.start()
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/priv")
        assert st == 200
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/priv/k",
                                b"x")
        assert st == 200
        # bob and anonymous: same 403 whether the key exists or not
        for who in ("bob", None):
            for path in ("/priv/k", "/priv/nothere"):
                if who:
                    st, _h, _b = await sreq(host, port, who, "GET",
                                            path)
                else:
                    st, _h, _b = await http(host, port, "GET", path)
                assert st == 403, (who, path, st)
        # alice (owner, holds READ): real 404 for the missing key
        st, _h, _b = await sreq(host, port, "alice", "GET",
                                "/priv/nothere")
        assert st == 404
        await fe.stop()
        await c.stop()

    run(t())


def test_acl_bucket_config_gate():
    """Versioning/lifecycle config writes require FULL_CONTROL; reads
    stay open to any authenticated principal on an unset policy but
    respect ownership once set."""
    async def t():
        c, rgw = await make()
        fe = S3Frontend(rgw, users=dict(USERS))
        host, port = await fe.start()
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/b")
        assert st == 200
        body = (b"<VersioningConfiguration><Status>Enabled</Status>"
                b"</VersioningConfiguration>")
        st, _h, _b = await sreq(host, port, "bob", "PUT", "/b", body,
                                query="versioning")
        assert st == 403
        st, _h, _b = await sreq(host, port, "alice", "PUT", "/b", body,
                                query="versioning")
        assert st == 200
        assert await rgw.get_bucket_versioning("b") == "Enabled"
        await fe.stop()
        await c.stop()

    run(t())
