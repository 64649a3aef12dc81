"""Swift REST dialect over the same RGW core (the rgw_rest_swift.h /
rgw_swift_auth.cc roles).

Same stance as the reference: S3 buckets and Swift containers are ONE
namespace over the cls-served bucket index — both dialects are thin
REST translations of the shared RGWLite operations, so an object PUT
through S3 lists through Swift and vice versa.

Covered surface (the load-bearing subset of the Swift API):
- TempAuth handshake: ``GET /auth/v1.0`` with X-Auth-User/X-Auth-Key
  mints an X-Auth-Token + X-Storage-Url (rgw_swift_auth.cc
  RGWTempURLAuthEngine/tempauth role); every /v1 request must carry
  the token.
- account: GET lists containers (text or ?format=json with
  count/bytes), HEAD returns X-Account-{Container,Object}-Count /
  X-Account-Bytes-Used.
- container: PUT create (201 / 202 when it exists — Swift semantics),
  DELETE (409 while non-empty), GET listing (prefix/marker/limit,
  text or JSON rows name/bytes/hash/last_modified/content_type),
  HEAD stats.
- object: PUT (ETag reply; Content-Type + X-Object-Meta-* persisted
  in the index entry), GET/HEAD (meta replayed as headers), DELETE,
  and server-side COPY (``COPY`` verb or PUT with X-Copy-From) with
  fresh-metadata override, mirroring rgw_op.cc's Swift copy paths.

Errors are text/plain with Swift status codes (401/404/409), not S3
XML.

ceph_tpu_torch's own copy of ``ceph_tpu/services/rgw_swift.py``.
"""
from __future__ import annotations

import asyncio
import json
import secrets
import time
import urllib.parse

from .rgw import HttpFrontend, RGWError, RGWLite

META_PREFIX = "x-object-meta-"
CONTAINER_META_PREFIX = "x-container-meta-"


class SwiftFrontend(HttpFrontend):
    def __init__(self, rgw: RGWLite,
                 users: dict[str, str] | None = None,
                 account: str = "test"):
        self.rgw = rgw
        #: "acct:user" -> key (the tempauth user table role); empty
        #: table = open frontend (DummyAuth tier, like S3Frontend)
        self.users = users or {}
        self.account = account
        #: token -> (user, expiry)
        self.tokens: dict[str, tuple[str, float]] = {}
        self.token_ttl = 3600.0
        self._server = None
        self.port = 0

    # ------------------------------------------------------------- auth

    def _mint_token(self, user: str) -> str:
        now = time.time()
        # sweep expired grants: clients re-auth rather than re-present
        # a dead token, so lazy per-token cleanup never fires and the
        # table would otherwise grow one entry per handshake forever
        for t in [t for t, (_u, exp) in self.tokens.items()
                  if now > exp]:
            del self.tokens[t]
        tok = "AUTH_tk" + secrets.token_hex(16)
        self.tokens[tok] = (user, now + self.token_ttl)
        return tok

    def _check_token(self, headers: dict) -> bool:
        if not self.users:
            return True
        tok = headers.get("x-auth-token", "")
        ent = self.tokens.get(tok)
        if ent is None:
            return False
        if time.time() > ent[1]:
            del self.tokens[tok]
            return False
        return True

    # ----------------------------------------------------------- routing

    async def _handle(self, method: str, target: str, headers: dict,
                      body: bytes) -> tuple[int, dict, bytes]:
        parsed = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(parsed.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))

        if path.rstrip("/") == "/auth/v1.0":
            user = headers.get("x-auth-user", "")
            key = headers.get("x-auth-key", "")
            if self.users and self.users.get(user) != key:
                return 401, {}, b"Unauthorized\n"
            tok = self._mint_token(user)
            url = f"http://127.0.0.1:{self.port}/v1/AUTH_{self.account}"
            return 200, {"x-auth-token": tok, "x-storage-token": tok,
                         "x-storage-url": url}, b""

        if not path.startswith("/v1/"):
            return 404, {}, b"Not Found\n"
        if not self._check_token(headers):
            return 401, {}, b"Unauthorized\n"
        parts = path[len("/v1/"):].split("/", 2)
        # parts[0] = AUTH_<account>; container/object follow
        container = parts[1] if len(parts) > 1 and parts[1] else None
        obj = parts[2] if len(parts) > 2 and parts[2] else None
        try:
            if container is None:
                return await self._account(method, query)
            if obj is None:
                return await self._container(method, container, query,
                                             headers)
            return await self._object(method, container, obj, headers,
                                      body)
        except RGWError as e:
            return e.status, {}, f"{e.code}\n".encode()

    # ----------------------------------------------------------- account

    async def _account(self, method: str, query: dict):
        names = await self.rgw.list_buckets()
        if method == "HEAD":
            stats = await asyncio.gather(
                *(self.rgw.bucket_stats(b) for b in names))
            return 204, {
                "x-account-container-count": str(len(names)),
                "x-account-object-count":
                    str(sum(s["count"] for s in stats)),
                "x-account-bytes-used":
                    str(sum(s["bytes"] for s in stats)),
            }, b""
        if method != "GET":
            return 405, {}, b"Method Not Allowed\n"
        if query.get("format") == "json":
            stats = await asyncio.gather(
                *(self.rgw.bucket_stats(b) for b in names))
            rows = [{"name": b, "count": s["count"],
                     "bytes": s["bytes"]}
                    for b, s in zip(names, stats)]
            return 200, {"content-type": "application/json"}, \
                json.dumps(rows).encode()
        return 200, {"content-type": "text/plain"}, \
            ("".join(n + "\n" for n in names)).encode()

    # --------------------------------------------------------- container

    async def _container(self, method: str, container: str,
                         query: dict, headers: dict):
        if method == "PUT":
            try:
                await self.rgw.create_bucket(container)
                return 201, {}, b""
            except RGWError as e:
                if e.code == "BucketAlreadyExists":
                    return 202, {}, b""  # Swift: idempotent accept
                raise
        if method == "DELETE":
            await self.rgw.delete_bucket(container)
            return 204, {}, b""
        if method == "HEAD":
            s = await self.rgw.bucket_stats(container)
            return 204, {"x-container-object-count": str(s["count"]),
                         "x-container-bytes-used": str(s["bytes"])}, b""
        if method != "GET":
            return 405, {}, b"Method Not Allowed\n"
        try:
            limit = int(query.get("limit", "10000"))
        except ValueError:
            return 400, {}, b"InvalidLimit\n"
        entries, _ = await self.rgw.list_objects(
            container, prefix=query.get("prefix", ""),
            marker=query.get("marker", ""), max_keys=limit)
        if query.get("format") == "json":
            rows = [{
                "name": e["key"],
                "bytes": e["size"],
                "hash": e["etag"],
                "content_type": (e["content_type"]
                                 or "application/octet-stream"),
                "last_modified": time.strftime(
                    "%Y-%m-%dT%H:%M:%S",
                    time.gmtime(e["mtime"])),
            } for e in entries]
            return 200, {"content-type": "application/json"}, \
                json.dumps(rows).encode()
        return 200, {"content-type": "text/plain"}, \
            ("".join(e["key"] + "\n" for e in entries)).encode()

    # ------------------------------------------------------------ object

    @staticmethod
    def _obj_meta(headers: dict) -> dict[str, str]:
        return {k[len(META_PREFIX):]: v for k, v in headers.items()
                if k.startswith(META_PREFIX)}

    async def _object(self, method: str, container: str, obj: str,
                      headers: dict, body: bytes):
        if method == "PUT":
            src = headers.get("x-copy-from", "")
            if src:
                sb, _, sk = src.lstrip("/").partition("/")
                etag = await self.rgw.copy_object(
                    sb, sk, container, obj,
                    meta=self._obj_meta(headers) or None)
                if isinstance(etag, tuple):
                    etag = etag[0]
                return 201, {"etag": etag}, b""
            etag = await self.rgw.put_object(
                container, obj, body,
                content_type=headers.get(
                    "content-type", "application/octet-stream"),
                meta=self._obj_meta(headers))
            if isinstance(etag, tuple):
                etag = etag[0]
            return 201, {"etag": etag}, b""
        if method == "COPY":
            dst = headers.get("destination", "")
            db, _, dk = dst.lstrip("/").partition("/")
            if not db or not dk:
                return 400, {}, b"Bad Destination\n"
            await self.rgw.copy_object(
                container, obj, db, dk,
                meta=self._obj_meta(headers) or None)
            return 201, {}, b""
        if method == "DELETE":
            await self.rgw.delete_object(container, obj)
            return 204, {}, b""
        if method not in ("GET", "HEAD"):
            return 405, {}, b"Method Not Allowed\n"
        if method == "HEAD":
            m = await self.rgw.head_object(container, obj)
            data = b""
        else:
            data, m = await self.rgw.get_object(container, obj)
        rh = {
            "etag": m["etag"],
            "content-type": (m["content_type"]
                             or "application/octet-stream"),
            "x-timestamp": str(m["mtime"]),
            "content-length": str(m["size"]),
        }
        for k, v in m["meta"].items():
            rh[META_PREFIX + k] = v
        return 200, rh, data
