"""RGW bucket notifications (the src/rgw/rgw_notify + cls_2pc_queue
persistent-topic role).

The reference publishes S3 event records to topics (amqp/kafka/http
endpoints or RADOS-backed persistent queues) per bucket notification
configuration. This module is the persistent-queue shape, TPU-build
style: a topic is a RADOS queue object driven by the same atomic-seq
cls log that backs the multisite datalog; delivery is RELIABLE — the
event append rides the op path, so a failed queue write fails the op
the way the reference's persistent mode does (reliable-by-2pc there,
reliable-by-atomic-append here). Consumers tail the queue by marker
and ack (trim) what they processed — the pull-mode endpoint role.

Surface:
- ``create_topic`` / ``list_topics`` / ``delete_topic`` — topic
  registry in a root omap (RGWPubSub topic table role).
- ``put_bucket_notification(rgw, bucket, rules)`` — rules are
  [{"id", "topic", "events": ["s3:ObjectCreated:*", ...],
    "prefix": ""}] (PutBucketNotificationConfiguration role, filter
  subset: event-type globs + key prefix).
- ``TopicQueue(client, pool, topic).pull(marker)`` / ``ack(upto)`` —
  consumer side; events are S3 record dicts.

Emission happens inside RGWLite (put/delete/multipart-complete), which
calls back into this module lazily; event names follow the S3 set:
ObjectCreated:Put, ObjectCreated:CompleteMultipartUpload,
ObjectRemoved:Delete, ObjectRemoved:DeleteMarkerCreated.

ceph_tpu_torch's own copy of ``ceph_tpu/services/rgw_notify.py``.
"""
from __future__ import annotations

import json
import time

from ..cluster.client import absent_attr as _no_config
from .rgw import ClsLog, RGWError, RGWLite, _index_oid

TOPICS_OID = b".rgw.topics"
ATTR_NOTIFY = "rgw.notify"


def _topic_oid(name: str) -> bytes:
    return b".rgw.topic." + name.encode()


# ----------------------------------------------------------- topics

async def create_topic(rgw: RGWLite, name: str) -> None:
    if not name or "/" in name:
        raise RGWError("InvalidArgument", what=f"topic {name!r}")
    await rgw.client.omap_set(rgw.pool_id, TOPICS_OID,
                              {name.encode(): b"1"})


async def list_topics(rgw: RGWLite) -> list[str]:
    try:
        omap = await rgw.client.omap_get(rgw.pool_id, TOPICS_OID)
    except KeyError:
        return []
    return sorted(k.decode() for k in omap)


async def delete_topic(rgw: RGWLite, name: str) -> None:
    """Refuses while any bucket's rules still reference the topic —
    otherwise those rules would keep publishing and the WR cls append
    would silently resurrect the deleted queue object with no
    consumer."""
    for bucket in await rgw.list_buckets():
        for r in await get_bucket_notification(rgw, bucket):
            if r.get("topic") == name:
                raise RGWError(
                    "Conflict", 409,
                    f"topic {name!r} still referenced by bucket "
                    f"{bucket!r}")
    await rgw.client.omap_rm(rgw.pool_id, TOPICS_OID, [name.encode()])
    try:
        await rgw.client.delete(rgw.pool_id, _topic_oid(name))
    except KeyError:
        pass


# ------------------------------------------------ bucket configuration

async def put_bucket_notification(rgw: RGWLite, bucket: str,
                                  rules: list[dict]) -> None:
    """Attach notification rules to a bucket; every referenced topic
    must exist (the reference validates the topic ARN the same way)."""
    await rgw._require_bucket(bucket)
    topics = set(await list_topics(rgw))
    for r in rules:
        if r.get("topic") not in topics:
            raise RGWError("InvalidArgument",
                           what=f"no such topic {r.get('topic')!r}")
        for ev in r.get("events", []):
            if not ev.startswith("s3:Object"):
                raise RGWError("InvalidArgument", what=f"event {ev!r}")
    await rgw.client.setxattr(
        rgw.pool_id, _index_oid(bucket), ATTR_NOTIFY,
        json.dumps(rules).encode())
    rgw._notif_cache.pop(bucket, None)


async def get_bucket_notification(rgw: RGWLite,
                                  bucket: str) -> list[dict]:
    await rgw._require_bucket(bucket)
    try:
        raw = await rgw.client.getxattr(
            rgw.pool_id, _index_oid(bucket), ATTR_NOTIFY)
    except Exception as e:
        if _no_config(e):
            return []
        raise
    return json.loads(raw.decode())


def event_match(patterns: list[str], event: str) -> bool:
    """S3 event filter globs: "s3:ObjectCreated:*" matches
    "s3:ObjectCreated:Put"; empty pattern list matches everything."""
    if not patterns:
        return True
    for p in patterns:
        if p == event or (p.endswith(":*")
                          and event.startswith(p[:-1])):
            return True
    return False


async def emit(rgw: RGWLite, bucket: str, key: str, event: str,
               size: int = 0, etag: str = "",
               version_id: str = "") -> None:
    """Publish one event to every matching topic queue (called from
    RGWLite's op path; rules are TTL-cached per bucket)."""
    rules = await _cached_rules(rgw, bucket)
    targets = {r["topic"] for r in rules
               if event_match(r.get("events", []), event)
               and key.startswith(r.get("prefix", ""))}
    if not targets:
        return
    record = json.dumps({
        "eventVersion": "2.2",
        "eventSource": "ceph:rgw",
        "eventTime": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                   time.gmtime()),
        "eventName": event,
        "s3": {"bucket": {"name": bucket},
               "object": {"key": key, "size": size, "eTag": etag,
                          "versionId": version_id}},
    }).encode()
    for t in sorted(targets):
        await ClsLog(rgw.client, rgw.pool_id,
                     _topic_oid(t)).append(record)


async def _cached_rules(rgw: RGWLite, bucket: str,
                        ttl: float = 2.0) -> list[dict]:
    now = time.monotonic()
    hit = rgw._notif_cache.get(bucket)
    if hit is not None and hit[0] > now:
        return hit[1]
    try:
        raw = await rgw.client.getxattr(
            rgw.pool_id, _index_oid(bucket), ATTR_NOTIFY)
        rules = json.loads(raw.decode())
    except Exception as e:
        if not _no_config(e):
            raise  # transient failure: fail the op, don't drop events
        rules = []
    rgw._notif_cache[bucket] = (now + ttl, rules)
    return rules


# ----------------------------------------------------------- consumer

class TopicQueue(ClsLog):
    """Pull-mode consumer over a topic's queue object."""

    def __init__(self, client, pool_id: int, topic: str):
        super().__init__(client, pool_id, _topic_oid(topic))

    async def pull(self, marker: int = 0, max_events: int = 100
                   ) -> tuple[list[dict], int, bool]:
        """(events, next_marker, truncated); pass next_marker back to
        resume, ``ack(next_marker)`` to drop what you processed."""
        _head, raw, truncated = await self.entries(marker, max_events)
        events = [json.loads(ent.decode()) for _seq, ent in raw]
        next_marker = (raw[-1][0] + 1) if raw else marker
        return events, next_marker, truncated

    async def ack(self, upto: int) -> None:
        await self.trim(upto)
