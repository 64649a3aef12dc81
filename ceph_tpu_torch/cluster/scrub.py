"""Scrub: background integrity checking + repair (src/osd/scrubber role).

The primary collects a ScrubMap — {oid: (version, (size, crc32c))} —
from itself and every live member (MScrub/MScrubReply), compares, and
repairs divergent copies through the existing recovery push machinery
(pg_scrubber.cc digest-compare + "repair" mode).

TPU-first digesting: a member does NOT loop crc32c over objects — it
groups its objects by size and checksums each group as ONE batched
dispatch (native SSE4.2 host batch by default, the batched device
CRC kernel for large same-size groups), the same amortization the
write path's ECBatcher uses. EC shards additionally self-verify their
chunk bytes against the stored hinfo CRC (the deep-scrub hinfo check,
ECBackend handle_sub_read's crc path) and report corrupt objects in
`errors`.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/scrub.py``. The device
groups run on ``torch_device`` (the OSD's device: the card unless the
caller names another), resolved only when a group goes there, so a
host-digest scrub needs no card.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..ops import crc32c as crc_ops

# route groups at least this large through the device kernel when the
# blob length is word-aligned (host batch wins below; dispatch overhead)
DEVICE_GROUP_MIN = 512


def digest_map(store, cid: str, skip: tuple[bytes, ...] = (),
               device: bool = False,
               torch_device=None) -> dict[bytes, tuple[int, int]]:
    """{oid: (size, crc32c-of-data)} for every object in `cid`,
    checksummed in per-size batches; ``device=True`` sends large
    word-aligned groups to the CRC kernel on ``torch_device``."""
    oids = [o for o in store.list_objects(cid) if o not in skip]
    by_size: dict[int, list[bytes]] = {}
    for oid in oids:
        by_size.setdefault(store.stat(cid, oid), []).append(oid)
    out: dict[bytes, tuple[int, int]] = {}
    for size, group in by_size.items():
        if size == 0:
            for oid in group:
                out[oid] = (0, native.crc32c(None))
            continue
        blobs = np.stack([
            np.frombuffer(store.read(cid, oid), np.uint8) for oid in group
        ])
        if device and size % 4 == 0 and len(group) >= DEVICE_GROUP_MIN:
            crcs = np.asarray(crc_ops.crc32c_batch(blobs,
                                                   device=torch_device))
        else:
            crcs = native.crc32c_batch(blobs)
        for oid, crc in zip(group, crcs):
            out[oid] = (size, int(crc))
    return out


def pick_authoritative(copies: dict) -> tuple:
    """copies: {member_key: (version, (size, crc)) } -> (auth_key, auth).

    Newest version wins; among holders of the newest version the
    majority (size, crc) is authoritative (the reference prefers a
    replica agreeing with the majority of digests); ties break on the
    lowest member key for determinism."""
    newest = max(v for v, _ in copies.values())
    holders = {k: sc for k, (v, sc) in copies.items() if v == newest}
    votes: dict[tuple, int] = {}
    for sc in holders.values():
        votes[sc] = votes.get(sc, 0) + 1
    best_sc = max(votes, key=lambda sc: (votes[sc],))
    auth_key = min(k for k, sc in holders.items() if sc == best_sc)
    return auth_key, (newest, best_sc)
