"""Balancer: upmap-based PG distribution optimizer (the src/pybind/mgr
balancer module's upmap mode, backed by OSDMonitor pg-upmap-items).

The reference's balancer asks CrushWrapper for an "optimal" incremental
remap; this lite version runs the same greedy arc directly on the map
pipeline: count PGs per OSD for a pool, then repeatedly move one PG
replica from the most-loaded OSD to the least-loaded eligible OSD by
appending a pg_upmap_items pair, until the spread reaches the floor or
the move budget runs out. Eligibility keeps placements valid: the
target must be up/in, absent from the PG's current up set, and — when
the map has a bucket hierarchy — must not share its failure-domain
bucket with a surviving replica (the chooseleaf contract the
reference enforces through CRUSH itself).

Every proposed move is validated by re-running the FULL map pipeline
(pg_to_up_acting_osds with the candidate upmap applied) before it is
committed, so a rejected/ineffective upmap can never reach the mon.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/balancer.py``.
"""
from __future__ import annotations

from collections import defaultdict


def _pg_ups(osdmap, pool_id: int) -> dict[tuple[int, int], list[int]]:
    pool = osdmap.pools[pool_id]
    out = {}
    for ps in range(pool.pg_num):
        up, _prim = osdmap.pg_to_up_acting_osds((pool_id, ps))
        out[(pool_id, ps)] = [o for o in up if o is not None and o >= 0]
    return out


def _parents(osdmap) -> dict[int, int] | None:
    """osd -> direct parent bucket (the failure domain). On a flat map
    (every device under one root) a domain constraint would block every
    move, so flat maps report None — matching a chooseleaf-less rule."""
    parents: dict[int, int] = {}
    for bid, bucket in osdmap.crush.buckets.items():
        for item in bucket.items:
            if item >= 0:
                parents[item] = bid
    if len(set(parents.values())) <= 1:
        return None
    return parents


def pg_distribution(osdmap, pool_id: int) -> dict[int, int]:
    """osd -> PG count for the pool (only up+in OSDs listed)."""
    counts: dict[int, int] = {
        o: 0 for o in range(osdmap.n_osds)
        if osdmap.osds[o].up and osdmap.osds[o].weight > 0
    }
    for up in _pg_ups(osdmap, pool_id).values():
        for o in up:
            if o in counts:
                counts[o] += 1
    return counts


def compute_moves(osdmap, pool_id: int,
                  max_moves: int = 10) -> list[tuple[tuple[int, int],
                                                     list[tuple[int, int]]]]:
    """Greedy upmap plan: [(pgid, pairs)] to commit via MUpmapItems.

    Works on a COPY of the map's upmap table so the planning loop sees
    its own earlier moves; the caller commits the returned entries.
    """
    ups = _pg_ups(osdmap, pool_id)
    counts = pg_distribution(osdmap, pool_id)
    if not counts:
        return []
    # existing pairs must be preserved (we append to them)
    pending: dict[tuple[int, int], list[tuple[int, int]]] = defaultdict(
        list,
        {pg: list(osdmap.pg_upmap_items.get(pg, []))
         for pg in ups})
    moves: list[tuple[tuple[int, int], list[tuple[int, int]]]] = []

    parents = _parents(osdmap)
    for _ in range(max_moves):
        hi = max(counts, key=lambda o: counts[o])
        lo = min(counts, key=lambda o: counts[o])
        if counts[hi] - counts[lo] <= 1:
            break  # balanced: spread is at the floor
        lo_dom = parents.get(lo) if parents else None
        done = False
        for pgid, up in ups.items():
            if hi not in up or lo in up:
                continue
            if lo_dom is not None and any(
                    o != hi and parents.get(o) == lo_dom
                    for o in up):
                continue  # would double up a failure domain
            candidate = pending[pgid] + [(hi, lo)]
            # validate through the real pipeline before proposing
            saved = osdmap.pg_upmap_items.get(pgid)
            osdmap.pg_upmap_items[pgid] = candidate
            new_up, _ = osdmap.pg_to_up_acting_osds(pgid)
            if saved is None:
                del osdmap.pg_upmap_items[pgid]
            else:
                osdmap.pg_upmap_items[pgid] = saved
            new_up = [o for o in new_up if o is not None and o >= 0]
            if lo not in new_up or hi in new_up or (
                    len(set(new_up)) != len(new_up)):
                continue  # upmap rejected or ineffective
            pending[pgid] = candidate
            ups[pgid] = new_up
            counts[hi] -= 1
            counts[lo] += 1
            moves.append((pgid, candidate))
            done = True
            break
        if not done:
            break  # no movable PG under the constraints
    # collapse to the final pairs per pg (later moves superseded earlier)
    final: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for pgid, pairs in moves:
        final[pgid] = pairs
    return list(final.items())


def spread(osdmap, pool_id: int) -> dict:
    counts = pg_distribution(osdmap, pool_id)
    if not counts:
        return {"osds": 0}
    vals = sorted(counts.values())
    return {
        "osds": len(counts),
        "min": vals[0],
        "max": vals[-1],
        "spread": vals[-1] - vals[0],
        "per_osd": {str(k): v for k, v in sorted(counts.items())},
    }
