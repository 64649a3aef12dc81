"""pg_autoscaler: pool pg_num targets from the cluster map.

The mgr pg_autoscaler role (reference
src/pybind/mgr/pg_autoscaler/module.py:706 _get_pool_status /
_maybe_adjust): each pool aims at ``target_per_osd`` PG *replicas* per
participating OSD, divided among pools, rounded to a power of two.
Like the reference, the planner only recommends growth when the ideal
is at least the adjustment threshold (3x) away, to avoid flapping, and
pgp_num trails pg_num by one round so collection splits land on the
members before placement changes (the pg_num -> pgp_num sequencing the
OSD split machinery relies on).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/autoscaler.py``.
"""
from __future__ import annotations

THRESHOLD = 3.0  # reference default: adjust when off by >= 3x


def _pow2_at_most(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def plan(osdmap, target_per_osd: int = 100,
         max_pg_num: int = 1 << 12) -> list[tuple[int, str, int]]:
    """-> [(pool_id, key, value)] mon mutations for this round.

    Growth: pg_num first (collections split in place), pgp_num catches
    up the following round so placement moves after the splits landed.
    Shrink: the reverse sequence — pgp_num collapses first so
    children co-locate with their parents, pg_num halves down to it the
    following round and the OSDs fold collections (PG::merge_from
    role). Both directions only fire when the ideal is >= THRESHOLD
    away, so sizes never flap."""
    pools = list(osdmap.pools.values())
    if not pools:
        return []
    n_up = sum(1 for st in osdmap.osds if st.up and st.weight > 0)
    if n_up == 0:
        return []
    out: list[tuple[int, str, int]] = []
    budget = target_per_osd * n_up / len(pools)
    for pool in pools:
        size = max(1, pool.size)
        ideal = max(1, _pow2_at_most(min(int(budget / size),
                                         max_pg_num)))
        if pool.pgp_num < pool.pg_num:
            if ideal <= pool.pgp_num:
                # mid-shrink: placement already collapsed; finish the
                # merge by halving pg_num down to it
                out.append((pool.id, "pg_num", pool.pgp_num))
            else:
                # mid-split: placement catches up to the grown pg_num
                out.append((pool.id, "pgp_num", pool.pg_num))
            continue
        if ideal >= pool.pg_num * THRESHOLD:
            out.append((pool.id, "pg_num", ideal))
        elif ideal * THRESHOLD <= pool.pg_num:
            out.append((pool.id, "pgp_num", ideal))
    return out
