"""Epoch-versioned cluster map: the object -> PG -> OSD pipeline.

Mirrors the reference's OSDMap (src/osd/OSDMap.cc): pools with pg/pgp
counts and masks, per-OSD state (exists/up/in + reweight), CRUSH rule
dispatch (_pg_to_raw_osds -> crush->do_rule, OSDMap.cc:2638-2650), upmap
overrides (_apply_upmap :2668), up-set derivation (_raw_to_up_osds
:2736), primary pick, and incremental epoch advance. The placement seed
(pps) and stable-mod hashing follow src/include/rados.h and
OSDMap::pool_raw_pg_to_pps exactly; object names hash with
ceph_str_hash_rjenkins (src/common/ceph_hash.cc:22).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import native
from .crushmap import ITEM_NONE, CrushMap


def ceph_str_hash_rjenkins(data: bytes) -> int:
    """Port of ceph_str_hash_rjenkins (ceph_hash.cc:22-98)."""
    mask = 0xFFFFFFFF
    a, b, c = 0x9E3779B9, 0x9E3779B9, 0
    length = len(data)
    k = 0
    le = length

    def mix(a: int, b: int, c: int) -> tuple[int, int, int]:
        a = (a - b - c) & mask
        a ^= c >> 13
        b = (b - c - a) & mask
        b ^= (a << 8) & mask
        c = (c - a - b) & mask
        c ^= b >> 13
        a = (a - b - c) & mask
        a ^= c >> 12
        b = (b - c - a) & mask
        b ^= (a << 16) & mask
        c = (c - a - b) & mask
        c ^= b >> 5
        a = (a - b - c) & mask
        a ^= c >> 3
        b = (b - c - a) & mask
        b ^= (a << 10) & mask
        c = (c - a - b) & mask
        c ^= b >> 15
        return a, b, c

    while le >= 12:
        a = (a + int.from_bytes(data[k : k + 4], "little")) & mask
        b = (b + int.from_bytes(data[k + 4 : k + 8], "little")) & mask
        c = (c + int.from_bytes(data[k + 8 : k + 12], "little")) & mask
        a, b, c = mix(a, b, c)
        k += 12
        le -= 12
    c = (c + length) & mask
    tail = data[k:]
    shifts_c = {11: 24, 10: 16, 9: 8}
    shifts_b = {8: 24, 7: 16, 6: 8, 5: 0}
    shifts_a = {4: 24, 3: 16, 2: 8, 1: 0}
    for i in range(le, 0, -1):
        byte = tail[i - 1]
        if i in shifts_c:
            c = (c + ((byte << shifts_c[i]) & mask)) & mask
        elif i in shifts_b:
            b = (b + ((byte << shifts_b[i]) & mask)) & mask
        else:
            a = (a + ((byte << shifts_a[i]) & mask)) & mask
    _, _, c = mix(a, b, c)
    return c


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """include/rados.h:96 — stable under pg_num growth."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def calc_bits_of(n: int) -> int:
    return n.bit_length()


@dataclass
class Pool:
    id: int
    name: str
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    crush_rule: int = 0
    type: str = "replicated"  # or "erasure"
    pgp_num: int = 0
    ec_profile: dict[str, str] = field(default_factory=dict)
    #: selfmanaged-snapshot allocation state (pg_pool_t snap_seq /
    #: removed_snaps roles): ids are allocated by the mon, removal is an
    #: interval set that drives OSD-side snap trimming
    snap_seq: int = 0
    removed_snaps: list[tuple[int, int]] = field(default_factory=list)
    #: pool quotas (pg_pool_t quota_max_bytes/objects): 0 = unlimited;
    #: `full` is the FLAG_FULL_QUOTA role — committed by the mon when
    #: the mgr digest crosses a quota, checked by clients before writes
    quota_max_bytes: int = 0
    quota_max_objects: int = 0
    full: bool = False

    def __post_init__(self):
        if self.pgp_num == 0:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return (1 << calc_bits_of(self.pg_num - 1)) - 1

    @property
    def pgp_num_mask(self) -> int:
        return (1 << calc_bits_of(self.pgp_num - 1)) - 1

    def can_shift_osds(self) -> bool:
        """Replicated sets compact out holes; EC sets are positional
        (pg_pool_t::can_shift_osds)."""
        return self.type == "replicated"

    def raw_pg_to_pg(self, ps: int) -> int:
        return ceph_stable_mod(ps, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, ps: int) -> int:
        """Placement seed (OSDMap::pool_raw_pg_to_pps): re-mod by pgp_num
        then mix with the pool id so pools don't align."""
        return native.crush_hash32_2(
            ceph_stable_mod(ps, self.pgp_num, self.pgp_num_mask), self.id
        )


@dataclass
class OSDState:
    exists: bool = True
    up: bool = True
    weight: int = 0x10000  # in/out reweight, 16.16 (0 = out, 0x10000 = in)


class OSDMap:
    """The authoritative cluster map (one epoch)."""

    def __init__(self, crush: CrushMap, n_osds: int, epoch: int = 1) -> None:
        self.epoch = epoch
        self.crush = crush
        self.osds: list[OSDState] = [OSDState() for _ in range(n_osds)]
        self.pools: dict[int, Pool] = {}
        self.pg_upmap: dict[tuple[int, int], list[int]] = {}
        self.pg_upmap_items: dict[tuple[int, int], list[tuple[int, int]]] = {}
        self.pg_upmap_primaries: dict[tuple[int, int], int] = {}
        #: peering-time overrides (OSDMap pg_temp/primary_temp role):
        #: the mon installs these while backfill runs so IO keeps
        #: flowing to the old holders
        self.pg_temp: dict[tuple[int, int], list[int]] = {}
        self.primary_temp: dict[tuple[int, int], int] = {}
        #: per-osd 16.16 primary affinity (0x10000 = default)
        self.primary_affinity: dict[int, int] = {}
        #: fenced client entities (the reference's osd blocklist,
        #: OSDMap::is_blocklisted role): OSDs reject their ops, which
        #: is what makes breaking a dead client's exclusive lock SAFE —
        #: the stale holder's in-flight writes can never land after the
        #: steal
        self.blocklist: set[str] = set()
        self._out_weights_cache: np.ndarray | None = None

    # ------------------------------------------------------------- state

    @property
    def n_osds(self) -> int:
        return len(self.osds)

    def add_pool(self, pool: Pool) -> None:
        self.pools[pool.id] = pool

    def is_up(self, osd: int) -> bool:
        return (
            0 <= osd < len(self.osds)
            and self.osds[osd].exists
            and self.osds[osd].up
        )

    def out_weights(self) -> np.ndarray:
        """Per-device 16.16 reweight vector; cached until the next
        incremental (it is read on every placement)."""
        if self._out_weights_cache is None:
            w = np.zeros(
                max(self.crush.max_devices, self.n_osds), dtype=np.uint32
            )
            for i, st in enumerate(self.osds):
                w[i] = st.weight if st.exists else 0
            self._out_weights_cache = w
        return self._out_weights_cache

    # ----------------------------------------------------- object -> PG

    def object_to_pg(self, pool_id: int, name: bytes | str) -> tuple[int, int]:
        """(pool, ps) — the raw pg id for an object name."""
        if isinstance(name, str):
            name = name.encode()
        pool = self.pools[pool_id]
        ps = pool.raw_pg_to_pg(ceph_str_hash_rjenkins(name))
        return (pool_id, ps)

    # ------------------------------------------------------- PG -> OSDs

    def pg_to_raw_osds(self, pgid: tuple[int, int]) -> tuple[list[int], int]:
        """(raw osd vector, pps) — OSDMap::_pg_to_raw_osds."""
        pool = self.pools[pgid[0]]
        pps = pool.raw_pg_to_pps(pgid[1])
        raw = self.crush.do_rule(
            pool.crush_rule, pps, pool.size, self.out_weights()
        )
        return raw, pps

    def _osd_marked_out(self, osd: int) -> bool:
        """The reference's upmap validity predicate (OSDMap.cc:2674-2677):
        reject only a target that is a valid in-range osd id with
        osd_weight == 0; out-of-range and NONE targets pass through."""
        return (
            osd != ITEM_NONE
            and 0 <= osd < self.n_osds
            and int(self.out_weights()[osd]) == 0
        )

    def _apply_upmap(self, pool: Pool, pgid: tuple[int, int], raw: list[int]):
        """OSDMap::_apply_upmap (OSDMap.cc:2668-2730): a valid full
        pg_upmap replaces raw and pg_upmap_items are STILL applied on top;
        an invalid pg_upmap (any in-range target with weight 0) returns
        raw untouched, skipping items and primaries too — matching the
        reference's early return."""
        out = list(raw)
        pm = self.pg_upmap.get(pgid)
        if pm:
            if any(self._osd_marked_out(o) for o in pm):
                return out  # reject whole override, skip items/primaries
            out = list(pm)
        for frm, to in self.pg_upmap_items.get(pgid, []):
            # One scan per pair, faithful to the reference loop: `to`
            # already present anywhere kills the pair; `frm` is replaced
            # at its first position unless `to` is marked out.
            exists = False
            pos = -1
            for i, o in enumerate(out):
                if o == to:
                    exists = True
                    break
                if o == frm and pos < 0 and not self._osd_marked_out(to):
                    pos = i
            if not exists and pos >= 0:
                out[pos] = to
        new_prim = self.pg_upmap_primaries.get(pgid)
        if (
            new_prim is not None
            and new_prim != ITEM_NONE
            and 0 <= new_prim < self.n_osds
            and int(self.out_weights()[new_prim]) != 0
        ):
            for i in range(1, len(out)):  # start from 1 on purpose
                if out[i] == new_prim:
                    out[i] = out[0]
                    out[0] = new_prim
                    break
        return out

    def _raw_to_up_osds(self, pool: Pool, raw: list[int]) -> list[int]:
        """OSDMap.cc:2736: replicated pools compact out down/dne OSDs;
        EC pools keep positions with NONE holes."""
        if pool.can_shift_osds():
            return [o for o in raw if o != ITEM_NONE and self.is_up(o)]
        return [o if o != ITEM_NONE and self.is_up(o) else ITEM_NONE for o in raw]

    @staticmethod
    def _pick_primary(osds: list[int]) -> int:
        for o in osds:
            if o != ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, pps: int, pool: Pool,
                                up: list[int]) -> int:
        """OSDMap::_apply_primary_affinity: hash the (pg seed, osd)
        pair against each candidate's affinity so a proportional share
        of its PGs rejects it as primary; replicated pools shift the
        chosen primary to the front."""
        if not self.primary_affinity:
            return self._pick_primary(up)
        if not any(
            o != ITEM_NONE
            and self.primary_affinity.get(o, 0x10000) != 0x10000
            for o in up
        ):
            return self._pick_primary(up)
        pos = -1
        for i, o in enumerate(up):
            if o == ITEM_NONE:
                continue
            a = self.primary_affinity.get(o, 0x10000)
            if a < 0x10000 and (
                native.crush_hash32_2(pps, o) >> 16
            ) >= a:
                if pos < 0:
                    pos = i  # fallback if everyone declines
            else:
                pos = i
                break
        if pos < 0:
            return self._pick_primary(up)
        primary = up[pos]
        if pool.can_shift_osds() and pos > 0:
            for i in range(pos, 0, -1):
                up[i] = up[i - 1]
            up[0] = primary
        return primary

    def _get_temp_osds(
        self, pool: Pool, pgid: tuple[int, int]
    ) -> tuple[list[int], int]:
        """OSDMap::_get_temp_osds: the pg_temp acting override with
        down members dropped (replicated) or holed (EC), and the
        primary_temp / first-live-temp primary."""
        temp = []
        for o in self.pg_temp.get(pgid, ()):  # absent -> empty
            if not self.is_up(o):
                if pool.can_shift_osds():
                    continue
                temp.append(ITEM_NONE)
            else:
                temp.append(o)
        primary = self.primary_temp.get(pgid, -1)
        if primary == -1:
            for o in temp:
                if o != ITEM_NONE:
                    primary = o
                    break
        return temp, primary

    def pg_to_up_acting_osds(
        self, pgid: tuple[int, int]
    ) -> tuple[list[int], int]:
        """(acting set, acting primary) — the membership IO targets
        (the full pipeline of OSDMap.cc:2891: crush -> upmap -> up ->
        affinity, with pg_temp/primary_temp overriding acting)."""
        _up, _upp, acting, primary = self.pg_to_up_acting_full(pgid)
        return acting, primary

    def pg_to_up_acting_full(
        self, pgid: tuple[int, int]
    ) -> tuple[list[int], int, list[int], int]:
        """(up, up_primary, acting, acting_primary)."""
        raw, pps = self.pg_to_raw_osds(pgid)
        return self.raw_to_up_acting(pgid, raw, pps)

    def raw_to_up_acting(
        self, pgid: tuple[int, int], raw: list[int], pps: int
    ) -> tuple[list[int], int, list[int], int]:
        """The post-CRUSH half of the placement pipeline: raw osd
        vector -> upmap overrides -> up filtering -> primary affinity
        -> pg_temp/primary_temp. Split out so the batched resolver
        (placement/resolver.py) can feed DEVICE-computed raw vectors
        through the exact same host semantics the per-pg path uses —
        one code path, no drift."""
        pool = self.pools[pgid[0]]
        raw = self._apply_upmap(pool, pgid, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._apply_primary_affinity(pps, pool, up)
        acting, acting_primary = self._get_temp_osds(pool, pgid)
        if not acting:
            acting = up  # primary_temp still applies (reference keeps
            # _acting_primary when set even with no pg_temp)
        if acting_primary == -1:
            acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    def object_to_up_osds(
        self, pool_id: int, name: bytes | str
    ) -> tuple[list[int], int]:
        return self.pg_to_up_acting_osds(self.object_to_pg(pool_id, name))

    # ------------------------------------------------------ incrementals

    def apply_incremental(self, inc: "Incremental") -> None:
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != map epoch {self.epoch}+1"
            )
        for osd in inc.down:
            self.osds[osd].up = False
        for osd in inc.up:
            self.osds[osd].up = True
        for osd, w in inc.weights.items():
            self.osds[osd].weight = w
        for pool in inc.new_pools:
            self.add_pool(pool)
        for pgid, mapping in inc.new_pg_upmap.items():
            if mapping:
                self.pg_upmap[pgid] = mapping
            else:
                self.pg_upmap.pop(pgid, None)
        for pgid, items in inc.new_pg_upmap_items.items():
            if items:
                self.pg_upmap_items[pgid] = items
            else:
                self.pg_upmap_items.pop(pgid, None)
        for pgid, prim in inc.new_pg_upmap_primaries.items():
            if prim is not None and prim != -1:
                self.pg_upmap_primaries[pgid] = prim
            else:
                self.pg_upmap_primaries.pop(pgid, None)
        for pgid, temp in inc.new_pg_temp.items():
            if temp:
                self.pg_temp[pgid] = list(temp)
            else:
                self.pg_temp.pop(pgid, None)
        for pgid, prim in inc.new_primary_temp.items():
            if prim != -1:
                self.primary_temp[pgid] = prim
            else:
                self.primary_temp.pop(pgid, None)
        for osd, aff in inc.new_primary_affinity.items():
            if aff == 0x10000:
                self.primary_affinity.pop(osd, None)
            else:
                self.primary_affinity[osd] = aff
        self.blocklist.update(inc.new_blocklist)
        self.blocklist.difference_update(inc.new_unblocklist)
        for pid in inc.removed_pools:
            self.pools.pop(pid, None)
            self.pg_temp = {k: v for k, v in self.pg_temp.items()
                            if k[0] != pid}
            self.primary_temp = {
                k: v for k, v in self.primary_temp.items() if k[0] != pid}
            self.pg_upmap = {k: v for k, v in self.pg_upmap.items()
                             if k[0] != pid}
            self.pg_upmap_items = {
                k: v for k, v in self.pg_upmap_items.items() if k[0] != pid}
            self.pg_upmap_primaries = {
                k: v for k, v in self.pg_upmap_primaries.items()
                if k[0] != pid}
        self._out_weights_cache = None
        self.epoch = inc.epoch


class PlacementMemo:
    """Per-epoch memo of pg_to_up_acting lookups, owned by daemons and
    clients whose map ONLY changes through epochs (every change arrives
    as an incremental or a newer full map). The data path asks for the
    same pgid's mapping on every op; within an epoch CRUSH is a pure
    function of the map, so recomputing it per op was ~20% of the
    round-5 write-path profile. NOT safe for the mon or tools, which
    edit map objects in place without bumping the epoch (the balancer's
    what-if probes, test fixtures) — they must keep calling the map
    directly."""

    def __init__(self) -> None:
        self._map: OSDMap | None = None
        self._epoch = -1
        self._memo: dict[tuple[int, int], tuple] = {}

    def full(self, osdmap: "OSDMap", pgid: tuple[int, int]
             ) -> tuple[list[int], int, list[int], int]:
        if self._map is not osdmap or osdmap.epoch != self._epoch:
            self._map = osdmap
            self._epoch = osdmap.epoch
            self._memo.clear()
        hit = self._memo.get(pgid)
        if hit is None:
            up, upp, acting, ap = osdmap.pg_to_up_acting_full(pgid)
            self._memo[pgid] = (tuple(up), upp, tuple(acting), ap)
            return up, upp, acting, ap
        up_t, upp, act_t, ap = hit
        # fresh lists per call: callers mutate the vectors they get
        return list(up_t), upp, list(act_t), ap

    def up_acting(self, osdmap: "OSDMap", pgid: tuple[int, int]
                  ) -> tuple[list[int], int]:
        _up, _upp, acting, ap = self.full(osdmap, pgid)
        return acting, ap


@dataclass
class Incremental:
    """Delta between epochs (OSDMap::Incremental, applied in order)."""

    epoch: int
    up: list[int] = field(default_factory=list)
    down: list[int] = field(default_factory=list)
    weights: dict[int, int] = field(default_factory=dict)  # osd -> 16.16
    new_pools: list[Pool] = field(default_factory=list)
    new_pg_upmap: dict[tuple[int, int], list[int]] = field(default_factory=dict)
    new_pg_upmap_items: dict[tuple[int, int], list[tuple[int, int]]] = field(
        default_factory=dict
    )
    # pgid -> osd (None or -1 removes the mapping)
    new_pg_upmap_primaries: dict[tuple[int, int], int | None] = field(
        default_factory=dict
    )
    # pgid -> temp acting set ([] removes), pgid -> temp primary (-1
    # removes), osd -> 16.16 affinity (0x10000 removes)
    new_pg_temp: dict[tuple[int, int], list[int]] = field(
        default_factory=dict
    )
    new_primary_temp: dict[tuple[int, int], int] = field(
        default_factory=dict
    )
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    # fenced / unfenced client entity names (osd blocklist role)
    new_blocklist: list[str] = field(default_factory=list)
    new_unblocklist: list[str] = field(default_factory=list)
    # deleted pool ids (`ceph osd pool rm` role): OSDs drop the pool's
    # PGs and collections when this epoch applies
    removed_pools: list[int] = field(default_factory=list)
