"""Wire/disk encoding for CrushMap, OSDMap, and Incremental.

The reference encodes maps with versioned denc (OSDMap::encode,
src/osd/OSDMap.cc, CrushWrapper::encode src/crush/CrushWrapper.cc) so the
mon can publish them and tools can operate offline. Same role here on the
ceph_tpu_torch.utils.denc primitives — explicit LE formats, bounded decoders,
a version byte up front for forward evolution.
"""
from __future__ import annotations

from ..utils import denc
from . import crushmap as cm
from .osdmap import Incremental, OSDMap, OSDState, Pool

_V = 4  # v4: +pool quotas/full flag, +removed_pools


# ----------------------------------------------------------------- crush


def encode_crushmap(m: cm.CrushMap) -> bytes:
    out = [denc.enc_u8(_V)]
    out.append(denc.enc_map(m.types, denc.enc_i32, denc.enc_str))
    out.append(denc.enc_u32(len(m.buckets)))
    for b in sorted(m.buckets.values(), key=lambda b: -b.id):
        out.append(denc.enc_i32(b.id))
        out.append(denc.enc_i32(b.type_id))
        out.append(denc.enc_str(b.alg))
        out.append(denc.enc_str(b.name))
        out.append(denc.enc_list(b.items, denc.enc_i32))
        out.append(denc.enc_list(b.weights, denc.enc_u32))
    out.append(denc.enc_u32(len(m.rules)))
    for r in sorted(m.rules.values(), key=lambda r: r.id):
        out.append(denc.enc_i32(r.id))
        out.append(denc.enc_str(r.name))
        out.append(denc.enc_u32(len(r.steps)))
        for s in r.steps:
            out.append(denc.enc_str(s.op))
            out.append(denc.enc_i32(s.arg1))
            out.append(denc.enc_i32(s.arg2))
    t = m.tunables
    out.append(
        b"".join(
            denc.enc_u32(v)
            for v in (
                t.choose_local_tries,
                t.choose_local_fallback_tries,
                t.choose_total_tries,
                t.chooseleaf_descend_once,
                t.chooseleaf_vary_r,
                t.chooseleaf_stable,
            )
        )
    )
    out.append(denc.enc_u32(m.max_devices))
    out.append(denc.enc_map(m.names, denc.enc_i32, denc.enc_str))
    # choose_args weight sets (balancer output must survive the wire)
    out.append(denc.enc_u32(len(m.choose_args)))
    for key in sorted(m.choose_args, key=str):
        out.append(denc.enc_str(str(key)))
        per_bucket = m.choose_args[key]
        out.append(denc.enc_u32(len(per_bucket)))
        for bid in sorted(per_bucket):
            ws, ids = per_bucket[bid]
            out.append(denc.enc_i32(bid))
            out.append(denc.enc_list(ws, denc.enc_u32))
            out.append(denc.enc_u8(ids is not None))
            if ids is not None:
                out.append(denc.enc_list(ids, denc.enc_i32))
    out.append(
        denc.enc_map(getattr(m, "device_classes", {}), denc.enc_i32,
                     denc.enc_str)
    )
    return b"".join(out)


def decode_crushmap(buf: bytes, off: int = 0) -> tuple[cm.CrushMap, int]:
    v, off = denc.dec_u8(buf, off)
    if v != _V:
        raise denc.DecodeError(f"crushmap v{v} unsupported")
    m = cm.CrushMap()
    m.types, off = denc.dec_map(buf, off, denc.dec_i32, denc.dec_str)
    nb, off = denc.dec_u32(buf, off)
    for _ in range(nb):
        bid, off = denc.dec_i32(buf, off)
        tid, off = denc.dec_i32(buf, off)
        alg, off = denc.dec_str(buf, off)
        name, off = denc.dec_str(buf, off)
        items, off = denc.dec_list(buf, off, denc.dec_i32)
        weights, off = denc.dec_list(buf, off, denc.dec_u32)
        m.add_bucket(
            cm.Bucket(id=bid, type_id=tid, alg=alg, items=items,
                      weights=weights, name=name)
        )
    nr, off = denc.dec_u32(buf, off)
    for _ in range(nr):
        rid, off = denc.dec_i32(buf, off)
        name, off = denc.dec_str(buf, off)
        ns, off = denc.dec_u32(buf, off)
        steps = []
        for _ in range(ns):
            op, off = denc.dec_str(buf, off)
            a1, off = denc.dec_i32(buf, off)
            a2, off = denc.dec_i32(buf, off)
            steps.append(cm.Step(op, a1, a2))
        m.add_rule(cm.Rule(id=rid, steps=steps, name=name))
    vals = []
    for _ in range(6):
        x, off = denc.dec_u32(buf, off)
        vals.append(x)
    m.tunables = cm.Tunables(*vals)
    m.max_devices, off = denc.dec_u32(buf, off)
    m.names, off = denc.dec_map(buf, off, denc.dec_i32, denc.dec_str)
    nca, off = denc.dec_u32(buf, off)
    for _ in range(nca):
        key, off = denc.dec_str(buf, off)
        nbk, off = denc.dec_u32(buf, off)
        per_bucket = {}
        for _ in range(nbk):
            bid, off = denc.dec_i32(buf, off)
            ws, off = denc.dec_list(buf, off, denc.dec_u32)
            has_ids, off = denc.dec_u8(buf, off)
            ids = None
            if has_ids:
                ids, off = denc.dec_list(buf, off, denc.dec_i32)
            per_bucket[bid] = (ws, ids)
        m.choose_args[key] = per_bucket
    m.device_classes, off = denc.dec_map(
        buf, off, denc.dec_i32, denc.dec_str
    )
    return m, off


# ------------------------------------------------------------------ pools


def _enc_pool(p: Pool) -> bytes:
    return b"".join(
        (
            denc.enc_i32(p.id),
            denc.enc_str(p.name),
            denc.enc_u32(p.size),
            denc.enc_u32(p.min_size),
            denc.enc_u32(p.pg_num),
            denc.enc_u32(p.crush_rule),
            denc.enc_str(p.type),
            denc.enc_u32(p.pgp_num),
            denc.enc_map(p.ec_profile, denc.enc_str, denc.enc_str),
            denc.enc_u64(p.snap_seq),
            denc.enc_list(
                p.removed_snaps,
                lambda iv: denc.enc_u64(iv[0]) + denc.enc_u64(iv[1]),
            ),
            denc.enc_u64(p.quota_max_bytes),
            denc.enc_u64(p.quota_max_objects),
            denc.enc_u8(1 if p.full else 0),
        )
    )


def _dec_pool(buf, off):
    pid, off = denc.dec_i32(buf, off)
    name, off = denc.dec_str(buf, off)
    size, off = denc.dec_u32(buf, off)
    min_size, off = denc.dec_u32(buf, off)
    pg_num, off = denc.dec_u32(buf, off)
    rule, off = denc.dec_u32(buf, off)
    ptype, off = denc.dec_str(buf, off)
    pgp, off = denc.dec_u32(buf, off)
    prof, off = denc.dec_map(buf, off, denc.dec_str, denc.dec_str)
    snap_seq, off = denc.dec_u64(buf, off)

    def _iv(b, o):
        lo, o = denc.dec_u64(b, o)
        hi, o = denc.dec_u64(b, o)
        return (lo, hi), o

    removed, off = denc.dec_list(buf, off, _iv)
    qb, off = denc.dec_u64(buf, off)
    qo, off = denc.dec_u64(buf, off)
    fl, off = denc.dec_u8(buf, off)
    return (
        Pool(id=pid, name=name, size=size, min_size=min_size, pg_num=pg_num,
             crush_rule=rule, type=ptype, pgp_num=pgp, ec_profile=prof,
             snap_seq=snap_seq, removed_snaps=removed,
             quota_max_bytes=qb, quota_max_objects=qo, full=bool(fl)),
        off,
    )


_PGID = (
    lambda p: denc.enc_i32(p[0]) + denc.enc_u32(p[1]),
    lambda b, o: ((denc.dec_i32(b, o)[0], denc.dec_u32(b, o + 4)[0]), o + 8),
)


# ----------------------------------------------------------------- osdmap


def encode_osdmap(m: OSDMap) -> bytes:
    out = [denc.enc_u8(_V), denc.enc_u32(m.epoch)]
    out.append(denc.enc_bytes(encode_crushmap(m.crush)))
    out.append(denc.enc_u32(len(m.osds)))
    for st in m.osds:
        out.append(denc.enc_u8((1 if st.exists else 0) | (2 if st.up else 0)))
        out.append(denc.enc_u32(st.weight))
    out.append(denc.enc_u32(len(m.pools)))
    for p in sorted(m.pools.values(), key=lambda p: p.id):
        out.append(_enc_pool(p))
    enc_pg, _ = _PGID
    out.append(
        denc.enc_map(m.pg_upmap, enc_pg, lambda v: denc.enc_list(v, denc.enc_i32))
    )
    out.append(
        denc.enc_map(
            m.pg_upmap_items,
            enc_pg,
            lambda v: denc.enc_list(
                v, lambda p: denc.enc_i32(p[0]) + denc.enc_i32(p[1])
            ),
        )
    )
    out.append(denc.enc_map(m.pg_upmap_primaries, enc_pg, denc.enc_i32))
    out.append(
        denc.enc_map(m.pg_temp, enc_pg,
                     lambda v: denc.enc_list(v, denc.enc_i32))
    )
    out.append(denc.enc_map(m.primary_temp, enc_pg, denc.enc_i32))
    out.append(
        denc.enc_map(m.primary_affinity, denc.enc_u32, denc.enc_u32)
    )
    out.append(denc.enc_list(sorted(m.blocklist), denc.enc_str))
    return b"".join(out)


def decode_osdmap(buf: bytes, off: int = 0) -> tuple[OSDMap, int]:
    v, off = denc.dec_u8(buf, off)
    if v != _V:
        raise denc.DecodeError(f"osdmap v{v} unsupported")
    epoch, off = denc.dec_u32(buf, off)
    crush_bytes, off = denc.dec_bytes(buf, off)
    crush, used = decode_crushmap(crush_bytes)
    if used != len(crush_bytes):
        raise denc.DecodeError("trailing crushmap bytes")
    n, off = denc.dec_u32(buf, off)
    m = OSDMap(crush, n, epoch=epoch)
    for i in range(n):
        flags, off = denc.dec_u8(buf, off)
        w, off = denc.dec_u32(buf, off)
        m.osds[i] = OSDState(
            exists=bool(flags & 1), up=bool(flags & 2), weight=w
        )
    np_, off = denc.dec_u32(buf, off)
    for _ in range(np_):
        p, off = _dec_pool(buf, off)
        m.add_pool(p)
    _, dec_pg = _PGID
    m.pg_upmap, off = denc.dec_map(
        buf, off, dec_pg, lambda b, o: denc.dec_list(b, o, denc.dec_i32)
    )

    def dec_pairs(b, o):
        return denc.dec_list(
            b, o,
            lambda b2, o2: (
                (denc.dec_i32(b2, o2)[0], denc.dec_i32(b2, o2 + 4)[0]),
                o2 + 8,
            ),
        )

    m.pg_upmap_items, off = denc.dec_map(buf, off, dec_pg, dec_pairs)
    m.pg_upmap_primaries, off = denc.dec_map(buf, off, dec_pg, denc.dec_i32)
    m.pg_temp, off = denc.dec_map(
        buf, off, dec_pg, lambda b, o: denc.dec_list(b, o, denc.dec_i32)
    )
    m.primary_temp, off = denc.dec_map(buf, off, dec_pg, denc.dec_i32)
    m.primary_affinity, off = denc.dec_map(
        buf, off, denc.dec_u32, denc.dec_u32
    )
    bl, off = denc.dec_list(buf, off, denc.dec_str)
    m.blocklist = set(bl)
    return m, off


# ------------------------------------------------------------ incremental


def encode_incremental(inc: Incremental) -> bytes:
    enc_pg, _ = _PGID
    return b"".join(
        (
            denc.enc_u8(_V),
            denc.enc_u32(inc.epoch),
            denc.enc_list(inc.up, denc.enc_u32),
            denc.enc_list(inc.down, denc.enc_u32),
            denc.enc_map(inc.weights, denc.enc_u32, denc.enc_u32),
            denc.enc_list(inc.new_pools, _enc_pool),
            denc.enc_map(
                inc.new_pg_upmap, enc_pg,
                lambda v: denc.enc_list(v, denc.enc_i32),
            ),
            denc.enc_map(
                inc.new_pg_upmap_items, enc_pg,
                lambda v: denc.enc_list(
                    v, lambda p: denc.enc_i32(p[0]) + denc.enc_i32(p[1])
                ),
            ),
            denc.enc_map(
                {k: (-1 if v is None else v)
                 for k, v in inc.new_pg_upmap_primaries.items()},
                enc_pg, denc.enc_i32,
            ),
            denc.enc_map(
                inc.new_pg_temp, enc_pg,
                lambda v: denc.enc_list(v, denc.enc_i32),
            ),
            denc.enc_map(inc.new_primary_temp, enc_pg, denc.enc_i32),
            denc.enc_map(inc.new_primary_affinity, denc.enc_u32,
                         denc.enc_u32),
            denc.enc_list(inc.new_blocklist, denc.enc_str),
            denc.enc_list(inc.new_unblocklist, denc.enc_str),
            denc.enc_list(inc.removed_pools, denc.enc_i32),
        )
    )


def decode_incremental(buf: bytes, off: int = 0) -> tuple[Incremental, int]:
    v, off = denc.dec_u8(buf, off)
    if v != _V:
        raise denc.DecodeError(f"incremental v{v} unsupported")
    epoch, off = denc.dec_u32(buf, off)
    up, off = denc.dec_list(buf, off, denc.dec_u32)
    down, off = denc.dec_list(buf, off, denc.dec_u32)
    weights, off = denc.dec_map(buf, off, denc.dec_u32, denc.dec_u32)
    pools, off = denc.dec_list(buf, off, _dec_pool)
    _, dec_pg = _PGID
    pg_upmap, off = denc.dec_map(
        buf, off, dec_pg, lambda b, o: denc.dec_list(b, o, denc.dec_i32)
    )

    def dec_pairs(b, o):
        return denc.dec_list(
            b, o,
            lambda b2, o2: (
                (denc.dec_i32(b2, o2)[0], denc.dec_i32(b2, o2 + 4)[0]),
                o2 + 8,
            ),
        )

    items, off = denc.dec_map(buf, off, dec_pg, dec_pairs)
    prims, off = denc.dec_map(buf, off, dec_pg, denc.dec_i32)
    pg_temp, off = denc.dec_map(
        buf, off, dec_pg, lambda b, o: denc.dec_list(b, o, denc.dec_i32)
    )
    ptemp, off = denc.dec_map(buf, off, dec_pg, denc.dec_i32)
    paff, off = denc.dec_map(buf, off, denc.dec_u32, denc.dec_u32)
    bl, off = denc.dec_list(buf, off, denc.dec_str)
    unbl, off = denc.dec_list(buf, off, denc.dec_str)
    rmp, off = denc.dec_list(buf, off, denc.dec_i32)
    return (
        Incremental(
            epoch=epoch, up=up, down=down, weights=weights, new_pools=pools,
            new_pg_upmap=pg_upmap, new_pg_upmap_items=items,
            new_pg_upmap_primaries={
                k: (None if v == -1 else v) for k, v in prims.items()
            },
            new_pg_temp=pg_temp, new_primary_temp=ptemp,
            new_primary_affinity=paff,
            new_blocklist=bl, new_unblocklist=unbl,
            removed_pools=rmp,
        ),
        off,
    )
