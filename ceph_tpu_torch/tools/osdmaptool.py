"""osdmaptool: inspect/build osdmaps, map objects, test PG distribution
(src/tools/osdmaptool.cc role).

  osdmaptool.py --createsimple 12 -o osdmap.bin [--pg-num 128]
  osdmaptool.py --print osdmap.bin
  osdmaptool.py --test-map-pgs osdmap.bin [--pool 1]
  osdmaptool.py --test-map-object foo --pool 1 osdmap.bin

ceph_tpu_torch's own copy of ``tools/osdmaptool.py``, run as
``python -m ceph_tpu_torch.tools.osdmaptool``. The map's placement runs
on the host oracle, as in the reference: it takes no device.
"""
from __future__ import annotations

import argparse
import signal
import sys

from ..placement import crushmap as cm
from ..placement import encoding as menc
from ..placement.osdmap import OSDMap, Pool


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mapfile", nargs="?")
    ap.add_argument("--createsimple", type=int, metavar="N")
    ap.add_argument("--pg-num", type=int, default=128)
    ap.add_argument("-o", metavar="OUT")
    ap.add_argument("--print", dest="print_", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--test-map-object", metavar="NAME")
    ap.add_argument("--pool", type=int, default=1)
    args = ap.parse_args(argv)

    if args.createsimple:
        n = args.createsimple
        crush = cm.build_flat(n)
        crush.add_rule(cm.flat_firstn_rule(0))
        m = OSDMap(crush, n)
        m.add_pool(Pool(id=1, name="rbd", size=3, pg_num=args.pg_num,
                        crush_rule=0))
        out = args.o or "osdmap.bin"
        open(out, "wb").write(menc.encode_osdmap(m))
        print(f"osdmaptool: wrote {n}-osd map, pool 'rbd' "
              f"pg_num {args.pg_num} -> {out}")
        return 0

    if not args.mapfile:
        ap.error("need a mapfile (or --createsimple)")
    m, _ = menc.decode_osdmap(open(args.mapfile, "rb").read())

    if args.print_:
        print(f"epoch {m.epoch}")
        print(f"max_osd {m.n_osds}")
        for p in m.pools.values():
            print(f"pool {p.id} '{p.name}' {p.type} size {p.size} "
                  f"pg_num {p.pg_num} crush_rule {p.crush_rule}")
        ups = sum(1 for o in m.osds if o.up)
        print(f"osds: {ups} up / {m.n_osds} total")
        return 0

    if args.test_map_pgs:
        pool = m.pools[args.pool]
        counts: dict[int, int] = {}
        for ps in range(pool.pg_num):
            up, primary = m.pg_to_up_acting_osds((pool.id, ps))
            for o in up:
                if 0 <= o < m.n_osds:
                    counts[o] = counts.get(o, 0) + 1
        total = sum(counts.values())
        avg = total / max(len(counts), 1)
        print(f"pool {pool.id} pg_num {pool.pg_num}: {total} mappings "
              f"over {len(counts)} osds, avg {avg:.1f}")
        worst = max(counts.values()) / avg if counts else 0
        print(f"max/avg ratio {worst:.3f}")
        for o in sorted(counts):
            print(f"  osd.{o}\t{counts[o]}")
        return 0

    if args.test_map_object:
        oid = args.test_map_object.encode()
        pg = m.object_to_pg(args.pool, oid)
        up, primary = m.pg_to_up_acting_osds(pg)
        print(f"object '{args.test_map_object}' -> pg {pg[0]}.{pg[1]:x}"
              f" -> up {up} primary {primary}")
        return 0

    ap.print_help()
    return 2


if __name__ == "__main__":
    # head-friendly CLI: a closed stdout pipe is a normal exit. Set
    # only when run as a program — at import time this would strip
    # the hosting process (e.g. pytest) of CPython's SIGPIPE ignore
    # and a later write to any dead socket would kill it (exit 141).
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
