"""ceph-objectstore-tool: offline store surgery (src/tools/
ceph_objectstore_tool.cc role). Operates directly on an OSD's store
directory while the OSD is down.

  objectstore_tool.py --data-path /tmp/c1/osd.0 --op list
  objectstore_tool.py --data-path /tmp/c1/osd.0 --op list --pgid 2.3
  objectstore_tool.py --data-path /tmp/c1/osd.0 --op info  --pgid 2.3
  objectstore_tool.py --data-path /tmp/c1/osd.0 --op export --pgid 2.3 \
                      --file pg.export
  objectstore_tool.py --data-path /tmp/c1/osd.1 --op import --file pg.export
  objectstore_tool.py --data-path /tmp/c1/osd.0 --op remove --pgid 2.3
  objectstore_tool.py --data-path /tmp/c1/osd.0 --op get-bytes \
                      --pgid 2.3 --obj myobj --file out.bin

The export format is a denc blob (magic, pgid, objects with data,
xattrs, omap) with a trailing CRC32C; import replays it as one
transaction. Works on both store flavors (BlueStoreLite: pass
--type bluestore, default; WalStore: --type walstore).

ceph_tpu_torch's own copy of ``tools/objectstore_tool.py`` over the
port's ``store/`` and C++ host core, run as ``python -m
ceph_tpu_torch.tools.objectstore_tool``. Host only: it takes no device.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys

import numpy as np

from .. import native
from .. import store as store_mod
from ..store import transaction as tx
from ..utils import denc

EXPORT_MAGIC = 0x43455850  # "CEXP"


def open_store(args):
    return store_mod.create(args.type, args.data_path)


def coll_for(pgid: str) -> str:
    return pgid


def cmd_list(args, s) -> int:
    cols = [args.pgid] if args.pgid else s.list_collections()
    for cid in cols:
        for oid in s.list_objects(cid):
            print(json.dumps([cid, oid.decode(errors="replace")]))
    return 0


def cmd_info(args, s) -> int:
    cid = coll_for(args.pgid)
    oids = s.list_objects(cid)
    total = sum(s.stat(cid, o) for o in oids)
    print(json.dumps({"pgid": args.pgid, "objects": len(oids),
                      "bytes": total}))
    return 0


def cmd_export(args, s) -> int:
    cid = coll_for(args.pgid)
    parts = [denc.enc_u32(EXPORT_MAGIC), denc.enc_str(cid)]
    oids = s.list_objects(cid)
    parts.append(denc.enc_u32(len(oids)))
    for oid in oids:
        parts.append(denc.enc_bytes(oid))
        parts.append(denc.enc_bytes(bytes(s.read(cid, oid))))
        parts.append(denc.enc_map(s.getattrs(cid, oid),
                                  denc.enc_str, denc.enc_bytes))
        parts.append(denc.enc_map(s.omap_get(cid, oid),
                                  denc.enc_bytes, denc.enc_bytes))
        parts.append(denc.enc_bytes(s.omap_get_header(cid, oid)))
    blob = b"".join(parts)
    blob += denc.enc_u32(native.crc32c(np.frombuffer(blob, np.uint8)))
    with open(args.file, "wb") as f:
        f.write(blob)
    print(f"exported {len(oids)} objects from {cid} "
          f"({len(blob)} bytes)")
    return 0


def cmd_import(args, s) -> int:
    blob = open(args.file, "rb").read()
    body, want = blob[:-4], denc.dec_u32(blob, len(blob) - 4)[0]
    got = native.crc32c(np.frombuffer(body, np.uint8))
    if got != want:
        raise SystemExit(f"export file corrupt: crc {got:#x} != {want:#x}")
    magic, off = denc.dec_u32(body, 0)
    if magic != EXPORT_MAGIC:
        raise SystemExit("not an export file")
    cid, off = denc.dec_str(body, off)
    n, off = denc.dec_u32(body, off)
    if cid in s.list_collections():
        # merging under an existing PG would leave its log (_pgmeta)
        # inconsistent with the union of contents; the reference tool
        # refuses the same way
        raise SystemExit(
            f"collection {cid} already exists; --op remove it first")
    t = tx.Transaction()
    t.create_collection(cid)
    for _ in range(n):
        oid, off = denc.dec_bytes(body, off)
        data, off = denc.dec_bytes(body, off)
        xattrs, off = denc.dec_map(body, off, denc.dec_str, denc.dec_bytes)
        omap, off = denc.dec_map(body, off, denc.dec_bytes, denc.dec_bytes)
        hdr, off = denc.dec_bytes(body, off)
        t.touch(cid, oid)
        t.truncate(cid, oid, 0)
        if data:
            t.write(cid, oid, 0, data)
        if xattrs:
            t.setattrs(cid, oid, xattrs)
        if omap:
            t.omap_setkeys(cid, oid, omap)
        if hdr:
            t.omap_setheader(cid, oid, hdr)
    s.apply_transaction(t)
    print(f"imported {n} objects into {cid}")
    return 0


def cmd_remove(args, s) -> int:
    cid = coll_for(args.pgid)
    t = tx.Transaction()
    for oid in s.list_objects(cid):
        t.remove(cid, oid)
    t.remove_collection(cid)
    s.apply_transaction(t)
    print(f"removed {cid}")
    return 0


def cmd_get_bytes(args, s) -> int:
    data = bytes(s.read(coll_for(args.pgid), args.obj.encode()))
    if args.file == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.file, "wb") as f:
            f.write(data)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--type", default="bluestore",
                    choices=["bluestore", "walstore", "filestore"])
    ap.add_argument("--op", required=True,
                    choices=["list", "info", "export", "import",
                             "remove", "get-bytes"])
    ap.add_argument("--pgid")
    ap.add_argument("--obj")
    ap.add_argument("--file")
    args = ap.parse_args(argv)
    if args.op in ("info", "export", "remove", "get-bytes") \
            and not args.pgid:
        ap.error(f"--op {args.op} requires --pgid")
    if args.op in ("export", "import", "get-bytes") and not args.file:
        ap.error(f"--op {args.op} requires --file")
    s = open_store(args)
    try:
        fn = {
            "list": cmd_list, "info": cmd_info, "export": cmd_export,
            "import": cmd_import, "remove": cmd_remove,
            "get-bytes": cmd_get_bytes,
        }[args.op]
        return fn(args, s)
    finally:
        s.umount()


if __name__ == "__main__":
    # head-friendly CLI: a closed stdout pipe is a normal exit. Set
    # only when run as a program — at import time this would strip
    # the hosting process (e.g. pytest) of CPython's SIGPIPE ignore
    # and a later write to any dead socket would kill it (exit 141).
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
