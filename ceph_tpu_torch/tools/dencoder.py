"""dencoder: encode/decode framework wire types (the
src/tools/ceph-dencoder role): list types, round-trip check, hex dump.

  dencoder.py list
  dencoder.py dump <TypeName> <hexfile|->       # decode + pretty-print
  dencoder.py selftest                          # round-trip every type

ceph_tpu_torch's own copy of ``tools/dencoder.py`` over the port's
``msg/`` and cluster messages, run as ``python -m
ceph_tpu_torch.tools.dencoder``. Host only: it takes no device.
"""
from __future__ import annotations

import sys

from ..cluster import messages as M
from ..msg.messages import _REGISTRY


def _samples() -> dict[str, object]:
    """One representative instance per message type (the corpus role)."""
    pg = (1, 3)
    ver = (2, 7)
    return {
        "MOSDBoot": M.MOSDBoot(osd=3),
        "MMonGetMap": M.MMonGetMap(have=5),
        "MOSDMapMsg": M.MOSDMapMsg(full=b"F" * 8, incrementals=[b"i1"],
                                   epoch=9),
        "MPing": M.MPing(osd=1, epoch=4),
        "MMonSubscribe": M.MMonSubscribe(what="osdmap"),
        "MFailure": M.MFailure(target=2, reporter="osd.1"),
        "MPoolCreate": M.MPoolCreate(pool=b"P" * 16),
        "MPoolCreateReply": M.MPoolCreateReply(pool_id=1, epoch=2),
        "MOSDOp": M.MOSDOp(tid=1, pgid=pg, oid=b"obj",
                           ops=[M.osd_op("read"),
                                M.osd_op("setxattr", key=b"k",
                                         data=b"v")],
                           epoch=3),
        "MOSDOpReply": M.MOSDOpReply(tid=1, result=0, data=b"d", size=1,
                                     outs=[(0, b"d")], epoch=3),
        "MOSDRepOp": M.MOSDRepOp(tid=2, pgid=pg, txn=b"T", entry=b"E",
                                 epoch=3),
        "MOSDRepOpReply": M.MOSDRepOpReply(tid=2, pgid=pg, result=0,
                                           osd=1),
        "MECSubWrite": M.MECSubWrite(tid=3, pgid=pg, shard=2, txn=b"T",
                                     entry=b"E", epoch=3),
        "MECSubWriteReply": M.MECSubWriteReply(tid=3, pgid=pg, shard=2,
                                               result=0),
        "MECSubRead": M.MECSubRead(tid=4, pgid=pg, shard=1, oid=b"o",
                                   offset=0, length=-1),
        "MECSubReadReply": M.MECSubReadReply(tid=4, pgid=pg, shard=1,
                                             result=0, data=b"c",
                                             digest=7, size=1,
                                             attrs={"u:k": b"v"}),
        "MPGInfoReq": M.MPGInfoReq(pgid=pg, epoch=3, shard=0),
        "MPGInfoReply": M.MPGInfoReply(pgid=pg, epoch=3, shard=0,
                                       info=b"I"),
        "MPushOp": M.MPushOp(pgid=pg, shard=0, oid=b"o", version=ver,
                             data=b"D", attrs={"v": b"x"}, epoch=3,
                             last_update=ver),
        "MPushReply": M.MPushReply(pgid=pg, shard=0, oid=b"o", result=0),
        "MPull": M.MPull(pgid=pg, shard=0, oid=b"o", epoch=3),
        "MPGScan": M.MPGScan(pgid=pg, shard=0, epoch=3),
        "MPGScanReply": M.MPGScanReply(pgid=pg, shard=0,
                                       objects={b"o": ver}),
        "MScrub": M.MScrub(pgid=pg, shard=0, epoch=3, tid=9),
        "MScrubReply": M.MScrubReply(pgid=pg, shard=0, tid=9,
                                     objects={b"o": (ver, (10, 0xAB))},
                                     errors=[b"bad"]),
    }


def cmd_list() -> int:
    for t, cls in sorted(_REGISTRY.items()):
        print(f"{t}\t{cls.__name__}")
    # non-message denc types
    print("-\tTransaction (store)")
    print("-\tPGLog / PGInfo / Entry (cluster)")
    print("-\tCrushMap / OSDMap / Incremental (placement)")
    return 0


def cmd_selftest() -> int:
    samples = _samples()
    missing = [cls.__name__ for cls in _REGISTRY.values()
               if cls.__name__ not in samples]
    if missing:
        print(f"NO SAMPLE for {missing}", file=sys.stderr)
        return 1
    bad = 0
    for name, msg in samples.items():
        blob = msg.encode()
        back = type(msg).decode(blob)
        if back != msg:
            print(f"ROUNDTRIP FAILED: {name}", file=sys.stderr)
            bad += 1
        else:
            print(f"ok {name} ({len(blob)}B)")
    # the non-message families
    from ..cluster.pglog import OP_MODIFY, Entry, PGLog
    from ..store.transaction import Transaction

    t = Transaction().create_collection("c")
    t.write("c", b"o", 0, b"data")
    t2, _ = Transaction.decode(t.encode())
    print("ok Transaction" if t2.encode() == t.encode()
          else "ROUNDTRIP FAILED: Transaction")
    log = PGLog()
    log.append(Entry(OP_MODIFY, b"o", (1, 1)))
    log2, _ = PGLog.decode(log.encode())
    print("ok PGLog" if log2.encode() == log.encode()
          else "ROUNDTRIP FAILED: PGLog")
    return 1 if bad else 0


def cmd_dump(type_name: str, path: str) -> int:
    cls = next(
        (c for c in _REGISTRY.values() if c.__name__ == type_name), None
    )
    if cls is None:
        print(f"unknown type {type_name!r}", file=sys.stderr)
        return 1
    raw = sys.stdin.buffer.read() if path == "-" else \
        open(path, "rb").read()
    try:
        blob = bytes.fromhex(raw.decode().strip())
    except (UnicodeDecodeError, ValueError):
        blob = raw  # already binary
    msg = cls.decode(blob)
    print(repr(msg))
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "list":
        return cmd_list()
    if argv[0] == "selftest":
        return cmd_selftest()
    if argv[0] == "dump" and len(argv) == 3:
        return cmd_dump(argv[1], argv[2])
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
