"""rados: object CLI + bench against a dev cluster (the src/tools/rados
role, with `bench` playing src/common/obj_bencher.h:64-113).

The cluster is vstart-style in-process; with --data-dir it runs on
durable BlueStoreLite stores, so state persists across invocations:

  rados.py --data-dir /tmp/c1 mkpool rep 3            # replicated size 3
  rados.py --data-dir /tmp/c1 mkpool ecp 5 --ec-k 3 --ec-m 2
  rados.py --data-dir /tmp/c1 put ecp myobj ./file
  rados.py --data-dir /tmp/c1 get ecp myobj -          # to stdout
  rados.py --data-dir /tmp/c1 ls ecp
  rados.py --data-dir /tmp/c1 stat ecp myobj
  rados.py --data-dir /tmp/c1 rm ecp myobj
  rados.py --data-dir /tmp/c1 df
  rados.py bench ecp 5 write --ec-k 3 --ec-m 2 -b 4194304 -t 8
  rados.py bench ecp 5 seq / rand    (reads the objects bench-write left)

Without --data-dir everything runs on MemStore and vanishes on exit
(useful for bench runs, which bring their own pool).

ceph_tpu_torch's own copy of ``tools/rados.py``, run as ``python -m
ceph_tpu_torch.tools.rados``. ``--device`` names where the cluster's
codecs and placement run: the CUDA card when left out (with no card the
cluster raises; it never drops to the CPU), ``--device cpu`` for the
plain versions. An EC pool's writes run K1 and K2 on the card, its
degraded reads K1. A ``--data-dir`` is byte-compatible with the
reference's: either CLI reads what the other wrote.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time

from ..cluster import TestCluster
from ..placement.osdmap import Pool

POOLS_META = "pools.json"  # pool registry, kept beside the stores


def _load_pools(data_dir: str | None) -> dict:
    if not data_dir:
        return {}
    p = os.path.join(data_dir, POOLS_META)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def _save_pools(data_dir: str | None, pools: dict) -> None:
    if data_dir:
        with open(os.path.join(data_dir, POOLS_META), "w") as f:
            json.dump(pools, f)


async def cluster_up(args) -> tuple[TestCluster, dict]:
    kw = {}
    if args.data_dir:
        os.makedirs(args.data_dir, exist_ok=True)
        kw = dict(objectstore="bluestore", data_dir=args.data_dir,
                  size=args.dev_size << 20)
    c = TestCluster(n_osds=args.osds, device=args.device, **kw)
    await c.start()
    c.client.op_timeout = args.timeout
    pools = _load_pools(args.data_dir)
    # re-register pools from the registry (mon state is not durable;
    # PGs re-peer onto the existing store collections)
    for name, spec in pools.items():
        await c.client.create_pool(Pool(**spec))
    if pools:
        await c.wait_active(args.timeout)
    return c, pools


def _pool_id(pools: dict, name: str) -> int:
    if name not in pools:
        raise SystemExit(f"pool '{name}' not found (mkpool first)")
    return pools[name]["id"]


async def cmd_mkpool(args) -> int:
    c, pools = await cluster_up(args)
    try:
        pid = max([p["id"] for p in pools.values()], default=1) + 1
        spec = dict(id=pid, name=args.pool, size=args.size,
                    min_size=max(1, args.size - 1), pg_num=args.pg_num,
                    crush_rule=0, type="replicated")
        if args.ec_k:
            spec.update(
                type="erasure", crush_rule=1,
                size=args.ec_k + args.ec_m,
                min_size=args.ec_k,
                ec_profile={"plugin": args.ec_plugin,
                            "k": str(args.ec_k), "m": str(args.ec_m),
                            "backend": "device"})
        await c.client.create_pool(Pool(**spec))
        await c.wait_active(args.timeout)
        pools[args.pool] = spec
        _save_pools(args.data_dir, pools)
        print(f"pool '{args.pool}' created (id {pid})")
    finally:
        await c.stop()
    return 0


def _parse_snapc(spec: str | None):
    """--snapc 'seq:id,id,...' -> (seq, [ids]) write SnapContext."""
    if not spec:
        return None
    seq_s, _, ids_s = spec.partition(":")
    ids = [int(x) for x in ids_s.split(",") if x]
    return (int(seq_s), ids)


async def cmd_put(args) -> int:
    data = (sys.stdin.buffer.read() if args.infile == "-"
            else open(args.infile, "rb").read())
    c, pools = await cluster_up(args)
    try:
        await c.client.write_full(_pool_id(pools, args.pool),
                                  args.obj.encode(), data,
                                  snapc=_parse_snapc(args.snapc))
    finally:
        await c.stop()
    return 0


async def cmd_get(args) -> int:
    c, pools = await cluster_up(args)
    try:
        data = await c.client.read(_pool_id(pools, args.pool),
                                   args.obj.encode(),
                                   snapid=args.snapid)
    finally:
        await c.stop()
    if args.outfile == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.outfile, "wb") as f:
            f.write(data)
    return 0


async def cmd_rm(args) -> int:
    c, pools = await cluster_up(args)
    try:
        await c.client.delete(_pool_id(pools, args.pool),
                              args.obj.encode())
    finally:
        await c.stop()
    return 0


async def cmd_stat(args) -> int:
    c, pools = await cluster_up(args)
    try:
        size = await c.client.stat(_pool_id(pools, args.pool),
                                   args.obj.encode())
        print(f"{args.pool}/{args.obj} size {size}")
    finally:
        await c.stop()
    return 0


async def cmd_ls(args) -> int:
    c, pools = await cluster_up(args)
    try:
        for oid in await c.client.list_objects(_pool_id(pools, args.pool)):
            print(oid.decode(errors="replace"))
    finally:
        await c.stop()
    return 0


async def cmd_snap_create(args) -> int:
    c, pools = await cluster_up(args)
    try:
        snapid = await c.client.selfmanaged_snap_create(
            _pool_id(pools, args.pool))
        print(f"created snap {snapid} in pool '{args.pool}'")
    finally:
        await c.stop()
    return 0


async def cmd_snap_rm(args) -> int:
    c, pools = await cluster_up(args)
    try:
        await c.client.selfmanaged_snap_remove(
            _pool_id(pools, args.pool), args.snapid)
        print(f"removed snap {args.snapid} from pool '{args.pool}' "
              "(trimming is asynchronous)")
    finally:
        await c.stop()
    return 0


async def cmd_df(args) -> int:
    c, pools = await cluster_up(args)
    try:
        print(f"{'POOL':<16}{'ID':>4}{'OBJECTS':>9}{'BYTES':>14}")
        for name, spec in sorted(pools.items()):
            oids = await c.client.list_objects(spec["id"])
            total = 0
            for oid in oids:
                total += await c.client.stat(spec["id"], oid)
            print(f"{name:<16}{spec['id']:>4}{len(oids):>9}{total:>14}")
    finally:
        await c.stop()
    return 0


async def cmd_bench(args) -> int:
    """obj_bencher role: timed write / seq-read / rand-read with
    throughput and latency stats."""
    import random

    c, pools = await cluster_up(args)
    try:
        if args.pool in pools:
            pid = pools[args.pool]["id"]
        else:  # bench brings its own pool (rados bench convention)
            args.size = (args.ec_k + args.ec_m) if args.ec_k else 3
            args.pg_num = 16
            pid = max([p["id"] for p in pools.values()], default=1) + 1
            spec = dict(id=pid, name=args.pool, size=args.size,
                        min_size=max(1, args.size - 1), pg_num=16,
                        crush_rule=0, type="replicated")
            if args.ec_k:
                spec.update(type="erasure", crush_rule=1,
                            min_size=args.ec_k,
                            ec_profile={"plugin": args.ec_plugin,
                                        "k": str(args.ec_k),
                                        "m": str(args.ec_m),
                                        "backend": "device"})
            await c.client.create_pool(Pool(**spec))
            await c.wait_active(args.timeout)
            pools[args.pool] = spec
            _save_pools(args.data_dir, pools)

        lat: list[float] = []
        done = 0
        bytes_done = 0
        deadline = time.perf_counter() + args.seconds
        sem = asyncio.Semaphore(args.concurrency)
        payload = os.urandom(args.block_size)

        t_start = time.perf_counter()
        if args.mode == "write":
            async def one(i: int):
                nonlocal done, bytes_done
                async with sem:
                    t0 = time.perf_counter()
                    await c.client.write_full(pid, b"bench_%d" % i, payload)
                    lat.append(time.perf_counter() - t0)
                    done += 1
                    bytes_done += len(payload)

            i = 0
            pending: set = set()
            while time.perf_counter() < deadline:
                while len(pending) < args.concurrency:
                    pending.add(asyncio.ensure_future(one(i)))
                    i += 1
                fin, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for f in fin:
                    f.result()
            if pending:
                await asyncio.gather(*pending)
        else:  # seq / rand read over whatever bench_ objects exist
            objs = [o for o in await c.client.list_objects(pid)
                    if o.startswith(b"bench_")]
            if not objs:
                raise SystemExit("no bench_ objects; run bench write first")

            async def rd(oid: bytes):
                nonlocal done, bytes_done
                async with sem:
                    t0 = time.perf_counter()
                    data = await c.client.read(pid, oid)
                    lat.append(time.perf_counter() - t0)
                    done += 1
                    bytes_done += len(data)

            # listing is setup, not benched work: restart the clock
            t_start = time.perf_counter()
            deadline = t_start + args.seconds
            pending = set()
            i = 0
            while time.perf_counter() < deadline:
                oid = (random.choice(objs) if args.mode == "rand"
                       else objs[i % len(objs)])
                i += 1
                while len(pending) >= args.concurrency:
                    fin, pending = await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED)
                    for f in fin:
                        f.result()
                pending.add(asyncio.ensure_future(rd(oid)))
            if pending:
                await asyncio.gather(*pending)

        # actual elapsed, incl. the post-deadline drain (obj_bencher
        # divides by wall time, not the nominal window)
        secs = max(time.perf_counter() - t_start, 1e-9)
        lat.sort()
        out = {
            "mode": args.mode,
            "seconds": round(secs, 3),
            "ops": done,
            "bytes": bytes_done,
            "mb_per_sec": round(bytes_done / secs / 2**20, 2),
            "iops": round(done / secs, 2),
            "avg_lat_ms": round(sum(lat) / len(lat) * 1e3, 2) if lat else 0,
            "p50_lat_ms": round(lat[len(lat) // 2] * 1e3, 2) if lat else 0,
            "p99_lat_ms": (round(lat[int(len(lat) * 0.99)] * 1e3, 2)
                           if lat else 0),
            "max_lat_ms": round(lat[-1] * 1e3, 2) if lat else 0,
        }
        print(json.dumps(out))
    finally:
        await c.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", help="durable cluster state dir "
                    "(BlueStoreLite per OSD); omit for throwaway MemStore")
    ap.add_argument("--osds", type=int, default=5)
    ap.add_argument("--dev-size", type=int, default=256,
                    help="per-OSD block device MiB (default 256)")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the cluster's codecs and "
                         "placement (default: the CUDA card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mkpool")
    p.add_argument("pool")
    p.add_argument("size", type=int, nargs="?", default=3)
    p.add_argument("--pg-num", type=int, default=16)
    p.add_argument("--ec-k", type=int, default=0)
    p.add_argument("--ec-m", type=int, default=2)
    p.add_argument("--ec-plugin", default="rs_tpu")
    p.set_defaults(fn=cmd_mkpool)

    p = sub.add_parser("put")
    p.add_argument("pool"), p.add_argument("obj"), p.add_argument("infile")
    p.add_argument("--snapc", default=None,
                   help="write SnapContext 'seq:id,id,...'")
    p.set_defaults(fn=cmd_put)

    p = sub.add_parser("get")
    p.add_argument("pool"), p.add_argument("obj"), p.add_argument("outfile")
    p.add_argument("--snapid", type=int, default=None,
                   help="read at this selfmanaged snap id")
    p.set_defaults(fn=cmd_get)

    p = sub.add_parser("snap-create")
    p.add_argument("pool")
    p.set_defaults(fn=cmd_snap_create)

    p = sub.add_parser("snap-rm")
    p.add_argument("pool"), p.add_argument("snapid", type=int)
    p.set_defaults(fn=cmd_snap_rm)

    p = sub.add_parser("rm")
    p.add_argument("pool"), p.add_argument("obj")
    p.set_defaults(fn=cmd_rm)

    p = sub.add_parser("stat")
    p.add_argument("pool"), p.add_argument("obj")
    p.set_defaults(fn=cmd_stat)

    p = sub.add_parser("ls")
    p.add_argument("pool")
    p.set_defaults(fn=cmd_ls)

    p = sub.add_parser("df")
    p.set_defaults(fn=cmd_df)

    p = sub.add_parser("bench")
    p.add_argument("pool")
    p.add_argument("seconds", type=int)
    p.add_argument("mode", choices=["write", "seq", "rand"])
    p.add_argument("-b", "--block-size", type=int, default=4 << 20)
    p.add_argument("-t", "--concurrency", type=int, default=16)
    p.add_argument("--ec-k", type=int, default=0)
    p.add_argument("--ec-m", type=int, default=2)
    p.add_argument("--ec-plugin", default="rs_tpu")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return asyncio.run(args.fn(args))


if __name__ == "__main__":
    # head-friendly CLI: a closed stdout pipe is a normal exit. Set
    # only when run as a program — at import time this would strip
    # the hosting process (e.g. pytest) of CPython's SIGPIPE ignore
    # and a later write to any dead socket would kill it (exit 141).
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
