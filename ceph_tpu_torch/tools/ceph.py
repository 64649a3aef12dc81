"""ceph: the cluster admin CLI (the src/ceph.in + MonCommands.h role).

Commands are NOT parsed here: argv is matched against the descriptor
table the mon itself serves (get_command_descriptions), exactly the
reference's validate_command stance — the CLI stays dumb and the
command surface lives with the daemon that executes it.

Runs against a vstart-style in-process cluster; with --data-dir state
persists across invocations on BlueStoreLite (same convention as
tools/rados.py):

  ceph.py status
  ceph.py -f json df
  ceph.py osd tree
  ceph.py osd pool create mypool 32 replicated 3
  ceph.py osd pool set mypool quota_max_objects 1000
  ceph.py osd out 2
  ceph.py config set osd debug_level 5

ceph_tpu_torch's own copy of ``tools/ceph.py``, run as ``python -m
ceph_tpu_torch.tools.ceph``. ``--device`` names where the cluster's
codecs and placement run: the CUDA card when left out (with no card the
cluster raises; it never drops to the CPU), ``--device cpu`` for the
plain versions.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from ..cluster import TestCluster


async def main_async(args) -> int:
    kw = {}
    if args.data_dir:
        os.makedirs(args.data_dir, exist_ok=True)
        kw = dict(objectstore="bluestore", data_dir=args.data_dir,
                  size=args.dev_size << 20)
    c = TestCluster(n_osds=args.osds, device=args.device, **kw)
    await c.start()
    try:
        # for stats-backed commands, wait for one round of OSD
        # reports -> mgr digest -> mon to land (hb + 1 s digest tick)
        if args.command[0] in ("status", "df", "pg", "health"):
            for _ in range(40):
                if c.mon.mgr_digest.get("pg_states"):
                    break
                await asyncio.sleep(0.1)
        rc, outs, outb = await c.client.mon_command(args.command)
        if args.format == "json":
            print(outb.decode() if outb else "{}")
        else:
            if outs:
                print(outs)
            elif outb:
                print(outb.decode())
        if rc != 0:
            print(f"Error: {rc}", file=sys.stderr)
        return 0 if rc == 0 else 1
    finally:
        await c.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None,
                    help="durable cluster state dir (BlueStoreLite)")
    ap.add_argument("--osds", type=int, default=3)
    ap.add_argument("--dev-size", type=int, default=256,
                    help="per-OSD device MiB (durable mode)")
    ap.add_argument("--device", default=None,
                    help="torch device of the cluster's codecs and "
                         "placement (default: the CUDA card)")
    ap.add_argument("-f", "--format", choices=("plain", "json"),
                    default="plain")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="mon command words (e.g. osd tree)")
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given (try: status)")
    return asyncio.run(main_async(args))


if __name__ == "__main__":
    raise SystemExit(main())
