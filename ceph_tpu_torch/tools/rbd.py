"""rbd: block-image CLI against a dev cluster (the src/tools/rbd
role). Runs vstart-style in-process; with --data-dir images persist on
durable BlueStoreLite stores across invocations:

  rbd.py --data-dir /tmp/c1 mkpool rbd 3
  rbd.py --data-dir /tmp/c1 create rbd/disk --size 64M
  rbd.py --data-dir /tmp/c1 ls rbd
  rbd.py --data-dir /tmp/c1 info rbd/disk
  rbd.py --data-dir /tmp/c1 import rbd/disk ./disk.img
  rbd.py --data-dir /tmp/c1 export rbd/disk ./out.img
  rbd.py --data-dir /tmp/c1 snap create rbd/disk@s1
  rbd.py --data-dir /tmp/c1 clone rbd/disk@s1 rbd/child
  rbd.py --data-dir /tmp/c1 flatten rbd/child
  rbd.py --data-dir /tmp/c1 cp rbd/disk rbd/copy        # deep copy
  rbd.py --data-dir /tmp/c1 resize rbd/disk --size 128M
  rbd.py --data-dir /tmp/c1 encryption format rbd/disk pass.txt
  rbd.py --data-dir /tmp/c1 export rbd/disk out.img --passphrase-file pass.txt
  rbd.py --data-dir /tmp/c1 migration prepare rbd/disk rbd/disk2
  rbd.py --data-dir /tmp/c1 migration execute rbd/disk2
  rbd.py --data-dir /tmp/c1 migration commit rbd/disk2
  rbd.py --data-dir /tmp/c1 rm rbd/disk

ceph_tpu_torch's own copy of ``tools/rbd.py``, run as ``python -m
ceph_tpu_torch.tools.rbd``; it shares the port's ``rados`` CLI's
cluster and pool registry (the reference loads ``tools/rados.py`` by
path). ``--device`` names where the cluster's codecs and placement run:
the CUDA card when left out (with no card the cluster raises; it never
drops to the CPU), ``--device cpu`` for the plain versions.
"""
from __future__ import annotations

import argparse
import asyncio
import sys

from ..osdc.striper import FileLayout
from ..services.rbd import RBD
from ..services import rbd_crypto
from . import rados as _rados  # shared cluster_up/pool registry


def _size(s: str) -> int:
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}
    if s and s[-1].upper() in mult:
        return int(float(s[:-1]) * mult[s[-1].upper()])
    return int(s)


def _split(spec: str) -> tuple[str, str, str | None]:
    """pool/image[@snap] -> (pool, image, snap)."""
    if "/" not in spec:
        raise SystemExit(f"image spec {spec!r} must be pool/name")
    pool, _, rest = spec.partition("/")
    name, _, snap = rest.partition("@")
    return pool, name, snap or None


async def _open_ctx(args, spec: str):
    c, pools = await _rados.cluster_up(args)
    pool, name, snap = _split(spec)
    return c, RBD(c.client, _rados._pool_id(pools, pool)), name, snap


def _passphrase(args) -> str | None:
    pf = getattr(args, "passphrase_file", None)
    if not pf:
        return None
    with open(pf) as f:
        return f.read().strip()


async def _image_handle(rbd: RBD, name: str, snap, args):
    """Plain or decrypting handle, by --passphrase-file."""
    pw = _passphrase(args)
    if pw is None:
        return await rbd.open(name, snap=snap)
    return await rbd_crypto.open_encrypted(rbd, name, pw, snap=snap)


async def cmd_create(args) -> int:
    c, rbd, name, _ = await _open_ctx(args, args.image)
    try:
        layout = FileLayout(stripe_unit=args.stripe_unit,
                            stripe_count=args.stripe_count,
                            object_size=args.object_size)
        await rbd.create(name, _size(args.size), layout)
        print(f"image '{name}' created ({_size(args.size)} bytes)")
    finally:
        await c.stop()
    return 0


async def cmd_ls(args) -> int:
    c, pools = await _rados.cluster_up(args)
    try:
        rbd = RBD(c.client, _rados._pool_id(pools, args.pool))
        for n in await rbd.list():
            print(n)
    finally:
        await c.stop()
    return 0


async def cmd_info(args) -> int:
    c, rbd, name, snap = await _open_ctx(args, args.image)
    try:
        img = await rbd.open(name, snap=snap)
        st = await img.stat()
        for k, v in st.items():
            print(f"{k}: {v}")
        await img.release_lock()
    finally:
        await c.stop()
    return 0


async def cmd_rm(args) -> int:
    c, rbd, name, _ = await _open_ctx(args, args.image)
    try:
        await rbd.remove(name)
        print(f"image '{name}' removed")
    finally:
        await c.stop()
    return 0


async def cmd_resize(args) -> int:
    c, rbd, name, _ = await _open_ctx(args, args.image)
    try:
        img = await _image_handle(rbd, name, None, args)
        await img.resize(_size(args.size))
        await img.release_lock()
        print(f"resized to {_size(args.size)}")
    finally:
        await c.stop()
    return 0


async def cmd_import(args) -> int:
    c, rbd, name, _ = await _open_ctx(args, args.image)
    try:
        img = await _image_handle(rbd, name, None, args)
        total = 0
        step = 4 << 20
        with open(args.infile, "rb") as f:  # constant-memory chunks
            while chunk := f.read(step):
                await img.write(total, chunk)
                total += len(chunk)
        await img.release_lock()
        print(f"imported {total} bytes into '{name}'")
    finally:
        await c.stop()
    return 0


async def cmd_export(args) -> int:
    c, rbd, name, snap = await _open_ctx(args, args.image)
    try:
        img = await _image_handle(rbd, name, snap, args)
        out = (sys.stdout.buffer if args.outfile == "-"
               else open(args.outfile, "wb"))
        step = 4 << 20
        for off in range(0, img.size, step):
            out.write(await img.read(off, min(step, img.size - off)))
        if out is not sys.stdout.buffer:
            out.close()
        await img.release_lock()
    finally:
        await c.stop()
    return 0


async def cmd_snap(args) -> int:
    if args.snap_cmd != "ls" and "@" not in args.image:
        raise SystemExit(
            f"snap {args.snap_cmd} needs pool/name@snap")
    c, rbd, name, snap = await _open_ctx(args, args.image)
    try:
        img = await rbd.open(name)
        if args.snap_cmd == "create":
            await img.snap_create(snap)
            print(f"snap '{snap}' created")
        elif args.snap_cmd == "ls":
            for s in await img.snap_list():
                print(s)
        elif args.snap_cmd == "rm":
            await img.snap_remove(snap)
            print(f"snap '{snap}' removed")
        elif args.snap_cmd == "rollback":
            await img.snap_rollback(snap)
            print(f"rolled back to '{snap}'")
        await img.release_lock()
    finally:
        await c.stop()
    return 0


async def cmd_clone(args) -> int:
    c, pools = await _rados.cluster_up(args)
    try:
        ppool, parent, snap = _split(args.parent)
        cpool, child, _ = _split(args.child)
        if ppool != cpool:
            raise SystemExit("clone must stay within one pool")
        if snap is None:
            raise SystemExit("clone needs parent@snap")
        rbd = RBD(c.client, _rados._pool_id(pools, ppool))
        await rbd.clone(parent, snap, child)
        print(f"cloned '{args.parent}' -> '{child}'")
    finally:
        await c.stop()
    return 0


async def cmd_flatten(args) -> int:
    c, rbd, name, _ = await _open_ctx(args, args.image)
    try:
        img = await rbd.open(name)
        await img.flatten()
        await img.release_lock()
        print(f"'{name}' flattened")
    finally:
        await c.stop()
    return 0


async def cmd_cp(args) -> int:
    c, pools = await _rados.cluster_up(args)
    try:
        spool, src, _ = _split(args.src)
        dpool, dst, _ = _split(args.dst)
        if spool != dpool:
            raise SystemExit("cp must stay within one pool")
        rbd = RBD(c.client, _rados._pool_id(pools, spool))
        await rbd.deep_copy(src, dst)
        print(f"copied '{src}' -> '{dst}'")
    finally:
        await c.stop()
    return 0


async def cmd_migration(args) -> int:
    c, pools = await _rados.cluster_up(args)
    try:
        if args.mig_cmd == "prepare":
            if not args.dst:
                raise SystemExit("migration prepare needs src AND dst")
            pool, src, _ = _split(args.src)
            _p2, dst, _ = _split(args.dst)
            rbd = RBD(c.client, _rados._pool_id(pools, pool))
            await rbd.migration_prepare(src, dst)
            print(f"migration prepared: '{src}' -> '{dst}'")
        else:
            pool, dst, _ = _split(args.src)
            rbd = RBD(c.client, _rados._pool_id(pools, pool))
            await getattr(rbd, f"migration_{args.mig_cmd}")(dst)
            print(f"migration {args.mig_cmd}: '{dst}'")
    finally:
        await c.stop()
    return 0


async def cmd_encryption(args) -> int:
    c, rbd, name, _ = await _open_ctx(args, args.image)
    try:
        with open(args.passfile) as f:
            pw = f.read().strip()
        await rbd_crypto.encryption_format(rbd, name, pw)
        print(f"'{name}' encryption-formatted")
    finally:
        await c.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir")
    ap.add_argument("--osds", type=int, default=4)
    ap.add_argument("--dev-size", type=int, default=256)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the cluster's codecs and "
                         "placement (default: the CUDA card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mkpool")  # delegates to the rados tool
    p.add_argument("pool")
    p.add_argument("size", type=int, nargs="?", default=3)
    p.add_argument("--pg-num", type=int, default=16)
    p.add_argument("--ec-k", type=int, default=0)
    p.add_argument("--ec-m", type=int, default=2)
    p.add_argument("--ec-plugin", default="rs_tpu")
    p.set_defaults(fn=_rados.cmd_mkpool)

    p = sub.add_parser("create")
    p.add_argument("image")
    p.add_argument("--size", required=True, help="e.g. 64M")
    p.add_argument("--stripe-unit", type=int, default=1 << 16)
    p.add_argument("--stripe-count", type=int, default=4)
    p.add_argument("--object-size", type=int, default=1 << 22)
    p.set_defaults(fn=cmd_create)

    p = sub.add_parser("ls")
    p.add_argument("pool")
    p.set_defaults(fn=cmd_ls)

    for n, fn in (("info", cmd_info), ("rm", cmd_rm),
                  ("flatten", cmd_flatten)):
        p = sub.add_parser(n)
        p.add_argument("image")
        p.set_defaults(fn=fn)

    p = sub.add_parser("resize")
    p.add_argument("image")
    p.add_argument("--size", required=True)
    p.add_argument("--passphrase-file")
    p.set_defaults(fn=cmd_resize)

    p = sub.add_parser("import")
    p.add_argument("image"), p.add_argument("infile")
    p.add_argument("--passphrase-file")
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("export")
    p.add_argument("image"), p.add_argument("outfile")
    p.add_argument("--passphrase-file")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("snap")
    p.add_argument("snap_cmd",
                   choices=["create", "ls", "rm", "rollback"])
    p.add_argument("image", help="pool/name@snap (ls: pool/name)")
    p.set_defaults(fn=cmd_snap)

    p = sub.add_parser("clone")
    p.add_argument("parent", help="pool/name@snap")
    p.add_argument("child", help="pool/name")
    p.set_defaults(fn=cmd_clone)

    p = sub.add_parser("cp")
    p.add_argument("src"), p.add_argument("dst")
    p.set_defaults(fn=cmd_cp)

    p = sub.add_parser("migration")
    p.add_argument("mig_cmd",
                   choices=["prepare", "execute", "commit", "abort"])
    p.add_argument("src", help="pool/src (prepare) or pool/dst")
    p.add_argument("dst", nargs="?", help="pool/dst (prepare only)")
    p.set_defaults(fn=cmd_migration)

    p = sub.add_parser("encryption")
    p.add_argument("enc_cmd", choices=["format"])
    p.add_argument("image"), p.add_argument("passfile")
    p.set_defaults(fn=cmd_encryption)

    args = ap.parse_args(argv)
    return asyncio.run(args.fn(args))


if __name__ == "__main__":
    raise SystemExit(main())
