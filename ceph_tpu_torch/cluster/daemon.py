"""Daemon entry point for multi-process clusters (src/ceph_osd.cc /
src/ceph_mon.cc main() role).

Runs ONE daemon — a mon (single or paxos rank) or an OSD — as its own
OS process on a NetBus (msg/netbus.py), with a durable store. Spawned
by procstart.ProcCluster (the vstart.sh:100-125 launch role) or by
hand:

    python -m ceph_tpu_torch.cluster.daemon --role osd --id 3 \
        --book /tmp/cluster/book --store-dir /tmp/cluster \
        --n-osds 4 --objectstore walstore --device cuda

A keyring file ``keyring`` in the book dir (lines ``entity hexsecret``)
switches every connection to the cephx-role authenticated mode; pass
--secure for AES-GCM on the wire.

SIGTERM stops cleanly; kill -9 is the crash the stores and the rest of
the cluster are built to survive.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/daemon.py``. The device
seam: ``--device {cpu,cuda}`` (the card unless the caller names the
CPU) takes the place of the reference's ``--platform``. An OSD passes it
to ``OSDLite``. With ``cpu`` the daemon pins torch to one intra-op
thread (the counterpart of pinning one virtual CPU device). With
``cuda`` an OSD creates its CUDA context and loads the kernel libraries
before its bus starts, so its first launch cannot stall a heartbeat
past ``--hb-grace``; it exits with an error when there is no card. The
mon uses no device. Each daemon writes its start-up seconds to
``<book>/<role>.<id>.startup`` (JSON) before its ``.ready`` marker, and
an OSD's admin socket serves ``kernel launches`` (the launch counts of
this process, ``{"reset": true}`` sets them to 0) and ``device status``
(its CUDA context, card and card memory). A WalStore OSD takes its
checkpoint threshold from ``walstore_compact_bytes`` (the reference's
daemon leaves the store's default, which is the option's default). The
MDS role needs ``services/mds.py``, which the port takes in its next
slice (ROADMAP §1 item 7), and raises.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def load_keyring(book_dir: str):
    """keyring file -> KeyServer | None (CephxKeyServer role)."""
    path = os.path.join(book_dir, "keyring")
    if not os.path.exists(path):
        return None
    from ..msg.auth import KeyServer

    ks = KeyServer()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            entity, hexsecret = line.split()
            ks.add(entity, bytes.fromhex(hexsecret))
    return ks


def make_keyring(book_dir: str, entities) -> None:
    """Generate a shared keyring for a dev cluster (vstart auth role)."""
    import secrets

    path = os.path.join(book_dir, "keyring")
    with open(path, "w") as f:
        for e in entities:
            f.write(f"{e} {secrets.token_hex(32)}\n")


def _since_exec() -> float | None:
    """Seconds since this process was exec'd (its /proc start time
    against the uptime clock); None where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(") ", 1)[-1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return up - start / _CLK_TCK


def _bind_device(device: str, role: str) -> dict:
    """Bind this daemon to ``device`` BEFORE its bus starts -> its
    start-up seconds.

    ``import_s`` is the interpreter's start and the imports of torch
    and the port (``python -m`` imports the package before ``main``).
    ``cpu`` pins torch to one intra-op thread: a dev cluster's daemons
    share the host's cores, and the plain versions are small tensor
    ops. ``cuda`` (an OSD) creates the CUDA context and loads every
    kernel library: fifteen processes doing that at once take seconds,
    which must pass before the OSD boots and starts its heartbeat, not
    after (the stall the reference's ``_pin_platform`` docstring
    records on the TPU). There is no fallback: no card, no daemon."""
    import torch

    out = {"role": role, "device": device, "pid": os.getpid(),
           "import_s": _since_exec(), "cuda_context_s": None,
           "kernel_load_s": None}
    if device == "cpu":
        torch.set_num_threads(1)
        return out
    if role != "osd":
        return out  # the mon uses no device
    from .. import kernels
    from ..device import resolve

    t0 = time.perf_counter()
    dev = resolve(None)  # raises when there is no card
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    out["cuda_context_s"] = time.perf_counter() - t0
    out["kernel_load_s"] = kernels.build_all()
    return out


def _kernel_launches(args: dict) -> dict:
    """The ``kernel launches`` admin verb: this process's launch count
    of each kernel (``{"reset": true}`` zeroes them after reading)."""
    from .. import kernels

    out = {"pid": os.getpid(),
           "launches": {k.name: k.launches for k in kernels.KERNELS}}
    if args.get("reset"):
        kernels.reset_counts()
    return out


def _device_status(args: dict) -> dict:
    """The ``device status`` admin verb: whether this process holds a
    CUDA context, on which card, and the card memory it holds."""
    import torch

    out = {"pid": os.getpid(), "cuda_initialized":
           torch.cuda.is_initialized()}
    if out["cuda_initialized"]:
        free, total = torch.cuda.mem_get_info()
        out.update(name=torch.cuda.get_device_name(),
                   memory_reserved=torch.cuda.memory_reserved(),
                   device_free=free, device_total=total)
    return out


async def _amain(args, startup: dict) -> None:
    from ..msg.netbus import NetBus
    from .. import store as store_mod

    keys = load_keyring(args.book)
    bus = NetBus(args.book, keys=keys, secure=args.secure,
                 backend=args.msg_backend)
    await bus.start()

    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop_ev.set)

    if args.role == "mon":
        from .monstore import MonStore

        store = MonStore(os.path.join(args.store_dir,
                                      f"mon.{args.id}.kv"))
        if args.n_mons > 1:
            from .paxos_mon import PaxosMon

            daemon = PaxosMon(bus, args.n_osds, rank=args.id,
                              n_mons=args.n_mons, store=store,
                              hb_grace=args.hb_grace,
                              out_interval=args.out_interval)
        else:
            from .mon import MonLite

            daemon = MonLite(bus, args.n_osds, store=store,
                             hb_grace=args.hb_grace,
                             out_interval=args.out_interval)
    elif args.role == "osd":
        from ..utils import config as cfg
        from .osd import OSDLite

        conf = cfg.proxy()
        if args.conf:
            # launcher-provided overrides (the vstart.sh `-o key=val`
            # role over process boundaries): the fabric bench needs the
            # EC coalescing / op-concurrency knobs on REAL daemons
            conf.apply({k: v for k, v in
                        (kv.split("=", 1) for kv in args.conf)})
        store_kw = {}
        if args.objectstore != "memstore":
            # store-side group commit rides the daemon config (the
            # store_commit_window_ms/store_commit_max_txns knob pair)
            store_kw = dict(
                commit_window_ms=float(conf["store_commit_window_ms"]),
                commit_max_txns=int(conf["store_commit_max_txns"]))
            if args.objectstore == "walstore":
                # the checkpoint threshold rides the config too (its
                # default is WalStore's own): a checkpoint serializes
                # the whole store under the store lock
                store_kw["wal_compact_bytes"] = int(
                    conf["walstore_compact_bytes"])
        store = store_mod.create(
            args.objectstore,
            os.path.join(args.store_dir, f"osd.{args.id}"), **store_kw)
        daemon = OSDLite(bus, args.id, store=store,
                         hb_interval=args.hb_interval, conf=conf,
                         device=args.device)
    elif args.role == "mds":
        # metadata daemon (src/ceph_mds.cc main role): needs
        # services/mds.py
        raise NotImplementedError(
            "the mds role needs services/mds.py, which the port takes in "
            "its next slice (ROADMAP §1 item 7)")
    else:
        raise SystemExit(f"unknown role {args.role!r}")

    await daemon.start()
    if hasattr(daemon, "start_admin"):
        # `ceph daemon <name> <cmd>` surface, one socket per daemon
        await daemon.start_admin(os.path.join(
            args.store_dir, f"{args.role}.{args.id}.asok"))
        daemon.admin.register("kernel launches", _kernel_launches,
                              "this process's kernel launch counts "
                              "{reset?}")
        daemon.admin.register("device status", _device_status,
                              "this process's CUDA context and card "
                              "memory")
    with open(os.path.join(args.book,
                           f"{args.role}.{args.id}.startup"), "w") as f:
        json.dump(startup, f)
    # readiness marker for the launcher (systemd-notify role)
    ready = os.path.join(args.book, f"{args.role}.{args.id}.ready")
    with open(ready, "w") as f:
        f.write(str(os.getpid()))

    async def watch_parent() -> None:
        # exit with the launcher: a dev-cluster daemon orphaned by a
        # killed test run must not linger and cross-talk with the next
        # cluster sharing the same book paths
        ppid = os.getppid()
        while os.getppid() == ppid:
            await asyncio.sleep(0.5)
        stop_ev.set()

    parent_task = loop.create_task(watch_parent())
    try:
        await stop_ev.wait()
        parent_task.cancel()
    finally:
        try:
            await asyncio.wait_for(daemon.stop(), 5)
        except Exception:
            pass
        await bus.close()
        try:
            os.unlink(ready)
        except OSError:
            pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ceph-tpu-torch-daemon")
    ap.add_argument("--role", required=True,
                    choices=["mon", "osd", "mds"])
    ap.add_argument("--id", type=int, default=0,
                    help="osd id / mon rank / mds rank")
    ap.add_argument("--pool", type=int, default=1,
                    help="mds: metadata pool id")
    ap.add_argument("--data-pool", type=int, default=-1,
                    help="mds: data pool id (-1 = metadata pool)")
    ap.add_argument("--book", required=True,
                    help="shared address-book directory")
    ap.add_argument("--store-dir", required=True)
    ap.add_argument("--n-osds", type=int, required=True)
    ap.add_argument("--n-mons", type=int, default=1)
    ap.add_argument("--objectstore", default="walstore")
    ap.add_argument("--secure", action="store_true",
                    help="AES-GCM on-wire (needs a keyring)")
    ap.add_argument("--msg-backend", default="tcp",
                    choices=["tcp", "shm"],
                    help="inter-process transport: tcp (CRC-framed "
                         "sockets) or shm (shared-memory rings with "
                         "unix-socket doorbells — same-host only)")
    ap.add_argument("--conf", action="append", default=[],
                    metavar="KEY=VAL",
                    help="config override applied before the daemon "
                         "boots (repeatable; the vstart -o role)")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="torch device of an OSD's codecs, placement "
                         "and scrub: cuda (the card; the daemon exits "
                         "with an error when there is none) or cpu "
                         "(the plain versions, torch pinned to one "
                         "thread)")
    ap.add_argument("--hb-interval", type=float, default=0.15)
    ap.add_argument("--hb-grace", type=float, default=2.0)
    ap.add_argument("--out-interval", type=float, default=4.0)
    args = ap.parse_args(argv)
    startup = _bind_device(args.device, args.role)
    try:
        asyncio.run(_amain(args, startup))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
