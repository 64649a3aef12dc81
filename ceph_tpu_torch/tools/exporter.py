"""exporter: standalone Prometheus exporter scraping daemon admin
sockets (the src/exporter DaemonMetricCollector role — distinct from
the mgr's cluster-level /prometheus, which renders map state).

  exporter.py --sock-dir /tmp/c1/asok --once          # print and exit
  exporter.py --sock-dir /tmp/c1/asok --port 9926     # serve /metrics

Every *.sock in --sock-dir is scraped with `perf dump`; counters become
`ceph_tpu_<counter>{ceph_daemon="<name>"}` exactly the way the
reference labels per-daemon series.

ceph_tpu_torch's own copy of ``tools/exporter.py``, run as
``python -m ceph_tpu_torch.tools.exporter``. Host only: it takes no
device.
"""
from __future__ import annotations

import argparse
import asyncio
import glob
import os
import signal
import sys

from ..utils.admin import admin_command


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


async def scrape(sock_dir: str) -> str:
    lines: list[str] = []
    seen_help: set[str] = set()
    for sock in sorted(glob.glob(os.path.join(sock_dir, "*.sock"))):
        daemon = os.path.splitext(os.path.basename(sock))[0]
        try:
            perf = await admin_command(sock, "perf dump")
        except (OSError, ConnectionError):
            lines.append(f'ceph_tpu_daemon_up{{ceph_daemon="{daemon}"}} 0')
            continue
        lines.append(f'ceph_tpu_daemon_up{{ceph_daemon="{daemon}"}} 1')
        for counter, value in sorted(_flatten(perf)):
            metric = f"ceph_tpu_{_sanitize(counter)}"
            if metric not in seen_help:
                lines.append(f"# TYPE {metric} gauge")
                seen_help.add(metric)
            lines.append(
                f'{metric}{{ceph_daemon="{daemon}"}} {value}')
    return "\n".join(lines) + "\n"


def _flatten(obj, prefix: str = ""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flatten(v, f"{prefix}_{k}" if prefix else str(k))
    elif isinstance(obj, bool):
        yield prefix, int(obj)
    elif isinstance(obj, (int, float)):
        yield prefix, obj


async def serve(sock_dir: str, port: int) -> None:
    async def handle(reader, writer):
        try:
            # drain request line + headers; responding with unread bytes
            # in the kernel buffer risks an RST eating the response
            while (await reader.readline()).strip():
                pass
            body = (await scrape(sock_dir)).encode()
            writer.write(
                b"HTTP/1.0 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"\r\n" + body)
            await writer.drain()
        finally:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", port)
    print(f"serving /metrics on 127.0.0.1:{port}", file=sys.stderr)
    async with server:
        await server.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sock-dir", required=True)
    ap.add_argument("--port", type=int, default=9926)
    ap.add_argument("--once", action="store_true",
                    help="scrape once to stdout and exit")
    args = ap.parse_args(argv)
    if args.once:
        print(asyncio.run(scrape(args.sock_dir)), end="")
        return 0
    asyncio.run(serve(args.sock_dir, args.port))
    return 0


if __name__ == "__main__":
    # head-friendly CLI: a closed stdout pipe is a normal exit. Set
    # only when run as a program — at import time this would strip
    # the hosting process (e.g. pytest) of CPython's SIGPIPE ignore
    # and a later write to any dead socket would kill it (exit 141).
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
