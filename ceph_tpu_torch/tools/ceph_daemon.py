"""ceph-daemon: talk to a daemon's admin socket (the `ceph daemon
<sock> <command>` role).

  ceph_daemon.py /path/osd0.sock help
  ceph_daemon.py /path/osd0.sock perf dump
  ceph_daemon.py /path/osd0.sock config set key=osd_subop_timeout value=5
  ceph_daemon.py /path/mgr.sock prometheus

ceph_tpu_torch's own copy of ``tools/ceph_daemon.py``, run as
``python -m ceph_tpu_torch.tools.ceph_daemon``. Host only: it takes no
device.
"""
from __future__ import annotations

import asyncio
import json
import sys

from ..utils.admin import admin_command


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    sock = argv[0]
    words = []
    kwargs = {}
    for tok in argv[1:]:
        if "=" in tok:
            k, v = tok.split("=", 1)
            kwargs[k] = v
        else:
            words.append(tok)
    prefix = " ".join(words)
    result = asyncio.run(admin_command(sock, prefix, **kwargs))
    if isinstance(result, str):
        print(result, end="" if result.endswith("\n") else "\n")
    else:
        print(json.dumps(result, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
