"""crash mgr module: cluster-wide crash report registry (the
src/pybind/mgr/crash module + ceph-crash uploader roles).

Daemons (or the ceph-crash role on a node) post crash metadata; the
module keys it by <timestamp>_<uuid> in the persistent module store
(mon-replicated, survives mgr restarts), serves ls/info/rm/prune/stat,
and summarizes recent crashes the way the reference's RECENT_CRASH
health check does.

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/crash.py``.
"""
from __future__ import annotations

import json
import time
import uuid

from ..cluster.mgr_module import MgrModule

#: crashes older than this no longer count as "recent" (the
#: mgr/crash/warn_recent_interval default: two weeks)
RECENT_S = 14 * 24 * 3600.0


class Module(MgrModule):
    COMMANDS = [
        {"cmd": "crash post",
         "desc": "record a crash: {entity, backtrace?, ts?}"},
        {"cmd": "crash ls", "desc": "list crash reports"},
        {"cmd": "crash info", "desc": "one crash in full: {id}"},
        {"cmd": "crash rm", "desc": "remove one report: {id}"},
        {"cmd": "crash prune",
         "desc": "drop reports older than {keep_days}"},
        {"cmd": "crash stat", "desc": "summary + recent count"},
    ]

    def _ids(self) -> list[str]:
        return json.loads(self.get_store("ids", "[]"))

    async def _save_ids(self, ids: list[str]) -> None:
        await self.set_store("ids", json.dumps(sorted(ids)))

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "crash post":
            ts = float(args.get("ts", time.time()))
            cid = f"{int(ts)}_{uuid.uuid4().hex[:12]}"
            report = {
                "crash_id": cid,
                "timestamp": ts,
                "entity_name": str(args.get("entity", "unknown")),
                "backtrace": args.get("backtrace", ""),
            }
            await self.set_store(f"report/{cid}", json.dumps(report))
            await self._save_ids(self._ids() + [cid])
            return {"crash_id": cid}
        if cmd == "crash ls":
            out = []
            for cid in self._ids():
                raw = self.get_store(f"report/{cid}")
                if raw:
                    r = json.loads(raw)
                    out.append({"crash_id": cid,
                                "entity_name": r["entity_name"],
                                "timestamp": r["timestamp"]})
            return out
        if cmd == "crash info":
            raw = self.get_store(f"report/{args['id']}")
            if raw is None:
                raise KeyError(args["id"])
            return json.loads(raw)
        if cmd == "crash rm":
            cid = args["id"]
            ids = self._ids()
            if cid not in ids:
                raise KeyError(cid)
            ids.remove(cid)
            await self.set_store(f"report/{cid}", None)
            await self._save_ids(ids)
            return {}
        if cmd == "crash prune":
            keep_s = float(args.get("keep_days", 14)) * 86400
            cutoff = time.time() - keep_s
            kept, dropped = [], []
            for cid in self._ids():
                (dropped if int(cid.split("_")[0]) < cutoff
                 else kept).append(cid)
            for cid in dropped:
                await self.set_store(f"report/{cid}", None)
            await self._save_ids(kept)
            return {"removed": len(dropped)}
        if cmd == "crash stat":
            now = time.time()
            ids = self._ids()
            recent = [c for c in ids
                      if int(c.split("_")[0]) > now - RECENT_S]
            return {"total": len(ids), "recent": len(recent),
                    "health": ("RECENT_CRASH" if recent else "OK")}
        raise NotImplementedError(cmd)
