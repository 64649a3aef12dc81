"""balancer mgr module: upmap-based PG distribution optimizer (the
src/pybind/mgr/balancer role over cluster/balancer.py's planner).

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/balancer.py``.
"""
from __future__ import annotations

from ..cluster import balancer
from ..cluster import messages as M
from ..cluster.mgr_module import MgrModule


class Module(MgrModule):
    COMMANDS = [
        {"cmd": "balancer status",
         "desc": "PG distribution for a pool: {pool}"},
        {"cmd": "balancer run",
         "desc": "apply upmap moves: {pool, max_moves?}"},
    ]

    async def handle_command(self, cmd: str, args: dict):
        osdmap = self.get("osd_map")
        pool = int(args["pool"])
        if cmd == "balancer status":
            return balancer.spread(osdmap, pool)
        before = balancer.spread(osdmap, pool)
        moves = balancer.compute_moves(
            osdmap, pool, int(args.get("max_moves", 10)))
        if moves:  # the whole plan rides one message -> one map epoch
            await self.send_mon(M.MUpmapItems(entries=moves))
        return {"moves": [
            {"pgid": list(p), "pairs": [list(x) for x in pr]}
            for p, pr in moves],
            "before": before}
