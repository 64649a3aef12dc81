"""prometheus mgr module: metrics exposition text (the
src/pybind/mgr/prometheus + src/exporter role), rendered from the
host's report/map state.

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/prometheus.py``.
"""
from __future__ import annotations

from ..cluster.mgr_module import MgrModule


class Module(MgrModule):
    COMMANDS = [{"cmd": "prometheus",
                 "desc": "metrics exposition text"}]

    async def handle_command(self, cmd: str, args: dict) -> str:
        return self.render()

    def render(self) -> str:
        osdmap = self.get("osd_map")
        reports = self.get("reports")
        lines = [
            "# HELP ceph_osd_up OSD liveness per the cluster map",
            "# TYPE ceph_osd_up gauge",
        ]
        for i, o in enumerate(osdmap.osds):
            lines.append(f'ceph_osd_up{{osd="{i}"}} {1 if o.up else 0}')
        lines.append("# TYPE ceph_osd_op_total counter")
        for osd, rep in sorted(reports.items()):
            for key, val in sorted(rep["perf"].items()):
                if isinstance(val, (int, float)):
                    lines.append(
                        f'ceph_osd_{key}_total{{osd="{osd}"}} {val}'
                    )
                elif isinstance(val, dict) and "sum" in val \
                        and "avgcount" in val:
                    lines.append(
                        f'ceph_osd_{key}_sum{{osd="{osd}"}} '
                        f'{val["sum"]}'
                    )
                    lines.append(
                        f'ceph_osd_{key}_count{{osd="{osd}"}} '
                        f'{val["avgcount"]}'
                    )
        lines.append("# TYPE ceph_pg_states gauge")
        states: dict[str, int] = {}
        for rep in reports.values():
            for s, n in rep["pgs"].items():
                states[s] = states.get(s, 0) + n
        for s, n in sorted(states.items()):
            lines.append(f'ceph_pg_states{{state="{s}"}} {n}')
        return "\n".join(lines) + "\n"
