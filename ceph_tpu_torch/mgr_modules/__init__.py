"""Built-in mgr modules (the src/pybind/mgr/<module>/ role).

Each module is a standalone file against the MgrModule API
(cluster/mgr_module.py) — the same format third-party drop-ins use, so
the builtins double as the reference examples. MgrLite loads them at
construction; `ceph_tpu_torch.cluster.mgr_module.load_module_file` loads
external ones from any directory.

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/__init__.py``.
"""
from __future__ import annotations

from .balancer import Module as BalancerModule
from .crash import Module as CrashModule
from .dashboard import Module as DashboardModule
from .pg_autoscaler import Module as PgAutoscalerModule
from .prometheus import Module as PrometheusModule
from .rgw_lc import Module as RgwLcModule
from .telemetry import Module as TelemetryModule

BUILTIN = {
    "balancer": BalancerModule,
    "crash": CrashModule,
    "dashboard": DashboardModule,
    "pg_autoscaler": PgAutoscalerModule,
    "prometheus": PrometheusModule,
    "rgw_lc": RgwLcModule,
    "telemetry": TelemetryModule,
}
