"""osdc: client-side op engines (the src/osdc layer role).

The Objecter role (target calc + resend on map change) lives in
ceph_tpu.cluster.client; this package holds the layout engines built on
top of it — Striper (byte-extent -> object striping, osdc/Striper.h) and
the striped large-object API (the libradosstriper role).

ceph_tpu_torch's own copy of ``ceph_tpu/osdc/__init__.py``.
"""
from __future__ import annotations

from .striper import (  # noqa: F401
    FileLayout,
    ObjectExtent,
    StripedReadResult,
    extent_to_file,
    file_to_extents,
    file_to_extents_bulk,
    get_num_objects,
)
from .striped_client import RadosStriper  # noqa: F401
