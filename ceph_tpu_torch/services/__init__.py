"""Storage services on RADOS (the L5 layer role: librbd, RGW, cls).

Thin by design (SURVEY.md §7 phase 8): capability-parity service
surfaces built on the client op-vector API, not re-implementations of
the reference's 400 K LoC service stack.

ceph_tpu_torch's own copy of ``ceph_tpu/services/__init__.py``.
"""
from __future__ import annotations

from .rbd import RBD, Image, ImageNotFound  # noqa: F401
from .fs import FSLite  # noqa: F401
from .rgw import RGWLite, S3Frontend  # noqa: F401
