"""The cluster tier (the JAX package's ``ceph_tpu/cluster``): mon-lite
and the Paxos quorum of mons, OSD-lite, the PG, the client, the mgr, the
TestCluster that assembles them in one process over a LocalBus, and the
process tier — ``daemon`` (one mon or OSD per OS process on a NetBus)
and ``procstart.ProcCluster`` (the launcher). Every module is the
reference's host code with its own imports; the device seams are the
port's:

- ``ecbatch`` — the ECBatcher: coalesces EC encode/decode work into
  batched dispatches on the codec's device (pinned staging, one CUDA
  stream per worker thread) or on the C++ host core.
- ``osd``, ``client``, ``vstart`` and ``procstart`` take ``device`` (the
  CUDA card unless the caller names another) and hand it to the codecs,
  the placement resolver and scrub; ``daemon`` takes ``--device
  {cpu,cuda}``, and every OSD process of a ProcCluster runs on the
  cluster's device. ``paxos_mon`` uses no device.
- ``stripe`` — fixed stripe-unit layout, per-cell CRCs, hinfo codec and
  the op-vector ``Overlay`` of the EC RMW write path.
- ``messages`` — every cluster message type (re-exported here, as in
  the reference); ``snaps``, ``faults``, ``scheduler``, ``reserver``,
  ``optracker``, ``hedge`` and ``pglog`` are the tier's leaves.

The MDS role of the process tier (``daemon --role mds``,
``ProcCluster.start_mds``) runs ``services/mds.py``'s ``MDSLite`` with
its own ``RadosClient`` on the cluster's device.
"""
from .ecbatch import FLUSH_REASONS, ECBatcher, codec_profile_key  # noqa: F401
from .messages import *  # noqa: F401,F403
from .mon import MonLite  # noqa: F401
from .osd import OSDLite  # noqa: F401
from .client import RadosClient  # noqa: F401
from .vstart import TestCluster  # noqa: F401
