"""The OSD-side modules of the cluster tier, ported as the slices reach
them (the JAX package's ``ceph_tpu/cluster``):

- ``ecbatch`` — the ECBatcher: coalesces EC encode/decode work into
  batched dispatches on the codec's device (pinned staging, one CUDA
  stream per worker thread) or on the C++ host core.
- ``stripe`` — fixed stripe-unit layout, per-cell CRCs, hinfo codec and
  the op-vector ``Overlay`` of the EC RMW write path.
- ``messages`` — every cluster message type (re-exported here, as in
  the reference); ``snaps``, ``faults``, ``scheduler``, ``reserver``,
  ``optracker``, ``hedge`` and ``pglog`` are the tier's leaves.
"""
from .ecbatch import FLUSH_REASONS, ECBatcher, codec_profile_key  # noqa: F401
from .messages import *  # noqa: F401,F403
