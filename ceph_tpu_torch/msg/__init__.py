"""Wire & transport layer: CRC-framed messages + messengers.

The reference's L1 (SURVEY.md §1): AsyncMessenger event loops carrying
msgr2 frames with per-segment CRC32C (src/msg/async/AsyncMessenger.h:74,
frames_v2.h:94-145) between typed Message subclasses (src/messages/).

The TPU-native redesign keeps the seam but not the machinery: the control
plane is a single-reactor asyncio messenger (the Crimson stance — one
event loop per process removes the reference's lock hierarchy by
construction, src/crimson/osd), and the DATA plane does not travel here
at all when shards are device-resident — EC fan-out/gather ride
collectives over the mesh (parallel/), while this layer carries
maps, heartbeats, sub-op control, and host-resident chunk payloads.

Two interchangeable messengers:
- LocalBus — in-process router for cluster-free tests (SURVEY §4 tier 2:
  the direct_messenger role). Every message still round-trips through
  frame encode/decode so wire coverage is identical.
- TcpMessenger — asyncio TCP, length-prefixed frames, CRC32C-checked
  (the PosixStack role).

ceph_tpu_torch's own copy of ``ceph_tpu/msg/__init__.py``.
"""
from .frames import Frame, FrameError, encode_frame, decode_frame  # noqa: F401
from .messages import (  # noqa: F401
    Message,
    register_message,
    decode_message,
)
from .messenger import Dispatcher, LocalBus, TcpMessenger  # noqa: F401
