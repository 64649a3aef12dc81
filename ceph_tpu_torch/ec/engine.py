"""EC engine economics: device kernels vs the C++ host core.

The reference picks its fastest available GF(2^8) engine at runtime by
probing the CPU (ErasureCodePluginRegistry preferring ISA-L on x86,
jerasure's SIMD dispatch in gf-complete). The CUDA build has the same
decision with a different axis: the batched device kernels win by orders
of magnitude on the card's HBM, but the DATA PATH must move every stripe
host<->device first — and that link (PCIe, pageable copies), not the
math, may be the bottleneck. So the data path probes once: time a
representative batch end-to-end through each engine (device: transfer +
kernels + readback; host: the multithreaded C++ matmul and CRC pass) and
use the faster one.

Profile key "backend" overrides: "device" / "host" force an engine,
"auto" (the data-path default) probes.

ceph_tpu_torch's own copy of ``ceph_tpu/ec/engine.py``. Changed:

- the device arm is the port's fused write dispatch: the pageable HtoD
  of the (64, 8, 2048)-word batch, ``ops.rs.encode_with_crcs`` (the
  GF(2^8) kernel for parity, the CRC32C kernel for every cell's CRC)
  and the DtoH of parity and CRCs; the host arm is the port's C++ core;
- ``_probe`` and ``data_path_engine`` take the torch device to probe
  (the CUDA card when it is left out). With no card the probe raises:
  there is no "device unavailable, use the host" answer, because the
  port never drops to the host on its own. The codecs ask only for a
  codec on a CUDA device; one on the CPU runs the plain versions as
  "device" and probes nothing.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from .. import native
from ..device import resolve, words_to_tensor

#: probe shape: 64 stripes x k=8 x 8 KiB chunks = 4 MiB of data — big
#: enough to expose link bandwidth, small enough to probe in <2 s even
#: over a slow link.
_PROBE_B, _PROBE_K, _PROBE_WORDS = 64, 8, 2048

_cached: str | None = None
#: measured probe economics of the last _probe() run: both engines'
#: per-batch seconds, so a run can RECORD the device-engine number
#: next to whichever engine the data path picked (empty when the
#: engine was forced via CEPH_TPU_EC_ENGINE and no probe ran)
last_probe: dict = {}
#: the probe runs once per process — it is reached from ECBatcher
#: executor WORKER threads, and two first-tick buckets probing
#: concurrently would contend and cache a skewed verdict
_probe_lock = threading.Lock()


def _probe(device=None) -> str:
    from ..ops import gf8, rs

    device = resolve(device)
    matrix = gf8.vandermonde_rs_matrix(_PROBE_K, 2)
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 2**32, (_PROBE_B, _PROBE_K, _PROBE_WORDS),
                         dtype=np.uint32)
    cell_bytes = _PROBE_WORDS * 4

    def dev_once() -> float:
        # the FUSED data-path dispatch: put + encode + per-cell CRC
        # kernel + readback of parity AND crcs — what the write path
        # actually ships per batch (cluster/ecbatch.py)
        t0 = time.perf_counter()
        parity, crcs = rs.encode_with_crcs(
            matrix, cell_bytes, words_to_tensor(batch, device))
        parity.cpu()
        crcs.cpu()
        return time.perf_counter() - t0

    def host_once() -> float:
        # the host engine's two-pass shape: multithreaded C++ encode,
        # then the separate multithreaded CRC pass over data+parity
        # cells — apples-to-apples with what the host data path costs
        u8 = np.ascontiguousarray(
            batch.view(np.uint8).reshape(_PROBE_B, _PROBE_K, -1)
            .transpose(1, 0, 2)).reshape(_PROBE_K, -1)
        t0 = time.perf_counter()
        par = native.rs_encode(matrix, u8, threads=os.cpu_count() or 1)
        cells = np.concatenate([u8, par]).reshape(-1, cell_bytes)
        native.crc32c_batch(cells, threads=os.cpu_count() or 1)
        return time.perf_counter() - t0

    data_bytes = _PROBE_B * _PROBE_K * cell_bytes
    dev_once()  # warm: kernel build/load and first transfer
    dt_dev = min(dev_once() for _ in range(2))
    host_once()
    dt_host = min(host_once() for _ in range(2))
    last_probe.update({
        "probe_data_bytes": data_bytes,
        "device_s": round(dt_dev, 6),
        "host_s": round(dt_host, 6),
        "device_mib_s": round(data_bytes / dt_dev / 2**20, 1),
        "host_mib_s": round(data_bytes / dt_host / 2**20, 1),
    })
    return "device" if dt_dev < dt_host else "host"


def data_path_engine(device=None) -> str:
    """The engine the cluster data path should encode with ("device" or
    "host"), probed once per process on ``device`` (the card when left
    out). CEPH_TPU_EC_ENGINE overrides."""
    global _cached
    if _cached is None:
        with _probe_lock:
            if _cached is None:
                forced = os.environ.get("CEPH_TPU_EC_ENGINE", "")
                _cached = (forced if forced in ("device", "host")
                           else _probe(device))
    return _cached


def reset_probe() -> None:
    """Test hook: drop the cached probe result."""
    global _cached
    _cached = None
