"""ceph_tpu_torch: the PyTorch/CUDA port of ceph_tpu for NVIDIA Hopper.

The JAX package ``ceph_tpu`` stays beside it as the reference; this
package imports nothing of it and never imports JAX. Layout follows the
reference so each module's counterpart is easy to find:

  device.py     device choice (the card unless the caller names another)
                and the int32-carries-uint32 packed-word convention
  kernels.py    nvcc build + ctypes binding of csrc/*.cu, launch counters
  csrc/         hand-written CUDA kernels for sm_90a
  ops/          gf8 (host field math), rs (GF(2^8) matmul), gf2 (the
                bitmatrix codes' XOR schedule), crc32c, crush (Jenkins
                hash, crush_ln, straw2), xor_combine (the mesh's XOR
                combines)
  models/       datapath: the batched EC write / repair step
  ec/           codec seam: ErasureCode base, registry, rs_tpu, isa,
                bitmatrix, clay, lrc, shec
  parallel/     the multi-device data plane: a mesh of slots (cards, or a
                virtual mesh on one device), placements, collective
                repair (shard_comm) and the serving runtime
  checksum/     the BlueStore Checksummer (crc32c family, xxhash): the
                C++ core by default, the crc32c kernel with device=True
  cluster/      the OSD's ECBatcher and stripe layout, every cluster
                message, snaps, the fault plane, and the tier's leaves
                (scheduler, reserver, optracker, hedge, pglog)
  msg/          the wire: CRC-framed messages, auth, LocalBus, TCP and
                shared-memory messengers, NetBus
  placement/    CRUSH maps and host rule engine, the bulk rule engine,
                OSDMap, map encoding, crushtool compiler, tester, and the
                batched placement resolver
  store/        the object store: transactions, MemStore, WalStore (WAL +
                checkpoint snapshots) and BlueStoreLite (block device +
                KV metadata), both checksumming through the Checksummer
  utils/        config schema, perf counters, fault injection, denc,
                BufferList, compressors, SloppyCRCMap, latency
                histograms, log, tracing, the admin socket
  native/       the C++ host core and ``rt`` (KV store, block device,
                bitmap allocator): g++ at first use, ctypes
  convert.py    hands the reference's state (matrix, stripe data, CRUSH
                and OSD maps) over
"""

from . import placement  # noqa: F401,E402
