"""Platform primitives the port's OSD-side modules stand on (the JAX
package's ``ceph_tpu/utils``, copied as the port reaches them):

- ``config`` — typed option schema + runtime config with observers
  (the md_config_t / ConfigProxy role).
- ``perf`` — counters registry (the PerfCounters role).
- ``fault`` — fault injection points (the FaultInjector role).
- ``denc`` — little-endian wire encoding (the denc.h role), for the
  placement maps and the store's records.
- ``buffer`` — BufferList, zero-copy scatter/gather (the bufferlist role).
- ``compress`` — compressor plugins and BlueStore's policy helpers.
- ``sloppy_crc`` — opportunistic per-block CRC tracking (SloppyCRCMap).
- ``lathist``, ``log``, ``trace``, ``admin`` — mergeable latency
  histograms, the dout log, span tracing and the admin socket.
"""
