"""``chip_smoke.py``'s phase ``proc`` on the CPU, small: a ProcCluster
of 3 mon and 12 OSD daemon processes on ``device="cpu"`` (the kernels'
plain versions) over shm, then one over TCP. Every check of the phase
runs (reads equal to the writes, every EC shard's hash_info against the
C++ core's CRC after the stop, encode batches on the writes and decode
batches on the degraded read, none on the host engine and none failed, a
quorum of 2 that creates a pool after the leader mon's kill), the
post-stop scan in 2 interpreters rather than the card run's 6 (the suite
runs beside other process-tier files); the card's checks (compute apps,
launch counts) need the card and run there."""
import numpy as np
import torch

import chip_smoke

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def test_proc_phase_on_the_cpu():
    out = chip_smoke.proc_phase(
        "cpu", np.random.default_rng(7), device="cpu", objects=6,
        rep_objects=2, degraded_writes=2, tcp_objects=2, scan_workers=2)
    shm, tcp = out["lines"]["shm"], out["lines"]["tcp"]
    assert list(shm) == ["start", "write", "read", "kill", "degraded_read",
                         "degraded_write", "recovery", "mon_failover",
                         "read_after"]
    assert list(tcp) == ["start", "write", "read"]
    assert shm["write"]["ec_batches"] > 0 and tcp["write"]["ec_batches"] > 0
    assert shm["degraded_read"]["ec_decode_batches"] > 0
    for lines in (shm, tcp):
        for step, line in lines.items():
            assert line["ec_decode_cold_host"] == 0, step
            assert line["ec_batch_failures"] == 0, step
            assert line.get("failed_ops", 0) == 0, step
    assert shm["start"]["quorum"] == [0, 1, 2]
    assert len(shm["mon_failover"]["quorum"]) == 2
    assert shm["mon_failover"]["new_leader"] != \
        shm["mon_failover"]["killed_mon"]
    assert set(shm["start"]["startup"]) == {"mon", "osd"}
