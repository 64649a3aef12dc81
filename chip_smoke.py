#!/usr/bin/env python3
"""Smoke run of ceph_tpu_torch on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from ``ceph_tpu_torch/csrc`` with nvcc (one nvcc
per source, all started together), holds each against its plain PyTorch
version on the card (exact equality: the functions are integer-only),
drives the main path at full width -- the
batched EC write and repair steps on k=8, m=3, 512 KiB chunks (4 MiB
stripes), B=256 stripes (1 GiB) per step, the rs_tpu codec and the
crc32c Checksummer over 16,384 x 64 KiB blobs -- and checks the results,
shows that the main path launched both EC kernels, times each at the
write, repair and Checksummer shapes, its plain version and each step with
CUDA events, and checks from a torch.profiler trace that the write step
(which CRCs data and parity where they lie) launches no copy kernel.

Phase ``ecbatch`` drives the OSD's EC dispatch engine, one ``ECBatcher``
(PerfCounters, the port's config: batch target 64 stripes, window 20 ms,
the OSD's idle probe) over an ``rs_tpu`` k=8, m=3 codec on the card at the
OSD's stripe unit (4 KiB cells), with three mixes of host-resident numpy
cells: ``write_4m`` (256 x 128-stripe full-object writes, 16 at a time,
1 GiB), ``rmw_4k`` (8,192 one-stripe overwrites, 64 at a time, 256 MiB)
and ``recovery`` (256 x 128-stripe rebuilds of shards 1 and 6, 16 at a
time, 1 GiB, then one degraded read of shards 1 and 9). Every parity and
rebuilt cell is held against the C++ host engine and every CRC against its
CRC32C; each mix prints its throughput, per-submission latency, batch
occupancy, flush reasons and kernel launches, beside the card's pinned
copy rates, each mix's copy bound and a torch.profiler split of
``write_4m`` (HtoD / kernels / DtoH device time, idle share).

Phase ``placement`` drives the CRUSH placement slice on the card: the
straw2 kernel against its plain version at the edges (one item, a ragged
batch, zero and equal weights, hash ids apart from items, the crush_ln
wrap at u = 0xffff, a bucket larger than one shared-memory tile) and at
65,536 inputs over 1,000 items; BASELINE.json config 5 (10 M inputs over
a flat 1,000-OSD straw2 bucket, weights from seed 11 as bench.py draws
them), exact against the C++ host core on 100,000 of them; the rule
kernel against its plain version, rows and draw counts, on 65,536 inputs
and on maps at the edges of its lane groups (``rule_edge_maps``), then
10 M inputs through each of a replicated (chooseleaf firstn host, 3) and
an EC k=8, m=3 rule (chooseleaf indep host, 11) on a 50 x 20-OSD tree
with 20 OSDs out and 20 at half weight, exact against
``CrushMap.do_rule`` on 10,000 inputs, and the
tester's utilization; and a ``PlacementResolver`` on the card over an
OSDMap of that cluster (a replicated pool of 32,768 PGs and an EC pool of
8,192: ~100 PG shards per OSD, Ceph's mon_target_pg_per_osd), prewarmed,
then 10 more OSDs marked out and a storm of misses over every PG, each
row held against ``OSDMap.pg_to_up_acting_full``.

Phase ``store`` drives the object store with the crc32c kernel as its
checksum engine, in a temporary directory (it needs ``ST_FREE_BYTES``
free and removes it at the end): a WalStore and a 4 GiB BlueStoreLite,
each as twins, one with ``device_csum=True`` on the card and one with
the C++ core's checksums, take the same transactions in turn: 256 RBD
objects of 4 MiB (1 GiB), then on WalStore one checkpoint, umount and
mount (one checksum call over all 262,144 blocks each), and on
BlueStoreLite 8,192 aligned 4 KiB overwrites and reads of every object
before and after a remount. Every read is held against the twin and a
numpy model, every stored checksum against the C++ core's CRC32C, K2's
launches against the device twin's checksum calls, and a byte flipped on
the block file must fail its read. Each mix prints both twins' txn/s
and GiB/s and the checksum calls' medians; each store shape (1, 1,024
and 262,144 blocks of 4 KiB) prints the call taken apart (host packing,
HtoD, kernel, DtoH, beside the C++ core) and K2's own time against its
bound, its plain version and the copy bound.

Phase ``codecs`` drives the other codec families on the card: the GF(2)
XOR kernel (K5) against its plain version at its edges (``gf2_edge_cases``);
a ``jerasure`` liber8tion k=8, m=2 codec at the write step's unit (256
stripes of 4 MiB, 1 GiB), ``encode_crc_batch`` exact against the host
engine and the C++ core's CRC32C on 16 sampled stripes and against the
plain versions in full, and ``decode_batch`` with data cells 1 and 6 lost;
K5 timed at that encode and decode (CUDA events, torch.profiler device
time, bound, plain version, codec step); Clay k=4, m=2, d=5 on 64 stripes
of 4 MiB (its rounds run on the host, its MDS matmuls on K1 and its CRCs
on K2): an encode, a two-loss decode and a single-loss sub-chunk repair,
with the repair's helper bytes beside an RS decode's; LRC k=4, m=2, l=3 at
1 GiB: an encode and one local-group decode; and an ECBatcher at the OSD's
4 KiB cells over 64 Clay rebuilds of one shard (128 stripes each, exact
against ``repair_cells_host``) and 64 liber8tion writes of 128 stripes
(exact against the host engine and the C++ core's CRC32C).

Phase ``msg`` drives the cluster wire with an EC pool's traffic: one
ECBatcher at the OSD's defaults over jerasure reed_sol_van k=8, m=3 on the
card encodes 256 objects of 4 MiB (K1 parity, K2 cell CRCs); for each the
primary sends every shard's cells in an MECSubWrite (a store Transaction
and the LE (cell, crc) patch) to its own receiver, which applies it to a
MemStore, recomputes every cell's CRC32C on the C++ core against the patch
and replies; then it reads every object back from the 9 shards other than
1 and 6 and rebuilds those two through the batcher (K1), exact against the
written bytes and CRCs. The traffic runs over LocalBus (by reference), TCP
on 127.0.0.1 (half the objects), TCP with signed frames (half) and the
shared-memory ring messenger; each prints its sub-ops, wire bytes, GiB/s,
sub-op round trips, frames per drain, kernel launches and the card's busy
share under torch.profiler. Secure mode is left out: it needs the
``cryptography`` package.

Phase ``cluster`` drives the cluster tier in one process as an RBD
deployment: a TestCluster of 12 OSDs (mon, OSDs with MemStores, mgr,
client over LocalBus) on the card, an RBD data pool on jerasure
reed_sol_van k=8, m=3 and a replicated size-3 pool of 32 PGs each, the
client's placement resolver prewarmed (K4). 256 objects of 4 MiB (1 GiB)
on the EC pool and 32 on the replicated one go through the client's aio
window (K1 parity and K2 cell CRCs through each OSD's ECBatcher), are read
back, take 1,024 aligned 4 KiB overwrites; two OSDs are killed, everything
is read degraded (K1 rebuilds) and 32 more objects a pool are written;
both are revived and recovered to active+clean (K1); every PG is
deep-scrubbed, every EC shard's hash_info CRCs are held against the C++
core's CRC of its bytes, and everything is read once more; then the seeded
thrash verdict runs through ``ceph_tpu_torch.tools.thrash``. Every read
must equal what was written, no op may fail (in placement or elsewhere),
every decode round must run on K1. A line per step prints its GiB/s, op
latency p50/p99, kernel launches, calls of the rs byte API, batches and
placement counters; the write step runs under torch.profiler for the
card's busy share.

Every phase prints one JSON line. The line before the last is the kernel
table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; it also exits nonzero when no CUDA
device is present. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15
#: 32-bit integer ALU rate of one H100 SXM: 132 SMs x 64 lanes x 1.98 GHz.
INT32_OPS_PER_S = 16.7e12
#: Integer-ALU instructions of one straw2 draw, counted in the SASS of
#: csrc/straw2.cu as nvcc 12.8 builds it for sm_90a (cuobjdump -sass),
#: on the path a draw takes when 2^48 - ln exceeds 32 bits (nearly every
#: draw: the 64-bit division's software routine): IADD3 62, LOP3 50, SHF
#: 35, ISETP 13, SEL 8, LEA 3, FLO 1. The 66 IMADs of the path run on the
#: FMA pipe and are not counted, nor is crush_rule.cu's descent around
#: its draws, so for both kernels the bound is a floor.
STRAW2_OPS_PER_DRAW = 172

KIB = 1024
MAIN_B, MAIN_K, MAIN_M, MAIN_CHUNK = 256, 8, 3, 512 * KIB
PRESENT = (0, 2, 3, 4, 5, 7, 8, 9)  # data shards 1 and 6 lost
CSUM_BLOCK, CSUM_BLOBS = 64 * KIB, 16384
DEVICE = "cuda"

#: The ecbatch phase: the OSD's stripe unit and batch knobs
#: (cluster/stripe.py DEFAULT_STRIPE_UNIT, utils/config.py), and per mix
#: (submissions, stripes per submission, concurrent submitters).
ECB_SU, ECB_TARGET, ECB_WINDOW = 4096, 64, 0.02
ECB_MIXES = {"write_4m": (256, 128, 16), "rmw_4k": (8192, 1, 64),
             "recovery": (256, 128, 16)}
ECB_WANT, ECB_READ_PRESENT, ECB_READ_WANT = (1, 6), (0, 2, 3, 4, 5, 6, 7, 8), (1, 9)
COPY_BYTES = 256 * 1024 * KIB  # pinned copy-rate probe, each way
#: Host seconds of idle at each end of a profiled run, tried in turn until
#: the trace holds every launch. On the card torch.profiler drops device
#: records that land outside its capture window (kineto's log counts them
#: "Out-of-range") although they start well under a millisecond after
#: their launch calls: the window's clock and the records' disagree, by
#: over 0.5 s late in this script, where no pad under 2 s holds every
#: K3/K4 record; even 2 s missed two records of 30 once.
PROFILE_PADS_S = (0.05, 0.5, 2.0)
#: What ``profiled`` says of a trace's capture, printed beside a time.
PROFILE_CLOCK = ("launches", "caught", "pad_s", "caught_by_pad",
                 "launch_to_device_ms")
#: Host API calls that launch a kernel, as the profiler names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")

#: The placement phase: BASELINE.json config 5 / bench.py config5_straw2
#: (10 M inputs, a flat 1,000-OSD straw2 bucket, weights and inputs from
#: seed 11, r = 0), the 100,000-input host check, and a 50-host x 20-OSD
#: cluster with 20 OSDs out and 20 at half weight; its pools as
#: (pool id, size, pg_num, rule): ~100 PG shards per OSD.
PL_OSDS, PL_SEED, PL_X, PL_SUBSET = 1000, 11, 10_000_000, 100_000
PL_HOSTS, PL_PER_HOST, PL_OUT, PL_HALF, PL_INC_OUT = 50, 20, 20, 20, 10
PL_CHECK_X, PL_ORACLE_X = 65_536, 10_000
#: Bucket sizes of the rule kernel's edge maps: 1 and 2 lanes, either side
#: of one and of two full groups of 32 lanes.
PL_EDGE_SIZES = (1, 2, 31, 32, 33, 64, 65)
#: Inputs a rule edge map takes: a ragged count of groups and of blocks.
PL_EDGE_X = 4099
PL_RULES = {"replicated": (0, 3), "ec_8_3": (1, 11)}  # rule, numrep
PL_POOLS = {"rbd": (1, 3, 32768, 0), "ec_8_3": (2, 11, 8192, 1)}

#: The store phase: one OSD of an RBD pool. Objects of RBD's default size
#: (rbd_default_order 22: 4 MiB), 1 GiB in all, on a 4 GiB BlueStoreLite
#: with compression off (Ceph's default bluestore_compression_mode=none)
#: and on a WalStore with compression off and a WAL never compacted on its
#: own (one explicit checkpoint of the whole GiB); then fio-style
#: randwrite bs=4k overwrites (4 KiB aligned, fio's default blockalign)
#: from a seeded generator: 8,192 of them (16,384 took 37-42 s; cut to
#: keep the whole script near 650 s once phase cluster joined it).
ST_OBJECTS, ST_OBJECT_BYTES, ST_DEVICE_BYTES = 256, 4 << 20, 4 << 30
ST_RANDWRITES = 8192
ST_POOL = "1.0"
ST_IMAGE = "rbd_data.10226b8b4567"
#: Free disk the phase needs under its temporary directory: two twins of
#: each store, a WalStore checkpoint written beside the one it replaces.
ST_FREE_BYTES = 6 << 30
#: Blocks per checksum call the phase times: a 4 KiB overwrite, a 4 MiB
#: object write or read, a 1 GiB checkpoint.
ST_SHAPES = {"1x4096": 1, "1024x4096": 1024, "262144x4096": 262144}

#: The codecs phase: the other codec families. liber8tion k=8, m=2 (w=8;
#: tools/thrash.py runs the bitmatrix family at m=2) at the rs write step's
#: unit, 256 stripes of 4 MiB (512 KiB cells, 1 GiB), data cells 1 and 6
#: lost for the decode, 16 stripes checked on the host; Clay k=4, m=2, d=5
#: (the example of Ceph's Clay documentation) on 64 stripes of 4 MiB, 8
#: checked on the host engine, chunks 1 and 4 lost for the decode, chunk 2
#: for the sub-chunk repair; LRC k=4, m=2, l=3 (the example of Ceph's LRC
#: documentation) on 256 stripes of 4 MiB, data chunk 0 lost.
CD_STRIPE = 4 << 20
CD_BM_PROFILE = {"plugin": "jerasure", "technique": "liber8tion", "k": "8",
                 "m": "2"}
CD_BM_B, CD_BM_CELL, CD_BM_LOST, CD_SAMPLE = 256, 512 * KIB, (1, 6), 16
CD_CLAY_PROFILE = {"plugin": "clay", "k": "4", "m": "2", "d": "5"}
CD_CLAY_B, CD_CLAY_SAMPLE, CD_CLAY_LOST, CD_CLAY_REPAIR = 64, 8, (1, 4), 2
CD_LRC_PROFILE = {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}
CD_LRC_B, CD_LRC_LOST = 256, 0
#: The codecs phase's ECBatcher at the OSD's 4 KiB cells, per mix
#: (submissions, stripes per submission, concurrent submitters): Clay
#: rebuilds of chunk CD_ECB_REPAIR and liber8tion full-object writes.
CD_ECB_MIXES = {"clay_recovery": (64, 128, 16),
                "liber8tion_write": (64, 128, 16)}
CD_ECB_REPAIR = 2
#: osd_ec_cold_shape_bytes for that batcher: the Clay rebuilds move 84 MB
#: of helper slices, under the default 256 MiB that would keep every round
#: on the host engine. A warm-up crosses it before the timed mix.
CD_ECB_COLD_BYTES = 8 << 20

#: The msg phase: the cluster wire carrying an EC pool's fan-out. One
#: ECBatcher at the OSD's defaults (ECB_SU cells, target ECB_TARGET, window
#: ECB_WINDOW) over jerasure reed_sol_van k=8, m=3 encodes objects of RBD's
#: default 4 MiB (128 stripes each), MSG_CONCURRENCY at a time; the primary
#: ships each shard's cells and (cell, crc) patch to its own receiver in an
#: MECSubWrite, then reads every object back from the 9 shards other than
#: MSG_LOST and rebuilds those two from MSG_PRESENT. Objects per transport:
#: MSG_OBJECTS (1 GiB), cut to half on the two TCP transports, which take
#: ~13 and ~18 s at the full count on the H100's host; secure mode needs the
#: ``cryptography`` package.
MSG_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
               "k": "8", "m": "3"}
MSG_OBJECT_BYTES, MSG_OBJECTS = 4 << 20, 256
MSG_TRANSPORTS = {"localbus": MSG_OBJECTS, "tcp": MSG_OBJECTS // 2,
                  "tcp_sign": MSG_OBJECTS // 2, "shm": MSG_OBJECTS}
MSG_CONCURRENCY = 16
MSG_LOST, MSG_PRESENT = (1, 6), PRESENT
MSG_PGID, MSG_EPOCH = (2, 0x1F), 1
#: Seconds a sub-op may wait for its reply before the phase fails.
MSG_TIMEOUT_S = 60.0

#: The cluster phase: the cluster tier in one process, an RBD deployment.
#: A TestCluster of CL_OSDS OSDs (MemStores over LocalBus) with an RBD data
#: pool on jerasure reed_sol_van k=8, m=3 (the main path's code, Ceph's
#: default 4 KiB stripe unit) and a replicated size-3 pool, each of
#: CL_PG_NUM PGs (Ceph's osd_pool_default_pg_num). Objects of RBD's 4 MiB:
#: CL_OBJECTS on the EC pool (1 GiB) and CL_REP_OBJECTS on the replicated
#: one, through the client's aio window (client_max_inflight, default 64);
#: CL_OVERWRITES fio-style randwrite bs=4k overwrites on the EC objects;
#: OSDs CL_KILLED killed, everything read degraded and CL_DEGRADED_WRITES
#: more objects written to each pool; both revived and recovered. The mon
#: marks a dead OSD out after CL_OUT_INTERVAL s (Ceph's noout for a
#: maintenance window: no remap while they are down). The OSDs' cold-shape
#: shield is off (osd_ec_cold_shape_bytes 0; default 256 MiB): it keeps a
#: decode pattern's first rounds on the host engine to hide a cold XLA
#: compile in the JAX package, and the port's kernels are built before the
#: phase. At the default no pattern of this phase would reach the card: an
#: OSD serves ~85 MiB of degraded reads and ~11 MiB of rebuilds per
#: pattern here. Every decode round must run on K1.
CL_OSDS, CL_PG_NUM = 12, 32
CL_EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "8", "m": "3"}
CL_EC_POOL, CL_REP_POOL = 2, 1
CL_OBJECT_BYTES, CL_OBJECTS, CL_REP_OBJECTS = 4 << 20, 256, 32
CL_OVERWRITES, CL_OVERWRITE_BYTES = 1024, 4096
CL_KILLED, CL_DEGRADED_WRITES = (1, 6), 32
CL_OUT_INTERVAL = 600.0
CL_COLD_SHAPE_BYTES = 0
#: Seconds the client may retry an op, and the cluster may take to become
#: active+clean, before the phase fails.
CL_OP_TIMEOUT_S, CL_CLEAN_TIMEOUT_S = 120.0, 300.0
#: The batches K1 and K2 are timed at alone after the phase: the write
#: step's mean encode batch, the degraded read's mean decode batch, and
#: phase msg's 2,048-stripe LocalBus batch.
CL_TIMED = ("cluster_wb", "cluster_rb", "msg_b2048")
#: The seeded thrash verdict (tools/thrash.py --seed 20260803: rs k=3,
#: m=2 on 5 OSDs), cut to the 4 s of tests/test_fabric.py's proc thrash.
CL_THRASH = ["--seed", "20260803", "--duration", "4"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the uint32 values two int32 word tensors hold."""
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max().item()) if a.numel() else 0


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card, CUDA events per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_once(fn) -> tuple[float, object]:
    """Milliseconds of one call of ``fn`` on the card (CUDA events) and
    what it returned."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def profiled(run, pads=PROFILE_PADS_S) -> tuple[list, dict]:
    """Run ``run()`` under torch.profiler with the capture window padded
    (``pads``, seconds tried in turn) until the trace holds one device
    record per kernel launch the host made, else keep the trace that held
    most -> (its
    device events, {launches, kernel records caught, the pad, the kernel
    records caught at each pad tried, the first device record's start
    minus the first launch call's start in ms: under a millisecond when
    the card's and the host's clocks agree})."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    caught, best = [], None
    for pad in pads:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            run()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [e for e in prof.events() if e.device_type == cuda]
        calls = [e.time_range.start for e in prof.events()
                 if e.device_type == cpu and e.name in LAUNCH_CALLS]
        kernels = sum(not e.name.lower().startswith(("memcpy", "memset"))
                      for e in events)
        caught.append(kernels)
        if best is None or kernels > best[1]["caught"]:
            lag = (min(e.time_range.start for e in events) - min(calls)
                   if events and calls else None)
            best = events, {"launches": len(calls), "caught": kernels,
                            "pad_s": pad, "launch_to_device_ms":
                            None if lag is None else lag / 1e3}
        if kernels == len(calls):
            break
    best[1]["caught_by_pad"] = caught
    return best


def kernel_name(e) -> str:
    name = e.name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].split("<")[0].split("::")[-1]


def profile_steps(step, reps: int = 10) -> dict:
    """Run ``step`` ``reps`` times back to back under torch.profiler
    (``profiled``): each kernel's device ms per step, and the share of
    the window from the first to the last device event in which the card
    was idle (null when no record was caught). A kernel's ms per step is
    the mean of its caught records times its launches per step (its
    records over ``reps``, rounded), so a dropped record does not lower
    it; the idle share counts only caught records."""
    step()
    torch.cuda.synchronize()
    events, clock = profiled(lambda: [step() for _ in range(reps)])
    spans = [e.time_range for e in events]
    durations = {}
    for e in events:
        durations.setdefault(kernel_name(e), []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    per_kernel = {name: statistics.fmean(d) * max(1, round(len(d) / reps))
                  for name, d in durations.items()}
    if not spans:
        return {"device_events": 0, **clock, "idle_share": None,
                "ms_per_step": {}}
    window = max(s.end for s in spans) - min(s.start for s in spans)
    busy = sum(s.end - s.start for s in spans)
    return {"device_events": len(spans), **clock,
            "idle_share": 1 - busy / window, "window_ms": window / 1e3,
            "ms_per_step": per_kernel}


def device_ms(prof: dict) -> float | None:
    """Device ms per step of a profiled step, null when no record of it
    was caught."""
    return sum(prof["ms_per_step"].values()) if prof["ms_per_step"] else None


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card (ms): the larger of the bytes over the HBM
    rate and the operations over the int8 tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_work(b: int, rows: int, cols: int, w: int) -> tuple[float, float]:
    """Bytes: C words in and R words out per column. Operations: the GF(2)
    bit-matrix product (the least work form, on int8 tensor cores),
    2 * 8R * 8C per byte position."""
    return 4.0 * b * w * (rows + cols), 2.0 * 64 * rows * cols * 4 * b * w


def crc_work(n: int, w: int) -> tuple[float, float]:
    """Bytes: every word in once, one CRC out per blob. Operations: the
    GF(2) product (N, 32W) x (32W, 32) on int8 tensor cores."""
    return 4.0 * n * w + 4.0 * n, 2.0 * 32 * 32 * n * w


def random_bytes(rng, shape) -> np.ndarray:
    """uint8 array of ``shape`` from the smoke's generator (drawn as
    64-bit words: ~5x faster than ``rng.bytes`` at a GiB)."""
    n = int(np.prod(shape))
    words = rng.integers(0, 2**64 - 1, -(-n // 8), dtype=np.uint64,
                         endpoint=True)
    return words.view(np.uint8)[:n].reshape(shape)


def copy_rates() -> dict:
    """The card's pinned host<->device copy rates (GB/s), median of 5
    copies of COPY_BYTES each way, timed with CUDA events."""
    host = torch.empty(COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True), reps=5)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True), reps=5)
    return {"h2d_GB_per_s": COPY_BYTES / h2d / 1e6,
            "d2h_GB_per_s": COPY_BYTES / d2h / 1e6, "bytes": COPY_BYTES}


def span_union(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_split(run, pads=PROFILE_PADS_S) -> dict:
    """Run ``run()`` under torch.profiler (``profiled``): device ms
    of host-to-device copies, kernels and device-to-host copies, and the
    idle share of the window from the first to the last device event
    (the union of every stream's events is the busy time), over the
    records caught."""
    return device_split(*profiled(run, pads))


def events_split(prof) -> dict:
    """``device_split`` of one finished torch.profiler trace."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    calls = sum(e.device_type == cpu and e.name in LAUNCH_CALLS
                for e in prof.events())
    kernels = sum(not e.name.lower().startswith(("memcpy", "memset"))
                  for e in events)
    return device_split(events, {"launches": calls, "caught": kernels})


def device_split(events, clock: dict) -> dict:
    """Device ms of HtoD copies, kernels and DtoH copies among ``events``
    and the idle share of their window (see ``profile_split``)."""
    split = {"htod_ms": 0.0, "kernels_ms": 0.0, "dtoh_ms": 0.0,
             "other_ms": 0.0}
    spans = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        name = e.name.lower()
        key = ("htod_ms" if "htod" in name else "dtoh_ms" if "dtoh" in name
               else "other_ms" if "memcpy" in name or "memset" in name
               else "kernels_ms")
        split[key] += (b - a) / 1e3
    if not spans:
        return {"device_events": 0, "idle_share": None, **split}
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return {"device_events": len(spans), "window_ms": window / 1e3,
            **clock, "idle_share": 1 - span_union(spans) / window, **split}


async def drive_async(submit, n: int, concurrency: int, state: dict):
    """``n`` submissions ``submit(i)`` from ``concurrency`` concurrent
    submitters on the running event loop -> (results, per-submission
    seconds, wall seconds). ``state["inflight"]`` counts submissions in
    flight (what the OSD's op tracker counts for its idle probe)."""
    results, lat = [None] * n, [0.0] * n
    order = iter(range(n))

    async def worker():
        for i in order:
            state["inflight"] += 1
            t0 = time.perf_counter()
            try:
                results[i] = await submit(i)
            finally:
                state["inflight"] -= 1
            lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    await asyncio.gather(*[worker() for _ in range(concurrency)])
    return results, lat, time.perf_counter() - t0


def drive(submit, n: int, concurrency: int, state: dict):
    """``drive_async`` on an event loop of its own."""
    return asyncio.run(drive_async(submit, n, concurrency, state))


def counter_delta(after: dict, before: dict) -> dict:
    """The perf counters a mix moved: u64 deltas, histogram count/sum
    deltas."""
    out = {}
    for key, v in after.items():
        if isinstance(v, dict):
            out[key] = {f: v[f] - before[key][f] for f in ("count", "sum")}
        else:
            out[key] = v - before[key]
    return out


def host_parts(batcher, codec, views: list, reps: int = 10) -> dict:
    """Where one encode batch made of ``views`` (the submissions it
    carries) spends host time, medians of ``reps`` on the host clock:
    the reactor's ``np.concatenate``, the worker's copy into pinned
    memory alone, and the worker's whole dispatch (``_encode_sync``:
    pinned copy, transfers, both kernels, the wait)."""
    def median_s(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    cells = np.concatenate(views)
    pinned = torch.empty(cells.shape, dtype=torch.uint8, pin_memory=True)
    return {"stripes": len(cells),
            "concat_ms": median_s(lambda: np.concatenate(views)) * 1e3,
            "pinned_copy_ms": median_s(
                lambda: np.copyto(pinned.numpy(), cells)) * 1e3,
            "dispatch_ms": median_s(
                lambda: batcher._encode_sync(codec, cells)) * 1e3}


def ecbatch_phase(dev, rng, rates: dict) -> dict:
    """Drive one ECBatcher over the three mixes, check every cell and CRC
    against the C++ host engine, print one line per mix and return the
    kernels' launch counts over the mixes and the batcher-shape times."""
    from ceph_tpu_torch import kernels, native
    from ceph_tpu_torch.cluster import FLUSH_REASONS, ECBatcher
    from ceph_tpu_torch.cluster.stripe import effective_stripe_unit
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.perf import PerfCounters

    k, m = MAIN_K, MAIN_M
    codec = load_codec({"plugin": "rs_tpu", "k": str(k), "m": str(m),
                        "technique": "reed_sol_van"}, device=dev)
    su = effective_stripe_unit(codec, ECB_SU)
    check(su == ECB_SU, f"stripe unit {su} != {ECB_SU}")
    conf = config.proxy()
    conf.apply({"osd_ec_batch_target_stripes": ECB_TARGET,
                "osd_ec_batch_window": ECB_WINDOW})
    perf = PerfCounters("osd.0")
    ECBatcher.declare_counters(perf)
    state = {"inflight": 0}
    # the OSD's rule (cluster/osd.py): idle when every op in flight is
    # parked on the batcher
    batcher = ECBatcher(perf, conf=conf,
                        idle_probe=lambda: state["inflight"]
                        <= batcher.parked())
    threads = 8

    def native_parity(shard_major: np.ndarray) -> np.ndarray:
        """(k, S, su) data rows -> (S, m, su) parity, the host engine."""
        s = shard_major.shape[1]
        par = native.rs_encode(codec.matrix, shard_major.reshape(k, -1),
                               threads=threads)
        return par.reshape(m, s, su).transpose(1, 0, 2)

    def check_crcs(cells: np.ndarray, crcs: np.ndarray, what: str) -> None:
        want = native.crc32c_batch(cells.reshape(-1, su), threads=threads)
        check(np.array_equal(crcs.reshape(-1), want), f"{what} CRCs")

    lines, launches = {}, {kk.name: 0 for kk in kernels.KERNELS}

    def run_mix(name, submit, per_stripe_h2d, per_stripe_d2h):
        n, per, conc = ECB_MIXES[name]
        before = perf.dump()
        kernels.reset_counts()
        results, lat, wall = drive(submit, n, conc, state)
        counts = {kk.name: kk.launches for kk in kernels.KERNELS}
        for kk, v in counts.items():
            launches[kk] += v
        d = counter_delta(perf.dump(), before)
        hist = d["ec_batch_stripes" if name != "recovery"
                 else "ec_decode_stripes"]
        stripes = n * per
        h2d, d2h = stripes * per_stripe_h2d, stripes * per_stripe_d2h
        lat_ms = np.array(lat) * 1e3
        lines[name] = {
            "phase": "ecbatch", "mix": name, "submissions": n,
            "stripes_per_submission": per, "concurrency": conc,
            "stripe_unit": su, "data_bytes": stripes * k * su,
            "wall_s": wall, "stripes_per_s": stripes / wall,
            "data_GiB_per_s": stripes * k * su / wall / 2**30,
            "lat_p50_ms": float(np.percentile(lat_ms, 50)),
            "lat_p99_ms": float(np.percentile(lat_ms, 99)),
            "batches": hist["count"],
            "mean_stripes_per_batch": hist["sum"] / max(1, hist["count"]),
            "flush": {r: d[f"ec_flush_{r}"] for r in FLUSH_REASONS},
            "ec_decode_cold_host": d["ec_decode_cold_host"],
            "ec_batch_failures": d["ec_batch_failures"],
            "launches": counts, "h2d_bytes": h2d, "d2h_bytes": d2h,
            "copy_bound_ms": max(h2d / rates["h2d_GB_per_s"],
                                 d2h / rates["d2h_GB_per_s"]) / 1e6}
        check(d["ec_batch_failures"] == 0, f"{name}: a batch failed")
        return results

    # write_4m: full-object writes; each op's cells are the (T, k, su)
    # transpose of its shard-major staging rows, as the PG submits them
    n, per, _ = ECB_MIXES["write_4m"]
    wdata = random_bytes(rng, (n, k, per, su))
    write_submit = (lambda i: batcher.encode_cells(
        codec, wdata[i].transpose(1, 0, 2)))
    out = run_mix("write_4m", write_submit, k * su, m * su + 4 * (k + m))
    wparity = np.stack([p for p, _ in out])      # (n, per, m, su)
    for i in range(n):
        check(np.array_equal(wparity[i], native_parity(wdata[i])),
              f"write_4m parity of submission {i}")
        check_crcs(np.concatenate([wdata[i].transpose(1, 0, 2), wparity[i]],
                                  axis=1), out[i][1], f"write_4m {i}")
    check(all(lines["write_4m"]["launches"][k] > 0
              for k in ("gf_matmul", "crc32c")),
          f"write_4m launches {lines['write_4m']['launches']}")
    emit(lines["write_4m"])

    # rmw_4k: one-stripe overwrites
    n, per, _ = ECB_MIXES["rmw_4k"]
    rdata = random_bytes(rng, (n, k, per, su))
    out = run_mix("rmw_4k", lambda i: batcher.encode_cells(
        codec, rdata[i].transpose(1, 0, 2)), k * su, m * su + 4 * (k + m))
    rparity = np.concatenate([p for p, _ in out])  # (n * per, m, su)
    check(np.array_equal(rparity, native_parity(np.ascontiguousarray(
        rdata.transpose(1, 0, 2, 3)).reshape(k, n * per, su))),
        "rmw_4k parity")
    check_crcs(np.concatenate([rdata.transpose(0, 2, 1, 3).reshape(
        n * per, k, su), rparity], axis=1),
        np.concatenate([c for _, c in out]), "rmw_4k")
    emit(lines["rmw_4k"])

    # recovery: shards 1 and 6 lost; survivors from write_4m's cells
    n, per, _ = ECB_MIXES["recovery"]
    check(n == ECB_MIXES["write_4m"][0] and per == ECB_MIXES["write_4m"][1],
          "recovery rebuilds write_4m's stripes")
    every = np.concatenate([wdata.transpose(0, 2, 1, 3), wparity], axis=2)
    surv = np.ascontiguousarray(every[:, :, list(PRESENT)])
    rmat = codec.decode_matrix_for(PRESENT, ECB_WANT)
    out = run_mix("recovery", lambda i: batcher.decode_cells(
        codec, PRESENT, ECB_WANT, surv[i]), k * su, len(ECB_WANT) * su)
    for i in range(n):
        flat = surv[i].transpose(1, 0, 2).reshape(k, -1)
        want = native.rs_matmul(rmat, flat, threads=threads)
        check(np.array_equal(out[i].transpose(1, 0, 2).reshape(
            len(ECB_WANT), -1), want), f"recovery {i} vs host engine")
        check(np.array_equal(out[i], every[i][:, list(ECB_WANT)]),
              f"recovery {i} vs the original cells")
    rec = lines["recovery"]
    device_rounds = rec["batches"] - rec["ec_decode_cold_host"]
    check(rec["ec_decode_cold_host"] > 0 and device_rounds > 0,
          f"recovery: {rec['ec_decode_cold_host']} host rounds and "
          f"{device_rounds} device rounds")
    read = asyncio.run(batcher.decode_cells(
        codec, ECB_READ_PRESENT, ECB_READ_WANT,
        np.ascontiguousarray(every[0][:, list(ECB_READ_PRESENT)])))
    check(np.array_equal(read, every[0][:, list(ECB_READ_WANT)]),
          "degraded read of shards 1 and 9")
    rec["device_rounds"] = device_rounds
    rec["warm_s"] = {f"{key[3]}->{key[4]}": v
                     for key, v in batcher.warm_seconds.items()}
    emit(rec)
    del surv, every, out

    # the write mix again under the profiler: HtoD / kernels / DtoH
    again = []

    def write_again():
        res, _, wall = drive(write_submit, ECB_MIXES["write_4m"][0],
                             ECB_MIXES["write_4m"][2], state)
        again.append((res, wall))

    split = profile_split(write_again)
    res, wall = again[0]
    check(all(np.array_equal(p, wparity[i]) for i, (p, _) in
              enumerate(res)), "write_4m under the profiler")
    emit({"phase": "ecbatch_profile", "mix": "write_4m", "wall_s": wall,
          **split})

    # host time of one batch of each encode mix, by part
    conc = ECB_MIXES["write_4m"][2]
    parts = {"write_4m": host_parts(batcher, codec, [
        wdata[i].transpose(1, 0, 2) for i in range(conc)]),
        "rmw_4k": host_parts(batcher, codec, [
            rdata[i].transpose(1, 0, 2) for i in range(ECB_TARGET)])}
    for name, part in parts.items():
        part["batch_ms_in_mix"] = (lines[name]["wall_s"] * 1e3
                                   / lines[name]["batches"])
    emit({"phase": "ecbatch_host_parts", **parts})

    # both kernels at the batcher's shapes: one 64-stripe batch of cells.
    # A call's event time there is mostly the host's launch path; the
    # profiler's device time is the kernel's own
    timed = batch_times(dev, rng, codec, ECB_TARGET, su, "batch")
    return {"launches": launches, "timed": timed}


def batch_times(dev, rng, codec, b: int, su: int, tag: str) -> dict:
    """K1 (encode to the m parities, decode of ECB_WANT from PRESENT) and
    K2 (the CRCs of data and parity where they lie) on one batch of ``b``
    stripes of ``su``-byte cells, each against its plain version: CUDA
    event ms, plain ms, bound, profiler device ms. Prints a ``time`` line
    each -> {"gf_<tag>_write", "gf_<tag>_decode", "crc_<tag>_write": ...}."""
    from ceph_tpu_torch.device import words_to_tensor
    from ceph_tpu_torch.ops import crc32c as crc_ops
    from ceph_tpu_torch.ops import rs

    k, m, w = codec.k, codec.m, su // 4
    x = words_to_tensor(rng.integers(0, 2**32, (b, k, w), dtype=np.uint32),
                        dev)
    par = rs.gf_matmul(codec.matrix, x)
    rm = codec.decode_matrix_for(PRESENT, ECB_WANT)
    cases = {
        f"gf_{tag}_write": (lambda: rs.gf_matmul(codec.matrix, x),
                            lambda: rs.gf_matmul_plain(codec.matrix, x),
                            gf_work(b, m, k, w)),
        f"gf_{tag}_decode": (lambda: rs.gf_matmul(rm, x),
                             lambda: rs.gf_matmul_plain(rm, x),
                             gf_work(b, len(ECB_WANT), k, w)),
        f"crc_{tag}_write": (lambda: crc_ops.crc0_cells(x, par),
                             lambda: crc_ops.crc0_words_plain(
                                 torch.cat([x, par], dim=1)),
                             crc_work(b * (k + m), w)),
    }
    timed = {}
    for key, (kernel, plain, (nbytes, ops)) in cases.items():
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"{key}: kernel and plain differ by {err}")
        ms, plain_ms = time_ms(kernel, reps=50), time_ms(plain)
        b_ms, b_by = bound(nbytes, ops)
        prof = profile_steps(kernel, reps=20)
        timed[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err,
                      "device_ms": device_ms(prof), "stripes": b}
        emit({"phase": "time", "what": key, **timed[key],
              "profile": {k: prof[k] for k in PROFILE_CLOCK}})
    return timed


def rule_bound(draws: int, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for ``draws`` straw2 draws on the int32 ALUs
    (STRAW2_OPS_PER_DRAW each at INT32_OPS_PER_S), or ``nbytes`` over
    HBM, whichever is larger."""
    t_ops = draws * STRAW2_OPS_PER_DRAW / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rule_edge_maps() -> dict:
    """Maps at the edges of crush_rule.cu's lane groups, as name: (CrushMap,
    rule, numrep, reweights or None): flat and two-level (n hosts of n
    OSDs) maps with buckets of each of PL_EDGE_SIZES items under a firstn
    and an indep rule, some OSDs out or at half weight; an all-zero-weight
    bucket, flat and as a host; an empty host bucket; a tree of uneven
    depth (a root over a rack of hosts and a bare host); indep at numrep
    256 over 300 OSDs; the legacy and vary_r tunables. Weights and
    reweights from a fixed seed."""
    from ceph_tpu_torch.placement import crushmap as cm

    rng = np.random.default_rng(20261018)

    def reweights(n, k=1):
        w = np.full(n, 0x10000, dtype=np.uint32)
        if n > 2:
            picked = rng.choice(n, 2 * k, replace=False)
            w[picked[:k]] = 0
            w[picked[k:]] = 0x8000
        return w

    def with_rules(m, *rules):
        for rule in rules:
            m.add_rule(rule)
        return m

    cases = {}
    for n in PL_EDGE_SIZES:
        flat = with_rules(cm.build_flat(n, rng.uniform(0.25, 4, n)),
                          cm.flat_firstn_rule(0),
                          cm.ec_rule(1, root=-1, failure_domain_type=0))
        w = reweights(n)
        cases[f"flat{n}_firstn"] = (flat, 0, 3, w)
        cases[f"flat{n}_indep"] = (flat, 1, 5, w)
        tree = with_rules(cm.build_hierarchy(osds_per_host=n, n_hosts=n),
                          cm.replicated_rule(0, root=-1,
                                             failure_domain_type=1),
                          cm.ec_rule(1, root=-1, failure_domain_type=1))
        w = reweights(n * n, k=max(1, n // 4))
        cases[f"tree{n}_firstn"] = (tree, 0, 3, w)
        cases[f"tree{n}_indep"] = (tree, 1, 6, w)
    zero = with_rules(cm.build_flat(5, osd_weights=[0] * 5),
                      cm.flat_firstn_rule(0),
                      cm.ec_rule(1, root=-1, failure_domain_type=0))
    cases["zero_flat_firstn"] = (zero, 0, 3, None)
    cases["zero_flat_indep"] = (zero, 1, 4, None)
    zhost = with_rules(cm.build_hierarchy(osds_per_host=4, n_hosts=5),
                       cm.replicated_rule(0, root=-1, failure_domain_type=1),
                       cm.ec_rule(1, root=-1, failure_domain_type=1))
    zhost.buckets[-3].weights = [0] * 4  # still weighted in the root
    cases["zero_host_firstn"] = (zhost, 0, 3, None)
    cases["zero_host_indep"] = (zhost, 1, 5, None)
    empty = cm.build_hierarchy(osds_per_host=3, n_hosts=4)
    empty.add_bucket(cm.Bucket(id=-6, type_id=1, items=[], weights=[],
                               name="host4"))
    empty.buckets[-1].items.append(-6)
    empty.buckets[-1].weights.append(0x30000)  # weighted, but empty
    with_rules(empty, cm.replicated_rule(0, root=-1, failure_domain_type=1),
               cm.ec_rule(1, root=-1, failure_domain_type=1))
    cases["empty_host_firstn"] = (empty, 0, 3, None)
    cases["empty_host_indep"] = (empty, 1, 4, None)
    uneven = cm.CrushMap()
    for t, name in ((1, "host"), (2, "rack"), (3, "root")):
        uneven.add_type(t, name)
    osd = 0
    for h, n in enumerate((3, 40, 7, 2)):
        uneven.add_bucket(cm.Bucket(
            id=-2 - h, type_id=1, items=list(range(osd, osd + n)),
            weights=[int(v) for v in rng.integers(0x4000, 0x30000, n)],
            name=f"host{h}"))
        osd += n
    uneven.add_bucket(cm.Bucket(
        id=-6, type_id=2, items=[-2, -3, -4],
        weights=[uneven.buckets[b].weight() for b in (-2, -3, -4)],
        name="rack0"))
    uneven.add_bucket(cm.Bucket(
        id=-1, type_id=3, items=[-6, -5],
        weights=[uneven.buckets[-6].weight(), 0x40000], name="root"))
    with_rules(uneven, cm.replicated_rule(0, root=-1, failure_domain_type=1),
               cm.ec_rule(1, root=-1, failure_domain_type=1))
    cases["uneven_depth_firstn"] = (uneven, 0, 3, reweights(osd, 3))
    cases["uneven_depth_indep"] = (uneven, 1, 4, reweights(osd, 3))
    wide = with_rules(cm.build_flat(300),
                      cm.ec_rule(0, root=-1, failure_domain_type=0))
    cases["indep256_flat300"] = (wide, 0, 256, reweights(300, 10))
    for name, tunables in (
            ("legacy_tunables", cm.Tunables(chooseleaf_stable=0,
                                            chooseleaf_vary_r=0)),
            ("vary_r_2", cm.Tunables(chooseleaf_vary_r=2,
                                     chooseleaf_descend_once=0))):
        m = cm.build_hierarchy(osds_per_host=4, n_hosts=5)
        m.tunables = tunables
        m.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
        cases[name] = (m, 0, 3, reweights(20, 2))
    return cases


def placement_phase(dev) -> dict:
    """Drive the CRUSH placement slice on the card (see the module
    docstring), print one line per step and return the kernels' launch
    counts on its main path and their timed entries."""
    import os

    from ceph_tpu_torch import kernels, native
    from ceph_tpu_torch.ops import crush
    from ceph_tpu_torch.placement import bulk, tester
    from ceph_tpu_torch.placement import crushmap as cm
    from ceph_tpu_torch.placement import resolver as rmod
    from ceph_tpu_torch.placement.osdmap import Incremental, OSDMap, Pool

    threads = os.cpu_count() or 1

    def t32(a) -> torch.Tensor:  # uint32/int32 numpy -> int32 on the card
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                .copy()).to(dev)

    # config 5's inputs, drawn as bench.py draws them
    rng = np.random.default_rng(PL_SEED)
    items = np.arange(PL_OSDS, dtype=np.int32)
    weights = rng.integers(1, 4 * 0x10000, PL_OSDS, dtype=np.uint32)
    xs = rng.integers(0, 2**32, PL_X, dtype=np.uint32)

    # ---- straw2 kernel against its plain version, edges included
    erng = np.random.default_rng(20261017)
    ids = erng.integers(-2**31, 2**31, PL_OSDS).astype(np.int32)
    zeq = weights.copy()
    zeq[::7] = 0
    zeq[1::5] = 0x10000
    wide = erng.integers(1, 4 * 0x10000, 2500, dtype=np.uint32)
    probe = torch.arange(0, 1 << 24, dtype=torch.int64, device=dev)
    wrap = probe[(crush.hash32_3(probe, int(items[0]), 3) & 0xFFFF)
                 == 0xFFFF][:256].cpu().numpy().astype(np.uint32)
    check(len(wrap) > 0, "inputs reaching u = 0xffff")
    sub = xs[:PL_CHECK_X]
    edge = {  # name: (items, ids, weights, xs, r)
        "65536x1000": (items, items, weights, sub, 0),
        "n1": (items[:1], items[:1], weights[:1], sub[:5000], 1),
        "ragged": (items, items, weights, xs[:PL_CHECK_X + 77], 2),
        "zero_and_equal": (items, items, zeq, sub, 0),
        "ids_not_items": (items, ids, weights, sub, 5),
        "u_0xffff": (items, items, weights, np.concatenate([wrap, sub[:999]]),
                     3),
        "tiles_2500": (np.arange(2500, dtype=np.int32),
                       np.arange(2500, dtype=np.int32), wide, sub[:20000], 0),
        "all_zero": (items[:5], items[:5], np.zeros(5, np.uint32), sub[:999],
                     0),
    }
    errs = {}
    for name, (it, hid, w, x, r) in edge.items():
        args = (t32(it), t32(hid), t32(w), t32(x), r)
        got = crush.straw2_choose(*args)
        errs[name] = max_abs_err(got, crush.straw2_choose_plain(*args))
        check(errs[name] == 0, f"straw2 {name}: kernel and plain differ by "
                               f"{errs[name]}")
    del probe
    emit({"phase": "placement_straw2_vs_plain", "cases": list(edge),
          "u_0xffff_inputs": len(wrap), "max_abs_err": max(errs.values())})

    # ---- the rule kernel against its plain version
    tree = cm.build_hierarchy(osds_per_host=PL_PER_HOST, n_hosts=PL_HOSTS)
    tree.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    tree.add_rule(cm.ec_rule(1, root=-1, failure_domain_type=1))
    rw = np.full(PL_OSDS, 0x10000, dtype=np.uint32)
    picked = erng.choice(PL_OSDS, PL_OUT + PL_HALF + PL_INC_OUT,
                         replace=False)
    out_osds = picked[:PL_OUT]
    half_osds = picked[PL_OUT:PL_OUT + PL_HALF]
    inc_out = [int(o) for o in picked[PL_OUT + PL_HALF:]]
    rw[out_osds] = 0
    rw[half_osds] = 0x8000
    comp = bulk.CompiledMap(tree)
    arrays = comp.arrays_on(dev)
    rw_t, xs_t, sub_t = t32(rw), t32(xs), t32(sub)
    rules = {name: comp.compile_rule(rule, numrep)
             for name, (rule, numrep) in PL_RULES.items()}

    lanes = bulk.card_lanes(dev)

    def group(nx):  # the lanes an input takes in a batch of nx
        return bulk.group_width(comp.widest(-1), nx, lanes)

    def rows_kernel(name, x, draws=None):
        return bulk.rule_rows(comp, rw_t, x, rules[name], PL_RULES[name][1],
                              draws)

    def rows_plain(name, x, draws=None, step=1 << 18):
        return torch.cat([bulk.rule_rows_plain(
            comp, rw_t, x[lo:lo + step], rules[name], PL_RULES[name][1],
            draws) for lo in range(0, x.shape[0], step)])

    def zero_count():
        return torch.zeros(1, dtype=torch.int64, device=dev)

    # the draws of the check inputs, counted by the kernel and by the
    # plain version (the bucket's size per choose of an input)
    plain_rows, check_draws = {}, {}
    for name in PL_RULES:
        kd, pd = zero_count(), zero_count()
        plain_rows[name] = rows_plain(name, sub_t, pd)
        errs[name] = max_abs_err(rows_kernel(name, sub_t, kd),
                                 plain_rows[name])
        check(errs[name] == 0, f"crush_rule {name}: kernel and plain differ "
                               f"by {errs[name]}")
        check(int(kd.item()) == int(pd.item()),
              f"crush_rule {name}: the kernel counted {int(kd.item())} "
              f"draws, the plain version {int(pd.item())}")
        check_draws[name] = int(kd.item())
    emit({"phase": "placement_rule_vs_plain", "rules": list(PL_RULES),
          "inputs": PL_CHECK_X, "out": PL_OUT, "half_weight": PL_HALF,
          "group": group(PL_CHECK_X), "draws": check_draws,
          "draws_equal": True,
          "max_abs_err": max(errs[name] for name in PL_RULES)})

    # ---- the rule kernel at the edges of its lane groups (bucket sizes
    # either side of 32 and 64, zero weights, an empty bucket, uneven
    # depth, rows of 256, the legacy tunables), rows and draws against the
    # plain version on the same inputs, a ragged count of them, at both
    # widths group_width can choose for a map (a batch the card holds
    # whole, one that fills it)
    xrng = np.random.default_rng(20261019)
    edge_groups = {}
    for ename, (emap, ruleno, numrep, ew) in rule_edge_maps().items():
        ecomp = bulk.CompiledMap(emap)
        erule = ecomp.compile_rule(ruleno, numrep)
        ew_t = t32(np.full(ecomp.max_devices, 0x10000, dtype=np.uint32)
                   if ew is None else ew)
        ex_t = t32(xrng.integers(0, 2**32, PL_EDGE_X, dtype=np.uint32))
        pd = zero_count()
        want = bulk.rule_rows_plain(ecomp, ew_t, ex_t, erule, numrep, pd)
        widths = sorted({bulk.group_width(ecomp.widest(erule.take), n, lanes)
                         for n in (1, PL_X)})
        err = 0
        for width in widths:
            kd = zero_count()
            err = max(err, max_abs_err(bulk.rule_rows(
                ecomp, ew_t, ex_t, erule, numrep, kd, width), want))
            check(int(kd.item()) == int(pd.item()),
                  f"crush_rule edge {ename}, {width} lanes: the kernel "
                  f"counted {int(kd.item())} draws, the plain version "
                  f"{int(pd.item())}")
        check(err == 0, f"crush_rule edge {ename}: kernel and plain differ "
                        f"by {err}")
        edge_groups[ename] = widths
        errs[f"edge_{ename}"] = err
    emit({"phase": "placement_rule_edges", "inputs": PL_EDGE_X,
          "groups": edge_groups, "draws_equal": True,
          "max_abs_err": max(errs[f"edge_{e}"] for e in edge_groups)})

    # ---- times: config 5 and each rule at full size, at the check shape
    # and at the resolver's batch (one size target of pgids); the rule
    # kernel's draws counted by the kernel itself. Each case's kernel
    # output is held against its plain version's, which is timed in the
    # same call. The plain rule engine takes minutes at 10 M inputs: at
    # full size the rule kernel's first PL_CHECK_X rows are held against
    # the plain rows of the check above (head_max_abs_err), and no plain
    # time is taken
    items_t, w_t = t32(items), t32(weights)
    timed = {}

    def time_case(key, nx, kernel, plain, draws, nbytes, reps=5,
                  head_ref=None, info=None):
        got = kernel()
        ms = time_ms(kernel, reps=reps, warmup=0)
        b_ms, b_by = rule_bound(draws, nbytes)
        prof = profile_steps(kernel, reps=3)
        timed[key] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                      "draws": draws,
                      "device_ms": device_ms(prof), **(info or {})}
        if plain is not None:
            timed[key]["plain_ms"], want = time_once(plain)
            timed[key]["max_abs_err"] = max_abs_err(got, want)
        else:
            timed[key]["max_abs_err"] = None
            timed[key]["head_max_abs_err"] = max_abs_err(
                got[:head_ref.shape[0]], head_ref)
            timed[key]["head_inputs"] = head_ref.shape[0]
        err = max(timed[key]["max_abs_err"] or 0,
                  timed[key].get("head_max_abs_err", 0))
        check(err == 0, f"{key}: kernel and plain differ by {err}")
        del got
        emit({"phase": "time", "what": key, "inputs": nx, **timed[key],
              "Mobj_per_s": nx / ms / 1e3, "share_of_bound": b_ms / ms,
              "profile": {k: prof[k] for k in PROFILE_CLOCK}})

    for key, x_t in (("straw2_config5", xs_t), ("straw2_65536", sub_t)):
        n = x_t.shape[0]
        time_case(key, n,
                  lambda x=x_t: crush.straw2_choose(items_t, items_t, w_t, x,
                                                    0),
                  lambda x=x_t: crush.straw2_choose_plain(items_t, items_t,
                                                          w_t, x, 0),
                  n * PL_OSDS, 12.0 * PL_OSDS + 8.0 * n)
    batch = t32(xs[PL_CHECK_X:PL_CHECK_X + 64])
    for name, (rule, numrep) in PL_RULES.items():
        for size, x_t in (("full", xs_t), ("65536", sub_t), ("64", batch)):
            key = f"crush_rule_{name}_{size}"
            count = zero_count()
            rows_kernel(name, x_t, count)
            check(int(count.item()) >= x_t.shape[0] * numrep,
                  f"{key}: the kernel counted {int(count.item())} draws")
            nbytes = (arrays[0].numel() * 8.0 + 8.0 * arrays[2].numel()
                      + 4.0 * PL_OSDS + 4.0 * x_t.shape[0] * (1 + numrep))
            time_case(key, x_t.shape[0],
                      lambda n=name, x=x_t: rows_kernel(n, x),
                      None if size == "full" else
                      lambda n=name, x=x_t: rows_plain(n, x),
                      int(count.item()), nbytes,
                      reps=3 if size == "full" else 20,
                      head_ref=plain_rows[name] if size == "full" else None,
                      info={"group": group(x_t.shape[0])})
    timed["placement_checks"] = {k: v for k, v in errs.items()
                                 if not k.startswith("edge_")}
    timed["placement_checks"]["rule_edges"] = max(
        errs[f"edge_{e}"] for e in edge_groups)

    # ---- the main path: config 5, the rule engine, the tester, the
    # resolver, all through the numpy/asyncio surfaces a user calls
    om = OSDMap(tree, PL_OSDS)
    for o in out_osds:
        om.osds[int(o)].weight = 0
    for o in half_osds:
        om.osds[int(o)].weight = 0x8000
    for name, (pid, size, pg_num, rule) in PL_POOLS.items():
        om.add_pool(Pool(id=pid, name=name, size=size, min_size=size - 2
                         if size > 3 else 2, pg_num=pg_num, crush_rule=rule,
                         type="erasure" if size > 3 else "replicated"))
    resolver = rmod.PlacementResolver(batch=True)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    placed = crush.straw2_bulk(items, weights, xs, r=0)
    bulk_s = time.perf_counter() - t0
    rows, rule_s = {}, {}
    for name, (rule, numrep) in PL_RULES.items():
        t0 = time.perf_counter()
        rows[name] = bulk.do_rule_bulk(comp, rule, xs, numrep, rw)
        rule_s[name] = time.perf_counter() - t0
    reports = {name: tester.test_rule(tree, rule, numrep, n_inputs=PL_X,
                                      weights=rw, device=True)
               for name, (rule, numrep) in PL_RULES.items()}
    k4_before = kernels.CRUSH_RULE.launches
    t0 = time.perf_counter()
    warmed = asyncio.run(resolver.prewarm(om, [p[0] for p in
                                               PL_POOLS.values()]))
    prewarm_s = time.perf_counter() - t0
    stats_warm = resolver.stats.dump()
    om.apply_incremental(Incremental(epoch=om.epoch + 1,
                                     weights={o: 0 for o in inc_out}))
    pgids = {p[0]: [(p[0], ps) for ps in range(p[2])]
             for p in PL_POOLS.values()}
    target = resolver._target()

    async def storm() -> dict:
        """Misses over every PG of both pools, in waves of one size
        target per pool (what concurrent ops of that many clients ask)."""
        got = {}
        waves = max(len(v) for v in pgids.values()) // target
        for w in range(waves):
            wave = [g for v in pgids.values()
                    for g in v[w * target:(w + 1) * target]]
            for g, row in zip(wave, await asyncio.gather(
                    *(resolver.afull(om, g) for g in wave))):
                got[g] = row
        return got

    t0 = time.perf_counter()
    served = asyncio.run(storm())
    storm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    k4_resolver = kernels.CRUSH_RULE.launches - k4_before
    stats = resolver.stats.dump()
    for name in ("straw2", "crush_rule"):
        check(launches[name] > 0, f"placement launched {name} "
                                  f"{launches[name]} times")

    # ---- checks against the host
    t0 = time.perf_counter()
    want = native.straw2_bulk(items, weights, xs[:PL_SUBSET],
                              threads=threads)
    host_s = time.perf_counter() - t0
    check(np.array_equal(placed[:PL_SUBSET], want),
          "config 5 against the host core")
    for name, (rule, numrep) in PL_RULES.items():
        for i in range(PL_ORACLE_X):
            row = tree.do_rule(rule, int(xs[i]), numrep, rw)
            check(list(rows[name][i]) == row + [cm.ITEM_NONE] * (
                numrep - len(row)), f"{name} x={xs[i]} against do_rule")
    check(k4_resolver >= stats["placement_batch_lookups"] > 0,
          f"{k4_resolver} rule launches for "
          f"{stats['placement_batch_lookups']} device batches")
    check(warmed == sum(len(v) for v in pgids.values()), "prewarm")
    check(len(served) == warmed, "every PG served")
    for g, row in served.items():
        check(tuple(row) == tuple(om.pg_to_up_acting_full(g)),
              f"resolver row of {g}")
    emit({"phase": "placement_config5", "inputs": PL_X, "osds": PL_OSDS,
          "seed": PL_SEED, "wall_s": bulk_s, "Mobj_per_s": PL_X / bulk_s
          / 1e6, "host_subset": PL_SUBSET, "host_threads": threads,
          "host_Mobj_per_s": PL_SUBSET / host_s / 1e6, "exact": True})
    for name, (rule, numrep) in PL_RULES.items():
        rep = reports[name]
        emit({"phase": "placement_rule", "rule": name, "numrep": numrep,
              "inputs": PL_X, "wall_s": rule_s[name],
              "Mobj_per_s": PL_X / rule_s[name] / 1e6,
              "oracle_inputs": PL_ORACLE_X, "exact": True,
              "tester_max_deviation": rep.max_deviation(tree),
              "tester_bad_mappings": len(rep.bad_mappings)})
    emit({"phase": "placement_resolver", "pgids": warmed,
          "pools": {k: {"size": v[1], "pg_num": v[2]}
                    for k, v in PL_POOLS.items()},
          "prewarm_s": prewarm_s, "prewarm_pgids_per_s": warmed / prewarm_s,
          "marked_out": len(inc_out), "storm_s": storm_s,
          "storm_pgids_per_s": len(served) / storm_s,
          "counters_after_prewarm": stats_warm, "counters": stats,
          "crush_rule_launches": k4_resolver,
          "exact": True})
    emit({"phase": "placement_launches", **launches})
    del placed, rows, reports, served, plain_rows
    return {"launches": launches, "timed": timed}


def csum_call_split(cs, blocks: np.ndarray, reps: int) -> dict:
    """One store checksum call (``Checksummer.calculate(blocks,
    device=True)``: ``crc32c_batch`` on the card) taken apart, medians of
    ``reps`` calls: host packing (``pack_blobs`` and the copy
    ``words_to_tensor`` makes of read-only memory) on the host clock,
    then HtoD, the kernel with its seed XOR, and DtoH with CUDA events;
    beside the whole call and the C++ core's (``device=False``) on the
    host clock."""
    from ceph_tpu_torch.device import i32
    from ceph_tpu_torch.ops import crc32c as crc_ops

    dev = cs.torch_device()
    seed = i32(crc_ops.zeros_shift(cs.init_value, blocks.shape[-1]))
    parts = {k: [] for k in ("pack_ms", "htod_ms", "kernel_ms", "dtoh_ms",
                             "call_ms", "host_core_ms")}
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        words = crc_ops.pack_blobs(blocks)
        if not words.flags.writeable:
            words = words.copy()
        src = torch.from_numpy(words.view(np.int32))
        parts["pack_ms"].append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = src.to(dev)
        ev[1].record()
        c = crc_ops.crc0_words(x) ^ seed
        ev[2].record()
        out = c.cpu()
        ev[3].record()
        ev[3].synchronize()
        for key, a, b in (("htod_ms", 0, 1), ("kernel_ms", 1, 2),
                          ("dtoh_ms", 2, 3)):
            parts[key].append(ev[a].elapsed_time(ev[b]))
        t0 = time.perf_counter()
        got = cs.calculate(blocks, device=True)
        parts["call_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        host = cs.calculate(blocks)
        parts["host_core_ms"].append((time.perf_counter() - t0) * 1e3)
    check(np.array_equal(out.numpy().view(np.uint32), got)
          and np.array_equal(got, host), "checksum call split vs the call")
    return {k: statistics.median(v) for k, v in parts.items()}


def store_phase(dev, rng, rates: dict) -> dict:
    """Drive WalStore and BlueStoreLite on the card with device checksums
    (see the module docstring), each beside a host-checksum twin, check
    every byte and checksum, print a line per mix and return K2's launches
    on the store path and its timed entries at the store's shapes."""
    import filecmp
    import os
    import shutil
    import tempfile

    from ceph_tpu_torch import kernels, native
    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.device import words_to_tensor
    from ceph_tpu_torch.ops import crc32c as crc_ops
    from ceph_tpu_torch.store import StoreError, create
    from ceph_tpu_torch.store import transaction as tx
    from ceph_tpu_torch.store.bluestore import BLOCK
    from ceph_tpu_torch.utils import denc

    n_obj, obj_bytes = ST_OBJECTS, ST_OBJECT_BYTES
    per_obj = obj_bytes // BLOCK
    threads = os.cpu_count() or 1
    oids = [f"{ST_IMAGE}.{i:016x}".encode() for i in range(n_obj)]
    objs = random_bytes(rng, (n_obj, obj_bytes))  # the model of the image
    calls = {"device": [], "host": []}  # (blocks, device flag, seconds)
    launches = 0

    def recorded(store, twin):
        inner = store._csum.calculate

        def calculate(data, device=False):
            t0 = time.perf_counter()
            out = inner(data, device=device)
            calls[twin].append((len(out), device, time.perf_counter() - t0))
            return out

        store._csum.calculate = calculate
        return store

    def twins(kind, path, **kw):
        return {"device": recorded(create(kind, str(path / "device"),
                                          device_csum=True, device=dev,
                                          **kw), "device"),
                "host": recorded(create(kind, str(path / "host"), **kw),
                                 "host")}

    def turns(stores, i):
        """The twins in turn, the first of them alternating with ``i``:
        whichever goes first pays for touching the shared input."""
        pairs = list(stores.items())
        return pairs if i % 2 == 0 else pairs[::-1]

    def run(label, stores, n, txn_of) -> dict:
        """Apply ``txn_of(i)`` for i < n to both twins in turn -> one
        line: each twin's txn/s and GiB/s, K2's launches and the device
        calls they match."""
        mark = {t: len(c) for t, c in calls.items()}
        spent = {t: 0.0 for t in stores}
        nbytes = 0
        kernels.reset_counts()
        for i in range(n):
            t, size = txn_of(i)
            nbytes += size
            for twin, s in turns(stores, i):
                t0 = time.perf_counter()
                s.apply_transaction(t)
                spent[twin] += time.perf_counter() - t0
        k2 = kernels.CRC32C.launches
        line = mixline(label, mark, k2)
        line.update({f"{twin}_txn_per_s": n / spent[twin] for twin in spent})
        line.update({f"{twin}_GiB_per_s": nbytes / spent[twin] / 2**30
                     for twin in spent})
        line.update({"txns": n, "bytes": nbytes})
        return line

    def mixline(label, mark, k2) -> dict:
        """K2's launches since ``mark`` against the twins' checksum
        calls: one launch per device call, none for the host twin."""
        nonlocal launches
        dcalls = calls["device"][mark["device"]:]
        hcalls = calls["host"][mark["host"]:]
        check(all(d for _, d, _ in dcalls), f"{label}: a host call on the "
                                            "device twin")
        check(not any(d for _, d, _ in hcalls),
              f"{label}: a device call on the host twin")
        check(k2 == len(dcalls), f"{label}: {k2} K2 launches for "
                                 f"{len(dcalls)} device checksum calls")
        launches += k2
        return {"phase": "store", "mix": label, "k2_launches": k2,
                "device_calls": len(dcalls), "host_calls": len(hcalls),
                "device_call_ms_p50": medians(dcalls),
                "host_call_ms_p50": medians(hcalls)}

    def medians(twin_calls) -> dict:
        """Median ms of checksum calls by shape (blocks x 4 KiB)."""
        by_shape = {}
        for n_blocks, _, secs in twin_calls:
            by_shape.setdefault(f"{n_blocks}x{BLOCK}", []).append(secs)
        return {k: statistics.median(v) * 1e3 for k, v in by_shape.items()}

    def check_onodes(stores, want, label) -> None:
        """Every onode's checksums equal the C++ core's ``want``."""
        for twin, s in stores.items():
            for i, oid in enumerate(oids):
                check(np.array_equal(
                    np.array(s.colls[ST_POOL][oid].csums, np.uint32),
                    want[i * per_obj:(i + 1) * per_obj]),
                    f"{label}: {twin} onode checksums of object {i} vs "
                    "the C++ core")

    def fill(i):
        t = tx.Transaction()
        if i == 0:
            t.create_collection(ST_POOL)
        return t.write(ST_POOL, oids[i], 0, objs[i]), obj_bytes

    def read_all(stores, label) -> dict:
        """Read every object from both twins; each must equal the model."""
        mark = {t: len(c) for t, c in calls.items()}
        spent = {t: 0.0 for t in stores}
        kernels.reset_counts()
        for i, oid in enumerate(oids):
            for twin, s in turns(stores, i):
                t0 = time.perf_counter()
                got = s.read(ST_POOL, oid)
                spent[twin] += time.perf_counter() - t0
                check(np.array_equal(np.frombuffer(got, np.uint8), objs[i]),
                      f"{label}: {twin} read of object {i}")
        line = mixline(label, mark, kernels.CRC32C.launches)
        line.update({f"{twin}_GiB_per_s": n_obj * obj_bytes / spent[twin]
                     / 2**30 for twin in spent})
        return line

    def remount(stores, label) -> dict:
        mark = {t: len(c) for t, c in calls.items()}
        kernels.reset_counts()
        out = {}
        for twin, s in stores.items():
            t0 = time.perf_counter()
            s.umount()
            t1 = time.perf_counter()
            s.mount()
            out[f"{twin}_umount_s"] = t1 - t0
            out[f"{twin}_mount_s"] = time.perf_counter() - t1
        return {**mixline(label, mark, kernels.CRC32C.launches), **out}

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_store-"))
    try:
        free = shutil.disk_usage(root).free
        check(free >= ST_FREE_BYTES,
              f"the store phase needs {ST_FREE_BYTES / 2**30:.0f} GiB free "
              f"under {root}, and {free / 2**30:.2f} GiB are")

        # ---- WalStore: fill, one checkpoint, umount and mount
        ws = twins("walstore", root / "walstore", compression=None,
                   wal_compact_bytes=1 << 62)
        emit(run("walstore_rbd_fill", ws, n_obj, fill))
        mark = {t: len(c) for t, c in calls.items()}
        kernels.reset_counts()
        ckpt = {}
        for twin, s in ws.items():
            t0 = time.perf_counter()
            s.compact()
            ckpt[f"{twin}_checkpoint_s"] = time.perf_counter() - t0
        line = {**mixline("walstore_checkpoint", mark,
                          kernels.CRC32C.launches), **ckpt}
        snaps = [root / "walstore" / t / "snap" for t in ws]
        check(filecmp.cmp(*snaps, shallow=False),
              "the twins' snapshots differ")
        want = native.crc32c_batch(objs.reshape(-1, BLOCK), threads=threads)
        buf = snaps[0].read_bytes()
        off = 4 + 4 + 8 + 4  # magic, version, seq, collections
        _, off = denc.dec_str(buf, off)
        nobj, off = denc.dec_u32(buf, off)
        check(nobj == n_obj, f"snapshot holds {nobj} objects")
        for i in range(nobj):
            oid, off = denc.dec_bytes(buf, off)
            _, off = denc.dec_u8(buf, off)
            n, off = denc.dec_u32(buf, off)
            off += n  # the object's bytes
            crcs, off = denc.dec_list(buf, off, denc.dec_u32)
            check(oid == oids[i] and np.array_equal(
                np.array(crcs, np.uint32),
                want[i * per_obj:(i + 1) * per_obj]),
                f"snapshot checksums of object {i} vs the C++ core")
            for _ in range(2):
                _, off = denc.dec_map(buf, off, denc.dec_bytes,
                                      denc.dec_bytes)
            _, off = denc.dec_bytes(buf, off)
        del buf
        emit(line)
        emit(remount(ws, "walstore_remount"))
        emit(read_all(ws, "walstore_read"))
        for s in ws.values():
            s.umount()
        del ws
        shutil.rmtree(root / "walstore")

        # ---- BlueStoreLite: fill, 4 KiB overwrites, read, remount, read
        bs = twins("bluestore", root / "bluestore", size=ST_DEVICE_BYTES)
        emit(run("bluestore_rbd_fill", bs, n_obj, fill))
        wobj = rng.integers(0, n_obj, ST_RANDWRITES)
        wblk = rng.integers(0, per_obj, ST_RANDWRITES)
        wdata = random_bytes(rng, (ST_RANDWRITES, BLOCK))

        def randwrite(j):
            o, b = int(wobj[j]), int(wblk[j])
            objs[o, b * BLOCK:(b + 1) * BLOCK] = wdata[j]
            return tx.Transaction().write(ST_POOL, oids[o], b * BLOCK,
                                          wdata[j]), BLOCK

        emit(run("bluestore_rbd_randwrite_4k", bs, ST_RANDWRITES,
                 randwrite))
        want = native.crc32c_batch(objs.reshape(-1, BLOCK), threads=threads)
        check_onodes(bs, want, "after the overwrites")
        emit(read_all(bs, "bluestore_read_verify"))
        emit(remount(bs, "bluestore_remount"))
        emit(read_all(bs, "bluestore_read_after_mount"))
        check_onodes(bs, want, "from the KV after mount")

        # one bad byte in one block on the device twin's block file
        s = bs["device"]
        victim, vblock = oids[n_obj // 2], 100
        phys = s.colls[ST_POOL][victim].blocks[vblock]
        s.umount()
        with open(root / "bluestore" / "device" / "block", "r+b") as f:
            f.seek(phys * BLOCK + 1)
            byte = f.read(1)
            f.seek(phys * BLOCK + 1)
            f.write(bytes([byte[0] ^ 0x20]))
        s.mount()
        kernels.reset_counts()
        try:
            s.read(ST_POOL, victim)
            caught = None
        except StoreError as e:
            caught = str(e)
        check(caught is not None and f"block {vblock}" in caught,
              f"a flipped byte in block {vblock} read back: {caught}")
        check(kernels.CRC32C.launches == 1, "the bad read's verify launched K2")
        launches += 1
        emit({"phase": "store", "mix": "bluestore_bit_rot",
              "caught": caught})
        for s in bs.values():
            s.umount()
        del bs
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # ---- K2 at the store's shapes: the call taken apart, the kernel
    # against its plain version, its bound and the copy bound
    cs = Checksummer("crc32c", BLOCK, device=dev)
    blocks = objs.reshape(-1, BLOCK)
    timed = {}
    for key, n in ST_SHAPES.items():
        reps = 200 if n == 1 else 30 if n <= 1024 else 3
        # what the stores hand the call: BlueStoreLite's blocks are a
        # read-only view of joined bytes (copied once more on the way to
        # the card), WalStore's checkpoint a fresh concatenation
        given = (blocks[:n] if n > 1024 else
                 np.frombuffer(blocks[:n].tobytes(), np.uint8).reshape(n, BLOCK))
        call = csum_call_split(cs, given, reps)
        if n == 1024:  # BlueStoreLite's join of 1,024 blocks, host only
            rows = [blocks[i].tobytes() for i in range(n)]
            t0 = time.perf_counter()
            for _ in range(reps):
                np.frombuffer(b"".join(rows), np.uint8).reshape(n, BLOCK)
            call["store_join_ms"] = (time.perf_counter() - t0) / reps * 1e3
        split = profile_split(lambda: [cs.calculate(given, device=True)
                                       for _ in range(reps)])
        call["profile_per_call"] = {
            k: split[k] / reps for k in ("htod_ms", "kernels_ms", "dtoh_ms")}
        call["profile_idle_share"] = split["idle_share"]
        x = words_to_tensor(blocks[:n].view(np.uint32), dev)
        kernel = lambda: crc_ops.crc0_words(x)  # noqa: E731
        plain = lambda: crc_ops.crc0_words_plain(x)  # noqa: E731
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"store shape {key}: kernel and plain differ by {err}")
        ms = time_ms(kernel, reps=50 if n < 262144 else 20, warmup=10)
        plain_ms = time_ms(plain, reps=20 if n < 262144 else 5, warmup=1)
        b_ms, b_by = bound(*crc_work(n, BLOCK // 4))
        prof = profile_steps(kernel, reps=20)
        copy_ms = max(n * BLOCK / rates["h2d_GB_per_s"],
                      4 * n / rates["d2h_GB_per_s"]) / 1e6
        timed[f"crc_store_{key}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err,
            "device_ms": device_ms(prof), "copy_bound_ms": copy_ms}
        emit({"phase": "time", "what": f"crc_store_{key}",
              **timed[f"crc_store_{key}"], "call": call,
              "profile": {k: prof[k] for k in PROFILE_CLOCK}})
        del x
    emit({"phase": "store_launches", "crc32c": launches})
    return {"launches": launches, "timed": timed}


def gf2_bound(n: int, c: int, r: int, length: int,
              terms: int) -> tuple[float, str]:
    """Least time (ms) of one GF(2) XOR schedule on the card: C words in
    and R out per column of every stripe over the HBM rate, or the XORs
    the plan's terms need on the int32 ALU, whichever is larger."""
    t_bytes = 4.0 * n * length * (c + r) / HBM_BYTES_PER_S * 1e3
    t_ops = float(n) * length * terms / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf2_edge_cases() -> dict:
    """name -> (plan (R, T) int32, rows shape (N, C, L)): the GF(2) XOR
    kernel's edges. Each technique's encode plan (blaum_roth w=6,
    liberation w=7, liber8tion w=8, cauchy_bm) with L on the 16 B path
    and an odd L on the 4 B path, every two-erasure decode plan of
    blaum_roth k=6, one term a row, a row of pads only, one stripe, L = 1,
    a plan too large for shared memory and C past the 16 B path's
    limit."""
    from ceph_tpu_torch.ec.bitmatrix_plugin import _bitmatrix, _want_xor_plan
    from ceph_tpu_torch.ops import gf2

    rng = np.random.default_rng(7)
    cases = {}
    for tech, k, m, w in (("blaum_roth", 6, 2, 6), ("liberation", 7, 2, 7),
                          ("liber8tion", 8, 2, 8), ("cauchy_bm", 6, 3, 8)):
        plan = gf2.xor_plan(_bitmatrix(tech, k, m, w))
        cases[f"encode_{tech}"] = (plan, (3, k * w, 4096))
        cases[f"encode_{tech}_odd_L"] = (plan, (2, k * w, 1001))
    for erase in itertools.combinations(range(8), 2):
        present = tuple(i for i in range(8) if i not in erase)
        plan = _want_xor_plan("blaum_roth", 6, 2, 6, present, erase)
        cases["decode_blaum_roth_lost_%d_%d" % erase] = (
            plan, (2, 36, 333 if sum(erase) % 2 else 512))
    cases["one_term"] = (np.array([[3], [0], [5], [6]], np.int32),
                         (4, 6, 100))
    pads = rng.integers(0, 10, (5, 4), dtype=np.int32)
    pads[2] = 10
    cases["all_pad_row"] = (pads, (3, 10, 64))
    cases["one_stripe"] = (gf2.xor_plan(_bitmatrix("liber8tion", 8, 2, 8)),
                           (1, 64, 16384))
    cases["L_one"] = (rng.integers(0, 11, (6, 5), dtype=np.int32), (5, 10, 1))
    cases["plan_in_global"] = (rng.integers(0, 97, (128, 64), dtype=np.int32),
                               (2, 96, 64))
    cases["wide_C"] = (rng.integers(0, 2101, (4, 3), dtype=np.int32),
                       (1, 2100, 8))
    return cases


def repair_slices(codec, every: np.ndarray, lost: int):
    """A Clay single-loss repair plan over (B, n, su) cells -> (helper
    chunks in order, (B, d, su/q) uint8 repair-plane slices)."""
    n = codec.k + codec.m
    plan = codec.minimum_to_decode([lost], [c for c in range(n) if c != lost])
    check(lost not in plan and len(plan) == codec.d,
          f"Clay repair plan of chunk {lost}: {sorted(plan)}")
    order = sorted(plan)
    sub = every.shape[-1] // codec.get_sub_chunk_count()
    return tuple(order), np.ascontiguousarray(np.stack([np.concatenate(
        [every[:, c, o * sub:(o + cnt) * sub] for o, cnt in plan[c]], axis=1)
        for c in order], axis=1))


def codecs_phase(dev, rng) -> dict:
    """The bitmatrix, Clay and LRC codecs on the card (see the module
    docstring): K5 against its plain version at its edges, then each codec
    path with every kernel's count set to 0 just before it and read just
    after, each result checked exactly; K5 timed at the full-width encode
    and decode. Returns the launches of those runs by kernel, the edges'
    largest error, the timed entries and the seconds of each part."""
    import os

    from ceph_tpu_torch import kernels, native
    from ceph_tpu_torch.cluster import ECBatcher
    from ceph_tpu_torch.cluster.stripe import effective_stripe_unit
    from ceph_tpu_torch.device import i32, tensor_to_words, words_to_tensor
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.ec.bitmatrix_plugin import _want_xor_plan
    from ceph_tpu_torch.ops import crc32c as crc_ops
    from ceph_tpu_torch.ops import gf2, rs
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.perf import PerfCounters

    threads = os.cpu_count() or 1
    seconds, timed = {}, {}
    launches = {k.name: 0 for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(20261017)

    def rand_cells(shape) -> torch.Tensor:
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    walls = {}

    def counted(run, wall=None):
        """``run()`` with every kernel's count set to 0 just before it ->
        (its result, the counts just after); the counts add to the
        phase's launches, and ``walls[wall]`` keeps its wall seconds."""
        torch.cuda.synchronize()
        kernels.reset_counts()
        t_run = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        if wall is not None:
            walls[wall] = time.perf_counter() - t_run
        counts = {k.name: k.launches for k in kernels.KERNELS}
        for key, v in counts.items():
            launches[key] += v
        return out, counts

    def plain_crcs(cells: torch.Tensor, cell_bytes: int) -> torch.Tensor:
        seed = i32(crc_ops.zeros_shift(crc_ops.CRC_SEED, cell_bytes))
        return crc_ops.crc0_words_plain(cells) ^ seed

    def host_crcs(cells: np.ndarray) -> np.ndarray:
        """(B, n, su) uint8 -> (B, n) uint32 on the C++ core."""
        return native.crc32c_batch(cells.reshape(-1, cells.shape[-1]),
                                   threads=threads).reshape(cells.shape[:2])

    # ---- K5 against its plain version at the edges
    t0 = time.perf_counter()
    edges = gf2_edge_cases()
    edge_err = 0
    for name, (plan, shape) in edges.items():
        rows = words_to_tensor(rng.integers(0, 2**32, shape, dtype=np.uint32),
                               dev)
        before = kernels.GF2_XOR.launches
        got = gf2.gf2_apply(plan, rows)
        torch.cuda.synchronize()
        check(kernels.GF2_XOR.launches == before + 1, f"gf2 {name} launches")
        err = max_abs_err(got, gf2.gf2_apply_plain(plan, rows))
        check(err == 0, f"gf2_xor {name}: kernel and plain differ by {err}")
        edge_err = max(edge_err, err)
    emit({"phase": "codecs_gf2_vs_plain", "cases": len(edges),
          "max_abs_err": edge_err})
    seconds["edges"] = time.perf_counter() - t0

    # ---- liber8tion k=8, m=2 at full width: 256 stripes of 4 MiB
    t0 = time.perf_counter()
    bm = load_codec(CD_BM_PROFILE, device=dev)
    k, m, w = bm.k, bm.m, bm.w
    words, cb = CD_BM_CELL // 4, CD_BM_CELL
    data = rand_cells((CD_BM_B, k, words))
    (parity, crcs), enc = counted(lambda: bm.encode_crc_batch(data, cb))
    check(enc["gf2_xor"] == 1 and enc["crc32c"] == 1,
          f"liber8tion encode launches {enc}")
    pick = torch.from_numpy(np.sort(rng.choice(CD_BM_B, CD_SAMPLE,
                                               replace=False))).to(dev)
    cells = rs.unpack_u32(tensor_to_words(data[pick]))
    host_par = gf2.gf2_encode_cells_np(bm._enc_plan, w, cells)
    check(np.array_equal(rs.unpack_u32(tensor_to_words(parity[pick])),
                         host_par),
          "liber8tion parity vs the host engine on the sampled stripes")
    check(np.array_equal(tensor_to_words(crcs[pick]), host_crcs(
        np.concatenate([cells, host_par], axis=1))),
        "liber8tion CRCs vs the C++ core on the sampled stripes")
    del cells, host_par
    rows = data.view(CD_BM_B, k * w, words // w)
    check(torch.equal(parity.view(CD_BM_B, m * w, words // w),
                      gf2.gf2_apply_plain(bm._enc_plan, rows)),
          "liber8tion parity vs plain")
    check(torch.equal(crcs, torch.cat([plain_crcs(data, cb),
                                       plain_crcs(parity, cb)], dim=1)),
          "liber8tion CRCs vs plain")
    present = tuple(i for i in range(k + m) if i not in CD_BM_LOST)
    surv = torch.cat([data, parity], dim=1)[:, list(present)].contiguous()
    rebuilt, dec = counted(lambda: bm.decode_batch(present, surv,
                                                   want=CD_BM_LOST))
    check(dec["gf2_xor"] == 1, f"liber8tion decode launches {dec}")
    check(torch.equal(rebuilt, data[:, list(CD_BM_LOST)]),
          "liber8tion decode rebuilt data cells 1 and 6")
    dplan = _want_xor_plan(bm.technique, k, m, w, present, CD_BM_LOST)
    srows = surv.view(CD_BM_B, k * w, words // w)
    check(torch.equal(rebuilt.view(CD_BM_B, -1, words // w),
                      gf2.gf2_apply_plain(dplan, srows)),
          "liber8tion decode vs plain")
    for key, plan, x, step in (
            ("gf2_encode", bm._enc_plan, rows,
             lambda: bm.encode_crc_batch(data, cb)),
            ("gf2_decode", dplan, srows,
             lambda: bm.decode_batch(present, surv, want=CD_BM_LOST))):
        err = max_abs_err(gf2.gf2_apply(plan, x), gf2.gf2_apply_plain(plan, x))
        check(err == 0, f"{key}: kernel and plain differ by {err}")
        ms = time_ms(lambda: gf2.gf2_apply(plan, x))
        plain_ms = time_ms(lambda: gf2.gf2_apply_plain(plan, x), reps=5,
                           warmup=1)
        n, c, length = x.shape
        b_ms, b_by = gf2_bound(n, c, plan.shape[0], length,
                               int((plan < c).sum()))
        prof = profile_steps(lambda: gf2.gf2_apply(plan, x))
        dev_ms = device_ms(prof)
        timed[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err,
                      "device_ms": dev_ms, "step_ms": time_ms(step, reps=10)}
        emit({"phase": "time", "what": key, "shape": [n, c, length],
              "plan": list(plan.shape), **timed[key],
              "share_of_bound": b_ms / ms,
              "device_share_of_bound": b_ms / dev_ms if dev_ms else None,
              "profile": {kk: prof[kk] for kk in PROFILE_CLOCK}})
    emit({"phase": "codecs", "codec": "liber8tion", "stripes": CD_BM_B,
          "k": k, "m": m, "w": w, "cell_bytes": cb,
          "sampled_stripes": CD_SAMPLE, "lost": list(CD_BM_LOST),
          "launches": {"encode": enc, "decode": dec}, "exact": True})
    del data, parity, crcs, surv, rebuilt, rows, srows
    seconds["liber8tion"] = time.perf_counter() - t0

    # ---- Clay k=4, m=2, d=5 on 4 MiB stripes: host rounds, K1 and K2
    t0 = time.perf_counter()
    clay = load_codec(CD_CLAY_PROFILE, device=dev)
    k, m = clay.k, clay.m
    su = CD_STRIPE // k
    check(su % clay.get_alignment() == 0, f"Clay cell {su} unaligned")
    data = rand_cells((CD_CLAY_B, k, su // 4))
    (parity, crcs), enc = counted(lambda: clay.encode_crc_batch(data, su),
                                  "encode")
    cells = rs.unpack_u32(tensor_to_words(data))
    par = rs.unpack_u32(tensor_to_words(parity))
    every = np.concatenate([cells, par], axis=1)
    del cells
    pick = np.sort(rng.choice(CD_CLAY_B, CD_CLAY_SAMPLE, replace=False))
    check(np.array_equal(par[pick], clay.encode_cells_host(
        every[pick, :k])), "Clay parity vs the host engine on the sampled "
                           "stripes")
    check(np.array_equal(tensor_to_words(crcs), host_crcs(every)),
          "Clay CRCs vs the C++ core")
    present = tuple(i for i in range(k + m) if i not in CD_CLAY_LOST)
    surv = words_to_tensor(rs.pack_u32(every[:, list(present)]), dev)
    rebuilt, dec = counted(lambda: clay.decode_batch(present, surv,
                                                     want=CD_CLAY_LOST),
                           "decode")
    check(np.array_equal(rs.unpack_u32(tensor_to_words(rebuilt)),
                         every[:, list(CD_CLAY_LOST)]),
          f"Clay decode rebuilt chunks {CD_CLAY_LOST}")
    order, slices = repair_slices(clay, every, CD_CLAY_REPAIR)
    helpers = words_to_tensor(rs.pack_u32(slices), dev)
    repaired, rep = counted(lambda: clay.repair_batch(
        order, helpers, (CD_CLAY_REPAIR,)), "repair")
    check(np.array_equal(rs.unpack_u32(tensor_to_words(repaired))[:, 0],
                         every[:, CD_CLAY_REPAIR]),
          f"Clay repair rebuilt chunk {CD_CLAY_REPAIR}")
    clay_counts = {"encode": enc, "decode": dec, "repair": rep}
    for part, counts in clay_counts.items():
        check(counts["gf_matmul"] > 0, f"Clay {part} launched K1 {counts}")
    check(enc["crc32c"] == 1, f"Clay encode launched K2 {enc}")
    emit({"phase": "codecs", "codec": "clay", "stripes": CD_CLAY_B,
          "k": k, "m": m, "d": clay.d, "cell_bytes": su,
          "sub_chunks": clay.get_sub_chunk_count(),
          "lost": list(CD_CLAY_LOST), "repaired": CD_CLAY_REPAIR,
          "repair_helper_bytes": int(slices.nbytes),
          "rs_decode_bytes": CD_CLAY_B * k * su,
          "helper_share_of_rs": slices.nbytes / (CD_CLAY_B * k * su),
          "launches": clay_counts, "op_seconds": dict(walls),
          "data_GiB_per_s": {op: CD_CLAY_B * CD_STRIPE / sec / 2**30
                             for op, sec in walls.items()},
          "seconds": time.perf_counter() - t0, "exact": True})
    del data, parity, crcs, every, par, surv, rebuilt, slices, helpers
    seconds["clay"] = time.perf_counter() - t0

    # ---- LRC k=4, m=2, l=3 at 1 GiB: K1 and K2, one local-group decode
    t0 = time.perf_counter()
    lrc = load_codec(CD_LRC_PROFILE, device=dev)
    k, m = lrc.k, lrc.m
    su = CD_STRIPE // k
    data = rand_cells((CD_LRC_B, k, su // 4))
    (parity, crcs), enc = counted(lambda: lrc.encode_crc_batch(data, su))
    check(enc["gf_matmul"] == 1 and enc["crc32c"] == 1,
          f"LRC encode launches {enc}")
    check(torch.equal(parity, rs.gf_matmul_plain(lrc.matrix, data)),
          "LRC parity vs plain")
    check(torch.equal(crcs, torch.cat([plain_crcs(data, su),
                                       plain_crcs(parity, su)], dim=1)),
          "LRC CRCs vs plain")
    n = lrc.get_chunk_count()
    lost = lrc.chunk_index(CD_LRC_LOST)
    need = sorted(lrc.minimum_to_decode([lost], [p for p in range(n)
                                                 if p != lost]))
    check(len(need) < k, f"LRC local repair reads {need}")
    full = torch.cat([data, parity], dim=1)  # generator order
    pg = tuple(lrc._position_to_generator(p) for p in need)
    surv = full[:, list(pg)].contiguous()
    rebuilt, dec = counted(lambda: lrc.decode_batch(pg, surv,
                                                    want=(CD_LRC_LOST,)))
    check(dec["gf_matmul"] == 1, f"LRC decode launches {dec}")
    check(torch.equal(rebuilt[:, 0], data[:, CD_LRC_LOST]),
          "LRC local-group decode")
    # K1 and K2 at the codec paths' shapes: LRC's encode at 1 GiB, and
    # one Clay encode round (4 survivor nodes x every plane of the 64
    # stripes -> the 2 parity nodes)
    clay_rm = clay.mds.decode_matrix_for((0, 1, 2, 3), (4, 5))
    clay_x = rand_cells((1, 4, CD_CLAY_B * CD_STRIPE // 16))
    cases = {
        "gf_lrc_encode": (lambda: rs.gf_matmul(lrc.matrix, data),
                          lambda: rs.gf_matmul_plain(lrc.matrix, data),
                          gf_work(CD_LRC_B, m, k, su // 4)),
        "crc_lrc_encode": (lambda: crc_ops.crc0_cells(data, parity),
                           lambda: crc_ops.crc0_words_plain(
                               torch.cat([data, parity], dim=1)),
                           crc_work(CD_LRC_B * (k + m), su // 4)),
        "gf_clay_round": (lambda: rs.gf_matmul(clay_rm, clay_x),
                          lambda: rs.gf_matmul_plain(clay_rm, clay_x),
                          gf_work(1, 2, 4, clay_x.shape[-1])),
    }
    for key, (kernel, plain, (nbytes, ops)) in cases.items():
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"{key}: kernel and plain differ by {err}")
        ms, plain_ms = time_ms(kernel), time_ms(plain, reps=5, warmup=1)
        b_ms, b_by = bound(nbytes, ops)
        prof = profile_steps(kernel)
        timed[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err,
                      "device_ms": device_ms(prof)}
        emit({"phase": "time", "what": key, **timed[key],
              "share_of_bound": b_ms / ms,
              "profile": {kk: prof[kk] for kk in PROFILE_CLOCK}})
    del clay_x
    emit({"phase": "codecs", "codec": "lrc", "stripes": CD_LRC_B, "k": k,
          "m": m, "chunks": n, "cell_bytes": su, "lost_position": lost,
          "read_positions": need, "launches": {"encode": enc, "decode": dec},
          "exact": True})
    del data, parity, crcs, full, surv, rebuilt
    seconds["lrc"] = time.perf_counter() - t0

    # ---- the ECBatcher at the OSD's 4 KiB cells
    t0 = time.perf_counter()
    conf = config.proxy()
    conf.apply({"osd_ec_batch_target_stripes": ECB_TARGET,
                "osd_ec_batch_window": ECB_WINDOW,
                "osd_ec_cold_shape_bytes": CD_ECB_COLD_BYTES})
    perf = PerfCounters("osd.0")
    ECBatcher.declare_counters(perf)
    state = {"inflight": 0}
    batcher = ECBatcher(perf, conf=conf,
                        idle_probe=lambda: state["inflight"]
                        <= batcher.parked())
    ecb = {}

    def mix(name, codec, submit, stripes_each, data_bytes):
        n_sub, _, conc = CD_ECB_MIXES[name]
        before = perf.dump()
        (results, lat, wall), counts = counted(
            lambda: drive(submit, n_sub, conc, state))
        d = counter_delta(perf.dump(), before)
        check(d["ec_batch_failures"] == 0, f"{name}: a batch failed")
        ecb[name] = {"phase": "codecs_ecbatch", "mix": name,
                     "submissions": n_sub, "stripes_per_submission":
                     stripes_each, "concurrency": conc,
                     "stripe_unit": codec_su[name], "wall_s": wall,
                     "stripes_per_s": n_sub * stripes_each / wall,
                     "data_GiB_per_s": data_bytes / wall / 2**30,
                     "lat_p50_ms": float(np.percentile(lat, 50) * 1e3),
                     "lat_p99_ms": float(np.percentile(lat, 99) * 1e3),
                     "ec_decode_cold_host": d["ec_decode_cold_host"],
                     "decode_batches": d["ec_decode_stripes"]["count"],
                     "encode_batches": d["ec_batch_stripes"]["count"],
                     "launches": counts}
        return results

    codec_su = {}
    clay = load_codec(CD_CLAY_PROFILE, device=dev)
    su = effective_stripe_unit(clay, ECB_SU)
    codec_su["clay_recovery"] = su
    n_sub, per, _ = CD_ECB_MIXES["clay_recovery"]
    cdata = random_bytes(rng, (n_sub * per, clay.k, su))
    every = np.concatenate([cdata, clay.encode_cells_host(cdata)], axis=1)
    order, slices = repair_slices(clay, every, CD_ECB_REPAIR)
    slices = slices.reshape(n_sub, per, *slices.shape[1:])

    def warm_clay():
        """Rebuilds until the batcher's cold-shape shield has promoted
        the pattern (CD_ECB_COLD_BYTES of it on the host engine, then
        its background warm on the card), so that the timed mix runs
        every round on the card -> (submissions, seconds)."""
        t_warm, n = time.perf_counter(), 0
        while not batcher._shape_warm:
            check(n < n_sub, "clay_recovery: the shield never promoted")
            got = asyncio.run(batcher.repair_cells(
                clay, order, (CD_ECB_REPAIR,), slices[n]))
            check(np.array_equal(got[:, 0], every[n * per:(n + 1) * per,
                                                  CD_ECB_REPAIR]),
                  f"clay_recovery warm-up {n} vs the original cells")
            n += 1
        while not all(batcher._shape_warm.values()):
            check(time.perf_counter() - t_warm < 120,
                  "clay_recovery: the pattern's warm did not end")
            time.sleep(0.01)
        return n, time.perf_counter() - t_warm

    before = perf.dump()
    (n_warm, warm_s), warm_counts = counted(warm_clay)
    d = counter_delta(perf.dump(), before)
    emit({"phase": "codecs_ecbatch_warmup", "mix": "clay_recovery",
          "submissions": n_warm, "stripes_per_submission": per,
          "seconds": warm_s,
          "host_rounds": d["ec_decode_cold_host"],
          "device_rounds": d["ec_decode_stripes"]["count"]
          - d["ec_decode_cold_host"],
          "warm_s": list(batcher.warm_seconds.values()),
          "launches": warm_counts})
    out = mix("clay_recovery", clay, lambda i: batcher.repair_cells(
        clay, order, (CD_ECB_REPAIR,), slices[i]), per,
        n_sub * per * clay.k * su)
    for i in range(n_sub):
        check(np.array_equal(out[i], clay.repair_cells_host(
            order, (CD_ECB_REPAIR,), slices[i])),
            f"clay_recovery {i} vs repair_cells_host")
        check(np.array_equal(out[i][:, 0], every[i * per:(i + 1) * per,
                                                 CD_ECB_REPAIR]),
              f"clay_recovery {i} vs the original cells")
    rec = ecb["clay_recovery"]
    rec["device_rounds"] = rec["decode_batches"] - rec["ec_decode_cold_host"]
    rec["device_share"] = rec["device_rounds"] / rec["decode_batches"]
    check(rec["ec_decode_cold_host"] == 0
          and rec["launches"]["gf_matmul"] > 0,
          f"clay_recovery: {rec['ec_decode_cold_host']} of "
          f"{rec['decode_batches']} rounds on the host engine, launches "
          f"{rec['launches']}")
    emit(rec)
    del cdata, every, slices, out

    bm = load_codec(CD_BM_PROFILE, device=dev)
    su = effective_stripe_unit(bm, ECB_SU)
    codec_su["liber8tion_write"] = su
    n_sub, per, _ = CD_ECB_MIXES["liber8tion_write"]
    wdata = random_bytes(rng, (n_sub, bm.k, per, su))
    out = mix("liber8tion_write", bm, lambda i: batcher.encode_cells(
        bm, wdata[i].transpose(1, 0, 2)), per, wdata.nbytes)
    for i in range(n_sub):
        cells = wdata[i].transpose(1, 0, 2)
        par, crc = out[i]
        check(np.array_equal(par, bm.encode_cells_host(cells)),
              f"liber8tion_write {i} parity vs the host engine")
        check(np.array_equal(crc, host_crcs(np.concatenate([cells, par],
                                                           axis=1))),
              f"liber8tion_write {i} CRCs vs the C++ core")
    wr = ecb["liber8tion_write"]
    check(wr["launches"]["gf2_xor"] > 0 and wr["launches"]["crc32c"] > 0,
          f"liber8tion_write launches {wr['launches']}")
    emit(wr)
    seconds["ecbatch"] = time.perf_counter() - t0
    emit({"phase": "codecs_seconds", **seconds})
    for key in ("gf2_xor", "gf_matmul", "crc32c"):
        check(launches[key] > 0, f"the codec paths launched {key} "
                                 f"{launches[key]} times")
    return {"launches": launches, "edge_err": edge_err, "timed": timed,
            "seconds": seconds}


def msg_oid(i: int) -> bytes:
    """The msg phase's object names: RBD data objects, one width for all
    (every message of a kind then has one size)."""
    return f"rbd_data.10226b8b4567.{i:016x}".encode()


def msg_cid(shard: int) -> str:
    """The shard collection of the phase's PG (the OSD's ``<pgid>s<shard>``)."""
    return f"{MSG_PGID[0]}.{MSG_PGID[1]:x}s{shard}"


def msg_sub_write(tid: int, shard: int, oid: bytes, rows: np.ndarray,
                  crcs: np.ndarray):
    """One shard's MECSubWrite as ``cluster/pg.py`` builds a full-object
    write's: a Transaction that touches the object and writes the shard's
    cells ``rows`` (T, su) from offset 0 as a view, and the LE (cell, crc)
    u32 patch of every cell. No log entries ride along: the receivers run
    no PG log."""
    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.store.transaction import Transaction

    cid = msg_cid(shard)
    t = Transaction().touch(cid, oid).write(cid, oid, 0, rows)
    patch = np.empty((len(crcs), 2), dtype="<u4")
    patch[:, 0] = np.arange(len(crcs))
    patch[:, 1] = crcs
    return M.MECSubWrite(tid=tid, pgid=MSG_PGID, shard=shard, txn=t,
                         entry=[], epoch=MSG_EPOCH,
                         hpatch=memoryview(patch).toreadonly().cast("B"),
                         ncells=len(crcs), size=MSG_OBJECT_BYTES)


class MsgShard:
    """One receiving OSD of the msg phase: a MemStore that holds its
    shard's collection, and the shard side of an EC PG's sub-ops
    (``cluster/pg.py`` handle_ec_write, handle_ec_read) cut to what the
    phase holds: apply the transaction, recompute every received cell's
    CRC32C on the C++ core and require the patch's, answer; serve reads
    with their digest."""

    def __init__(self, shard: int, su: int):
        from ceph_tpu_torch.store.memstore import MemStore
        from ceph_tpu_torch.store.transaction import Transaction

        self.shard, self.su, self.cid = shard, su, msg_cid(shard)
        self.store = MemStore()
        self.store.queue_transaction(Transaction().create_collection(self.cid))
        self.send = None  # (dst, msg) coroutine, set once the wire is up
        self.cells_checked = 0
        self.errors: list[str] = []

    def _cells(self, t) -> np.ndarray:
        """The cells a sub-write's transaction carries, as received (a
        view over the staging rows on LocalBus, over the frame otherwise)."""
        from ceph_tpu_torch.store import transaction as tx

        return np.concatenate([
            np.frombuffer(op.args["data"], np.uint8) for op in t.ops
            if op.code == tx.OP_WRITE]).reshape(-1, self.su)

    async def __call__(self, src: str, msg) -> None:
        from ceph_tpu_torch import native
        from ceph_tpu_torch.cluster import messages as M
        from ceph_tpu_torch.store.transaction import Transaction

        if isinstance(msg, M.MECSubWrite):
            t = (msg.txn if isinstance(msg.txn, Transaction)
                 else Transaction.decode(msg.txn)[0])
            pairs = np.frombuffer(msg.hpatch, dtype="<u4").reshape(-1, 2)
            cells = self._cells(t)
            ok = (len(cells) == msg.ncells == len(pairs)
                  and np.array_equal(pairs[:, 0], np.arange(len(pairs)))
                  and np.array_equal(native.crc32c_batch(cells), pairs[:, 1]))
            if ok:
                self.store.queue_transaction(t)
                self.cells_checked += len(cells)
            else:
                self.errors.append(f"osd.{self.shard}: tid {msg.tid} cells "
                                   "disagree with their (cell, crc) patch")
            await self.send(src, M.MECSubWriteReply(
                tid=msg.tid, pgid=msg.pgid, shard=msg.shard,
                result=M.OK if ok else M.EIO))
        elif isinstance(msg, M.MECSubRead):
            chunk = self.store.read(self.cid, msg.oid, msg.offset, msg.length)
            await self.send(src, M.MECSubReadReply(
                tid=msg.tid, pgid=msg.pgid, shard=msg.shard, result=M.OK,
                data=chunk, digest=native.crc32c(chunk), size=len(chunk),
                attrs={}, ver=(MSG_EPOCH, 0)))
        else:
            self.errors.append(f"osd.{self.shard}: unexpected {msg!r}")


class MsgPrimary:
    """The primary of the msg phase: encodes each object on the batcher
    (K1 parity, K2 cell CRCs), fans its shards out as MECSubWrites and
    gathers the replies; reads objects back from all shards but MSG_LOST
    and rebuilds those through the batcher's decode (K1). Every reply
    is matched to its sub-op by tid; ``write_rtt`` and ``read_rtt``
    hold each sub-op's round trip, send to reply."""

    def __init__(self, batcher, codec, su: int, data: np.ndarray):
        from ceph_tpu_torch.utils.lathist import LatHist

        self.batcher, self.codec, self.su, self.data = batcher, codec, su, data
        self.k, self.n = codec.k, codec.k + codec.m
        self.stripes = MSG_OBJECT_BYTES // (self.k * su)
        self.crcs = np.zeros((len(data), self.n, self.stripes), np.uint32)
        self.tids = itertools.count(1)
        self.pending: dict[int, asyncio.Future] = {}
        self.write_rtt, self.read_rtt = LatHist(), LatHist()
        self.send = None  # (dst, msg) coroutine, set once the wire is up

    async def __call__(self, src: str, msg) -> None:
        fut = self.pending.pop(msg.tid, None)
        if fut is not None and not fut.done():
            fut.set_result(msg)

    async def _call(self, dst: str, msg, hist):
        fut = asyncio.get_running_loop().create_future()
        self.pending[msg.tid] = fut
        t0 = time.perf_counter()
        await self.send(dst, msg)
        reply = await asyncio.wait_for(fut, MSG_TIMEOUT_S)
        hist.note_s(time.perf_counter() - t0)
        return reply

    async def write_object(self, i: int) -> None:
        from ceph_tpu_torch.cluster import messages as M

        k, t, su = self.k, self.stripes, self.su
        staging = np.empty((self.n, t, su), np.uint8)   # shard-major rows
        staging[:k] = self.data[i].reshape(t, k, su).transpose(1, 0, 2)
        parity, crcs = await self.batcher.encode_cells(
            self.codec, staging[:k].transpose(1, 0, 2))
        check(crcs is not None, "the batcher returned no cell CRCs")
        staging[k:] = parity.transpose(1, 0, 2)
        self.crcs[i] = crcs.T
        oid = msg_oid(i)
        replies = await asyncio.gather(*(
            self._call(f"osd.{g}", msg_sub_write(next(self.tids), g, oid,
                                                 staging[g], self.crcs[i, g]),
                       self.write_rtt) for g in range(self.n)))
        for g, r in enumerate(replies):
            check(isinstance(r, M.MECSubWriteReply) and r.result == M.OK
                  and r.shard == g, f"object {i} shard {g}: {r!r}")

    async def read_object(self, i: int) -> None:
        from ceph_tpu_torch import native
        from ceph_tpu_torch.cluster import messages as M

        k, t, su = self.k, self.stripes, self.su
        oid, reads = msg_oid(i), [g for g in range(self.n) if g not in MSG_LOST]
        replies = await asyncio.gather(*(
            self._call(f"osd.{g}", M.MECSubRead(
                tid=next(self.tids), pgid=MSG_PGID, shard=g, oid=oid,
                offset=0, length=-1), self.read_rtt) for g in reads))
        cells = self.data[i].reshape(t, k, su)
        got = {}
        for g, r in zip(reads, replies):
            check(isinstance(r, M.MECSubReadReply) and r.result == M.OK
                  and r.shard == g and len(r.data) == t * su
                  and r.digest == native.crc32c(r.data),
                  f"object {i} read of shard {g}: {r!r}")
            got[g] = np.frombuffer(r.data, np.uint8).reshape(t, su)
            check(np.array_equal(native.crc32c_batch(got[g]), self.crcs[i, g]),
                  f"object {i} shard {g}: cells read back vs their CRCs")
            if g < k:
                check(np.array_equal(got[g], cells[:, g]),
                      f"object {i} shard {g}: bytes read back")
        rebuilt = await self.batcher.decode_cells(
            self.codec, MSG_PRESENT, MSG_LOST,
            np.stack([got[g] for g in MSG_PRESENT], axis=1))
        check(np.array_equal(rebuilt, cells[:, list(MSG_LOST)]),
              f"object {i}: rebuilt shards {MSG_LOST} vs the written bytes")
        check(np.array_equal(
            native.crc32c_batch(rebuilt.transpose(1, 0, 2).reshape(-1, su)),
            self.crcs[i, list(MSG_LOST)].reshape(-1)),
            f"object {i}: rebuilt cells' CRCs vs the written ones")


class MsgWire:
    """One transport of the msg phase between named entities, each with
    its dispatcher: ``localbus`` (one in-process LocalBus: sub-ops by
    reference), ``tcp`` and ``tcp_sign`` (a TcpMessenger per entity on
    127.0.0.1, the second with a KeyServer, so every frame carries an
    HMAC tag) or ``shm`` (a ShmMessenger per entity, its doorbell socket
    in Linux's abstract namespace, its rings where CEPH_TPU_SHM_DIR
    says)."""

    def __init__(self, kind: str, handlers: dict, secrets: dict):
        self.kind, self.handlers, self.secrets = kind, handlers, secrets
        self.bus, self.ends, self.addr = None, {}, {}

    async def start(self) -> None:
        import os

        from ceph_tpu_torch.msg.auth import KeyServer
        from ceph_tpu_torch.msg.messenger import LocalBus, TcpMessenger
        from ceph_tpu_torch.msg.shmring import ShmMessenger

        if self.kind == "localbus":
            self.bus = LocalBus()
            for name, h in self.handlers.items():
                self.bus.register(name, h)
        elif self.kind in ("tcp", "tcp_sign"):
            keys = None
            if self.kind == "tcp_sign":
                keys = KeyServer()
                for name in self.handlers:
                    keys.add(name, self.secrets[name])
            self.ends = {name: TcpMessenger(name, h, keys=keys)
                         for name, h in self.handlers.items()}
            book = {name: await m.listen("127.0.0.1", 0)
                    for name, m in self.ends.items()}
            for m in self.ends.values():
                m.addrbook.update(book)
        elif self.kind == "shm":
            self.ends = {name: ShmMessenger(name, h)
                         for name, h in self.handlers.items()}
            self.addr = {name: await m.listen(
                f"\0ctsm-{os.getpid()}-{id(self):x}-{name}")
                for name, m in self.ends.items()}
        else:
            raise ValueError(f"unknown transport {self.kind!r}")

    async def send(self, src: str, dst: str, msg) -> None:
        if self.bus is not None:
            await self.bus.send(src, dst, msg)
        elif self.addr:
            await self.ends[src].send(self.addr[dst], msg,
                                      timeout=MSG_TIMEOUT_S)
        else:
            await self.ends[src].send(dst, msg)

    def sender(self, src: str):
        return lambda dst, msg: self.send(src, dst, msg)

    def per_drain(self) -> float:
        """Messages handed over per delivery burst (LocalBus), per
        writer drain (TCP) or per doorbell byte (shm), over all entities."""
        if self.bus is not None:
            return self.bus.frames_per_drain
        if self.addr:
            pairs = [(m.zero_copy_gathers, m.doorbells)
                     for m in self.ends.values()]
        else:
            pairs = [(m.frames_sent, m.drains) for m in self.ends.values()]
        return sum(a for a, _ in pairs) / max(1, sum(b for _, b in pairs))

    async def close(self) -> None:
        if self.bus is not None:
            await self.bus.drain()
        for m in self.ends.values():
            await m.close()


def msg_wire_bytes(kind: str, n: int, stripes: int, su: int) -> int:
    """Bytes one object's sub-ops put on the transport: each message's
    payload (its sender's name, then its fields) in a frame of 16 bytes
    (header and CRC) over TCP, plus a 16-byte HMAC tag a frame in sign
    mode; the payload alone in a shm arena; none over LocalBus, which
    hands the objects over by reference. Every message of a kind has one
    size (fixed-width oids and tids), so one object's count is exact."""
    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.utils import denc
    from ceph_tpu_torch.utils.buffer import BufferList

    if kind == "localbus":
        return 0
    frame = {"tcp": 16, "tcp_sign": 32, "shm": 0}[kind]

    def size(src, msg):
        return frame + len(msg.encode_bl(BufferList(denc.enc_str(src))))

    rows, crcs, total = np.zeros((stripes, su), np.uint8), np.zeros(stripes), 0
    for g in range(n):
        osd = f"osd.{g}"
        total += size("primary", msg_sub_write(2**63, g, msg_oid(0), rows,
                                               crcs))
        total += size(osd, M.MECSubWriteReply(tid=2**63, pgid=MSG_PGID,
                                              shard=g, result=M.OK))
        if g in MSG_LOST:
            continue
        total += size("primary", M.MECSubRead(
            tid=2**63, pgid=MSG_PGID, shard=g, oid=msg_oid(0), offset=0,
            length=-1))
        total += size(osd, M.MECSubReadReply(
            tid=2**63, pgid=MSG_PGID, shard=g, result=M.OK,
            data=rows.reshape(-1), digest=0, size=rows.size, attrs={},
            ver=(MSG_EPOCH, 0)))
    return total


async def msg_transport(kind: str, batcher, codec, su: int, data: np.ndarray,
                        state: dict, secrets: dict) -> dict:
    """One transport's run of the msg phase: the primary and its k + m
    receivers on ``kind``, every object of ``data`` written, then read back
    degraded and rebuilt -> the run's numbers."""
    n = codec.k + codec.m
    primary = MsgPrimary(batcher, codec, su, data)
    shards = {f"osd.{g}": MsgShard(g, su) for g in range(n)}
    wire = MsgWire(kind, {"primary": primary, **shards}, secrets)
    t0 = time.perf_counter()
    await wire.start()
    primary.send = wire.sender("primary")
    for name, shard in shards.items():
        shard.send = wire.sender(name)
    try:
        _, wlat, write_s = await drive_async(primary.write_object, len(data),
                                             MSG_CONCURRENCY, state)
        _, rlat, read_s = await drive_async(primary.read_object, len(data),
                                            MSG_CONCURRENCY, state)
    finally:
        await wire.close()
    wall = time.perf_counter() - t0
    errors = [e for s in shards.values() for e in s.errors]
    check(not errors, f"{kind}: {errors[:3]}")
    checked = sum(s.cells_checked for s in shards.values())
    check(checked == len(data) * n * primary.stripes,
          f"{kind}: receivers checked {checked} cells")
    nbytes = data.nbytes
    return {"objects": len(data), "sub_writes": len(data) * n,
            "sub_reads": len(data) * (n - len(MSG_LOST)),
            "cells_crc_checked": checked,
            "rebuilt_cells": len(data) * primary.stripes * len(MSG_LOST),
            "wire_bytes": len(data) * msg_wire_bytes(
                kind, n, primary.stripes, su),
            "data_bytes": nbytes, "write_s": write_s, "read_s": read_s,
            "wall_s": wall,
            "write_GiB_per_s": nbytes / write_s / 2**30,
            "read_GiB_per_s": nbytes / read_s / 2**30,
            "sub_write_rtt_p50_ms": primary.write_rtt.percentile(0.5),
            "sub_write_rtt_p99_ms": primary.write_rtt.percentile(0.99),
            "sub_read_rtt_p50_ms": primary.read_rtt.percentile(0.5),
            "sub_read_rtt_p99_ms": primary.read_rtt.percentile(0.99),
            "object_write_p50_ms": float(np.percentile(wlat, 50) * 1e3),
            "object_write_p99_ms": float(np.percentile(wlat, 99) * 1e3),
            "object_read_p50_ms": float(np.percentile(rlat, 50) * 1e3),
            "object_read_p99_ms": float(np.percentile(rlat, 99) * 1e3),
            "frames_per_drain": wire.per_drain()}


def msg_phase(dev, rng, card: str, transports=None,
              profile: bool = True) -> dict:
    """The cluster wire with EC traffic on the card (see the module
    docstring): one ECBatcher, its decode pattern warmed past the
    cold-shape shield first, then each transport of ``transports``
    (name: objects; MSG_TRANSPORTS by default) in turn, every kernel's
    count set to 0 just before it and read just after, the run under
    torch.profiler when ``profile``. Prints a line per transport ->
    {"launches": those runs' launches by kernel, "lines": the lines by
    transport}."""
    import os
    import shutil
    import tempfile

    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.cluster import ECBatcher
    from ceph_tpu_torch.cluster.stripe import effective_stripe_unit
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.perf import PerfCounters

    transports = MSG_TRANSPORTS if transports is None else transports
    codec = load_codec(MSG_PROFILE, device=dev)
    su = effective_stripe_unit(codec, ECB_SU)
    check(su == ECB_SU, f"stripe unit {su} != {ECB_SU}")
    k, n = codec.k, codec.k + codec.m
    conf = config.proxy()
    conf.apply({"osd_ec_batch_target_stripes": ECB_TARGET,
                "osd_ec_batch_window": ECB_WINDOW})
    perf = PerfCounters("osd.0")
    ECBatcher.declare_counters(perf)
    state = {"inflight": 0}
    batcher = ECBatcher(perf, conf=conf,
                        idle_probe=lambda: state["inflight"]
                        <= batcher.parked())
    data = random_bytes(rng, (max(transports.values()), MSG_OBJECT_BYTES))
    secrets = {name: rng.bytes(32)
               for name in ("primary", *(f"osd.{g}" for g in range(n)))}

    # the OSD's steady state: the degraded-read pattern already promoted
    # past the cold-shape shield (zero cells decode to zero cells)
    t_warm, warm_rounds = time.perf_counter(), 0
    zeros = np.zeros((ECB_TARGET * 32, k, su), np.uint8)
    while not batcher._shape_warm:
        check(warm_rounds < 64, "msg: the shield never promoted")
        got = asyncio.run(batcher.decode_cells(codec, MSG_PRESENT, MSG_LOST,
                                               zeros))
        check(not got.any(), "msg warm-up: zero cells rebuilt non-zero")
        warm_rounds += 1
    while not all(batcher._shape_warm.values()):
        check(time.perf_counter() - t_warm < 120, "msg: the warm did not end")
        time.sleep(0.01)
    torch.cuda.synchronize()
    emit({"phase": "msg_warmup", "rounds": warm_rounds,
          "stripes_per_round": len(zeros),
          "seconds": time.perf_counter() - t_warm,
          "warm_s": list(batcher.warm_seconds.values())})
    del zeros

    launches = {kk.name: 0 for kk in kernels.KERNELS}
    lines = {}
    ring_dir = tempfile.mkdtemp(prefix="ctsm")
    shm_dir = os.environ.get("CEPH_TPU_SHM_DIR")
    os.environ["CEPH_TPU_SHM_DIR"] = ring_dir
    try:
        for kind, n_obj in transports.items():
            runs = []
            before = perf.dump()
            torch.cuda.synchronize()
            kernels.reset_counts()

            def run():
                runs.append(asyncio.run(msg_transport(
                    kind, batcher, codec, su, data[:n_obj], state,
                    secrets)))

            split = None
            if profile:  # one pad: a rerun would repeat the transport
                split = profile_split(run, pads=PROFILE_PADS_S[:1])
            else:
                run()
            torch.cuda.synchronize()
            counts = {kk.name: kk.launches for kk in kernels.KERNELS}
            for key, v in counts.items():
                launches[key] += v
            d = counter_delta(perf.dump(), before)
            check(d["ec_batch_failures"] == 0, f"msg {kind}: a batch failed")
            check(d["ec_decode_cold_host"] == 0,
                  f"msg {kind}: {d['ec_decode_cold_host']} decode rounds "
                  "on the host engine")
            line = {"phase": "msg", "transport": kind, **runs[0],
                    "objects_cut_from": MSG_OBJECTS if n_obj < MSG_OBJECTS
                    else None,
                    "encode_batches": d["ec_batch_stripes"]["count"],
                    "decode_batches": d["ec_decode_stripes"]["count"],
                    "launches": counts, "card": card}
            if split is not None:
                window_ms = runs[0]["wall_s"] * 1e3
                busy_ms = (split.get("window_ms", 0.0)
                           * (1 - (split["idle_share"] or 0.0)))
                line.update({
                    "kernels_ms": split["kernels_ms"],
                    "htod_ms": split["htod_ms"], "dtoh_ms": split["dtoh_ms"],
                    "kernel_share": split["kernels_ms"] / window_ms,
                    "busy_share": busy_ms / window_ms,
                    "profile": {key: split.get(key) for key in PROFILE_CLOCK}})
            lines[kind] = line
            emit(line)
    finally:
        if shm_dir is None:
            os.environ.pop("CEPH_TPU_SHM_DIR", None)
        else:
            os.environ["CEPH_TPU_SHM_DIR"] = shm_dir
        shutil.rmtree(ring_dir, ignore_errors=True)
        batcher.close()
    return {"launches": launches, "lines": lines}


def cl_placement_failure(e: BaseException) -> bool:
    """Whether ``e`` came out of the placement layer: a frame of
    ``ceph_tpu_torch/placement`` in its traceback or in its cause's."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        tb = e.__traceback__
        while tb is not None:
            if "/placement/" in tb.tb_frame.f_code.co_filename:
                return True
            tb = tb.tb_next
        e = e.__cause__ or e.__context__
    return False


async def cl_ops(client, ops: list) -> dict:
    """Submit ``ops`` [(pool, name, op vector, bytes a read must return
    or None)] through the client's aio window and wait for all of them ->
    {"lat_s": each op's seconds from entering the window to its reply,
    "wall_s", "failed": failures, "placement_failed": those that came out
    of the placement layer, "mismatched": reads unequal to their bytes}."""
    lat = [0.0] * len(ops)
    comps = []
    t0 = time.perf_counter()
    for i, (pool, name, opvec, _) in enumerate(ops):
        comp = await client.aio_submit(pool, name, opvec)
        t_in = time.perf_counter()
        comp.add_done_callback(
            lambda _c, i=i, t_in=t_in: lat.__setitem__(
                i, time.perf_counter() - t_in))
        comps.append(comp)
    await client.writes_wait()
    wall = time.perf_counter() - t0
    failed, placement, mismatched = [], 0, 0
    for (pool, name, _, want), comp in zip(ops, comps):
        try:
            reply = comp.result()
        except Exception as e:  # every failure is counted, then fails
            failed.append(f"{pool}/{name}: {e!r}")
            placement += cl_placement_failure(e)
            continue
        if want is not None and bytes(reply.outs[0][1]) != want:
            mismatched += 1
    return {"lat_s": lat, "wall_s": wall, "failed": failed,
            "placement_failed": placement, "mismatched": mismatched}


class ClSteps:
    """The cluster phase's ledger, read at each step's end: kernel
    launches, calls of the rs byte API (``RSCodec.encode_chunks`` /
    ``decode_chunks``), the recovery reservations a PG asked of its
    targets (``PG._reserve_remote``: granted, or timed out after 4 x
    ``osd_subop_timeout``), the OSDs' decode rounds on the device and on
    the host engine, and the client's placement counters, each as the
    step's delta."""

    def __init__(self, card: str):
        from ceph_tpu_torch import kernels
        from ceph_tpu_torch.cluster.pg import PG
        from ceph_tpu_torch.ec import rs_plugin

        self.card = card
        self.kernels = kernels
        self.rs_calls = {"encode_chunks": 0, "decode_chunks": 0}
        self.reserve = {"granted": 0, "timed_out": 0}
        self._real = [(rs_plugin.RSCodec, n, getattr(rs_plugin.RSCodec, n))
                      for n in self.rs_calls]
        for cls, n, fn in self._real:
            def counted(*a, _n=n, _fn=fn, **kw):
                self.rs_calls[_n] += 1
                return _fn(*a, **kw)
            setattr(cls, n, counted)
        reserve = PG._reserve_remote

        async def reserve_counted(pg, o):
            ok = await reserve(pg, o)
            self.reserve["granted" if ok else "timed_out"] += 1
            return ok
        self._real.append((PG, "_reserve_remote", reserve))
        PG._reserve_remote = reserve_counted
        self.lines: dict[str, dict] = {}
        self.cluster = None
        self._last = None

    def close(self) -> None:
        for cls, n, fn in self._real:
            setattr(cls, n, fn)

    def _osd_counters(self) -> dict:
        out = {}
        for o in self.cluster.osds if self.cluster is not None else ():
            if o is not None:
                d = o.perf.dump()
                out[id(o)] = (d["ec_decode_cold_host"],
                              d["ec_decode_stripes"]["count"],
                              d["ec_batch_stripes"]["count"],
                              d["ec_decode_stripes"]["sum"],
                              d["ec_batch_stripes"]["sum"])
        return out

    def _snapshot(self) -> dict:
        torch.cuda.synchronize()
        client = self.cluster.client if self.cluster is not None else None
        return {"t": time.perf_counter(),
                "launches": {k.name: k.launches
                             for k in self.kernels.KERNELS},
                "rs": dict(self.rs_calls), "reserve": dict(self.reserve),
                "osds": self._osd_counters(),
                "placement": dict(client.placement_stats())
                if client is not None else {}}

    def start(self) -> None:
        """Every count to 0 just before the phase drives its path."""
        torch.cuda.synchronize()
        self.kernels.reset_counts()
        self._last = self._snapshot()

    def mark(self, step: str, **extra) -> dict:
        now = self._snapshot()
        last = self._last
        moved = [0] * 5  # host rounds, decode/encode batches and stripes
        for key, now_c in now["osds"].items():
            for i, (v, v0) in enumerate(zip(
                    now_c, last["osds"].get(key, (0,) * 5))):
                moved[i] += v - v0
        host, decode, encode, decode_stripes, encode_stripes = moved
        line = {"phase": "cluster", "step": step,
                "seconds": now["t"] - last["t"],
                "launches": {n: v - last["launches"][n]
                             for n, v in now["launches"].items()},
                "rs_byte_api": {n: v - last["rs"][n]
                                for n, v in now["rs"].items()},
                "reservations": {n: v - last["reserve"][n]
                                 for n, v in now["reserve"].items()},
                "encode_batches": encode, "decode_batches": decode,
                "encode_stripes": encode_stripes,
                "decode_stripes": decode_stripes,
                "decode_host_rounds": host,
                "placement": {n: v - last["placement"].get(n, 0)
                              for n, v in now["placement"].items()},
                **extra, "card": self.card}
        self.lines[step] = line
        self._last = self._snapshot()
        emit(line)
        return line

    def totals(self) -> dict:
        out = {k.name: 0 for k in self.kernels.KERNELS}
        for line in self.lines.values():
            for n, v in line["launches"].items():
                out[n] += v
        return out


def cl_traffic(res: dict, nbytes: int) -> dict:
    """A step's traffic numbers from ``cl_ops``'s result (failures
    checked by the caller)."""
    lat = np.asarray(res["lat_s"]) * 1e3
    return {"ops": len(lat), "bytes": nbytes,
            "GiB_per_s": nbytes / 2**30 / res["wall_s"],
            "wall_s": res["wall_s"],
            "lat_p50_ms": float(np.percentile(lat, 50)),
            "lat_p99_ms": float(np.percentile(lat, 99)),
            "failed_ops": len(res["failed"]),
            "placement_failed_ops": res["placement_failed"]}


def cl_check(res: dict, what: str) -> None:
    check(not res["failed"], f"cluster {what}: {len(res['failed'])} ops "
                             f"failed, first {res['failed'][:3]}")
    check(res["placement_failed"] == 0,
          f"cluster {what}: {res['placement_failed']} ops failed on "
          "placement")
    check(res["mismatched"] == 0,
          f"cluster {what}: {res['mismatched']} reads differ from what "
          "was written")


async def cl_profiled(coro_fn, pad: float = PROFILE_PADS_S[0]):
    """Await ``coro_fn()`` under torch.profiler, the window padded by
    ``pad`` seconds at each end -> (its result, the device split as
    ``profile_split`` gives it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        await asyncio.sleep(pad)
        out = await coro_fn()
        torch.cuda.synchronize()
        await asyncio.sleep(pad)
    return out, events_split(prof)


async def cl_drive(steps: ClSteps, device, rng, objects: int,
                   rep_objects: int, overwrites: int,
                   degraded_writes: int, profile: bool) -> dict:
    """The cluster phase's traffic on one event loop (see
    ``cluster_phase``)."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch.cluster import TestCluster
    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.cluster.pg import ATTR_HINFO, META_OID
    from ceph_tpu_torch.cluster.stripe import dec_hinfo
    from ceph_tpu_torch.placement.osdmap import Pool

    c = TestCluster(n_osds=CL_OSDS, out_interval=CL_OUT_INTERVAL,
                    osd_conf={"osd_ec_cold_shape_bytes":
                              CL_COLD_SHAPE_BYTES}, device=device)
    steps.cluster = c
    out = {}
    await c.start()
    try:
        steps.start()
        c.client.op_timeout = CL_OP_TIMEOUT_S
        await c.client.create_pool(Pool(
            id=CL_REP_POOL, name="rbd", size=3, min_size=2,
            pg_num=CL_PG_NUM, crush_rule=0))
        await c.client.create_pool(Pool(
            id=CL_EC_POOL, name="rbd_data", size=11, min_size=8,
            pg_num=CL_PG_NUM, crush_rule=1, type="erasure",
            ec_profile=dict(CL_EC_PROFILE)))
        await c.wait_active(60)
        warmed = await c.client._placement.prewarm(
            c.client.osdmap, [CL_REP_POOL, CL_EC_POOL])
        check(warmed == 2 * CL_PG_NUM, f"cluster prewarm {warmed}")
        su = c.osds[0].sinfo_for(c.mon.osdmap.pools[CL_EC_POOL]).su
        check(su == ECB_SU, f"cluster stripe unit {su}")
        steps.mark("setup", prewarmed_pgids=warmed,
                   client_max_inflight=c.client.conf["client_max_inflight"])

        # the model: what every object must read back as
        model = {(CL_EC_POOL, f"rbd_data.{i:016x}"): rng.bytes(
            CL_OBJECT_BYTES) for i in range(objects)}
        model.update({(CL_REP_POOL, f"rbd_rep.{i:016x}"): rng.bytes(
            CL_OBJECT_BYTES) for i in range(rep_objects)})

        def writes(names):
            return [(p, n, [M.osd_op("writefull", data=model[(p, n)])],
                     None) for p, n in names]

        def reads():
            return [(p, n, [M.osd_op("read", offset=0, length=-1)],
                     bytes(d)) for (p, n), d in model.items()]

        nbytes = sum(len(d) for d in model.values())
        step = writes(list(model))
        split = None
        if profile:
            res, split = await cl_profiled(lambda: cl_ops(c.client, step))
        else:
            res = await cl_ops(c.client, step)
        cl_check(res, "write")
        extra = {}
        if split is not None:
            window_ms = res["wall_s"] * 1e3
            extra = {"kernels_ms": split["kernels_ms"],
                     "htod_ms": split["htod_ms"],
                     "dtoh_ms": split["dtoh_ms"],
                     "busy_share": split.get("window_ms", 0.0)
                     * (1 - (split["idle_share"] or 0.0)) / window_ms,
                     "kernel_share": split["kernels_ms"] / window_ms,
                     "profile": {k: split.get(k) for k in PROFILE_CLOCK}}
        out["write"] = steps.mark("write", **cl_traffic(res, nbytes), **extra)

        res = await cl_ops(c.client, reads())
        cl_check(res, "read")
        out["read"] = steps.mark("read", **cl_traffic(res, nbytes))

        # fio randwrite bs=4k on the EC objects: aligned, seeded
        ec_names = [n for p, n in model if p == CL_EC_POOL]
        step = []
        for _ in range(overwrites):
            name = ec_names[int(rng.integers(len(ec_names)))]
            off = int(rng.integers(CL_OBJECT_BYTES // CL_OVERWRITE_BYTES)) \
                * CL_OVERWRITE_BYTES
            patch = rng.bytes(CL_OVERWRITE_BYTES)
            d = bytearray(model[(CL_EC_POOL, name)])
            d[off:off + CL_OVERWRITE_BYTES] = patch
            model[(CL_EC_POOL, name)] = bytes(d)
            step.append((CL_EC_POOL, name,
                         [M.osd_op("write", offset=off, data=patch)], None))
        res = await cl_ops(c.client, step)
        cl_check(res, "overwrite")
        out["overwrite"] = steps.mark(
            "overwrite", **cl_traffic(res, overwrites * CL_OVERWRITE_BYTES))

        for i in CL_KILLED:
            await c.kill_osd(i)
        for i in CL_KILLED:
            await c.wait_down(i, timeout=30)
        steps.mark("kill", killed=list(CL_KILLED))
        res = await cl_ops(c.client, reads())
        cl_check(res, "degraded read")
        out["degraded_read"] = steps.mark("degraded_read",
                                          **cl_traffic(res, nbytes))
        late = [(p, f"{base}.late.{i:04x}")
                for p, base in ((CL_EC_POOL, "rbd_data"),
                                (CL_REP_POOL, "rbd_rep"))
                for i in range(degraded_writes)]
        for key in late:
            model[key] = rng.bytes(CL_OBJECT_BYTES)
        res = await cl_ops(c.client, writes(late))
        cl_check(res, "degraded write")
        out["degraded_write"] = steps.mark(
            "degraded_write",
            **cl_traffic(res, len(late) * CL_OBJECT_BYTES))

        t0 = time.perf_counter()
        for i in CL_KILLED:
            await c.revive_osd(i)
        await c.wait_clean(CL_CLEAN_TIMEOUT_S)
        out["recovery"] = steps.mark(
            "recovery", recovery_s=time.perf_counter() - t0,
            health=c.mon.health())

        inconsistent = 0
        for pool in (CL_EC_POOL, CL_REP_POOL):
            for ps in range(CL_PG_NUM):
                rep = await c.scrub_pg((pool, ps))
                inconsistent += len(rep["inconsistent"])
        check(inconsistent == 0,
              f"cluster scrub: {inconsistent} inconsistent objects")
        shards = cells = 0
        for store in c.stores:
            for cid in store.list_collections():
                if not cid.startswith(f"{CL_EC_POOL}."):
                    continue
                for oid in store.list_objects(cid):
                    if oid == META_OID:
                        continue
                    data = np.frombuffer(store.read(cid, oid), np.uint8)
                    want = dec_hinfo(store.getattr(cid, oid, ATTR_HINFO))
                    got = native.crc32c_batch(data.reshape(-1, su))
                    check(np.array_equal(got, want),
                          f"cluster: {cid}/{oid!r} hash_info differs from "
                          "the C++ core's CRC of its bytes")
                    shards += 1
                    cells += len(got)
        check(shards == 11 * (objects + degraded_writes),
              f"cluster: {shards} EC shards stored")
        out["scrub"] = steps.mark("scrub", pgs=2 * CL_PG_NUM,
                                  inconsistent=inconsistent,
                                  shards_crc_checked=shards,
                                  cells_crc_checked=cells)

        res = await cl_ops(c.client, reads())
        cl_check(res, "read after recovery")
        out["read_clean"] = steps.mark("read_clean",
                                       **cl_traffic(res, sum(
                                           len(d) for d in model.values())))
    finally:
        await c.stop()
        steps.cluster = None
    return out


def cluster_phase(card: str, rng, device=None, objects: int = CL_OBJECTS,
                  rep_objects: int = CL_REP_OBJECTS,
                  overwrites: int = CL_OVERWRITES,
                  degraded_writes: int = CL_DEGRADED_WRITES,
                  thrash=CL_THRASH, profile: bool = True) -> dict:
    """The cluster tier in one process with an RBD deployment's traffic
    (see the CL_* constants): a TestCluster on ``device`` (the card when
    None, as a user leaves it), every count set to 0 at its start; the
    client's resolver prewarmed so its misses run on K4; writes, reads,
    4 KiB overwrites, two OSDs killed, degraded reads and writes, their
    revival and recovery, a deep-scrub of every PG, every EC shard's
    hash_info CRCs against the C++ core, a last read; then the seeded
    thrash through ``ceph_tpu_torch.tools.thrash``. A line per step ->
    {"lines": the lines by step, "launches": the phase's launches by
    kernel, "thrash": the verdict}."""
    import contextlib
    import io

    from ceph_tpu_torch.tools import thrash as thrash_tool

    steps = ClSteps(card)
    try:
        t0 = time.perf_counter()
        asyncio.run(cl_drive(steps, device, rng, objects, rep_objects,
                             overwrites, degraded_writes, profile))
        drive_s = time.perf_counter() - t0
        host = {s: line["decode_host_rounds"]
                for s, line in steps.lines.items()
                if line["decode_host_rounds"]}
        check(not host, f"cluster: decode rounds on the host engine {host}")
        argv = list(thrash) + ([] if device is None
                               else ["--device", str(device)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = thrash_tool.main(argv)
        verdict = json.loads(buf.getvalue())
        check(rc == 0 and verdict["passed"],
              f"cluster thrash verdict failed: {verdict}")
        steps.mark("thrash", argv=argv, passed=verdict["passed"],
                   converged=verdict["converged"],
                   scrub_inconsistent=len(verdict["scrub_inconsistent"]),
                   oracle_mismatches=len(verdict["oracle_mismatches"]),
                   writes_acked=verdict["writes_acked"],
                   events=len(verdict["events"]),
                   hedge_counters=verdict.get("hedge_counters"),
                   ec_counters=verdict["ec_counters"])
    finally:
        steps.close()
    launches = steps.totals()
    timed = {}
    if profile:
        # K1 and K2 alone at the batches this path made: the write step's
        # mean encode batch and the degraded read's mean decode batch,
        # and the 2,048 stripes of phase msg's LocalBus batches
        from ceph_tpu_torch.ec import load_codec

        w, r = steps.lines["write"], steps.lines["degraded_read"]
        sizes = dict(zip(CL_TIMED, (
            round(w["encode_stripes"] / w["encode_batches"]),
            round(r["decode_stripes"] / r["decode_batches"]), 2048)))
        codec = load_codec(CL_EC_PROFILE, device=device)
        for tag, b in sizes.items():
            timed.update(batch_times(codec.device, rng, codec, b, ECB_SU,
                                     tag))
    emit({"phase": "cluster_launches", **launches,
          "rs_byte_api": {s: line["rs_byte_api"]
                          for s, line in steps.lines.items()},
          "drive_s": drive_s})
    return {"lines": steps.lines, "launches": launches, "thrash": verdict,
            "timed": timed}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.device import i32, tensor_to_words, words_to_tensor
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.models import datapath
    from ceph_tpu_torch.ops import crc32c as crc_ops
    from ceph_tpu_torch.ops import gf8, rs

    start = time.perf_counter()
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "card", "name": name, "count": count,
          "nvidia_smi": smi.splitlines()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- phase 2: build both kernels (one nvcc each, started together)
    secs = kernels.build_all()
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "entry function" in ln or "Used" in ln
                      or "spill" in ln]
             for k in kernels.KERNELS}
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})

    rng = np.random.default_rng(20261016)

    def rand_words(shape) -> torch.Tensor:
        return words_to_tensor(
            rng.integers(0, 2**32, shape, dtype=np.uint32), dev)

    # ---- phase 3: each kernel against its plain version, on the card
    gf_cases = []
    # C > 8 runs several K-steps, C > 32 several 256-bit ones past the
    # first fragment block; (16, 240) and (256, 256): B fragments too large
    # for shared memory, read from HBM; W = 1 and W % 4 != 0 take 4 B loads
    for i, (r, c, w) in enumerate([(3, 8, 131072), (8, 8, 4096), (1, 2, 1),
                                   (2, 5, 1000), (4, 6, 384), (16, 240, 100),
                                   (3, 8, 1), (16, 40, 1000), (4, 240, 257),
                                   (8, 8, 6), (256, 256, 9)]):
        mat = rng.integers(0, 256, (r, c), dtype=np.uint8)
        gf_cases.append((f"random{r}x{c}", mat, 1 + i % 3, w))
    van = gf8.vandermonde_rs_matrix(MAIN_K, MAIN_M)
    gf_cases.append(("vandermonde8+3", van, 2, 4096))
    gf_cases.append(("decode(1,6)",
                     gf8.decode_matrix(van, MAIN_K, list(PRESENT)), 2, 4096))
    zero_row = rng.integers(0, 256, (3, 4), dtype=np.uint8)
    zero_row[1] = 0
    gf_cases.append(("zero-row", zero_row, 3, 257))
    errs = {"gf_matmul": 0, "crc32c": 0}
    for label, mat, b, w in gf_cases:
        x = rand_words((b, mat.shape[1], w))
        got = rs.gf_matmul(mat, x)
        want = rs.gf_matmul_plain(mat, x)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"gf_matmul {label} B={b} W={w} differs by {err}")
        errs["gf_matmul"] = max(errs["gf_matmul"], err)
    x = rand_words((3, 4, 2, 5, 64))  # batch dims, non-contiguous view
    view = x[:, :, 1]
    check(torch.equal(rs.gf_matmul(van[:, :5], view),
                      rs.gf_matmul_plain(van[:, :5], view)),
          "gf_matmul on a strided view")
    crc_cases = [(70000, 1), (70000, 3), (70000, 100), (64, 16384),
                 (16, 131072), (5, 257), (3, 300001)]
    for n, w in crc_cases:
        words = rand_words((n, w))
        err = max_abs_err(crc_ops.crc0_words(words),
                          crc_ops.crc0_words_plain(words))
        check(err == 0, f"crc32c N={n} W={w} differs by {err}")
        errs["crc32c"] = max(errs["crc32c"], err)
    two_source = [(4, 8, 3, 131072), (3, 4, 2, 257), (1000, 3, 1, 1),
                  (7, 10, 4, 1000)]
    for b, k, m, w in two_source:  # data and parity read where they lie
        d, p = rand_words((b, k, w)), rand_words((b, m, w))
        err = max_abs_err(crc_ops.crc0_cells(d, p), crc_ops.crc0_words_plain(
            torch.cat([d, p], dim=1)))
        check(err == 0, f"crc32c two sources B={b} k={k} m={m} W={w} "
                        f"differs by {err}")
        errs["crc32c"] = max(errs["crc32c"], err)
    blob = rng.integers(0, 256, (2, 4096 * 4 + 3), dtype=np.uint8)
    check(all(int(v) == crc_ops.crc32c_np(b.tobytes())
              for v, b in zip(crc_ops.crc32c_batch(blob, device=dev), blob)),
          "crc32c_batch against the scalar reference")
    emit({"phase": "kernel_vs_plain", "gf_cases": len(gf_cases) + 1,
          "crc_cases": len(crc_cases) + len(two_source) + 1,
          "max_abs_err": errs})

    # ---- phase 4: the main path at full width
    params = datapath.ECParams(k=MAIN_K, m=MAIN_M, chunk_bytes=MAIN_CHUNK)
    data = datapath.example_batch(params, batch=MAIN_B, seed=0, device=dev)
    obj = np.frombuffer(rng.bytes(4 * 1024 * KIB), dtype=np.uint8)
    csum_data = np.frombuffer(rng.bytes(CSUM_BLOCK * CSUM_BLOBS),
                              dtype=np.uint8)
    torch.cuda.synchronize()

    kernels.reset_counts()
    parity, crcs = datapath.write_step(params, data)
    surviving = torch.cat([data, parity], dim=1)[:, list(PRESENT)]
    rebuilt, rcrcs = datapath.repair_step(params, PRESENT, surviving)
    codec = load_codec({"plugin": "rs_tpu", "k": "8", "m": "3"})
    encoded = codec.encode(range(MAIN_K + MAIN_M), obj)
    have = {i: c for i, c in encoded.items() if i not in (1, 6, 9)}
    decoded = codec.decode_concat(have)
    cparity, ccrcs = codec.encode_crc_batch(data, params.chunk_bytes)
    want_present = (0, 2, 3, 4, 5, 6, 7, 8)
    surviving_want = torch.cat([data, parity], dim=1)[:, list(want_present)]
    wanted = codec.decode_batch(want_present, surviving_want, want=(1, 9))
    csums = Checksummer("crc32c", CSUM_BLOCK).calculate(csum_data,
                                                        device=True)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    emit({"phase": "main_path_launches", **launches})
    for k in ("gf_matmul", "crc32c"):
        check(launches[k] > 0, f"main path launched {k} {launches[k]} times")

    seed_cell = crc_ops.zeros_shift(crc_ops.CRC_SEED, params.chunk_bytes)
    cells = torch.cat([data, parity], dim=1)
    plain_crcs = crc_ops.crc0_words_plain(cells) ^ i32(seed_cell)
    check(torch.equal(crcs, plain_crcs), "write_step CRCs vs plain")
    del cells
    sample = torch.from_numpy(
        rng.choice(MAIN_B, min(8, MAIN_B), replace=False)).to(dev)
    check(torch.equal(parity[sample],
                      rs.gf_matmul_plain(params.matrix, data[sample])),
          "write_step parity vs plain on 8 sampled stripes")
    check(torch.equal(rebuilt, data), "repair_step rebuilt all 256 stripes")
    check(torch.equal(rcrcs, crcs[:, :MAIN_K]), "repair_step CRCs")
    blocksize = codec.get_chunk_size(obj.size)
    padded = np.zeros(blocksize * MAIN_K, np.uint8)
    padded[:obj.size] = obj
    check(np.array_equal(decoded, padded), "codec byte decode round trip")
    ref_parity = gf8.gf_matmul(codec.matrix, padded.reshape(MAIN_K, blocksize))
    check(all(np.array_equal(encoded[MAIN_K + j], ref_parity[j])
              for j in range(MAIN_M)), "codec byte parity vs numpy gf8")
    check(torch.equal(cparity, parity) and torch.equal(ccrcs, crcs),
          "codec encode_crc_batch vs write_step")
    check(torch.equal(wanted[:, 0], data[:, 1])
          and torch.equal(wanted[:, 1], parity[:, 1]),
          "codec decode_batch(want=(1, 9))")
    blocks = words_to_tensor(rs.pack_u32(csum_data.reshape(CSUM_BLOBS, -1)),
                             dev)
    seed_blk = crc_ops.zeros_shift(crc_ops.CRC_SEED, CSUM_BLOCK)
    plain_csums = (tensor_to_words(crc_ops.crc0_words_plain(blocks))
                   ^ np.uint32(seed_blk))
    check(np.array_equal(csums, plain_csums), "Checksummer vs plain")
    emit({"phase": "main_path", "stripes": MAIN_B, "k": MAIN_K, "m": MAIN_M,
          "chunk_bytes": MAIN_CHUNK, "repair_present": list(PRESENT),
          "codec_object_bytes": int(obj.size), "checksummer_blobs": CSUM_BLOBS,
          "checksummer_block": CSUM_BLOCK, "exact": True})
    del surviving_want, wanted, cparity, ccrcs, decoded, encoded

    # ---- phase 5: times at the main path's shapes (data on the card)
    full_cells = torch.cat([data, parity], dim=1)  # the plain version's input
    repair_cells = rebuilt.reshape(-1, params.words)
    rmat = gf8.decode_matrix(params.matrix, MAIN_K, list(PRESENT))
    words = params.words
    cases = {  # name: (kernel call, plain call, (bytes, operations))
        "gf_write": (lambda: rs.gf_matmul(params.matrix, data),
                     lambda: rs.gf_matmul_plain(params.matrix, data),
                     gf_work(MAIN_B, MAIN_M, MAIN_K, words)),
        "gf_repair": (lambda: rs.gf_matmul(rmat, surviving),
                      lambda: rs.gf_matmul_plain(rmat, surviving),
                      gf_work(MAIN_B, MAIN_K, MAIN_K, words)),
        "crc_write": (lambda: crc_ops.crc0_cells(data, parity),
                      lambda: crc_ops.crc0_words_plain(full_cells),
                      crc_work(MAIN_B * (MAIN_K + MAIN_M), words)),
        "crc_repair": (lambda: crc_ops.crc0_words(repair_cells),
                       lambda: crc_ops.crc0_words_plain(repair_cells),
                       crc_work(repair_cells.shape[0], words)),
        "crc_checksummer": (lambda: crc_ops.crc0_words(blocks),
                            lambda: crc_ops.crc0_words_plain(blocks),
                            crc_work(CSUM_BLOBS, CSUM_BLOCK // 4)),
    }
    timed = {}
    for key, (kernel, plain, (nbytes, ops)) in cases.items():
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"{key}: kernel and plain differ by {err}")
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        b_ms, b_by = bound(nbytes, ops)
        prof = profile_steps(kernel)
        timed[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err,
                      "device_ms": device_ms(prof)}
        emit({"phase": "time", "what": key, **timed[key],
              "GB_per_s": nbytes / ms / 1e6, "share_of_bound": b_ms / ms,
              "profile": {k: prof[k] for k in PROFILE_CLOCK}})
    steps = {
        "write_step": (lambda: datapath.write_step(params, data),
                       timed["gf_write"]["ms"] + timed["crc_write"]["ms"],
                       timed["gf_write"]["bound_ms"]),
        "repair_step": (lambda: datapath.repair_step(params, PRESENT, surviving),
                        timed["gf_repair"]["ms"] + timed["crc_repair"]["ms"],
                        timed["gf_repair"]["bound_ms"]),
    }
    for key, (step, parts_ms, b_ms) in steps.items():
        ms = time_ms(step)
        emit({"phase": "time", "what": key, "ms": ms, "parts_ms": parts_ms,
              "data_GiB_per_s": MAIN_B * MAIN_K * params.chunk_bytes / ms
              * 1e3 / 2**30, "bound_ms": b_ms})

    # ---- phase 6: device busy and idle share over back-to-back steps; the
    # write step reads data and parity where they lie, so its profile holds
    # the two kernels and the seed XOR and no copy kernel
    for key, (step, _, _) in steps.items():
        prof = profile_steps(step)
        emit({"phase": "profile", "what": key, **prof})
        copies = [n for n in prof["ms_per_step"]
                  if any(s in n.lower() for s in ("cat", "copy", "memcpy"))]
        check(not copies, f"{key} launched copy kernels {copies}")

    seconds = {"through_main_path": time.perf_counter() - start}

    # ---- phase 7: the OSD's EC dispatch engine (ECBatcher) at its shapes
    t0 = time.perf_counter()
    rates = copy_rates()
    emit({"phase": "copy_rates", **rates})
    ecb = ecbatch_phase(dev, rng, rates)
    for key in ("gf_matmul", "crc32c"):
        n = ecb["launches"][key]
        check(n > 0, f"the ecbatch mixes launched {key} {n} times")
    timed.update(ecb["timed"])
    seconds["ecbatch"] = time.perf_counter() - t0

    # ---- phase 8: CRUSH placement (config 5, the rule engine, the
    # resolver)
    t0 = time.perf_counter()
    pl = placement_phase(dev)
    timed.update(pl["timed"])
    pl_errs = timed.pop("placement_checks")
    seconds["placement"] = time.perf_counter() - t0

    # ---- phase 9: the object store (WalStore and BlueStoreLite with
    # device checksums, each beside a host-checksum twin)
    t0 = time.perf_counter()
    st = store_phase(dev, rng, rates)
    check(st["launches"] > 0, f"the store phase launched crc32c "
                              f"{st['launches']} times")
    timed.update(st["timed"])
    seconds["store"] = time.perf_counter() - t0

    # ---- phase 10: the other codec families (bitmatrix through K5, Clay
    # and LRC through K1 and K2, the ECBatcher's sub-chunk repair)
    t0 = time.perf_counter()
    cd = codecs_phase(dev, rng)
    timed.update(cd["timed"])
    seconds["codecs"] = time.perf_counter() - t0

    # ---- phase 11: the cluster wire carrying the EC fan-out (K1 and K2
    # through the ECBatcher) over LocalBus, TCP, signed TCP and shm
    t0 = time.perf_counter()
    emit({"phase": "msg", "transport": "tcp_secure", "skipped":
          "left out: secure mode imports the cryptography package, which "
          "the H100 machine does not have; tests/test_torch_auth.py runs "
          "it on the CPU"})
    wire = msg_phase(dev, rng, smi.splitlines()[0])
    for key in ("gf_matmul", "crc32c"):
        for kind, line in wire["lines"].items():
            check(line["launches"][key] > 0,
                  f"msg {kind} launched {key} {line['launches'][key]} times")
    seconds["msg"] = time.perf_counter() - t0

    # ---- phase 12: the cluster tier in one process (mon, OSDs, PGs,
    # client, mgr) with an RBD deployment's traffic and the seeded thrash
    t0 = time.perf_counter()
    cl = cluster_phase(smi.splitlines()[0], rng)
    timed.update(cl["timed"])
    for key in ("gf_matmul", "crc32c", "crush_rule"):
        check(cl["launches"][key] > 0,
              f"the cluster phase launched {key} {cl['launches'][key]} times")
    seconds["cluster"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - start
    emit({"phase": "seconds", **seconds})

    def shapes(*keys):  # every main-path shape a kernel was timed at
        return {k.split("_", 1)[1]: {f: timed[k][f] for f in
                                     ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "device_ms", "copy_bound_ms", "draws",
                                      "group", "step_ms", "stripes",
                                      "max_abs_err",
                                      "head_max_abs_err")
                                     if f in timed[k]}
                for k in keys}

    def by_path(name):
        paths = {"main_path": launches[name], "ecbatch": ecb["launches"][name]}
        if name == "crc32c":
            paths["store"] = st["launches"]
        paths["codecs"] = cd["launches"][name]
        paths["msg"] = wire["launches"][name]
        paths["cluster"] = cl["launches"][name]
        return paths

    table = [
        {"name": "gf_matmul", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf_matmul.cu",
         "replaces": "ceph_tpu/ops/rs.py:348",
         "launches": launches["gf_matmul"], **timed["gf_write"],
         "max_abs_err": max(errs["gf_matmul"], timed["gf_write"]["max_abs_err"],
                            timed["gf_repair"]["max_abs_err"],
                            timed["gf_batch_write"]["max_abs_err"],
                            timed["gf_batch_decode"]["max_abs_err"],
                            timed["gf_lrc_encode"]["max_abs_err"],
                            timed["gf_clay_round"]["max_abs_err"],
                            *(timed[f"gf_{t}_{s}"]["max_abs_err"]
                              for t in CL_TIMED for s in ("write", "decode"))),
         "library_ms": None, "launches_by_path": by_path("gf_matmul"),
         "shapes": shapes("gf_write", "gf_repair", "gf_batch_write",
                          "gf_batch_decode", "gf_lrc_encode",
                          "gf_clay_round",
                          *(f"gf_{t}_{s}" for t in CL_TIMED
                            for s in ("write", "decode")))},
        {"name": "crc32c", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/crc32c.cu",
         "replaces": "ceph_tpu/ops/crc32c.py:231",
         "launches": launches["crc32c"], **timed["crc_write"],
         "max_abs_err": max(errs["crc32c"], timed["crc_write"]["max_abs_err"],
                            timed["crc_repair"]["max_abs_err"],
                            timed["crc_checksummer"]["max_abs_err"],
                            timed["crc_batch_write"]["max_abs_err"],
                            timed["crc_lrc_encode"]["max_abs_err"],
                            *(timed[f"crc_store_{k}"]["max_abs_err"]
                              for k in ST_SHAPES),
                            *(timed[f"crc_{t}_write"]["max_abs_err"]
                              for t in CL_TIMED)),
         "library_ms": None, "launches_by_path": by_path("crc32c"),
         "shapes": shapes("crc_write", "crc_repair", "crc_checksummer",
                          "crc_batch_write", "crc_lrc_encode",
                          *(f"crc_store_{k}" for k in ST_SHAPES),
                          *(f"crc_{t}_write" for t in CL_TIMED))},
        {"name": "straw2", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/straw2.cu",
         "replaces": "ceph_tpu/ops/crush.py:255",
         "launches": pl["launches"]["straw2"], **timed["straw2_config5"],
         "max_abs_err": max(
             *(pl_errs[c] for c in pl_errs
               if c not in (*PL_RULES, "rule_edges")),
             timed["straw2_config5"]["max_abs_err"],
             timed["straw2_65536"]["max_abs_err"]),
         "library_ms": None,
         "launches_by_path": {"placement": pl["launches"]["straw2"],
                              "cluster": cl["launches"]["straw2"]},
         "shapes": shapes("straw2_config5", "straw2_65536")},
        {"name": "crush_rule", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/crush_rule.cu",
         "replaces": "ceph_tpu/placement/bulk.py:433",
         "launches": pl["launches"]["crush_rule"],
         **timed["crush_rule_replicated_65536"],
         "max_abs_err": max(
             *(pl_errs[r] for r in (*PL_RULES, "rule_edges")),
             *(timed[f"crush_rule_{r}_{s}"]["max_abs_err"] for r in PL_RULES
               for s in ("65536", "64")),
             *(timed[f"crush_rule_{r}_full"]["head_max_abs_err"]
               for r in PL_RULES)),
         "library_ms": None,
         "launches_by_path": {"placement": pl["launches"]["crush_rule"],
                              "cluster": cl["launches"]["crush_rule"]},
         "shapes": shapes(*(f"crush_rule_{r}_{s}" for r in PL_RULES
                            for s in ("full", "65536", "64")))},
        {"name": "gf2_xor", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf2_xor.cu",
         "replaces": "ceph_tpu/ops/gf2.py:62",
         "launches": cd["launches"]["gf2_xor"], **timed["gf2_encode"],
         "max_abs_err": max(cd["edge_err"],
                            timed["gf2_encode"]["max_abs_err"],
                            timed["gf2_decode"]["max_abs_err"]),
         "library_ms": None,
         "launches_by_path": {"codecs": cd["launches"]["gf2_xor"],
                              "cluster": cl["launches"]["gf2_xor"]},
         "shapes": shapes("gf2_encode", "gf2_decode")},
    ]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
