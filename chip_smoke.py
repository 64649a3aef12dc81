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
BlueStoreLite 4,096 aligned 4 KiB overwrites and reads of every object
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

Phase ``corpus`` (after ``codecs``) replays the golden EC corpus
(``tests/corpus/ec_corpus.json``: 20 configs of rs_tpu, LRC, SHEC and
Clay at objects of 31, 4,096 and 65,537 bytes) through the codecs' byte
API on the card with ``gen_ec_corpus --check``: once as the corpus pins
each profile and once more with ``backend=device`` (SHEC runs on the host
only), zero drift in both, K1 launched. Then the EC engine probe
(``ec/engine.py``) times the fused write dispatch (pageable HtoD of 4 MiB,
K1 + K2, DtoH of parity and CRCs) against the C++ core and prints its
verdict: what ``backend=auto`` users get on this machine (the deployment
phases pin ``CEPH_TPU_EC_ENGINE=device``, so each of them launches K1 and
K2 whatever the verdict). K1 and K2 are timed at the probe's batch and K1
at the corpus's largest byte-API shape; last, the port's tpulint runs over
``ceph_tpu_torch`` with no unbaselined finding.

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

Phase ``services`` drives the client services (``osdc/``, ``services/``)
on phase ``cluster``'s deployment, built on the loop of a
``ClusterLoopThread``: RBD and RGW on the EC pool must raise EOPNOTSUPP
(they keep omap); ``fs``: FSLite with its metadata on the replicated pool
and its data on the EC pool writes a 1 GiB file in 4 MiB writes, reads it
back, takes 4 KiB random overwrites (partial-stripe RMW through each OSD's
ECBatcher, K1 and K2) and a truncate, then small files in directories are
created, listed and read; ``rbd`` on the replicated pool: an image written
and read at queue depth 16, 4 KiB random writes through the write-back
cache and a flush, a snapshot, an overwrite, a read at the snapshot, a
clone and copy-up in it; ``rbd_crypto``: an encrypted image written and
read (or a line that says the machine lacks ``cryptography``);
``mirror``: a journaled image replayed by a MirrorDaemon onto a second
TestCluster of 4 OSDs on the card; ``rgw``: sigv4-signed S3 PUTs, GETs and
a listing over HTTP on 127.0.0.1 (the client in threads) and a multipart
upload; ``sqlite``: a CephVFS database on the EC pool (its callbacks from
a thread into the cluster's loop), rows inserted in one transaction, an
aggregate, a reopen (or a line that says why this Python's ``sqlite3``
cannot see the VFS); ``degraded``: an OSD holding EC shards killed, the
FS file read back (K1 rebuilds), a file written and the database queried
and written, then every EC shard's hash_info CRCs held against the C++
core. Every read must equal the host's copy; K1 and K2 must launch in
``fs``, ``sqlite`` and ``degraded``; no step may call the rs byte API,
decode on the host engine or fail a placement lookup. A line per step;
the counts cut to keep the phase inside 90 s print in a line of their own.

Phase ``proc`` drives the cluster tier across processes as the same RBD
deployment: a ProcCluster of 3 Paxos mon processes and 12 OSD daemon
processes, each OSD with its own WalStore and its own CUDA context on the
card (the launcher builds the kernels once; each daemon loads them before
it boots), over the shared-memory ring messenger. 128 objects of 4 MiB on
the EC pool and 16 on the replicated one go through the client's aio
window and are read back; every OSD's pid must hold a context on the card
(``nvidia-smi --query-compute-apps``); OSD 1's process is killed with
SIGKILL, everything is read degraded and 16 more EC objects written; the
OSD is revived (a cold start from its WalStore) and the cluster recovered
to active+clean; the leader mon's process is killed, a quorum of 2 must
form and create a pool; everything is read once more. After the stop every
OSD's WalStore is mounted and every EC shard's hash_info CRCs held against
the C++ core's CRC of its bytes. Then a second cluster of the same shape
over TCP writes and reads back 32 objects. A line per step prints its
GiB/s, op latency p50/p99, the kernel launches counted inside the daemons
(their admin sockets) and in the launcher, and the OSDs' batch counters;
encode batches must run on the writes and decode batches on the degraded
read, none on the host engine and none failed; the start line prints the
start-up seconds by role, the daemons' CPU seconds and resident memory.

Phase ``mesh`` drives the multi-device data plane (``parallel/``) on a
virtual mesh of 8 slots over the one card (``parallel.pin_virtual``: each
slot holds its own tensors, and every copy between slots is made on the
card, so the mesh moves the bytes a mesh of cards moves): the XOR-combine
kernel K6 (``xor_fold``, ``bit_planes``, ``plane_parity_pack``,
``crc_join``) against its plain version at its edges; then, every count
at 0, the write step at the main path's width over meshes of 8 x 1, 4 x 2
and 2 x 4 slots (K1 and K2 on every slot's block, the segment CRCs joined
by K6), collective repair of shards 1 and 6 at widths 2 and 4
(``allgather`` at 256 stripes, ``psum_bits`` at 64), each slot's result
equal to the one-device step; an ECBatcher at the OSD's shapes with the
mesh knobs on in both repair modes, equal to a one-device batcher; phase
``cluster``'s deployment with the knobs on (64 objects of 4 MiB written,
read, read degraded with one OSD down, no host gather); and the multi-chip
dry run. It prints each mesh step's time beside the one-device step's and
K6's times at the shapes the path gave it beside their bounds.

Phase ``mds`` drives the CephFS metadata daemon (``services/mds.py``) on
phase ``services``' deployment: ``FSLite.mkfs`` with the metadata on the
replicated pool, MDS ranks 0 and 1 with the file data on the EC pool and
two FSClients, the second with the ObjectCacher. ``tree``: 8 directories,
2 pinned to rank 1, 256 files of 64 KiB created by the two clients in
turn, each listing what the other made, both closing their files and
reading what the other made; ``caps``: the cached client's files read by
the other while it holds their caps (a recall that outlasts the MDS's 2 s
revoke timeout evicts it: recorded, with the reads it made short);
``race``: creates on both ranks at once (the inode numbers their shared
counter hands out twice are counted); ``data``: 1 GiB in 4
MiB writes over 4 files, both clients writing at once, read back at queue
depth 16 (K1 and K2 on every write batch); ``overwrites``: 1,024 aligned 4
KiB overwrites of one file at depth 16; ``rename``: 64 cross-subtree
renames, rank 0 to 1 and back; ``snap``: a snapshot, a mutation, the
snapshot read back; ``quota``: a bytes quota refuses the write past it;
``crash``: rank 0 dies mid-rename and a new rank 0 replays its journal;
``degraded``: an OSD down, the 1 GiB read back (K1 rebuilds). Every step
gates on no rs byte-API call, no decode on the host engine and no failed
placement lookup, and counts the cap revokes and any live client evicted;
K1 and K2 are then timed alone at its mean batches. Its process arm runs
MDS ranks 0 and 1 as daemon processes (``ProcCluster.start_mds``): 64
files of 4 MiB written and read back, kill -9 of rank 0 and its revival
with the namespace back, a subtree pinned to rank 1 and a cross-subtree
rename both ways, the MDS daemons' start-up seconds and launches (their
admin sockets), ``ceph_daemon`` and the exporter against the live
sockets. It runs in phase ``proc``'s TCP cluster where the memory phase
``proc`` measured (VmRSS, RssAnon, RssFile and Pss by role, MemAvailable)
leaves room for two more daemons, else on a cluster of its own.

Phase ``tools`` runs the operator CLIs (``ceph_tpu_torch.tools``) through
their ``main`` on the card: ``crushtool --test --device`` on config 5's
1,000 OSDs at 1,048,576 inputs for both rules (the CLI's counts against
the kernel's rows, the rows' head against the plain engine, K4 timed);
``osdmaptool --test-map-pgs`` against the library's mapping; ``rados
bench`` 4 MiB x 16 on an EC 8+3 pool, write then ``seq`` (every read equal
to the written object); ``rbd`` create / import / export / snap / clone of
a 256 MiB image, exact; ``objectstore_tool``'s export and import of one
PG; ``dencoder`` over every registered message type; ``ceph status``,
``osd tree`` and ``osd pool ls``; and ``swarm`` at its own defaults
(2,000 clients, 8 s, 10 OSDs, 1,000,000 objects, Zipf 1.1) with no op
error and K1, K2 and K4 launched. K1 and K2 are then timed at the bench's
mean encode batch.

Every phase prints one JSON line. The line before the last is the kernel
table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; it also exits nonzero when no CUDA
device is present. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import asyncio
import contextlib
import io
import itertools
import json
import os
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
#: The pads ``batch_times`` and the tools' K4 times try: the 2 s pad (up to
#: 2 x 2 s a case, 14 cases) is cut to keep the script near 900 s with
#: phases mds and tools; a case whose records the 0.5 s window misses
#: prints the most it caught.
BT_PADS = PROFILE_PADS_S[:2]
#: Calls a plain version is timed over (median) at the main path's and the
#: batchers' shapes: 20 took ~22 s of plain calls a run (the main path's
#: CRCs 0.2-0.3 s a call); cut to keep the script near 900 s.
PLAIN_REPS = 5
#: The script's cuts to keep it near 900 s with phases mds and tools, each
#: printed in a line of its own at the start: what, from, to.
SCRIPT_CUTS = {
    "batch_times profile pads (s)": (list(PROFILE_PADS_S), list(BT_PADS)),
    "plain-version timing reps": (20, PLAIN_REPS),
    "store randwrites (ST_RANDWRITES)": (8192, 4096),
    "mds tree files (MD_CUTS)": (256, 128),
}
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
#: Inputs a rule edge map takes: a ragged count of groups and of blocks;
#: the numrep-256 map takes fewer. The edges hold the kernel's rows
#: against the host rule engine (``CrushMap.do_rule``) and its draw count
#: across the lane widths. The plain torch engine took 110.1-146.3 s on
#: all of them on the card, launch-bound whatever the input count (its
#: numrep-256 map 58.7 s at 259 inputs and 66.9 s at 67), so it holds
#: rows and draws on the maps of PL_EDGE_PLAIN only (a firstn and an
#: indep rule either side of a group of 32 lanes), on 65,536 inputs of
#: each rule above, and on every edge map in tests/test_torch_gpu.py.
PL_EDGE_X, PL_EDGE_X_WIDE = 1027, 259
PL_EDGE_PLAIN = ("flat33_firstn", "tree33_indep", "tree65_firstn",
                 "flat65_indep")
#: The host rule engine's rows for the edge maps (pure Python: 53.5-58.4 s
#: in one process on the H100's host, the maps of 1 or 2 items and
#: indep rules most of it) come from this many forked worker processes,
#: each taking PL_ORACLE_CHUNK inputs of a map at a time.
PL_ORACLE_WORKERS, PL_ORACLE_CHUNK = 8, 64
PL_RULES = {"replicated": (0, 3), "ec_8_3": (1, 11)}  # rule, numrep
PL_POOLS = {"rbd": (1, 3, 32768, 0), "ec_8_3": (2, 11, 8192, 1)}

#: The store phase: one OSD of an RBD pool. Objects of RBD's default size
#: (rbd_default_order 22: 4 MiB), 1 GiB in all, on a 4 GiB BlueStoreLite
#: with compression off (Ceph's default bluestore_compression_mode=none)
#: and on a WalStore with compression off and a WAL never compacted on its
#: own (one explicit checkpoint of the whole GiB); then fio-style
#: randwrite bs=4k overwrites (4 KiB aligned, fio's default blockalign)
#: from a seeded generator: 4,096 of them (16,384 took 37-42 s; cut to
#: 8,192 to keep the whole script near 650 s once phase cluster joined
#: it, and to 4,096 (13.6 s for both twins at 8,192) once phases mds and
#: tools did).
ST_OBJECTS, ST_OBJECT_BYTES, ST_DEVICE_BYTES = 256, 4 << 20, 4 << 30
ST_RANDWRITES = 4096
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

#: Phase services: the client services (osdc/, services/) on phase
#: cluster's deployment (CL_OSDS OSDs, the CL_EC_PROFILE pool with its
#: 4 KiB stripe unit and a replicated size-3 pool, CL_PG_NUM PGs each, the
#: cold-shape shield off), each at the services' own defaults: FSLite with
#: its metadata on the replicated pool and its data on the EC pool (its
#: layout's 4 MiB objects); RBD, which needs omap, on the replicated pool
#: (rbd_default_order 22: 4 MiB objects); RGW, whose bucket index is omap,
#: there too; CephVFS (SQLite) on the EC pool. I/O in 4 MiB requests (dd
#: bs=4M), 4 KiB random writes fio-style (aligned, each block once) at
#: queue depth SV_QD; the RBD handle for them is opened with the cache on
#: (librbd's rbd_cache = true). The mirror's secondary is the layout of
#: tests/test_mirror.py (SV_MIRROR_OSDS OSDs, one replicated pool of 8
#: PGs). The degraded step kills OSD SV_KILLED, which holds EC shards.
SV_FULL = {
    "io_bytes": 4 << 20,
    "fs_file_bytes": 1 << 30, "fs_overwrites": 1024,
    "fs_files": 256, "fs_small_bytes": 64 << 10, "fs_dirs": 8,
    "rbd_image_bytes": 1 << 30, "rbd_randwrites": 1024, "rbd_copyups": 16,
    "crypt_image_bytes": 256 << 20,
    "mirror_image_bytes": 256 << 20, "mirror_rounds": 4,
    "rgw_puts": 64, "rgw_object_bytes": 4 << 20,
    "rgw_multipart_bytes": 64 << 20, "rgw_parts": 8,
    "sql_rows": 20_000, "sql_degraded_rows": 1_000,
}
#: Counts cut so that the phase keeps to its 90 s: at SV_FULL it took
#: 111.1 s on the H100's host (fs 44.8: 16.6 of it the overwrites, rbd
#: 19.4, degraded 12.7, mirror 11.2, sqlite 8.7, crypto 6.1, rgw 6.0);
#: with the replicated-pool counts at half, 85.1 and 95.4 s (rbd
#: 11.8-12.7, mirror 4.7-5.5, rgw 3.2-3.4, crypto 2.1). Only the services
#: on the replicated pool, which launch no EC kernel, are cut, to a
#: quarter, and the FS's small files (created one at a time) to half; the
#: EC counts (the 1 GiB FS file, its 1,024 overwrites, the 20,000 SQLite
#: rows) stay at SV_FULL. Each cut prints in a line of its own.
SV_CUTS = {"fs_files": 128,
           "rbd_image_bytes": 256 << 20, "rbd_randwrites": 256,
           "crypt_image_bytes": 64 << 20, "mirror_image_bytes": 64 << 20,
           "rgw_puts": 16}
SV_SIZES = {**SV_FULL, **SV_CUTS}
SV_QD, SV_OVERWRITE_BYTES = 16, 4096
SV_MIRROR_OSDS, SV_MIRROR_PGS = 4, 8
SV_KILLED = 1
SV_RGW_USER = ("AKIDSERVICESPHASE", "services-phase-secret")
#: The batches K1 and K2 are timed at alone after the phase (tag: step,
#: its batches, the ``batch_times`` cases that step runs): the fs step's
#: and the sqlite step's (its page writes) mean encode batch, the
#: degraded step's mean decode batch.
SV_TIMED = {"services_fs_wb": ("fs", "encode", ("write", "crc")),
            "services_sql_wb": ("sqlite", "encode", ("write", "crc")),
            "services_rb": ("degraded", "decode", ("decode",))}
#: Seconds the whole drive may take before the phase fails.
SV_TIMEOUT_S = 900.0

#: Phase proc: phase cluster's RBD deployment as real daemons, the layout
#: of Ceph's vstart.sh / qa/standalone (3 mons, OSDs on one host): 3 mon
#: processes in a Paxos quorum and 12 OSD processes, each with its own
#: WalStore and its own CUDA context on the card; the same two pools (32
#: PGs each, EC 8+3 with a 4 KiB stripe unit and replicated size 3) and
#: the same OSD override (osd_ec_cold_shape_bytes 0: every decode on K1).
#: The mons keep the daemon's out interval (4 s), so OSD PR_KILLED is
#: marked out while it is down and recovery moves data back after its
#: revival. Over shm: PR_OBJECTS 4 MiB objects on EC and PR_REP_OBJECTS
#: replicated through the client's aio window, PR_DEGRADED_WRITES EC
#: writes while the OSD is down; then a second cluster of the same shape
#: over TCP writes and reads PR_TCP_OBJECTS.
PR_OSDS, PR_MONS = 12, 3
#: The shm rings' arena (CEPH_TPU_SHM_ARENA_BYTES): a whole-object read's
#: reply carries its 4 MiB twice (MOSDOpReply's ``data`` mirrors its first
#: ``outs`` entry), more than the default 8 MiB arena takes in one
#: message; 32 MiB holds three such replies.
PR_SHM_ARENA_BYTES = 32 << 20
PR_OBJECTS, PR_REP_OBJECTS, PR_DEGRADED_WRITES = 128, 16, 16
PR_TCP_OBJECTS = 32
PR_KILLED = 1
PR_AFTER_FAILOVER_POOL = 3
#: Seconds every daemon may take from spawn to its .ready marker (15
#: processes import torch and create a CUDA context at once), a client op,
#: a quorum to form and the cluster to become active+clean.
PR_SPAWN_TIMEOUT_S, PR_OP_TIMEOUT_S = 180.0, 120.0
PR_QUORUM_TIMEOUT_S, PR_CLEAN_TIMEOUT_S = 120.0, 300.0
#: The client's op timeout while it polls the quorum after the leader's
#: kill: a request that a peon forwards to the dead leader is lost, and
#: the poll re-sends after this many seconds instead of the op timeout.
PR_QUORUM_POLL_S = 2.0
#: The client's op timeout for the pool create after the failover: a mon
#: op sent just after the leader's kill can be lost (ROADMAP §3 item 9),
#: and the client re-sends it after this many seconds (three attempts)
#: instead of waiting out PR_OP_TIMEOUT_S.
PR_FAILOVER_OP_S = 10.0
#: WalStore's checkpoint threshold on the phase's OSDs (the
#: walstore_compact_bytes option; default 64 MiB). A checkpoint encodes and
#: zlib-compresses the whole store while it holds the store lock, and at
#: ~0.5 GiB an OSD that stalls its reactor past the heartbeat grace (the
#: mon then marks it down, again and again): above what an OSD takes here,
#: no checkpoint runs in the phase and a revival replays its WAL.
PR_WAL_COMPACT_BYTES = 8 << 30
#: Fresh interpreters that mount the OSDs' WalStores after the stop (the
#: shm cluster's WALs hold ~0.5 GiB an OSD; the TCP cluster's are scanned
#: in the launcher).
PR_SCAN_WORKERS = 6
#: The OSD counters a step's line sums over the daemons (perf dump).
PR_COUNTERS = ("ec_batches", "ec_decode_batches", "ec_decode_cold_host",
               "ec_batch_failures", "ec_hedges_fired", "ec_hedges_won")


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


def profile_steps(step, reps: int = 10, pads=PROFILE_PADS_S) -> dict:
    """Run ``step`` ``reps`` times back to back under torch.profiler
    (``profiled``): each kernel's device ms per step, and the share of
    the window from the first to the last device event in which the card
    was idle (null when no record was caught). A kernel's ms per step is
    the mean of its caught records times its launches per step (its
    records over ``reps``, rounded), so a dropped record does not lower
    it; the idle share counts only caught records."""
    step()
    torch.cuda.synchronize()
    events, clock = profiled(lambda: [step() for _ in range(reps)], pads)
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


def batch_times(dev, rng, codec, b: int, su: int, tag: str,
                cases=("write", "decode", "crc")) -> dict:
    """K1 (``write``: encode to the m parities, ``decode``: ECB_WANT from
    PRESENT) and K2 (``crc``: the CRCs of data and parity where they lie)
    on one batch of ``b`` stripes of ``su``-byte cells, each of ``cases``
    against its plain version: CUDA event ms, plain ms, bound, profiler
    device ms. Prints a ``time`` line each -> {"gf_<tag>_write",
    "gf_<tag>_decode", "crc_<tag>_write": ...} for those cases."""
    from ceph_tpu_torch.device import words_to_tensor
    from ceph_tpu_torch.ops import crc32c as crc_ops
    from ceph_tpu_torch.ops import rs

    k, m, w = codec.k, codec.m, su // 4
    x = words_to_tensor(rng.integers(0, 2**32, (b, k, w), dtype=np.uint32),
                        dev)
    par = rs.gf_matmul(codec.matrix, x)
    rm = codec.decode_matrix_for(PRESENT, ECB_WANT)
    runs = {
        "write": (f"gf_{tag}_write",
                  lambda: rs.gf_matmul(codec.matrix, x),
                  lambda: rs.gf_matmul_plain(codec.matrix, x),
                  gf_work(b, m, k, w)),
        "decode": (f"gf_{tag}_decode", lambda: rs.gf_matmul(rm, x),
                   lambda: rs.gf_matmul_plain(rm, x),
                   gf_work(b, len(ECB_WANT), k, w)),
        "crc": (f"crc_{tag}_write", lambda: crc_ops.crc0_cells(x, par),
                lambda: crc_ops.crc0_words_plain(torch.cat([x, par], dim=1)),
                crc_work(b * (k + m), w)),
    }
    timed = {}
    for key, kernel, plain, (nbytes, ops) in (runs[c] for c in cases):
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"{key}: kernel and plain differ by {err}")
        ms = time_ms(kernel, reps=50)
        plain_ms = time_ms(plain, reps=PLAIN_REPS, warmup=1)
        b_ms, b_by = bound(nbytes, ops)
        prof = profile_steps(kernel, reps=20, pads=BT_PADS)
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


#: name -> (CrushMap, rule, numrep, weights, inputs) of the maps whose
#: rows ``pl_oracle`` asks its workers for; set before they fork.
_ORACLE_MAPS: dict = {}


def pl_oracle_rows(task: tuple) -> tuple:
    """A worker's share of ``pl_oracle``: ``CrushMap.do_rule`` on inputs
    [lo, hi) of map ``name`` -> (name, lo, rows, seconds)."""
    name, lo, hi = task
    cmap, ruleno, numrep, weights, xs = _ORACLE_MAPS[name]
    t0 = time.perf_counter()
    rows = [cmap.do_rule(ruleno, int(x), numrep, weights) for x in xs[lo:hi]]
    return name, lo, rows, time.perf_counter() - t0


def pl_oracle(maps: dict, workers: int = PL_ORACLE_WORKERS,
              chunk: int = PL_ORACLE_CHUNK) -> tuple[dict, dict]:
    """Rows of the host rule engine for every map of ``maps`` (name ->
    (CrushMap, rule, numrep, weights, inputs)), computed by ``workers``
    forked processes, ``chunk`` inputs a task; the pool is closed before
    it returns. The workers run pure Python and touch no device ->
    (name -> (inputs, numrep) int32 array, rows padded with ITEM_NONE,
    name -> seconds the workers spent on it)."""
    import multiprocessing as mp

    from ceph_tpu_torch.placement.crushmap import ITEM_NONE

    _ORACLE_MAPS.clear()
    _ORACLE_MAPS.update(maps)
    tasks = [(name, lo, min(lo + chunk, len(m[4])))
             for name, m in maps.items() for lo in range(0, len(m[4]), chunk)]
    try:
        with mp.get_context("fork").Pool(workers) as pool:
            parts = pool.map(pl_oracle_rows, tasks, chunksize=1)
    finally:
        _ORACLE_MAPS.clear()
    rows = {name: [None] * len(m[4]) for name, m in maps.items()}
    seconds = dict.fromkeys(maps, 0.0)
    for name, lo, part, sec in parts:
        numrep = maps[name][2]
        rows[name][lo:lo + len(part)] = [
            row + [ITEM_NONE] * (numrep - len(row)) for row in part]
        seconds[name] += sec
    return ({name: np.asarray(r, dtype=np.int32).reshape(
                len(r), maps[name][2]) for name, r in rows.items()},
            seconds)


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
    # depth, rows of 256, the legacy tunables) on a ragged count of
    # inputs, at both widths group_width can choose for a map (a batch the
    # card holds whole, one that fills it): rows against the host rule
    # engine, draws equal across the widths, and on the PL_EDGE_PLAIN maps
    # rows and draws against the plain version on the same inputs
    xrng = np.random.default_rng(20261019)
    edge_groups, edge_plain_draws = {}, {}
    t_edges = time.perf_counter()
    edges = {}
    for ename, (emap, ruleno, numrep, ew) in rule_edge_maps().items():
        ecomp = bulk.CompiledMap(emap)
        ew = (np.full(ecomp.max_devices, 0x10000, dtype=np.uint32)
              if ew is None else ew)
        ex = xrng.integers(0, 2**32, PL_EDGE_X if numrep < 256
                           else PL_EDGE_X_WIDE, dtype=np.uint32)
        edges[ename] = (emap, ruleno, numrep, ew, ex, ecomp)
    t_oracle = time.perf_counter()
    oracle_rows, edge_oracle_s = pl_oracle(
        {n: e[:5] for n, e in edges.items()})
    oracle_wall_s = time.perf_counter() - t_oracle
    for ename, (_, ruleno, numrep, ew, ex, ecomp) in edges.items():
        erule = ecomp.compile_rule(ruleno, numrep)
        ew_t, ex_t = t32(ew), t32(ex)
        want = torch.from_numpy(oracle_rows[ename]).to(dev)
        widths = sorted({bulk.group_width(ecomp.widest(erule.take), n, lanes)
                         for n in (1, PL_X)})
        err, draws = 0, set()
        for width in widths:
            kd = zero_count()
            err = max(err, max_abs_err(bulk.rule_rows(
                ecomp, ew_t, ex_t, erule, numrep, kd, width), want))
            draws.add(int(kd.item()))
        check(len(draws) == 1 and min(draws) > 0,
              f"crush_rule edge {ename}: the kernel counted draws {draws} "
              f"at {widths} lanes")
        if ename in PL_EDGE_PLAIN:
            pd = zero_count()
            err = max(err, max_abs_err(bulk.rule_rows_plain(
                ecomp, ew_t, ex_t, erule, numrep, pd), want))
            check(int(pd.item()) in draws,
                  f"crush_rule edge {ename}: the kernel counted {draws} "
                  f"draws, the plain version {int(pd.item())}")
            edge_plain_draws[ename] = int(pd.item())
        check(err == 0, f"crush_rule edge {ename}: kernel and do_rule differ "
                        f"by {err}")
        edge_groups[ename] = widths
        errs[f"edge_{ename}"] = err
    emit({"phase": "placement_rule_edges", "inputs": PL_EDGE_X,
          "inputs_numrep_256": PL_EDGE_X_WIDE, "against": "CrushMap.do_rule",
          "seconds": time.perf_counter() - t_edges,
          "oracle_wall_s": oracle_wall_s, "oracle_workers": PL_ORACLE_WORKERS,
          "oracle_seconds": edge_oracle_s,
          "groups": edge_groups, "draws_equal_across_widths": True,
          "plain_draws": edge_plain_draws,
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


#: The corpus phase: the golden corpus's largest byte-API shape (rs_tpu 8+4
#: at 65,537 bytes: one stripe of 8,224-byte chunks), and the probe's
#: codec (k=8, m=2, reed_sol_van, 64 stripes of 8 KiB cells: 4 MiB).
CP_CORPUS_PROFILE = {"plugin": "rs_tpu", "k": "8", "m": "4",
                     "backend": "device"}
CP_CORPUS_BYTES = 65537
CP_PROBE_PROFILE = {"plugin": "rs_tpu", "k": "8", "m": "2"}
#: The phase's budget: it must stay cheap in a script near 900 s.
CP_BUDGET_S = 30.0


def corpus_phase(card: str, rng, device=None) -> dict:
    """The golden corpus, the engine probe and the port's lint on the card
    (see the module docstring; ``device`` None: the card, as a user
    leaves it out): ``gen_ec_corpus --check`` through its ``main`` (both
    arms, gated on zero drift), then
    ``engine._probe`` after ``engine.reset_probe()``, with every count set
    to 0 just before the corpus and read after each part; then K1 and K2
    timed at the probe's batch and K1 at the corpus's largest byte-API
    shape, each against its plain version; then ``tpulint --json
    --no-baseline`` over ``ceph_tpu_torch`` through its ``main``, its
    findings counted by rule and gated on none outside the baseline. Returns the launches by part and in all, the timed entries
    and the seconds of each part."""
    from collections import Counter

    from ceph_tpu_torch import analysis, kernels
    from ceph_tpu_torch.ec import engine, load_codec
    from ceph_tpu_torch.device import resolve, words_to_tensor
    from ceph_tpu_torch.ops import rs
    from ceph_tpu_torch.tools import gen_ec_corpus, tpulint

    dev = resolve(device)

    def counts() -> dict:
        return {k.name: k.launches for k in kernels.KERNELS}

    seconds = {}
    t0 = time.perf_counter()
    kernels.reset_counts()
    rc, out = tl_run(gen_ec_corpus, ["--check", *tl_device(device)])
    by_part = {"corpus": counts()}
    lines = out.splitlines()
    drift = [ln for ln in lines if ln.startswith("DRIFT")]
    for ln in drift:
        print(ln, flush=True)
    n_device = sum(p["plugin"] in gen_ec_corpus.DEVICE_PLUGINS
                   for p in gen_ec_corpus.MATRIX)
    check(rc == 0 and not drift, f"corpus --check: rc {rc}, "
                                 f"{len(drift)} drift lines")
    check(by_part["corpus"]["gf_matmul"] > 0,
          f"the corpus launched gf_matmul "
          f"{by_part['corpus']['gf_matmul']} times")
    seconds["corpus"] = time.perf_counter() - t0
    emit({"phase": "corpus", "step": "corpus",
          "configs": len(gen_ec_corpus.MATRIX),
          "sizes": list(gen_ec_corpus.SIZES),
          "pinned_arm": len(gen_ec_corpus.MATRIX),
          "device_arm": n_device,
          "host_only": [gen_ec_corpus.profile_key(p)
                        for p in gen_ec_corpus.MATRIX
                        if p["plugin"] not in gen_ec_corpus.DEVICE_PLUGINS],
          "drift": len(drift), "summary": lines[-1],
          "launches": by_part["corpus"], "seconds": seconds["corpus"]})

    t0 = time.perf_counter()
    engine.reset_probe()
    engine.last_probe.clear()
    before = counts()
    verdict = engine._probe(device)
    by_part["probe"] = {k: v - before[k] for k, v in counts().items()}
    launches = counts()
    check(all(by_part["probe"][k] > 0 for k in ("gf_matmul", "crc32c")),
          f"the probe launched {by_part['probe']}")
    seconds["probe"] = time.perf_counter() - t0
    emit({"phase": "corpus", "step": "probe", "verdict": verdict,
          **engine.last_probe, "auto_resolves_to": verdict,
          "nvidia_smi": card, "launches": by_part["probe"],
          "seconds": seconds["probe"]})
    engine.reset_probe()

    # K1 + K2 of the probe's dispatch with the batch on the card, then each
    # kernel alone at the probe's and the corpus's shapes
    t0 = time.perf_counter()
    probe = load_codec(CP_PROBE_PROFILE, device=dev)
    cell_bytes = engine._PROBE_WORDS * 4
    x = words_to_tensor(rng.integers(
        0, 2**32, (engine._PROBE_B, engine._PROBE_K, engine._PROBE_WORDS),
        dtype=np.uint32), dev)

    def fused():
        return rs.encode_with_crcs(probe.matrix, cell_bytes, x)

    ms = time_ms(fused, reps=50)
    prof = profile_steps(fused, reps=20, pads=BT_PADS)
    emit({"phase": "time", "what": "probe_fused", "ms": ms,
          "device_ms": device_ms(prof), "idle_share": prof["idle_share"],
          "profile": {k: prof[k] for k in PROFILE_CLOCK}})
    del x
    timed = batch_times(dev, rng, probe, engine._PROBE_B, cell_bytes,
                        "probe", cases=("write", "crc"))
    big = load_codec(CP_CORPUS_PROFILE, device=dev)
    timed.update(batch_times(dev, rng, big, 1,
                             big.get_chunk_size(CP_CORPUS_BYTES), "corpus",
                             cases=("write",)))
    seconds["times"] = time.perf_counter() - t0

    # every finding, baselined or not, then the gate against the baseline
    t0 = time.perf_counter()
    rc, out = tl_run(tpulint, ["--json", "--no-baseline"])
    found = [analysis.Finding(**f) for f in json.loads(out)]
    new = analysis.unbaselined(
        found, analysis.load_baseline(tpulint.DEFAULT_BASELINE))
    check(rc == (1 if found else 0) and not new,
          f"tpulint: rc {rc}, unbaselined {[f.render() for f in new]}")
    seconds["lint"] = time.perf_counter() - t0
    emit({"phase": "corpus", "step": "lint",
          "findings": len(found), "unbaselined": len(new),
          "by_rule": dict(sorted(Counter(f.rule for f in found).items())),
          "rules": len(analysis.instance().names()),
          "seconds": seconds["lint"]})
    seconds["total"] = sum(seconds.values())
    emit({"phase": "corpus_seconds", **seconds, "budget_s": CP_BUDGET_S,
          "over_budget": seconds["total"] > CP_BUDGET_S})
    return {"launches": launches, "by_part": by_part, "timed": timed,
            "verdict": verdict, "probe": dict(engine.last_probe),
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


async def cl_ops(client, ops: list) -> dict:
    """Submit ``ops`` [(pool, name, op vector, bytes a read must return
    or None)] through the client's aio window and wait for all of them ->
    {"lat_s": each op's seconds from entering the window to its reply,
    "wall_s", "failed": failures, "mismatched": reads unequal to their
    bytes}."""
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
    failed, mismatched = [], 0
    for (pool, name, _, want), comp in zip(ops, comps):
        try:
            reply = comp.result()
        except Exception as e:  # every failure is counted, then fails
            failed.append(f"{pool}/{name}: {e!r}")
            continue
        if want is not None and bytes(reply.outs[0][1]) != want:
            mismatched += 1
    return {"lat_s": lat, "wall_s": wall, "failed": failed,
            "mismatched": mismatched}


class ClSteps:
    """The ledger of phases ``cluster`` and ``services``, read at each
    step's end: kernel launches, calls of the rs byte API
    (``RSCodec.encode_chunks`` / ``decode_chunks``), the recovery
    reservations a PG asked of its targets (``PG._reserve_remote``:
    granted, or timed out after 4 x ``osd_subop_timeout``), the OSDs'
    decode rounds on the device and on the host engine, the client's
    placement counters and the lookups its resolver failed (raised out of
    ``PlacementResolver.afull`` or ``full``, also where a caller swallows
    them, as the striper's prefetch does), each as the step's delta."""

    def __init__(self, card: str, phase: str = "cluster"):
        from ceph_tpu_torch import kernels
        from ceph_tpu_torch.cluster.pg import PG
        from ceph_tpu_torch.ec import rs_plugin
        from ceph_tpu_torch.placement.resolver import PlacementResolver

        self.card = card
        self.phase = phase
        self.kernels = kernels
        self.rs_calls = {"encode_chunks": 0, "decode_chunks": 0}
        self.reserve = {"granted": 0, "timed_out": 0}
        self.placement_failures = 0
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
        afull, full = PlacementResolver.afull, PlacementResolver.full

        async def afull_counted(*a, **kw):
            try:
                return await afull(*a, **kw)
            except Exception:
                self.placement_failures += 1
                raise

        def full_counted(*a, **kw):
            try:
                return full(*a, **kw)
            except Exception:
                self.placement_failures += 1
                raise
        self._real += [(PlacementResolver, "afull", afull),
                       (PlacementResolver, "full", full)]
        PlacementResolver.afull = afull_counted
        PlacementResolver.full = full_counted
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
                "placement_failures": self.placement_failures,
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
        line = {"phase": self.phase, "step": step,
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
                "placement_failures": now["placement_failures"]
                - last["placement_failures"],
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
            "failed_ops": len(res["failed"])}


def cl_check(res: dict, what: str) -> None:
    check(not res["failed"], f"cluster {what}: {len(res['failed'])} ops "
                             f"failed, first {res['failed'][:3]}")
    check(res["mismatched"] == 0,
          f"cluster {what}: {res['mismatched']} reads differ from what "
          "was written")


def cl_lookups_check(steps: ClSteps, phase: str) -> None:
    """No step of ``steps`` failed a placement lookup."""
    failed = {s: line["placement_failures"]
              for s, line in steps.lines.items()
              if line["placement_failures"]}
    check(not failed, f"{phase}: placement lookups failed {failed}")


def cl_hinfo_check(stores, su: int, phase: str) -> tuple[int, int]:
    """Every EC shard's hash_info CRCs (the CL_EC_POOL collections of
    ``stores``, PG meta objects left out) against the C++ core's CRC32C
    of its ``su``-byte cells -> (shards, cells) checked."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch.cluster.pg import ATTR_HINFO, META_OID
    from ceph_tpu_torch.cluster.stripe import dec_hinfo

    shards = cells = 0
    for store in stores:
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
                      f"{phase}: {cid}/{oid!r} hash_info differs from "
                      "the C++ core's CRC of its bytes")
                shards += 1
                cells += len(got)
    return shards, cells


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
    from ceph_tpu_torch.cluster import TestCluster
    from ceph_tpu_torch.cluster import messages as M
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
        shards, cells = cl_hinfo_check(c.stores, su, "cluster")
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
        cl_lookups_check(steps, "cluster")
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


async def sv_run(calls, qd: int) -> dict:
    """Await every zero-argument coroutine function of ``calls``, at most
    ``qd`` in flight, in order of submission -> {"lat_s": each call's
    seconds, "wall_s", "results": what each returned}. A failure raises
    out of the step."""
    sem = asyncio.Semaphore(qd)
    lat = [0.0] * len(calls)
    results = [None] * len(calls)

    async def one(i, call):
        async with sem:
            t = time.perf_counter()
            results[i] = await call()
            lat[i] = time.perf_counter() - t

    t0 = time.perf_counter()
    await asyncio.gather(*(one(i, c) for i, c in enumerate(calls)))
    return {"lat_s": lat, "wall_s": time.perf_counter() - t0,
            "results": results}


def sv_traffic(res: dict, nbytes: int) -> dict:
    """A step's traffic numbers from ``sv_run``'s result."""
    lat = np.asarray(res["lat_s"]) * 1e3
    return {"ops": len(lat), "bytes": nbytes, "wall_s": res["wall_s"],
            "GiB_per_s": nbytes / 2**30 / res["wall_s"],
            "ops_per_s": len(lat) / res["wall_s"],
            "lat_p50_ms": float(np.percentile(lat, 50)),
            "lat_p99_ms": float(np.percentile(lat, 99))}


def sv_blocks(rng, nbytes: int, count: int) -> list[int]:
    """fio randwrite offsets: ``count`` distinct SV_OVERWRITE_BYTES-aligned
    blocks of an ``nbytes`` file, so writes in flight together never
    overlap and the host's copy is the same in any order."""
    n = nbytes // SV_OVERWRITE_BYTES
    return [int(b) * SV_OVERWRITE_BYTES
            for b in rng.choice(n, min(count, n), replace=False)]


async def sv_read_back(read, model, io: int) -> dict:
    """Read ``model``'s bytes back from offset 0 through ``read(offset,
    length)`` in ``io``-byte requests, SV_QD at a time -> ``sv_run``'s
    result, each result whether the read equals the model."""
    async def one(off):
        want = model[off:off + io]
        return await read(off, len(want)) == want
    return await sv_run([lambda o=o: one(o)
                         for o in range(0, len(model), io)], SV_QD)


def sv_reads_equal(res: dict, what: str) -> None:
    bad = sum(1 for ok in res["results"] if not ok)
    check(bad == 0, f"services {what}: {bad} of {len(res['results'])} "
                    "reads differ from the host's copy")


def sv_sqlite_shared() -> str | None:
    """None when this Python's ``sqlite3`` module loads the
    ``libsqlite3.so.0`` that ctypes opens, so a VFS registered through
    ctypes (``CephVFS.register``) serves its ``connect``; else why not (a
    module with SQLite linked in statically never sees the VFS)."""
    import ctypes
    import sqlite3

    def mapped() -> set[str]:
        with open("/proc/self/maps") as f:
            return {os.path.realpath(ln.split()[-1]) for ln in f
                    if "libsqlite3" in ln and "/" in ln}

    module = mapped()
    if not module:
        return (f"the sqlite3 module ({sqlite3.sqlite_version}) maps no "
                "libsqlite3 shared library: SQLite is linked in statically")
    try:
        ctypes.CDLL("libsqlite3.so.0")
    except OSError as e:
        return f"ctypes cannot open libsqlite3.so.0: {e}"
    both = mapped()
    if both != module:
        return (f"the sqlite3 module maps {sorted(module)}, ctypes "
                f"{sorted(both - module)}")
    return None


async def sv_fs(steps: ClSteps, c, rng, sz: dict) -> dict:
    """Step ``fs``: FSLite with its data on the EC pool."""
    from ceph_tpu_torch.services.fs import FSLite

    io, size = sz["io_bytes"], sz["fs_file_bytes"]
    fs = FSLite(c.client, CL_REP_POOL, data_pool=CL_EC_POOL)
    await fs.mkfs()
    model = bytearray(rng.bytes(size))
    n = size // io
    # one write at a time, in order (dd bs=4M): FSLite.write reads the
    # inode's size and writes it back, so two extending writes in flight
    # could leave the smaller one
    res = await sv_run([lambda i=i: fs.write(
        "/big", bytes(model[i * io:(i + 1) * io]), i * io)
        for i in range(n)], 1)
    write = sv_traffic(res, size)
    res = await sv_read_back(lambda o, n: fs.read("/big", o, n), model, io)
    sv_reads_equal(res, "fs read")
    read = sv_traffic(res, size)
    # 4 KiB random overwrites inside the file: the inode's size does not
    # move, so they run SV_QD at a time (partial-stripe RMW on the PG)
    offs = sv_blocks(rng, size, sz["fs_overwrites"])
    patches = [rng.bytes(SV_OVERWRITE_BYTES) for _ in offs]
    for off, p in zip(offs, patches):
        model[off:off + SV_OVERWRITE_BYTES] = p
    res = await sv_run([lambda o=o, p=p: fs.write("/big", p, o)
                        for o, p in zip(offs, patches)], SV_QD)
    overwrite = sv_traffic(res, len(offs) * SV_OVERWRITE_BYTES)
    # (step degraded reads the whole file back after them)
    # truncate at an unaligned length: the tail is cut on the OSDs
    cut = size - io - io // 2 - 12_345
    t0 = time.perf_counter()
    await fs.truncate("/big", cut)
    truncate_s = time.perf_counter() - t0
    del model[cut:]
    check((await fs.stat("/big"))["size"] == cut, "fs truncate size")
    tail = max(0, cut - 2 * io)
    check(await fs.read("/big", tail) == model[tail:],
          "fs read across the truncation")
    # small files in directories, one create at a time (the inode
    # allocator reads and writes back fsmeta.nextino); read SV_QD at a time
    dirs = [f"/d{j}" for j in range(sz["fs_dirs"])]
    for d in dirs:
        await fs.mkdir(d)
    small = {f"{dirs[i % len(dirs)]}/f{i:04d}": rng.bytes(
        sz["fs_small_bytes"]) for i in range(sz["fs_files"])}
    res = await sv_run([lambda p=p, d=d: fs.write(p, d)
                        for p, d in small.items()], 1)
    create = sv_traffic(res, sum(map(len, small.values())))
    t0 = time.perf_counter()
    listed = {d: await fs.listdir(d) for d in dirs}
    list_s = time.perf_counter() - t0
    for d in dirs:
        check(sorted(listed[d]) == sorted(
            p.rsplit("/", 1)[1] for p in small if p.startswith(d + "/")),
            f"fs listdir {d}")

    async def read_small(p):
        return await fs.read(p) == small[p]
    res = await sv_run([lambda p=p: read_small(p) for p in small], SV_QD)
    sv_reads_equal(res, "fs small-file read")
    steps.mark("fs", write=write, read=read, overwrite=overwrite,
               truncate_s=truncate_s, truncated_to=cut,
               small_create=create, small_read=sv_traffic(
                   res, sum(map(len, small.values()))),
               dirs=len(dirs), list_s=list_s)
    return {"fs": fs, "model": model}


async def sv_rbd(steps: ClSteps, c, rng, sz: dict) -> None:
    """Step ``rbd``: one image on the replicated pool, then a snapshot, a
    clone and copy-up."""
    from ceph_tpu_torch.services.rbd import RBD

    io, size = sz["io_bytes"], sz["rbd_image_bytes"]
    rbd = RBD(c.client, CL_REP_POOL)
    await rbd.create("vol", size)
    img = await rbd.open("vol")
    model = bytearray(rng.bytes(size))
    res = await sv_run([lambda o=o: img.write(o, bytes(model[o:o + io]))
                        for o in range(0, size, io)], SV_QD)
    write = sv_traffic(res, size)
    res = await sv_read_back(img.read, model, io)
    sv_reads_equal(res, "rbd read")
    read = sv_traffic(res, size)
    await img.release_lock()
    # 4 KiB random writes through the write-back cache, then a flush
    cimg = await rbd.open("vol", cache=True)
    offs = sv_blocks(rng, size, sz["rbd_randwrites"])
    patches = [rng.bytes(SV_OVERWRITE_BYTES) for _ in offs]
    for off, p in zip(offs, patches):
        model[off:off + SV_OVERWRITE_BYTES] = p
    res = await sv_run([lambda o=o, p=p: cimg.write(o, p)
                        for o, p in zip(offs, patches)], SV_QD)
    t0 = time.perf_counter()
    await cimg.flush()
    flush_s = time.perf_counter() - t0
    randwrite = sv_traffic(res, len(offs) * SV_OVERWRITE_BYTES)
    randwrite["wall_s_with_flush"] = randwrite["wall_s"] + flush_s
    # a snapshot, then the head's first objects overwritten
    t0 = time.perf_counter()
    await cimg.snap_create("s1")
    snap_s = time.perf_counter() - t0
    at_snap = bytes(model)
    span = sz["rbd_copyups"] * io
    fresh = rng.bytes(span)
    model[:span] = fresh
    res = await sv_run([lambda o=o: cimg.write(o, fresh[o:o + io])
                        for o in range(0, span, io)], SV_QD)
    await cimg.flush()
    overwrite = sv_traffic(res, span)
    snap = await rbd.open("vol", snap="s1")
    res = await sv_read_back(snap.read, at_snap, io)
    sv_reads_equal(res, "rbd read at the snapshot")
    snap_read = sv_traffic(res, size)
    res = await sv_read_back(cimg.read, model[:span], io)
    sv_reads_equal(res, "rbd head read after the overwrite")
    # a clone of the snapshot; a 4 KiB write into each of the objects
    # after the overwritten ones copies that object up from the parent
    t0 = time.perf_counter()
    await rbd.clone("vol", "s1", "child")
    child = await rbd.open("child")
    clone_s = time.perf_counter() - t0
    child_model = bytearray(at_snap[:3 * span])
    ups = list(range(span, 2 * span, io))
    for o in ups:
        child_model[o + 8192:o + 12288] = rng.bytes(4096)
    res = await sv_run([lambda o=o: child.write(
        o + 8192, bytes(child_model[o + 8192:o + 12288])) for o in ups],
        SV_QD)
    copyup = sv_traffic(res, len(ups) * io)
    res = await sv_read_back(child.read, child_model, io)
    sv_reads_equal(res, "rbd child read")
    child_read = sv_traffic(res, 3 * span)
    objects = {bytes(n) for n in await c.client.list_objects(CL_REP_POOL)}
    copied = sum(f"rbd_data.child.{o // io:016x}".encode() in objects
                 for o in range(0, 3 * span, io))
    check(copied == len(ups), f"rbd child holds {copied} objects, "
                              f"{len(ups)} copied up")
    await child.release_lock()
    await cimg.release_lock()
    steps.mark("rbd", write=write, read=read, randwrite=randwrite,
               flush_s=flush_s, snap_s=snap_s, overwrite=overwrite,
               snap_read=snap_read, clone_s=clone_s, copyup=copyup,
               child_read=child_read, copied_up=copied)


async def sv_crypto(steps: ClSteps, c, rng, sz: dict) -> None:
    """Step ``rbd_crypto``: an encrypted image written and read, when the
    ``cryptography`` package imports; else a line that says it is
    missing."""
    import importlib.util

    if importlib.util.find_spec("cryptography") is None:
        emit({"phase": "services", "step": "rbd_crypto", "skipped":
              "left out: rbd_crypto's AES-XTS and AES-GCM import the "
              "cryptography package, which this machine does not have; "
              "tests/test_torch_rbd_crypto.py runs it on the CPU",
              "card": steps.card})
        return
    from ceph_tpu_torch.services.rbd import RBD
    from ceph_tpu_torch.services.rbd_crypto import (encryption_format,
                                                    open_encrypted)

    io, size = sz["io_bytes"], sz["crypt_image_bytes"]
    rbd = RBD(c.client, CL_REP_POOL)
    await rbd.create("vault", size)
    await encryption_format(rbd, "vault", "services-phase")
    img = await open_encrypted(rbd, "vault", "services-phase")
    model = rng.bytes(size)
    res = await sv_run([lambda o=o: img.write(o, model[o:o + io])
                        for o in range(0, size, io)], SV_QD)
    write = sv_traffic(res, size)
    res = await sv_read_back(img.read, model, io)
    sv_reads_equal(res, "rbd_crypto read")
    read = sv_traffic(res, size)
    await img.close()
    raw = await (await rbd.open("vault")).read(0, io)
    check(raw != model[:io], "rbd_crypto: the image holds plaintext")
    steps.mark("rbd_crypto", write=write, read=read)


async def sv_mirror(steps: ClSteps, c, rng, sz: dict, device) -> None:
    """Step ``mirror``: a journaled image on the main cluster replayed by
    a MirrorDaemon onto a second TestCluster on the same device."""
    from ceph_tpu_torch.cluster import TestCluster
    from ceph_tpu_torch.placement.osdmap import Pool
    from ceph_tpu_torch.services import mirror as mir
    from ceph_tpu_torch.services.rbd import RBD

    io, size = sz["io_bytes"], sz["mirror_image_bytes"]
    t0 = time.perf_counter()
    site = TestCluster(n_osds=SV_MIRROR_OSDS, device=device)
    await site.start()
    try:
        site.client.op_timeout = CL_OP_TIMEOUT_S
        await site.client.create_pool(Pool(
            id=1, name="rbd", size=3, pg_num=SV_MIRROR_PGS, crush_rule=0))
        await site.wait_active(60)
        site_s = time.perf_counter() - t0
        await RBD(c.client, CL_REP_POOL).create("mirrored", size)
        img = await mir.journaled(c.client, CL_REP_POOL, "mirrored")
        daemon = mir.MirrorDaemon(c.client, CL_REP_POOL, site.client, 1)
        check(await daemon.sync_image("mirrored") == 0,
              "mirror bootstrap replayed entries")
        model = rng.bytes(size)
        offs = list(range(0, size, io))
        rounds = np.array_split(offs, sz["mirror_rounds"])
        lat, wall, applied, replay_s = [], 0.0, 0, 0.0
        for part in rounds:
            res = await sv_run([lambda o=int(o): img.write(
                o, model[o:o + io]) for o in part], SV_QD)
            lat += res["lat_s"]
            wall += res["wall_s"]
            t1 = time.perf_counter()
            n = await daemon.sync_image("mirrored")
            replay_s += time.perf_counter() - t1
            check(n == len(part), f"mirror replayed {n} of {len(part)}")
            applied += n
        write = sv_traffic({"lat_s": lat, "wall_s": wall}, size)
        dst = await RBD(site.client, 1).open("mirrored")
        check(dst.size == size, f"mirror secondary size {dst.size}")
        res = await sv_read_back(dst.read, model, io)
        sv_reads_equal(res, "mirror secondary read")
        secondary = sv_traffic(res, size)
        res = await sv_read_back(img.read, model, io)
        sv_reads_equal(res, "mirror primary read")
        await img.release_lock()
        await dst.release_lock()
        steps.mark("mirror", site_start_s=site_s, write=write,
                   entries_replayed=applied, replay_s=replay_s,
                   replay_GiB_per_s=size / 2**30 / replay_s,
                   secondary_read=secondary,
                   primary_read=sv_traffic(res, size))
    finally:
        await site.stop()


def sv_http(port: int, method: str, path: str, body: bytes = b"",
            query: str = "") -> tuple[int, dict, bytes]:
    """One sigv4-signed S3 request to 127.0.0.1:``port`` (blocking: run it
    in a thread, never on the cluster's loop) -> (status, headers, body)."""
    import urllib.error
    import urllib.request

    from ceph_tpu_torch.services.rgw import _sha256, sigv4_sign

    host = f"127.0.0.1:{port}"
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    headers = {"host": host, "x-amz-content-sha256": _sha256(body),
               "x-amz-date": amz_date}
    headers["authorization"] = sigv4_sign(
        method, path, query, headers, body, *SV_RGW_USER, amz_date)
    req = urllib.request.Request(
        f"http://{host}{path}" + (f"?{query}" if query else ""),
        data=body or None, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=CL_OP_TIMEOUT_S) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, \
                r.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


async def sv_rgw(steps: ClSteps, c, rng, sz: dict) -> None:
    """Step ``rgw``: S3 over HTTP with sigv4 on the replicated pool."""
    import hashlib
    import xml.etree.ElementTree as ET

    from ceph_tpu_torch.services.rgw import RGWLite, S3Frontend

    rgw = RGWLite(c.client, CL_REP_POOL)
    fe = S3Frontend(rgw, users={SV_RGW_USER[0]: SV_RGW_USER[1]})
    _host, port = await fe.start("127.0.0.1", 0)
    try:
        def http(*a, **kw):
            return asyncio.to_thread(sv_http, port, *a, **kw)

        status, _, body = await http("PUT", "/services")
        check(status == 200, f"rgw bucket create {status} {body[:200]}")
        objs = {f"obj-{i:04d}": rng.bytes(sz["rgw_object_bytes"])
                for i in range(sz["rgw_puts"])}

        async def put(key):
            status, hdr, _ = await http("PUT", f"/services/{key}",
                                        objs[key])
            return (status == 200 and hdr.get("etag", "").strip('"')
                    == hashlib.md5(objs[key]).hexdigest())
        res = await sv_run([lambda k=k: put(k) for k in objs], SV_QD)
        bad = sum(not ok for ok in res["results"])
        check(bad == 0, f"rgw: {bad} PUTs failed or returned a wrong ETag")
        puts = sv_traffic(res, sum(map(len, objs.values())))
        # multipart through the gateway's API (its S3 frontend has no
        # multipart route, as in the reference), parts SV_QD at a time
        mp = rng.bytes(sz["rgw_multipart_bytes"])
        part = len(mp) // sz["rgw_parts"]
        t0 = time.perf_counter()
        upload = await rgw.initiate_multipart("services", "multipart")
        res = await sv_run([lambda p=p: rgw.upload_part(
            "services", "multipart", upload, p + 1,
            mp[p * part:(p + 1) * part]) for p in range(sz["rgw_parts"])],
            SV_QD)
        etag = await rgw.complete_multipart(
            "services", "multipart", upload, list(range(1, sz["rgw_parts"]
                                                        + 1)))
        multipart_s = time.perf_counter() - t0
        want = hashlib.md5(b"".join(bytes.fromhex(e) for e in
                                    res["results"])).hexdigest()
        check(etag == f"{want}-{sz['rgw_parts']}", f"rgw multipart ETag "
                                                   f"{etag}")
        objs["multipart"] = mp

        async def get(key):
            status, _, body = await http("GET", f"/services/{key}")
            return status == 200 and body == objs[key]
        res = await sv_run([lambda k=k: get(k) for k in objs], SV_QD)
        sv_reads_equal(res, "rgw GET")
        gets = sv_traffic(res, sum(map(len, objs.values())))
        t0 = time.perf_counter()
        status, _, body = await http("GET", "/services")
        list_s = time.perf_counter() - t0
        check(status == 200, f"rgw listing {status}")
        keys = [el.text for el in ET.fromstring(body).iter()
                if el.tag.rsplit("}", 1)[-1] == "Key"]
        check(keys == sorted(objs), f"rgw listing {keys[:4]}...")
    finally:
        await fe.stop()
    steps.mark("rgw", puts=puts, multipart_bytes=len(mp),
               multipart_parts=sz["rgw_parts"], multipart_s=multipart_s,
               gets=gets, listed=len(keys), list_s=list_s)


SV_SQL_SCHEMA = ("create table t (id integer primary key, k text, "
                 "v integer, pad text)")
SV_SQL_AGG = "select count(*), sum(v), min(k), max(k) from t"


def sv_sql_rows(rng, lo: int, hi: int) -> list[tuple]:
    vals = rng.integers(0, 1 << 40, hi - lo)
    return [(i, f"key-{i:08d}", int(v), f"{int(v):x}" * 4)
            for i, v in zip(range(lo, hi), vals)]


def sv_sql_expect(rows: list[tuple]) -> tuple:
    return (len(rows), sum(r[2] for r in rows), min(r[1] for r in rows),
            max(r[1] for r in rows))


async def sv_sqlite(steps: ClSteps, c, rng, sz: dict, bridge):
    """Step ``sqlite``: a CephVFS database on the EC pool. The SQLite
    calls run in a thread, their VFS callbacks on the cluster's loop
    (``bridge``). -> (the VFS, the rows), or None with a line that says
    why the step was left out."""
    why = sv_sqlite_shared()
    if why is not None:
        emit({"phase": "services", "step": "sqlite", "skipped":
              f"left out: {why}", "card": steps.card})
        return None
    import sqlite3

    from ceph_tpu_torch.services.sqlite_vfs import CephVFS

    vfs = CephVFS(bridge, c.client, CL_EC_POOL)
    vfs.register()
    rows = sv_sql_rows(rng, 0, sz["sql_rows"])

    def work() -> dict:
        out = {}
        t0 = time.perf_counter()
        db = sqlite3.connect(f"file:services?vfs={vfs.name}", uri=True,
                             timeout=CL_OP_TIMEOUT_S)
        db.execute(SV_SQL_SCHEMA)
        with db:
            db.executemany("insert into t values (?, ?, ?, ?)", rows)
        out["insert_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["agg"] = db.execute(SV_SQL_AGG).fetchone()
        out["query_s"] = time.perf_counter() - t0
        db.close()
        t0 = time.perf_counter()
        db = sqlite3.connect(f"file:services?vfs={vfs.name}", uri=True,
                             timeout=CL_OP_TIMEOUT_S)
        out["count"] = db.execute("select count(*) from t").fetchone()[0]
        out["pages"] = db.execute("pragma page_count").fetchone()[0]
        db.close()
        out["reopen_s"] = time.perf_counter() - t0
        return out

    out = await asyncio.to_thread(work)
    check(out["agg"] == sv_sql_expect(rows),
          f"sqlite aggregate {out['agg']}")
    check(out["count"] == len(rows), f"sqlite count after reopen "
                                     f"{out['count']}")
    steps.mark("sqlite", rows=len(rows), rows_per_s=len(rows)
               / out["insert_s"], insert_s=out["insert_s"],
               query_s=out["query_s"], reopen_s=out["reopen_s"],
               db_pages=out["pages"])
    return vfs, rows


async def sv_degraded(steps: ClSteps, c, rng, sz: dict, fs_state: dict,
                      sql) -> None:
    """Step ``degraded``: OSD SV_KILLED (it holds EC shards) killed and
    down; the FS file read and a file written, the SQLite database
    queried and written while the EC pool runs degraded (K1 rebuilds,
    K1 and K2 on the writes)."""
    import sqlite3

    from ceph_tpu_torch.cluster.pg import META_OID

    store = c.stores[SV_KILLED]
    held = sum(1 for cid in store.list_collections()
               if cid.startswith(f"{CL_EC_POOL}.")
               for oid in store.list_objects(cid) if oid != META_OID)
    check(held > 0, f"services: OSD {SV_KILLED} holds no EC shard")
    await c.kill_osd(SV_KILLED)
    await c.wait_down(SV_KILLED, timeout=30)
    fs, model = fs_state["fs"], fs_state["model"]
    io = sz["io_bytes"]
    res = await sv_read_back(lambda o, n: fs.read("/big", o, n), model, io)
    sv_reads_equal(res, "fs degraded read")
    fs_read = sv_traffic(res, len(model))
    late = rng.bytes(io)
    t0 = time.perf_counter()
    await fs.write("/late", late)
    check(await fs.read("/late") == late, "fs degraded write read back")
    fs_write_s = time.perf_counter() - t0
    sqlite = None
    if sql is not None:
        vfs, rows = sql
        more = sv_sql_rows(rng, len(rows), len(rows)
                           + sz["sql_degraded_rows"])

        def work() -> dict:
            out = {}
            t0 = time.perf_counter()
            db = sqlite3.connect(f"file:services?vfs={vfs.name}",
                                 uri=True, timeout=CL_OP_TIMEOUT_S)
            out["agg"] = db.execute(SV_SQL_AGG).fetchone()
            out["query_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            with db:
                db.executemany("insert into t values (?, ?, ?, ?)", more)
            out["insert_s"] = time.perf_counter() - t0
            out["agg_after"] = db.execute(SV_SQL_AGG).fetchone()
            db.close()
            return out

        out = await asyncio.to_thread(work)
        check(out["agg"] == sv_sql_expect(rows),
              f"sqlite degraded aggregate {out['agg']}")
        check(out["agg_after"] == sv_sql_expect(rows + more),
              f"sqlite degraded write {out['agg_after']}")
        sqlite = {"query_s": out["query_s"], "insert_s": out["insert_s"],
                  "rows_inserted": len(more)}
        vfs.unregister()
    # every EC shard's hash_info on every OSD, the killed one's included
    su = next(o for o in c.osds if o is not None).sinfo_for(
        c.mon.osdmap.pools[CL_EC_POOL]).su
    shards, cells = cl_hinfo_check(c.stores, su, "services")
    steps.mark("degraded", killed=SV_KILLED, shards_held=held,
               fs_read=fs_read, fs_write_s=fs_write_s, sqlite=sqlite,
               shards_crc_checked=shards, cells_crc_checked=cells)


async def sv_drive(steps: ClSteps, bridge, device, rng, sz: dict) -> None:
    """The services phase on the cluster's loop (``bridge``'s)."""
    from ceph_tpu_torch.cluster import TestCluster
    from ceph_tpu_torch.cluster.client import RadosError
    from ceph_tpu_torch.placement.osdmap import Pool
    from ceph_tpu_torch.services.rbd import RBD
    from ceph_tpu_torch.services.rgw import RGWLite

    c = TestCluster(n_osds=CL_OSDS, out_interval=CL_OUT_INTERVAL,
                    osd_conf={"osd_ec_cold_shape_bytes":
                              CL_COLD_SHAPE_BYTES}, device=device)
    steps.cluster = c
    await c.start()
    try:
        steps.start()
        c.client.op_timeout = CL_OP_TIMEOUT_S
        await c.client.create_pool(Pool(
            id=CL_REP_POOL, name="services", size=3, min_size=2,
            pg_num=CL_PG_NUM, crush_rule=0))
        await c.client.create_pool(Pool(
            id=CL_EC_POOL, name="services_data", size=11, min_size=8,
            pg_num=CL_PG_NUM, crush_rule=1, type="erasure",
            ec_profile=dict(CL_EC_PROFILE)))
        await c.wait_active(60)
        warmed = await c.client._placement.prewarm(
            c.client.osdmap, [CL_REP_POOL, CL_EC_POOL])
        check(warmed == 2 * CL_PG_NUM, f"services prewarm {warmed}")
        # RBD and RGW keep their state in omap, which an EC pool refuses
        # (as in the reference): both raise EOPNOTSUPP there
        refused = {}
        for what, make in (
                ("rbd", lambda: RBD(c.client, CL_EC_POOL).create(
                    "refused", 4 << 20)),
                ("rgw", lambda: RGWLite(c.client, CL_EC_POOL).create_bucket(
                    "refused"))):
            try:
                await make()
            except RadosError as e:
                refused[what] = e.code
        check(refused == {"rbd": -95, "rgw": -95},
              f"services: RBD/RGW on the EC pool gave {refused}")
        steps.mark("setup", prewarmed_pgids=warmed, ec_refusals=refused)
        fs_state = await sv_fs(steps, c, rng, sz)
        await sv_rbd(steps, c, rng, sz)
        await sv_crypto(steps, c, rng, sz)
        await sv_mirror(steps, c, rng, sz, device)
        await sv_rgw(steps, c, rng, sz)
        sql = await sv_sqlite(steps, c, rng, sz, bridge)
        await sv_degraded(steps, c, rng, sz, fs_state, sql)
    finally:
        await c.stop()
        steps.cluster = None


def services_phase(card: str, rng, device=None, **sizes) -> dict:
    """The client services tier on the cluster (see the SV_* constants):
    a TestCluster on ``device`` (the card when None, as a user leaves
    it) built and driven on the loop of a ``ClusterLoopThread``, whose
    thread CephVFS's SQLite callbacks call into; every count set to 0 at
    its start; then steps ``fs``, ``rbd``, ``rbd_crypto``, ``mirror``,
    ``rgw``, ``sqlite`` and ``degraded``, a line each (``sizes``
    overrides SV_SIZES). Every read must equal the host's copy; K1 and
    K2 must launch in ``fs``, ``sqlite`` (when it runs) and
    ``degraded``; no step may call the rs byte API, decode on the host
    engine or fail a placement lookup -> {"lines", "launches",
    "drive_s"}."""
    from ceph_tpu_torch.services.sqlite_vfs import ClusterLoopThread

    sz = {**SV_SIZES, **sizes}
    emit({"phase": "services", "cuts": {
        k: {"from": v, "to": sz[k]} for k, v in SV_FULL.items()
        if sz[k] != v}, "card": card})
    steps = ClSteps(card, phase="services")
    bridge = ClusterLoopThread()
    try:
        t0 = time.perf_counter()
        bridge.call(sv_drive(steps, bridge, device, rng, sz),
                    timeout=SV_TIMEOUT_S)
        drive_s = time.perf_counter() - t0
    finally:
        bridge.stop()
        steps.close()
    for step, line in steps.lines.items():
        check(line["rs_byte_api"] == {"encode_chunks": 0,
                                      "decode_chunks": 0},
              f"services {step}: rs byte API {line['rs_byte_api']}")
        check(line["decode_host_rounds"] == 0,
              f"services {step}: {line['decode_host_rounds']} decode "
              "rounds on the host engine")
    cl_lookups_check(steps, "services")
    for step in ("fs", "sqlite", "degraded"):
        if step not in steps.lines:
            check(step == "sqlite", f"services: no step {step}")
            continue
        for key in ("gf_matmul", "crc32c"):
            n = steps.lines[step]["launches"][key]
            check(n > 0, f"services {step} launched {key} {n} times")
    check(steps.lines["degraded"]["decode_batches"] > 0,
          "services degraded: no decode batch")
    launches = steps.totals()
    emit({"phase": "services_launches", **launches, "drive_s": drive_s})
    return {"lines": steps.lines, "launches": launches, "drive_s": drive_s}


def sv_batch_times(lines: dict, rng, device=None,
                   table: dict = SV_TIMED) -> dict:
    """K1 and K2 alone, each against its plain version, at the mean
    batches a phase made (``lines``, its lines by step; phase
    ``services``' by default): the cases of each step of ``table`` (tag:
    step, its batches, cases) that ran -> ``batch_times``' results."""
    from ceph_tpu_torch.ec import load_codec

    codec = load_codec(CL_EC_PROFILE, device=device)
    timed = {}
    for tag, (step, kind, cases) in table.items():
        line = lines.get(step)
        if line is None or not line[f"{kind}_batches"]:
            continue
        b = round(line[f"{kind}_stripes"] / line[f"{kind}_batches"])
        timed.update(batch_times(codec.device, rng, codec, b, ECB_SU, tag,
                                 cases))
    return timed


def pr_rss_bytes(pid: int) -> int:
    """Resident bytes of a live process (/proc VmRSS); 0 once it is gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def pr_compute_apps() -> dict[int, str]:
    """pid -> used memory of every process holding a context on the card,
    as ``nvidia-smi --query-compute-apps`` lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    apps = {}
    for line in out.splitlines():
        if line.strip():
            pid, mem = (f.strip() for f in line.split(",", 1))
            apps[int(pid)] = mem
    return apps


class PrSteps:
    """The proc phase's ledger for one ProcCluster, read at each step's
    end: every live OSD daemon's kernel launches (its admin socket's
    ``kernel launches``) and the PR_COUNTERS of its ``perf dump``, the
    launcher's own launches (the client's placement, K4), each as the
    step's delta. A daemon revived under a new pid counts from 0."""

    def __init__(self, c, card: str, transport: str, phase: str = "proc"):
        from ceph_tpu_torch import kernels

        self.c, self.card, self.transport = c, card, transport
        self.phase = phase
        self.kernels = kernels
        self.lines: dict[str, dict] = {}
        #: osd id -> its daemons' launches over the phase, by kernel
        self.by_osd: dict[int, dict[str, int]] = {}
        self._last = None

    async def _read(self) -> dict:
        if self.c.device.type == "cuda":
            torch.cuda.synchronize()
        daemons = {}
        for i in range(self.c.n_osds):
            proc = self.c.procs.get(f"osd.{i}")
            if proc is None or proc.poll() is not None:
                continue
            kl = await self.c.asok(f"osd.{i}", "kernel launches")
            perf = await self.c.asok(f"osd.{i}", "perf dump")
            daemons[i] = (kl["pid"], kl["launches"],
                          {k: int(perf[k]) for k in PR_COUNTERS})
        return {"t": time.perf_counter(), "daemons": daemons,
                "launcher": {k.name: k.launches
                             for k in self.kernels.KERNELS}}

    async def start(self) -> None:
        """Every count to 0 (launcher and daemons) just before the phase
        drives its path."""
        if self.c.device.type == "cuda":
            torch.cuda.synchronize()
        self.kernels.reset_counts()
        for i in range(self.c.n_osds):
            await self.c.asok(f"osd.{i}", "kernel launches", reset=True)
        self._last = await self._read()

    async def mark(self, step: str, **extra) -> dict:
        now, last = await self._read(), self._last
        launches = {n: v - last["launcher"][n]
                    for n, v in now["launcher"].items()}
        daemon_launches = {n: 0 for n in launches}
        counters = {k: 0 for k in PR_COUNTERS}
        for i, (pid, kl, perf) in now["daemons"].items():
            pid0, kl0, perf0 = last["daemons"].get(i, (None, {}, {}))
            same = pid0 == pid
            mine = self.by_osd.setdefault(i, {n: 0 for n in kl})
            for n, v in kl.items():
                d = v - (kl0.get(n, 0) if same else 0)
                launches[n] += d
                daemon_launches[n] += d
                mine[n] += d
            for k, v in perf.items():
                counters[k] += v - (perf0.get(k, 0) if same else 0)
        line = {"phase": self.phase, "transport": self.transport,
                "step": step,
                "seconds": now["t"] - last["t"],
                "osdmap_epoch": self.c.client.osdmap.epoch,
                "launches": launches,
                "daemon_launches": daemon_launches, **counters, **extra,
                "card": self.card}
        self.lines[step] = line
        self._last = now
        emit(line)
        return line

    def totals(self) -> dict:
        out = {k.name: 0 for k in self.kernels.KERNELS}
        for line in self.lines.values():
            for n, v in line["launches"].items():
                out[n] += v
        return out


async def pr_on_card(c) -> dict:
    """Every OSD daemon of ``c`` holds a CUDA context on this card: its
    pid among ``nvidia-smi``'s compute apps where that list names the
    processes by their pids, and in any case its own report over its
    admin socket (``device status``: context initialised, the card's
    name, the card memory it holds). -> the line's fields."""
    name = torch.cuda.get_device_name(0)
    apps = pr_compute_apps()
    osds = {f"osd.{i}": c.procs[f"osd.{i}"].pid for i in range(c.n_osds)}
    status = {n: await c.asok(n, "device status") for n in osds}
    for n, st in status.items():
        check(st["pid"] == osds[n] and st["cuda_initialized"]
              and st.get("name") == name,
              f"proc: {n} holds no CUDA context on {name}: {st}")
    listed = [n for n, pid in osds.items() if pid in apps]
    if any(pid in apps for pid in osds.values()):
        check(len(listed) == len(osds),
              f"proc: {sorted(set(osds) - set(listed))} missing from the "
              f"compute apps {apps}")
    return {"compute_apps": {str(pid): mem for pid, mem in apps.items()},
            "osd_pids_in_compute_apps": len(listed),
            "osd_memory_reserved": {n: st["memory_reserved"]
                                    for n, st in status.items()},
            "card_free_bytes": min(st["device_free"]
                                   for st in status.values())}


async def pr_quorum(client, n: int, timeout: float) -> list:
    """Poll ``quorum_status`` until ``n`` ranks sit in the quorum (the
    reference's ``wait_quorum``); -> the quorum. Each poll waits at most
    the client's op timeout for its reply."""
    deadline = time.perf_counter() + timeout
    while True:
        try:
            _, _, outb = await client.mon_command(["quorum_status"])
            quorum = json.loads(outb)["quorum"]
            if len(quorum) == n:
                return quorum
        except (IOError, asyncio.TimeoutError):
            pass
        check(time.perf_counter() < deadline,
              f"proc: no quorum of {n} within {timeout} s")
        await asyncio.sleep(0.1)


async def pr_active(c, timeout: float) -> None:
    """ProcCluster.wait_active, failing with what each OSD last reported
    (map epoch, PG states, report age) against the client's map."""
    try:
        await c.wait_active(timeout)
    except asyncio.TimeoutError:
        m = c.client.osdmap
        now = time.time()
        seen = {i: {"epoch": r["epoch"], "pgs": r["pgs"],
                    "age_s": round(now - r["ts"], 2)}
                for i, r in sorted(c.reports.items())}
        for log in sorted(Path(c.data_dir).glob("*.log")):
            tail = log.read_text(errors="replace").splitlines()[-40:]
            if tail:
                print(f"--- {log.name}", *tail, sep="\n", file=sys.stderr)
        raise RuntimeError(
            f"proc: not active within {timeout} s: map epoch "
            f"{m.epoch if m else None}, up "
            f"{[i for i, o in enumerate(m.osds) if o.up] if m else None}, "
            f"pg_temp {len(m.pg_temp) if m else None}, reports "
            f"{seen}") from None


async def pr_clean(c, timeout: float) -> None:
    """active+clean over processes: every live OSD reports every PG
    active on the current epoch and the map pins no pg_temp."""
    deadline = time.perf_counter() + timeout
    while True:
        await pr_active(c, max(1.0, deadline - time.perf_counter()))
        await c._refresh_map()
        if not c.client.osdmap.pg_temp:
            await pr_active(c, max(1.0, deadline - time.perf_counter()))
            return
        check(time.perf_counter() < deadline, "proc: pg_temp never cleared")
        await asyncio.sleep(0.1)


def pr_startup(c) -> dict:
    """Start-up seconds by role: median and max of each part over the
    role's daemons (import of torch and the port, CUDA context, kernel
    load), as the daemons wrote them."""
    by_role: dict[str, dict[str, list]] = {}
    for name, rec in c.startup().items():
        role = by_role.setdefault(rec["role"], {})
        for part in ("import_s", "cuda_context_s", "kernel_load_s"):
            if rec.get(part) is not None:
                role.setdefault(part, []).append(rec[part])
    return {role: {part: {"median": statistics.median(v), "max": max(v),
                          "n": len(v)} for part, v in parts.items()}
            for role, parts in by_role.items()}


def pr_host(c) -> dict:
    """The daemons' CPU seconds (live and exited) and resident bytes."""
    pids = [p.pid for p in c.procs.values()
            if p is not None and p.poll() is None]
    rss = [pr_rss_bytes(pid) for pid in pids]
    return {"daemon_cpu_s": c.cpu_seconds(), "daemons": len(pids),
            "daemon_rss_bytes": sum(rss), "daemon_rss_max_bytes": max(rss),
            "launcher_rss_bytes": pr_rss_bytes(os.getpid())}


def pr_scan(data_dir: str, osds: list[int], su: int) -> dict:
    """Mount the WalStores of ``osds`` (after the stop) with the port's
    store: every EC shard stored there (strays of a re-placement too)
    must carry hash_info CRCs equal to the C++ core's CRC32C of its
    cells. -> {"held": [[osd, cid, oid hex], ...], "stored", "cells"}."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch import store as store_mod
    from ceph_tpu_torch.cluster.pg import ATTR_HINFO, META_OID
    from ceph_tpu_torch.cluster.stripe import dec_hinfo

    held, cells = [], 0
    for i in osds:
        st = store_mod.create("walstore", f"{data_dir}/osd.{i}")
        try:
            for cid in st.list_collections():
                if not cid.startswith(f"{CL_EC_POOL}."):
                    continue
                for oid in st.list_objects(cid):
                    if oid == META_OID:
                        continue
                    data = np.frombuffer(st.read(cid, oid), np.uint8)
                    want = dec_hinfo(st.getattr(cid, oid, ATTR_HINFO))
                    got = native.crc32c_batch(data.reshape(-1, su))
                    check(np.array_equal(got, want),
                          f"proc: osd.{i} {cid}/{oid!r} hash_info differs "
                          "from the C++ core's CRC of its bytes")
                    held.append([i, cid, oid.hex()])
                    cells += len(got)
        finally:
            st.umount()
    return {"held": held, "stored": len(held), "cells": cells}


def pr_shards(data_dir: str, placed: dict, su: int, workers: int) -> dict:
    """Every OSD's WalStore checked by ``pr_scan`` after the stop, in the
    launcher or, with ``workers`` > 1, the OSDs split over that many fresh
    interpreters (a mount replays the store's WAL in Python); then each
    EC shard that the final map places on an OSD must be among those it
    holds."""
    if workers > 1:
        code = ("import json, sys, chip_smoke; print(json.dumps("
                "chip_smoke.pr_scan(sys.argv[1], json.loads(sys.argv[2]), "
                "int(sys.argv[3]))))")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, data_dir,
             json.dumps(list(range(PR_OSDS))[w::workers]), str(su)],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for w in range(workers)]
        results = []
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0,
                  f"proc shard scan failed:\n{err[-4000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    else:
        results = [pr_scan(data_dir, list(range(PR_OSDS)), su)]
    held, stored, cells = set(), 0, 0
    for res in results:
        held.update((i, cid, oid) for i, cid, oid in res["held"])
        stored += res["stored"]
        cells += res["cells"]
    placed_n = 0
    for name, ((pool, ps), acting) in placed.items():
        for shard, osd in enumerate(acting):
            check((osd, f"{pool}.{ps}s{shard}", name.encode().hex()) in held,
                  f"proc: shard {shard} of {name} missing on osd.{osd}")
            placed_n += 1
    return {"placed_shards": placed_n, "stored_shards": stored,
            "cells_crc_checked": cells}


async def pr_cluster(data_dir: str, backend: str, device, card: str,
                     rng, objects: int, rep_objects: int,
                     degraded_writes: int, chaos: bool,
                     scan_workers: int = PR_SCAN_WORKERS,
                     mds_arm: bool = False) -> dict:
    """One ProcCluster of the proc phase (see the PR_* constants) on one
    event loop: start, pools, writes and a read-back; with ``chaos`` the
    kill, degraded read and writes, revival and recovery, the leader
    mon's kill, a pool created after the failover and a last read; with
    ``mds_arm`` then phase mds's process arm (``mp_arm``). The start and
    write lines print the daemons' memory by role (``pr_memory``) and
    the host's MemAvailable before the start. After the stop every EC
    shard is checked on disk (``pr_shards``)."""
    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.cluster.procstart import ProcCluster
    from ceph_tpu_torch.placement.osdmap import Pool

    c = ProcCluster(data_dir, n_osds=PR_OSDS, n_mons=PR_MONS,
                    backend=backend, spawn_timeout=PR_SPAWN_TIMEOUT_S,
                    osd_conf={"osd_ec_cold_shape_bytes":
                              CL_COLD_SHAPE_BYTES,
                              "walstore_compact_bytes":
                              PR_WAL_COMPACT_BYTES}, device=device)
    steps = PrSteps(c, card, backend)
    out = {"steps": steps}
    before = mem_available()
    t0 = time.perf_counter()
    try:
        await c.start()
        start_s = time.perf_counter() - t0
        c.client.op_timeout = PR_OP_TIMEOUT_S
        quorum = await pr_quorum(c.client, PR_MONS, PR_QUORUM_TIMEOUT_S)
        await steps.start()
        await c.client.create_pool(Pool(
            id=CL_REP_POOL, name="rbd", size=3, min_size=2,
            pg_num=CL_PG_NUM, crush_rule=0))
        await c.client.create_pool(Pool(
            id=CL_EC_POOL, name="rbd_data", size=11, min_size=8,
            pg_num=CL_PG_NUM, crush_rule=1, type="erasure",
            ec_profile=dict(CL_EC_PROFILE)))
        await pr_active(c, PR_CLEAN_TIMEOUT_S)
        warmed = await c.client._placement.prewarm(
            c.client.osdmap, [CL_REP_POOL, CL_EC_POOL])
        check(warmed == 2 * CL_PG_NUM, f"proc prewarm {warmed}")
        await steps.mark("start", start_s=start_s, quorum=quorum,
                         startup=pr_startup(c), prewarmed_pgids=warmed,
                         **pr_host(c), memory=pr_memory(c),
                         MemAvailable_before_start_bytes=before[
                             "MemAvailable_bytes"])

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

        def nbytes():
            return sum(len(d) for d in model.values())

        res = await cl_ops(c.client, writes(list(model)))
        cl_check(res, f"proc {backend} write")
        extra = {}
        if c.device.type == "cuda":
            extra = await pr_on_card(c)
        memory = pr_memory(c)
        out["fits"] = mp_fits(memory, before)
        line = await steps.mark("write", **cl_traffic(res, nbytes()),
                                **extra, **pr_host(c), memory=memory,
                                mds_fit=out["fits"])
        check(line["ec_batches"] > 0, f"proc {backend} write: no EC batch")
        res = await cl_ops(c.client, reads())
        cl_check(res, f"proc {backend} read")
        await steps.mark("read", **cl_traffic(res, nbytes()))
        if chaos:
            c.kill_osd(PR_KILLED)
            await c.wait_down(PR_KILLED, 60)
            await steps.mark("kill", killed=PR_KILLED)
            res = await cl_ops(c.client, reads())
            cl_check(res, "proc degraded read")
            line = await steps.mark("degraded_read",
                                    **cl_traffic(res, nbytes()))
            check(line["ec_decode_batches"] > 0,
                  "proc degraded read: no decode batch")
            late = [(CL_EC_POOL, f"rbd_data.late.{i:04x}")
                    for i in range(degraded_writes)]
            for key in late:
                model[key] = rng.bytes(CL_OBJECT_BYTES)
            res = await cl_ops(c.client, writes(late))
            cl_check(res, "proc degraded write")
            await steps.mark("degraded_write", **cl_traffic(
                res, len(late) * CL_OBJECT_BYTES))
            t_rec = time.perf_counter()
            await c.revive_osd(PR_KILLED)
            await pr_clean(c, PR_CLEAN_TIMEOUT_S)
            await steps.mark("recovery",
                             recovery_s=time.perf_counter() - t_rec,
                             startup=c.startup()[f"osd.{PR_KILLED}"])
            leader = c.leader_mon_rank()
            t_fail = time.perf_counter()
            c.kill_mon(leader)
            c.client.op_timeout = PR_QUORUM_POLL_S
            quorum = await pr_quorum(c.client, PR_MONS - 1,
                                     PR_QUORUM_TIMEOUT_S)
            quorum_s = time.perf_counter() - t_fail
            new_leader = c.leader_mon_rank()
            check(new_leader != leader,
                  f"proc: mon.{leader} killed and still the leader")
            c.client.op_timeout = PR_FAILOVER_OP_S
            pool = await c.client.create_pool(Pool(
                id=PR_AFTER_FAILOVER_POOL, name="after_failover", size=3,
                min_size=2, pg_num=8, crush_rule=0))
            c.client.op_timeout = PR_OP_TIMEOUT_S
            check(pool == PR_AFTER_FAILOVER_POOL
                  and pool in c.client.osdmap.pools,
                  f"proc: pool created after the failover is {pool}")
            await steps.mark("mon_failover", killed_mon=leader,
                             new_leader=new_leader, quorum=quorum,
                             quorum_s=quorum_s,
                             pool_create_s=time.perf_counter() - t_fail
                             - quorum_s)
            res = await cl_ops(c.client, reads())
            cl_check(res, "proc read after failover")
            await steps.mark("read_after", **cl_traffic(res, nbytes()))
        if mds_arm:
            out["mds"] = await mp_arm(c, card, rng, backend)
        su = ECB_SU
        final = c.client.osdmap
        out["placed"] = {}
        for (pool, name) in model:
            if pool == CL_EC_POOL:
                pgid = final.object_to_pg(pool, name.encode())
                out["placed"][name] = (pgid, list(
                    final.pg_to_up_acting_osds(pgid)[0]))
        out["host"] = pr_host(c)
    finally:
        t_stop = time.perf_counter()
        await c.stop()
        out["stop_s"] = time.perf_counter() - t_stop
    out["shards"] = pr_shards(data_dir, out["placed"], su,
                              scan_workers if chaos else 1)
    return out


def proc_phase(card: str, rng, device=None, objects: int = PR_OBJECTS,
               rep_objects: int = PR_REP_OBJECTS,
               degraded_writes: int = PR_DEGRADED_WRITES,
               tcp_objects: int = PR_TCP_OBJECTS,
               scan_workers: int = PR_SCAN_WORKERS) -> dict:
    """The cluster tier across processes with an RBD deployment's
    traffic (see the PR_* constants): a ProcCluster of 3 mon and 12 OSD
    daemon processes on ``device`` (the card when None, as a user leaves
    it) over shm, every count set to 0 at its start; writes, a read-back,
    kill -9 of an OSD, degraded reads and writes, its revival and
    recovery, kill -9 of the leader mon and a pool created by the new
    quorum, a last read; every EC shard's hash_info against the C++ core
    after the stop. Then a second cluster over TCP writes and reads
    ``tcp_objects``. Where the shm cluster's memory says that two MDS
    daemons more fit (``mp_fits``), phase mds's process arm runs in the
    TCP cluster after its steps. A line per step -> {"lines": by
    transport and step, "launches": the phase's launches by kernel,
    "mds": the process arm's result or None, "mds_fit"}."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_proc-")
    ring_dir = os.path.join(root, "rings")
    os.mkdir(ring_dir)
    saved = {k: os.environ.get(k) for k in ("CEPH_TPU_SHM_DIR",
                                             "CEPH_TPU_SHM_ARENA_BYTES")}
    os.environ["CEPH_TPU_SHM_DIR"] = ring_dir
    os.environ["CEPH_TPU_SHM_ARENA_BYTES"] = str(PR_SHM_ARENA_BYTES)
    lines, launches, mds, fit = {}, None, None, None
    try:
        for backend, n, n_rep, n_late, chaos in (
                ("shm", objects, rep_objects, degraded_writes, True),
                ("tcp", tcp_objects, 0, 0, False)):
            t0 = time.perf_counter()
            d = os.path.join(root, backend)
            os.mkdir(d)
            arm = backend == "tcp" and fit["fits"]
            if backend == "tcp":
                emit({"phase": "mds", "arm": "process", "where":
                      "proc_tcp" if arm else "own_cluster", **fit,
                      "free_share": MP_FREE_SHARE, "card": card})
            out = asyncio.run(pr_cluster(d, backend, device, card, rng, n,
                                         n_rep, n_late, chaos, scan_workers,
                                         mds_arm=arm))
            if backend == "shm":
                fit = out["fits"]
            mds = out.get("mds", mds)
            steps = out["steps"]
            for step, line in steps.lines.items():
                for key in ("ec_decode_cold_host", "ec_batch_failures"):
                    check(line[key] == 0,
                          f"proc {backend} {step}: {key} {line[key]}")
            totals = steps.totals()
            launches = totals if launches is None else {
                k: launches[k] + v for k, v in totals.items()}
            lines[backend] = steps.lines
            emit({"phase": "proc_cluster", "transport": backend,
                  "seconds": time.perf_counter() - t0,
                  "stop_s": out["stop_s"], **out["shards"],
                  "launches": totals,
                  "launches_by_osd": {f"osd.{i}": kl for i, kl in
                                      sorted(steps.by_osd.items())},
                  **out["host"], "card": card})
            shutil.rmtree(d, ignore_errors=True)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "proc_launches", **launches})
    return {"lines": lines, "launches": launches, "mds": mds,
            "mds_fit": fit}


#: Phase mesh: the multi-device data plane (``parallel/``) on a virtual mesh
#: of MESH_SLOTS slots over the one card (``parallel.pin_virtual``): each
#: slot holds its own tensors on the card and the copies between slots are
#: made on the card, so the mesh moves the bytes a mesh of cards moves.
#: The write step at the main path's width over each (stripe, width) shape
#: of MESH_SHAPES; collective repair of the main path's erasure pattern at
#: the widths MESH_REPAIR_WIDTHS, ``allgather`` at B = MAIN_B and
#: ``psum_bits`` at MESH_PSUM_B stripes (its planes take a byte a bit:
#: at B = 256 and width 4 a slot's planes are 4 GiB, 32 GiB for the mesh,
#: and each slot gathers 16 GiB more; at 64 stripes a quarter of that).
MESH_SLOTS = 8
MESH_SHAPES = ((8, 1), (4, 2), (2, 4))
MESH_REPAIR_WIDTHS = (2, 4)
MESH_PSUM_B = 64
#: K6 against its plain version: row counts 1..8 at these word counts, and
#: crc_join over 1..8 segments of these cell lengths in words (not powers
#: of two) for MESH_JOIN_CELLS cells.
K6_EDGE_N = (1, 31, 32, 33, (1 << 20) + 3)
K6_JOIN_WORDS = (1, 3, 37, 1000)
MESH_JOIN_CELLS = (1, 33, 1027)
#: The ECBatcher at the OSD's shapes over the mesh: MESH_ECB_SUBMITS
#: submissions of MESH_ECB_STRIPES stripes of 4 KiB cells, 8 at a time,
#: with MESH_WIDTH and each repair mode, then their degraded reads.
MESH_ECB_SUBMITS, MESH_ECB_STRIPES, MESH_ECB_CONCURRENCY = 64, 16, 8
MESH_WIDTH = 2
#: Phase cluster's deployment with the mesh knobs on: MESH_CL_OBJECTS
#: RBD objects on the EC pool, one OSD killed, every object read degraded.
MESH_CL_OBJECTS, MESH_CL_KILLED = 64, 1
K6_ENTRIES = ("xor_fold", "bit_planes", "plane_parity_pack", "crc_join")
K6_REPLACES = {"xor_fold": "ceph_tpu/parallel/shard_comm.py:88",
               "bit_planes": "ceph_tpu/parallel/shard_comm.py:95",
               "plane_parity_pack": "ceph_tpu/parallel/shard_comm.py:98",
               "crc_join": "ceph_tpu/ops/crc32c.py:158"}


def k6_edge_cases() -> dict:
    """K6's edges: name -> (entry, rows n (segments w for crc_join), words
    a row N (cell words for crc_join))."""
    cases = {}
    for length in K6_EDGE_N:
        cases[f"bit_planes_N{length}"] = ("bit_planes", 1, length)
        for n in range(1, MESH_SLOTS + 1):
            cases[f"xor_fold_n{n}_N{length}"] = ("xor_fold", n, length)
            cases[f"plane_parity_pack_n{n}_N{length}"] = (
                "plane_parity_pack", n, length)
    for w in range(1, MESH_SLOTS + 1):
        for words in K6_JOIN_WORDS:
            cases[f"crc_join_w{w}_W{w * words}"] = ("crc_join", w, w * words)
    return cases


def k6_case(entry: str, n: int, length: int, rng, dev):
    """One K6 edge case on ``dev``: (the entry's result, its plain
    version's) on the same random inputs."""
    from ceph_tpu_torch.device import words_to_tensor
    from ceph_tpu_torch.ops import crc32c as crc_ops
    from ceph_tpu_torch.ops import xor_combine

    def words(shape):
        return words_to_tensor(rng.integers(0, 2**32, shape,
                                            dtype=np.uint32), dev)

    if entry == "xor_fold":
        x = words((n, length))
        return xor_combine.xor_fold(x), xor_combine.xor_fold_plain(x)
    if entry == "bit_planes":
        x = words((length,))
        return xor_combine.bit_planes(x), xor_combine.bit_planes_plain(x)
    if entry == "plane_parity_pack":
        planes = xor_combine.bit_planes_plain(words((n, length))) \
            .transpose(0, 1).contiguous()
        return (xor_combine.plane_parity_pack(planes),
                xor_combine.plane_parity_pack_plain(planes))
    cells = MESH_JOIN_CELLS[length % len(MESH_JOIN_CELLS)]
    parts = words((n, cells))
    zcols = crc_ops.segment_shift_columns(length, n)
    seed = crc_ops.zeros_shift(crc_ops.CRC_SEED, 4 * length)
    return (xor_combine.crc_join(parts, zcols, seed),
            xor_combine.crc_join_plain(parts, zcols, seed))


def k6_bytes(entry: str, n: int, length: int) -> int:
    """Bytes a K6 entry must move: each input read once, each output
    written once (planes one byte an element)."""
    return {"xor_fold": 4 * length * (n + 1),
            "bit_planes": 4 * length + 32 * length,
            "plane_parity_pack": 32 * length * n + 4 * length,
            "crc_join": 4 * length * (n + 1)}[entry]


def mesh_sharded_equal(arr, want: torch.Tensor) -> bool:
    """Every slot's piece of a sharded result equals the same slice of
    ``want`` (on the card)."""
    return all(torch.equal(s.data, want[s.index]) for s in arr.shards)


def mesh_ecb_knobs(mode: str) -> dict:
    """The mesh knobs of phase mesh's batcher in repair mode ``mode``."""
    return {"osd_ec_mesh_devices": MESH_SLOTS,
            "osd_ec_mesh_width": MESH_WIDTH, "parallel_repair_mode": mode}


async def mesh_ecb(dev, cells: np.ndarray, knobs: dict) -> dict:
    """One ECBatcher at the OSD's shapes with ``knobs`` (the mesh's, or
    none for the one-device batcher): every submission of ``cells``
    encoded, MESH_ECB_CONCURRENCY at a time, then each read degraded
    (shards 1 and 6 rebuilt)."""
    from ceph_tpu_torch.cluster import ECBatcher
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.utils import config as cfg
    from ceph_tpu_torch.utils.perf import PerfCounters

    codec = load_codec(dict(MSG_PROFILE), device=dev)
    conf = cfg.proxy()
    conf.apply({"osd_ec_batch_target_stripes": ECB_TARGET,
                "osd_ec_batch_window": ECB_WINDOW,
                "osd_ec_cold_shape_bytes": 0, **knobs})
    perf = PerfCounters("mesh" if knobs else "single")
    ECBatcher.declare_counters(perf)
    b = ECBatcher(perf, conf=conf)
    sem = asyncio.Semaphore(MESH_ECB_CONCURRENCY)

    async def one(call):
        async with sem:
            return await call()

    t0 = time.perf_counter()
    enc = await asyncio.gather(*[one(lambda c=c: b.encode_cells(codec, c))
                                 for c in cells])
    t_enc = time.perf_counter() - t0
    every = [np.concatenate([c, p], axis=1) for c, (p, _) in zip(cells, enc)]
    t0 = time.perf_counter()
    dec = await asyncio.gather(*[one(lambda e=e: b.decode_cells(
        codec, PRESENT, (1, 6), np.ascontiguousarray(e[:, list(PRESENT)])))
        for e in every])
    out = {"enc": enc, "dec": dec, "encode_s": t_enc,
           "decode_s": time.perf_counter() - t0, "perf": b.perf.dump()}
    b.close()
    return out


def mesh_ecb_check(mode: str, cells: np.ndarray, mesh: dict,
                   single: dict) -> None:
    """The mesh batcher's bytes and CRCs equal the one-device batcher's,
    its degraded reads the lost cells, its CRCs the C++ core's."""
    from ceph_tpu_torch import native

    for (pm, cm), (ps, cs) in zip(mesh["enc"], single["enc"]):
        check(np.array_equal(pm, ps) and np.array_equal(cm, cs),
              f"mesh batcher ({mode}) encode differs from one device")
    for c, dm, ds in zip(cells, mesh["dec"], single["dec"]):
        check(np.array_equal(dm, ds) and np.array_equal(dm, c[:, [1, 6]]),
              f"mesh batcher ({mode}) degraded read differs")
    for c, (p, crcs) in zip(cells[:2], mesh["enc"][:2]):
        want = native.crc32c_batch(np.concatenate([c, p], axis=1)
                                   .reshape(-1, ECB_SU))
        check(np.array_equal(crcs.reshape(-1), want),
              f"mesh batcher ({mode}) CRCs differ from the C++ core")


async def mesh_cluster(dev, rng, mode: str) -> dict:
    """Phase cluster's deployment with the mesh knobs on: MESH_CL_OBJECTS
    objects of 4 MiB written to the EC pool and read back, OSD
    MESH_CL_KILLED killed, every object read degraded, exactly."""
    from ceph_tpu_torch.cluster import TestCluster
    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.placement.osdmap import Pool

    c = TestCluster(n_osds=CL_OSDS, out_interval=CL_OUT_INTERVAL, osd_conf={
        "osd_ec_cold_shape_bytes": CL_COLD_SHAPE_BYTES,
        "osd_ec_mesh_devices": MESH_SLOTS, "osd_ec_mesh_width": MESH_WIDTH,
        "parallel_repair_mode": mode}, device=dev)
    out = {}
    await c.start()
    try:
        c.client.op_timeout = CL_OP_TIMEOUT_S
        await c.client.create_pool(Pool(
            id=CL_EC_POOL, name="rbd_data", size=11, min_size=8,
            pg_num=CL_PG_NUM, crush_rule=1, type="erasure",
            ec_profile=dict(CL_EC_PROFILE)))
        await c.wait_active(60)
        model = {f"rbd_data.{i:016x}": rng.bytes(CL_OBJECT_BYTES)
                 for i in range(MESH_CL_OBJECTS)}
        nbytes = len(model) * CL_OBJECT_BYTES
        res = await cl_ops(c.client, [
            (CL_EC_POOL, n, [M.osd_op("writefull", data=d)], None)
            for n, d in model.items()])
        cl_check(res, "mesh write")
        out["write"] = cl_traffic(res, nbytes)
        out["write_host_gathers"] = runtime_stats()["mesh_host_gathers"]
        reads = [(CL_EC_POOL, n, [M.osd_op("read", offset=0, length=-1)], d)
                 for n, d in model.items()]
        res = await cl_ops(c.client, reads)
        cl_check(res, "mesh read")
        out["read"] = cl_traffic(res, nbytes)
        await c.kill_osd(MESH_CL_KILLED)
        await c.wait_down(MESH_CL_KILLED, timeout=30)
        res = await cl_ops(c.client, reads)
        cl_check(res, "mesh degraded read")
        out["degraded_read"] = cl_traffic(res, nbytes)
        out["osd_counters"] = {
            k: sum(o.perf.dump()[k] for o in c.osds if o is not None)
            for k in ("ec_mesh_encode_dispatches", "ec_mesh_decode_dispatches",
                      "ec_decode_cold_host", "ec_batch_failures")}
    finally:
        await c.stop()
    return out


def launches_of(call) -> dict:
    """The kernel launches one ``call()`` makes, by kernel (those it
    launched)."""
    from ceph_tpu_torch import kernels

    before = {k.name: k.launches for k in kernels.KERNELS}
    call()
    return {k.name: k.launches - before[k.name] for k in kernels.KERNELS
            if k.launches > before[k.name]}


def runtime_stats() -> dict:
    from ceph_tpu_torch.parallel import runtime

    return runtime.STATS.dump()


def mesh_phase(dev, rng, card: str, cluster_lines: dict | None = None,
               cluster: bool = True) -> dict:
    """The multi-device data plane on a virtual mesh over the card (see the
    MESH_* constants): K6 against its plain version at its edges; then,
    every count set to 0, the write step over each mesh shape, collective
    repair in both modes, the ECBatcher and phase cluster's deployment
    with the mesh knobs on, and the multi-chip dry run, each held against
    the one-device step (run before the counts are set to 0, so they
    count only the mesh path's own launches); then each mesh step's time beside the one-device
    step's and K6's times at the shapes the path gave it. ->
    {"launches", "timed", "edge_err", "lines"}."""
    from ceph_tpu_torch import kernels, parallel
    from ceph_tpu_torch.models import datapath
    from ceph_tpu_torch.ops import crc32c as crc_ops
    from ceph_tpu_torch.ops import xor_combine
    from ceph_tpu_torch.parallel import runtime, shard_comm
    from ceph_tpu_torch.tools import dryrun_multichip

    parallel.pin_virtual(MESH_SLOTS)
    slots = parallel.get_devices(MESH_SLOTS, dev)
    virtual = len({str(s.device) for s in slots}) < len(slots)
    emit({"phase": "mesh", "step": "mesh", "slots": MESH_SLOTS,
          "virtual": virtual, "cards": torch.cuda.device_count(),
          "device": str(dev), "card": card,
          "note": (f"a virtual mesh of {MESH_SLOTS} slots over one card"
                   if virtual else f"{MESH_SLOTS} cards")})
    lines = {}

    # ---- K6 against its plain version at its edges
    edge_err = 0
    cases = k6_edge_cases()
    for label, (entry, n, length) in cases.items():
        got, want = k6_case(entry, n, length, rng, dev)
        torch.cuda.synchronize()
        err = max_abs_err(got.to(torch.int32), want.to(torch.int32))
        check(err == 0, f"K6 {label} differs from its plain version by {err}")
        edge_err = max(edge_err, err)
    emit({"phase": "mesh", "step": "k6_vs_plain", "cases": len(cases),
          "max_abs_err": edge_err})

    # ---- the one-device steps the mesh is held against
    params = datapath.ECParams(k=MAIN_K, m=MAIN_M, chunk_bytes=MAIN_CHUNK)
    data = datapath.example_batch(params, batch=MAIN_B, seed=0, device=dev)
    parity, crcs = datapath.write_step(params, data)
    surviving = torch.cat([data, parity], dim=1)[:, list(PRESENT)]
    meshes = {f"{s}x{w}": parallel.make_mesh(slots, width=w)
              for s, w in MESH_SHAPES}
    ecb_cells = rng.integers(0, 256, (MESH_ECB_SUBMITS, MESH_ECB_STRIPES,
                                      MAIN_K, ECB_SU), dtype=np.uint8)
    ecb_single = asyncio.run(mesh_ecb(dev, ecb_cells, {}))
    dry_step = dryrun_multichip.setup(MESH_SLOTS, dev)
    dry_want = dryrun_multichip.one_device(dry_step)
    repair_in = {}
    for w in MESH_REPAIR_WIDTHS:
        mesh = meshes[f"{MESH_SLOTS // w}x{w}"]
        repair_in[("allgather", w)] = parallel.shard_placement(mesh, surviving)
        repair_in[("psum_bits", w)] = parallel.shard_placement(
            mesh, surviving[:MESH_PSUM_B])
    torch.cuda.synchronize()

    # ---- the mesh path, every count at 0
    kernels.reset_counts()
    runtime.STATS.reset()
    t_path = time.perf_counter()
    for key, mesh in meshes.items():
        p, c = runtime.mesh_encode_crc_batch(mesh, params.matrix,
                                             params.chunk_bytes, data)
        check(mesh_sharded_equal(p, parity) and mesh_sharded_equal(c, crcs),
              f"mesh {key} write step differs from the one-device step")
        del p, c
    for (method, w), surv in repair_in.items():
        mesh = surv.mesh
        out = shard_comm.distributed_repair(mesh, params.matrix, MAIN_K,
                                            list(PRESENT), surv, method)
        runtime.finish(mesh)
        check(mesh_sharded_equal(out, data[:surv.shape[0]]),
              f"collective repair {method} width {w} differs from "
              "repair_step")
        del out
    ecb = {mode: asyncio.run(mesh_ecb(dev, ecb_cells, mesh_ecb_knobs(mode)))
           for mode in shard_comm.METHODS}
    for mode, res in ecb.items():
        mesh_ecb_check(mode, ecb_cells, res, ecb_single)
        d = res["perf"]
        check(d["ec_mesh_encode_dispatches"] > 0
              and d["ec_mesh_decode_dispatches"] > 0,
              f"mesh batcher ({mode}) dispatches {d}")
        lines[f"ecbatch_{mode}"] = line = {
            "phase": "mesh", "step": f"ecbatch_{mode}",
            "submissions": MESH_ECB_SUBMITS, "stripes": MESH_ECB_STRIPES,
            **{k: d[k] for k in ("ec_batches", "ec_decode_batches",
                                 "ec_mesh_encode_dispatches",
                                 "ec_mesh_decode_dispatches")},
            "encode_GiB_per_s": {
                k: MESH_ECB_SUBMITS * MESH_ECB_STRIPES * MAIN_K * ECB_SU
                / 2**30 / r["encode_s"] for k, r in (("mesh", res),
                                                    ("single", ecb_single))},
            "decode_s": {"mesh": res["decode_s"],
                         "single": ecb_single["decode_s"]},
            "card": card}
        emit(line)
    del ecb, ecb_single
    gathers = runtime_stats()["mesh_host_gathers"]
    check(gathers == 0, f"the mesh batcher gathered {gathers} times")
    if cluster:
        cl = asyncio.run(mesh_cluster(dev, rng, "allgather"))
        stats = runtime_stats()
        check(cl["write_host_gathers"] == 0 and stats["mesh_host_gathers"] == 0,
              f"mesh cluster host gathers {stats['mesh_host_gathers']}")
        check(stats["mesh_encode_dispatches"] > 0
              and stats["mesh_decode_dispatches"] > 0,
              f"mesh cluster dispatches {stats}")
        check(cl["osd_counters"]["ec_batch_failures"] == 0
              and cl["osd_counters"]["ec_decode_cold_host"] == 0,
              f"mesh cluster counters {cl['osd_counters']}")
        base = cluster_lines or {}
        lines["cluster"] = line = {
            "phase": "mesh", "step": "cluster", "objects": MESH_CL_OBJECTS,
            "killed": MESH_CL_KILLED, "width": MESH_WIDTH,
            "mode": "allgather", **{k: cl[k] for k in (
                "write", "read", "degraded_read", "osd_counters")},
            "mesh_stats": {k: v for k, v in stats.items()
                           if k != "mesh_stripes_per_device"},
            "phase_cluster": {s: {k: base[s].get(k) for k in (
                "GiB_per_s", "lat_p50_ms", "lat_p99_ms")}
                for s in ("write", "read", "degraded_read") if s in base},
            "card": card}
        emit(line)
    dry = dryrun_multichip.on_mesh(dry_step, dry_want)
    lines["dryrun"] = {"phase": "mesh", "step": "dryrun", **dry, "card": card}
    emit(lines["dryrun"])
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = {k.name: k.launches for k in kernels.KERNELS}
    emit({"phase": "mesh_launches", **launches, "path_s": path_s})
    for name in ("gf_matmul", "crc32c", *K6_ENTRIES):
        check(launches[name] > 0, f"the mesh path launched {name} "
                                  f"{launches[name]} times")

    # ---- times: each mesh step beside the one-device step
    write_ms = time_ms(lambda: datapath.write_step(params, data), reps=5)
    for key, mesh in meshes.items():
        def call(mesh=mesh):
            runtime.mesh_encode_crc_batch(mesh, params.matrix,
                                          params.chunk_bytes, data)
        per_call = launches_of(call)
        ms = time_ms(call, reps=5, warmup=1)
        lines[f"write_{key}"] = line = {
            "phase": "mesh", "step": "write", "mesh": key, "ms": ms,
            "one_device_ms": write_ms, "stripes": MAIN_B,
            "launches_per_call": per_call, "card": card}
        emit(line)
    repair_ms = time_ms(lambda: datapath.repair_step(params, PRESENT,
                                                     surviving), reps=5)
    for (method, w), surv in repair_in.items():
        mesh = surv.mesh

        def call(mesh=mesh, surv=surv, method=method):
            shard_comm.distributed_repair(mesh, params.matrix, MAIN_K,
                                          list(PRESENT), surv, method)
            runtime.finish(mesh)
        per_call = launches_of(call)
        ms = time_ms(call, reps=3, warmup=1)
        one_ms = repair_ms if surv.shape[0] == MAIN_B else time_ms(
            lambda b=surv.shape[0]: datapath.repair_step(
                params, PRESENT, surviving[:b]), reps=5)
        lines[f"repair_{method}_{w}"] = line = {
            "phase": "mesh", "step": "repair", "method": method, "width": w,
            "mesh": f"{MESH_SLOTS // w}x{w}", "stripes": surv.shape[0],
            "ms": ms, "one_device_repair_step_ms": one_ms,
            "launches_per_call": per_call, "card": card}
        emit(line)
    del repair_in

    # ---- K6 alone at the shapes the mesh path gave it
    timed = {}
    w = max(MESH_REPAIR_WIDTHS)
    s = MESH_SLOTS // w
    fold_len = MAIN_B // s * MAIN_K * params.words
    psum_len = MESH_PSUM_B // s * MAIN_K * params.words
    join_len = MAIN_B // s * (MAIN_K + MAIN_M)
    shapes = {"xor_fold": (w, fold_len), "bit_planes": (1, psum_len),
              "plane_parity_pack": (w, psum_len),
              "crc_join": (w, join_len)}
    for entry, (n, length) in shapes.items():
        if entry == "plane_parity_pack":
            planes = torch.randint(0, 2, (n, 32, length), dtype=torch.uint8,
                                   device=dev)
            kernel = lambda planes=planes: xor_combine.plane_parity_pack(planes)
            plain = lambda planes=planes: \
                xor_combine.plane_parity_pack_plain(planes)
        elif entry == "crc_join":
            parts = torch.randint(-2**31, 2**31, (n, length), dtype=torch.int32,
                                  device=dev)
            zcols = crc_ops.segment_shift_columns(params.words, n)
            seed = crc_ops.zeros_shift(crc_ops.CRC_SEED, params.chunk_bytes)
            kernel = lambda parts=parts: xor_combine.crc_join(parts, zcols,
                                                              seed)
            plain = lambda parts=parts: xor_combine.crc_join_plain(
                parts, zcols, seed)
        else:
            x = torch.randint(-2**31, 2**31, (length,) if entry ==
                              "bit_planes" else (n, length),
                              dtype=torch.int32, device=dev)
            fn = getattr(xor_combine, entry)
            pfn = getattr(xor_combine, f"{entry}_plain")
            kernel = lambda x=x, fn=fn: fn(x)
            plain = lambda x=x, pfn=pfn: pfn(x)
        err = max_abs_err(kernel().to(torch.int32), plain().to(torch.int32))
        check(err == 0, f"K6 {entry} at the mesh shape differs by {err}")
        ms, plain_ms = time_ms(kernel, reps=10), time_ms(plain, reps=3,
                                                         warmup=1)
        b_ms, b_by = bound(k6_bytes(entry, n, length), 0)
        prof = profile_steps(kernel)
        timed[f"k6_{entry}"] = {"ms": ms, "plain_ms": plain_ms,
                                "bound_ms": b_ms, "bound_by": b_by,
                                "max_abs_err": err,
                                "device_ms": device_ms(prof), "n": n,
                                "words": length}
        emit({"phase": "time", "what": f"k6_{entry}",
              **timed[f"k6_{entry}"],
              "share_of_bound": b_ms / ms,
              "profile": {k: prof[k] for k in PROFILE_CLOCK}, "card": card})

    # ---- K1 and K2 alone at one slot's share of the 2 x 4 mesh: the
    # repair's column block on its resident survivors, the write step's
    # word segment and the CRCs of its cells' segments
    from ceph_tpu_torch.device import words_to_tensor
    from ceph_tpu_torch.ops import gf8, rs

    bs, ws = MAIN_B // s, params.words // w

    def words(shape):
        return words_to_tensor(rng.integers(0, 2**32, shape,
                                            dtype=np.uint32), dev)

    rblock = rs.column_blocks(
        gf8.decode_matrix(params.matrix, MAIN_K, list(PRESENT)), w)[0]
    surv = words((bs, MAIN_K // w, params.words))
    seg, pseg = words((bs, MAIN_K, ws)), words((bs, MAIN_M, ws))
    cells = torch.cat([seg, pseg], dim=1)
    cases = {
        "gf_mesh_repair": (lambda: rs.gf_matmul(rblock, surv),
                           lambda: rs.gf_matmul_plain(rblock, surv),
                           gf_work(bs, MAIN_K, MAIN_K // w, params.words)),
        "gf_mesh_write": (lambda: rs.gf_matmul(params.matrix, seg),
                          lambda: rs.gf_matmul_plain(params.matrix, seg),
                          gf_work(bs, MAIN_M, MAIN_K, ws)),
        "crc_mesh_write": (lambda: crc_ops.crc0_cells(seg, pseg),
                           lambda: crc_ops.crc0_words_plain(cells),
                           crc_work(bs * (MAIN_K + MAIN_M), ws))}
    for key, (kernel, plain, (nbytes, ops)) in cases.items():
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"{key}: kernel and plain differ by {err}")
        ms, plain_ms = time_ms(kernel, reps=10), time_ms(plain, reps=3,
                                                         warmup=1)
        b_ms, b_by = bound(nbytes, ops)
        prof = profile_steps(kernel)
        timed[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err,
                      "device_ms": device_ms(prof)}
        emit({"phase": "time", "what": key, **timed[key],
              "share_of_bound": b_ms / ms,
              "profile": {k: prof[k] for k in PROFILE_CLOCK}, "card": card})
    return {"launches": launches, "timed": timed, "edge_err": edge_err,
            "lines": lines}


#: Phase mds, in-process arm: the CephFS metadata daemon
#: (``services/mds.py``) on phase services' deployment (CL_OSDS OSDs, the
#: CL_EC_PROFILE pool with its 4 KiB stripe unit and a replicated size-3
#: pool, CL_PG_NUM PGs each, the cold-shape shield off): ``FSLite.mkfs``
#: with the metadata on the replicated pool, MDS ranks 0 and 1 with the
#: file data on the EC pool, and two FSClients, the second with the
#: ObjectCacher (``cache=True``). ``tree``: ``dirs`` directories, the last
#: ``pinned`` of them pinned to rank 1, then ``files`` files of
#: ``file_bytes`` created by the two clients in turn, each client listing
#: what the other made, then (both clients' files closed) reading it;
#: ``caps``: ``caps_files`` more files by the cached client read by the
#: other while their caps are held; ``race``: ``race_files`` creates on
#: each rank at once (the inode numbers handed out twice are counted);
#: ``data``: ``data_bytes`` in
#: MD_IO_BYTES writes over ``data_files`` files (each file's writes in
#: order: a write that extends a file reads and writes back the striper's
#: size object), both clients writing at once, read back at queue depth
#: MD_QD; ``overwrites``: aligned 4 KiB overwrites of one file at MD_QD
#: (none extends it, so FSClient takes them in flight together);
#: ``rename``: ``renames`` cross-subtree renames, rank 0 to 1 and back;
#: ``snap``, ``quota``, ``crash`` (rank 0 dies mid-rename, a new rank 0
#: replays its journal) and ``degraded`` (OSD MD_KILLED down, the data
#: read back). The MDSs keep their 2 s revoke timeout.
MD_FULL = {"dirs": 8, "pinned": 2, "files": 256, "file_bytes": 64 << 10,
           "caps_files": 128, "race_files": 128, "data_bytes": 1 << 30,
           "data_files": 4, "overwrites": 1024, "renames": 64}
#: Counts cut to keep the phase inside MD_BUDGET_S: only those that launch
#: no EC kernel of their own (``tree``'s files, ``rename``) may be cut. At
#: MD_FULL the drive took 97.1 s on the H100's host (tree 11.7, caps 7.7,
#: race 4.0, data 28.2, overwrites 24.3, degraded 14.2): ``files`` at
#: half. ``caps`` and ``race`` keep their counts: below 128 files the
#: caps step's evictions (ROADMAP §3 item 11) no longer show.
MD_CUTS: dict = {"files": 128}
MD_SIZES = {**MD_FULL, **MD_CUTS}
MD_IO_BYTES, MD_QD, MD_KILLED = 4 << 20, 16, 1
MD_QUOTA_BYTES = 1 << 20
MD_BUDGET_S, MD_TIMEOUT_S = 90.0, 600.0
#: The batches K1 and K2 are timed at alone after the phase: the data
#: step's mean encode batch and the degraded step's mean decode batch.
MD_TIMED = {"mds_data_wb": ("data", "encode", ("write", "crc")),
            "mds_rb": ("degraded", "decode", ("decode",))}

#: Phase mds, process arm: MDS ranks 0 and 1 as daemon processes
#: (``ProcCluster.start_mds``) with the metadata on the replicated pool and
#: the data on the EC pool; the schedule of tests/test_multiprocess.py's
#: two MDS cases at MP_FILES files of MP_FILE_BYTES: written and read back
#: exactly, kill -9 of rank 0 between two ops, its revival and the
#: namespace back, a subtree pinned to rank 1 and a cross-subtree rename
#: both ways. The clients' timeout outlasts a revival (an OSD daemon took
#: 13-20 s to start on the H100's host; the reference's test uses 30 s). Where the daemons
#: fit, the arm runs in phase proc's TCP cluster after its steps: 17
#: daemons must leave MP_FREE_SHARE of the host's memory free, judged from
#: the MemAvailable drop phase proc's shm cluster measured. Else a
#: ProcCluster of its own: 1 mon, MP_OSDS OSDs (EC 8+3's minimum) and the
#: two MDS daemons.
MP_FILES, MP_FILE_BYTES, MP_QD = 64, 4 << 20, 16
MP_CLIENT_TIMEOUT_S, MP_FREE_SHARE, MP_OSDS = 60.0, 0.10, 11
MP_DOWN_PROBE_S = 3.0


class MdSteps(ClSteps):
    """ClSteps of phase mds, with the caps ledger: the revokes the clients
    received and the releases that reached an MDS after it had stopped
    waiting for them (a live client evicted by the revoke timeout). Made
    before the MDSs start, which register their bound ``handle``."""

    def __init__(self, card: str):
        from ceph_tpu_torch.cluster import messages as M
        from ceph_tpu_torch.services.mds import FSClient, MDSLite

        super().__init__(card, phase="mds")
        self.caps = {"revokes": 0, "late_releases": 0}
        self._caps0 = dict(self.caps)
        handle, client_handle = MDSLite.handle, FSClient._handle

        async def mds_handle(mds, src, msg):
            if isinstance(msg, M.MCapRelease):
                fut = mds._revokes.get((msg.ino, msg.tid))
                if fut is None or fut.done():
                    self.caps["late_releases"] += 1
            return await handle(mds, src, msg)

        async def fsclient_handle(cl, src, msg):
            if isinstance(msg, M.MCapRevoke):
                self.caps["revokes"] += 1
            return await client_handle(cl, src, msg)
        self._real += [(MDSLite, "handle", handle),
                       (FSClient, "_handle", client_handle)]
        MDSLite.handle = mds_handle
        FSClient._handle = fsclient_handle

    def start(self) -> None:
        super().start()
        self._caps0 = dict(self.caps)

    def mark(self, step: str, **extra) -> dict:
        caps = {k: v - self._caps0[k] for k, v in self.caps.items()}
        self._caps0 = dict(self.caps)
        return super().mark(step, caps=caps, **extra)


async def md_read_all(cl, models: dict, io: int) -> dict:
    """Read every file of ``models`` back through ``cl`` in ``io``-byte
    requests, MD_QD in flight -> ``sv_run``'s result, each result whether
    the read equals the model."""
    async def one(p, off):
        want = models[p][off:off + io]
        return await cl.read(p, off, len(want)) == want
    return await sv_run([lambda p=p, o=o: one(p, o) for p in models
                         for o in range(0, len(models[p]), io)], MD_QD)


async def md_tree(steps: MdSteps, st: dict, rng, sz: dict) -> None:
    """Step ``tree``: directories on both ranks, files by both clients in
    turn, each client listing what the other made; then both clients
    close their files (caps and cached data flushed) and each reads what
    the other made."""
    a, b = st["a"], st["b"]
    dirs = [f"/d{j}" for j in range(sz["dirs"])]
    pinned = dirs[len(dirs) - sz["pinned"]:]
    t0 = time.perf_counter()
    for d in dirs:
        await a.mkdir(d)
    for d in pinned:
        await a.set_subtree_pin(d, 1)
    mkdir_s = time.perf_counter() - t0
    files = {f"{dirs[i % len(dirs)]}/f{i:04d}": rng.bytes(sz["file_bytes"])
             for i in range(sz["files"])}
    by = {p: (a, b)[i % 2] for i, p in enumerate(files)}

    async def create(p):
        await by[p].create(p)
        await by[p].write(p, files[p])
    res = await sv_run([lambda p=p: create(p) for p in files], 1)
    create_t = sv_traffic(res, sum(map(len, files.values())))
    t0 = time.perf_counter()
    for d in dirs:
        want = sorted(p.rsplit("/", 1)[1] for p in files
                      if p.startswith(d + "/"))
        for cl in (a, b):
            got = sorted(await cl.listdir(d))
            check(got == want, f"mds tree: {cl.name} lists {d} as "
                               f"{got[:4]}... not {want[:4]}...")
    list_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for cl in (a, b):
        await cl.close()
        await cl.connect()
    close_s = time.perf_counter() - t0

    async def read_other(p):
        other = b if by[p] is a else a
        return await other.read(p) == files[p]
    res = await sv_run([lambda p=p: read_other(p) for p in files], MD_QD)
    sv_reads_equal(res, "mds tree read of the other client's files")
    st.update(dirs=dirs, pinned=pinned, files=files)
    steps.mark("tree", dirs=len(dirs), pinned=pinned, mkdir_pin_s=mkdir_s,
               create=create_t, list_s=list_s, close_s=close_s,
               read=sv_traffic(res, sum(map(len, files.values()))))


async def md_caps(steps: MdSteps, st: dict, rng, sz: dict) -> None:
    """Step ``caps``: the cached client writes ``caps_files`` files (its
    write caps held, its data in the ObjectCacher), then the other reads
    them all at MD_QD while it holds them. Each read recalls a cap; the
    first recall flushes the holder's whole cache, and a recall that
    waits past the MDS's 2 s revoke timeout evicts the live holder: the
    MDS drops its buffered size and the reader sees the file as short as
    the MDS knew it (ROADMAP §3). Recorded, not hidden: every read must be
    the written bytes or a prefix of them, and a short read only where a
    release came late."""
    a, b = st["a"], st["b"]
    await b.mkdir("/live")
    files = {f"/live/f{i:04d}": rng.bytes(sz["file_bytes"])
             for i in range(sz["caps_files"])}
    for p, data in files.items():
        await b.create(p)
        await b.write(p, data)
    late0 = steps.caps["late_releases"]

    async def read(p):
        return await a.read(p)
    res = await sv_run([lambda p=p: read(p) for p in files], MD_QD)
    got = dict(zip(files, res["results"]))
    short = [p for p, g in got.items() if g != files[p]]
    check(all(files[p].startswith(got[p]) for p in short),
          "mds caps: a read returned bytes that were never written")
    late = steps.caps["late_releases"] - late0
    check(not short or late > 0,
          f"mds caps: {len(short)} short reads with no late release")
    await b.close()
    await b.connect()
    steps.mark("caps", files=len(files), qd=MD_QD,
               revoke_timeout_s=st["ranks"][0].revoke_timeout,
               reads_exact=len(files) - len(short), reads_short=len(short),
               short_lengths=sorted({len(got[p]) for p in short}),
               read=sv_traffic(res, sum(map(len, got.values()))))


async def md_race(steps: MdSteps, st: dict, sz: dict) -> None:
    """Step ``race``: both clients create files at once, one in a rank-0
    directory and the other in a rank-1 one. The ranks share one inode
    counter (``fsmeta.nextino``) that each reads and then writes back, so
    two creates at once can take one inode number (ROADMAP §3 item 12):
    the two files then share their data objects. Recorded, not hidden:
    the step counts the inode numbers handed out twice."""
    a, b = st["a"], st["b"]
    dirs = {"/race0": (a, 0), "/race1": (b, 1)}
    for d, (cl, rank) in dirs.items():
        await a.mkdir(d)
        if rank:
            await a.set_subtree_pin(d, rank)
        await cl.listdir(d)  # the client learns the directory's rank
    n = sz["race_files"]
    paths = [(cl, f"{d}/f{i:04d}") for i in range(n)
             for d, (cl, _) in dirs.items()]
    t0 = time.perf_counter()
    await asyncio.gather(*(cl.create(p) for cl, p in paths))
    create_s = time.perf_counter() - t0
    inos = [(await a.stat(p))["ino"] for _, p in paths]
    twice = len(inos) - len(set(inos))
    steps.mark("race", creates=len(paths), create_s=create_s,
               inos_handed_out_twice=twice)


async def md_data(steps: MdSteps, st: dict, rng, sz: dict) -> None:
    """Step ``data``: both clients write at once, each file's writes in
    order; then everything read back at MD_QD."""
    a, b = st["a"], st["b"]
    io, n = MD_IO_BYTES, sz["data_files"]
    per = sz["data_bytes"] // n
    await a.mkdir("/data")
    models = {f"/data/file{i}": bytearray(rng.bytes(per)) for i in range(n)}
    by = {p: (a, b)[i % 2] for i, p in enumerate(models)}
    lat = []

    async def write_file(p):
        cl = by[p]
        for off in range(0, per, io):
            t = time.perf_counter()
            await cl.write(p, bytes(models[p][off:off + io]), off)
            lat.append(time.perf_counter() - t)
        # data lands (b's cache flushed) and the size reaches the MDS
        await cl._flush(cl._paths[p])
    t0 = time.perf_counter()
    await asyncio.gather(*(write_file(p) for p in models))
    write = sv_traffic({"lat_s": lat, "wall_s": time.perf_counter() - t0},
                       sz["data_bytes"])
    for p in models:
        size = (await a.stat(p))["size"]
        check(size == per, f"mds data: {p} size {size}, wrote {per}")
    res = await md_read_all(a, models, io)
    sv_reads_equal(res, "mds data read")
    st["models"] = models
    steps.mark("data", files=n, writers_in_flight=n, write=write,
               read_qd=MD_QD, read=sv_traffic(res, sz["data_bytes"]))


async def md_overwrites(steps: MdSteps, st: dict, rng, sz: dict) -> None:
    """Step ``overwrites``: aligned 4 KiB overwrites of one data file by
    the client without a cache, MD_QD in flight; the other client reads
    the file back."""
    a, b = st["a"], st["b"]
    p = "/data/file0"
    model = st["models"][p]
    offs = sv_blocks(rng, len(model), sz["overwrites"])
    patches = [rng.bytes(SV_OVERWRITE_BYTES) for _ in offs]
    for off, patch in zip(offs, patches):
        model[off:off + SV_OVERWRITE_BYTES] = patch
    res = await sv_run([lambda o=o, q=q: a.write(p, q, o)
                        for o, q in zip(offs, patches)], MD_QD)
    overwrite = sv_traffic(res, len(offs) * SV_OVERWRITE_BYTES)
    res = await md_read_all(b, {p: model}, MD_IO_BYTES)
    sv_reads_equal(res, "mds overwrites read-back")
    steps.mark("overwrites", depth=MD_QD,
               depth_why="aligned overwrites inside the file: none moves "
                         "its size, so FSClient.write under the held write "
                         "cap is client-side only",
               overwrite=overwrite, read=sv_traffic(res, len(model)))


async def md_rename(steps: MdSteps, st: dict, sz: dict) -> None:
    """Step ``rename``: files of a rank-0 directory renamed into a
    directory pinned to rank 1 and back (the peer-request path)."""
    a, b, files = st["a"], st["b"], st["files"]
    src, dst = st["dirs"][0], st["pinned"][-1]
    names = sorted(p.rsplit("/", 1)[1] for p in files
                   if p.startswith(src + "/"))
    moved = names[:sz["renames"] // 2]
    lat = []

    async def rename(frm, to):
        t = time.perf_counter()
        await a.rename(frm, to)
        lat.append(time.perf_counter() - t)
    t0 = time.perf_counter()
    for n in moved:
        await rename(f"{src}/{n}", f"{dst}/moved-{n}")
    there = set(await b.listdir(dst))
    check(all(f"moved-{n}" in there for n in moved),
          "mds rename: rank 1's directory lacks the moved files")
    check(await b.read(f"{dst}/moved-{moved[0]}")
          == files[f"{src}/{moved[0]}"], "mds rename: moved file's bytes")
    for n in moved:
        await rename(f"{dst}/moved-{n}", f"{src}/{n}")
    wall = time.perf_counter() - t0
    check(sorted(await b.listdir(src)) == names,
          "mds rename: the round trip changed the listing")
    steps.mark("rename", renames=len(lat), from_rank=0, to_rank=1,
               **sv_traffic({"lat_s": lat, "wall_s": wall}, 0))


async def md_snap(steps: MdSteps, st: dict, rng) -> None:
    """Step ``snap``: a snapshot of a directory, a mutation (an overwrite
    by the other client and a new file), the snapshot read back."""
    a, b, files = st["a"], st["b"], st["files"]
    d = st["dirs"][1]
    before = sorted(await a.listdir(d))
    t0 = time.perf_counter()
    snapid = await a.mksnap(d, "mds-phase")
    mksnap_s = time.perf_counter() - t0
    victim = f"{d}/{before[0]}"
    old = files[victim]
    patch = rng.bytes(4096)
    await b.write(victim, patch, 0)
    files[victim] = patch + old[4096:]
    await a.create(f"{d}/after-snap")
    await a.write(f"{d}/after-snap", b"after the snapshot")
    check(sorted(await a.snap_listdir(d, "mds-phase")) == before,
          "mds snap: the snapshot's listing moved")
    t0 = time.perf_counter()
    res = await sv_run([lambda n=n: a.snap_read(d, "mds-phase", n)
                        for n in before], MD_QD)
    snap_read_s = time.perf_counter() - t0
    want = [old if f"{d}/{n}" == victim else files[f"{d}/{n}"]
            for n in before]
    check(res["results"] == want, "mds snap: snapshot bytes differ")
    check(await a.read(victim) == files[victim], "mds snap: live bytes")
    steps.mark("snap", snapid=snapid, mksnap_s=mksnap_s,
               snap_files=len(before), snap_read_s=snap_read_s)


async def md_quota(steps: MdSteps, st: dict) -> None:
    """Step ``quota``: a bytes quota refuses the write past it."""
    from ceph_tpu_torch.services.fs import QuotaExceeded

    a = st["a"]
    await a.mkdir("/quota")
    await a.set_quota("/quota", max_bytes=MD_QUOTA_BYTES)
    await a.write("/quota/half", b"q" * (MD_QUOTA_BYTES // 2))
    await a._flush(a._paths["/quota/half"])
    a._quota_cache.clear()
    refused = None
    try:
        await a.write("/quota/over", b"y" * MD_QUOTA_BYTES)
    except QuotaExceeded as e:
        refused = str(e)
    check(refused is not None, "mds quota: the write past it went through")
    st_ = await a.dir_stat("/quota")
    check(st_["rbytes"] == MD_QUOTA_BYTES // 2,
          f"mds quota: rbytes {st_['rbytes']}")
    steps.mark("quota", max_bytes=MD_QUOTA_BYTES, refused=refused,
               dir_stat=st_)


async def md_crash(steps: MdSteps, st: dict, c) -> None:
    """Step ``crash``: rank 0 dies between the two dirfrag updates of a
    rename (``_crash_mid_rename``); a new rank 0 replays its journal and
    the rename completes."""
    from ceph_tpu_torch.services.mds import MDSLite

    a, b, files = st["a"], st["b"], st["files"]
    for cl in (a, b):  # caps and cached data durable before the crash
        await cl.close()
        await cl.connect()
    d0, d1 = st["dirs"][0], st["dirs"][2]
    src = sorted(p for p in files if p.startswith(d0 + "/"))[-1]
    dst = f"{d1}/crashed-{src.rsplit('/', 1)[1]}"
    st["ranks"][0]._crash_mid_rename = True
    failed = None
    try:
        await a.rename(src, dst)
    except Exception as e:  # the daemon died mid-op
        failed = type(e).__name__
    check(failed is not None, "mds crash: the rename did not fail")
    await st["ranks"][0].stop()
    fresh = MDSLite(c.bus, st["ranks"][0].client, CL_REP_POOL, name="mds.0",
                    data_pool=CL_EC_POOL)
    t0 = time.perf_counter()
    await fresh.start()  # journal replay completes the rename
    replay_s = time.perf_counter() - t0
    st["ranks"][0] = fresh
    name = src.rsplit("/", 1)[1]
    check(name not in await b.listdir(d0), "mds crash: source still there")
    check(dst.rsplit("/", 1)[1] in await b.listdir(d1),
          "mds crash: destination missing after replay")
    check(await b.read(dst) == files[src], "mds crash: renamed file bytes")
    files[dst] = files.pop(src)
    steps.mark("crash", client_error=failed, replay_s=replay_s,
               renamed=[src, dst])


async def md_degraded(steps: MdSteps, st: dict, c) -> None:
    """Step ``degraded``: OSD MD_KILLED (it holds EC shards) down, the
    data read back exactly (K1 rebuilds)."""
    from ceph_tpu_torch.cluster.pg import META_OID

    store = c.stores[MD_KILLED]
    held = sum(1 for cid in store.list_collections()
               if cid.startswith(f"{CL_EC_POOL}.")
               for oid in store.list_objects(cid) if oid != META_OID)
    check(held > 0, f"mds: OSD {MD_KILLED} holds no EC shard")
    await c.kill_osd(MD_KILLED)
    await c.wait_down(MD_KILLED, timeout=30)
    models = st["models"]
    res = await md_read_all(st["a"], models, MD_IO_BYTES)
    sv_reads_equal(res, "mds degraded read")
    su = next(o for o in c.osds if o is not None).sinfo_for(
        c.mon.osdmap.pools[CL_EC_POOL]).su
    shards, cells = cl_hinfo_check(c.stores, su, "mds")
    steps.mark("degraded", killed=MD_KILLED, shards_held=held,
               read=sv_traffic(res, sum(map(len, models.values()))),
               shards_crc_checked=shards, cells_crc_checked=cells)


async def md_drive(steps: MdSteps, device, rng, sz: dict) -> None:
    """Phase mds's in-process arm on one event loop."""
    from ceph_tpu_torch.cluster import RadosClient, TestCluster
    from ceph_tpu_torch.placement.osdmap import Pool
    from ceph_tpu_torch.services.fs import FSLite
    from ceph_tpu_torch.services.mds import FSClient, MDSLite

    c = TestCluster(n_osds=CL_OSDS, out_interval=CL_OUT_INTERVAL,
                    osd_conf={"osd_ec_cold_shape_bytes":
                              CL_COLD_SHAPE_BYTES}, device=device)
    steps.cluster = c
    await c.start()
    try:
        steps.start()
        c.client.op_timeout = CL_OP_TIMEOUT_S
        await c.client.create_pool(Pool(
            id=CL_REP_POOL, name="cephfs_metadata", size=3, min_size=2,
            pg_num=CL_PG_NUM, crush_rule=0))
        await c.client.create_pool(Pool(
            id=CL_EC_POOL, name="cephfs_data", size=11, min_size=8,
            pg_num=CL_PG_NUM, crush_rule=1, type="erasure",
            ec_profile=dict(CL_EC_PROFILE)))
        await c.wait_active(60)
        warmed = await c.client._placement.prewarm(
            c.client.osdmap, [CL_REP_POOL, CL_EC_POOL])
        check(warmed == 2 * CL_PG_NUM, f"mds prewarm {warmed}")
        await FSLite(c.client, CL_REP_POOL, data_pool=CL_EC_POOL).mkfs()
        # each rank with a RADOS client of its own, as an MDS daemon has
        mds_clients = [RadosClient(c.bus, name=f"client.mds{r}",
                                   op_timeout=CL_OP_TIMEOUT_S,
                                   device=c.device) for r in range(2)]
        ranks = []
        for r, cl in enumerate(mds_clients):
            await cl.connect()
            ranks.append(MDSLite(c.bus, cl, CL_REP_POOL, name=f"mds.{r}",
                                 data_pool=CL_EC_POOL))
            await ranks[-1].start()
        a = FSClient(c.bus, c.client, CL_EC_POOL, name="fsclient.a",
                     timeout=CL_OP_TIMEOUT_S)
        b = FSClient(c.bus, c.client, CL_EC_POOL, name="fsclient.b",
                     timeout=CL_OP_TIMEOUT_S, cache=True)
        await a.connect()
        await b.connect()
        steps.mark("setup", prewarmed_pgids=warmed, ranks=len(ranks),
                   clients={"fsclient.a": "direct",
                            "fsclient.b": "ObjectCacher"})
        st = {"a": a, "b": b, "ranks": ranks}
        await md_tree(steps, st, rng, sz)
        await md_caps(steps, st, rng, sz)
        await md_race(steps, st, sz)
        await md_data(steps, st, rng, sz)
        await md_overwrites(steps, st, rng, sz)
        await md_rename(steps, st, sz)
        await md_snap(steps, st, rng)
        await md_quota(steps, st)
        await md_crash(steps, st, c)
        await md_degraded(steps, st, c)
        await a.close()
        await b.close()
        for m in st["ranks"]:
            await m.stop()
        for cl in mds_clients:
            await cl.close()
    finally:
        await c.stop()
        steps.cluster = None


def mds_phase(card: str, rng, device=None, **sizes) -> dict:
    """Phase mds's in-process arm (see the MD_* constants): a TestCluster
    on ``device`` (the card when None, as a user leaves it), every count
    set to 0 at its start; steps ``tree``, ``caps``, ``race``, ``data``,
    ``overwrites``, ``rename``, ``snap``, ``quota``, ``crash`` and
    ``degraded``, a line
    each (``sizes`` overrides MD_SIZES). Every read must equal the host's
    copy; K1 and K2 must launch in ``tree``, ``data`` and ``overwrites``,
    K1 in ``degraded``; no step may call the rs byte API, decode on the
    host engine or fail a placement lookup -> {"lines", "launches",
    "drive_s"}."""
    sz = {**MD_SIZES, **sizes}
    emit({"phase": "mds", "arm": "in_process", "cuts": {
        k: {"from": v, "to": sz[k]} for k, v in MD_FULL.items()
        if sz[k] != v}, "budget_s": MD_BUDGET_S, "card": card})
    steps = MdSteps(card)
    try:
        t0 = time.perf_counter()
        asyncio.run(asyncio.wait_for(md_drive(steps, device, rng, sz),
                                     MD_TIMEOUT_S))
        drive_s = time.perf_counter() - t0
    finally:
        steps.close()
    for step, line in steps.lines.items():
        check(line["rs_byte_api"] == {"encode_chunks": 0,
                                      "decode_chunks": 0},
              f"mds {step}: rs byte API {line['rs_byte_api']}")
        check(line["decode_host_rounds"] == 0,
              f"mds {step}: {line['decode_host_rounds']} decode rounds on "
              "the host engine")
    cl_lookups_check(steps, "mds")
    for step, keys in (("tree", ("gf_matmul", "crc32c")),
                       ("data", ("gf_matmul", "crc32c")),
                       ("overwrites", ("gf_matmul", "crc32c")),
                       ("degraded", ("gf_matmul",))):
        for key in keys:
            n = steps.lines[step]["launches"][key]
            check(n > 0, f"mds {step} launched {key} {n} times")
    check(steps.lines["degraded"]["decode_batches"] > 0,
          "mds degraded: no decode batch")
    launches = steps.totals()
    evictions = sum(line["caps"]["late_releases"]
                    for line in steps.lines.values())
    emit({"phase": "mds_launches", "arm": "in_process", **launches,
          "drive_s": drive_s, "over_budget": drive_s > MD_BUDGET_S,
          "cap_revokes": sum(line["caps"]["revokes"]
                             for line in steps.lines.values()),
          "live_clients_evicted": evictions})
    return {"lines": steps.lines, "launches": launches, "drive_s": drive_s}


def mem_available() -> dict:
    """MemTotal and MemAvailable of the host (/proc/meminfo), bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[f"{key}_bytes"] = int(value.split()[0]) * 1024
    return out


def pr_mem_of(pid: int) -> dict:
    """A live process's VmRSS, RssAnon, RssFile and RssShmem
    (/proc/<pid>/status) and Pss (/proc/<pid>/smaps_rollup, else the sum
    over /proc/<pid>/smaps; left out where neither can be read), bytes;
    {} once it is gone."""
    out = {}
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                key = line.split(":", 1)[0]
                if key in ("VmRSS", "RssAnon", "RssFile", "RssShmem"):
                    out[key] = int(line.split()[1]) * 1024
    except OSError:
        return {}
    for name in ("smaps_rollup", "smaps"):
        try:
            with open(f"/proc/{pid}/{name}") as f:
                pss = [int(line.split()[1]) * 1024 for line in f
                       if line.startswith("Pss:")]
        except OSError:
            continue
        if pss:
            out["Pss"] = sum(pss)
            break
    return out


def pr_memory(c) -> dict:
    """Memory by role over the live daemons of ``c``: each field's
    median, max and sum (bytes), and the host's MemAvailable."""
    by_role: dict[str, dict[str, list]] = {}
    for name, proc in c.procs.items():
        if proc is None or proc.poll() is not None:
            continue
        role = by_role.setdefault(name.split(".")[0], {})
        for key, v in pr_mem_of(proc.pid).items():
            role.setdefault(key, []).append(v)
    daemons = sum(1 for p in c.procs.values()
                  if p is not None and p.poll() is None)
    return {"by_role": {role: {key: {"median": statistics.median(v),
                                     "max": max(v), "sum": sum(v),
                                     "n": len(v)}
                               for key, v in fields.items()}
                        for role, fields in by_role.items()},
            "daemons": daemons, **mem_available()}


def mp_fits(mem: dict, before: dict, extra: int = 2) -> dict:
    """Whether ``extra`` more daemons fit beside those ``mem``
    (``pr_memory``) measured, leaving MP_FREE_SHARE of the host's memory
    free, against MemAvailable before the cluster started. A daemon's
    size: the host's MemAvailable drop since the start over the live
    daemons. VmRSS counts the shared torch and CUDA libraries once in
    every process, so a sum of it overstates; on the H100's host /proc
    gives a Pss equal to VmRSS, so it splits nothing either."""
    used = before["MemAvailable_bytes"] - mem["MemAvailable_bytes"]
    each = used / max(1, mem["daemons"])
    need = used + extra * each
    room = before["MemAvailable_bytes"] - MP_FREE_SHARE * before[
        "MemTotal_bytes"]
    return {"daemons_bytes": used, "daemon_bytes": each, "need_bytes": need,
            "room_bytes": room, "fits": need <= room}


async def mp_arm(c, card: str, rng, cluster: str) -> dict:
    """Phase mds's process arm on the ProcCluster ``c`` (its replicated
    and EC pools made): two MDS daemon processes, two FSClients in the
    launcher, the schedule of the MP_* constants. A line per step ->
    {"lines", "launches", "mds_launches"}."""
    from ceph_tpu_torch.services.fs import FSLite
    from ceph_tpu_torch.services.mds import FSClient
    from ceph_tpu_torch.tools import ceph_daemon, exporter

    steps = PrSteps(c, card, cluster, phase="mds")
    await steps.start()
    await FSLite(c.client, CL_REP_POOL, data_pool=CL_EC_POOL).mkfs()
    t0 = time.perf_counter()
    await asyncio.gather(*(c.start_mds(r, pool=CL_REP_POOL,
                                       data_pool=CL_EC_POOL)
                           for r in range(2)))
    start_s = time.perf_counter() - t0
    startup = {n: c.startup()[n] for n in ("mds.0", "mds.1")}
    fs = FSClient(c.bus, c.client, CL_EC_POOL, name="fsclient.p0",
                  timeout=MP_CLIENT_TIMEOUT_S)
    fs2 = FSClient(c.bus, c.client, CL_EC_POOL, name="fsclient.p1",
                   timeout=MP_CLIENT_TIMEOUT_S)
    await fs.connect()
    await fs2.connect()
    await fs.mkdir("/proj")
    await fs.mkdir("/pin")
    await fs.set_subtree_pin("/pin", 1)
    mem = pr_memory(c)
    await steps.mark("mds_start", arm="process", start_s=start_s,
                     startup=startup, memory=mem["by_role"].get("mds"),
                     MemAvailable_bytes=mem["MemAvailable_bytes"])
    files = {f"{('/proj', '/pin')[i % 2]}/f{i:03d}": rng.bytes(MP_FILE_BYTES)
             for i in range(MP_FILES)}
    by = {p: (fs, fs2)[i % 2] for i, p in enumerate(files)}
    # the creates one at a time: the two ranks share one inode counter
    # that each reads and writes back (ROADMAP §3 item 12; the in-process
    # arm's step race records it), then the data MP_QD at a time
    for p in files:
        await by[p].create(p)
    res = await sv_run([lambda p=p: by[p].write(p, files[p])
                        for p in files], MP_QD)
    for cl in (fs, fs2):  # the sizes reach the MDSs
        for ino in list(cl.wcaps):
            await cl._flush(ino)
    nbytes = MP_FILES * MP_FILE_BYTES
    await steps.mark("write", arm="process", qd=MP_QD,
                     **sv_traffic(res, nbytes))

    async def read_other(p):
        other = fs2 if by[p] is fs else fs
        got = await other.read(p)
        return got == files[p] or (p, len(got), got == files[p][:len(got)])
    res = await sv_run([lambda p=p: read_other(p) for p in files], MP_QD)
    bad = [r for r in res["results"] if r is not True]
    check(not bad, f"mds process arm read: {len(bad)} of {len(files)} "
                   f"reads differ (path, bytes, a prefix): {bad[:4]}")
    await steps.mark("read", arm="process", **sv_traffic(res, nbytes))
    # kill -9 of rank 0 between two ops of the stream, its revival and
    # the namespace back after the journal's replay
    listing = {d: sorted(await fs.listdir(d)) for d in ("/proj", "/pin")}
    c.kill_mds(0)
    t0 = time.perf_counter()
    down = None
    try:
        await asyncio.wait_for(fs.mkdir("/proj/lost"), MP_DOWN_PROBE_S)
    except (OSError, asyncio.TimeoutError) as e:
        down = type(e).__name__
    check(down is not None, "mds process arm: rank 0 answered after kill")
    t1 = time.perf_counter()
    await c.revive_mds(0)
    revive_s = time.perf_counter() - t1
    again = {d: sorted(await fs.listdir(d)) for d in ("/proj", "/pin")}
    check(again == listing, "mds process arm: namespace after the revival")
    back_s = time.perf_counter() - t0
    sample = sorted(files)[:8]
    res = await sv_run([lambda p=p: fs.read(p) for p in sample], MP_QD)
    check(res["results"] == [files[p] for p in sample],
          "mds process arm: reads after the revival")
    await fs.create("/proj/after-revival")
    await fs.write("/proj/after-revival", b"after-revival")
    check(await fs2.read("/proj/after-revival") == b"after-revival",
          "mds process arm: write after the revival")
    await steps.mark("kill9_revive", arm="process", probe_error=down,
                     revive_s=revive_s, namespace_back_s=back_s,
                     startup=c.startup()["mds.0"])
    # cross-subtree renames over the wire: mds.0 -> mds.1 and back
    lat = []
    for src, dst, cl in (("/proj/f000", "/pin/crossed", fs),
                         ("/pin/crossed", "/proj/back", fs2)):
        t = time.perf_counter()
        await cl.rename(src, dst)
        lat.append(time.perf_counter() - t)
        other = fs2 if cl is fs else fs
        check(await other.read(dst) == files["/proj/f000"],
              f"mds process arm: {dst} after the rename")
    check("f000" not in await fs2.listdir("/proj")
          and "crossed" not in await fs.listdir("/pin"),
          "mds process arm: rename left its source")
    launches = {n: await c.asok(n, "kernel launches")
                for n in ("mds.0", "mds.1")}
    # the CLIs against the live daemons' admin sockets
    asok = os.path.join(c.data_dir, "mds.1.asok")
    rc, text = await asyncio.to_thread(tl_run, ceph_daemon,
                                       [asok, "kernel", "launches"])
    check(rc == 0 and json.loads(text)["pid"] == c.procs["mds.1"].pid,
          f"ceph_daemon against mds.1: rc {rc}, {text[:200]}")
    sock_dir = os.path.join(c.data_dir, "scrape")
    os.makedirs(sock_dir, exist_ok=True)
    for i in range(c.n_osds):
        os.symlink(os.path.join(c.data_dir, f"osd.{i}.asok"),
                   os.path.join(sock_dir, f"osd.{i}.sock"))
    text = await exporter.scrape(sock_dir)
    up = sum(f'ceph_tpu_daemon_up{{ceph_daemon="osd.{i}"}} 1' in text
             for i in range(c.n_osds))
    check(up == c.n_osds and "ceph_tpu_op" in text,
          f"exporter: {up} of {c.n_osds} OSDs scraped up")
    await steps.mark("rename_clis", arm="process", renames=len(lat),
                     rename_ms=[x * 1e3 for x in lat],
                     mds_launches={n: v["launches"]
                                   for n, v in launches.items()},
                     ceph_daemon_rc=rc, exporter_lines=text.count("\n"),
                     exporter_osds_up=up)
    await fs.close()
    await fs2.close()
    mds_launches = {n: v["launches"] for n, v in launches.items()}
    totals = steps.totals()
    for n, kl in mds_launches.items():
        for k, v in kl.items():
            totals[k] += v
    return {"lines": steps.lines, "launches": totals,
            "mds_launches": mds_launches}


async def mp_cluster(data_dir: str, device, card: str, rng) -> dict:
    """The process arm's own ProcCluster: 1 mon, MP_OSDS OSDs over TCP,
    phase proc's pools, then ``mp_arm``."""
    from ceph_tpu_torch.cluster.procstart import ProcCluster
    from ceph_tpu_torch.placement.osdmap import Pool

    c = ProcCluster(data_dir, n_osds=MP_OSDS, n_mons=1, backend="tcp",
                    spawn_timeout=PR_SPAWN_TIMEOUT_S,
                    osd_conf={"osd_ec_cold_shape_bytes":
                              CL_COLD_SHAPE_BYTES}, device=device)
    try:
        t0 = time.perf_counter()
        await c.start()
        start_s = time.perf_counter() - t0
        c.client.op_timeout = PR_OP_TIMEOUT_S
        await c.client.create_pool(Pool(
            id=CL_REP_POOL, name="cephfs_metadata", size=3, min_size=2,
            pg_num=CL_PG_NUM, crush_rule=0))
        k, m = int(CL_EC_PROFILE["k"]), int(CL_EC_PROFILE["m"])
        await c.client.create_pool(Pool(
            id=CL_EC_POOL, name="cephfs_data", size=k + m, min_size=k,
            pg_num=CL_PG_NUM, crush_rule=1, type="erasure",
            ec_profile=dict(CL_EC_PROFILE)))
        await pr_active(c, PR_CLEAN_TIMEOUT_S)
        emit({"phase": "mds", "arm": "process", "step": "cluster",
              "osds": MP_OSDS, "mons": 1, "start_s": start_s,
              "memory": pr_memory(c), "card": card})
        return await mp_arm(c, card, rng, "tcp")
    finally:
        await c.stop()


def mp_check(mp: dict) -> None:
    """The process arm's lines: no EC batch failed and no decode ran on
    the host engine in the OSD daemons."""
    for step, line in mp["lines"].items():
        for key in ("ec_decode_cold_host", "ec_batch_failures"):
            check(line[key] == 0, f"mds process arm {step}: {key} "
                                  f"{line[key]}")
    emit({"phase": "mds_launches", "arm": "process", **mp["launches"],
          "by_mds": mp["mds_launches"]})


def mds_proc_phase(card: str, rng, device=None) -> dict:
    """Phase mds's process arm on a ProcCluster of its own (``mp_cluster``)
    -> ``mp_arm``'s result."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_mds-")
    try:
        return asyncio.run(mp_cluster(root, device, card, rng))
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: Phase tools: the operator CLIs (``ceph_tpu_torch.tools``), each through
#: its ``main(argv)`` in this process, the clusters they build on the card
#: (no ``--device``, as an operator leaves it). ``crushtool --test
#: --device`` on config 5's 1,000 OSDs (placement phase's 50 hosts x 20,
#: its replicated and EC 8+3 rules) at TL_CRUSH_X inputs;
#: ``osdmaptool --test-map-pgs`` on a TL_MAP_OSDS-OSD map with phase
#: cluster's two pools; ``rados bench`` at 4 MiB, ``-t`` TL_BENCH_T,
#: TL_BENCH_S s of writes then ``seq`` on an EC 8+3 pool of CL_OSDS OSDs on
#: BlueStoreLite; ``rbd`` create / import / export / snap / clone of a
#: TL_RBD_BYTES image; ``objectstore_tool`` export and import of one PG
#: (tests/test_tools.py's surgery); ``dencoder`` over every registered
#: message type; ``ceph status``, ``osd tree`` and ``osd pool ls``; and
#: ``swarm`` at its own defaults (2,000 clients, 8 s, 10 OSDs, 1,000,000
#: objects, Zipf 1.1).
TL_CRUSH_X, TL_CRUSH_HEAD = 1 << 20, 65_536
TL_MAP_OSDS = 12
TL_BENCH_S, TL_BENCH_T, TL_BENCH_BYTES = 5, 16, 4 << 20
TL_BENCH_DEV_MIB = 1024
TL_RBD_BYTES, TL_RBD_MUT_BYTES, TL_RBD_DEV_MIB = 256 << 20, 1 << 20, 1024
TL_BUDGET_S = 60.0
#: swarm's argv: its own defaults.
TL_SWARM_ARGV: list[str] = []
#: Free bytes the phase needs under TMPDIR (the BlueStoreLite block files
#: of the bench's and rbd's clusters are sparse, their data is not).
TL_FREE_BYTES = 8 << 30


def tl_device(device) -> list[str]:
    """The ``--device`` arguments of a CLI that builds a cluster: none
    for the card (an operator leaves it out), else the device named."""
    return [] if device is None else ["--device", str(device)]


def tl_run(mod, argv: list[str]) -> tuple[int, str]:
    """A CLI's ``main(argv)`` with its stdout captured (text and bytes, as
    ``rbd export -`` writes) -> (rc, stdout)."""
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out):
        rc = mod.main(list(argv))
    out.flush()
    return rc, buf.getvalue().decode()


def tl_value(kind, rng):
    """A seeded value of a message field ``kind`` (the kinds of
    ``msg/messages.py`` and the cluster messages' own codecs, named by
    their encoder)."""
    from ceph_tpu_torch.cluster import messages as M

    if isinstance(kind, tuple):
        kind = kind[0].__name__
    if kind in ("u8", "u16", "u32", "u64"):
        return int(rng.integers(0, 1 << {"u8": 8, "u16": 16, "u32": 32,
                                          "u64": 63}[kind]))
    if kind in ("i32", "i64"):
        bits = 31 if kind == "i32" else 62
        return int(rng.integers(-(1 << bits), 1 << bits))
    if kind == "str":
        return "".join(rng.choice(list("abcdefgh.0123"),
                                  int(rng.integers(12))))
    if kind in ("bytes", "body", "_enc_lazy_txn", "_enc_lazy_entries"):
        return rng.bytes(int(rng.integers(40)))
    if kind.startswith("list:"):
        return [tl_value(kind[5:], rng) for _ in range(rng.integers(4))]
    if kind.startswith("map:"):
        k_kind, v_kind = kind[4:].split(":", 1)
        return {tl_value(k_kind, rng): tl_value(v_kind, rng)
                for _ in range(rng.integers(4))}
    if kind.startswith("pair:"):
        a_kind, b_kind = kind[5:].split(":", 1)
        return (tl_value(a_kind, rng), tl_value(b_kind, rng))
    if kind == "_enc_osd_ops":
        return [M.osd_op(tl_value("str", rng), tl_value("u64", rng),
                         tl_value("i64", rng), tl_value("bytes", rng),
                         tl_value("bytes", rng),
                         tl_value("map:bytes:bytes", rng),
                         tl_value("list:bytes", rng))
                for _ in range(rng.integers(4))]
    if kind == "_enc_outs":
        return [(tl_value("i32", rng), tl_value("bytes", rng))
                for _ in range(rng.integers(4))]
    if kind == "_enc_scrub_map":
        return {tl_value("bytes", rng): (tl_value("pair:u32:u64", rng),
                                         tl_value("pair:u64:u32", rng))
                for _ in range(rng.integers(4))}
    if kind == "_enc_cfg_entries":
        return [tuple(tl_value("str", rng) for _ in range(3))
                for _ in range(rng.integers(4))]
    if kind == "_enc_upmap_plan":
        return [(tl_value("pair:i32:u32", rng),
                 [tl_value("pair:i32:i32", rng)
                  for _ in range(rng.integers(3))])
                for _ in range(rng.integers(4))]
    raise ValueError(f"no value for message field kind {kind!r}")


class TlShapes:
    """While open, the batch of every K1 encode (``rs.gf_matmul`` with the
    m-row matrix: stripes, words a cell) the CLIs make, and the payload of
    ``rados bench``'s first write with every bench read held against it
    (the bench writes one random buffer to every object)."""

    def __init__(self, m: int):
        self.m = m
        self.encodes: list[tuple[int, int]] = []
        self.payload = None
        self.reads = self.reads_equal = 0

    def __enter__(self):
        from ceph_tpu_torch.cluster.client import RadosClient
        from ceph_tpu_torch.ops import rs

        self._real = [(rs, "gf_matmul", rs.gf_matmul),
                      (RadosClient, "write_full", RadosClient.write_full),
                      (RadosClient, "read", RadosClient.read)]
        gf, write_full, read = (r[2] for r in self._real)

        def gf_matmul(mat, x, *a, **kw):
            if len(mat) == self.m and x.dim() == 3:
                self.encodes.append((int(x.shape[0]), int(x.shape[2])))
            return gf(mat, x, *a, **kw)

        async def bench_write(cl, pool, name, data, *a, **kw):
            if self.payload is None and bytes(
                    name if isinstance(name, bytes) else name.encode()
            ).startswith(b"bench_"):
                self.payload = bytes(data)
            return await write_full(cl, pool, name, data, *a, **kw)

        async def bench_read(cl, pool, name, *a, **kw):
            data = await read(cl, pool, name, *a, **kw)
            if bytes(name if isinstance(name, bytes)
                     else name.encode()).startswith(b"bench_"):
                self.reads += 1
                self.reads_equal += bytes(data) == self.payload
            return data
        rs.gf_matmul = gf_matmul
        RadosClient.write_full = bench_write
        RadosClient.read = bench_read
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._real:
            setattr(owner, name, fn)


def tl_crush(tmp: str, device=None) -> tuple[dict, object]:
    """``crushtool --test --device`` on config 5's 1,000 OSDs for both
    rules -> (a line's fields, the map)."""
    from ceph_tpu_torch.placement import crushmap as cm
    from ceph_tpu_torch.placement import encoding as menc
    from ceph_tpu_torch.tools import crushtool

    tree = cm.build_hierarchy(osds_per_host=PL_PER_HOST, n_hosts=PL_HOSTS)
    tree.add_rule(cm.replicated_rule(0, root=-1, failure_domain_type=1))
    tree.add_rule(cm.ec_rule(1, root=-1, failure_domain_type=1))
    path = os.path.join(tmp, "config5.crush")
    with open(path, "wb") as f:
        f.write(menc.encode_crushmap(tree))
    out = {}
    for name, (rule, numrep) in PL_RULES.items():
        t0 = time.perf_counter()
        rc, text = tl_run(crushtool, [
            "--test", "-i", path, "--rule", str(rule), "--num-rep",
            str(numrep), "--max-x", str(TL_CRUSH_X), "--show-bad-mappings",
            "--device", *([] if device is None else [str(device)])])
        head = text.splitlines()[0]
        placed = int(head.split("placed ")[1].split(",")[0])
        bad = int(head.split(", ")[-2].split()[0])
        check(rc == (1 if bad else 0),
              f"crushtool rule {rule}: rc {rc}, {head}")
        out[name] = {"rule": rule, "num_rep": numrep, "rc": rc,
                     "seconds": time.perf_counter() - t0, "placed": placed,
                     "bad_mappings": bad,
                     "max_deviation": float(head.rsplit(" ", 1)[1])}
    return out, tree


def tl_osdmap(tmp: str) -> dict:
    """``osdmaptool --test-map-pgs`` and ``--print`` on a TL_MAP_OSDS-OSD
    map with phase cluster's two pools, against the library's own
    mapping of every PG."""
    from ceph_tpu_torch.placement import crushmap as cm
    from ceph_tpu_torch.placement import encoding as menc
    from ceph_tpu_torch.placement.osdmap import OSDMap, Pool
    from ceph_tpu_torch.tools import osdmaptool

    crush = cm.build_flat(TL_MAP_OSDS)
    crush.add_rule(cm.flat_firstn_rule(0))
    crush.add_rule(cm.ec_rule(1, root=-1, failure_domain_type=0))
    m = OSDMap(crush, TL_MAP_OSDS)
    m.add_pool(Pool(id=CL_REP_POOL, name="rbd", size=3, min_size=2,
                    pg_num=CL_PG_NUM, crush_rule=0))
    m.add_pool(Pool(id=CL_EC_POOL, name="rbd_data", size=11, min_size=8,
                    pg_num=CL_PG_NUM, crush_rule=1, type="erasure",
                    ec_profile=dict(CL_EC_PROFILE)))
    path = os.path.join(tmp, "osdmap.bin")
    with open(path, "wb") as f:
        f.write(menc.encode_osdmap(m))
    out = {}
    for pool in (CL_REP_POOL, CL_EC_POOL):
        rc, text = tl_run(osdmaptool, ["--test-map-pgs", path, "--pool",
                                       str(pool)])
        counts = {}
        for ps in range(CL_PG_NUM):
            for o in m.pg_to_up_acting_osds((pool, ps))[0]:
                if 0 <= o < TL_MAP_OSDS:
                    counts[o] = counts.get(o, 0) + 1
        got = {int(ln.split("\t")[0].strip().removeprefix("osd.")):
               int(ln.split("\t")[1]) for ln in text.splitlines()
               if ln.startswith("  osd.")}
        check(rc == 0 and got == counts,
              f"osdmaptool pool {pool}: rc {rc}, {got} against {counts}")
        out[str(pool)] = {"mappings": sum(got.values()), "osds": len(got),
                          "max_avg": text.splitlines()[1]}
    rc, text = tl_run(osdmaptool, ["--print", path])
    check(rc == 0 and f"max_osd {TL_MAP_OSDS}" in text,
          f"osdmaptool --print: rc {rc}")
    return out


def tl_bench(tmp: str, shapes: TlShapes, device=None) -> dict:
    """``rados bench`` write then seq on an EC 8+3 pool (durable, so seq
    finds the objects)."""
    from ceph_tpu_torch.tools import rados

    base = ["--data-dir", os.path.join(tmp, "bench"), "--osds",
            str(CL_OSDS), "--dev-size", str(TL_BENCH_DEV_MIB),
            *tl_device(device)]
    out = {}
    for mode in ("write", "seq"):
        t0 = time.perf_counter()
        rc, text = tl_run(rados, base + [
            "bench", "ecbench", str(TL_BENCH_S), mode, "-b",
            str(TL_BENCH_BYTES), "-t", str(TL_BENCH_T), "--ec-k",
            CL_EC_PROFILE["k"], "--ec-m", CL_EC_PROFILE["m"]])
        res = json.loads(text.strip().splitlines()[-1])
        check(rc == 0 and res["mode"] == mode and res["ops"] > 0,
              f"rados bench {mode}: rc {rc}, {res}")
        out[mode] = {**res, "command_s": time.perf_counter() - t0}
    check(shapes.payload is not None and shapes.reads == out["seq"]["ops"]
          and shapes.reads_equal == shapes.reads,
          f"rados bench seq: {shapes.reads_equal} of {shapes.reads} reads "
          f"equal the written object ({out['seq']['ops']} ops)")
    out["seq"]["reads_equal"] = shapes.reads_equal
    return out


def tl_rbd(tmp: str, rng, device=None) -> dict:
    """``rbd`` create, import, export, snap create, a second import, clone
    and exports, each a cold start of a durable cluster; every export
    byte-exact."""
    from ceph_tpu_torch.tools import rbd

    base = ["--data-dir", os.path.join(tmp, "rbd"), "--dev-size",
            str(TL_RBD_DEV_MIB), *tl_device(device)]
    img = rng.bytes(TL_RBD_BYTES)
    mut = rng.bytes(TL_RBD_MUT_BYTES)
    src, mutf, out = (os.path.join(tmp, n) for n in ("img", "mut", "out"))
    with open(src, "wb") as f:
        f.write(img)
    with open(mutf, "wb") as f:
        f.write(mut)
    seconds = {}

    def run(*argv):
        t0 = time.perf_counter()
        rc, text = tl_run(rbd, base + list(argv))
        check(rc == 0, f"rbd {' '.join(argv)}: rc {rc}")
        key = " ".join(a for a in argv if not a.startswith(tmp))
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return text

    def exported(spec):
        run("export", spec, out)
        with open(out, "rb") as f:
            return f.read()
    run("mkpool", "rbd")
    run("create", "rbd/disk", "--size", f"{TL_RBD_BYTES >> 20}M")
    run("import", "rbd/disk", src)
    check(exported("rbd/disk") == img, "rbd export after import")
    run("snap", "create", "rbd/disk@s1")
    run("import", "rbd/disk", mutf)
    run("clone", "rbd/disk@s1", "rbd/child")
    check(exported("rbd/child") == img, "rbd export of the clone")
    check(exported("rbd/disk") == mut + img[len(mut):],
          "rbd export after the snapshot's overwrite")
    check("child" in run("ls", "rbd"), "rbd ls")
    for path in (src, mutf, out):
        os.unlink(path)
    return {"image_bytes": TL_RBD_BYTES, "exports_exact": 3,
            "command_seconds": seconds}


def tl_objectstore(tmp: str, rng, device=None) -> dict:
    """tests/test_tools.py's PG surgery: a replicated object put with
    ``rados``, its PG exported from one OSD's store, removed, imported
    and read back with ``objectstore_tool``."""
    from ceph_tpu_torch.tools import objectstore_tool as ost
    from ceph_tpu_torch.tools import rados

    d = os.path.join(tmp, "ost")
    base = ["--data-dir", d, "--osds", "4", "--dev-size", "64",
            *tl_device(device)]
    payload = rng.bytes(9000)
    src = os.path.join(tmp, "victim")
    with open(src, "wb") as f:
        f.write(payload)
    check(tl_run(rados, base + ["mkpool", "rp", "3"])[0] == 0, "rados mkpool")
    check(tl_run(rados, base + ["put", "rp", "victim", src])[0] == 0,
          "rados put")
    pgid = tb = None
    for i in range(4):
        tb = ["--data-path", os.path.join(d, f"osd.{i}"), "--type",
              "bluestore"]
        rows = [json.loads(ln) for ln in
                tl_run(ost, tb + ["--op", "list"])[1].splitlines()]
        hit = {cid for cid, oid in rows if oid == "victim"}
        if hit:
            pgid = hit.pop()
            break
    check(pgid is not None, "objectstore_tool: no OSD holds the object")
    exp = os.path.join(tmp, "pg.export")
    got = os.path.join(tmp, "got")
    for argv in (["--op", "export", "--pgid", pgid, "--file", exp],
                 ["--op", "remove", "--pgid", pgid],
                 ["--op", "import", "--file", exp],
                 ["--op", "get-bytes", "--pgid", pgid, "--obj", "victim",
                  "--file", got]):
        check(tl_run(ost, tb + argv)[0] == 0, f"objectstore_tool {argv}")
    with open(got, "rb") as f:
        check(f.read() == payload, "objectstore_tool: imported bytes")
    return {"pgid": pgid, "export_bytes": os.path.getsize(exp),
            "osd": tb[1].rsplit("/", 1)[1]}


def tl_dencoder(tmp: str) -> dict:
    """``dencoder list`` and ``selftest`` (the reference's selftest has no
    sample for most types and exits 1 before any round trip: kept, and
    recorded), then ``dencoder dump`` of every registered message type,
    each a seeded instance's wire bytes decoded and encoded back
    equal."""
    from ceph_tpu_torch.msg.messages import _REGISTRY
    from ceph_tpu_torch.tools import dencoder

    rc, text = tl_run(dencoder, ["list"])
    listed = [ln for ln in text.splitlines() if not ln.startswith("-")]
    check(rc == 0 and len(listed) == len(_REGISTRY),
          f"dencoder list: rc {rc}, {len(listed)} of {len(_REGISTRY)}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        self_rc, self_out = tl_run(dencoder, ["selftest"])
    rng = np.random.default_rng(20261020)
    dumped = 0
    for t, cls in sorted(_REGISTRY.items()):
        msg = cls(**{n: tl_value(k, rng) for n, k in cls.FIELDS})
        blob = msg.encode()
        path = os.path.join(tmp, f"{cls.__name__}.hex")
        with open(path, "w") as f:
            f.write(blob.hex())
        rc, text = tl_run(dencoder, ["dump", cls.__name__, path])
        check(rc == 0 and text.startswith(cls.__name__)
              and cls.decode(blob).encode() == blob,
              f"dencoder dump {cls.__name__}: rc {rc}")
        dumped += 1
    return {"types": len(_REGISTRY), "dumped_round_trip": dumped,
            "selftest_rc": self_rc,
            "selftest": (self_out + err.getvalue()).strip()[:300]}


def tl_ceph(device=None) -> dict:
    """``ceph status``, ``osd tree`` and ``osd pool ls`` (json), each on a
    fresh CL_OSDS-OSD cluster."""
    from ceph_tpu_torch.tools import ceph

    out = {}
    for words in (["status"], ["osd", "tree"], ["osd", "pool", "ls"]):
        t0 = time.perf_counter()
        rc, text = tl_run(ceph, ["--osds", str(CL_OSDS), "-f", "json",
                                 *tl_device(device), *words])
        check(rc == 0, f"ceph {' '.join(words)}: rc {rc}")
        out[" ".join(words)] = {"seconds": time.perf_counter() - t0,
                                "json": json.loads(text)}
    osds = sorted(n["id"] for n in out["osd tree"]["json"] if n["id"] >= 0
                  and n["status"] == "up")
    check(osds == list(range(CL_OSDS)), f"ceph osd tree lists {osds} up")
    status = out["status"]["json"]
    check(status["osdmap"]["num_up_osds"] == CL_OSDS
          and status["osdmap"]["num_in_osds"] == CL_OSDS,
          f"ceph status: {status['osdmap']}")
    check(out["osd pool ls"]["json"] == [],
          f"ceph osd pool ls: {out['osd pool ls']['json']}")
    return {"command_seconds": {k: v["seconds"] for k, v in out.items()},
            "status": status, "tree_osds_up": len(osds),
            "pools": out["osd pool ls"]["json"]}


def tl_swarm(device=None) -> dict:
    """``swarm`` at its own defaults; its JSON verdict's per-shape
    percentiles and MiB/s, in-flight peak and resolver block."""
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.tools import swarm

    before = {k.name: k.launches for k in kernels.KERNELS}
    t0 = time.perf_counter()
    rc, text = tl_run(swarm, TL_SWARM_ARGV + tl_device(device))
    seconds = time.perf_counter() - t0
    if device is None:
        torch.cuda.synchronize()
    launches = {k.name: k.launches - before[k.name]
                for k in kernels.KERNELS}
    res = json.loads(text)
    check(rc == 0 and res["op_errors"] == {},
          f"swarm: rc {rc}, op_errors {res['op_errors']}")
    for key in ("gf_matmul", "crc32c", "crush_rule"):
        check(launches[key] > 0, f"swarm launched {key} {launches[key]} "
                                 "times")
    return {"seconds": seconds, "launches": launches,
            **{k: res[k] for k in (
                "clients", "duration_s", "n_osds", "namespace_objects",
                "distinct_objects_touched", "ops", "ops_s", "mib_s",
                "inflight_sustained", "inflight_peak", "op_errors",
                "get_misses", "shapes", "placement",
                "placement_prewarmed_pgids", "osd_counters")}}


def tools_phase(card: str, rng, device=None) -> dict:
    """Phase tools (see the TL_* constants): every count set to 0, then
    each CLI through its ``main`` on the card, a line each; the tools'
    launches read; then K4's rows at the crushtool inputs held against the
    plain engine on a TL_CRUSH_HEAD head and timed at TL_CRUSH_X, and K1
    and K2 timed at the bench's mean encode batch. ``device`` None runs
    the CLIs on the card (no ``--device``, as an operator runs them) ->
    {"lines", "launches", "timed", "seconds"}."""
    import gc
    import shutil
    import tempfile

    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.ec import load_codec

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools-")
    free = shutil.disk_usage(tmp).free
    check(free >= TL_FREE_BYTES, f"tools: {free} bytes free under "
                                 f"{tmp}, the phase needs {TL_FREE_BYTES}")
    lines = {}

    def line(step, t0, **fields):
        lines[step] = {"phase": "tools", "step": step,
                       "seconds": time.perf_counter() - t0, **fields,
                       "card": card}
        emit(lines[step])
    try:
        if device is None:
            torch.cuda.synchronize()
        kernels.reset_counts()
        t_phase = time.perf_counter()
        with TlShapes(int(CL_EC_PROFILE["m"])) as shapes:
            t0 = time.perf_counter()
            crush_out, tree = tl_crush(tmp, device)
            line("crushtool", t0, inputs=TL_CRUSH_X, rules=crush_out)
            t0 = time.perf_counter()
            line("osdmaptool", t0, osds=TL_MAP_OSDS, pools=tl_osdmap(tmp))
            t0 = time.perf_counter()
            bench = tl_bench(tmp, shapes, device)
            bench_encodes = list(shapes.encodes)
            line("rados_bench", t0, object_bytes=TL_BENCH_BYTES,
                 concurrency=TL_BENCH_T, **bench)
            shutil.rmtree(os.path.join(tmp, "bench"), ignore_errors=True)
            t0 = time.perf_counter()
            line("rbd", t0, **tl_rbd(tmp, rng, device))
            shutil.rmtree(os.path.join(tmp, "rbd"), ignore_errors=True)
            t0 = time.perf_counter()
            line("objectstore_tool", t0, **tl_objectstore(tmp, rng, device))
        t0 = time.perf_counter()
        line("dencoder", t0, **tl_dencoder(tmp))
        t0 = time.perf_counter()
        line("ceph", t0, **tl_ceph(device))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        line("swarm", t0, **tl_swarm(device))
        if device is None:
            torch.cuda.synchronize()
        phase_s = time.perf_counter() - t_phase
        launches = {k.name: k.launches for k in kernels.KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "tools_launches", **launches, "drive_s": phase_s,
          "budget_s": TL_BUDGET_S, "over_budget": phase_s > TL_BUDGET_S})
    for key in ("gf_matmul", "crc32c", "crush_rule"):
        check(launches[key] > 0, f"the tools launched {key} "
                                 f"{launches[key]} times")
    # after the counts: the kernels against their plain versions
    t0 = time.perf_counter()
    timed = tl_rule_times(tree, crush_out, device)
    check(bench_encodes, "rados bench: no K1 encode")
    b = round(statistics.fmean(s for s, _ in bench_encodes))
    su = bench_encodes[0][1] * 4
    codec = load_codec(CL_EC_PROFILE, device=device)
    timed.update(batch_times(codec.device, rng, codec, b, su, "tools_bench_wb",
                             ("write", "crc")))
    return {"lines": lines, "launches": launches, "timed": timed,
            "seconds": {"tools": phase_s,
                        "tools_times": time.perf_counter() - t0}}


def tl_rule_times(tree, cli: dict, device=None) -> dict:
    """K4 at crushtool's inputs (0..TL_CRUSH_X-1, every OSD in) for each
    rule: its rows' placed and bad-mapping counts against the CLI's
    (``cli``, ``tl_crush``'s), its first TL_CRUSH_HEAD rows and draws
    against the plain engine on the card, then timed at TL_CRUSH_X (CUDA
    events, device ms, the bound from the draws the kernel counted)."""
    from ceph_tpu_torch.device import resolve
    from ceph_tpu_torch.placement import bulk

    dev = resolve(device)
    comp = bulk.CompiledMap(tree)
    arrays = comp.arrays_on(dev)
    rw_t = torch.full((PL_OSDS,), 0x10000, dtype=torch.int32, device=dev)
    xs_t = torch.arange(TL_CRUSH_X, dtype=torch.int32, device=dev)
    head = xs_t[:TL_CRUSH_HEAD]
    timed = {}
    for name, (rule, numrep) in PL_RULES.items():
        rc = comp.compile_rule(rule, numrep)
        kd = torch.zeros(1, dtype=torch.int64, device=dev)
        pd = torch.zeros(1, dtype=torch.int64, device=dev)
        got = bulk.rule_rows(comp, rw_t, head, rc, numrep, kd)
        want = bulk.rule_rows_plain(comp, rw_t, head, rc, numrep, pd)
        err = max_abs_err(got, want)
        check(err == 0 and int(kd.item()) == int(pd.item()),
              f"crushtool {name}: K4 and the plain engine differ by {err} "
              f"(draws {int(kd.item())} / {int(pd.item())})")
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        rows = bulk.rule_rows(comp, rw_t, xs_t, rc, numrep, count)
        valid = (rows >= 0) & (rows < comp.max_devices)
        placed = int(valid.sum().item())
        bad = int((valid.sum(dim=1) < numrep).sum().item())
        check((placed, bad) == (cli[name]["placed"],
                                cli[name]["bad_mappings"]),
              f"crushtool {name}: the CLI placed {cli[name]['placed']} "
              f"with {cli[name]['bad_mappings']} bad mappings, the "
              f"kernel's rows {placed} and {bad}")
        del rows, valid

        def kernel(rc=rc, numrep=numrep):
            return bulk.rule_rows(comp, rw_t, xs_t, rc, numrep)
        ms = time_ms(kernel, reps=5, warmup=1)
        nbytes = (arrays[0].numel() * 8.0 + 8.0 * arrays[2].numel()
                  + 4.0 * PL_OSDS + 4.0 * TL_CRUSH_X * (1 + numrep))
        b_ms, b_by = rule_bound(int(count.item()), nbytes)
        prof = profile_steps(kernel, reps=3, pads=BT_PADS)
        key = f"crush_rule_tools_{name}"
        timed[key] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                      "draws": int(count.item()), "device_ms":
                      device_ms(prof), "max_abs_err": None,
                      "head_max_abs_err": err,
                      "head_inputs": TL_CRUSH_HEAD,
                      "group": bulk.group_width(comp.widest(-1), TL_CRUSH_X,
                                                bulk.card_lanes(dev))
                      if dev.type == "cuda" else None}
        emit({"phase": "time", "what": key, "inputs": TL_CRUSH_X,
              **timed[key], "share_of_bound": b_ms / ms,
              "profile": {k: prof[k] for k in PROFILE_CLOCK}})
    return timed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # The deployments (the EC batchers of phase ecbatch on, and the OSD
    # daemons of phase proc, which inherit it) run their codecs' "auto"
    # backend on the device engine, whatever phase corpus's probe picks:
    # each of them gates on K1/K2 launches in every step.
    os.environ["CEPH_TPU_EC_ENGINE"] = "device"

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

    for what, (was, now) in SCRIPT_CUTS.items():
        emit({"phase": "cut", "what": what, "from": was, "to": now})

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
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=PLAIN_REPS, warmup=1)
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

    # ---- phase 10b: the golden EC corpus replayed through the codecs on
    # the card (both arms), the engine probe's verdict, the port's lint
    t0 = time.perf_counter()
    cp = corpus_phase(smi.splitlines()[0], rng)
    timed.update(cp["timed"])
    seconds["corpus"] = time.perf_counter() - t0

    # ---- phase 11: the cluster wire carrying the EC fan-out (K1 and K2
    # through the ECBatcher) over LocalBus, TCP, signed TCP and shm
    t0 = time.perf_counter()
    import importlib.util

    emit({"phase": "msg", "transport": "tcp_secure", "skipped":
          ("left out: secure mode imports the cryptography package, which "
           "this machine does not have"
           if importlib.util.find_spec("cryptography") is None else
           "left out of MSG_TRANSPORTS for the script's time budget "
           "(850 s)")
          + "; tests/test_torch_auth.py runs it on the CPU"})
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

    # ---- phase 13: the client services (osdc/, services/) on that
    # deployment: FSLite, the striper and SQLite on the EC pool (K1, K2),
    # RBD with a snapshot, a clone and a mirror, and RGW over HTTP on the
    # replicated pool, then a degraded read (K1 rebuilds)
    t0 = time.perf_counter()
    sv = services_phase(smi.splitlines()[0], rng)
    for key in ("gf_matmul", "crc32c", "crush_rule"):
        check(sv["launches"][key] > 0,
              f"the services phase launched {key} {sv['launches'][key]} "
              "times")
    seconds["services"] = time.perf_counter() - t0
    # K1 and K2 alone at the batches that phase made
    t0 = time.perf_counter()
    sv_timed = sv_batch_times(sv["lines"], rng)
    timed.update(sv_timed)
    seconds["services_times"] = time.perf_counter() - t0

    # ---- phase 14: the cluster tier across processes (3 Paxos mons, 12
    # OSD daemons on the card, each with its own CUDA context) over shm,
    # then TCP
    t0 = time.perf_counter()
    pr = proc_phase(smi.splitlines()[0], rng)
    for key in ("gf_matmul", "crc32c", "crush_rule"):
        check(pr["launches"][key] > 0,
              f"the proc phase launched {key} {pr['launches'][key]} times")
    seconds["proc"] = time.perf_counter() - t0

    # ---- phase 15: the multi-device data plane (parallel/) on a virtual
    # mesh of 8 slots over the card: K1 and K2 on every slot, the copies
    # between slots and K6's XOR combines
    t0 = time.perf_counter()
    mesh = mesh_phase(dev, rng, smi.splitlines()[0],
                      cluster_lines=cl["lines"])
    timed.update(mesh["timed"])
    seconds["mesh"] = time.perf_counter() - t0

    # ---- phase 16: the CephFS metadata daemon (services/mds.py), two
    # ranks in one process on phase services' deployment, then as daemon
    # processes (in phase proc's TCP cluster where they fit)
    t0 = time.perf_counter()
    md = mds_phase(smi.splitlines()[0], rng)
    for key in ("gf_matmul", "crc32c", "crush_rule"):
        check(md["launches"][key] > 0,
              f"the mds phase launched {key} {md['launches'][key]} times")
    seconds["mds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    md_timed = sv_batch_times(md["lines"], rng, table=MD_TIMED)
    timed.update(md_timed)
    seconds["mds_times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = pr["mds"]
    if mp is None:
        mp = mds_proc_phase(smi.splitlines()[0], rng)
        seconds["mds_proc"] = time.perf_counter() - t0
    mp_check(mp)

    # ---- phase 17: the operator CLIs (tools/), each through its main
    tl = tools_phase(smi.splitlines()[0], rng)
    timed.update(tl["timed"])
    seconds.update(tl["seconds"])
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
        paths["corpus"] = cp["launches"][name]
        paths["msg"] = wire["launches"][name]
        paths["cluster"] = cl["launches"][name]
        paths["services"] = sv["launches"][name]
        paths["proc"] = pr["launches"][name]
        paths["mesh"] = mesh["launches"][name]
        paths["mds"] = md["launches"][name] + mp["launches"][name]
        paths["tools"] = tl["launches"][name]
        return paths

    # the batcher batches K1 and K2 were timed at on the cluster and
    # services paths
    ec_gf = [*(f"gf_{t}_{s}" for t in CL_TIMED for s in ("write", "decode")),
             *(k for k in (*sv_timed, *md_timed, *tl["timed"])
               if k.startswith("gf_"))]
    ec_crc = [*(f"crc_{t}_write" for t in CL_TIMED),
              *(k for k in (*sv_timed, *md_timed, *tl["timed"])
                if k.startswith("crc_"))]
    cp_gf = [k for k in cp["timed"] if k.startswith("gf_")]
    cp_crc = [k for k in cp["timed"] if k.startswith("crc_")]
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
                            *(timed[k]["max_abs_err"] for k in ec_gf),
                            *(timed[k]["max_abs_err"] for k in cp_gf),
                            timed["gf_mesh_repair"]["max_abs_err"],
                            timed["gf_mesh_write"]["max_abs_err"]),
         "library_ms": None, "launches_by_path": by_path("gf_matmul"),
         "shapes": shapes("gf_write", "gf_repair", "gf_batch_write",
                          "gf_batch_decode", "gf_lrc_encode",
                          "gf_clay_round",
                          *ec_gf, *cp_gf,
                          "gf_mesh_repair", "gf_mesh_write")},
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
                            *(timed[k]["max_abs_err"] for k in ec_crc),
                            *(timed[k]["max_abs_err"] for k in cp_crc),
                            timed["crc_mesh_write"]["max_abs_err"]),
         "library_ms": None, "launches_by_path": by_path("crc32c"),
         "shapes": shapes("crc_write", "crc_repair", "crc_checksummer",
                          "crc_batch_write", "crc_lrc_encode",
                          *(f"crc_store_{k}" for k in ST_SHAPES),
                          *ec_crc, *cp_crc,
                          "crc_mesh_write")},
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
                              "cluster": cl["launches"]["straw2"],
                              "services": sv["launches"]["straw2"],
                              "proc": pr["launches"]["straw2"],
                              "mesh": mesh["launches"]["straw2"]},
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
               for r in PL_RULES),
             *(timed[f"crush_rule_tools_{r}"]["head_max_abs_err"]
               for r in PL_RULES)),
         "library_ms": None,
         "launches_by_path": {"placement": pl["launches"]["crush_rule"],
                              "cluster": cl["launches"]["crush_rule"],
                              "services": sv["launches"]["crush_rule"],
                              "proc": pr["launches"]["crush_rule"],
                              "mesh": mesh["launches"]["crush_rule"],
                              "mds": md["launches"]["crush_rule"]
                              + mp["launches"]["crush_rule"],
                              "tools": tl["launches"]["crush_rule"]},
         "shapes": shapes(*(f"crush_rule_{r}_{s}" for r in PL_RULES
                            for s in ("full", "65536", "64")),
                          *(f"crush_rule_tools_{r}" for r in PL_RULES))},
        {"name": "gf2_xor", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf2_xor.cu",
         "replaces": "ceph_tpu/ops/gf2.py:62",
         "launches": cd["launches"]["gf2_xor"], **timed["gf2_encode"],
         "max_abs_err": max(cd["edge_err"],
                            timed["gf2_encode"]["max_abs_err"],
                            timed["gf2_decode"]["max_abs_err"]),
         "library_ms": None,
         "launches_by_path": {"codecs": cd["launches"]["gf2_xor"],
                              "cluster": cl["launches"]["gf2_xor"],
                              "services": sv["launches"]["gf2_xor"],
                              "proc": pr["launches"]["gf2_xor"]},
         "shapes": shapes("gf2_encode", "gf2_decode")},
    ] + [
        {"name": entry, "route": "cuda",
         "source": "ceph_tpu_torch/csrc/xor_combine.cu",
         "replaces": K6_REPLACES[entry],
         "launches": mesh["launches"][entry], **timed[f"k6_{entry}"],
         "max_abs_err": max(mesh["edge_err"],
                            timed[f"k6_{entry}"]["max_abs_err"]),
         "library_ms": None,
         "launches_by_path": {"services": sv["launches"][entry],
                              "mesh": mesh["launches"][entry]}}
        for entry in K6_ENTRIES]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
