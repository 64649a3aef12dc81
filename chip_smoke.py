#!/usr/bin/env python3
"""Smoke run of ceph_tpu_torch on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Builds both CUDA kernels from ``ceph_tpu_torch/csrc`` with nvcc, holds each
against its plain PyTorch version on the card (exact equality: the
functions are integer-only), drives the main path at full width -- the
batched EC write and repair steps on k=8, m=3, 512 KiB chunks (4 MiB
stripes), B=256 stripes (1 GiB) per step, the rs_tpu codec and the
crc32c Checksummer over 16,384 x 64 KiB blobs -- and checks the results,
shows that the main path launched both kernels, times each kernel at the
write, repair and Checksummer shapes, its plain version and each step with
CUDA events, and checks from a torch.profiler trace that the write step
(which CRCs data and parity where they lie) launches no copy kernel.

Every phase prints one JSON line. The line before the last is the kernel
table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; it also exits nonzero when no CUDA
device is present. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15

KIB = 1024
MAIN_B, MAIN_K, MAIN_M, MAIN_CHUNK = 256, 8, 3, 512 * KIB
PRESENT = (0, 2, 3, 4, 5, 7, 8, 9)  # data shards 1 and 6 lost
CSUM_BLOCK, CSUM_BLOBS = 64 * KIB, 16384
DEVICE = "cuda"


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


def profile_steps(step, reps: int = 10) -> dict:
    """Run ``step`` ``reps`` times back to back under torch.profiler: the
    device time per step of each kernel, and the share of the window from
    the first to the last device event in which the card was idle (null
    when the profiler records no device events)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            name = name.split("::")[-1]
            per_kernel[name] = per_kernel.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    if not spans:
        return {"device_events": 0, "idle_share": None, "ms_per_step": {}}
    window = max(s.end for s in spans) - min(s.start for s in spans)
    busy = sum(s.end - s.start for s in spans)
    return {"device_events": len(spans), "idle_share": 1 - busy / window,
            "window_ms": window / 1e3, "ms_per_step": per_kernel}


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
    csums = Checksummer("crc32c", CSUM_BLOCK).calculate(csum_data)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    emit({"phase": "main_path_launches", **launches})
    for k, n in launches.items():
        check(n > 0, f"main path launched {k} {n} times")

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
        timed[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err}
        emit({"phase": "time", "what": key, **timed[key],
              "GB_per_s": nbytes / ms / 1e6, "share_of_bound": b_ms / ms})
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

    def shapes(*keys):  # every main-path shape a kernel was timed at
        return {k.split("_", 1)[1]: {f: timed[k][f] for f in
                                     ("ms", "plain_ms", "bound_ms", "bound_by")}
                for k in keys}

    table = [
        {"name": "gf_matmul", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf_matmul.cu",
         "replaces": "ceph_tpu/ops/rs.py:348",
         "launches": launches["gf_matmul"], **timed["gf_write"],
         "max_abs_err": max(errs["gf_matmul"], timed["gf_write"]["max_abs_err"],
                            timed["gf_repair"]["max_abs_err"]),
         "library_ms": None, "shapes": shapes("gf_write", "gf_repair")},
        {"name": "crc32c", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/crc32c.cu",
         "replaces": "ceph_tpu/ops/crc32c.py:231",
         "launches": launches["crc32c"], **timed["crc_write"],
         "max_abs_err": max(errs["crc32c"], timed["crc_write"]["max_abs_err"],
                            timed["crc_repair"]["max_abs_err"],
                            timed["crc_checksummer"]["max_abs_err"]),
         "library_ms": None,
         "shapes": shapes("crc_write", "crc_repair", "crc_checksummer")},
    ]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
