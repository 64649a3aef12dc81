"""Multi-chip dry run of the port's full data-path step over a device mesh.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(encode + checksum + straw2 placement over an n-device (stripe, width)
mesh, then collective repair), on ceph_tpu_torch:

    python3 -m ceph_tpu_torch.tools.dryrun_multichip [--devices 8]
        [--device cuda|cpu]

The mesh has n slots: n cards where the machine has them, else a virtual
mesh of n slots on ``--device`` (``parallel.pin_virtual``; the card
unless named). Shapes are the reference's: k=8, m=3, 64 KiB chunks, at
least 64 stripes, a 64-OSD straw2 bucket. The steps, each checked
against the same step on one device:

- encode and CRC (K1 and K2 on every slot, K6 joining the width
  segments' CRCs);
- straw2 primaries per stripe slot (K3);
- the scrub digest, an XOR over the batch of the CRCs: K6 ``xor_fold``
  in each slot, then across the stripe slots;
- distributed repair of two lost data chunks, ``allgather`` and
  ``psum_bits`` (K1 on each slot's column block, copies, K6).

Prints one JSON line and exits 0 when every check holds.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import native, parallel
from ..device import resolve, tensor_to_words
from ..models import datapath
from ..ops import crush, rs, xor_combine
from ..parallel import runtime, shard_comm


def _width(n: int) -> int:
    return (4 if n % 4 == 0 and n >= 4
            else 2 if n % 2 == 0 and n > 1 else 1)


def _digest(crcs: parallel.Sharded) -> parallel.Sharded:
    """XOR over the batch of per-stripe CRCs (B, k+m): each slot folds its
    stripe block, then each slot folds its width column's stripe blocks
    (copies onto the slot, then K6)."""
    mesh = crcs.mesh
    n_w = mesh.shape[parallel.WIDTH_AXIS]
    local = [xor_combine.xor_fold(s.data) for s in crcs.shards]
    events = [shard_comm.mark(s.slot.device) for s in crcs.shards]
    out = []
    for p, shard in enumerate(crcs.shards):
        col = mesh.position(p)[1]
        parts = shard_comm.gather(local[col::n_w], events[col::n_w],
                                  shard.slot.device)
        out.append(xor_combine.xor_fold(parts))
    shape = (crcs.shape[1],)
    return parallel.Sharded(mesh, (), shape, [
        parallel.Shard(s.slot, (slice(0, shape[0]),), t)
        for s, t in zip(crcs.shards, out)])


@dataclass
class Step:
    """The dry run's inputs: the mesh, the code's parameters, the data
    batch and one object id per stripe, all on ``device``."""

    mesh: parallel.Mesh
    params: datapath.ECParams
    data: torch.Tensor
    xs: np.ndarray
    device: torch.device


def setup(n_devices: int = 8, device=None, chunk_bytes: int = 64 * 1024,
          min_stripes: int = 64) -> Step:
    """The mesh of n slots on ``device`` and the inputs of the step. The
    reference's shapes are the defaults (the CPU tests cut them)."""
    parallel.pin_virtual(n_devices)
    dev = resolve(device)
    mesh = parallel.make_mesh(parallel.get_devices(n_devices, dev),
                              width=_width(n_devices))
    params = datapath.ECParams(k=8, m=3, chunk_bytes=chunk_bytes)
    batch = max(min_stripes, parallel.pad_batch(n_devices, mesh))
    batch = -(-batch // n_devices) * n_devices  # keep mesh-divisible
    data = datapath.example_batch(params, batch=batch, seed=0, device=dev)
    return Step(mesh, params, data, np.arange(batch, dtype=np.uint32), dev)


def _straw2(xs: torch.Tensor) -> torch.Tensor:
    """Primaries of ``xs`` in a 64-OSD bucket of equal weights (K3)."""
    osds = torch.arange(64, dtype=torch.int32, device=xs.device)
    weights = torch.full((64,), 0x10000, dtype=torch.int32,
                         device=xs.device)
    return crush.straw2_choose(osds, osds, weights, xs, 0)


def one_device(step: Step) -> dict:
    """The step on one device, which the mesh is held against: the write
    step's parity and CRCs and the straw2 primaries."""
    parity, crcs = datapath.write_step(step.params, step.data)
    primary = _straw2(torch.from_numpy(step.xs.view(np.int32))
                      .to(step.device))
    return {"parity": parity, "crcs": crcs, "primary": primary}


def on_mesh(step: Step, want: dict) -> dict:
    """The step over the mesh; raise on any difference from ``want``
    (``one_device(step)``). Returns what it ran."""
    mesh, params, data = step.mesh, step.params, step.data

    # --- encode and CRC over the mesh, against the one-device write step
    parity, crcs = runtime.mesh_encode_crc_batch(
        mesh, params.matrix, params.chunk_bytes, data)
    got_parity = parity.numpy()
    got_crcs = crcs.numpy()
    if not np.array_equal(got_parity, tensor_to_words(want["parity"])):
        raise AssertionError("mesh parity differs from the one-device step")
    if not np.array_equal(got_crcs, tensor_to_words(want["crcs"])):
        raise AssertionError("mesh CRCs differ from the one-device step")
    # one stripe against the host reference
    d0 = tensor_to_words(data[0])
    if not np.array_equal(rs.unpack_u32(got_parity[0]),
                          native.rs_encode(params.matrix, rs.unpack_u32(d0))):
        raise AssertionError("mesh parity differs from the host reference")

    # --- straw2 primaries per stripe slot: one object id per stripe
    placed = parallel.per_stripe(mesh, step.xs)
    primary = parallel.Sharded(mesh, placed.spec, placed.shape, [
        parallel.Shard(s.slot, s.index, _straw2(s.data))
        for s in placed.shards])
    if not np.array_equal(primary.numpy().view(np.int32),
                          want["primary"].cpu().numpy()):
        raise AssertionError("mesh straw2 primaries differ from one device")

    # --- scrub digest: the sharded XOR must equal the host's plain XOR
    digest = _digest(crcs)
    want_digest = np.bitwise_xor.reduce(got_crcs, axis=0)
    for shard in digest.shards:
        if not np.array_equal(tensor_to_words(shard.data), want_digest):
            raise AssertionError("sharded XOR scrub digest differs from "
                                 "the host's")

    # --- distributed repair: TWO erased data chunks at k=8, m=3; the k
    # survivors (6 data + 2 parity) split across the width axis
    erased = (1, 3)
    present = ([i for i in range(params.k) if i not in erased]
               + [params.k, params.k + 1])
    every = torch.cat([data, want["parity"]], dim=1)
    surv = parallel.shard_placement(mesh, every[:, present])
    want_data = tensor_to_words(data)
    for method in shard_comm.METHODS:
        rec = shard_comm.distributed_repair(
            mesh, params.matrix, params.k, present, surv, method=method)
        runtime.finish(mesh)
        if not np.array_equal(rec.numpy(), want_data):
            raise AssertionError(
                f"distributed repair ({method}) differs from original")
    return {"mesh": dict(mesh.shape), "virtual": mesh.virtual,
            "device": str(step.device), "batch": data.shape[0],
            "k": params.k, "m": params.m, "chunk_bytes": params.chunk_bytes,
            "repair": list(shard_comm.METHODS), "ok": True}


def dryrun_multichip(n_devices: int = 8, device=None,
                     chunk_bytes: int = 64 * 1024,
                     min_stripes: int = 64) -> dict:
    """Run the step over an n-slot mesh on ``device``; raise on any
    difference from the one-device step. Returns what it ran."""
    step = setup(n_devices, device, chunk_bytes, min_stripes)
    return on_mesh(step, one_device(step))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph_tpu_torch.tools.dryrun_multichip",
                                 description=__doc__)
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh slots (default %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device of a virtual mesh (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.devices, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
