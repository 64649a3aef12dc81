"""Placement layer: CRUSH map model, rule engines, OSDMap pipeline.

- ``crushmap`` — map model (buckets/rules/tunables) + the host rule
  engine, a faithful port of crush_do_rule (reference src/crush/mapper.c:
  878-1083, choose_firstn :438, choose_indep :633). The host engine is
  the correctness oracle for the bulk engine.
- ``bulk`` — the bulk rule engine: the same semantics over large batches
  of placement inputs, on the card as one CUDA kernel launch
  (``csrc/crush_rule.cu``, north-star config 5: 10 M objects x 1 K OSDs),
  on the CPU as its plain torch version.
- ``osdmap`` — epoch-versioned cluster map: pools, OSD states, the
  object -> PG -> OSD pipeline (reference src/osd/OSDMap.cc:2638-2891),
  upmap overrides, incrementals.
- ``encoding`` / ``compiler`` / ``tester`` — wire form of the maps,
  crushtool text compile/decompile, and the placement simulator.
- ``resolver`` — the batched placement service of the serving plane:
  epoch-keyed memoized CRUSH results with misses resolved through the
  bulk engine in coalesced batches (clients and daemons route
  placement through it; per-op host straw2 is the fallback, never the
  path).
"""
from . import crushmap, osdmap, resolver  # noqa: F401
from .crushmap import CrushMap, Rule, Tunables  # noqa: F401
from .osdmap import OSDMap, Pool  # noqa: F401
from .resolver import PlacementResolver  # noqa: F401
