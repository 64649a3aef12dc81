"""tpulint: AST-based static analysis for kernel hygiene and
distributed-correctness invariants.

The hot paths of this tree — GF(2^8) erasure matmuls, batched CRC32C,
straw2 placement — are won or lost at the code-structure level (the
arXiv:2108.02692 lesson): a single host sync inside a device function
or a float dtype in a GF(2^8) path silently destroys the whole point of
the port. Nothing in the type system stops such a PR; this package
does, statically, with nothing but the stdlib ``ast`` module.

Rule families (each a plugin in the registry, mirroring the
ErasureCodePlugin/Checksummer seam):

- ``trace-safety``  — host syncs inside the CUDA kernels' launch
  wrappers and their callers (rules_trace.py);
- ``dtype``         — implicit or float dtypes where GF(2^8)/CRC
  word-size discipline is required (rules_dtype.py);
- ``wire-parity``   — encode/decode field-order asymmetry in the wire
  layer (rules_wire.py);
- ``lock-discipline`` — shared-state writes outside the owning lock
  and blocking calls made while holding one (rules_lock.py);
- ``send-discipline``, ``buffer-discipline``, ``mesh-discipline``,
  ``dispatch-discipline``, the two hedge and the three fabric families
  (rules_pipeline.py, rules_buffer.py, rules_mesh.py,
  rules_dispatch.py, rules_hedge.py, rules_fabric.py).

Grandfathered findings live in a committed baseline
(ceph_tpu_torch/tools/tpulint_baseline.json); anything NEW fails the
tier-1 gate (tests/test_torch_tpulint.py). CLI: ``python -m
ceph_tpu_torch.tools.tpulint``.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/``: the rules read the
port's paths, and the three families that named JAX (trace-safety,
dtype, mesh-discipline) read the same hazards in torch's spellings;
each module's docstring says what changed.
"""
from __future__ import annotations

from .baseline import load_baseline, save_baseline, unbaselined
from .core import (
    Finding,
    Rule,
    RuleRegistry,
    instance,
    lint_source,
    preload,
    register,
    run_paths,
)

__all__ = [
    "Finding",
    "Rule",
    "RuleRegistry",
    "instance",
    "register",
    "preload",
    "run_paths",
    "lint_source",
    "load_baseline",
    "save_baseline",
    "unbaselined",
]
