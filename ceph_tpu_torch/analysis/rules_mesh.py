"""mesh-discipline: no host readback inside the mesh data path.

The multi-chip serving path (parallel/runtime.py + the ECBatcher's
mesh mode) exists so batched stripes stay device-resident: staging is
sharded onto the mesh, the fused encode+CRC and the collective repair
produce every shard row on the chip that owns it, and results cross
back to the host ONLY as per-device shard views at the sanctioned
boundary (``shard_rows_to_host``), or through the counted
``host_gather`` escape hatch. A stray ``.cpu()`` or a
whole-array ``np.asarray`` in that path silently re-buys the gather
the mesh was built to kill — the code still works, it just serializes
every dispatch through one host buffer, exactly the failure mode the
buffer-discipline family guards against one layer down.

The rule flags, inside ``ceph_tpu_torch/parallel/`` and the batcher module
(``ceph_tpu_torch/cluster/ecbatch.py``):

- a tensor's whole-result readbacks: ``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``.item()`` and ``.to("cpu")``;
- ``np.asarray(...)`` / ``np.array(...)`` coercions (the readback
  spelling a CPU tensor answers to) outside a sanctioned boundary.

Sanctioned boundaries, by function name: the per-device view reader
(``shard_rows_to_host``), the counted gather (``host_gather``), the
single-device engine boundary the batcher already owns
(``_encode_sync`` / ``_decode_sync`` and the ``_dispatch_block``
row-block closures of the over-decomposed dispatch — their mesh
siblings are NOT sanctioned, they must route through the view
reader), and the two host-side helpers that touch device lists, not
data (``make_mesh``, ``_platform_healthy``).

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_mesh.py``, over
the port's ``parallel/`` and ``cluster/ecbatch.py``, with the same
sanctioned boundaries. Changed: the port's tensors have no
``jax.device_get``; their whole-result readbacks are the five tensor
methods above, which take its place, each with its own finding.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, call_name, register

_SCOPE_PREFIX = "ceph_tpu_torch/parallel/"
_SCOPE_FILES = ("ceph_tpu_torch/cluster/ecbatch.py",)

_SANCTIONED = frozenset((
    "shard_rows_to_host", "host_gather",
    "_encode_sync", "_decode_sync", "_repair_sync",
    "_dispatch_block",
    "make_mesh", "_platform_healthy",
))

_MSG_READBACK = (
    "readback inside the mesh data path: results must cross to the "
    "host as per-device shard views (shard_rows_to_host) or through "
    "the counted host_gather boundary"
)
_MSG_ASARRAY = (
    "whole-array np.asarray/np.array readback inside the mesh data "
    "path: gathers a sharded result through one host buffer — consume "
    "per-device shard views at a sanctioned boundary instead"
)

_ASARRAY_NAMES = frozenset(("np.asarray", "np.array", "numpy.asarray",
                            "numpy.array"))
#: tensor methods that read a whole result back to the host
_READBACKS = frozenset(("cpu", "numpy", "tolist", "item"))


def _readback(node: ast.Call) -> str | None:
    """``.cpu()`` / ``.numpy()`` / ``.tolist()`` / ``.item()`` /
    ``.to("cpu")`` (also ``device="cpu"``, ``torch.device("cpu")``)."""
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr in _READBACKS and not node.args:
        return f".{attr}()"
    if attr == "to":
        args = [*node.args, *(k.value for k in node.keywords
                              if k.arg == "device")]
        for a in args:
            if (isinstance(a, ast.Call)
                    and call_name(a.func) == "torch.device" and a.args):
                a = a.args[0]
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return '.to("cpu")'
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.scope: list[str] = []
        self.findings: list[Finding] = []

    @property
    def symbol(self) -> str:
        return ".".join(self.scope) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        fn = self.scope[-1] if self.scope else ""
        if fn not in _SANCTIONED:
            name = call_name(node.func)
            readback = _readback(node)
            if readback is not None:
                self.findings.append(Finding(
                    "mesh-discipline", self.path, node.lineno,
                    self.symbol, f"`{readback}` {_MSG_READBACK}"))
            elif name in _ASARRAY_NAMES:
                self.findings.append(Finding(
                    "mesh-discipline", self.path, node.lineno,
                    self.symbol, _MSG_ASARRAY))
        self.generic_visit(node)


@register
class MeshDisciplineRule(Rule):
    """Device-residency discipline for the multi-chip data plane."""

    id = "mesh-discipline"

    def applies(self, path: str) -> bool:
        return path.startswith(_SCOPE_PREFIX) or path in _SCOPE_FILES

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        v = _Visitor(path)
        v.visit(tree)
        yield from v.findings
