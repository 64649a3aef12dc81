"""buffer-discipline: no byte-string coercion on message/payload paths.

The buffer plane (utils/buffer.py) moves payloads as scatter/gather
views — ``BufferList`` segments, memoryviews, contiguous ndarrays —
and flattens exactly once, at a sanctioned boundary (socket write, WAL
fsync, blob checksum, compat API edge). Every ``bytes(...)`` or
``.tobytes()`` on a payload path re-buys the copy that seam was built
to kill, and it does so silently: the code still works, just one
memcpy slower per hop, which is exactly how the pre-buffer-plane write
path accreted its 2000x device/system gap.

The rule flags, on the message/payload paths
(``ceph_tpu_torch/msg/`` and
the cluster hot-path modules):

- ``bytes(x)`` coercion of something NAMED like a payload (``data``,
  ``payload``, ``buf``, ``chunk``, ``body`` — a name/oid/key coercion
  is an identity-producing boundary, not a payload copy, and a
  literal-int size alloc like ``bytes(16)`` is not a coercion at all);
- ``<x>.tobytes()`` ndarray/memoryview materialization (arrays on
  these paths ARE payloads).

Sanctioned flatten boundaries are allowlisted by function name (the
same shape the send-discipline family uses for the corked writer);
remaining pre-existing sites are grandfathered in the ratcheted
baseline — fix them when touched, never add new ones.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_buffer.py``.
Changed: the scopes, the port's ``msg/`` and its cluster hot-path
modules.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, register

#: cluster modules that ARE the payload hot path (the op pipeline);
#: everything else under cluster/ is control plane and stays out of
#: scope until it earns a seam
_CLUSTER_HOT = (
    "ceph_tpu_torch/cluster/pg.py",
    "ceph_tpu_torch/cluster/client.py",
    "ceph_tpu_torch/cluster/osd.py",
    "ceph_tpu_torch/cluster/messages.py",
    "ceph_tpu_torch/cluster/pglog.py",
)

#: functions allowed to materialize bytes: the buffer plane's own
#: flatten entry points, the sanctioned per-tier boundaries (socket
#: burst flatten for HMAC/GCM, compression, handshake parse, snapshot
#: isolation of mutable storage), and the client's compat API edge
_FLATTEN_BOUNDARIES = frozenset((
    "flatten", "tobytes", "__bytes__",
    "encode_frame", "_send_now", "_writer_bursts",
    "parse_hello", "snapshot", "_snap_value",
    # legacy flat encoders + the op-vector normalization edge: these
    # ARE the marshal boundary for callers that need flat bytes
    "_enc_osd_op", "osd_op",
))

_MSG_COERCION = (
    "bytes(...) payload coercion on a message/payload path: pass the "
    "view/BufferList through the seam and flatten only at a "
    "sanctioned boundary"
)
_MSG_TOBYTES = (
    ".tobytes() materialization on a message/payload path: hand the "
    "array/view itself to the seam (transactions, messages and the "
    "store all take views)"
)


#: identifier fragments that mark a value as payload-shaped; anything
#: else (oids, keys, names) is identity data whose bytes() coercion is
#: cheap and often REQUIRED (dict keys must hash)
_PAYLOAD_NAMES = ("data", "payload", "buf", "chunk", "body")


def _payload_named(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        ident = node.attr
    elif isinstance(node, ast.Name):
        ident = node.id
    else:
        return False
    ident = ident.lower()
    return any(p in ident for p in _PAYLOAD_NAMES)


def _is_bytes_coercion(node: ast.Call) -> bool:
    if not (isinstance(node.func, ast.Name) and node.func.id == "bytes"):
        return False
    if len(node.args) != 1 or node.keywords:
        return False
    return _payload_named(node.args[0])


def _is_tobytes(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "tobytes"
            and not node.args and not node.keywords)


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.scope: list[str] = []
        self.findings: list[Finding] = []

    @property
    def symbol(self) -> str:
        return ".".join(self.scope) or "<module>"

    def _fn_name(self) -> str:
        return self.scope[-1] if self.scope else ""

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
        if self._fn_name() not in _FLATTEN_BOUNDARIES:
            if _is_bytes_coercion(node):
                self.findings.append(Finding(
                    "buffer-discipline", self.path, node.lineno,
                    self.symbol, _MSG_COERCION))
            elif _is_tobytes(node):
                self.findings.append(Finding(
                    "buffer-discipline", self.path, node.lineno,
                    self.symbol, _MSG_TOBYTES))
        self.generic_visit(node)


@register
class BufferDisciplineRule(Rule):
    """Zero-copy discipline for the buffer plane's payload paths."""

    id = "buffer-discipline"

    def applies(self, path: str) -> bool:
        return (path.startswith("ceph_tpu_torch/msg/")
                or path in _CLUSTER_HOT
                or (path.startswith("ceph_tpu_torch/cluster/")
                    and path.endswith("fixture.py")))

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        v = _Visitor(path)
        v.visit(tree)
        yield from v.findings
