"""send/commit pipelining discipline (the write-path batching seams).

Two inverse-of-batching hazards, both of which quietly re-serialize a
path this codebase spent PRs un-serializing:

- **per-frame drain in a send loop** (``ceph_tpu_torch/msg/``): an ``await
  <writer>.drain()`` inside a ``for``/``while`` body pays one flush
  barrier per frame — a k=8,m=3 fan-out then costs 11 serialized
  syscall round-trips. All bulk sends must ride the corked writer
  (messenger.py ``_writer_bursts``: queue, ONE write, ONE drain per
  burst), which is the single allowlisted drain-in-loop site.

- **direct WAL flush outside the group-commit path**
  (``ceph_tpu_torch/store/``): a ``<x>._wal.flush()`` (or ``fsync`` of the
  WAL fd) anywhere but the committer's flush hook re-introduces
  one-flush-per-transaction durability behind the
  ``store_commit_window_ms`` knob's back — the group pays the barrier,
  nobody else. ``_flush_wal`` is the allowlisted site.

Handshake writes (one frame, awaited reply) are not loops and stay
clean by construction.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_pipeline.py``.
Changed: the scopes, ``ceph_tpu_torch/msg/`` and ``ceph_tpu_torch/store/``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, call_name, register

#: functions allowed to drain inside a loop: the corked writer itself
#: (one drain per BURST — the loop iterates bursts, not frames)
_CORKED_WRITERS = frozenset(("_writer_bursts",))

#: functions allowed to flush/fsync the WAL: the group committer's
#: flush hook, plus the two checkpoint barriers that are about WAL
#: TRUNCATION durability, not per-transaction commit (mount's
#: torn-tail discard, compact's post-snapshot truncate)
_WAL_FLUSHERS = frozenset(("_flush_wal", "mount", "compact"))


def _is_drain_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "drain"
            and not node.args and not node.keywords)


def _is_wal_flush(node: ast.AST) -> bool:
    """<anything>._wal.flush() / os.fsync(<anything>._wal.fileno())."""
    if not isinstance(node, ast.Call):
        return False
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in ("flush", "fsync")
            and isinstance(node.func.value, ast.Attribute)
            and node.func.value.attr == "_wal"):
        return True
    if call_name(node.func) == "os.fsync" and node.args:
        arg = node.args[0]
        return (isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Attribute)
                and arg.func.attr == "fileno"
                and isinstance(arg.func.value, ast.Attribute)
                and arg.func.value.attr == "_wal")
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, in_msg: bool, in_store: bool):
        self.path = path
        self.in_msg = in_msg
        self.in_store = in_store
        self.scope: list[str] = []
        self.loop_depth = 0
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
        outer, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = outer
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _visit_loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_Await(self, node: ast.Await) -> None:
        if (self.in_msg and self.loop_depth > 0
                and _is_drain_call(node.value)
                and self._fn_name() not in _CORKED_WRITERS):
            self.findings.append(Finding(
                "send-discipline", self.path, node.lineno, self.symbol,
                "per-frame `await ...drain()` in a send loop: one "
                "flush barrier per frame re-serializes the fan-out — "
                "route bulk sends through the corked writer (queue + "
                "one drain per burst)",
            ))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if (self.in_store and _is_wal_flush(node)
                and self._fn_name() not in _WAL_FLUSHERS):
            self.findings.append(Finding(
                "send-discipline", self.path, node.lineno, self.symbol,
                "direct WAL flush/fsync outside the group-commit "
                "path: per-transaction barriers bypass "
                "store_commit_window_ms — flush only via the "
                "committer's flush hook",
            ))
        self.generic_visit(node)


@register
class SendDisciplineRule(Rule):
    """Corked-send + group-commit discipline for the write path."""

    id = "send-discipline"

    def applies(self, path: str) -> bool:
        return path.startswith(("ceph_tpu_torch/msg/",
                                "ceph_tpu_torch/store/"))

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        v = _Visitor(path, in_msg=path.startswith("ceph_tpu_torch/msg/"),
                     in_store=path.startswith("ceph_tpu_torch/store/"))
        v.visit(tree)
        yield from v.findings
