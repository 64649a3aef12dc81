"""hedge-discipline: straggler-proof fan-outs on the EC read path.

The cluster tier's EC sub-read fan-outs route through the shared
hedged-fanout helper (cluster/hedge.py): first-sufficient-subset
completion, EWMA-delayed extras, loser cancellation, and the
``ec_hedges_*`` counter ledger. A bare ``asyncio.gather`` over
``await_reply`` / ``_fetch_shard_copy`` calls re-introduces the
wait-for-the-slowest seam the hedging pass removed — byte-identical
results, silently tail-dominated latency, and no counters to show for
it. The write fan-outs are all-ack (every participant must land) and
legitimately gather; only the first-k read/reconstruct seams are in
scope, which is why the rule keys on the reply-wait callees rather
than on ``gather`` itself.

The companion rule catches the other way to lose a hedge: a
fire-and-forget ``create_task`` / ``ensure_future`` of a hedge
coroutine whose task is neither awaited nor retained. An orphaned
hedge can never be cancelled, so it leaks a pending reply expectation
and breaks the ``canceled == fired - won`` ledger invariant the
thrash verdict asserts.

Scope: ``ceph_tpu_torch/cluster/`` — the tier that owns sub-op fan-outs.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_hedge.py``.
Changed: the scope, ``ceph_tpu_torch/cluster/``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, ScopedVisitor, call_name, register

_SCOPE = "ceph_tpu_torch/cluster/"

#: reply-wait callees that mark a first-k completion seam: a gather
#: over these waits for the SLOWEST shard of a subset-decodable read
_REPLY_WAITS = frozenset(("await_reply", "_fetch_shard_copy"))

_SPAWNERS = frozenset(("create_task", "ensure_future"))


def _in_scope(path: str) -> bool:
    return path.startswith(_SCOPE) or f"/{_SCOPE}" in f"/{path}"


def _calls_in(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


@register
class HedgeFanoutRule(Rule):
    id = "hedge-fanout-discipline"

    def applies(self, path: str) -> bool:
        return _in_scope(path)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        rule_id = self.id
        findings: list[Finding] = []

        class V(ScopedVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                if call_name(node.func).rpartition(".")[2] == "gather":
                    waits = sorted({
                        call_name(c.func).rpartition(".")[2]
                        for a in node.args
                        for c in _calls_in(a)
                        if call_name(c.func).rpartition(".")[2]
                        in _REPLY_WAITS})
                    if waits:
                        findings.append(Finding(
                            rule_id, path, node.lineno, self.symbol,
                            "asyncio.gather over "
                            f"{'/'.join(waits)} waits for the slowest "
                            "shard of a first-k seam — route the "
                            "fan-out through hedged_fanout "
                            "(cluster/hedge.py)"))
                self.generic_visit(node)

        V().visit(tree)
        return iter(findings)


@register
class HedgeTaskRule(Rule):
    id = "hedge-task-discipline"

    def applies(self, path: str) -> bool:
        return _in_scope(path)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        rule_id = self.id
        findings: list[Finding] = []

        class V(ScopedVisitor):
            def visit_Expr(self, node: ast.Expr) -> None:
                # an Expr-statement call is fire-and-forget: its value
                # (the task handle) is discarded on the spot
                call = node.value
                if (isinstance(call, ast.Call)
                        and call_name(call.func).rpartition(".")[2]
                        in _SPAWNERS):
                    for arg in call.args[:1]:
                        for c in _calls_in(arg):
                            leaf = call_name(c.func).rpartition(".")[2]
                            if "hedge" in leaf.lower():
                                findings.append(Finding(
                                    rule_id, path, node.lineno,
                                    self.symbol,
                                    f"orphaned hedge task `{leaf}`: "
                                    "the discarded handle can never "
                                    "be cancelled, leaking a pending "
                                    "reply expectation and breaking "
                                    "canceled == fired - won"))
                self.generic_visit(node)

        V().visit(tree)
        return iter(findings)
