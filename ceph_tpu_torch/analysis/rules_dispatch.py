"""dispatch-discipline: per-op host placement on the serving plane.

The serving plane routes EVERY placement lookup through the batched
PlacementResolver (placement/resolver.py): epoch-keyed memo hits on the
op path, misses coalesced into device bulk-CRUSH dispatches, host
straw2 only as the resolver's own fallback.  A direct per-op call into
the host placement pipeline from the client or the osdc tier —
``osdmap.pg_to_up_acting_osds(...)``, ``crush.do_rule(...)``, a freshly
constructed ``PlacementMemo`` — silently reintroduces the per-op Python
descent the round-10 serving-plane pass removed, and no test catches it
(the result is identical, just slower and un-batched).  This family
makes that regression a lint failure.

Scope: ``ceph_tpu_torch/cluster/client.py`` and
``ceph_tpu_torch/osdc/`` — the
client-side op path.  Daemon/mon/tool code legitimately calls the map
directly (the mon EDITS maps in place; tools run without an event
loop), so the scope is deliberately narrow.  The resolver itself lives
in ``ceph_tpu_torch/placement/`` and is outside the scope by construction.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_dispatch.py``.
Changed: the scopes, the port's ``cluster/client`` and ``osdc/``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, ScopedVisitor, call_name, register

_SCOPES = ("ceph_tpu_torch/cluster/client", "ceph_tpu_torch/osdc/")

#: host placement-pipeline entry points whose per-op use on the client
#: path bypasses the batched resolver
_HOST_PLACEMENT_CALLS = frozenset((
    "pg_to_up_acting_osds", "pg_to_up_acting_full", "pg_to_raw_osds",
    "object_to_up_osds", "do_rule", "straw2_bulk",
))

#: constructing a raw per-epoch memo instead of the resolver loses the
#: batched miss path and the serving-plane counters
_BANNED_CTORS = frozenset(("PlacementMemo",))


@register
class DispatchDisciplineRule(Rule):
    id = "dispatch-discipline"

    def applies(self, path: str) -> bool:
        return any(path.startswith(s) or f"/{s}" in f"/{path}"
                   for s in _SCOPES)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        rule_id = self.id
        findings: list[Finding] = []

        class V(ScopedVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                name = call_name(node.func)
                leaf = name.rpartition(".")[2]
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _HOST_PLACEMENT_CALLS):
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"per-op host placement `{node.func.attr}` on "
                        "the client path — route lookups through the "
                        "batched PlacementResolver"))
                elif leaf in _BANNED_CTORS:
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"`{leaf}` on the client path — use "
                        "PlacementResolver (same memo, plus the "
                        "batched miss path and counters)"))
                self.generic_visit(node)

        V().visit(tree)
        return iter(findings)
