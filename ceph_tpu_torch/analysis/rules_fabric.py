"""fabric-discipline: the multi-process serving fabric's invariants.

Three hazards, one rule family each:

``fabric-spawn-discipline`` — no ``fork`` once the CUDA runtime may
have initialized.  A forked child inherits the parent's CUDA context
and device handles in an undefined state (CUDA does not survive a
fork); every fabric process must be a FRESH
interpreter (``subprocess.Popen``) or an explicit spawn-context
``multiprocessing``.  Flags ``os.fork``/``os.forkpty``, fork-method
``get_context``/``set_start_method``, and bare
``multiprocessing.Process``/``Pool`` (whose Linux default start
method is fork).

``fabric-pipe-pickle`` — the fabric results pipe carries JSON lines
of histogram bucket dicts (utils/lathist.py), NEVER pickled objects:
pickle across a version-skewed or partially-written pipe is an
arbitrary-code-execution surface and silently couples worker and
parent class layouts.  ``BufferList`` payloads stay in the data
plane; only summaries cross the control pipe.  Flags any
``pickle``/``cPickle``/``marshal`` use on the fabric surfaces
(``msg/``, ``cluster/procstart.py``, ``cluster/daemon.py``,
``tools/swarm.py``).

``fabric-shm-release`` — every shm ring consume path must release
its descriptors: a function that drains ``recv_all()`` and never
calls ``release()`` pins ring slots and arena extents until the
producer's free list starves (backpressure masquerading as a hang).
The idiomatic form copies out and releases in ``finally``.

Scope: ``ceph_tpu_torch/msg/``, ``ceph_tpu_torch/cluster/``,
``ceph_tpu_torch/utils/``, ``ceph_tpu_torch/tools/`` — the layers the
fabric traverses.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_fabric.py``.
Changed: the scopes move to the port's paths, and ``bench.py`` leaves
them (the port has no counterpart of it yet); the spawn rule guards
against CUDA's state where the reference names JAX's, the same hazard,
and its findings keep the reference's text.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, ScopedVisitor, call_name, register

_SCOPES = ("ceph_tpu_torch/msg/", "ceph_tpu_torch/cluster/",
           "ceph_tpu_torch/utils/", "ceph_tpu_torch/tools/")

_PIPE_SURFACES = ("ceph_tpu_torch/msg/", "cluster/procstart.py",
                  "cluster/daemon.py", "tools/swarm.py")


def _match(path: str, prefixes) -> bool:
    p = f"/{path}"
    return any(p.endswith(s) or f"/{s}" in p for s in prefixes)


@register
class FabricSpawnRule(Rule):
    id = "fabric-spawn-discipline"

    def applies(self, path: str) -> bool:
        return _match(path, _SCOPES)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        rule_id = self.id
        findings: list[Finding] = []

        class V(ScopedVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                name = call_name(node.func)
                tail = name.rpartition(".")[2]
                if name in ("os.fork", "os.forkpty"):
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"{name}() after a possible JAX runtime init "
                        "inherits device handles in an undefined "
                        "state — spawn a fresh interpreter "
                        "(subprocess.Popen) instead"))
                elif tail in ("get_context", "set_start_method") \
                        and any(isinstance(a, ast.Constant)
                                and a.value == "fork"
                                for a in node.args):
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"{tail}('fork') — the fabric is spawn-only; "
                        "a forked child deadlocks inside inherited "
                        "XLA state"))
                elif name in ("multiprocessing.Process",
                              "multiprocessing.Pool"):
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"bare {name} defaults to the fork start "
                        "method on Linux — use subprocess.Popen or "
                        "an explicit spawn context"))
                self.generic_visit(node)

        V().visit(tree)
        yield from findings


@register
class FabricPipePickleRule(Rule):
    id = "fabric-pipe-pickle"

    def applies(self, path: str) -> bool:
        return _match(path, _PIPE_SURFACES)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        rule_id = self.id
        findings: list[Finding] = []

        class V(ScopedVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                name = call_name(node.func)
                mod = name.partition(".")[0]
                if mod in ("pickle", "cPickle", "marshal") and \
                        name.rpartition(".")[2] in (
                            "dump", "dumps", "load", "loads"):
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"{name} on a fabric results-pipe surface — "
                        "the pipe carries JSON histogram summaries "
                        "only (utils/lathist.py), never pickled "
                        "objects or BufferLists"))
                self.generic_visit(node)

        V().visit(tree)
        yield from findings


@register
class FabricShmReleaseRule(Rule):
    id = "fabric-shm-release"

    def applies(self, path: str) -> bool:
        return _match(path, _SCOPES)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        rule_id = self.id
        findings: list[Finding] = []

        class V(ScopedVisitor):
            @staticmethod
            def _own_nodes(node) -> Iterator[ast.AST]:
                # this function's own statements, nested defs excluded
                # (a nested consumer is checked in its own scope)
                stack = list(ast.iter_child_nodes(node))
                while stack:
                    n = stack.pop()
                    yield n
                    if not isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        stack.extend(ast.iter_child_nodes(n))

            def _check_fn(self, node) -> None:
                consumes = None
                releases = False
                for sub in self._own_nodes(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    tail = call_name(sub.func).rpartition(".")[2]
                    if tail == "recv_all":
                        consumes = consumes or sub
                    elif tail in ("release", "reclaim_dead"):
                        releases = True
                if consumes is not None and not releases:
                    findings.append(Finding(
                        rule_id, path, consumes.lineno, self.symbol,
                        "recv_all() without a release() on any path "
                        "— unreleased shm descriptors pin ring slots "
                        "and arena extents until the producer "
                        "starves; copy out and release in finally"))

            def visit_FunctionDef(self, node) -> None:
                self._check_fn(node)
                self.generic_visit(node)

            def visit_AsyncFunctionDef(self, node) -> None:
                self._check_fn(node)
                self.generic_visit(node)

        V().visit(tree)
        yield from findings
