"""Analyzer core: Finding, Rule, the plugin registry, and the runner.

The registry mirrors ec/registry.py (ErasureCodePluginRegistry role):
rules self-register at import, ``preload`` pulls in the built-in set,
and the CLI/tests run whatever is registered — adding a rule family is
one module with a ``@register`` class, no runner changes.

Findings are keyed WITHOUT line numbers (rule:path:symbol:message) so
an unrelated edit higher in a file does not churn the committed
baseline; two identical findings in one symbol share a key and the
baseline stores a count.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/core.py``; nothing
changed but this paragraph.
"""
from __future__ import annotations

import ast
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str      # rule family id, e.g. "trace-safety"
    path: str      # repo-relative posix path
    line: int
    symbol: str    # dotted scope, e.g. "Checksummer.calculate"
    message: str   # stable text (part of the baseline key)

    @property
    def key(self) -> str:
        """Line-free identity used by the baseline."""
        return f"{self.rule}:{self.path}:{self.symbol}:{self.message}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.symbol}: {self.message}")


class Rule:
    """One rule family. Subclasses set ``id`` and implement ``check``;
    ``applies`` scopes the family to the layers whose invariants it
    guards (a dtype rule has no business in the RGW frontend)."""

    id: str = ""

    def applies(self, path: str) -> bool:
        return True

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        raise NotImplementedError


class RuleRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: dict[str, Callable[[], Rule]] = {}

    def add(self, rule_id: str, factory: Callable[[], Rule]) -> None:
        with self._lock:
            if rule_id in self._rules:
                raise KeyError(f"lint rule {rule_id!r} already registered")
            self._rules[rule_id] = factory

    def get(self, rule_id: str) -> Callable[[], Rule]:
        with self._lock:
            try:
                return self._rules[rule_id]
            except KeyError:
                raise KeyError(
                    f"unknown lint rule {rule_id!r}; "
                    f"known: {sorted(self._rules)}"
                ) from None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._rules)

    def rules(self, only: Iterable[str] | None = None) -> list[Rule]:
        ids = list(only) if only is not None else self.names()
        return [self.get(i)() for i in ids]


_instance = RuleRegistry()


def instance() -> RuleRegistry:
    return _instance


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator: register a Rule subclass under its ``id``."""
    if not cls.id:
        raise ValueError(f"{cls.__name__} has no rule id")
    _instance.add(cls.id, cls)
    return cls


def preload() -> None:
    """Import the built-in rule modules (registration is import-time,
    the mon/osd "plugins preload" stance)."""
    from . import (rules_buffer, rules_dispatch,  # noqa: F401
                   rules_dtype, rules_fabric, rules_hedge, rules_lock,
                   rules_mesh, rules_pipeline, rules_trace, rules_wire)


# ------------------------------------------------------------ AST helpers


def call_name(node: ast.AST) -> str:
    """Dotted name of a call target / reference: ``jax.jit``,
    ``np.zeros``, ``print`` — "" when it is not a plain dotted path."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def walk_ordered(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk is breadth-first; wire-parity needs source order."""
    yield node
    for child in ast.iter_child_nodes(node):
        yield from walk_ordered(child)


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the dotted class/function scope, so a
    finding can be keyed on the symbol it lives in."""

    def __init__(self) -> None:
        self.scope: list[str] = []

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


# --------------------------------------------------------------- running


def lint_source(source: str, path: str,
                only: Iterable[str] | None = None) -> list[Finding]:
    """Lint one source text under a virtual path (test fixtures use
    this; the path decides which rules apply)."""
    preload()
    tree = ast.parse(source, filename=path)
    out: list[Finding] = []
    for rule in _instance.rules(only):
        if rule.applies(path):
            out.extend(rule.check(tree, path, source))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule, f.message))


def iter_py_files(paths: Iterable[str | Path],
                  root: Path) -> Iterator[Path]:
    for p in paths:
        p = (root / p) if not Path(p).is_absolute() else Path(p)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            yield from sorted(p.rglob("*.py"))


def run_paths(paths: Iterable[str | Path], root: str | Path,
              only: Iterable[str] | None = None) -> list[Finding]:
    """Lint every .py file under ``paths`` (relative to ``root``)."""
    root = Path(root).resolve()
    out: list[Finding] = []
    for f in iter_py_files(paths, root):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:  # outside the repo root: key on abs path
            rel = f.resolve().as_posix()
        try:
            src = f.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError):
            continue
        try:
            out.extend(lint_source(src, rel, only))
        except SyntaxError as e:
            out.append(Finding("syntax", rel, e.lineno or 0,
                               "<module>", f"syntax error: {e.msg}"))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule, f.message))
