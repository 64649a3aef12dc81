"""lock discipline in the cluster daemons.

Two inverse hazards around ``self._lock``-style mutexes:

- an attribute the class elsewhere guards with the lock is written
  OUTSIDE any lock scope — the classic torn-update race (protection is
  inferred per class: any attr ever assigned under ``with self.X`` /
  ``async with self.X`` where X names a lock is "shared state");
- a blocking call (``time.sleep``, ``open``, socket/subprocess I/O) is
  made while HOLDING a lock — in an asyncio daemon this stalls the
  whole event loop with the lock pinned, the mon/OSD heartbeat-death
  pattern.

Plus one fault-plane hazard (same family): a fault-injection hook is
AWAITED while holding a lock — injected pauses (FaultInjector.pause,
utils/fault.py) exist to stall ONE op, but under a PG lock they stall
every op of the PG with the lock pinned, turning a latency fault into
a livelock the thrasher then misattributes. Sync ``fault.hit()`` calls
under a lock are fine (one dict lookup); only awaits fire.

``__init__`` (and other underscore-free constructors) are exempt from
the first check: construction happens-before sharing.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_lock.py``.
Changed: the scope, ``ceph_tpu_torch/cluster/``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, call_name, register

_SCOPES = ("ceph_tpu_torch/cluster/",)

_LOCK_CTORS = frozenset((
    "asyncio.Lock", "threading.Lock", "threading.RLock",
    "asyncio.Condition", "threading.Condition", "asyncio.Semaphore",
    "threading.Semaphore",
))
_LOCK_NAME_HINTS = ("lock", "mutex")


def _looks_like_lock(attr: str) -> bool:
    """Name-based lock heuristic. "_mu" matches only as a SUFFIX
    (self._acquire_mu) — substring matching would classify data
    attributes like `xattr_muts` as locks and silently exempt them
    from the unlocked-write check."""
    low = attr.lower()
    return (any(h in low for h in _LOCK_NAME_HINTS)
            or low == "mu" or low.endswith("_mu"))

_BLOCKING_CALLS = frozenset((
    "time.sleep", "os.system", "socket.create_connection",
    "subprocess.run", "subprocess.check_call", "subprocess.check_output",
    "subprocess.call", "subprocess.Popen", "urllib.request.urlopen",
))
_INIT_METHODS = frozenset(("__init__", "__post_init__", "__new__"))


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _assigned_self_attrs(node: ast.AST) -> Iterator[tuple[str, int]]:
    """(attr, line) for every self.X = / self.X op= / self.X[...] =
    in a statement."""
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            base = t
            while isinstance(base, ast.Subscript):
                base = base.value
            attr = _self_attr(base)
            if attr is not None:
                yield attr, node.lineno


class _ClassInfo:
    def __init__(self, cls: ast.ClassDef) -> None:
        self.cls = cls
        self.locks = self._find_locks(cls)
        self.protected: set[str] = set()

    @staticmethod
    def _find_locks(cls: ast.ClassDef) -> set[str]:
        locks: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                if call_name(node.value.func) in _LOCK_CTORS:
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            locks.add(attr)
        for node in ast.walk(cls):
            for attr, _line in _assigned_self_attrs(node):
                if _looks_like_lock(attr):
                    locks.add(attr)
        return locks

    def is_lock_scope(self, node: ast.AST) -> bool:
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            return False
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call):
                ctx = ctx.func
            attr = _self_attr(ctx)
            if attr is not None and attr in self.locks:
                return True
        return False


@register
class LockDisciplineRule(Rule):
    id = "lock-discipline"

    def applies(self, path: str) -> bool:
        return any(path.startswith(s) or f"/{s}" in f"/{path}"
                   for s in _SCOPES)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(node, path)

    def _check_class(self, cls: ast.ClassDef,
                     path: str) -> Iterator[Finding]:
        info = _ClassInfo(cls)
        if not info.locks:
            return
        # pass 1: attrs ever assigned under a lock are "shared state"
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            for attr, _line in self._walk_assigns(method, info,
                                                  in_lock=True):
                info.protected.add(attr)
        info.protected -= info.locks
        # pass 2: flag unlocked writes to shared state and blocking
        # calls made while a lock is held
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            symbol = f"{cls.name}.{method.name}"
            if method.name not in _INIT_METHODS:
                for attr, line in self._walk_assigns(method, info,
                                                     in_lock=False):
                    if attr in info.protected:
                        yield Finding(
                            self.id, path, line, symbol,
                            f"write to `self.{attr}` outside the lock "
                            "that guards it elsewhere in "
                            f"`{cls.name}`")
            yield from self._blocking_in_lock(method, info, path,
                                              symbol)

    def _walk_assigns(self, node: ast.AST, info: _ClassInfo,
                      in_lock: bool) -> Iterator[tuple[str, int]]:
        """self-attr assignments under ``node`` that are (in_lock=True)
        inside / (False) outside any lock scope."""
        if info.is_lock_scope(node):
            if in_lock:
                for c in ast.walk(node):
                    yield from _assigned_self_attrs(c)
            return
        if not in_lock:
            yield from _assigned_self_attrs(node)
        for c in ast.iter_child_nodes(node):
            yield from self._walk_assigns(c, info, in_lock)

    @staticmethod
    def _is_fault_hook(name: str) -> bool:
        """Dotted path of a fault-injection hook: any segment named
        ``fault``/``faults`` (self.osd.fault.pause, plane.faults...)."""
        return any(seg in ("fault", "faults")
                   for seg in name.split("."))

    def _blocking_in_lock(self, node: ast.AST, info: _ClassInfo,
                          path: str, symbol: str,
                          held: bool = False) -> Iterator[Finding]:
        if info.is_lock_scope(node):
            held = True
        if held and isinstance(node, ast.Call):
            name = call_name(node.func)
            if name in _BLOCKING_CALLS or name == "open":
                yield Finding(
                    self.id, path, node.lineno, symbol,
                    f"blocking call `{name}` while holding a lock "
                    "stalls the event loop with the lock pinned")
        if (held and isinstance(node, ast.Await)
                and isinstance(node.value, ast.Call)):
            name = call_name(node.value.func)
            if self._is_fault_hook(name):
                yield Finding(
                    self.id, path, node.lineno, symbol,
                    f"fault-injection hook `{name}` awaited while "
                    "holding a lock: an injected pause must stall one "
                    "op, not pin the lock for the whole PG")
        for c in ast.iter_child_nodes(node):
            yield from self._blocking_in_lock(c, info, path, symbol,
                                              held)
