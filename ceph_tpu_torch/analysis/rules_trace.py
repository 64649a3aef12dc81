"""trace-safety: host-sync hazards inside the port's device functions.

A device function hands tensors on the card to a hand-written CUDA
kernel and returns tensors on the card; the launch is asynchronous, so
the host runs ahead while the card works. Anything that forces a
concrete value (``.item()``, ``int()`` on a tensor, ``.cpu()``,
``np.asarray``) inserts a device->host sync into the hot path: the
host waits for the card at every launch, and the next launch queues
behind that wait. ``print`` of a tensor does the same to format it,
and ``torch.cuda.synchronize()`` does it outright. These are exactly
the bugs that pass small tests on the CPU and destroy throughput on the
card.

Device functions are found two ways: the launch wrappers of
``ceph_tpu_torch/kernels.py`` (``gf_matmul``, ``gf2_xor``, ``crc32c``,
``straw2``, ``crush_rule``, ``xor_fold``, ``bit_planes``,
``plane_parity_pack``, ``crc_join``), and every function that calls one
of them (``kernels.gf_matmul(...)``, or the bare name imported from the
kernels module).

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_trace.py``.
Changed: the port has no jitted function, so the device functions above
take the jitted ones' place; the host syncs are the reference's with
torch's spellings (``.cpu()``, ``.numpy()`` and
``torch.cuda.synchronize()`` in place of ``block_until_ready`` and
``copy_to_host_async``); a tensor parameter is one annotated as a
``Tensor``, as a traced parameter was one not made static. The
reference's checks of ``self``/``global`` mutation and of
``static_argnums`` go: they guard against a trace that bakes one call's
value into the compiled program, or a cache key that cannot hash, and
torch runs a wrapper's Python body on every call and compiles nothing.
The reactor-readback check is the reference's, and also reads a
dispatch's result read back through the tensor methods.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, call_name, register

#: the launch wrappers of ceph_tpu_torch/kernels.py, one per kernel entry
_WRAPPERS = frozenset((
    "gf_matmul", "gf2_xor", "crc32c", "straw2", "crush_rule",
    "xor_fold", "bit_planes", "plane_parity_pack", "crc_join",
))
_KERNELS_FILE = "ceph_tpu_torch/kernels.py"

#: attribute calls that force a device->host sync on a tensor
_SYNC_METHODS = frozenset(("item", "tolist", "cpu", "numpy"))

#: calls that materialize a tensor on the host
_HOST_CALLS = frozenset((
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "np.copy", "numpy.copy",
))

#: codec methods that dispatch a device program and return device
#: arrays — materializing their result on the asyncio reactor thread
#: blocks the whole daemon for the transfer+execution round trip; the
#: dispatch AND its readback belong in an executor worker
#: (cluster/ecbatch.py shape). The bulk-CRUSH serving path
#: (placement/bulk.py do_rule_bulk, ops/crush.py straw2_bulk) is the
#: same hazard on the dispatch plane: the placement resolver runs it in
#: an executor, never on the reactor
_DEVICE_DISPATCHES = frozenset((
    "encode_batch", "decode_batch", "encode_crc_batch",
    "do_rule_bulk", "straw2_bulk",
))


def _kernel_aliases(tree: ast.Module) -> set[str]:
    """Bare names this module binds to a launch wrapper
    (``from ..kernels import gf_matmul as k1``)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.rpartition(".")[2] == "kernels"):
            out |= {a.asname or a.name for a in node.names
                    if a.name in _WRAPPERS}
    return out


def _own_calls(fn: ast.AST) -> Iterator[ast.Call]:
    """Calls in ``fn``'s own body (nested defs are judged on their
    own)."""
    for c in ast.iter_child_nodes(fn):
        if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(c, ast.Call):
            yield c
        yield from _own_calls(c)


def _launches(fn: ast.AST, aliases: set[str]) -> bool:
    for c in _own_calls(fn):
        name = call_name(c.func)
        mod, _, leaf = name.rpartition(".")
        if leaf in _WRAPPERS and mod.rpartition(".")[2] == "kernels":
            return True
        if not mod and name in aliases:
            return True
    return False


def _tensor_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    """Parameter names annotated as a ``Tensor`` (``torch.Tensor``,
    ``Tensor | None``, ...)."""
    a = fn.args
    out: set[str] = set()
    for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
        if p.annotation is None:
            continue
        if any(call_name(sub).rpartition(".")[2] == "Tensor"
               for sub in ast.walk(p.annotation)):
            out.add(p.arg)
    return out


#: attribute chains that yield STATIC metadata of a tensor —
#: `int(x.shape[0])` is idiomatic and sync-free, not a readback
_STATIC_ATTRS = frozenset(("shape", "ndim", "dtype", "size", "device",
                           "numel", "dim", "stride", "element_size"))


def _refs_traced_value(node: ast.AST, names: set[str]) -> bool:
    """Does ``node`` reference a tensor param's VALUE (as opposed to
    its static metadata like ``.shape``)?"""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False  # prune: x.shape / x.dtype subtrees are static
    if isinstance(node, ast.Name):
        return node.id in names
    return any(_refs_traced_value(c, names)
               for c in ast.iter_child_nodes(node))


@register
class TraceSafetyRule(Rule):
    id = "trace-safety"

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        aliases = _kernel_aliases(tree)
        in_kernels = (path == _KERNELS_FILE
                      or path.endswith("/" + _KERNELS_FILE))
        scope: list[str] = []
        findings: list[Finding] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.ClassDef):
                scope.append(node.name)
                for c in ast.iter_child_nodes(node):
                    visit(c)
                scope.pop()
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.append(node.name)
                wrapper = (in_kernels and len(scope) == 1
                           and node.name in _WRAPPERS)
                if wrapper or _launches(node, aliases):
                    findings.extend(self._check_device_fn(
                        node, path, ".".join(scope)))
                else:
                    if isinstance(node, ast.AsyncFunctionDef):
                        findings.extend(self._check_reactor_readback(
                            node, path, ".".join(scope)))
                    for c in ast.iter_child_nodes(node):
                        visit(c)
                scope.pop()
                return
            for c in ast.iter_child_nodes(node):
                visit(c)

        visit(tree)
        return iter(findings)

    def _check_device_fn(self, fn, path: str,
                         symbol: str) -> Iterator[Finding]:
        params = _tensor_params(fn)

        def emit(node, what: str) -> Finding:
            return Finding(self.id, path, node.lineno, symbol, what)

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node.func)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS):
                yield emit(node, f"host sync `.{node.func.attr}()` "
                                 "inside a device function")
            elif name in _HOST_CALLS:
                yield emit(node, f"`{name}` materializes a tensor on "
                                 "the host inside a device function")
            elif name == "print":
                yield emit(node, "`print` inside a device function "
                                 "syncs the card to format a tensor")
            elif name == "torch.cuda.synchronize":
                yield emit(node, "`torch.cuda.synchronize` inside a "
                                 "device function waits for the card "
                                 "at every launch")
            elif (name in ("float", "int", "bool") and node.args
                  and _refs_traced_value(node.args[0], params)):
                yield emit(node, f"`{name}()` on a tensor forces a "
                                 "device->host sync")

    def _check_reactor_readback(self, fn: ast.AsyncFunctionDef,
                                path: str,
                                symbol: str) -> Iterator[Finding]:
        """A blocking device readback on the reactor thread: inside an
        ``async def``, ``np.asarray(...)``/``np.array(...)`` wrapping a
        batched device dispatch, or a ``.cpu()``/``.numpy()``/
        ``.tolist()``/``.item()`` of one, materializes the result
        synchronously — the event loop stalls for the whole
        transfer+execution round trip. The dispatch and its readback
        must run in an executor worker (the ECBatcher
        _encode_sync/_decode_sync shape). The walk stops at nested
        function boundaries (each def is checked in its own visit)."""

        def local_walk(node: ast.AST) -> Iterator[ast.AST]:
            for c in ast.iter_child_nodes(node):
                if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                yield c
                yield from local_walk(c)

        for node in local_walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node.func) in _HOST_CALLS and node.args:
                read = node.args[0]
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS):
                read = node.func.value
            else:
                continue
            for sub in ast.walk(read):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _DEVICE_DISPATCHES):
                    yield Finding(
                        self.id, path, node.lineno, symbol,
                        f"blocking device readback of "
                        f"`.{sub.func.attr}()` on the reactor thread — "
                        "dispatch + readback belong in an executor "
                        "worker")
                    break
