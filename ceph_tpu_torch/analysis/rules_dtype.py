"""dtype discipline in the GF(2^8)/CRC word-size-critical layers.

arXiv:1701.07731's polynomial-ring EC results hinge on strict word-size
discipline; in this tree the same contract lives in ceph_tpu_torch/ec (GF(2^8)
tables are uint8, bitmatrix planes uint32), ceph_tpu_torch/checksum (CRC
words are uint32), and ceph_tpu_torch/placement (straw2 is fixed-point u32/
u64 by design — a float anywhere breaks bit-parity with the reference).

Three checks, scoped to those packages:

- array constructors without an explicit dtype (``np.zeros(n)`` is
  float64; ``np.frombuffer(b)`` is float64 and raises on odd lengths
  — both silently poison a GF path);
- float dtypes by name (``np.float32``, ``dtype=float``, ``"float64"``,
  ``astype(float)``) — GF(2^8) and CRC state have no float form;
- ``+``/``-``/``*`` arithmetic inside GF-named functions, where field
  semantics require XOR / table lookups instead.

The GF(2) bit-plane kernels (ceph_tpu_torch/ops/gf2.py — the bitmatrix
XOR-schedule dispatch) get the same ctor/float checks PLUS a 64-bit
promotion check: XOR/popcount lanes must stay uint8/uint32 and gather
indices int32 — an ``int64``/``uint64`` dtype inside the jitted kernel
doubles lane traffic and breaks on x64-disabled backends. The GF-arith
operator check does NOT apply there: GF(2) work is XOR/shift by
construction, and the integer ``+``/``*`` that remains is index/shape
arithmetic (unlike GF(2^8) where a stray ``*`` means a missing table
lookup). placement/ is exempt from the promotion check — straw2 is
int64 fixed-point BY DESIGN.

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_dtype.py``, over
the port's ``ec/``, ``checksum/``, ``placement/`` and ``ops/gf2``.
Changed, for torch's spellings of the same hazards:

- ``torch`` is an array module beside numpy's. torch's constructors
  (``torch.zeros(n)`` is float32) take their dtype by keyword only, so
  one without ``dtype=`` is flagged whatever its positional arguments;
- ``torch.float16/32/64``, ``torch.float``, ``torch.bfloat16``,
  ``torch.half`` and ``torch.double`` are float dtypes, and so are the
  casts ``.float()``, ``.half()``, ``.double()`` and ``.bfloat16()``;
  ``.to(dtype)`` is checked as ``.astype(dtype)`` is.

The GF-arith operator check is the reference's.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Rule, ScopedVisitor, call_name, register

_SCOPES = ("ceph_tpu_torch/ec/", "ceph_tpu_torch/checksum/",
           "ceph_tpu_torch/placement/")
#: GF(2) bit-plane kernel scope: ctor/float checks + the 64-bit lane
#: promotion check, but NOT the GF-arith operator check (see module
#: docstring)
_GF2_SCOPES = ("ceph_tpu_torch/ops/gf2",)

_NP_MODS = ("np", "jnp", "numpy", "jax.numpy", "torch")
#: constructor -> 0-based positional index where dtype may ride
_NEED_DTYPE = {
    "zeros": 1, "ones": 1, "empty": 1, "full": 2, "array": 1,
    "arange": 3, "eye": 3, "frombuffer": 1,
}
#: torch's constructors: the dtype is keyword-only (positional
#: arguments are sizes or data)
_TORCH_CTORS = frozenset(("zeros", "ones", "empty", "full", "arange",
                          "eye", "tensor", "frombuffer"))
#: tensor methods that cast to a float dtype
_FLOAT_CASTS = frozenset(("float", "half", "double", "bfloat16"))
_FLOAT_NAMES = frozenset((
    "float16", "float32", "float64", "bfloat16", "float_", "double",
    "half", "single",
))
_WIDE_INT_NAMES = frozenset(("int64", "uint64", "int_", "longlong",
                             "ulonglong"))
_GF_MARKERS = ("gf", "galois")


def _is_array_ctor(name: str) -> str | None:
    mod, _, fn = name.rpartition(".")
    if mod == "torch":
        return fn if fn in _TORCH_CTORS else None
    return fn if mod in _NP_MODS and fn in _NEED_DTYPE else None


def _float_dtype_name(node: ast.AST) -> str | None:
    """`np.float32`, `torch.float`, bare `float`, or a "float64" string
    literal."""
    name = call_name(node)
    if name:
        mod, _, leaf = name.rpartition(".")
        if leaf in _FLOAT_NAMES and (not mod or mod in _NP_MODS):
            return name
        if name in ("float", "torch.float"):
            return name
    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.lstrip("<>=") in _FLOAT_NAMES):
        return node.value
    return None


def _wide_int_dtype_name(node: ast.AST) -> str | None:
    """`np.int64`, bare `int`, or an "int64" string literal — the lane
    promotions the GF(2) kernel scope forbids."""
    name = call_name(node)
    if name:
        mod, _, leaf = name.rpartition(".")
        if leaf in _WIDE_INT_NAMES and (not mod or mod in _NP_MODS):
            return name
        if name == "int":
            return name
    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.lstrip("<>=").lower() in _WIDE_INT_NAMES):
        return node.value
    return None


def _in_gf_context(scopes: list[str], path: str) -> bool:
    hay = [s.lower() for s in scopes] + [path.rsplit("/", 1)[-1].lower()]
    return any(m in h for m in _GF_MARKERS for h in hay)


@register
class DtypeRule(Rule):
    id = "dtype"

    def applies(self, path: str) -> bool:
        return any(path.startswith(s) or f"/{s}" in f"/{path}"
                   for s in _SCOPES + _GF2_SCOPES)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        rule_id = self.id
        findings: list[Finding] = []
        gf2_scope = any(path.startswith(s) or f"/{s}" in f"/{path}"
                        for s in _GF2_SCOPES)

        class V(ScopedVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                name = call_name(node.func)
                ctor = _is_array_ctor(name)
                kwargs = {k.arg for k in node.keywords}
                on_torch = name.startswith("torch.")
                if ctor is not None and "dtype" not in kwargs:
                    # np.zeros(n, np.uint8): dtype passed positionally
                    # (torch takes it by keyword only)
                    if on_torch or len(node.args) <= _NEED_DTYPE[ctor]:
                        default = "float32" if on_torch else "float64"
                        findings.append(Finding(
                            rule_id, path, node.lineno, self.symbol,
                            f"`{name}` without an explicit dtype "
                            f"defaults to {default} in a GF/CRC path"))
                    elif gf2_scope:
                        # positional dtype must pass the promotion
                        # check too (np.zeros(n, np.int64))
                        wide = _wide_int_dtype_name(
                            node.args[_NEED_DTYPE[ctor]])
                        if wide is not None:
                            findings.append(Finding(
                                rule_id, path, node.lineno,
                                self.symbol,
                                f"64-bit dtype `{wide}` in a GF(2) "
                                "bit-plane kernel — XOR/popcount "
                                "lanes stay uint8/uint32, indices "
                                "int32"))
                for kw in node.keywords:
                    if kw.arg == "dtype":
                        bad = _float_dtype_name(kw.value)
                        if bad is not None:
                            findings.append(Finding(
                                rule_id, path, kw.value.lineno,
                                self.symbol,
                                f"float dtype `{bad}` where GF(2^8)/"
                                "CRC integer words are required"))
                        if gf2_scope:
                            wide = _wide_int_dtype_name(kw.value)
                            if wide is not None:
                                findings.append(Finding(
                                    rule_id, path, kw.value.lineno,
                                    self.symbol,
                                    f"64-bit dtype `{wide}` in a GF(2)"
                                    " bit-plane kernel — XOR/popcount "
                                    "lanes stay uint8/uint32, indices "
                                    "int32"))
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("astype", "to")
                        and node.args):
                    cast = node.func.attr
                    bad = _float_dtype_name(node.args[0])
                    if bad is not None:
                        findings.append(Finding(
                            rule_id, path, node.lineno, self.symbol,
                            f"`.{cast}({bad})` in a GF(2^8)/CRC path"))
                    if gf2_scope:
                        wide = _wide_int_dtype_name(node.args[0])
                        if wide is not None:
                            findings.append(Finding(
                                rule_id, path, node.lineno,
                                self.symbol,
                                f"`.{cast}({wide})` promotes GF(2) "
                                "lanes to 64 bits inside the kernel"))
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _FLOAT_CASTS
                        and not node.args and not node.keywords):
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"`.{node.func.attr}()` in a GF(2^8)/CRC path"))
                self.generic_visit(node)

            def visit_BinOp(self, node: ast.BinOp) -> None:
                # the GF-arith operator check is GF(2^8)-specific (a
                # stray `*` means a missing table lookup); GF(2)
                # kernels legitimately do index/shape arithmetic
                if (not gf2_scope
                        and _in_gf_context(self.scope, path)
                        and isinstance(node.op,
                                       (ast.Add, ast.Sub, ast.Mult))
                        and not isinstance(node.left, ast.Constant)
                        and not isinstance(node.right, ast.Constant)):
                    op = {ast.Add: "+", ast.Sub: "-",
                          ast.Mult: "*"}[type(node.op)]
                    findings.append(Finding(
                        rule_id, path, node.lineno, self.symbol,
                        f"integer `{op}` in a GF(2^8) context — field "
                        "semantics need XOR / table lookups"))
                self.generic_visit(node)

        V().visit(tree)
        return iter(findings)
