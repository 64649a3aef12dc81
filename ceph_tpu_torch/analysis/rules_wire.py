"""wire-format parity: encode/decode field-kind symmetry.

A field added to ``encode_*`` but not ``decode_*`` (or vice versa) is
invisible until two daemons of different vintages talk — then every
message after the skew decodes garbage. The wire layer here is built on
``denc`` primitives whose names carry the field kind (``enc_u32`` /
``dec_u32``), so parity is statically checkable: for each
encode/decode pair, the multiset of kind references must match.

Counters (not sequences) are compared: helper lambdas and decode loops
legally reorder call sites relative to the encoder, but a *missing or
extra* kind is exactly the wire-skew bug. struct.Struct pack/unpack
arity is checked the same way (frames.py's header path).

ceph_tpu_torch's own copy of ``ceph_tpu/analysis/rules_wire.py``.
Changed: the scope, the port's ``msg/messages.py``, ``msg/frames.py``
and ``placement/encoding.py``.
"""
from __future__ import annotations

import ast
import re
from collections import Counter
from typing import Iterator

from .core import Finding, Rule, call_name, register, walk_ordered

_FILES = (
    "ceph_tpu_torch/msg/messages.py",
    "ceph_tpu_torch/msg/frames.py",
    "ceph_tpu_torch/placement/encoding.py",
)

#: encode_osdmap/_enc_pool/pack_hdr <-> decode_osdmap/_dec_pool/...
_PAIR_RE = re.compile(r"^(_?)(encode|enc|pack)(_|$)")
_DEC_OF = {"encode": "decode", "enc": "dec", "pack": "unpack"}

_KIND_RE = re.compile(r"^(?:denc\.)?(enc|dec)_([a-z0-9_]+)$")


def _kind_counter(fn: ast.AST, want: str) -> Counter:
    """Counter of denc kind names (`u32`, `map`, ...) referenced under
    ``fn`` with the given direction (``enc`` or ``dec``)."""
    kinds: Counter = Counter()
    # helpers defined inside the codec (e.g. a local `def dec_pairs`)
    # are composition, not wire kinds — only refs to denc primitives
    # and module-level codecs count
    local_defs = {n.name for n in ast.walk(fn)
                  if isinstance(n, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)) and n is not fn}
    for node in walk_ordered(fn):
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = call_name(node)
            if name in local_defs:
                continue
            m = _KIND_RE.match(name)
            if m and m.group(1) == want:
                kinds[m.group(2)] += 1
    return kinds


@register
class WireParityRule(Rule):
    id = "wire-parity"

    def applies(self, path: str) -> bool:
        return any(path.endswith(f) for f in _FILES)

    def check(self, tree: ast.Module, path: str,
              source: str) -> Iterator[Finding]:
        yield from self._check_denc_pairs(tree, path)
        yield from self._check_struct_arity(tree, path)

    # ------------------------------------------------------- denc kinds

    def _check_denc_pairs(self, tree: ast.Module,
                          path: str) -> Iterator[Finding]:
        funcs: dict[str, ast.AST] = {}

        def collect(node: ast.AST, prefix: str) -> None:
            for c in ast.iter_child_nodes(node):
                if isinstance(c, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                    funcs[prefix + c.name] = c
                elif isinstance(c, ast.ClassDef):
                    collect(c, prefix + c.name + ".")

        collect(tree, "")
        for name, enc_fn in sorted(funcs.items()):
            scope, _, leaf = name.rpartition(".")
            m = _PAIR_RE.match(leaf)
            if not m:
                continue
            dec_leaf = (m.group(1) + _DEC_OF[m.group(2)]
                        + leaf[m.end(2):])
            dec_name = (scope + "." if scope else "") + dec_leaf
            dec_fn = funcs.get(dec_name)
            if dec_fn is None:
                continue
            enc_kinds = _kind_counter(enc_fn, "enc")
            dec_kinds = _kind_counter(dec_fn, "dec")
            if enc_kinds == dec_kinds:
                continue
            only_enc = enc_kinds - dec_kinds
            only_dec = dec_kinds - enc_kinds
            detail = "; ".join(filter(None, (
                "encoder-only kinds: " + ", ".join(
                    f"{k}x{v}" for k, v in sorted(only_enc.items()))
                if only_enc else "",
                "decoder-only kinds: " + ", ".join(
                    f"{k}x{v}" for k, v in sorted(only_dec.items()))
                if only_dec else "",
            )))
            yield Finding(
                self.id, path, enc_fn.lineno, name,
                f"field-kind mismatch with `{dec_name}` — {detail}")

    # --------------------------------------------------- struct arity

    def _check_struct_arity(self, tree: ast.Module,
                            path: str) -> Iterator[Finding]:
        """For each struct object X: X.pack(...) positional arity must
        equal the tuple arity every X.unpack/unpack_from result is
        destructured into."""
        # key: a Struct instance's variable name, or — for module-level
        # struct.pack/unpack — ("struct", <format literal>), so two
        # UNRELATED formats in one file never compare against each other
        def _key(node: ast.Call, var: str):
            if var != "struct":
                return var
            fmt = node.args[0] if node.args else None
            if isinstance(fmt, ast.Constant) and isinstance(
                    fmt.value, str):
                return f"struct[{fmt.value}]"
            return None  # dynamic format: nothing to compare

        packs: dict[str, tuple[int, int]] = {}    # key -> (argc, line)
        unpacks: dict[str, tuple[int, int]] = {}  # key -> (targets, line)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute):
                var = call_name(node.func.value)
                if not var:
                    continue
                key = _key(node, var)
                if key is None:
                    continue
                if node.func.attr == "pack":
                    # module-level struct.pack carries the format as
                    # its first arg; a Struct instance's pack does not
                    argc = len(node.args) - (1 if var == "struct" else 0)
                    packs.setdefault(key, (max(0, argc), node.lineno))
                elif node.func.attr == "pack_into":
                    skip = 3 if var == "struct" else 2
                    packs.setdefault(
                        key, (max(0, len(node.args) - skip),
                              node.lineno))
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call) and isinstance(
                    node.value.func, ast.Attribute):
                if node.value.func.attr not in ("unpack", "unpack_from"):
                    continue
                var = call_name(node.value.func.value)
                t = node.targets[0]
                if var and isinstance(t, (ast.Tuple, ast.List)):
                    key = _key(node.value, var)
                    if key is not None:
                        unpacks.setdefault(key, (len(t.elts),
                                                 node.lineno))
        for key, (argc, line) in sorted(packs.items()):
            if key in unpacks and unpacks[key][0] != argc:
                yield Finding(
                    self.id, path, line, "<module>",
                    f"`{key}.pack` writes {argc} fields but its "
                    f"unpack destructures {unpacks[key][0]} (line "
                    f"{unpacks[key][1]}) — wire skew")
