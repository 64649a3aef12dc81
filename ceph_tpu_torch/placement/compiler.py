"""Crushmap text compiler/decompiler (the src/crush/CrushCompiler.cc
role behind `crushtool -c/-d`).

Speaks the standard crushmap text format:

    tunable choose_total_tries 50
    device 0 osd.0
    device 1 osd.1 class ssd
    type 0 osd
    type 1 host
    host host0 {
        id -2
        alg straw2
        hash 0
        item osd.0 weight 1.000
    }
    rule replicated_rule {
        id 0
        type replicated
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }

compile(text) -> CrushMap; decompile(map) -> text; the pair round-trips
(weights through 16.16 fixed point). Device classes are parsed and
preserved as annotations (full shadow-hierarchy expansion is the
reference's class machinery; out of scope here)."""
from __future__ import annotations

import re

from .crushmap import (
    ALG_LIST,
    ALG_STRAW,
    ALG_STRAW2,
    ALG_TREE,
    ALG_UNIFORM,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSE_TRIES,
    OP_SET_CHOOSELEAF_TRIES,
    OP_TAKE,
    Bucket,
    CrushMap,
    Rule,
    Step,
    Tunables,
)

ALGS = (ALG_UNIFORM, ALG_LIST, ALG_TREE, ALG_STRAW, ALG_STRAW2)


class CompileError(Exception):
    pass


# ------------------------------------------------------------- compile


def compile(text: str) -> CrushMap:  # noqa: A001 (crushtool verb)
    m = CrushMap(Tunables())
    device_classes: dict[int, str] = {}
    lines = _logical_lines(text)
    i = 0
    while i < len(lines):
        tok = lines[i].split()
        head = tok[0]
        if head == "tunable":
            if len(tok) != 3:
                raise CompileError(f"bad tunable line: {lines[i]}")
            if not hasattr(m.tunables, tok[1]):
                raise CompileError(f"unknown tunable {tok[1]!r}")
            setattr(m.tunables, tok[1], int(tok[2]))
            i += 1
        elif head == "device":
            # device <id> <name> [class <c>]
            devid = int(tok[1])
            m.names[devid] = tok[2]
            m.max_devices = max(m.max_devices, devid + 1)
            if len(tok) >= 5 and tok[3] == "class":
                device_classes[devid] = tok[4]
            i += 1
        elif head == "type":
            m.add_type(int(tok[1]), tok[2])
            i += 1
        elif head == "rule":
            i = _parse_rule(m, lines, i)
        elif head in m.types.values() or (len(tok) == 2 and tok[1] == "{"):
            i = _parse_bucket(m, lines, i)
        else:
            raise CompileError(f"cannot parse line: {lines[i]!r}")
    m.device_classes = device_classes
    return m


def _logical_lines(text: str) -> list[str]:
    out = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if line:
            out.append(line)
    return out


def _resolve(m: CrushMap, name: str) -> int:
    for item, n in m.names.items():
        if n == name:
            return item
    if name.startswith("osd.") and name[4:].isdigit():
        return int(name[4:])
    raise CompileError(f"unknown item name {name!r}")


def _parse_bucket(m: CrushMap, lines: list[str], i: int) -> int:
    head = lines[i].split()
    if len(head) != 3 or head[2] != "{":
        raise CompileError(f"bad bucket header: {lines[i]!r}")
    type_name, name = head[0], head[1]
    try:
        type_id = m.type_id(type_name)
    except KeyError:
        raise CompileError(f"unknown bucket type {type_name!r}") from None
    bid = None
    alg = ALG_STRAW2
    items: list[int] = []
    weights: list[int] = []
    i += 1
    while i < len(lines) and lines[i] != "}":
        tok = lines[i].split()
        if tok[0] == "id":
            if bid is None:  # `id -2 class ssd` shadow ids ignored
                bid = int(tok[1])
        elif tok[0] == "alg":
            if tok[1] not in ALGS:
                raise CompileError(f"unknown bucket alg {tok[1]!r}")
            alg = tok[1]
        elif tok[0] == "hash":
            if tok[1] not in ("0", "rjenkins1"):
                raise CompileError(f"unsupported hash {tok[1]!r}")
        elif tok[0] == "item":
            # item <name> [weight <w>]
            item = _resolve(m, tok[1])
            w = 1.0
            if "weight" in tok:
                w = float(tok[tok.index("weight") + 1])
            items.append(item)
            weights.append(int(round(w * 0x10000)))
        else:
            raise CompileError(f"bad bucket line: {lines[i]!r}")
        i += 1
    if i == len(lines):
        raise CompileError(f"unterminated bucket {name!r}")
    if bid is None:
        raise CompileError(f"bucket {name!r} has no id")
    m.add_bucket(Bucket(id=bid, type_id=type_id, alg=alg, items=items,
                        weights=weights, name=name))
    return i + 1


_STEP_RE = re.compile(
    r"step\s+(take\s+(?P<take>\S+)"
    r"|(?P<kind>chooseleaf|choose)\s+(?P<mode>firstn|indep)\s+"
    r"(?P<n>-?\d+)\s+type\s+(?P<type>\S+)"
    r"|emit"
    r"|set_choose_tries\s+(?P<sct>\d+)"
    r"|set_chooseleaf_tries\s+(?P<sclt>\d+))$"
)


def _parse_rule(m: CrushMap, lines: list[str], i: int) -> int:
    head = lines[i].split()
    if len(head) != 3 or head[2] != "{":
        raise CompileError(f"bad rule header: {lines[i]!r}")
    name = head[1]
    rid = None
    steps: list[Step] = []
    i += 1
    while i < len(lines) and lines[i] != "}":
        tok = lines[i].split()
        if tok[0] in ("id", "ruleset"):
            rid = int(tok[1])
        elif tok[0] in ("type", "min_size", "max_size"):
            pass  # informational in modern maps
        elif tok[0] == "step":
            mt = _STEP_RE.match(lines[i])
            if not mt:
                raise CompileError(f"bad step: {lines[i]!r}")
            if mt.group("take"):
                steps.append(Step(OP_TAKE, _resolve(m, mt.group("take"))))
            elif mt.group("kind"):
                tid = m.type_id(mt.group("type"))
                n = int(mt.group("n"))
                op = {
                    ("choose", "firstn"): OP_CHOOSE_FIRSTN,
                    ("choose", "indep"): OP_CHOOSE_INDEP,
                    ("chooseleaf", "firstn"): OP_CHOOSELEAF_FIRSTN,
                    ("chooseleaf", "indep"): OP_CHOOSELEAF_INDEP,
                }[(mt.group("kind"), mt.group("mode"))]
                steps.append(Step(op, n, tid))
            elif mt.group("sct"):
                steps.append(Step(OP_SET_CHOOSE_TRIES, int(mt.group("sct"))))
            elif mt.group("sclt"):
                steps.append(
                    Step(OP_SET_CHOOSELEAF_TRIES, int(mt.group("sclt")))
                )
            else:
                steps.append(Step(OP_EMIT))
        else:
            raise CompileError(f"bad rule line: {lines[i]!r}")
        i += 1
    if i == len(lines):
        raise CompileError(f"unterminated rule {name!r}")
    if rid is None:
        raise CompileError(f"rule {name!r} has no id")
    m.add_rule(Rule(id=rid, name=name, steps=steps))
    return i + 1


# ----------------------------------------------------------- decompile


def decompile(m: CrushMap) -> str:
    out: list[str] = ["# begin crush map"]
    for field_ in ("choose_local_tries", "choose_local_fallback_tries",
                   "choose_total_tries", "chooseleaf_descend_once",
                   "chooseleaf_vary_r", "chooseleaf_stable"):
        out.append(f"tunable {field_} {getattr(m.tunables, field_)}")
    out.append("")
    out.append("# devices")
    classes = getattr(m, "device_classes", {})
    for d in range(m.max_devices):
        name = m.names.get(d, f"osd.{d}")
        cls = f" class {classes[d]}" if d in classes else ""
        out.append(f"device {d} {name}{cls}")
    out.append("")
    out.append("# types")
    for tid in sorted(m.types):
        out.append(f"type {tid} {m.types[tid]}")
    out.append("")
    out.append("# buckets")
    # children before parents (the compiler resolves names forward-only)
    for b in _buckets_bottom_up(m):
        out.append(f"{m.types[b.type_id]} {_name_of(m, b.id)} {{")
        out.append(f"\tid {b.id}")
        out.append(f"\talg {b.alg}")
        out.append("\thash 0\t# rjenkins1")
        for item, w in zip(b.items, b.weights):
            out.append(
                f"\titem {_name_of(m, item)} weight {w / 0x10000:.5f}"
            )
        out.append("}")
    out.append("")
    out.append("# rules")
    for rid in sorted(m.rules):
        rule = m.rules[rid]
        out.append(f"rule {rule.name or f'rule_{rid}'} {{")
        out.append(f"\tid {rid}")
        out.append("\ttype replicated")
        for s in rule.steps:
            if s.op == OP_TAKE:
                out.append(f"\tstep take {_name_of(m, s.arg1)}")
            elif s.op == OP_EMIT:
                out.append("\tstep emit")
            elif s.op == OP_SET_CHOOSE_TRIES:
                out.append(f"\tstep set_choose_tries {s.arg1}")
            elif s.op == OP_SET_CHOOSELEAF_TRIES:
                out.append(f"\tstep set_chooseleaf_tries {s.arg1}")
            else:
                kind, mode = {
                    OP_CHOOSE_FIRSTN: ("choose", "firstn"),
                    OP_CHOOSE_INDEP: ("choose", "indep"),
                    OP_CHOOSELEAF_FIRSTN: ("chooseleaf", "firstn"),
                    OP_CHOOSELEAF_INDEP: ("chooseleaf", "indep"),
                }[s.op]
                out.append(
                    f"\tstep {kind} {mode} {s.arg1} type "
                    f"{m.types[s.arg2]}"
                )
        out.append("}")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


def _name_of(m: CrushMap, item: int) -> str:
    if item in m.names:
        return m.names[item]
    return f"osd.{item}" if item >= 0 else f"bucket{-item}"


def _buckets_bottom_up(m: CrushMap) -> list[Bucket]:
    done: set[int] = set()
    out: list[Bucket] = []

    def visit(bid: int) -> None:
        if bid in done:
            return
        done.add(bid)
        b = m.buckets[bid]
        for item in b.items:
            if item < 0:
                visit(item)
        out.append(b)

    for bid in sorted(m.buckets, reverse=True):
        visit(bid)
    return out
