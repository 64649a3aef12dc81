"""CRUSH map model + host rule engine (the oracle).

A faithful Python port of the reference's C mapper semantics
(src/crush/mapper.c): all five bucket algorithms (straw2, uniform,
list, tree, straw1), firstn and indep choose modes, chooseleaf
recursion, reweight-based is_out rejection, and the jewel-era
tunables. Used directly for small lookups (mon-side map
operations, tests) and as the bit-exactness oracle for the vectorized
device engine (placement/bulk.py and its CUDA kernel).

Scalar integer primitives (Jenkins hashes, straw2 draws) come from the
port's C++ host core (ceph_tpu_torch.native) — the same functions the
CUDA kernels are verified against.

All four legacy bucket algorithms (uniform, list, tree, straw1) are
implemented alongside straw2 — pre-jewel maps decode and map
bit-exactly; straw2 is what Ceph creates by default since jewel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from .. import native

ITEM_UNDEF = 0x7FFFFFFE  # crush.h:32
ITEM_NONE = 0x7FFFFFFF  # crush.h:36

ALG_UNIFORM = "uniform"
ALG_STRAW2 = "straw2"
ALG_LIST = "list"
ALG_TREE = "tree"
ALG_STRAW = "straw"  # legacy straw1 (pre-jewel maps)

# rule step ops (crush.h rule ops)
OP_TAKE = "take"
OP_CHOOSE_FIRSTN = "choose_firstn"
OP_CHOOSE_INDEP = "choose_indep"
OP_CHOOSELEAF_FIRSTN = "chooseleaf_firstn"
OP_CHOOSELEAF_INDEP = "chooseleaf_indep"
OP_EMIT = "emit"
OP_SET_CHOOSE_TRIES = "set_choose_tries"
OP_SET_CHOOSELEAF_TRIES = "set_chooseleaf_tries"


@dataclass
class Tunables:
    """Jewel-profile defaults (CrushWrapper set_tunables_jewel)."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1


@dataclass
class Bucket:
    id: int  # negative
    type_id: int  # >0; 0 is reserved for devices
    alg: str = ALG_STRAW2
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)  # 16.16 fixed per item
    name: str = ""
    # derived per-alg state, computed by add_bucket (the builder.c role):
    # straw scalers (straw1), cumulative sums (list), node weights (tree)
    straws: list[int] = field(default_factory=list)
    sum_weights: list[int] = field(default_factory=list)
    node_weights: list[int] = field(default_factory=list)

    @property
    def size(self) -> int:
        return len(self.items)

    def weight(self) -> int:
        return sum(self.weights)


def calc_straw_scalers(weights: list[int]) -> list[int]:
    """crush_calc_straw (builder.c:430, straw_calc_version 1): reverse
    weight-sorted items get exponentially growing straw scalers so draw
    probabilities track weights."""
    size = len(weights)
    order = sorted(range(size), key=lambda i: (weights[i], i))
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if weights[order[i]] == 0:
            straws[order[i]] = 0
            i += 1
            numleft -= 1
            continue
        straws[order[i]] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        wbelow += (float(weights[order[i - 1]]) - lastw) * numleft
        numleft -= 1
        wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
        if wbelow + wnext > 0 and wbelow > 0:
            pbelow = wbelow / (wbelow + wnext)
            if pbelow > 0 and numleft > 0:
                straw *= (1.0 / pbelow) ** (1.0 / numleft)
        lastw = float(weights[order[i - 1]])
    return straws


def _tree_depth(size: int) -> int:
    depth = 1
    t = size - 1
    while t:
        t >>= 1
        depth += 1
    return depth


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _tree_left(x: int) -> int:
    return x - (1 << (_tree_height(x) - 1))


def _tree_right(x: int) -> int:
    return x + (1 << (_tree_height(x) - 1))


def calc_tree_nodes(weights: list[int]) -> list[int]:
    """crush_make_tree_bucket node-weight layout: leaf i sits at node
    2i+1; internal nodes accumulate their subtree weights."""
    size = len(weights)
    if size == 0:
        return []
    depth = _tree_depth(size)
    nodes = [0] * (1 << depth)
    for i, wgt in enumerate(weights):
        node = ((i + 1) << 1) - 1
        nodes[node] = wgt
        for _ in range(1, depth):
            node = _tree_parent(node)
            nodes[node] += wgt
    return nodes


def _tree_parent(n: int) -> int:
    h = _tree_height(n)
    return n - (1 << h) if n & (1 << (h + 1)) else n + (1 << h)


# rjenkins1 4-input hash (src/crush/hash.c rjenkins1_4 recipe — frozen
# interoperability constants, like the 2/3-input variants in the native
# core)
def _hashmix(a: int, b: int, c: int) -> tuple[int, int, int]:
    M = 0xFFFFFFFF
    a = (a - b - c) & M; a ^= c >> 13  # noqa: E702
    b = (b - c - a) & M; b ^= (a << 8) & M  # noqa: E702
    c = (c - a - b) & M; c ^= b >> 13  # noqa: E702
    a = (a - b - c) & M; a ^= c >> 12  # noqa: E702
    b = (b - c - a) & M; b ^= (a << 16) & M  # noqa: E702
    c = (c - a - b) & M; c ^= b >> 5  # noqa: E702
    a = (a - b - c) & M; a ^= c >> 3  # noqa: E702
    b = (b - c - a) & M; b ^= (a << 10) & M  # noqa: E702
    c = (c - a - b) & M; c ^= b >> 15  # noqa: E702
    return a, b, c


_HASH_SEED = 1315423911


def crush_hash32_4(a: int, b: int, c: int, d: int) -> int:
    M = 0xFFFFFFFF
    a &= M; b &= M; c &= M; d &= M  # noqa: E702
    h = (_HASH_SEED ^ a ^ b ^ c ^ d) & M
    x, y = 231232, 1232
    a, b, h = _hashmix(a, b, h)
    c, d, h = _hashmix(c, d, h)
    a, x, h = _hashmix(a, x, h)
    y, b, h = _hashmix(y, b, h)
    c, x, h = _hashmix(c, x, h)
    y, d, h = _hashmix(y, d, h)
    return h


@dataclass
class Step:
    op: str
    arg1: int = 0  # take: item; choose: numrep; set_*: value
    arg2: int = 0  # choose: type id


@dataclass
class Rule:
    id: int
    steps: list[Step]
    name: str = ""


class CrushMap:
    """Buckets + rules + tunables (reference struct crush_map, crush.h)."""

    def __init__(self, tunables: Tunables | None = None) -> None:
        self.buckets: dict[int, Bucket] = {}
        self.rules: dict[int, Rule] = {}
        self.types: dict[int, str] = {0: "osd"}
        self.tunables = tunables or Tunables()
        self.max_devices = 0
        self.names: dict[int, str] = {}  # item id -> name (buckets+devices)
        #: named alternate weight sets (crush_choose_arg_map role):
        #: {key: {bucket_id: (weight_set 16.16 list, ids list | None)}}
        self.choose_args: dict = {}
        self._active_choose_args: dict | None = None

    # ----------------------------------------------------------- building

    def add_type(self, type_id: int, name: str) -> None:
        self.types[type_id] = name

    def type_id(self, name: str) -> int:
        for tid, n in self.types.items():
            if n == name:
                return tid
        raise KeyError(f"unknown bucket type {name!r}")

    def add_bucket(self, bucket: Bucket) -> None:
        if bucket.id >= 0:
            raise ValueError("bucket ids are negative")
        if bucket.alg not in (ALG_STRAW2, ALG_UNIFORM, ALG_LIST,
                              ALG_TREE, ALG_STRAW):
            raise ValueError(f"unsupported bucket alg {bucket.alg!r}")
        if len(bucket.items) != len(bucket.weights):
            raise ValueError("items/weights length mismatch")
        # derived builder state per alg (builder.c make_*_bucket roles)
        if bucket.alg == ALG_STRAW and not bucket.straws:
            bucket.straws = calc_straw_scalers(bucket.weights)
        if bucket.alg == ALG_LIST and not bucket.sum_weights:
            acc = 0
            bucket.sum_weights = []
            for wgt in bucket.weights:
                acc += wgt
                bucket.sum_weights.append(acc)
        if bucket.alg == ALG_TREE and not bucket.node_weights:
            bucket.node_weights = calc_tree_nodes(bucket.weights)
        self.buckets[bucket.id] = bucket
        if bucket.name:
            self.names[bucket.id] = bucket.name
        for it in bucket.items:
            if it >= 0:
                self.max_devices = max(self.max_devices, it + 1)

    def add_rule(self, rule: Rule) -> None:
        self.rules[rule.id] = rule

    def item_type(self, item: int) -> int:
        return 0 if item >= 0 else self.buckets[item].type_id

    # ------------------------------------------------------ bucket choose

    def bucket_choose(self, b: Bucket, x: int, r: int) -> int:
        if b.alg == ALG_STRAW2:
            arg = self._active_choose_args.get(b.id) \
                if self._active_choose_args else None
            if arg is None:
                return int(
                    native.straw2_choose(
                        np.asarray(b.items, dtype=np.int32),
                        np.asarray(b.weights, dtype=np.uint32),
                        x,
                        r,
                    )
                )
            # crush_choose_arg role: alternate weight_set (balancer
            # output) and optional substitute ids for hashing
            weights, ids = arg
            items_for_hash = ids if ids is not None else b.items
            high = 0
            high_draw = None
            for i in range(b.size):
                draw = int(native.straw2_draw(x, items_for_hash[i], r,
                                              weights[i]))
                if high_draw is None or draw > high_draw:
                    high, high_draw = i, draw
            return b.items[high]
        if b.alg == ALG_UNIFORM:
            return self._uniform_choose(b, x, r)
        if b.alg == ALG_LIST:
            return self._list_choose(b, x, r)
        if b.alg == ALG_TREE:
            return self._tree_choose(b, x, r)
        if b.alg == ALG_STRAW:
            return self._straw1_choose(b, x, r)
        raise ValueError(f"unsupported alg {b.alg}")

    def _list_choose(self, b: Bucket, x: int, r: int) -> int:
        """bucket_list_choose (mapper.c): walk items tail-first; accept
        item i when its scaled hash falls inside its own weight slice
        of the cumulative sum."""
        for i in range(b.size - 1, -1, -1):
            w = crush_hash32_4(x, b.items[i] & 0xFFFFFFFF, r,
                               b.id & 0xFFFFFFFF) & 0xFFFF
            w = (w * b.sum_weights[i]) >> 16
            if w < b.weights[i]:
                return b.items[i]
        return b.items[0]

    def _tree_choose(self, b: Bucket, x: int, r: int) -> int:
        """bucket_tree_choose: descend the weight-balanced binary tree
        by hashed splits."""
        n = len(b.node_weights) >> 1
        while not (n & 1):  # terminal nodes are odd
            w = b.node_weights[n]
            t = (crush_hash32_4(x, n, r, b.id & 0xFFFFFFFF) * w) >> 32
            left = n - (1 << (_tree_height(n) - 1))
            n = left if t < b.node_weights[left] else \
                n + (1 << (_tree_height(n) - 1))
        return b.items[n >> 1]

    def _straw1_choose(self, b: Bucket, x: int, r: int) -> int:
        """bucket_straw_choose: 16-bit hash draw scaled by precomputed
        straw lengths; first maximum wins."""
        high = 0
        high_draw = -1
        for i in range(b.size):
            draw = (native.crush_hash32_3(x, b.items[i] & 0xFFFFFFFF, r)
                    & 0xFFFF) * b.straws[i]
            if draw > high_draw:
                high, high_draw = i, draw
        return b.items[high]

    def _uniform_choose(self, b: Bucket, x: int, r: int) -> int:
        """bucket_perm_choose, computed statelessly: build the Fisher-
        Yates permutation prefix for seed x up to position r % size.
        crush hash fn id 0 (rjenkins1) with inputs (x, bucket id, p)."""
        size = b.size
        pr = r % size
        perm = list(range(size))
        for p in range(pr + 1):
            if p < size - 1:
                i = native.crush_hash32_3(x, b.id & 0xFFFFFFFF, p) % (size - p)
                if i:
                    perm[p + i], perm[p] = perm[p], perm[p + i]
        return b.items[perm[pr]]

    # ------------------------------------------------------------- is_out

    def _is_out(self, weights: np.ndarray, item: int, x: int) -> bool:
        """Reweight rejection (mapper.c:401-416): weights is the 16.16
        per-device out-weight vector (0x10000 = fully in)."""
        if item >= len(weights):
            return True
        w = int(weights[item])
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (native.crush_hash32_2(x, item) & 0xFFFF) >= w

    # ------------------------------------------------- choose (firstn)

    def _choose_firstn(
        self,
        bucket: Bucket,
        weights: np.ndarray,
        x: int,
        numrep: int,
        type_id: int,
        out: list[int],
        outpos: int,
        out_size: int,
        tries: int,
        recurse_tries: int,
        local_retries: int,
        local_fallback_retries: int,
        recurse_to_leaf: bool,
        vary_r: int,
        stable: int,
        out2: list[int] | None,
        parent_r: int,
    ) -> int:
        """Port of crush_choose_firstn (mapper.c:438-590)."""
        count = out_size
        rep = 0 if stable else outpos
        while rep < numrep and count > 0:
            ftotal = 0
            skip_rep = False
            retry_descent = True
            while retry_descent:
                retry_descent = False
                in_b = bucket
                flocal = 0
                retry_bucket = True
                while retry_bucket:
                    retry_bucket = False
                    collide = False
                    r = rep + parent_r + ftotal
                    if in_b.size == 0:
                        reject = True
                        item = ITEM_NONE
                    else:
                        if (
                            local_fallback_retries > 0
                            and flocal >= (in_b.size >> 1)
                            and flocal > local_fallback_retries
                        ):
                            item = self._uniform_choose(in_b, x, r)
                        else:
                            item = self.bucket_choose(in_b, x, r)
                        if item >= self.max_devices:
                            skip_rep = True
                            break
                        itemtype = self.item_type(item)
                        if itemtype != type_id:
                            if item >= 0 or item not in self.buckets:
                                skip_rep = True
                                break
                            in_b = self.buckets[item]
                            retry_bucket = True
                            continue
                        for i in range(outpos):
                            if out[i] == item:
                                collide = True
                                break
                        reject = False
                        if not collide and recurse_to_leaf:
                            if item < 0:
                                sub_r = r >> (vary_r - 1) if vary_r else 0
                                got = self._choose_firstn(
                                    self.buckets[item],
                                    weights,
                                    x,
                                    1 if stable else outpos + 1,
                                    0,
                                    out2,
                                    outpos,
                                    count,
                                    recurse_tries,
                                    0,
                                    local_retries,
                                    local_fallback_retries,
                                    False,
                                    vary_r,
                                    stable,
                                    None,
                                    sub_r,
                                )
                                if got <= outpos:
                                    reject = True
                            else:
                                out2[outpos] = item
                        if not reject and not collide:
                            if itemtype == 0:
                                reject = self._is_out(weights, item, x)
                    if reject or collide:
                        ftotal += 1
                        flocal += 1
                        if collide and flocal <= local_retries:
                            retry_bucket = True
                        elif (
                            local_fallback_retries > 0
                            and flocal <= in_b.size + local_fallback_retries
                        ):
                            retry_bucket = True
                        elif ftotal < tries:
                            retry_descent = True
                        else:
                            skip_rep = True
            if skip_rep:
                rep += 1
                continue
            out[outpos] = item
            outpos += 1
            count -= 1
            rep += 1
        return outpos

    # -------------------------------------------------- choose (indep)

    def _choose_indep(
        self,
        bucket: Bucket,
        weights: np.ndarray,
        x: int,
        left: int,
        numrep: int,
        type_id: int,
        out: list[int],
        outpos: int,
        tries: int,
        recurse_tries: int,
        recurse_to_leaf: bool,
        out2: list[int] | None,
        parent_r: int,
    ) -> None:
        """Port of crush_choose_indep (mapper.c:633-800)."""
        endpos = outpos + left
        for rep in range(outpos, endpos):
            out[rep] = ITEM_UNDEF
            if out2 is not None:
                out2[rep] = ITEM_UNDEF
        ftotal = 0
        while left > 0 and ftotal < tries:
            for rep in range(outpos, endpos):
                if out[rep] != ITEM_UNDEF:
                    continue
                in_b = bucket
                while True:
                    r = rep + parent_r
                    if in_b.alg == ALG_UNIFORM and in_b.size % numrep == 0:
                        r += (numrep + 1) * ftotal
                    else:
                        r += numrep * ftotal
                    if in_b.size == 0:
                        break
                    item = self.bucket_choose(in_b, x, r)
                    if item >= self.max_devices:
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        break
                    itemtype = self.item_type(item)
                    if itemtype != type_id:
                        if item >= 0 or item not in self.buckets:
                            out[rep] = ITEM_NONE
                            if out2 is not None:
                                out2[rep] = ITEM_NONE
                            left -= 1
                            break
                        in_b = self.buckets[item]
                        continue
                    collide = False
                    for i in range(outpos, endpos):
                        if out[i] == item:
                            collide = True
                            break
                    if collide:
                        break
                    if recurse_to_leaf:
                        if item < 0:
                            self._choose_indep(
                                self.buckets[item],
                                weights,
                                x,
                                1,
                                numrep,
                                0,
                                out2,
                                rep,
                                recurse_tries,
                                0,
                                False,
                                None,
                                r,
                            )
                            if out2[rep] == ITEM_NONE:
                                break
                        elif out2 is not None:
                            out2[rep] = item
                    if itemtype == 0 and self._is_out(weights, item, x):
                        break
                    out[rep] = item
                    left -= 1
                    break
            ftotal += 1
        for rep in range(outpos, endpos):
            if out[rep] == ITEM_UNDEF:
                out[rep] = ITEM_NONE
            if out2 is not None and out2[rep] == ITEM_UNDEF:
                out2[rep] = ITEM_NONE

    # ------------------------------------------------------------ do_rule

    def do_rule(
        self,
        ruleno: int,
        x: int,
        numrep: int,
        weights: np.ndarray | None = None,
        choose_args=None,
    ) -> list[int]:
        """Port of crush_do_rule (mapper.c:878-1083). ``numrep`` is
        result_max (what CrushWrapper::do_rule passes); ``weights`` the
        16.16 per-device out-weight vector (defaults to all-in).
        ``choose_args`` selects a named alternate weight set
        (CrushWrapper::do_rule's choose_args_map role) or passes one
        directly as {bucket_id: (weight_set, ids|None)}."""
        if weights is None:
            weights = np.full(self.max_devices, 0x10000, dtype=np.uint32)
        if isinstance(choose_args, (str, int)):
            choose_args = self.choose_args[choose_args]
        self._active_choose_args = choose_args
        try:
            return self._do_rule_inner(ruleno, x, numrep, weights)
        finally:
            self._active_choose_args = None

    def _do_rule_inner(
        self,
        ruleno: int,
        x: int,
        numrep: int,
        weights: np.ndarray,
    ) -> list[int]:
        t = self.tunables
        rule = self.rules[ruleno]
        result: list[int] = []
        result_max = numrep
        choose_tries = t.choose_total_tries + 1  # off-by-one, see mapper.c
        choose_leaf_tries = 0
        local_retries = t.choose_local_tries
        local_fallback_retries = t.choose_local_fallback_tries
        vary_r = t.chooseleaf_vary_r
        stable = t.chooseleaf_stable
        w: list[int] = []
        for step in rule.steps:
            if step.op == OP_TAKE:
                item = step.arg1
                if item >= 0 or item in self.buckets:
                    w = [item]
            elif step.op == OP_SET_CHOOSE_TRIES:
                if step.arg1 > 0:
                    choose_tries = step.arg1
            elif step.op == OP_SET_CHOOSELEAF_TRIES:
                if step.arg1 > 0:
                    choose_leaf_tries = step.arg1
            elif step.op in (
                OP_CHOOSE_FIRSTN,
                OP_CHOOSELEAF_FIRSTN,
                OP_CHOOSE_INDEP,
                OP_CHOOSELEAF_INDEP,
            ):
                if not w:
                    continue
                firstn = step.op in (OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN)
                recurse_to_leaf = step.op in (
                    OP_CHOOSELEAF_FIRSTN,
                    OP_CHOOSELEAF_INDEP,
                )
                # per-take scratch: the C engine offsets out by osize per
                # take item, so collision checks are scoped per take
                o_all: list[int] = []
                c_all: list[int] = []
                for wi in w:
                    nr = step.arg1
                    if nr <= 0:
                        nr += result_max
                        if nr <= 0:
                            continue
                    if wi >= 0 or wi not in self.buckets:
                        continue  # probably ITEM_NONE
                    osize = len(o_all)
                    o: list[int] = [0] * result_max
                    c: list[int] = [0] * result_max
                    if firstn:
                        if choose_leaf_tries:
                            recurse_tries = choose_leaf_tries
                        elif t.chooseleaf_descend_once:
                            recurse_tries = 1
                        else:
                            recurse_tries = choose_tries
                        placed = self._choose_firstn(
                            self.buckets[wi],
                            weights,
                            x,
                            nr,
                            step.arg2,
                            o,
                            0,
                            result_max - osize,
                            choose_tries,
                            recurse_tries,
                            local_retries,
                            local_fallback_retries,
                            recurse_to_leaf,
                            vary_r,
                            stable,
                            c,
                            0,
                        )
                    else:
                        placed = min(nr, result_max - osize)
                        self._choose_indep(
                            self.buckets[wi],
                            weights,
                            x,
                            placed,
                            nr,
                            step.arg2,
                            o,
                            0,
                            choose_tries,
                            choose_leaf_tries or 1,
                            recurse_to_leaf,
                            c,
                            0,
                        )
                    o_all.extend(o[:placed])
                    c_all.extend(c[:placed])
                w = c_all if recurse_to_leaf else o_all
            elif step.op == OP_EMIT:
                result.extend(w[: result_max - len(result)])
                w = []
            else:
                raise ValueError(f"unknown rule op {step.op!r}")
        return result


# ------------------------------------------------------------ map builders


def build_flat(
    n_osds: int,
    osd_weights: Iterable[float] | None = None,
    alg: str = ALG_STRAW2,
) -> CrushMap:
    """One root bucket holding all OSDs (the minimal useful map)."""
    m = CrushMap()
    m.add_type(1, "root")
    ws = (
        [0x10000] * n_osds
        if osd_weights is None
        else [int(w * 0x10000) for w in osd_weights]
    )
    m.add_bucket(
        Bucket(
            id=-1,
            type_id=1,
            alg=alg,
            items=list(range(n_osds)),
            weights=ws,
            name="root",
        )
    )
    return m


def build_hierarchy(
    osds_per_host: int,
    n_hosts: int,
    host_weights: Iterable[float] | None = None,
) -> CrushMap:
    """root -> host -> osd straw2 tree with uniform device weights."""
    m = CrushMap()
    m.add_type(1, "host")
    m.add_type(2, "root")
    host_ids = []
    for h in range(n_hosts):
        osds = list(range(h * osds_per_host, (h + 1) * osds_per_host))
        b = Bucket(
            id=-(2 + h),
            type_id=1,
            items=osds,
            weights=[0x10000] * osds_per_host,
            name=f"host{h}",
        )
        m.add_bucket(b)
        host_ids.append(b.id)
    hw = (
        [0x10000 * osds_per_host] * n_hosts
        if host_weights is None
        else [int(w * 0x10000) for w in host_weights]
    )
    m.add_bucket(
        Bucket(id=-1, type_id=2, items=host_ids, weights=hw, name="root")
    )
    return m


def replicated_rule(
    rule_id: int, root: int = -1, failure_domain_type: int = 1
) -> Rule:
    """take root; chooseleaf_firstn 0 type <fd>; emit (the default
    replicated_rule CrushWrapper::create_replicated_rule builds)."""
    return Rule(
        id=rule_id,
        name="replicated_rule",
        steps=[
            Step(OP_TAKE, root),
            Step(OP_CHOOSELEAF_FIRSTN, 0, failure_domain_type),
            Step(OP_EMIT),
        ],
    )


def flat_firstn_rule(rule_id: int, root: int = -1) -> Rule:
    """take root; choose_firstn 0 type osd; emit (flat maps)."""
    return Rule(
        id=rule_id,
        name="flat_firstn",
        steps=[Step(OP_TAKE, root), Step(OP_CHOOSE_FIRSTN, 0, 0), Step(OP_EMIT)],
    )


def ec_rule(
    rule_id: int,
    root: int = -1,
    failure_domain_type: int = 0,
    set_chooseleaf_tries: int = 5,
) -> Rule:
    """The default EC rule shape (ErasureCodeInterface create_rule +
    ErasureCode::create_rule: set_chooseleaf_tries 5; take; chooseleaf/
    choose indep 0 type <fd>; emit)."""
    choose = (
        Step(OP_CHOOSE_INDEP, 0, 0)
        if failure_domain_type == 0
        else Step(OP_CHOOSELEAF_INDEP, 0, failure_domain_type)
    )
    return Rule(
        id=rule_id,
        name="ec_rule",
        steps=[
            Step(OP_SET_CHOOSELEAF_TRIES, set_chooseleaf_tries),
            Step(OP_TAKE, root),
            choose,
            Step(OP_EMIT),
        ],
    )
