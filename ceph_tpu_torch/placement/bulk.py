"""Bulk CRUSH rule engine: do_rule over whole batches of placement inputs.

The reference maps one input at a time through recursive C with
data-dependent retries (mapper.c:438,633). Here the map compiles to dense
arrays (bucket items/weights/sizes/types, ``CompiledMap``) and a batch of
inputs runs through them in one call:

- on a CUDA device, ``csrc/crush_rule.cu``: a group of lanes per input
  (``group_width``: up to a warp, by the widest bucket and the batch)
  running the C's own loop order (firstn retries, indep rounds, the
  chooseleaf recursion) with each bucket's draws spread over the group,
  launched once per call;
- on the CPU, the plain version: the same semantics vectorised in torch
  over the batch, every lane walking in lockstep with per-lane masks (the
  descent unrolled over the map's depth, the retry loops as Python loops
  that run while any lane is active). It is the kernel's yardstick in the
  tests and in ``chip_smoke.py``.

Straw2 draws, the reweight is_out test and the Jenkins hashes are
``ops/crush.py``'s (bit-exact against the C host core).

Scope: straw2 buckets, jewel-era tunables with choose_local_tries ==
choose_local_fallback_tries == 0 (their defaults since 2014), rules shaped
take -> [set_*] -> choose|chooseleaf -> emit — the shape of every rule
Ceph's own tooling generates — and at most ``MAX_REP`` results a row.
Unsupported maps, tunables, rule shapes or widths are REJECTED with
ValueError at compile time (callers route those through the host oracle,
CrushMap.do_rule); nothing silently degrades. compile_rule also rejects
maps where a device item sits above the choose-type level (e.g. a root
holding both hosts and bare OSDs): the C handles that case with
skip_rep/ITEM_NONE semantics (mapper.c:497-516) that the fixed descent
does not reproduce, so such maps must use the host engine rather than
silently diverge.

Bit-exactness is asserted in tests against the host engine and the JAX
package's engine.
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import resolve
from ..ops import crush as crush_ops
from . import crushmap as cm

ITEM_NONE = cm.ITEM_NONE
ITEM_UNDEF = cm.ITEM_UNDEF
#: Most results a row may hold (the kernel's rows in shared memory).
MAX_REP = kernels.CRUSH_MAX_REP
#: Most lanes of the kernel that carry one input: a warp.
GROUP_MAX = kernels.CRUSH_MAX_GROUP
#: Slots of the widest bucket a lane draws in one choose when the batch
#: fills the card. On the 50-host x 20-OSD tree at 10 M inputs (G = 8) it
#: was the fastest width for the EC rule and within 1.3% of the fastest
#: for the replicated one (PERF.md, "K4 redesigned").
LANE_SLOTS = 8


def _pow2_lanes(n: int) -> int:
    return min(GROUP_MAX, 1 << max(n - 1, 0).bit_length())


def group_width(widest: int, n_inputs: int, card_lanes: int) -> int:
    """Lanes of ``csrc/crush_rule.cu`` that carry one input, for a rule
    whose widest bucket holds ``widest`` items, over ``n_inputs`` inputs
    on a card that holds ``card_lanes`` threads at once. Lane j draws
    slots j, j + G, ... of a bucket, so a choose takes ceil(size / G)
    rounds of draws and a log2(G)-step reduction.

    A batch the card holds whole at one lane per slot (n_inputs x G <=
    card_lanes) takes that G, the smallest power of two >= widest, at
    most GROUP_MAX: the shortest serial chain an input can have. A larger
    batch takes G >= widest / LANE_SLOTS: fewer idle lanes in a round and
    each choose's reduction and control shared by more inputs a warp,
    which outweighs their divergence once the card is full."""
    whole = _pow2_lanes(widest)
    if n_inputs * whole <= card_lanes:
        return whole
    return _pow2_lanes(-(-widest // LANE_SLOTS))


@functools.lru_cache(maxsize=None)
def card_lanes(device: torch.device) -> int:
    """Threads ``device``'s SMs hold at once."""
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * p.max_threads_per_multi_processor


@dataclass(frozen=True)
class CompiledRule:
    take: int
    op: str  # one of the four choose ops
    numrep_arg: int  # raw arg1 (0 means result_max)
    choose_type: int
    choose_tries: int
    recurse_tries: int
    vary_r: int
    stable: int


class CompiledMap:
    """Dense-array form of a straw2 CrushMap for bulk dispatch."""

    def __init__(self, m: cm.CrushMap):
        if any(b.alg != cm.ALG_STRAW2 for b in m.buckets.values()):
            raise ValueError("device engine supports straw2 buckets only")
        t = m.tunables
        if t.choose_local_tries or t.choose_local_fallback_tries:
            raise ValueError("local retries unsupported on device")
        self.crushmap = m
        nb = max(-bid for bid in m.buckets)
        mi = max(b.size for b in m.buckets.values())
        self.items = np.zeros((nb, mi), dtype=np.int32)
        self.weights = np.zeros((nb, mi), dtype=np.uint32)
        self.sizes = np.zeros(nb, dtype=np.int32)
        self.btype = np.zeros(nb, dtype=np.int32)
        for bid, b in m.buckets.items():
            i = -1 - bid
            self.items[i, : b.size] = b.items
            self.weights[i, : b.size] = b.weights
            self.sizes[i] = b.size
            self.btype[i] = b.type_id
        self.max_devices = m.max_devices
        self.max_depth = self._depth()
        self.tunables = t
        self._on: dict[str, tuple[torch.Tensor, ...]] = {}
        self._widest: dict[int, int] = {}
        self._lock = threading.Lock()

    def _depth(self) -> int:
        depth = {}

        def d(item: int) -> int:
            if item >= 0:
                return 0
            if item not in depth:
                b = self.crushmap.buckets[item]
                depth[item] = 1 + max((d(i) for i in b.items), default=0)
            return depth[item]

        return max(d(bid) for bid in self.crushmap.buckets)

    def arrays_on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(items, weights, sizes, btype) as int32 tensors on ``device``
        (weights holding uint32 bits), uploaded once per device with a
        blocking copy, so any thread's stream may read them."""
        key = str(device)
        with self._lock:
            if key not in self._on:
                self._on[key] = tuple(
                    torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                     .copy()).to(device)
                    for a in (self.items, self.weights, self.sizes,
                              self.btype))
            return self._on[key]

    def widest(self, take: int) -> int:
        """Items of the widest bucket reachable from bucket ``take``: the
        most draws one choose of a rule that takes it can make."""
        with self._lock:
            if take not in self._widest:
                most, seen, stack = 0, set(), [take]
                while stack:
                    bid = stack.pop()
                    if bid >= 0 or bid in seen:
                        continue
                    seen.add(bid)
                    b = self.crushmap.buckets[bid]
                    most = max(most, b.size)
                    stack.extend(b.items)
                self._widest[take] = most
            return self._widest[take]

    def _validate_descent(self, take: int, choose_type: int) -> None:
        """Reject maps where a device item is chooseable above the
        choose-type level. The C handles such picks with skip_rep (firstn,
        mapper.c:497) or ITEM_NONE (indep, mapper.c:516), altering the r
        retry sequence in ways the fixed descent does not reproduce — so
        the asserted bit-exactness contract would silently break. Those
        maps must use the host oracle."""
        if choose_type == 0:
            return  # devices are the targets; any item is a valid stop
        stack = [take]
        seen: set[int] = set()
        while stack:
            bid = stack.pop()
            if bid in seen or bid >= 0:
                continue
            seen.add(bid)
            b = self.crushmap.buckets[bid]
            for it in b.items:
                it_type = 0 if it >= 0 else self.crushmap.buckets[it].type_id
                if it_type == choose_type:
                    continue  # valid descent target; recursion stops here
                if it >= 0:
                    raise ValueError(
                        f"device engine: bucket {bid} (type {b.type_id}) "
                        f"holds device {it} above choose type "
                        f"{choose_type}; use the host oracle for this map"
                    )
                stack.append(it)

    def compile_rule(self, ruleno: int, result_max: int) -> CompiledRule:
        """Validate + flatten a take/set*/choose/emit rule."""
        t = self.tunables
        rule = self.crushmap.rules[ruleno]
        take = None
        choose = None
        choose_tries = t.choose_total_tries + 1
        choose_leaf_tries = 0
        seen_emit = False
        for s in rule.steps:
            if s.op == cm.OP_TAKE:
                if take is not None or choose is not None:
                    raise ValueError("device engine: single take/choose only")
                take = s.arg1
            elif s.op == cm.OP_SET_CHOOSE_TRIES:
                if s.arg1 > 0:
                    choose_tries = s.arg1
            elif s.op == cm.OP_SET_CHOOSELEAF_TRIES:
                if s.arg1 > 0:
                    choose_leaf_tries = s.arg1
            elif s.op in (
                cm.OP_CHOOSE_FIRSTN,
                cm.OP_CHOOSELEAF_FIRSTN,
                cm.OP_CHOOSE_INDEP,
                cm.OP_CHOOSELEAF_INDEP,
            ):
                if choose is not None or take is None:
                    raise ValueError("device engine: single choose only")
                choose = s
            elif s.op == cm.OP_EMIT:
                seen_emit = True
            else:
                raise ValueError(f"device engine: unsupported op {s.op}")
        if take is None or choose is None or not seen_emit:
            raise ValueError("device engine: rule must take/choose/emit")
        if take >= 0 or take not in self.crushmap.buckets:
            raise ValueError(
                f"device engine: take target {take} is not a bucket; "
                "use the host oracle"
            )
        self._validate_descent(take, choose.arg2)
        width = min(choose.arg1 if choose.arg1 > 0
                    else result_max + choose.arg1, result_max)
        if width > MAX_REP:
            raise ValueError(
                f"device engine: {width} results a row, at most {MAX_REP}; "
                "use the host oracle")
        firstn = choose.op in (cm.OP_CHOOSE_FIRSTN, cm.OP_CHOOSELEAF_FIRSTN)
        if firstn:
            if choose_leaf_tries:
                recurse = choose_leaf_tries
            elif t.chooseleaf_descend_once:
                recurse = 1
            else:
                recurse = choose_tries
        else:
            recurse = choose_leaf_tries or 1
        return CompiledRule(
            take=take,
            op=choose.op,
            numrep_arg=choose.arg1,
            choose_type=choose.arg2,
            choose_tries=choose_tries,
            recurse_tries=recurse,
            vary_r=t.chooseleaf_vary_r,
            stable=t.chooseleaf_stable,
        )


# ------------------------------------------------- the plain version


def _straw2_choose_rows(arrays, bno, x, r):
    """Per-lane straw2 choose: bno (N,) bucket row index, x and r (N,)
    int64 holding uint32. Returns chosen item (N,) int32. Pad slots draw
    INT64_MIN, so an all-dead bucket resolves to slot 0 — the same
    first-wins the C has."""
    items, weights, sizes = arrays
    its = items[bno]  # (N, MI)
    draws = crush_ops.straw2_draw(x[:, None], its, r[:, None], weights[bno])
    slot = torch.arange(its.shape[1], dtype=torch.int64, device=x.device)
    draws = torch.where(slot[None, :] < sizes[bno][:, None], draws,
                        crush_ops.INT64_MIN)
    top = draws.max(dim=1, keepdim=True).values
    win = torch.where(draws == top, slot, its.shape[1]).min(dim=1).values
    return its.gather(1, win[:, None])[:, 0]


def _is_out(dev_weights, item, x):
    """Vector is_out (mapper.c:401): probabilistic reweight rejection.
    dev_weights int64 holding uint32; item int32; x int64."""
    nw = dev_weights.shape[0]
    if nw == 0:
        return torch.ones_like(item, dtype=torch.bool)
    w = dev_weights[item.long().clamp(0, nw - 1)]
    h = crush_ops.hash32_2(x, item) & 0xFFFF
    return (item >= nw) | ((w < 0x10000) & ((w == 0) | (h >= w)))


def _item_type(btype, item):
    bt = btype[(-1 - item.long()).clamp(0, btype.shape[0] - 1)]
    return torch.where(item >= 0, torch.zeros_like(bt), bt)


def _descend(arrays, btype, max_depth, start_bno, x, r, target_type, active,
             draws=None):
    """Walk from bucket rows start_bno down to items of target_type.
    Returns (item, ok): ok lanes found a target-typed item. ``draws``, a
    (1,) int64 tensor or None, gains the bucket's size for each choose of
    a lane still walking (the kernel's count)."""
    sizes = arrays[2]
    cur = start_bno
    found = torch.full_like(start_bno, ITEM_NONE, dtype=torch.int32)
    walking = active
    for _ in range(max_depth):
        empty = sizes[cur] == 0  # C rejects empty buckets (mapper.c:494)
        if draws is not None:
            draws += torch.where(walking & ~empty, sizes[cur], 0).sum()
        item = _straw2_choose_rows(arrays, cur, x, r)
        hit = walking & ~empty & (_item_type(btype, item) == target_type)
        found = torch.where(hit, item, found)
        keep = walking & ~empty & ~hit & (item < 0)
        cur = torch.where(keep, -1 - item.long(), cur)
        walking = keep
    return found, active & (found != ITEM_NONE)


def _sub_r(rule, r):
    if not rule.vary_r:
        return torch.zeros_like(r)
    if rule.vary_r - 1 >= 32:
        return torch.zeros_like(r)
    return r >> (rule.vary_r - 1)


def _leaf_attempts(arrays, btype, max_depth, dev_weights, rule, R,
                   host_item, r, pos, x, active, out2, draws):
    """Recursive chooseleaf: descend to a device, recurse_tries attempts,
    r2 = (stable ? 0 : pos) + sub_r + ftotal2. The C recursion
    collision-checks the leaf against out2[0..outpos-1] (it passes out2
    as the recursion's out vector)."""
    base = _sub_r(rule, r) if rule.stable else pos + _sub_r(rule, r)
    slot_valid = torch.arange(R, dtype=torch.int64,
                              device=x.device)[None, :] < pos[:, None]
    host_bno = (-1 - host_item.long()).clamp(0, btype.shape[0] - 1)
    leaf = torch.full_like(host_item, ITEM_NONE)
    pending = active & (host_item < 0)
    ft2 = 0
    while bool(pending.any()) and ft2 < rule.recurse_tries:
        cand, ok = _descend(arrays, btype, max_depth, host_bno, x, base + ft2,
                            0, pending, draws)
        collide2 = (slot_valid & (out2 == cand[:, None])).any(dim=1)
        ok = ok & ~collide2 & ~_is_out(dev_weights, cand, x)
        leaf = torch.where(pending & ok, cand, leaf)
        pending = pending & ~ok
        ft2 += 1
    # host_item may already be a device ("we already have a leaf")
    leaf = torch.where(active & (host_item >= 0), host_item, leaf)
    return leaf, active & (leaf != ITEM_NONE)


def _choose_firstn_vec(arrays, btype, max_depth, dev_weights, rule, R,
                       root_bno, xs, draws):
    """Vectorised crush_choose_firstn + chooseleaf recursion. Each lane
    carries (rep, ftotal, pos): success advances rep and resets ftotal,
    exhaustion (ftotal == tries) skips the rep."""
    n = xs.shape[0]
    dev = xs.device
    recurse_to_leaf = rule.op == cm.OP_CHOOSELEAF_FIRSTN
    out = torch.full((n, R), ITEM_NONE, dtype=torch.int32, device=dev)
    out2 = torch.full((n, R), ITEM_NONE, dtype=torch.int32, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    rep = torch.zeros(n, dtype=torch.int64, device=dev)
    ftotal = torch.zeros(n, dtype=torch.int64, device=dev)
    cols = torch.arange(R, dtype=torch.int64, device=dev)[None, :]
    while True:
        active = (rep < R) & (pos < R)
        if not bool(active.any()):
            break
        r = rep + ftotal
        cand, ok = _descend(arrays, btype, max_depth, root_bno, xs, r,
                            rule.choose_type, active, draws)
        collide = ((cols < pos[:, None]) & (out == cand[:, None])).any(dim=1)
        ok = ok & ~collide
        if recurse_to_leaf:
            leaf, leaf_ok = _leaf_attempts(arrays, btype, max_depth,
                                           dev_weights, rule, R, cand, r,
                                           pos, xs, ok, out2, draws)
            ok = ok & leaf_ok
        else:
            leaf = cand
        if rule.choose_type == 0:
            ok = ok & ~_is_out(dev_weights, cand, xs)
        success = active & ok
        write = (cols == pos[:, None]) & success[:, None]
        out = torch.where(write, cand[:, None], out)
        out2 = torch.where(write, leaf[:, None], out2)
        pos = pos + success.long()
        fail = active & ~success
        exhausted = fail & (ftotal + 1 >= rule.choose_tries)
        rep = rep + success.long() + exhausted.long()
        ftotal = torch.where(success | exhausted, 0, ftotal + fail.long())
    return out2 if recurse_to_leaf else out


def _choose_indep_vec(arrays, btype, max_depth, dev_weights, rule, R,
                      root_bno, xs, draws):
    """Vectorised crush_choose_indep + chooseleaf recursion (positional).
    The C's round structure (for ftotal: for rep: retry UNDEF slots) is
    scanned one (ftotal, rep) pair at a time for every lane; lanes whose
    slot is already placed do nothing."""
    n = xs.shape[0]
    dev = xs.device
    recurse_to_leaf = rule.op == cm.OP_CHOOSELEAF_INDEP
    numrep = R
    out = torch.full((n, R), ITEM_UNDEF, dtype=torch.int32, device=dev)
    out2 = torch.full((n, R), ITEM_UNDEF, dtype=torch.int32, device=dev)

    def leaf_indep(host_item, parent_r, rep, active):
        """Recursive indep chooseleaf: left=1 at position rep, its own
        recurse_tries round loop."""
        host_bno = (-1 - host_item.long()).clamp(0, btype.shape[0] - 1)
        leaf = torch.full_like(host_item, ITEM_UNDEF)
        ft2 = 0
        while ft2 < rule.recurse_tries:
            pending = active & (leaf == ITEM_UNDEF)
            if not bool(pending.any()):
                break
            r2 = rep + parent_r + numrep * ft2
            cand, ok = _descend(arrays, btype, max_depth, host_bno, xs, r2,
                                0, pending & (host_item < 0), draws)
            ok = ok & ~_is_out(dev_weights, cand, xs)
            leaf = torch.where(pending & ok, cand, leaf)
            ft2 += 1
        return torch.where(active & (host_item >= 0), host_item, leaf)

    for ftotal in range(rule.choose_tries):
        # a round visits only the ranks some lane still lacks: a rank's
        # column changes only at its own turn in the round
        todo = (out == ITEM_UNDEF).any(dim=0).nonzero().flatten().tolist()
        if not todo:
            break
        for rep in todo:
            pending = out[:, rep] == ITEM_UNDEF
            r = torch.full((n,), rep + numrep * ftotal, dtype=torch.int64,
                           device=dev)
            cand, ok = _descend(arrays, btype, max_depth, root_bno, xs, r,
                                rule.choose_type, pending, draws)
            ok = ok & (out == cand[:, None]).any(dim=1).logical_not()
            if recurse_to_leaf:
                leaf = leaf_indep(cand, r, rep, ok)
                ok = ok & (leaf != ITEM_UNDEF)
            else:
                leaf = cand
            if rule.choose_type == 0:
                ok = ok & ~_is_out(dev_weights, cand, xs)
            success = pending & ok
            out[:, rep] = torch.where(success, cand, out[:, rep])
            out2[:, rep] = torch.where(success, leaf, out2[:, rep])
    res = out2 if recurse_to_leaf else out
    return torch.where(res == ITEM_UNDEF, ITEM_NONE, res)


def rule_rows_plain(compiled: CompiledMap, dev_weights, xs,
                    rule: CompiledRule, R: int,
                    draws: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of the engine on ``xs``' device: the compiled
    map's arrays there, dev_weights (nw,) and xs (N,) int32 holding
    uint32 -> (N, R) int32 rows. ``draws``, a (1,) int64 tensor on that
    device, gains the straw2 draws these inputs need, counted as the
    kernel counts them."""
    items, weights, sizes, btype = compiled.arrays_on(xs.device)
    args = ((items, weights, sizes), btype, compiled.max_depth,
            dev_weights.to(torch.int64) & 0xFFFFFFFF)
    x64 = xs.to(torch.int64) & 0xFFFFFFFF
    root = torch.full((xs.shape[0],), -1 - rule.take, dtype=torch.int64,
                      device=xs.device)
    if rule.op in (cm.OP_CHOOSE_FIRSTN, cm.OP_CHOOSELEAF_FIRSTN):
        return _choose_firstn_vec(*args, rule, R, root, x64, draws)
    return _choose_indep_vec(*args, rule, R, root, x64, draws)


def rule_rows(compiled: CompiledMap, dev_weights, xs, rule: CompiledRule,
              R: int, draws: torch.Tensor | None = None,
              group: int | None = None) -> torch.Tensor:
    """(N, R) int32 rows: the CUDA kernel for CUDA tensors (one launch,
    ``group`` lanes an input, by default ``group_width``'s choice for
    this batch; every width gives the same rows), the plain version for
    CPU ones. ``draws``, a (1,) int64 tensor on ``xs``' device, gains the
    number of straw2 draws made (the work these inputs need)."""
    if xs.device.type == "cpu":
        return rule_rows_plain(compiled, dev_weights, xs, rule, R, draws)
    if xs.device.type != "cuda":
        raise ValueError(f"no CRUSH rule kernel for device {xs.device}")
    firstn = rule.op in (cm.OP_CHOOSE_FIRSTN, cm.OP_CHOOSELEAF_FIRSTN)
    leaf = rule.op in (cm.OP_CHOOSELEAF_FIRSTN, cm.OP_CHOOSELEAF_INDEP)
    params = {"root_bno": -1 - rule.take, "firstn": int(firstn),
              "leaf": int(leaf), "numrep": R,
              "choose_type": rule.choose_type, "tries": rule.choose_tries,
              "recurse_tries": rule.recurse_tries, "vary_r": rule.vary_r,
              "stable": rule.stable, "max_depth": compiled.max_depth,
              "group": group or group_width(compiled.widest(rule.take),
                                            xs.shape[0],
                                            card_lanes(xs.device))}
    return kernels.crush_rule(*compiled.arrays_on(xs.device),
                              dev_weights.contiguous(), xs.contiguous(),
                              crush_ops.kernel_tables(str(xs.device)), params,
                              draws)


# --------------------------------------------------------------- dispatch


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def do_rule_bulk(
    compiled: CompiledMap,
    ruleno: int,
    xs: np.ndarray,
    numrep: int,
    weights: np.ndarray | None = None,
    chunk: int = 1 << 18,
    device=None,
) -> np.ndarray:
    """(N,) placement inputs -> (N, numrep) int32 osds (ITEM_NONE holes).

    firstn results are compacted per lane like the C (no holes, short
    rows padded with ITEM_NONE at the tail); indep results are
    positional. Runs on the card unless ``device`` names another: one
    kernel launch per call there; the plain version (``"cpu"``) walks
    the batch in chunks of ``chunk`` to bound its temporaries. The map's
    arrays go to the device once per CompiledMap, the reweight vector
    with every call.
    """
    rule = compiled.compile_rule(ruleno, numrep)
    nr = rule.numrep_arg if rule.numrep_arg > 0 else numrep + rule.numrep_arg
    r_eff = min(nr, numrep)
    dev = resolve(device)
    if weights is None:
        weights = np.full(compiled.max_devices, 0x10000, dtype=np.uint32)
    xs = np.ascontiguousarray(xs, dtype=np.uint32)
    if r_eff <= 0 or len(xs) == 0:
        return np.full((len(xs), max(r_eff, 0)), ITEM_NONE, dtype=np.int32)
    dev_weights = _u32_tensor(weights, dev)
    xs_t = _u32_tensor(xs, dev)
    step = len(xs) if dev.type == "cuda" else max(1, chunk)
    outs = [rule_rows(compiled, dev_weights, xs_t[lo:lo + step], rule, r_eff)
            for lo in range(0, len(xs), step)]
    return torch.cat(outs).cpu().numpy()
