"""MonCommand surface: the `ceph` CLI's server side.

The reference declares every command as a signature string in
src/mon/MonCommands.h and validates/dispatches argv against that table
(src/ceph.in validate_command); clients fetch the table itself with the
special `get_command_descriptions` command. Same seam here: COMMANDS is
the descriptor table, `dispatch` validates a JSON cmd object against it
and runs the handler against the live MonLite/PaxosMon.

Signature mini-language (one string per command): space-separated
tokens; a plain token is a literal, `name=<n>,type=<t>[,req=0][,n=N]`
declares a parameter (types: int, float, str; n=N marks a variadic
tail that swallows remaining argv words). The CLI parses argv by
longest-literal-prefix match over this table — no client-side command
knowledge, exactly the reference's stance.

Stats-backed commands (`status`, `df`, `pg stat`) are served from the
last MMgrDigest the mgr pushed (MgrStatMonitor role); without a mgr
they degrade to map-only output.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/moncommands.py``.
"""
from __future__ import annotations

import json

from . import messages as M

# ------------------------------------------------------------ descriptors

COMMANDS: list[dict] = []
_HANDLERS: dict[str, object] = {}


def _command(sig: str, helptext: str):
    """Register a command: prefix = the literal tokens."""

    def deco(fn):
        prefix = " ".join(
            t for t in sig.split() if "=" not in t)
        COMMANDS.append({"sig": sig, "help": helptext, "prefix": prefix})
        _HANDLERS[prefix] = fn
        return fn

    return deco


def parse_sig(sig: str) -> tuple[list[str], list[dict]]:
    """Split a signature into (literal tokens, param specs)."""
    lits, params = [], []
    for tok in sig.split():
        if "=" not in tok:
            lits.append(tok)
            continue
        spec: dict = {"req": True, "n": 1}
        for part in tok.split(","):
            k, _, v = part.partition("=")
            if k == "name":
                spec["name"] = v
            elif k == "type":
                spec["type"] = v
            elif k == "strings":
                spec["strings"] = v.split("|")
            elif k == "req":
                spec["req"] = v not in ("0", "false")
            elif k == "n":
                spec["n"] = 0 if v == "N" else int(v)
        params.append(spec)
    return lits, params


def _coerce(spec: dict, word: str):
    t = spec.get("type", "str")
    if t == "int":
        return int(word)
    if t == "float":
        return float(word)
    if t == "choice" and word not in spec.get("strings", []):
        raise ValueError(f"{word!r} not in {spec.get('strings')}")
    return word


def match_argv(argv: list[str]) -> dict | None:
    """argv -> {"prefix": ..., args} against COMMANDS (the ceph.in
    validate_command role); None when nothing matches."""
    best = None
    for desc in COMMANDS:
        lits, params = parse_sig(desc["sig"])
        if argv[: len(lits)] != lits:
            continue
        rest = argv[len(lits):]
        cmd = {"prefix": desc["prefix"]}
        ok = True
        for spec in params:
            if spec["n"] == 0:  # variadic tail
                if not rest and spec["req"]:
                    ok = False
                try:
                    cmd[spec["name"]] = [
                        _coerce(spec, w) for w in rest]
                except ValueError:
                    ok = False
                rest = []
                break
            if not rest:
                if spec["req"]:
                    ok = False
                break
            try:
                cmd[spec["name"]] = _coerce(spec, rest[0])
            except ValueError:
                ok = False
                break
            rest = rest[1:]
        if rest or not ok:
            continue
        if best is None or len(desc["prefix"]) > len(best["prefix"]):
            best = cmd
    return best


async def dispatch(mon, cmd: dict) -> tuple[int, str, bytes]:
    """Run one validated command object; returns (rc, outs, outb)."""
    fn = _HANDLERS.get(cmd.get("prefix", ""))
    if fn is None:
        return (-22, f"unrecognized command {cmd.get('prefix')!r}", b"")
    try:
        return await fn(mon, cmd)
    except (KeyError, IndexError) as e:
        return (M.ENOENT, f"not found: {e}", b"")
    except ValueError as e:
        return (-22, str(e), b"")


def _ok(outs: str = "", obj=None) -> tuple[int, str, bytes]:
    return (M.OK, outs,
            json.dumps(obj).encode() if obj is not None else b"")


# ------------------------------------------------------------- commands


@_command("get_command_descriptions",
          "list available commands (ceph.in bootstrap)")
async def _cmd_descriptions(mon, cmd):
    return _ok(obj=COMMANDS)


@_command("version", "show mon version")
async def _cmd_version(mon, cmd):
    return _ok("ceph-tpu version 5.0", {"version": "5.0"})


@_command("status", "show cluster status (ceph -s)")
async def _cmd_status(mon, cmd):
    omap = mon.osdmap
    dig = getattr(mon, "mgr_digest", None) or {}
    up = sum(1 for o in omap.osds if o.up)
    inn = sum(1 for o in omap.osds if o.weight > 0)
    health = _health(mon)
    obj = {
        "health": health["status"],
        "monmap": _mon_stat(mon),
        "osdmap": {"epoch": omap.epoch, "num_osds": omap.n_osds,
                   "num_up_osds": up, "num_in_osds": inn},
        "pgmap": {
            "num_pools": len(omap.pools),
            "pgs_by_state": dig.get("pg_states", {}),
            "bytes_used": sum(
                v[0] for v in dig.get("pools", {}).values()),
            "objects": sum(
                v[1] for v in dig.get("pools", {}).values()),
        },
    }
    lines = [
        f"  cluster: {health['status']}",
        f"  monmap:  {obj['monmap']['num_mons']} mons, "
        f"leader rank {obj['monmap'].get('leader')}",
        f"  osdmap:  e{omap.epoch} {omap.n_osds} osds: "
        f"{up} up, {inn} in",
        f"  pools:   {len(omap.pools)} pools, "
        f"{obj['pgmap']['objects']} objects, "
        f"{obj['pgmap']['bytes_used']} bytes",
        f"  pgs:     " + ", ".join(
            f"{n} {s}" for s, n in sorted(
                obj["pgmap"]["pgs_by_state"].items())),
    ]
    return _ok("\n".join(lines), obj)


def _health(mon) -> dict:
    """Map-derived health checks (the mon's own view; the mgr adds
    report-staleness checks on its side)."""
    checks: dict[str, str] = {}
    omap = mon.osdmap
    down = [i for i, o in enumerate(omap.osds) if o.exists and not o.up]
    if down:
        checks["OSD_DOWN"] = f"{len(down)} osds down: {down}"
    out = [i for i, o in enumerate(omap.osds)
           if o.exists and o.weight == 0]
    if out:
        checks["OSD_OUT"] = f"{len(out)} osds out: {out}"
    dig = getattr(mon, "mgr_digest", None) or {}
    inactive = sum(n for s, n in dig.get("pg_states", {}).items()
                   if s != "active")
    if inactive:
        checks["PG_NOT_ACTIVE"] = f"{inactive} pg instances not active"
    full = getattr(mon, "full_pools", None) or {}
    if full:
        checks["POOL_FULL"] = (
            "pool quota reached: "
            + ", ".join(sorted(full.values())))
    return {"status": "HEALTH_OK" if not checks else "HEALTH_WARN",
            "checks": checks}


@_command("health name=detail,type=choice,strings=detail,req=0",
          "cluster health [detail]")
async def _cmd_health(mon, cmd):
    h = _health(mon)
    outs = h["status"]
    if cmd.get("detail") == "detail" and h["checks"]:
        outs += "\n" + "\n".join(
            f"{k}: {v}" for k, v in sorted(h["checks"].items()))
    return _ok(outs, h)


@_command("df", "pool usage (from the mgr digest)")
async def _cmd_df(mon, cmd):
    dig = getattr(mon, "mgr_digest", None) or {}
    pools = []
    for pid, pool in sorted(mon.osdmap.pools.items()):
        used, objs = dig.get("pools", {}).get(str(pid), (0, 0))
        pools.append({"name": pool.name, "id": pid,
                      "stored_bytes": used, "objects": objs})
    lines = ["POOL            ID   STORED   OBJECTS"] + [
        f"{p['name']:<15} {p['id']:<4} {p['stored_bytes']:<8} "
        f"{p['objects']}" for p in pools]
    return _ok("\n".join(lines), {"pools": pools})


@_command("pg stat", "pg state counts")
async def _cmd_pg_stat(mon, cmd):
    dig = getattr(mon, "mgr_digest", None) or {}
    states = dig.get("pg_states", {})
    total = sum(states.values())
    outs = f"{total} pgs: " + ", ".join(
        f"{n} {s}" for s, n in sorted(states.items()))
    return _ok(outs, {"num_pgs": total, "pgs_by_state": states})


def _mon_stat(mon) -> dict:
    rank = getattr(mon, "rank", 0)
    quorum = sorted(getattr(mon, "quorum", {rank}) or {rank})
    leader = getattr(mon, "leader", rank)
    n = getattr(mon, "n_mons", 1)
    return {"num_mons": n, "rank": rank, "quorum": quorum,
            "leader": leader if leader is not None else -1}


@_command("mon stat", "monmap/quorum summary")
async def _cmd_mon_stat(mon, cmd):
    st = _mon_stat(mon)
    return _ok(
        f"{st['num_mons']} mons, quorum {st['quorum']}, "
        f"leader rank {st['leader']}", st)


@_command("quorum_status", "quorum detail")
async def _cmd_quorum(mon, cmd):
    return _ok(obj=_mon_stat(mon))


# ------------------------------------------------------------------ osd


@_command("osd stat", "osd up/in counts")
async def _cmd_osd_stat(mon, cmd):
    omap = mon.osdmap
    up = sum(1 for o in omap.osds if o.up)
    inn = sum(1 for o in omap.osds if o.weight > 0)
    outs = f"{omap.n_osds} osds: {up} up, {inn} in; epoch e{omap.epoch}"
    return _ok(outs, {"num_osds": omap.n_osds, "num_up_osds": up,
                      "num_in_osds": inn, "epoch": omap.epoch})


@_command("osd ls", "list osd ids")
async def _cmd_osd_ls(mon, cmd):
    ids = [i for i, o in enumerate(mon.osdmap.osds) if o.exists]
    return _ok("\n".join(str(i) for i in ids), ids)


@_command("osd tree", "CRUSH hierarchy with osd states")
async def _cmd_osd_tree(mon, cmd):
    omap = mon.osdmap
    crush = omap.crush
    nodes = []
    lines = []

    def osd_row(item: int, depth: int, weight: int):
        st = omap.osds[item]
        status = "up" if st.up else "down"
        reweight = st.weight / 0x10000
        nodes.append({"id": item, "name": f"osd.{item}", "type": "osd",
                      "crush_weight": weight / 0x10000,
                      "status": status, "reweight": reweight})
        lines.append(f"{'  ' * depth}{item:>4}  osd.{item:<8} "
                     f"{weight / 0x10000:<8.4f} {status:<5} "
                     f"{reweight:.4f}")

    def walk(bid: int, depth: int, weight: int):
        if bid >= 0:
            osd_row(bid, depth, weight)
            return
        b = crush.buckets[bid]
        tname = crush.types.get(b.type_id, str(b.type_id))
        nodes.append({"id": bid, "name": b.name or f"{tname}{bid}",
                      "type": tname,
                      "crush_weight": b.weight() / 0x10000,
                      "children": list(b.items)})
        lines.append(f"{'  ' * depth}{bid:>4}  {tname} "
                     f"{b.name or bid}")
        for item, w in zip(b.items, b.weights):
            walk(item, depth + 1, w)

    roots = set(crush.buckets) - {
        i for b in crush.buckets.values() for i in b.items}
    for r in sorted(roots, reverse=True):
        walk(r, 0, crush.buckets[r].weight())
    return _ok("\n".join(lines), nodes)


async def _mark(mon, ids: list[int], what: str) -> tuple[int, str, bytes]:
    inc = mon._new_inc()
    changed = []
    for i in ids:
        if not (0 <= i < mon.osdmap.n_osds):
            return (M.ENOENT, f"osd.{i} does not exist", b"")
        st = mon.osdmap.osds[i]
        if what == "down" and st.up:
            inc.down.append(i)
            changed.append(i)
        elif what == "out" and st.weight != 0:
            inc.weights[i] = 0
            changed.append(i)
        elif what == "in" and st.weight == 0:
            inc.weights[i] = 0x10000
            changed.append(i)
    if changed:
        await mon.commit(inc)
    return _ok(f"marked {what} {changed}" if changed
               else f"already {what}")


@_command("osd down name=ids,type=int,n=N", "mark osd(s) down")
async def _cmd_osd_down(mon, cmd):
    return await _mark(mon, cmd["ids"], "down")


@_command("osd out name=ids,type=int,n=N", "mark osd(s) out")
async def _cmd_osd_out(mon, cmd):
    return await _mark(mon, cmd["ids"], "out")


@_command("osd in name=ids,type=int,n=N", "mark osd(s) in")
async def _cmd_osd_in(mon, cmd):
    return await _mark(mon, cmd["ids"], "in")


@_command("osd reweight name=id,type=int name=weight,type=float",
          "set in/out reweight [0..1]")
async def _cmd_osd_reweight(mon, cmd):
    i, w = cmd["id"], cmd["weight"]
    if not (0 <= i < mon.osdmap.n_osds):
        return (M.ENOENT, f"osd.{i} does not exist", b"")
    if not (0.0 <= w <= 1.0):
        raise ValueError("weight must be in [0, 1]")
    inc = mon._new_inc()
    inc.weights[i] = int(w * 0x10000)
    await mon.commit(inc)
    return _ok(f"reweighted osd.{i} to {w}")


@_command("osd df", "per-osd usage from the mgr digest")
async def _cmd_osd_df(mon, cmd):
    dig = getattr(mon, "mgr_digest", None) or {}
    usage = dig.get("osds", {})
    rows = []
    for i, st in enumerate(mon.osdmap.osds):
        if not st.exists:
            continue
        used, pgs = usage.get(str(i), (0, 0))
        rows.append({"id": i, "status": "up" if st.up else "down",
                     "reweight": st.weight / 0x10000,
                     "used_bytes": used, "pgs": pgs})
    lines = ["ID  STATUS  REWEIGHT  USED      PGS"] + [
        f"{r['id']:<3} {r['status']:<7} {r['reweight']:<9.4f} "
        f"{r['used_bytes']:<9} {r['pgs']}" for r in rows]
    return _ok("\n".join(lines), rows)


@_command("osd pg-upmap-items name=pgid,type=str "
          "name=mappings,type=int,n=N",
          "pin PG replica replacements: pgid from to [from to ...]")
async def _cmd_pg_upmap_items(mon, cmd):
    try:
        pool_s, _, ps_s = cmd["pgid"].partition(".")
        pgid = (int(pool_s), int(ps_s))
    except ValueError:
        raise ValueError(f"bad pgid {cmd['pgid']!r} (want pool.ps)")
    if pgid[0] not in mon.osdmap.pools:
        return (M.ENOENT, f"pool {pgid[0]} does not exist", b"")
    flat = cmd["mappings"]
    if len(flat) % 2:
        raise ValueError("mappings must be from/to pairs")
    pairs = list(zip(flat[::2], flat[1::2]))
    await mon._handle_upmap_items(M.MUpmapItems(
        entries=[(pgid, pairs)]))
    if pairs:
        return _ok(f"upmap {cmd['pgid']} {pairs}")
    return _ok(f"cleared upmap on {cmd['pgid']}")


@_command("osd rm-pg-upmap-items name=pgid,type=str",
          "clear a PG's upmap entry")
async def _cmd_rm_pg_upmap_items(mon, cmd):
    cmd = dict(cmd, mappings=[], prefix="osd pg-upmap-items")
    return await _cmd_pg_upmap_items(mon, cmd)


@_command("osd blocklist ls", "list fenced clients")
async def _cmd_blocklist_ls(mon, cmd):
    bl = sorted(mon.osdmap.blocklist)
    return _ok("\n".join(bl), bl)


@_command("osd blocklist add name=entity,type=str", "fence a client")
async def _cmd_blocklist_add(mon, cmd):
    inc = mon._new_inc()
    inc.new_blocklist.append(cmd["entity"])
    await mon.commit(inc)
    return _ok(f"blocklisting {cmd['entity']}")


@_command("osd blocklist rm name=entity,type=str", "unfence a client")
async def _cmd_blocklist_rm(mon, cmd):
    if cmd["entity"] not in mon.osdmap.blocklist:
        return (M.ENOENT, f"{cmd['entity']} not blocklisted", b"")
    inc = mon._new_inc()
    inc.new_unblocklist.append(cmd["entity"])
    await mon.commit(inc)
    return _ok(f"un-blocklisting {cmd['entity']}")


# ------------------------------------------------------------ osd pool


@_command("osd pool ls name=detail,type=choice,strings=detail,req=0",
          "list pools [detail]")
async def _cmd_pool_ls(mon, cmd):
    pools = sorted(mon.osdmap.pools.values(), key=lambda p: p.id)
    if cmd.get("detail") == "detail":
        obj = [
            {"id": p.id, "name": p.name, "type": p.type,
             "size": p.size, "min_size": p.min_size,
             "pg_num": p.pg_num, "pgp_num": p.pgp_num or p.pg_num,
             "crush_rule": p.crush_rule,
             "ec_profile": dict(p.ec_profile),
             "quota_max_bytes": p.quota_max_bytes,
             "quota_max_objects": p.quota_max_objects,
             "full": p.full}
            for p in pools]
        outs = "\n".join(
            f"pool {p['id']} '{p['name']}' {p['type']} size {p['size']} "
            f"min_size {p['min_size']} pg_num {p['pg_num']}"
            for p in obj)
        return _ok(outs, obj)
    names = [p.name for p in pools]
    return _ok("\n".join(names), names)


@_command("osd pool get name=pool,type=str name=var,type=str",
          "get one pool parameter")
async def _cmd_pool_get(mon, cmd):
    pool = next((p for p in mon.osdmap.pools.values()
                 if p.name == cmd["pool"]), None)
    if pool is None:
        return (M.ENOENT, f"pool '{cmd['pool']}' not found", b"")
    var = cmd["var"]
    if not hasattr(pool, var):
        raise ValueError(f"unknown pool parameter {var!r}")
    val = getattr(pool, var)
    if var == "ec_profile":
        val = dict(val)
    return _ok(f"{var}: {val}", {var: val})


@_command(
    "osd pool create name=pool,type=str name=pg_num,type=int "
    "name=kind,type=str,req=0 name=a,type=int,req=0 "
    "name=b,type=int,req=0",
    "create a pool: replicated [size] | erasure [k m]")
async def _cmd_pool_create(mon, cmd):
    from ..placement.osdmap import Pool

    kind = cmd.get("kind", "replicated")
    if kind not in ("replicated", "erasure"):
        raise ValueError("pool kind must be replicated|erasure")
    if kind == "erasure":
        k = cmd.get("a", 2)
        m = cmd.get("b", 1)
        pool = Pool(id=-1, name=cmd["pool"], size=k + m, min_size=k,
                    pg_num=cmd["pg_num"], type="erasure", crush_rule=1,
                    ec_profile={"k": str(k), "m": str(m),
                                "plugin": "isa"})
    else:
        size = cmd.get("a", 3)
        pool = Pool(id=-1, name=cmd["pool"], size=size,
                    min_size=max(1, size - 1), pg_num=cmd["pg_num"])
    rc, pool_id = await mon.pool_create(pool)
    if rc != M.OK:
        return (rc, f"pool '{cmd['pool']}' exists with a different "
                    "spec", b"")
    return _ok(f"pool '{cmd['pool']}' created (id {pool_id})",
               {"pool_id": pool_id})


@_command(
    "osd pool rm name=pool,type=str name=pool2,type=str,req=0 "
    "name=sure,type=str,req=0",
    "remove a pool (name twice + --yes-i-really-really-mean-it; "
    "requires mon_allow_pool_delete)")
async def _cmd_pool_rm(mon, cmd):
    """Pool deletion is irreversible — OSDs purge every object and
    collection on the next epoch — so it is triple-interlocked like
    the reference (OSDMonitor::prepare_command pool delete guards):
    the mon_allow_pool_delete config flag, the pool name repeated,
    and the --yes-i-really-really-mean-it literal."""
    pool = next((p for p in mon.osdmap.pools.values()
                 if p.name == cmd["pool"]), None)
    if pool is None:
        return (M.ENOENT, f"pool '{cmd['pool']}' not found", b"")
    allow = str(mon.config_db.get(("mon", "mon_allow_pool_delete"),
                                  "false")).lower()
    if allow not in ("true", "1", "yes"):
        return (M.EPERM,
                "pool deletion is disabled; you must first set the "
                "mon_allow_pool_delete config option to true before "
                "you can destroy a pool", b"")
    if cmd.get("pool2") != cmd["pool"] or \
            cmd.get("sure") != "--yes-i-really-really-mean-it":
        return (M.EPERM,
                f"WARNING: this will PERMANENTLY DESTROY all data in "
                f"pool '{cmd['pool']}'. If you are ABSOLUTELY CERTAIN "
                f"that is what you want, pass the pool name twice, "
                f"followed by --yes-i-really-really-mean-it.", b"")
    inc = mon._new_inc()
    inc.removed_pools.append(pool.id)
    await mon.commit(inc)
    mon.full_pools.pop(pool.id, None)
    return _ok(f"pool '{cmd['pool']}' removed")


@_command(
    "osd pool set name=pool,type=str name=var,type=str "
    "name=val,type=str",
    "set a pool parameter (pg_num/pgp_num/quotas)")
async def _cmd_pool_set(mon, cmd):
    pool = next((p for p in mon.osdmap.pools.values()
                 if p.name == cmd["pool"]), None)
    if pool is None:
        return (M.ENOENT, f"pool '{cmd['pool']}' not found", b"")
    rc = await mon.pool_set(pool.id, cmd["var"], cmd["val"])
    if rc != M.OK:
        return (rc, f"set {cmd['var']} failed ({rc})", b"")
    return _ok(f"set pool {pool.id} {cmd['var']} to {cmd['val']}")


# --------------------------------------------------------------- config


@_command("config set name=who,type=str name=key,type=str "
          "name=value,type=str", "central config set")
async def _cmd_config_set(mon, cmd):
    await mon._handle_config_set(M.MConfigSet(
        who=cmd["who"], key=cmd["key"], value=cmd["value"]))
    return _ok(f"set {cmd['who']}/{cmd['key']}")


@_command("config get name=who,type=str name=key,type=str,req=0",
          "central config get")
async def _cmd_config_get(mon, cmd):
    if "key" in cmd and cmd["key"]:
        val = mon.config_db.get((cmd["who"], cmd["key"]))
        if val is None:
            return (M.ENOENT, "", b"")
        return _ok(val, {cmd["key"]: val})
    entries = {k: v for (w, k), v in mon.config_db.items()
               if w == cmd["who"]}
    return _ok("\n".join(f"{k} = {v}" for k, v in sorted(
        entries.items())), entries)


@_command("config dump", "dump the central config DB")
async def _cmd_config_dump(mon, cmd):
    entries = [
        {"who": w, "key": k, "value": v}
        for (w, k), v in sorted(mon.config_db.items())]
    outs = "\n".join(f"{e['who']:<10} {e['key']} = {e['value']}"
                     for e in entries)
    return _ok(outs, entries)
