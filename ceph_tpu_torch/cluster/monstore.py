"""MonStore: the monitor's durable state on the native kv.

The MonitorDBStore role (reference src/mon/MonitorDBStore.h:37): every
piece of mon state — the full OSDMap, the incremental history, Paxos
first/last_committed and accept obligations (src/mon/Paxos.h:24-104),
the central config DB, and allocation counters — rides the native C++
kv store (CRC-framed WAL + snapshot compaction, native/rt_native.cc),
so a full-cluster restart recovers the cluster maps from disk instead
of losing them with the process.

Key schema (all values explicit LE denc):
  ``m:full``          encoded full OSDMap at last_committed
  ``m:inc:<e>``       encoded Incremental for epoch e (10-digit key
                      so lexicographic scan order == epoch order)
  ``m:last``          u32 last committed epoch
  ``m:npool``         u32 next pool id
  ``p:promised``      u64 promised proposal number
  ``p:accepted``      u64 accepted proposal number
  ``p:uncommitted``   (u64 pn, u32 version, bytes value) — the accept
                      obligation that must survive a crash: a peon that
                      acked a begin must re-propose it after restart
  ``c:<who>\\0<key>``  config DB entry

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/monstore.py``.
"""
from __future__ import annotations

from ..native.rt import NativeKV
from ..utils import denc


def _inc_key(epoch: int) -> bytes:
    return b"m:inc:%010d" % epoch


class MonStore:
    def __init__(self, path: str, fsync: bool = False):
        self.kv = NativeKV(path, fsync=fsync)

    def close(self) -> None:
        self.kv.close()

    @property
    def closed(self) -> bool:
        # in-flight handler tasks can outlive stop(); their persists
        # become quiet no-ops instead of hitting a closed native handle
        return self.kv._h is None

    # ------------------------------------------------------------- maps

    def save_map(self, full: bytes, epoch: int, inc_raw: bytes | None,
                 inc_epoch: int = 0, next_pool_id: int | None = None,
                 ) -> None:
        """One atomic batch per commit: the new full map, the
        incremental that produced it, and the committed epoch."""
        if self.closed:
            return
        ops = [
            ("put", b"m:full", full),
            ("put", b"m:last", denc.enc_u32(epoch)),
        ]
        if inc_raw is not None:
            ops.append(("put", _inc_key(inc_epoch), inc_raw))
        if next_pool_id is not None:
            ops.append(("put", b"m:npool", denc.enc_u32(next_pool_id)))
        self.kv.batch(ops)

    def load_map(self):
        """-> (full bytes, last epoch, {epoch: inc bytes}, next_pool_id)
        or None when the store is empty (first boot)."""
        full = self.kv.get(b"m:full")
        if full is None:
            return None
        last = denc.dec_u32(self.kv.get(b"m:last"), 0)[0]
        history = {}
        for k, v in self.kv.scan_prefix(b"m:inc:"):
            history[int(k[len(b"m:inc:"):])] = v
        npool_raw = self.kv.get(b"m:npool")
        npool = denc.dec_u32(npool_raw, 0)[0] if npool_raw else 1
        return full, last, history, npool

    # ------------------------------------------------------------ paxos

    def save_paxos(self, pn: int, promised_pn: int, accepted_pn: int,
                   uncommitted: tuple[int, int, bytes] | None) -> None:
        """Persist BEFORE acking a begin or a collect (the Paxos
        durability obligation, Paxos.cc:613 handle_begin -> store txn):
        promises, acceptances, AND the proposer's own pn — a restarted
        leader must never issue a pn at or below one already promised."""
        if self.closed:
            return
        ops = [
            ("put", b"p:pn", denc.enc_u64(pn)),
            ("put", b"p:promised", denc.enc_u64(promised_pn)),
            ("put", b"p:accepted", denc.enc_u64(accepted_pn)),
        ]
        if uncommitted is None:
            ops.append(("del", b"p:uncommitted", None))
        else:
            upn, version, value = uncommitted
            ops.append(("put", b"p:uncommitted",
                        denc.enc_u64(upn) + denc.enc_u32(version)
                        + denc.enc_bytes(value)))
        self.kv.batch(ops)

    def load_paxos(self):
        """-> (pn, promised_pn, accepted_pn, uncommitted | None)."""
        raw_n = self.kv.get(b"p:pn")
        raw_p = self.kv.get(b"p:promised")
        raw_a = self.kv.get(b"p:accepted")
        pn = denc.dec_u64(raw_n, 0)[0] if raw_n else 0
        promised = denc.dec_u64(raw_p, 0)[0] if raw_p else 0
        accepted = denc.dec_u64(raw_a, 0)[0] if raw_a else 0
        raw_u = self.kv.get(b"p:uncommitted")
        uncommitted = None
        if raw_u:
            upn, off = denc.dec_u64(raw_u, 0)
            version, off = denc.dec_u32(raw_u, off)
            value, _ = denc.dec_bytes(raw_u, off)
            uncommitted = (upn, version, value)
        return pn, promised, accepted, uncommitted

    # ----------------------------------------------------------- config

    def save_config(self, who: str, key: str, value: str) -> None:
        if self.closed:
            return
        self.kv.put(b"c:" + who.encode() + b"\0" + key.encode(),
                    value.encode())

    def load_config(self) -> dict[tuple[str, str], str]:
        out = {}
        for k, v in self.kv.scan_prefix(b"c:"):
            who, _, key = k[2:].partition(b"\0")
            out[(who.decode(), key.decode())] = v.decode()
        return out

    def replace_config(self, db: dict[tuple[str, str], str]) -> None:
        """Peon mirror update: replace the whole config DB atomically."""
        if self.closed:
            return
        ops = [("del", k, None) for k, _ in self.kv.scan_prefix(b"c:")]
        for (who, key), v in db.items():
            ops.append(("put",
                        b"c:" + who.encode() + b"\0" + key.encode(),
                        v.encode()))
        if ops:
            self.kv.batch(ops)
