"""Config system: typed option schema + proxy with change observers
(the src/common/config.h + src/common/options/*.yaml.in role).

Options are declared once in a schema (type, default, bounds, enum,
level, description — the yaml.in fields that matter at runtime);
ConfigProxy gives typed get/set with validation, tracks which values
were explicitly set, and fires registered observers on change the way
md_config_obs_t subscribers re-read their cached values
(e.g. BlueStore re-reading bluestore_csum_type, BlueStore.cc:4715).

Sources are layered like the reference (defaults < file < env < cli <
runtime `set`), collapsed eagerly: the last write wins, `reset` returns
an option to its default.

This is ceph_tpu_torch's own copy of ``ceph_tpu/utils/config.py`` with
the whole options table (the tests hold every name, type, default and
bound equal to the JAX package's), so the cluster tier can read it.
``osd_ec_mesh_devices`` > 1 and ``parallel_repair_mode`` other than off
run the ECBatcher over a device mesh (``parallel/``): n cards, or a
virtual mesh on one device after ``parallel.pin_virtual``; a mesh that
cannot be had raises.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable


class ConfigError(Exception):
    pass


_TYPES = {
    "str": str,
    "int": int,
    "float": float,
    "bool": bool,
    "size": int,   # bytes; accepts "4K", "1M" style strings
    "secs": float,
}

_SIZE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


@dataclass(frozen=True)
class Option:
    name: str
    type: str = "str"
    default: Any = None
    desc: str = ""
    min: float | None = None
    max: float | None = None
    enum: tuple = ()
    #: runtime-updatable (the yaml `flags: runtime` marker); non-runtime
    #: options reject set() after freeze()
    runtime: bool = True

    def coerce(self, value: Any) -> Any:
        if self.type not in _TYPES:
            raise ConfigError(f"{self.name}: unknown type {self.type!r}")
        if self.type == "bool":
            if isinstance(value, str):
                v = value.lower()
                if v in ("true", "yes", "1", "on"):
                    return True
                if v in ("false", "no", "0", "off"):
                    return False
                raise ConfigError(f"{self.name}: bad bool {value!r}")
            return bool(value)
        if self.type == "size" and isinstance(value, str):
            s = value.strip().lower().rstrip("ib")
            if s and s[-1] in _SIZE_SUFFIX:
                value = int(float(s[:-1]) * _SIZE_SUFFIX[s[-1]])
            else:
                value = int(s)
        try:
            out = _TYPES[self.type](value)
        except (TypeError, ValueError) as e:
            raise ConfigError(
                f"{self.name}: cannot parse {value!r} as {self.type}"
            ) from e
        if self.enum and out not in self.enum:
            raise ConfigError(
                f"{self.name}: {out!r} not in {self.enum}"
            )
        if self.min is not None and out < self.min:
            raise ConfigError(f"{self.name}: {out} < min {self.min}")
        if self.max is not None and out > self.max:
            raise ConfigError(f"{self.name}: {out} > max {self.max}")
        return out


class Schema:
    def __init__(self, options: Iterable[Option] = ()):
        self._options: dict[str, Option] = {}
        for o in options:
            self.add(o)

    def add(self, option: Option) -> None:
        if option.name in self._options:
            raise ConfigError(f"duplicate option {option.name!r}")
        self._options[option.name] = option

    def get(self, name: str) -> Option:
        try:
            return self._options[name]
        except KeyError:
            raise ConfigError(f"unknown option {name!r}") from None

    def names(self) -> list[str]:
        return sorted(self._options)


class ConfigProxy:
    """Typed live view over a Schema with observers."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._values: dict[str, Any] = {}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        self._frozen = False
        self._lock = threading.RLock()

    # -------------------------------------------------------------- get

    def get(self, name: str) -> Any:
        opt = self.schema.get(name)
        with self._lock:
            if name in self._values:
                return self._values[name]
        return opt.coerce(opt.default) if opt.default is not None else None

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def is_set(self, name: str) -> bool:
        self.schema.get(name)
        return name in self._values

    # -------------------------------------------------------------- set

    def set(self, name: str, value: Any) -> None:
        opt = self.schema.get(name)
        if self._frozen and not opt.runtime:
            raise ConfigError(
                f"{name} is not runtime-updatable (restart required)"
            )
        coerced = opt.coerce(value)
        with self._lock:
            old = self.get(name)
            self._values[name] = coerced
            observers = list(self._observers.get(name, ()))
        if coerced != old:
            for cb in observers:
                cb(name, coerced)

    def reset(self, name: str) -> None:
        self.schema.get(name)
        with self._lock:
            self._values.pop(name, None)

    def apply(self, values: dict[str, Any]) -> None:
        for k, v in values.items():
            self.set(k, v)

    def freeze(self) -> None:
        """Boot finished: non-runtime options lock (the mon pushes only
        runtime-updatable changes to live daemons)."""
        self._frozen = True

    # -------------------------------------------------------- observers

    def observe(self, name: str, cb: Callable[[str, Any], None]) -> None:
        """md_config_obs_t role: cb(name, new_value) fires on change."""
        self.schema.get(name)
        with self._lock:
            self._observers.setdefault(name, []).append(cb)

    # ------------------------------------------------------------- dump

    def show(self) -> dict[str, Any]:
        """`config show` role: every option's effective value."""
        return {n: self.get(n) for n in self.schema.names()}

    def diff(self) -> dict[str, Any]:
        """`config diff` role: only explicitly-set values."""
        with self._lock:
            return dict(self._values)


# ------------------------------------------------- framework defaults

SCHEMA = Schema([
    Option("osd_heartbeat_interval", "secs", 0.25,
           desc="OSD->mon ping period", min=0.001),
    Option("osd_heartbeat_grace", "secs", 2.0,
           desc="silence before an OSD is reported down", min=0.01),
    Option("mon_osd_down_out_interval", "secs", 4.0,
           desc="down this long -> out (weight 0, data re-flows)"),
    Option("osd_pg_log_keep", "int", 128,
           desc="PGLog entries retained for delta recovery", min=1),
    Option("osd_subop_timeout", "secs", 3.0,
           desc="peer sub-op reply deadline", min=0.01),
    Option("osd_max_backfills", "int", 2,
           desc="concurrent recoveries/backfills per OSD, local and "
                "remote slots alike (AsyncReserver role)", min=1),
    Option("osd_ec_batch_window", "secs", 0.0,
           desc="EC batch coalescing deadline: stripes accrete across "
                "reactor ticks up to this long before dispatch (0 = "
                "flush every tick; NIC-interrupt-coalescing role)"),
    Option("osd_ec_batch_target_stripes", "int", 64, min=0,
           desc="EC batch size target: a bucket reaching this many "
                "queued stripes flushes immediately, ahead of the "
                "window deadline (0 = no size trigger)"),
    Option("osd_op_concurrency", "int", 16, min=1,
           desc="client/recovery ops dispatched concurrently from the "
                "mClock queue; >1 lets EC stripes from different ops "
                "coalesce into one device batch (per-PG write ordering "
                "is preserved by the PG lock)"),
    Option("osd_ec_mesh_devices", "int", 0, min=0,
           desc="device count of the EC serving-path mesh: >1 pins the "
                "ECBatcher's staging to a (stripe, width) device mesh so "
                "batched stripes land sharded and the fused encode+CRC "
                "runs on the chip that owns each shard row (0/1 = the "
                "single-device path; degrades gracefully when the "
                "platform cannot supply the devices)"),
    Option("osd_ec_mesh_width", "int", 1, min=1,
           desc="width-axis size of the serving mesh (must divide "
                "osd_ec_mesh_devices): chunk words stripe across width "
                "devices, the remainder goes to the stripe/batch axis"),
    Option("parallel_repair_mode", "str", "off",
           enum=("off", "allgather", "psum_bits"),
           desc="EC repair/degraded-decode combine strategy on the "
                "mesh: off = single-device stacked-matrix decode; "
                "allgather / psum_bits = shard_comm's distributed GF "
                "matmul with recovery partials combined by mesh "
                "collectives instead of messenger fan-in (needs "
                "osd_ec_mesh_devices > 1)"),
    Option("osd_hedge_reads", "bool", True,
           desc="straggler-proof EC read dispatch: degraded reads and "
                "shard reconstructs fan sub-reads out to d > k "
                "candidates, complete on the first decodable subset "
                "and cancel the losers (first-sufficient-subset "
                "hedging); the CEPH_TPU_HEDGE=0 env lever forces it "
                "off for A/B runs"),
    Option("osd_hedge_delay_factor", "float", 2.0, min=1.0,
           desc="hedge trigger multiplier over the per-peer sub-op "
                "latency EWMA: extra candidates launch after factor x "
                "the upper-median EWMA of the planned peers (median, "
                "so one known straggler cannot postpone the hedge "
                "aimed at it), clamped to the client_backoff_base/"
                "client_backoff_max bounded-backoff shape"),
    Option("osd_hedge_max_extra", "int", 2, min=0,
           desc="hedge width: extra shard candidates (beyond the "
                "minimal decode plan) a single fan-out may launch "
                "(0 = plan-exact fan-out, hedging off)"),
    Option("osd_ec_overdecompose", "int", 0, min=0,
           desc="recovery-matmul over-decomposition factor: >0 splits "
                "each batched decode/repair dispatch into factor x "
                "workers row-block sub-tasks dispatched redundantly, "
                "first result per block wins — a slow worker sheds "
                "its block instead of gating the round (rateless "
                "over-decomposition stance; 0 = one dispatch per "
                "batch, the legacy path)"),
    Option("osd_ec_cold_shape_bytes", "size", 256 << 20, min=0,
           desc="cold-shape shield threshold: a decode/repair survivor "
                "pattern dispatches on the host engine until its "
                "cumulative bytes cross this volume, then promotes to "
                "the device engine where the fresh-shape kernel "
                "compile amortizes — storm patterns promote within a "
                "few stacked rounds, the one-off patterns hedged "
                "reads manufacture stay host and never stall a waiting "
                "read on a compile (0 disables the shield)"),
    Option("osd_ec_verify_on_read", "bool", True,
           desc="verify per-cell hinfo CRC32C on EVERY EC read, normal "
                "or degraded: a mismatch excludes the shard (EIO, "
                "counter ec_read_crc_err) and kicks a repair instead "
                "of serving rotted cells; off trades that safety for "
                "read-path CPU"),
    Option("client_backoff_base", "secs", 0.05, min=0.001,
           desc="first retry delay of the client resend loops (ESTALE/"
                "EAGAIN and tick-resend); doubles per attempt with "
                "jitter (bounded exponential backoff)"),
    Option("client_backoff_max", "secs", 2.0, min=0.01,
           desc="retry delay ceiling of the client resend loops"),
    Option("client_placement_batch_window", "secs", 0.002,
           desc="placement-miss coalescing window: pgid lookups that "
                "miss the epoch-keyed cache within this long ride ONE "
                "device bulk-CRUSH dispatch (0 = flush every tick; "
                "the ECBatcher window discipline on the dispatch "
                "plane)"),
    Option("client_placement_batch_target", "int", 64, min=1,
           desc="placement-miss batch size target: this many queued "
                "pgids flush ahead of the window deadline"),
    Option("client_placement_batch_min", "int", 16, min=1,
           desc="smallest miss batch worth a device dispatch: below "
                "it the host pipeline resolves inline (a cold jit "
                "compile would cost more than it saves — the "
                "DEVICE_MIN_BYTES stance applied to placement)"),
    Option("client_max_inflight", "int", 64, min=1,
           desc="aio op window: ops in flight per client before "
                "aio submission blocks (objecter_inflight_ops role); "
                "the budget the writes_begin/writes_wait pipeline "
                "amortizes per-op costs across"),
    Option("store_commit_window_ms", "float", 0.0, min=0.0,
           desc="store group-commit window: transactions arriving "
                "within this many ms share ONE WAL/kv flush (+fsync) "
                "and their on_commit callbacks fire together "
                "(0 = flush per transaction, the legacy path)"),
    Option("store_commit_max_txns", "int", 64, min=1,
           desc="store group-commit size cap: a group reaching this "
                "many transactions flushes immediately, ahead of the "
                "window deadline"),
    Option("store_kind", "str", "memstore",
           enum=("memstore", "walstore"), runtime=False,
           desc="ObjectStore backend for OSD-lite daemons"),
    Option("walstore_fsync", "bool", False, runtime=False,
           desc="fsync the WAL on every commit"),
    Option("walstore_compact_bytes", "size", 64 << 20,
           desc="WAL size that triggers a checkpoint", min=4096),
    Option("bluestore_csum_type", "str", "crc32c",
           enum=("none", "crc32c", "crc32c_16", "crc32c_8",
                 "xxhash32", "xxhash64"),
           desc="blob checksum algorithm (Checksummer)"),
    Option("osd_client_message_size_cap", "size", 64 << 20,
           desc="in-flight client payload bytes before ingest throttles"),
    Option("debug_default", "int", 1, desc="default log level",
           min=0, max=20),
    Option("ec_device_backend", "bool", True,
           desc="route EC encode/decode through the device kernels"),
])


def proxy() -> ConfigProxy:
    """Fresh proxy over the framework schema (per-daemon, like each
    daemon's md_config_t)."""
    return ConfigProxy(SCHEMA)
