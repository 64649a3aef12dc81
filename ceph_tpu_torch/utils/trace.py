"""Distributed tracing: spans with cross-daemon context propagation
(the reference's blkin/Zipkin + opentelemetry tracer roles,
src/common/tracer.h:18, ECBackend.cc:831-858 pg_trace threading).

A Span is (trace_id, span_id, parent_id, service, name, start,
duration, tags); the (trace_id, span_id) pair is the propagated
context — it rides op messages as a u64 pair exactly the way the
reference threads `pg_trace` through EC sub-ops. Each daemon owns a
Tracer (a bounded ring of finished spans, dumpable over its admin
socket as `dump_tracing`); an in-process registry lets tests and the
exporter assemble the full tree the way a Zipkin collector would.

Zero-config: tracing is always on with a bounded ring (finished spans
only), matching the OpTracker stance — cost is one dict append per op.

ceph_tpu_torch's own copy of ``ceph_tpu/utils/trace.py``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

_seq = itertools.count(1)
_seq_lock = threading.Lock()

#: ambient span context for the executing op (asyncio tasks inherit it,
#: so sub-op constructors deep in the PG pick up the op's span without
#: threading it through every call — the pg_trace member role)
import contextvars  # noqa: E402

current = contextvars.ContextVar("ceph_tpu_trace_ctx", default=(0, 0))


def _new_id() -> int:
    # deterministic-ish unique 64-bit ids: time base + process counter
    # (good enough for correlation; no crypto requirement)
    with _seq_lock:
        n = next(_seq)
    return ((int(time.time() * 1e6) & 0xFFFFFFFF) << 32) | (n & 0xFFFFFFFF)


NO_CTX = (0, 0)  # wire value for "not traced"


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "service", "name",
                 "start", "duration", "tags", "_tracer")

    def __init__(self, tracer: "Tracer", trace_id: int, parent_id: int,
                 name: str):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.service = tracer.service
        self.name = name
        self.start = time.time()
        self.duration: float | None = None
        self.tags: dict[str, str] = {}

    @property
    def ctx(self) -> tuple[int, int]:
        """Wire context to put on an outgoing message."""
        return (self.trace_id, self.span_id)

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = str(value)
        return self

    def finish(self) -> None:
        if self.duration is None:
            self.duration = time.time() - self.start
            self._tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.tag("error", exc_type.__name__)
        self.finish()

    def dump(self) -> dict:
        return {
            "traceId": f"{self.trace_id:016x}",
            "id": f"{self.span_id:016x}",
            "parentId": (f"{self.parent_id:016x}"
                         if self.parent_id else None),
            "localEndpoint": {"serviceName": self.service},
            "name": self.name,
            "timestamp": int(self.start * 1e6),  # zipkin micros
            "duration": int((self.duration or 0) * 1e6),
            "tags": dict(self.tags),
        }


class Tracer:
    def __init__(self, service: str, ring_size: int = 512):
        self.service = service
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=ring_size)
        _REGISTRY[service] = self

    def start_span(self, name: str,
                   parent: tuple[int, int] | Span | None = None) -> Span:
        """New span; parent is a wire ctx, a local Span, or None (root).
        A NO_CTX wire parent starts a fresh trace."""
        if isinstance(parent, Span):
            ctx = parent.ctx
        elif parent is None or tuple(parent) == NO_CTX:
            ctx = (_new_id(), 0)
        else:
            ctx = tuple(parent)
        return Span(self, ctx[0], ctx[1], name)

    def _record(self, span: Span) -> None:
        self._ring.append(span)

    def dump(self, trace_id: int | None = None, limit: int = 200) -> list:
        if limit <= 0:
            return []
        spans = [s for s in self._ring
                 if trace_id is None or s.trace_id == trace_id]
        return [s.dump() for s in spans[-limit:]]


#: in-process collector view: service -> Tracer (tests / exporter)
_REGISTRY: dict[str, Tracer] = {}


def get_tracer(service: str) -> Tracer:
    t = _REGISTRY.get(service)
    if t is None:
        t = Tracer(service)
    return t


def dump_all(trace_id: int | None = None) -> list:
    """Collector view across every in-process service."""
    out = []
    for svc in sorted(_REGISTRY):
        out.extend(_REGISTRY[svc].dump(trace_id))
    return out
