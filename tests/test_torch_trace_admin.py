"""The port's tracing, admin socket and log (``ceph_tpu_torch.utils.trace``,
``admin``, ``log``): the span, wire-context and admin-socket units of
``test_trace.py`` and ``test_l0.py`` on the port, spans whose dumps take
the reference's form, and an admin socket of each package answering the
other's client. The cluster cases of ``test_trace.py`` (a traced EC write,
the OSD's admin socket) wait for the cluster tier. Tolerance: exact
equality. Every socket wait is bounded."""
import asyncio
import io
import threading

import pytest
import torch

from ceph_tpu.utils import admin as jadmin
from ceph_tpu.utils import log as jlog
from ceph_tpu.utils import trace as jtrace
from ceph_tpu_torch.utils import admin, log, trace
from ceph_tpu_torch.utils.admin import AdminSocket, admin_command

torch.set_num_threads(1)


def run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ------------------------------------------------------------------- trace


def test_span_basics():
    t = trace.get_tracer("svc-a")
    with t.start_span("root") as root:
        root.tag("k", "v")
        child = t.start_span("child", parent=root)
        child.finish()
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id and root.parent_id == 0
    dumped = t.dump(trace_id=root.trace_id)
    assert {d["name"] for d in dumped} == {"root", "child"}
    by_name = {d["name"]: d for d in dumped}
    assert by_name["child"]["parentId"] == f"{root.span_id:016x}"
    assert by_name["root"]["tags"] == {"k": "v"}
    assert by_name["root"]["parentId"] is None


def test_wire_ctx_round_trip():
    t = trace.get_tracer("svc-b")
    parent = t.start_span("parent")
    fresh = t.start_span("fresh", parent=trace.NO_CTX)
    assert fresh.parent_id == 0 and fresh.trace_id != parent.trace_id
    remote = t.start_span("remote", parent=parent.ctx)
    assert remote.trace_id == parent.trace_id
    assert remote.parent_id == parent.span_id
    parent.finish(), fresh.finish(), remote.finish()


def test_span_records_errors_and_finishes_once():
    t = trace.get_tracer("svc-c")
    with pytest.raises(KeyError):
        with t.start_span("failing") as s:
            raise KeyError("x")
    assert s.tags == {"error": "KeyError"}
    s.finish()  # a second finish records nothing
    assert [d["name"] for d in t.dump(trace_id=s.trace_id)] == ["failing"]
    assert t.dump(limit=0) == []


def test_span_ids_unique_across_threads():
    ids, lock = [], threading.Lock()

    def make():
        t = trace.get_tracer("svc-threads")
        got = [t.start_span("s").span_id for _ in range(500)]
        with lock:
            ids.extend(got)

    threads = [threading.Thread(target=make) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(set(ids)) == 2000


def test_dump_form_equals_the_reference():
    """Both packages dump a span to the same Zipkin-form keys, and the
    collector views order services alike."""
    p, j = trace.get_tracer("svc-form"), jtrace.get_tracer("svc-form")
    ps, js = p.start_span("op", parent=(7, 9)), j.start_span("op",
                                                            parent=(7, 9))
    ps.tag("pg", "2.1f").finish()
    js.tag("pg", "2.1f").finish()
    pd, jd = ps.dump(), js.dump()
    assert pd.keys() == jd.keys()
    for key in ("traceId", "parentId", "localEndpoint", "name", "tags"):
        assert pd[key] == jd[key]
    assert pd["traceId"] == f"{7:016x}"
    assert trace.current.get() == trace.NO_CTX == jtrace.NO_CTX
    names = [s["localEndpoint"]["serviceName"] for s in trace.dump_all(7)]
    assert names == sorted(names) and "svc-form" in names


def test_context_var_is_inherited_by_tasks():
    async def scenario():
        token = trace.current.set((5, 6))
        try:
            seen = await asyncio.create_task(_read_ctx())
        finally:
            trace.current.reset(token)
        return seen

    async def _read_ctx():
        return trace.current.get()

    assert run(scenario()) == (5, 6)
    assert trace.current.get() == trace.NO_CTX


# --------------------------------------------------------------------- log


def test_log_levels_and_ring():
    buf = io.StringIO()
    lg = log.Log(default_level=1, gather_level=10, ring_size=100, stream=buf)
    lg.dout("osd", 1, "printed")
    lg.dout("osd", 5, "gathered only")
    lg.dout("osd", 15, "dropped entirely")
    out = buf.getvalue()
    assert "printed" in out and "gathered" not in out
    recent = lg.dump_recent()
    assert len(recent) == 2 and "gathered only" in recent[-1]
    lg.set_level("osd", 5)
    lg.dout("osd", 5, "now visible")
    assert "now visible" in buf.getvalue()
    assert lg.should("osd", 10) and not lg.should("osd", 11)
    assert len(lg.dump_recent(limit=1)) == 1


def test_log_ring_is_bounded_and_lines_match_the_reference():
    buf, jbuf = io.StringIO(), io.StringIO()
    lg = log.Log(default_level=3, ring_size=4, stream=buf)
    jl = jlog.Log(default_level=3, ring_size=4, stream=jbuf)
    for i in range(10):
        lg.dout("ms", i % 5, f"line {i}")
        jl.dout("ms", i % 5, f"line {i}")
    assert len(lg.dump_recent()) == 4
    strip = lambda lines: [ln.split(" ", 1)[1] for ln in lines]  # noqa: E731
    assert strip(lg.dump_recent()) == strip(jl.dump_recent())
    assert strip(buf.getvalue().splitlines()) == \
        strip(jbuf.getvalue().splitlines())


def test_log_root_dout(monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(log, "root", log.Log(stream=buf))
    log.dout("mon", 0, "to the root logger")
    assert "mon: to the root logger" in buf.getvalue()


# ------------------------------------------------------------ admin socket


def test_admin_socket_roundtrip(tmp_path):
    async def scenario():
        sock = AdminSocket(str(tmp_path / "d" / "a.sock"))
        sock.register("echo", lambda a: {"you said": a.get("msg")})

        async def slow(a):
            await asyncio.sleep(0)
            return a["n"] * 2

        sock.register("double", slow, "async handler")
        await sock.start()
        assert await admin_command(sock.path, "echo", msg="hi") == \
            {"you said": "hi"}
        assert await admin_command(sock.path, "double", n=21) == 42
        helped = await admin_command(sock.path, "help")
        assert helped["double"] == "async handler" and "echo" in helped
        with pytest.raises(RuntimeError, match="unknown command"):
            await admin_command(sock.path, "nope")
        with pytest.raises(RuntimeError, match="KeyError"):
            await admin_command(sock.path, "double")
        with pytest.raises(KeyError):
            sock.register("echo", lambda a: None)
        sock.unregister("echo")
        with pytest.raises(RuntimeError):
            await admin_command(sock.path, "echo")
        await sock.stop()
        assert not (tmp_path / "d" / "a.sock").exists()

    run(scenario())


def test_admin_socket_plain_text_request(tmp_path):
    async def scenario():
        sock = AdminSocket(str(tmp_path / "b.sock"))
        sock.register("status", lambda a: "fine")
        await sock.start()
        r, w = await asyncio.open_unix_connection(sock.path)
        w.write(b"status\n")
        await w.drain()
        line = await r.readline()
        w.close()
        await sock.stop()
        return line

    assert run(scenario()) == b'{"ok": true, "result": "fine"}\n'


@pytest.mark.parametrize("server", ["port", "jax"])
def test_admin_socket_answers_the_other_packages_client(tmp_path, server):
    srv_mod, cli_mod = (admin, jadmin) if server == "port" else (jadmin, admin)

    async def scenario():
        sock = srv_mod.AdminSocket(str(tmp_path / "c.sock"))
        sock.register("perf dump", lambda a: {"op_w": 3, "args": a})
        await sock.start()
        got = await cli_mod.admin_command(sock.path, "perf dump", x=1)
        await sock.stop()
        return got

    assert run(scenario()) == {"op_w": 3, "args": {"x": 1}}
