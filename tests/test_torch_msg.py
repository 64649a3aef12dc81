"""The port's wire (``ceph_tpu_torch.msg`` and ``cluster.messages``) held
against the JAX package's: every registered message type encodes to equal
bytes in both packages and each decodes the other's, frames are byte-equal
with the CRC chained across payload segments, and a port TcpMessenger and
a JAX one talk in both directions. Also the units of ``test_msg.py`` and
the frame and LocalBus cases of ``test_buffer.py`` on the port, and the
fan-out of ``chip_smoke.py``'s phase ``msg`` on the CPU at one object a
transport. Tolerance: exact equality (bytes and integers). Every socket
wait is bounded (``run``); listeners bind port 0."""
import asyncio
import random
import tempfile

import numpy as np
import pytest
import torch

from ceph_tpu.cluster import messages as JM
from ceph_tpu.msg import frames as jframes
from ceph_tpu.msg import messages as jmessages
from ceph_tpu.msg.messenger import TcpMessenger as JTcpMessenger
from ceph_tpu.store import transaction as jtx
from ceph_tpu.utils import buffer as jbuffer
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.msg import frames, messages
from ceph_tpu_torch.msg.frames import Frame, decode_frame, encode_frame, encode_frame_bl
from ceph_tpu_torch.msg.messenger import ZERO_COPY_TYPES, LocalBus, TcpMessenger
from ceph_tpu_torch.store import transaction as tx
from ceph_tpu_torch.utils import denc
from ceph_tpu_torch.utils.buffer import BufferList
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ------------------------------------------------------ every message type


def _value(kind, rng: random.Random):
    """A seeded value of a message field kind (``msg/messages.py`` kinds
    and the cluster messages' custom codecs, named by their encoder)."""
    if isinstance(kind, tuple):
        kind = kind[0].__name__
    if kind in ("u8", "u16", "u32", "u64"):
        return rng.randrange(1 << {"u8": 8, "u16": 16, "u32": 32,
                                   "u64": 64}[kind])
    if kind in ("i32", "i64"):
        bits = 31 if kind == "i32" else 63
        return rng.randrange(-(1 << bits), 1 << bits)
    if kind == "str":
        return "".join(rng.choice("abcdefgh.0123") for _ in range(
            rng.randrange(12)))
    if kind in ("bytes", "body", "_enc_lazy_txn", "_enc_lazy_entries"):
        return rng.randbytes(rng.randrange(40))
    if kind.startswith("list:"):
        return [_value(kind[5:], rng) for _ in range(rng.randrange(4))]
    if kind.startswith("map:"):
        k_kind, v_kind = kind[4:].split(":", 1)
        return {_value(k_kind, rng): _value(v_kind, rng)
                for _ in range(rng.randrange(4))}
    if kind.startswith("pair:"):
        a_kind, b_kind = kind[5:].split(":", 1)
        return (_value(a_kind, rng), _value(b_kind, rng))
    if kind == "_enc_osd_ops":
        return [M.osd_op(_value("str", rng), _value("u64", rng),
                         _value("i64", rng), _value("bytes", rng),
                         _value("bytes", rng), _value("map:bytes:bytes", rng),
                         _value("list:bytes", rng))
                for _ in range(rng.randrange(4))]
    if kind == "_enc_outs":
        return [(_value("i32", rng), _value("bytes", rng))
                for _ in range(rng.randrange(4))]
    if kind == "_enc_scrub_map":
        return {_value("bytes", rng): (_value("pair:u32:u64", rng),
                                       _value("pair:u64:u32", rng))
                for _ in range(rng.randrange(4))}
    if kind == "_enc_cfg_entries":
        return [tuple(_value("str", rng) for _ in range(3))
                for _ in range(rng.randrange(4))]
    if kind == "_enc_upmap_plan":
        return [(_value("pair:i32:u32", rng),
                 [_value("pair:i32:i32", rng) for _ in range(rng.randrange(3))])
                for _ in range(rng.randrange(4))]
    raise AssertionError(f"no value for kind {kind!r}")


def _fields(msg) -> list:
    """A message's field values, views read as bytes (the two packages'
    classes differ, so messages compare by their fields)."""
    def norm(v):
        if isinstance(v, memoryview):
            return bytes(v)
        if isinstance(v, (list, tuple)):
            return type(v)(norm(x) for x in v)
        if isinstance(v, dict):
            return {norm(k): norm(x) for k, x in v.items()}
        return v
    return [norm(getattr(msg, n)) for n, _ in msg.FIELDS]


def _names(registry) -> dict:
    """TYPE -> class name, without the probe types tests register."""
    return {t: c.__name__ for t, c in registry.items() if t < 0x7F00}


def test_registries_bind_equal_types_to_equal_names():
    assert _names(messages._REGISTRY) == _names(jmessages._REGISTRY)
    assert len(_names(messages._REGISTRY)) >= 50


def _kinds(cls) -> list:
    return [(n, k if isinstance(k, str) else k[0].__name__)
            for n, k in cls.FIELDS]


@pytest.mark.parametrize("mtype", sorted(
    t for t in jmessages._REGISTRY if t < 0x7F00))
def test_message_encodes_equal_bytes_and_decodes_across(mtype):
    pcls, jcls = messages._REGISTRY[mtype], jmessages._REGISTRY[mtype]
    assert _kinds(pcls) == _kinds(jcls)
    for seed in range(3):
        rng = random.Random(mtype * 1000 + seed)
        kw = {n: _value(k, rng) for n, k in pcls.FIELDS}
        pmsg, jmsg = pcls(**kw), jcls(**kw)
        wire = pmsg.encode()
        assert wire == jmsg.encode()
        assert bytes(pmsg.encode_bl()) == bytes(jmsg.encode_bl()) == wire
        from_jax = messages.decode_message(mtype, jmsg.encode())
        from_port = jmessages.decode_message(mtype, wire)
        assert _fields(from_jax) == _fields(from_port) == _fields(pmsg)
        assert from_jax.encode() == wire


def test_zero_copy_types_match_the_reference():
    from ceph_tpu.msg import messenger as jmessenger

    jmessenger._init_zero_copy()
    from ceph_tpu_torch.msg import messenger

    messenger._init_zero_copy()
    assert ZERO_COPY_TYPES == jmessenger.ZERO_COPY_TYPES
    assert len(ZERO_COPY_TYPES) == 9


# ------------------------------------------------------------------ frames


def test_frame_roundtrip():
    f = Frame(type=7, payload=b"hello world" * 100)
    wire = encode_frame(f)
    got, used = decode_frame(wire)
    assert used == len(wire)
    assert got.type == 7 and got.payload == f.payload


@pytest.mark.parametrize("seed", range(6))
def test_frames_equal_bytes_with_the_crc_chained_across_segments(seed):
    rng = random.Random(seed)
    body = rng.randbytes(rng.randrange(1, 9000))
    bl, jbl, pos = BufferList(), jbuffer.BufferList(), 0
    while pos < len(body):
        step = rng.randrange(1, len(body) - pos + 1)
        bl.append(body[pos:pos + step])
        jbl.append(body[pos:pos + step])
        pos += step
    ftype, flags = rng.randrange(1 << 16), rng.randrange(2)
    wire = bytes(encode_frame_bl(Frame(ftype, bl, flags)))
    assert wire == bytes(jframes.encode_frame_bl(
        jframes.Frame(ftype, jbl, flags)))
    assert wire == encode_frame(Frame(ftype, body, flags))
    from ceph_tpu_torch import native

    # one CRC32C over type..payload, chained segment by segment
    assert int.from_bytes(wire[-4:], "little") == native.crc32c(wire[4:-4])
    for pkg in (frames, jframes):
        got, used = pkg.decode_frame(wire)
        assert used == len(wire) and bytes(got.payload) == body
        assert (got.type, got.flags) == (ftype, flags)


def test_frame_crc_detects_every_flipped_bit():
    wire = encode_frame(Frame(1, b"payload-bytes"))
    for byte in range(4, len(wire)):  # the magic is checked on its own
        for bit in (0, 5):
            bad = bytearray(wire)
            bad[byte] ^= 1 << bit
            with pytest.raises(frames.FrameError):
                decode_frame(bytes(bad))
            with pytest.raises(jframes.FrameError):
                jframes.decode_frame(bytes(bad))


def test_frame_bad_magic_and_incomplete():
    wire = encode_frame(Frame(1, b"x" * 64))
    for cut in (0, 10, 11, len(wire) - 1):
        with pytest.raises(frames.IncompleteFrame) as got:
            decode_frame(wire[:cut])
        with pytest.raises(jframes.IncompleteFrame) as want:
            jframes.decode_frame(wire[:cut])
        assert got.value.needed == want.value.needed
    with pytest.raises(frames.FrameError, match="magic"):
        decode_frame(b"\0" + wire[1:])


def test_frame_bl_encode_matches_legacy_and_decodes_as_view():
    payload = b"p" * 300
    bl_form = bytes(encode_frame_bl(Frame(7, BufferList(payload))))
    flat_form = encode_frame(Frame(7, payload))
    assert bl_form == flat_form
    frame, used = decode_frame(flat_form)
    assert used == len(flat_form)
    assert isinstance(frame.payload, memoryview)  # zero-copy decode
    assert frame.payload == payload


def _random_op(rng: random.Random, pkg):
    body = rng.randbytes(rng.randrange(1, 4096))
    return pkg.MOSDOp(
        tid=rng.randrange(1 << 40), pgid=(2, rng.randrange(32)),
        oid=rng.randbytes(rng.randrange(1, 24)),
        ops=[pkg.osd_op("writefull", data=body),
             pkg.osd_op("setxattr", key=b"k", data=rng.randbytes(8))],
        epoch=rng.randrange(1 << 20), snap_seq=rng.randrange(1 << 10),
        snaps=[rng.randrange(1 << 16) for _ in range(rng.randrange(3))])


def test_encode_bl_equals_legacy_encode_property():
    """Over random messages and random payload segmentations the
    BufferList encoding equals the joined one and the JAX package's."""
    rng, jrng = random.Random(20260804), random.Random(20260804)
    cuts = random.Random(7)
    for _ in range(40):
        msg, jmsg = _random_op(rng, M), _random_op(jrng, JM)
        legacy = msg.encode()
        assert legacy == jmsg.encode()
        assert bytes(msg.encode_bl()) == legacy
        ops = []
        for (op, off, ln, key, data, kv, keys) in msg.ops:
            if data:
                data, seg, pos = bytes(data), BufferList(), 0
                while pos < len(data):
                    step = cuts.randrange(1, len(data) - pos + 1)
                    seg.append(data[pos:pos + step])
                    pos += step
                data = seg
            ops.append((op, off, ln, key, data, kv, keys))
        msg.ops = ops
        assert bytes(msg.encode_bl()) == legacy
        assert M.MOSDOp.decode(legacy).encode() == legacy


def test_decode_bodies_are_views():
    body = b"B" * 512
    msg = M.MOSDOpReply(tid=1, result=0, data=body, size=len(body),
                        outs=[(0, body)], epoch=3)
    dec = M.MOSDOpReply.decode(msg.encode())
    assert isinstance(dec.data, memoryview)
    assert isinstance(dec.outs[0][1], memoryview)
    assert dec.data == body and dec.outs[0][1] == body
    assert dec == msg


def test_lazy_subop_fields_wire_roundtrip():
    """Live Transaction objects marshal as the pre-encoded bytes do, and
    as the JAX package's live ones."""
    def txn(pkg):
        t = pkg.Transaction()
        t.touch("1.0s0", b"obj")
        t.write("1.0s0", b"obj", 0, b"payload-bytes" * 100)
        t.setattr("1.0s0", b"obj", "k", b"v")
        return t

    t = txn(tx)
    live = M.MECSubWrite(tid=1, pgid=(1, 0), shard=0, txn=t, entry=b"",
                         epoch=3, hpatch=b"hp", ncells=1, size=1300,
                         prev_head=(3, 6))
    pre = M.MECSubWrite(tid=1, pgid=(1, 0), shard=0, txn=t.encode(),
                        entry=b"", epoch=3, hpatch=b"hp", ncells=1,
                        size=1300, prev_head=(3, 6))
    jlive = JM.MECSubWrite(tid=1, pgid=(1, 0), shard=0, txn=txn(jtx),
                           entry=b"", epoch=3, hpatch=b"hp", ncells=1,
                           size=1300, prev_head=(3, 6))
    assert live.encode() == pre.encode() == jlive.encode()
    dec = M.MECSubWrite.decode(live.encode())
    t2, _ = tx.Transaction.decode(dec.txn)
    assert [op.code for op in t2.ops] == [op.code for op in t.ops]
    rep = M.MOSDRepOp(tid=2, pgid=(1, 1), txn=t, entry=[], epoch=3,
                      prev_head=(3, 6))
    jrep = JM.MOSDRepOp(tid=2, pgid=(1, 1), txn=txn(jtx), entry=[],
                        epoch=3, prev_head=(3, 6))
    assert rep.encode() == jrep.encode()


# ---------------------------------------------------------------- LocalBus


def test_localbus_snapshot_delivery_resend_mutation_safety():
    async def scenario():
        bus = LocalBus()
        got = []

        async def handler(_src, m):
            got.append(m)

        bus.register("osd.0", handler)
        payload = b"D" * (1 << 16)
        msg = M.MOSDOp(tid=9, pgid=(2, 1), oid=b"o",
                       ops=[M.osd_op("writefull", data=payload)], epoch=5)
        await bus.send("client.0", "osd.0", msg)
        msg.epoch = 6  # the resend path re-stamps before delivery ran
        msg.ops = [M.osd_op("writefull", data=b"replaced")]
        await bus.drain()
        assert len(got) == 1 and got[0] is not msg
        assert got[0].epoch == 5
        assert got[0].ops[0][4] is payload  # zero-copy shared body
        assert bus.zero_copy_sends == 1

    run(scenario())


def test_localbus_sub_ops_ride_by_reference():
    async def scenario():
        bus = LocalBus()
        got = []

        async def handler(_src, m):
            got.append(m)

        bus.register("osd.1", handler)
        t = tx.Transaction().write("1.0s1", b"o", 0, np.ones(64, np.uint8))
        sub = M.MECSubWrite(tid=3, pgid=(1, 0), shard=1, txn=t, entry=[],
                            epoch=1)
        for _ in range(5):
            await bus.send("osd.0", "osd.1", sub)
        await bus.drain()
        assert all(m is sub for m in got) and len(got) == 5
        assert bus.zero_copy_sends == 0  # no snapshot: by reference
        assert bus.frames_per_drain == 5.0  # one burst for the five

    run(scenario())


def test_localbus_duplicate_deliveries_are_isolated():
    from ceph_tpu_torch.cluster.faults import NetFaultPolicy

    async def scenario():
        pol = NetFaultPolicy(random.Random(1))
        pol.set_link("client.0", "osd.0", dup=1.0)
        bus = LocalBus(faults=pol)
        got = []

        async def handler(_src, m):
            got.append(m)

        bus.register("osd.0", handler)
        msg = M.MOSDOpReply(tid=1, result=0, data=b"x", size=1,
                            outs=[(0, b"x")], epoch=1)
        await bus.send("client.0", "osd.0", msg)
        await bus.drain()
        assert len(got) == 2 and got[0] is not got[1]
        got[0].outs.append((1, b"y"))
        assert len(got[1].outs) == 1

    run(scenario())


def test_localbus_codec_symmetry_check_passes_when_armed():
    async def scenario():
        bus = LocalBus()
        bus.verify_codec_symmetry = True
        got = []

        async def handler(_src, m):
            got.append(m)

        bus.register("osd.0", handler)
        msg = M.MOSDOp(tid=1, pgid=(2, 0), oid=b"o",
                       ops=[M.osd_op("writefull", data=b"abc" * 100)],
                       epoch=1)
        await bus.send("client.0", "osd.0", msg)
        await bus.drain()
        assert got and bus.codec_symmetry_checks == 1

    run(scenario())


class MLossy(messages.Message):
    """A message whose encoder drops its payload's tail: its decode can
    never agree with what was sent."""
    TYPE = 0x7F11
    FIELDS = (("blob", (lambda v: denc.enc_bytes(v[:1]), denc.dec_bytes)),)


messages.register_message(MLossy)


def test_localbus_codec_symmetry_check_catches_asymmetry():
    async def scenario():
        bus = LocalBus()
        bus.verify_codec_symmetry = True

        async def handler(_src, m):
            pass

        bus.register("osd.0", handler)
        with pytest.raises(frames.FrameError):
            await bus.send("client.0", "osd.0", MLossy(blob=b"lossy"))

    run(scenario())


def test_localbus_legacy_marshal_lever(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_BUS_SNAPSHOT", "0")

    async def scenario():
        bus = LocalBus()
        assert bus.snapshot_delivery is False
        got = []

        async def handler(_src, m):
            got.append(m)

        bus.register("osd.0", handler)
        payload = b"P" * 1024
        msg = M.MOSDOp(tid=2, pgid=(2, 0), oid=b"o",
                       ops=[M.osd_op("writefull", data=payload)], epoch=1)
        await bus.send("client.0", "osd.0", msg)
        await bus.drain()
        assert got and bus.zero_copy_sends == 0
        assert got[0].ops[0][4] is not payload
        assert bytes(got[0].ops[0][4]) == payload

    run(scenario())


def test_localbus_unknown_entity_and_blackhole():
    from ceph_tpu_torch.msg.messenger import SendError

    async def scenario():
        bus = LocalBus()
        got = []

        async def handler(_src, m):
            got.append(m)

        bus.register("osd.0", handler)
        with pytest.raises(SendError):
            await bus.send("client.0", "osd.9", M.MOSDBoot(osd=1))
        bus.blackholes.add("osd.0")
        await bus.send("client.0", "osd.0", M.MOSDBoot(osd=1))
        await bus.drain()
        assert got == [] and len(bus.dropped) == 1
        bus.unregister("osd.0")
        assert "osd.0" not in bus.blackholes

    run(scenario())


# --------------------------------------------------------------------- TCP


async def _pair(a_cls, b_cls, got, reply=None, **kw):
    done = asyncio.Event()

    async def da(src, msg):
        got.append(("a", src, msg))
        done.set()

    async def db(src, msg):
        got.append(("b", src, msg))
        await b.send(src, reply or M.MOSDBoot(osd=99))

    a = a_cls("client.1", da, **kw)
    b = b_cls("osd.0", db, **kw)
    a.addrbook["osd.0"] = await b.listen()
    b.addrbook["client.1"] = await a.listen()
    return a, b, done


def test_tcp_messenger_roundtrip():
    async def scenario():
        got = []
        a, b, done = await _pair(TcpMessenger, TcpMessenger, got)
        await a.send("osd.0", M.MOSDOp(tid=1, pgid=(1, 0), oid=b"x",
                                       ops=[M.osd_op("read")], epoch=1))
        await asyncio.wait_for(done.wait(), 5)
        await a.close()
        await b.close()
        assert got[0][:2] == ("b", "client.1")
        assert isinstance(got[0][2], M.MOSDOp)
        assert got[1] == ("a", "osd.0", M.MOSDBoot(osd=99))

    run(scenario())


@pytest.mark.parametrize("port_side", ["connector", "acceptor"])
def test_tcp_messenger_talks_to_the_jax_one(port_side):
    """Plain mode across the packages: a big EC sub-write one way, the
    reply the other, the cork bursting several frames a drain."""
    classes = ((TcpMessenger, JTcpMessenger) if port_side == "connector"
               else (JTcpMessenger, TcpMessenger))
    a_pkg = M if port_side == "connector" else JM
    b_pkg = JM if port_side == "connector" else M

    async def scenario():
        got = []
        a, b, done = await _pair(*classes, got, reply=b_pkg.MECSubWriteReply(
            tid=5, pgid=(1, 2), shard=3, result=0))
        body = bytes(range(256)) * 2048
        sends = [a.send("osd.0", a_pkg.MECSubReadReply(
            tid=i, pgid=(1, 2), shard=3, result=0, data=body, digest=i,
            size=len(body), attrs={"u": b"v"}, ver=(1, i))) for i in range(6)]
        await asyncio.gather(*sends)
        await asyncio.wait_for(done.wait(), 10)
        while sum(1 for g in got if g[0] == "a") < 6:
            await asyncio.sleep(0.01)
        await a.close()
        await b.close()
        inbound = [m for side, _, m in got if side == "b"]
        assert [m.tid for m in inbound] == list(range(6))
        assert all(bytes(m.data) == body and m.ver == (1, m.tid)
                   for m in inbound)
        replies = [m for side, src, m in got if side == "a"]
        assert all(type(m).__name__ == "MECSubWriteReply" and m.shard == 3
                   for m in replies)
        assert a.frames_sent == 6 and a.frames_per_drain >= 1.0

    run(scenario())


def test_tcp_onwire_compression_roundtrip():
    async def scenario():
        got = []
        done = asyncio.Event()

        async def da(src, msg):
            got.append(msg)
            done.set()

        a = TcpMessenger("client.1", lambda s, m: None,
                         compress_threshold=64)
        b = JTcpMessenger("osd.0", da, compress_threshold=64)
        a.addrbook["osd.0"] = await b.listen()
        big = M.MOSDMapMsg(full=b"z" * 50_000, incrementals=[], epoch=3)
        await a.send("osd.0", big)
        await asyncio.wait_for(done.wait(), 5)
        assert _fields(got[0]) == _fields(big)
        await a.close()
        await b.close()

    run(scenario())


def test_tcp_decompression_bomb_capped():
    import zlib

    async def scenario():
        b = TcpMessenger("osd.0", lambda s, m: None)
        hb, pb = await b.listen()
        bomb = zlib.compress(b"\x00" * (TcpMessenger.MAX_INFLATE + 100), 9)
        r, w = await asyncio.open_connection(hb, pb)
        w.write(encode_frame(Frame(11, bomb, TcpMessenger.FLAG_COMPRESSED)))
        await w.drain()
        assert await asyncio.wait_for(r.read(1), 5) == b""
        w.close()
        await b.close()

    run(scenario(), 60)


def test_tcp_send_to_an_unknown_or_dead_peer_raises():
    from ceph_tpu_torch.msg.messenger import SendError

    async def scenario():
        a = TcpMessenger("client.1", lambda s, m: None)
        with pytest.raises(SendError):
            await a.send("osd.7", M.MOSDBoot(osd=1))
        b = TcpMessenger("osd.0", lambda s, m: None)
        a.addrbook["osd.0"] = await b.listen()
        await b.close()
        with pytest.raises(SendError):
            await a.send("osd.0", M.MOSDBoot(osd=1))
        await a.close()

    run(scenario())


# ------------------------------------------------------------------ NetBus


@pytest.mark.parametrize("port_side", ["sender", "receiver"])
def test_netbus_envelopes_cross_the_packages(tmp_path, port_side):
    """One NetBus of each package over one address book: entities find
    each other by name and MEnvelope carries the entity-level src/dst."""
    from ceph_tpu.msg.netbus import NetBus as JNetBus
    from ceph_tpu_torch.msg.netbus import NetBus

    async def scenario():
        got = []
        done = asyncio.Event()

        async def handler(src, msg):
            got.append((src, msg))
            done.set()

        send_bus, recv_bus = ((NetBus, JNetBus) if port_side == "sender"
                              else (JNetBus, NetBus))
        tx_bus = send_bus(str(tmp_path / "book"))
        rx_bus = recv_bus(str(tmp_path / "book"))
        await tx_bus.start()
        await rx_bus.start()
        tx_bus.register("client.4", handler)
        rx_bus.register("osd.2", handler)
        pkg = M if port_side == "sender" else JM
        await tx_bus.send("client.4", "osd.2", pkg.MPing(osd=4, epoch=8))
        await asyncio.wait_for(done.wait(), 5)
        assert got[0][0] == "client.4"
        assert (got[0][1].osd, got[0][1].epoch) == (4, 8)
        await tx_bus.close()
        await rx_bus.close()
        assert not (tmp_path / "book" / "osd.2").exists()

    run(scenario())


# ------------------------------------------- the chip smoke's fan-out, small


def test_msg_phase_fan_out_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.msg_phase`` with the codec on the CPU (the batcher's
    plain versions), one object per transport: every sub-write's cells
    hold against their CRC patch on the receiver, every degraded read
    rebuilds shards 1 and 6 exact. Secure mode is left to
    ``test_torch_auth.py``."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # sockets, rings
    out = chip_smoke.msg_phase(
        torch.device("cpu"), np.random.default_rng(5), "cpu",
        transports={"localbus": 1, "tcp": 1, "tcp_sign": 1, "shm": 1},
        profile=False)
    assert list(out["lines"]) == ["localbus", "tcp", "tcp_sign", "shm"]
    for kind, line in out["lines"].items():
        assert line["cells_crc_checked"] == 11 * 128
        assert line["rebuilt_cells"] == 2 * 128
        assert line["sub_writes"] == 11 and line["sub_reads"] == 9
        assert (line["wire_bytes"] == 0) == (kind == "localbus")
    tcp, sign = out["lines"]["tcp"], out["lines"]["tcp_sign"]
    assert sign["wire_bytes"] - tcp["wire_bytes"] == 16 * 40  # HMAC tags
