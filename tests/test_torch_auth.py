"""The port's auth (``ceph_tpu_torch.msg.auth``) held against the JAX
package's: handshakes, frame signatures and secure-mode records made by
one package are accepted by the other, and a port TcpMessenger and a JAX
one talk in both directions in plain, sign and secure mode. Also the
units of ``test_auth.py`` on the port. Secure mode needs the
``cryptography`` package, which these tests require. Tolerance: exact
equality.
Every socket wait is bounded (``run``); listeners bind port 0."""
import asyncio
import builtins
import struct

import pytest
import torch

from ceph_tpu.cluster import messages as JM
from ceph_tpu.msg import auth as jauth
from ceph_tpu.msg.messenger import TcpMessenger as JTcpMessenger
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.msg import auth as pauth
from ceph_tpu_torch.msg.auth import (AuthError, Authenticator, KeyServer,
                                     SecureSession, handshake_accept)
from ceph_tpu_torch.msg.messenger import SendError, TcpMessenger
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_handshake_unit():
    keys = KeyServer()
    secret = keys.add("osd.1")
    a = Authenticator("osd.1", secret)
    hello, nonce = a.make_hello()
    challenge = Authenticator.make_challenge()
    proof = a.prove(challenge, nonce)
    session = handshake_accept(keys, hello, challenge, proof)
    a.derive_session(secret, challenge, nonce)
    assert session == a.session_key
    mallory = Authenticator("osd.1", b"guessed-wrong")
    with pytest.raises(AuthError):
        handshake_accept(keys, hello, challenge,
                         mallory.prove(challenge, nonce))
    ghost = Authenticator("osd.99", secret)
    h2, n2 = ghost.make_hello()
    with pytest.raises(AuthError):
        handshake_accept(keys, h2, challenge, ghost.prove(challenge, n2))


@pytest.mark.parametrize("connector", ["port", "jax"])
@pytest.mark.parametrize("mode", ["sign", "secure"])
def test_handshake_interoperates(connector, mode):
    """A hello and proof made by one package pass the other's acceptor,
    and both sides derive the same session key."""
    conn_mod, acc_mod = ((pauth, jauth) if connector == "port"
                         else (jauth, pauth))
    keys = acc_mod.KeyServer()
    secret = keys.add("client.3", b"s" * 32)
    a = conn_mod.Authenticator("client.3", secret)
    hello, nonce = a.make_hello(mode)
    assert acc_mod.Authenticator.parse_hello(hello) == ("client.3", nonce,
                                                        mode)
    challenge = acc_mod.Authenticator.make_challenge()
    session = acc_mod.handshake_accept(keys, hello, challenge,
                                       a.prove(challenge, nonce))
    a.derive_session(secret, challenge, nonce)
    assert session == a.session_key
    assert jauth._mac(b"k", b"a", b"bc") == pauth._mac(b"k", b"a", b"bc")


def test_frame_signing_unit_and_equal_tags():
    keys = KeyServer()
    a = Authenticator("x", keys.add("x"))
    a.session_key = b"k" * 32
    tag = a.sign(b"frame-bytes")
    a.check(b"frame-bytes", tag)
    with pytest.raises(AuthError):
        a.check(b"frame-bytEs", tag)
    j = jauth.Authenticator("x", b"")
    j.session_key = b"k" * 32
    assert j.sign(b"frame-bytes") == tag
    j.check(b"frame-bytes", tag)
    with pytest.raises(AuthError, match="no session key"):
        Authenticator("y", b"").sign(b"f")


@pytest.mark.parametrize("role", ["connector", "acceptor"])
def test_secure_records_decrypt_across_the_packages(role):
    other = "acceptor" if role == "connector" else "connector"
    for tx_cls, rx_cls in ((SecureSession, jauth.SecureSession),
                           (jauth.SecureSession, SecureSession)):
        tx, rx = tx_cls(b"q" * 32, role), rx_cls(b"q" * 32, other)
        records = [b"first", b"", b"third record" * 100]
        wires = [tx.encrypt(r) for r in records]
        for w in wires:
            (ln,) = struct.unpack("<I", w[:4])
            assert ln == len(w) - 4
        assert [rx.decrypt(w[4:]) for w in wires] == records
    a, b = SecureSession(b"q" * 32, role), jauth.SecureSession(b"q" * 32, role)
    assert a.encrypt(b"same") == b.encrypt(b"same")  # same key, nonce


def test_secure_frame_tamper_detected():
    sess_a = SecureSession(b"k" * 32, "connector")
    sess_b = SecureSession(b"k" * 32, "acceptor")
    rec = b"hello frame bytes"
    wire = sess_a.encrypt(rec)
    (ln,) = struct.unpack("<I", wire[:4])
    ct = bytearray(wire[4:4 + ln])
    assert sess_b.decrypt(bytes(ct)) == rec
    ct[5] ^= 0x40
    with pytest.raises(AuthError, match="authentication"):
        SecureSession(b"k" * 32, "acceptor").decrypt(bytes(ct))


def test_secure_replay_rejected():
    tx = SecureSession(b"s" * 32, "connector")
    rx = SecureSession(b"s" * 32, "acceptor")
    w1, w2 = tx.encrypt(b"first"), tx.encrypt(b"second")
    assert rx.decrypt(w1[4:]) == b"first"
    assert rx.decrypt(w2[4:]) == b"second"
    with pytest.raises(AuthError):
        rx.decrypt(w1[4:])


def test_secure_no_reflection_and_bad_role():
    a = SecureSession(b"q" * 32, "connector")
    with pytest.raises(AuthError):
        a.decrypt(a.encrypt(b"mine")[4:])
    with pytest.raises(ValueError):
        SecureSession(b"q" * 32, "bystander")


def test_secure_mode_without_cryptography_raises_auth_error(monkeypatch):
    """As in the reference: no ``cryptography`` package, no secure
    session, and the error says why."""
    real_import = builtins.__import__

    def no_crypto(name, *args, **kw):
        if name.startswith("cryptography"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_crypto)
    with pytest.raises(AuthError, match="cryptography"):
        SecureSession(b"k" * 32, "connector")
    with pytest.raises(ValueError, match="KeyServer"):
        TcpMessenger("osd.0", lambda s, m: None, secure=True)


# ------------------------------------------------------------- messengers


def _messengers(mode, port_side, da, db):
    """(connector a, acceptor b): one of each package, ``port_side`` the
    side the port's TcpMessenger takes, each with its own package's
    KeyServer holding the same two secrets unless ``mode`` is plain."""
    a_cls, b_cls = ((TcpMessenger, JTcpMessenger) if port_side == "connector"
                    else (JTcpMessenger, TcpMessenger))

    def keys(cls):
        if mode == "plain":
            return None
        ks = (KeyServer if cls is TcpMessenger else jauth.KeyServer)()
        ks.add("client.1", b"c" * 32)
        ks.add("osd.0", b"o" * 32)
        return ks

    kw = {} if mode == "plain" else {"secure": mode == "secure"}
    return (a_cls("client.1", da, keys=keys(a_cls), **kw),
            b_cls("osd.0", db, keys=keys(b_cls), **kw))


@pytest.mark.parametrize("port_side", ["connector", "acceptor"])
@pytest.mark.parametrize("mode", ["plain", "sign", "secure"])
def test_tcp_messengers_of_both_packages_talk(mode, port_side):
    async def scenario():
        got = []
        done = asyncio.Event()

        async def da(src, msg):
            got.append(("a", src, msg))
            if len([g for g in got if g[0] == "a"]) == 3:
                done.set()

        async def db(src, msg):
            got.append(("b", src, msg))
            pkg = JM if port_side == "connector" else M
            await b.send(src, pkg.MOSDBoot(osd=msg.have))

        a, b = _messengers(mode, port_side, da, db)
        a.addrbook["osd.0"] = await b.listen()
        b.addrbook["client.1"] = await a.listen()
        pkg = M if port_side == "connector" else JM
        await asyncio.gather(*(a.send("osd.0", pkg.MMonGetMap(have=i))
                               for i in range(3)))
        await asyncio.wait_for(done.wait(), 10)
        await a.close()
        await b.close()
        assert sorted(m.have for s, src, m in got if s == "b") == [0, 1, 2]
        assert all(src == "client.1" for s, src, _ in got if s == "b")
        assert sorted(m.osd for s, src, m in got if s == "a") == [0, 1, 2]
        assert all(src == "osd.0" for s, src, _ in got if s == "a")

    run(scenario())


def test_wrong_key_rejected_on_wire():
    async def scenario():
        server_keys = KeyServer()
        server_keys.add("osd.0")
        server_keys.add("client.1", b"the-real-secret")
        rogue_keys = jauth.KeyServer()
        rogue_keys.add("client.1", b"WRONG")
        received = []

        async def db(src, msg):
            received.append(msg)

        b = TcpMessenger("osd.0", db, keys=server_keys)
        a = JTcpMessenger("client.1", lambda s, m: None, keys=rogue_keys)
        a.addrbook["osd.0"] = await b.listen()
        from ceph_tpu.msg.messenger import SendError as JSendError

        with pytest.raises(JSendError):
            await a.send("osd.0", JM.MMonGetMap(have=0))
        await asyncio.sleep(0.1)
        assert received == []
        await a.close()
        await b.close()

    run(scenario())


def test_unauthenticated_peer_rejected():
    async def scenario():
        keys = KeyServer()
        keys.add("osd.0")
        received = []

        async def db(src, msg):
            received.append(msg)

        b = TcpMessenger("osd.0", db, keys=keys)
        a = TcpMessenger("client.1", lambda s, m: None)
        a.addrbook["osd.0"] = await b.listen()
        await a.send("osd.0", M.MMonGetMap(have=0))
        await asyncio.sleep(0.2)
        assert received == []
        await a.close()
        await b.close()

    run(scenario())


def test_secure_acceptor_rejects_signed_peer():

    async def scenario():
        keys = KeyServer()
        keys.add("client.1")
        keys.add("osd.0")
        got = []
        b = TcpMessenger("osd.0", lambda s, m: got.append(m), keys=keys,
                         secure=True)
        a = TcpMessenger("client.1", lambda s, m: None, keys=keys)
        a.addrbook["osd.0"] = await b.listen()
        with pytest.raises(SendError):
            await a.send("osd.0", M.MMonGetMap(have=0))
        await asyncio.sleep(0.2)
        assert got == []
        await a.close()
        await b.close()

    run(scenario())
