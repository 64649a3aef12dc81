"""Auth: shared-secret authentication + frame signing/encryption (the
src/auth cephx role, compressed to its load-bearing arc).

KeyServer (CephxKeyServer role) holds per-entity secrets. A connecting
messenger proves identity with a challenge/response handshake —
acceptor issues a random challenge, connector answers
HMAC(secret, challenge || nonce || entity) — and the session derives a
key from both nonces. Two on-wire protection modes follow (frames_v2
auth roles):

- "sign":   every frame carries a truncated HMAC tag (msgr2 signed
  mode).
- "secure": every frame is AES-GCM encrypted+authenticated under the
  session key with counter nonces (msgr2 secure mode,
  crypto_onwire.cc role) — confidentiality, integrity, and replay
  protection (a replayed record fails its position's nonce).

Replay of a recorded handshake fails because the acceptor's challenge
is fresh per connection.

ceph_tpu_torch's own copy of ``ceph_tpu/msg/auth.py``.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import struct


class AuthError(Exception):
    pass


class KeyServer:
    """Entity -> secret registry (CephxKeyServer role)."""

    def __init__(self) -> None:
        self._keys: dict[str, bytes] = {}

    def add(self, entity: str, secret: bytes | None = None) -> bytes:
        if secret is None:
            secret = os.urandom(32)
        self._keys[entity] = bytes(secret)
        return self._keys[entity]

    def get(self, entity: str) -> bytes | None:
        return self._keys.get(entity)


def _mac(key: bytes, *parts: bytes) -> bytes:
    h = hmac.new(key, digestmod=hashlib.sha256)
    for p in parts:
        h.update(len(p).to_bytes(4, "little"))
        h.update(p)
    return h.digest()


class Authenticator:
    """Session auth state for one connection side."""

    def __init__(self, entity: str, secret: bytes):
        self.entity = entity
        self.secret = secret
        self.session_key: bytes | None = None

    # ------------------------------------------------------ handshake

    def make_hello(self, mode: str = "sign") -> tuple[bytes, bytes]:
        """Connector step 1: (hello_payload, nonce). mode rides along
        so the acceptor knows which on-wire protection follows."""
        nonce = os.urandom(16)
        return (self.entity.encode() + b"\0" + nonce
                + (b"\x01" if mode == "secure" else b"\x00")), nonce

    @staticmethod
    def parse_hello(payload: bytes) -> tuple[str, bytes, str]:
        # handshake cold path: frames decode payloads as views now,
        # and bytes methods below want real bytes
        entity, _, rest = bytes(payload).partition(b"\0")
        if len(rest) < 16:
            raise AuthError("malformed hello")
        nonce = rest[:16]
        mode = "secure" if rest[16:17] == b"\x01" else "sign"
        return entity.decode(), nonce, mode

    @staticmethod
    def make_challenge() -> bytes:
        return os.urandom(16)

    def prove(self, challenge: bytes, nonce: bytes) -> bytes:
        """Connector step 2: the proof the acceptor verifies."""
        return _mac(self.secret, challenge, nonce, self.entity.encode())

    def verify_proof(self, proof: bytes, challenge: bytes,
                     nonce: bytes, entity: str,
                     their_secret: bytes) -> None:
        want = _mac(their_secret, challenge, nonce, entity.encode())
        if not hmac.compare_digest(proof, want):
            raise AuthError(f"bad proof from {entity!r}")

    def derive_session(self, secret: bytes, challenge: bytes,
                       nonce: bytes) -> None:
        """Both sides derive the same signing key (session ticket
        role)."""
        self.session_key = _mac(secret, b"session", challenge, nonce)

    # -------------------------------------------------- frame signing

    def sign(self, frame_bytes: bytes) -> bytes:
        if self.session_key is None:
            raise AuthError("no session key")
        return _mac(self.session_key, frame_bytes)[:16]

    def check(self, frame_bytes: bytes, tag: bytes) -> None:
        if not hmac.compare_digest(self.sign(frame_bytes), tag):
            raise AuthError("frame signature mismatch")


class SecureSession:
    """msgr2 "secure" mode: AES-256-GCM over each frame under the
    session key (crypto_onwire.cc role). Each DIRECTION gets its own
    4-byte nonce salt, derived from the session key and the sender's
    role — so the connector's tx stream and the acceptor's tx stream
    can never collide on (key, nonce) even if a connection goes
    full-duplex, and a peer's own records can't reflect back as valid
    receives. The salt plus a 64-bit record counter makes any replay,
    reorder, or tamper fail authentication."""

    def __init__(self, session_key: bytes, role: str):
        if role not in ("connector", "acceptor"):
            raise ValueError(f"role must be connector/acceptor, not "
                             f"{role!r}")
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        except ImportError as e:  # pragma: no cover - env without lib
            raise AuthError(
                "secure mode needs the 'cryptography' package") from e
        self._gcm = AESGCM(_mac(session_key, b"aes-key"))  # 32 bytes
        other = "acceptor" if role == "connector" else "connector"
        self._salt_tx = _mac(session_key, b"nonce-" + role.encode())[:4]
        self._salt_rx = _mac(session_key, b"nonce-" + other.encode())[:4]
        self._seq_tx = 0
        self._seq_rx = 0

    def encrypt(self, record: bytes) -> bytes:
        nonce = self._salt_tx + struct.pack("<Q", self._seq_tx)
        ct = self._gcm.encrypt(nonce, record, None)
        self._seq_tx += 1
        return struct.pack("<I", len(ct)) + ct

    def decrypt(self, ciphertext: bytes) -> bytes:
        """Ciphertext WITHOUT the length prefix."""
        from cryptography.exceptions import InvalidTag

        nonce = self._salt_rx + struct.pack("<Q", self._seq_rx)
        try:
            rec = self._gcm.decrypt(nonce, bytes(ciphertext), None)
        except InvalidTag as e:
            raise AuthError("secure frame failed authentication "
                            "(tamper/replay/reorder)") from e
        self._seq_rx += 1
        return rec


def handshake_accept(keys: KeyServer, hello: bytes,
                     challenge: bytes, proof: bytes) -> bytes:
    """Acceptor-side verification: returns the session key or raises
    (the cephx do-you-know-the-secret arc)."""
    entity, nonce, _mode = Authenticator.parse_hello(hello)
    secret = keys.get(entity)
    if secret is None:
        raise AuthError(f"unknown entity {entity!r}")
    want = _mac(secret, challenge, nonce, entity.encode())
    if not hmac.compare_digest(proof, want):
        raise AuthError(f"bad proof from {entity!r}")
    return _mac(secret, b"session", challenge, nonce)
