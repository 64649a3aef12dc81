"""RBD image encryption (the src/librbd/crypto LUKS role).

The reference formats an image with a LUKS1/2 header and runs AES-XTS
under the IO dispatch layers (`librbd/crypto/LoadRequest.cc`,
`EncryptionFormat`). This module is that capability over Image:

- ``RBD.encryption_format(name, passphrase)`` mints a random 512-bit
  XTS data key, wraps it with AES-GCM under a PBKDF2-derived KEK, and
  stores header {salt, nonce, wrapped key} as an xattr on the image
  header object (the LUKS keyslot role: the passphrase unlocks the
  data key; the data key never changes, so re-keying the passphrase
  never re-encrypts data).
- ``RBD.open_encrypted(name, passphrase)`` unwraps the key (a wrong
  passphrase fails the GCM tag, mapping to the LUKS "no key available
  with this passphrase" error) and returns an :class:`EncryptedImage`
  wrapping the plain Image.
- Data is AES-XTS encrypted per 4 KiB crypto block (LUKS2's larger
  sector size), tweak = little-endian block number — so random IO
  needs no chaining state and every block is independently
  addressable. Partial-block writes read-modify-write the boundary
  blocks through the decrypting read path.
- SPARSE-aware: an all-zero ciphertext block reads as zero plaintext.
  RBD images are thin — unwritten objects are holes that read as
  zeros, and decrypting them would return garbage (dm-crypt
  semantics); treating the all-zero block as a hole keeps rbd's
  sparse read contract. A real XTS block is all-zeros with
  probability 2^-32768 — not a practical ambiguity.

Snapshots/clones pass through to the wrapped Image untouched: they
operate on ciphertext objects, so a snapshot of an encrypted image is
itself encrypted (same as the reference). ``resize`` is intercepted
only to hold the size to crypto-block multiples.

ceph_tpu_torch's own copy of ``ceph_tpu/services/rbd_crypto.py``.
"""
from __future__ import annotations

import asyncio
import hashlib
import os

from ..cluster.client import absent_attr as _no_header
from .rbd import Image, RBD

CRYPT_ATTR = "rbd.crypt"
BLOCK = 4096
_PBKDF2_ITERS = 100_000


class WrongPassphrase(Exception):
    pass


def _kek(passphrase: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", passphrase.encode(), salt,
                               _PBKDF2_ITERS)


def _aes_gcm(key: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    return AESGCM(key)


def _xts(key64: bytes, block_no: int):
    from cryptography.hazmat.primitives.ciphers import (
        Cipher, algorithms, modes)

    tweak = block_no.to_bytes(16, "little")
    return Cipher(algorithms.AES(key64), modes.XTS(tweak))


async def encryption_format(rbd: RBD, name: str,
                            passphrase: str) -> None:
    """Format an EMPTY image for encryption (EncryptionFormatRequest
    role). Existing plaintext data is NOT converted — same as the
    reference, which requires formatting before first use."""
    img = await rbd.open(name)
    try:
        if img.size % BLOCK:
            raise IOError(
                f"image size {img.size} not a multiple of the "
                f"{BLOCK}-byte crypto block")
        # the exclusive lock serializes the probe-then-write: without
        # it two concurrent formats both pass the probe and the
        # loser's keyslot (and everything encrypted under it) is
        # clobbered
        await img.acquire_lock()
        hdr = _header_oid_of(img)
        already = True
        try:
            await img.client.getxattr(img.pool_id, hdr, CRYPT_ATTR)
        except Exception as e:
            if not _no_header(e):
                raise
            already = False
        if already:
            raise IOError(f"image {name!r} already formatted")
        data_key = os.urandom(64)  # AES-256-XTS: two 32-byte halves
        salt = os.urandom(16)
        nonce = os.urandom(12)
        wrapped = _aes_gcm(_kek(passphrase, salt)).encrypt(
            nonce, data_key, b"rbd-xts-keyslot")
        await img.client.setxattr(
            img.pool_id, hdr, CRYPT_ATTR, salt + nonce + wrapped)
    finally:
        await img.release_lock()


async def open_encrypted(rbd: RBD, name: str, passphrase: str,
                         snap: str | None = None,
                         **kw) -> "EncryptedImage":
    """Open an encryption-formatted image (crypto LoadRequest role)."""
    img = await rbd.open(name, snap=snap, **kw)
    try:
        raw = await img.client.getxattr(
            img.pool_id, _header_oid_of(img), CRYPT_ATTR)
    except Exception as e:
        await img.release_lock()
        if not _no_header(e):
            raise
        raise IOError(f"image {name!r} is not encryption-formatted") \
            from None
    salt, nonce, wrapped = raw[:16], raw[16:28], raw[28:]
    try:
        data_key = _aes_gcm(_kek(passphrase, salt)).decrypt(
            nonce, wrapped, b"rbd-xts-keyslot")
    except Exception:
        await img.release_lock()
        raise WrongPassphrase(name) from None
    return EncryptedImage(img, data_key)


def _header_oid_of(img: Image) -> str:
    from .rbd import _header

    return _header(img.name)


class EncryptedImage:
    """Decrypting/encrypting view over an Image; same IO surface."""

    def __init__(self, image: Image, data_key: bytes):
        self.image = image
        self._key = data_key
        #: serializes encrypting writes: two concurrent sub-block
        #: writes RMW-ing the same crypto block would each re-encrypt
        #: a full block read before the other landed — last writer
        #: would silently erase the first (the plain Image has no such
        #: read-modify-write, so it needs no such lock)
        self._wlock = asyncio.Lock()

    # everything non-IO passes through (snapshots, locks, resize, ...)
    def __getattr__(self, attr):
        return getattr(self.image, attr)

    def _decrypt(self, first_block: int, ct: bytes) -> bytes:
        out = bytearray(len(ct))
        for i in range(0, len(ct), BLOCK):
            blk = ct[i:i + BLOCK]
            if blk.count(0) == len(blk):
                continue  # hole: stays zeros (see module docstring)
            dec = _xts(self._key, first_block + i // BLOCK).decryptor()
            out[i:i + len(blk)] = dec.update(blk) + dec.finalize()
        return bytes(out)

    def _encrypt(self, first_block: int, pt: bytes) -> bytes:
        out = bytearray(len(pt))
        for i in range(0, len(pt), BLOCK):
            enc = _xts(self._key, first_block + i // BLOCK).encryptor()
            blk = pt[i:i + BLOCK]
            out[i:i + len(blk)] = enc.update(blk) + enc.finalize()
        return bytes(out)

    async def read(self, offset: int, length: int) -> bytes:
        length = max(0, min(length, self.image.size - offset))
        if length == 0:
            return b""
        start = offset - offset % BLOCK
        end = min(-(-(offset + length) // BLOCK) * BLOCK,
                  self.image.size)
        ct = await self.image.read(start, end - start)
        ct += b"\x00" * (end - start - len(ct))  # short read = hole
        pt = self._decrypt(start // BLOCK, ct)
        return pt[offset - start:offset - start + length]

    async def write(self, offset: int, data: bytes) -> None:
        if not data:
            return
        if offset + len(data) > self.image.size:
            raise IOError("write past end of image")
        start = offset - offset % BLOCK
        end = min(-(-(offset + len(data)) // BLOCK) * BLOCK,
                  self.image.size)
        async with self._wlock:
            await self._write_locked(offset, data, start, end)

    async def _write_locked(self, offset: int, data: bytes,
                            start: int, end: int) -> None:
        head = tail = b""
        if start < offset:  # boundary RMW via the decrypting read
            head = await self.read(start, offset - start)
        tail_from = offset + len(data)
        if end > tail_from:
            tail = await self.read(tail_from, end - tail_from)
        pt = head + data + tail
        await self.image.write(start,
                               self._encrypt(start // BLOCK, pt))

    async def resize(self, new_size: int) -> None:
        if new_size % BLOCK:
            raise IOError(
                f"encrypted image size must stay a multiple of "
                f"{BLOCK} (got {new_size})")
        await self.image.resize(new_size)

    async def discard(self, offset: int, length: int) -> None:
        """Zero a range: block-aligned spans become real holes (read
        back as zeros via the hole rule); boundary fragments are
        re-encrypted zeros."""
        end = min(offset + length, self.image.size)
        offset = min(offset, self.image.size)

        async def zero(off: int, n: int) -> None:
            z = b"\x00" * n
            s0 = off - off % BLOCK
            e0 = min(-(-(off + n) // BLOCK) * BLOCK, self.image.size)
            await self._write_locked(off, z, s0, e0)

        # the whole punch-then-rewrite runs under the write lock: a
        # concurrent sub-block write's RMW interleaving with the punch
        # would re-encrypt pre-discard bytes back in
        async with self._wlock:
            a = -(-offset // BLOCK) * BLOCK  # first fully-covered blk
            b = (end // BLOCK) * BLOCK       # end of last covered blk
            if a < b:
                await self.image.discard(a, b - a)
                if offset < a:
                    await zero(offset, a - offset)
                if b < end:
                    await zero(b, end - b)
            elif offset < end:  # whole range inside one crypto block
                await zero(offset, end - offset)

    async def close(self) -> None:
        await self.image.release_lock()
