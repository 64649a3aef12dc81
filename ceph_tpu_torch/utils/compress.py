"""Compressor plugin layer (the src/compressor role).

Same seam as the reference: named plugins behind a factory
(CompressionPlugin.h), compress/decompress over bytes, and the
policy helpers BlueStore applies per blob — mode none/passive/
aggressive/force plus a required ratio gate
(Compressor::CompressionMode, bluestore_compression_* options).
Stdlib backends stand in for the native codec submodules: zlib
(deflate), bz2, lzma(zstd-role); gated cleanly if an interpreter
lacks one.

ceph_tpu_torch's own copy of ``ceph_tpu/utils/compress.py``.
"""
from __future__ import annotations

import bz2
import lzma
import zlib
from typing import Callable


class CompressError(Exception):
    pass


class Compressor:
    """One algorithm: compress/decompress bytes->bytes."""

    def __init__(self, name: str,
                 compress: Callable[[bytes], bytes],
                 decompress: Callable[[bytes], bytes]):
        self.name = name
        self._c = compress
        self._d = decompress

    def compress(self, data: bytes) -> bytes:
        return self._c(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        try:
            return self._d(bytes(data))
        except Exception as e:
            raise CompressError(f"{self.name}: corrupt stream: {e}") from e


_REGISTRY: dict[str, Compressor] = {}


def register(c: Compressor) -> None:
    _REGISTRY[c.name] = c


def create(name: str) -> Compressor:
    """Compressor::create role."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise CompressError(
            f"unknown compressor {name!r}; know {sorted(_REGISTRY)}"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)


register(Compressor("zlib", lambda b: zlib.compress(b, 6),
                    zlib.decompress))
register(Compressor("bz2", lambda b: bz2.compress(b, 5), bz2.decompress))
register(Compressor("lzma", lambda b: lzma.compress(b, preset=1),
                    lzma.decompress))


# ------------------------------------------------------------- policy

MODE_NONE = "none"
MODE_PASSIVE = "passive"      # only when the client hints compressible
MODE_AGGRESSIVE = "aggressive"  # unless the client hints incompressible
MODE_FORCE = "force"

HINT_NONE = 0
HINT_COMPRESSIBLE = 1
HINT_INCOMPRESSIBLE = 2


def should_compress(mode: str, hint: int = HINT_NONE) -> bool:
    """BlueStore's blob-compression decision (mode x client hint)."""
    if mode == MODE_NONE:
        return False
    if mode == MODE_FORCE:
        return True
    if mode == MODE_PASSIVE:
        return hint == HINT_COMPRESSIBLE
    if mode == MODE_AGGRESSIVE:
        return hint != HINT_INCOMPRESSIBLE
    raise CompressError(f"unknown compression mode {mode!r}")


def compress_blob(
    comp: Compressor, data: bytes, required_ratio: float = 0.875
) -> bytes | None:
    """Compress iff the result actually earns its keep
    (bluestore_compression_required_ratio role). None = store raw."""
    out = comp.compress(data)
    if len(out) <= len(data) * required_ratio:
        return out
    return None
