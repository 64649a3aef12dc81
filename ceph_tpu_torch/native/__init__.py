"""ctypes bindings for the port's C++ host core (``ct_native.cc``).

``ct_native.cc`` and ``crush_ln_tables.h`` are the port's own copies of
the JAX package's native sources: GF(2^8) field ops and Reed-Solomon
matrices, the multithreaded host RS engine (``rs_encode`` / ``rs_matmul``
/ ``rs_decode``), CRC32C (SSE4.2 where the host has it), CRUSH straw2 and
xxhash32/64. ``rt`` binds the second library, ``rt_native.cc`` (the
store's embedded KV, block device and bitmap allocator).

Both libraries are built at first use with ``g++`` (``build_library``)
into ``ceph_tpu_torch/build/`` (gitignored), named by a digest of the
sources and flags, so a changed source is rebuilt; each build writes a
temporary file and renames it into place, so processes building at once
never see a partial library. All array arguments are numpy arrays;
chunks are row-major (k, L) uint8.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD = _DIR.parent / "build"
SOURCES = (_DIR / "ct_native.cc", _DIR / "crush_ln_tables.h")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def library_path(stem: str, sources: tuple[Path, ...]) -> Path:
    """Where the shared library ``stem`` built from ``sources`` (the
    compiled file, then the headers it includes) with CXX_FLAGS lies."""
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources)
        + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{stem}-{digest}.so"


def build_library(lib_path: Path, source: Path) -> Path:
    """Compile ``source`` with g++ into ``lib_path`` unless it is there."""
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's C++ host "
                           "libraries are built at first use")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {lib_path.name} failed (exit "
                           f"{res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> Path:
    """Path of the host core library for the current sources and flags."""
    return library_path("ct_native", SOURCES)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(library(), SOURCES[0])))
    lib.ct_gf_mul.restype = ctypes.c_uint8
    lib.ct_gf_mul.argtypes = [ctypes.c_uint8, ctypes.c_uint8]
    lib.ct_gf_inv.restype = ctypes.c_uint8
    lib.ct_gf_inv.argtypes = [ctypes.c_uint8]
    lib.ct_rs_matrix_vandermonde.restype = ctypes.c_int
    lib.ct_rs_matrix_vandermonde.argtypes = [ctypes.c_int, ctypes.c_int, _u8p]
    lib.ct_rs_matrix_cauchy.restype = ctypes.c_int
    lib.ct_rs_matrix_cauchy.argtypes = [ctypes.c_int, ctypes.c_int, _u8p]
    lib.ct_gf_matinv.restype = ctypes.c_int
    lib.ct_gf_matinv.argtypes = [_u8p, ctypes.c_int]
    lib.ct_rs_matmul.restype = None
    lib.ct_rs_matmul.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_size_t, _u8p]
    lib.ct_rs_matmul_mt.restype = None
    lib.ct_rs_matmul_mt.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_size_t, _u8p,
        ctypes.c_int]
    lib.ct_rs_decode.restype = ctypes.c_int
    lib.ct_rs_decode.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _i32p, _u8p, ctypes.c_size_t, _u8p]
    lib.ct_crc32c.restype = ctypes.c_uint32
    lib.ct_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64]
    lib.ct_crc32c_sw.restype = ctypes.c_uint32
    lib.ct_crc32c_sw.argtypes = [ctypes.c_uint32, _u8p, ctypes.c_uint64]
    lib.ct_crc32c_zeros.restype = ctypes.c_uint32
    lib.ct_crc32c_zeros.argtypes = [ctypes.c_uint32, ctypes.c_uint64]
    lib.ct_crc32c_batch.restype = None
    lib.ct_crc32c_batch.argtypes = [
        ctypes.c_uint32, _u8p, ctypes.c_uint64, ctypes.c_uint64, _u32p]
    lib.ct_crc32c_batch_mt.restype = None
    lib.ct_crc32c_batch_mt.argtypes = [
        ctypes.c_uint32, _u8p, ctypes.c_uint64, ctypes.c_uint64, _u32p,
        ctypes.c_int]
    lib.ct_crush_hash32_2.restype = ctypes.c_uint32
    lib.ct_crush_hash32_2.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.ct_crush_hash32_3.restype = ctypes.c_uint32
    lib.ct_crush_hash32_3.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lib.ct_crush_ln.restype = ctypes.c_uint64
    lib.ct_crush_ln.argtypes = [ctypes.c_uint32]
    lib.ct_straw2_draw.restype = ctypes.c_int64
    lib.ct_straw2_draw.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lib.ct_straw2_choose.restype = ctypes.c_int32
    lib.ct_straw2_choose.argtypes = [
        _i32p, _i32p, _u32p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32]
    lib.ct_straw2_bulk.restype = None
    lib.ct_straw2_bulk.argtypes = [
        _i32p, _i32p, _u32p, ctypes.c_int, _u32p, ctypes.c_uint64,
        ctypes.c_uint32, _i32p]
    lib.ct_straw2_bulk_mt.restype = None
    lib.ct_straw2_bulk_mt.argtypes = [
        _i32p, _i32p, _u32p, ctypes.c_int, _u32p, ctypes.c_uint64,
        ctypes.c_uint32, _i32p, ctypes.c_int]
    lib.ct_xxhash32.restype = ctypes.c_uint32
    lib.ct_xxhash32.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint32]
    lib.ct_xxhash64.restype = ctypes.c_uint64
    lib.ct_xxhash64.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint64]
    return lib


_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use (thread-safe)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load()
        return _lib


# ------------------------- numpy-friendly wrappers -------------------------


def _bytes(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def gf_mul(a: int, b: int) -> int:
    return lib().ct_gf_mul(a, b)


def gf_inv(a: int) -> int:
    return lib().ct_gf_inv(a)


def rs_matrix_vandermonde(k: int, m: int) -> np.ndarray:
    out = np.zeros((m, k), dtype=np.uint8)
    if lib().ct_rs_matrix_vandermonde(k, m, out) != 0:
        raise ValueError(f"bad k={k}, m={m}")
    return out


def rs_matrix_cauchy(k: int, m: int) -> np.ndarray:
    out = np.zeros((m, k), dtype=np.uint8)
    if lib().ct_rs_matrix_cauchy(k, m, out) != 0:
        raise ValueError(f"bad k={k}, m={m}")
    return out


def gf_matinv(m: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(m, dtype=np.uint8).copy()
    if lib().ct_gf_matinv(a, a.shape[0]) != 0:
        raise np.linalg.LinAlgError("singular GF(2^8) matrix")
    return a


def rs_matmul(matrix: np.ndarray, data: np.ndarray, threads: int = 0) -> np.ndarray:
    """matrix (R, C) x data (C, L) -> (R, L), GF(2^8); ``threads`` > 1
    splits L across that many host threads."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    rows, k = matrix.shape
    if data.shape[0] != k:
        raise ValueError(f"data has {data.shape[0]} chunks, matrix wants {k}")
    out = np.empty((rows, data.shape[1]), dtype=np.uint8)
    if threads > 1:
        lib().ct_rs_matmul_mt(matrix, rows, k, data, data.shape[1], out, threads)
    else:
        lib().ct_rs_matmul(matrix, rows, k, data, data.shape[1], out)
    return out


def rs_encode(matrix: np.ndarray, data: np.ndarray, threads: int = 0) -> np.ndarray:
    """Parity (m, L) of data (k, L) under the (m, k) coding matrix."""
    return rs_matmul(matrix, data, threads)


def rs_decode(
    matrix: np.ndarray, present: list[int], chunks: np.ndarray
) -> np.ndarray:
    """The k data chunks from k survivors (rows of ``chunks`` in
    ``present`` order; 0..k-1 data, k.. parity)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    m, k = matrix.shape
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    if chunks.shape[0] != k or len(present) != k:
        raise ValueError(
            f"need exactly k={k} surviving chunks, got {chunks.shape[0]} "
            f"chunks / {len(present)} indices"
        )
    pres = np.asarray(present, dtype=np.int32)
    out = np.empty((k, chunks.shape[1]), dtype=np.uint8)
    if lib().ct_rs_decode(matrix, k, m, pres, chunks, chunks.shape[1], out) != 0:
        raise ValueError(f"cannot decode from chunks {present}")
    return out


def crc32c(data: np.ndarray | bytes | None, seed: int = 0xFFFFFFFF,
           length: int | None = None) -> int:
    """CRC32C of ``data``; with ``data`` None, of ``length`` zero bytes."""
    if data is None:
        return lib().ct_crc32c(seed & 0xFFFFFFFF, None, length or 0)
    a = _bytes(data)
    return lib().ct_crc32c(seed & 0xFFFFFFFF, a.ctypes.data, a.size)


def crc32c_sw(data: np.ndarray | bytes, seed: int = 0xFFFFFFFF) -> int:
    """CRC32C by the portable table path (the hardware path's oracle)."""
    a = _bytes(data)
    return lib().ct_crc32c_sw(seed & 0xFFFFFFFF, a, a.size)


def crc32c_zeros(crc: int, length: int) -> int:
    """``crc`` after ``length`` zero bytes."""
    return lib().ct_crc32c_zeros(crc & 0xFFFFFFFF, length)


def crc32c_batch(blobs: np.ndarray, seed: int = 0xFFFFFFFF, threads: int = 0) -> np.ndarray:
    """blobs (N, L) uint8 -> (N,) uint32 of per-blob CRCs."""
    blobs = np.ascontiguousarray(blobs, dtype=np.uint8)
    n, l = blobs.shape
    out = np.empty(n, dtype=np.uint32)
    if threads > 1:
        lib().ct_crc32c_batch_mt(seed & 0xFFFFFFFF, blobs, l, n, out, threads)
    else:
        lib().ct_crc32c_batch(seed & 0xFFFFFFFF, blobs, l, n, out)
    return out


def crush_hash32_2(a: int, b: int) -> int:
    return lib().ct_crush_hash32_2(a & 0xFFFFFFFF, b & 0xFFFFFFFF)


def crush_hash32_3(a: int, b: int, c: int) -> int:
    return lib().ct_crush_hash32_3(a & 0xFFFFFFFF, b & 0xFFFFFFFF, c & 0xFFFFFFFF)


def crush_ln(x: int) -> int:
    return lib().ct_crush_ln(x & 0xFFFFFFFF)


def straw2_draw(x: int, item_id: int, r: int, weight: int) -> int:
    return lib().ct_straw2_draw(x & 0xFFFFFFFF, item_id & 0xFFFFFFFF,
                                r & 0xFFFFFFFF, weight & 0xFFFFFFFF)


def straw2_choose(items: np.ndarray, weights: np.ndarray, x: int, r: int,
                  ids: np.ndarray | None = None) -> int:
    items = np.ascontiguousarray(items, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.uint32)
    ids_arr = items if ids is None else np.ascontiguousarray(ids, dtype=np.int32)
    return lib().ct_straw2_choose(items, ids_arr, weights, len(items),
                                  x & 0xFFFFFFFF, r & 0xFFFFFFFF)


def straw2_bulk(items: np.ndarray, weights: np.ndarray, xs: np.ndarray,
                r: int = 0, ids: np.ndarray | None = None,
                threads: int = 0) -> np.ndarray:
    items = np.ascontiguousarray(items, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.uint32)
    xs = np.ascontiguousarray(xs, dtype=np.uint32)
    ids_arr = items if ids is None else np.ascontiguousarray(ids, dtype=np.int32)
    out = np.empty(len(xs), dtype=np.int32)
    if threads > 1:
        lib().ct_straw2_bulk_mt(items, ids_arr, weights, len(items), xs,
                                len(xs), r & 0xFFFFFFFF, out, threads)
    else:
        lib().ct_straw2_bulk(items, ids_arr, weights, len(items), xs,
                             len(xs), r & 0xFFFFFFFF, out)
    return out


def xxhash32(data: bytes | np.ndarray, seed: int = 0) -> int:
    a = _bytes(data)
    return lib().ct_xxhash32(a, a.size, seed & 0xFFFFFFFF)


def xxhash64(data: bytes | np.ndarray, seed: int = 0) -> int:
    a = _bytes(data)
    return lib().ct_xxhash64(a, a.size, seed & 0xFFFFFFFFFFFFFFFF)
