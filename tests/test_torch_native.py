"""The port's C++ host core (``ceph_tpu_torch.native``) against the JAX
package's (``ceph_tpu.native``): every entry point on the same
numpy-seeded inputs. Tolerance: exact equality (integer results).

``jax_library`` / ``jax_native_whole`` load the JAX package's library for
every port test file that runs that package's host code beside the
port's."""
import os
import threading
import time

import numpy as np
import pytest

from ceph_tpu import native as jnt
from ceph_tpu_torch import native as nt

ROOT_NATIVE = "ceph_tpu/native"


#: What dlopen says of a shared library whose linker is still writing it.
PARTIAL_LIBRARY = ("file too short", "ELF load command", "cannot read file data")


def jax_library(deadline_s: float = 120.0):
    """``ceph_tpu.native.lib()``, loaded once the library file is whole.
    The JAX package builds libceph_tpu_native.so at first use with make,
    in place and with no lock, so under parallel test workers one
    worker's dlopen can meet the file while another worker's linker is
    still writing it ("file too short"). Wait for that writer instead of
    failing whichever test first needs the library; any other load error
    (a library that is whole but broken) raises at once."""
    t_end = time.monotonic() + deadline_s
    while True:
        try:
            return jnt.lib()
        except OSError as e:
            if (not any(m in str(e) for m in PARTIAL_LIBRARY)
                    or time.monotonic() > t_end):
                raise
            time.sleep(0.25)


@pytest.fixture(scope="module", autouse=True)
def jax_native_whole():
    """Load the JAX package's C++ core (``jax_library``) before a
    module's tests run it; a module imports this fixture to use it."""
    jax_library()


def test_jax_library_waits_for_a_build_in_progress(tmp_path, monkeypatch):
    """The race of the JAX package's in-place build: the library file is
    cut short when the first load meets it, and whole a moment later."""
    whole = jnt._SO.read_bytes()
    path = tmp_path / "libceph_tpu_native.so"
    path.write_bytes(whole[:16])
    monkeypatch.setattr(jnt, "_SO", path)
    monkeypatch.setattr(jnt, "_build", lambda: None)
    monkeypatch.setattr(jnt, "_lib", None)
    with pytest.raises(OSError, match="too short"):
        jnt.lib()

    def finish():
        time.sleep(0.5)
        with open(path, "wb") as f:
            f.write(whole)
            f.flush()
            os.fsync(f.fileno())

    writer = threading.Thread(target=finish)
    writer.start()
    try:
        lib = jax_library(deadline_s=30)
    finally:
        writer.join()
    assert lib._name == str(path)
    assert lib.ct_gf_mul(3, 7) == nt.gf_mul(3, 7)


def test_jax_library_fails_at_once_on_a_load_error_of_another_kind(
        tmp_path, monkeypatch):
    """A library that no build is writing (here: none at all) raises on
    the first load instead of waiting out the deadline."""
    monkeypatch.setattr(jnt, "_SO", tmp_path / "libceph_tpu_native.so")
    monkeypatch.setattr(jnt, "_build", lambda: None)
    monkeypatch.setattr(jnt, "_lib", None)
    t0 = time.monotonic()
    with pytest.raises(OSError, match="No such file"):
        jax_library(deadline_s=30)
    assert time.monotonic() - t0 < 5


def test_library_is_the_ports_own_build():
    path = nt.library()
    assert path.parent.name == "build"
    assert path.parent.parent.name == "ceph_tpu_torch"
    nt.lib()
    assert ROOT_NATIVE not in str(nt.lib()._name)


def test_build_is_safe_under_concurrent_builders(tmp_path, monkeypatch):
    """Several builders at once (xdist workers, batcher threads) each
    write a temporary file and rename it: every one loads a whole
    library and the build directory holds no leftovers."""
    monkeypatch.setattr(nt, "BUILD", tmp_path)
    path = nt.library()
    assert not path.exists()
    errors = []

    def build():
        try:
            nt.build_library(path, nt.SOURCES[0])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    import ctypes

    assert ctypes.CDLL(str(path)).ct_gf_mul(3, 7) == jnt.gf_mul(3, 7)


def test_gf_mul_and_inv_every_element():
    rng = np.random.default_rng(1)
    for a, b in rng.integers(0, 256, (500, 2)):
        assert nt.gf_mul(int(a), int(b)) == jnt.gf_mul(int(a), int(b))
    for a in range(1, 256):
        assert nt.gf_inv(a) == jnt.lib().ct_gf_inv(a)
        assert nt.gf_mul(a, nt.gf_inv(a)) == 1


@pytest.mark.parametrize("k,m", [(2, 1), (3, 2), (4, 2), (8, 3), (10, 4),
                                 (12, 4)])
def test_matrices(k, m):
    assert np.array_equal(nt.rs_matrix_vandermonde(k, m),
                          jnt.rs_matrix_vandermonde(k, m))
    assert np.array_equal(nt.rs_matrix_cauchy(k, m),
                          jnt.rs_matrix_cauchy(k, m))


@pytest.mark.parametrize("n,seed", [(2, 0), (4, 1), (6, 2), (8, 3), (11, 4)])
def test_matinv(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        mat = rng.integers(0, 256, (n, n), dtype=np.uint8)
        try:
            want = jnt.gf_matinv(mat)
        except np.linalg.LinAlgError:
            with pytest.raises(np.linalg.LinAlgError):
                nt.gf_matinv(mat)
            continue
        assert np.array_equal(nt.gf_matinv(mat), want)


def test_matinv_singular_raises():
    with pytest.raises(np.linalg.LinAlgError):
        nt.gf_matinv(np.zeros((3, 3), np.uint8))


@pytest.mark.parametrize("rows,cols,length", [(3, 8, 4096), (2, 3, 1),
                                              (8, 8, 1000), (4, 10, 777),
                                              (1, 1, 64)])
@pytest.mark.parametrize("threads", [0, 3])
def test_rs_matmul_and_encode(rows, cols, length, threads):
    rng = np.random.default_rng(rows * 100 + cols)
    mat = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
    data = rng.integers(0, 256, (cols, length), dtype=np.uint8)
    want = jnt.rs_matmul(mat, data)
    assert np.array_equal(nt.rs_matmul(mat, data, threads=threads), want)
    assert np.array_equal(nt.rs_encode(mat, data, threads=threads), want)
    with pytest.raises(ValueError):
        nt.rs_matmul(mat, data[:-1] if cols > 1 else data[:0])


@pytest.mark.parametrize("present", [(0, 2, 3, 4, 5, 6, 8, 10),
                                     (3, 4, 5, 6, 7, 8, 9, 10),
                                     tuple(range(8))])
def test_rs_decode(present):
    rng = np.random.default_rng(sum(present))
    gen = nt.rs_matrix_vandermonde(8, 3)
    data = rng.integers(0, 256, (8, 1024), dtype=np.uint8)
    every = np.concatenate([data, nt.rs_encode(gen, data)])
    got = nt.rs_decode(gen, list(present), every[list(present)])
    assert np.array_equal(got, jnt.rs_decode(gen, list(present),
                                             every[list(present)]))
    assert np.array_equal(got, data)
    with pytest.raises(ValueError):
        nt.rs_decode(gen, list(present)[:7], every[list(present)[:7]])


@pytest.mark.parametrize("length", [0, 1, 3, 4, 7, 8, 9, 63, 64, 4096, 100001])
@pytest.mark.parametrize("seed", [0xFFFFFFFF, 0, 0xDEADBEEF])
def test_crc32c(length, seed):
    data = np.random.default_rng(length).integers(0, 256, length,
                                                  dtype=np.uint8)
    want = jnt.crc32c(data, seed=seed)
    assert nt.crc32c(data, seed=seed) == want
    assert nt.crc32c(data.tobytes(), seed=seed) == want
    assert nt.crc32c_sw(data, seed=seed) == jnt.lib().ct_crc32c_sw(
        seed, data, data.size) == want
    assert nt.crc32c(None, seed=seed, length=length) == jnt.crc32c(
        None, seed=seed, length=length)
    assert nt.crc32c_zeros(seed, length) == jnt.lib().ct_crc32c_zeros(
        seed, length)


def test_crc32c_check_value():
    assert nt.crc32c(b"123456789") ^ 0xFFFFFFFF == 0xE3069283


@pytest.mark.parametrize("n,length", [(64, 4096), (7, 1), (3, 100003),
                                      (1000, 12)])
@pytest.mark.parametrize("threads", [0, 4])
def test_crc32c_batch(n, length, threads):
    blobs = np.random.default_rng(n).integers(0, 256, (n, length),
                                              dtype=np.uint8)
    for seed in (0xFFFFFFFF, 0):
        got = nt.crc32c_batch(blobs, seed=seed, threads=threads)
        assert got.dtype == np.uint32
        assert np.array_equal(got, jnt.crc32c_batch(blobs, seed=seed))


def test_xxhash_vectors():
    assert nt.xxhash32(b"") == 0x02CC5D05
    assert nt.xxhash32(b"abc") == 0x32D153FF
    assert nt.xxhash64(b"") == 0xEF46DB3751D8E999
    assert nt.xxhash64(b"abc") == 0x44BC2CF5AD770999


@pytest.mark.parametrize("length", [0, 1, 3, 4, 15, 16, 17, 31, 32, 33, 100,
                                    4096, 65537])
def test_xxhash_against_reference(length):
    data = np.random.default_rng(length).integers(0, 256, length,
                                                  dtype=np.uint8)
    for seed in (0, 1, 0xFFFFFFFF, (1 << 64) - 1, 0x123456789ABCDEF):
        assert nt.xxhash32(data, seed) == jnt.xxhash32(data, seed)
        assert nt.xxhash64(data, seed) == jnt.xxhash64(data, seed)
    assert nt.xxhash64(data.tobytes()) == jnt.xxhash64(data.tobytes())


def test_crush_hashes_and_ln():
    rng = np.random.default_rng(7)
    for a, b, c in rng.integers(0, 2**32, (300, 3), dtype=np.uint64):
        a, b, c = int(a), int(b), int(c)
        assert nt.crush_hash32_2(a, b) == jnt.crush_hash32_2(a, b)
        assert nt.crush_hash32_3(a, b, c) == jnt.crush_hash32_3(a, b, c)
    for x in list(range(0, 0x10001, 97)) + [0xFFFF, 0x10000, 2**32 - 1]:
        assert nt.crush_ln(x) == jnt.crush_ln(x)


def test_straw2_draw_and_choose():
    rng = np.random.default_rng(8)
    items = np.arange(-1, -13, -1, dtype=np.int32)
    ids = np.arange(100, 112, dtype=np.int32)
    weights = rng.integers(0, 5 * 0x10000, 12).astype(np.uint32)
    weights[3] = 0
    for x in rng.integers(0, 2**32, 200, dtype=np.uint64):
        x = int(x)
        for r in (0, 1, 5):
            assert nt.straw2_choose(items, weights, x, r) == \
                jnt.straw2_choose(items, weights, x, r)
            assert nt.straw2_choose(items, weights, x, r, ids=ids) == \
                jnt.straw2_choose(items, weights, x, r, ids=ids)
        w = int(weights[x % 12])
        assert nt.straw2_draw(x, 100 + x % 12, 2, w) == \
            jnt.straw2_draw(x, 100 + x % 12, 2, w)


@pytest.mark.parametrize("threads", [0, 4])
def test_straw2_bulk(threads):
    rng = np.random.default_rng(9)
    items = np.arange(20, dtype=np.int32)
    weights = rng.integers(1, 4 * 0x10000, 20).astype(np.uint32)
    xs = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    for r in (0, 3):
        got = nt.straw2_bulk(items, weights, xs, r=r, threads=threads)
        assert np.array_equal(got, jnt.straw2_bulk(items, weights, xs, r=r))
        ids = items + 1000
        assert np.array_equal(
            nt.straw2_bulk(items, weights, xs, r=r, ids=ids, threads=threads),
            jnt.straw2_bulk(items, weights, xs, r=r, ids=ids))
