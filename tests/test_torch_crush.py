"""The port's CRUSH straw2 ops (``ceph_tpu_torch.ops.crush``, plain
versions on CPU tensors) against the JAX package's (``ceph_tpu.ops.crush``)
and both C++ host cores, on numpy-seeded inputs. Tolerance: exact
equality (integer results)."""
import numpy as np
import pytest
import torch

from ceph_tpu import native as jnt
from ceph_tpu.ops import crush as jcrush
from ceph_tpu_torch import native as nt
from ceph_tpu_torch.native import gen_tables
from ceph_tpu_torch.ops import crush
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def test_hashes_equal_jax_and_host():
    rng = np.random.default_rng(41)
    a, b, c = (rng.integers(0, 2**32, 4096, dtype=np.uint32)
               for _ in range(3))
    got2 = _np(crush.hash32_2(a, b))
    got3 = _np(crush.hash32_3(a, b, c))
    assert np.array_equal(got2, np.asarray(jcrush.hash32_2(a, b)))
    assert np.array_equal(got3, np.asarray(jcrush.hash32_3(a, b, c)))
    for i in range(0, 4096, 97):
        assert got2[i] == nt.crush_hash32_2(int(a[i]), int(b[i]))
        assert got3[i] == jnt.crush_hash32_3(int(a[i]), int(b[i]), int(c[i]))


def test_crush_ln_full_domain():
    """All 2^16 inputs, u = 0xffff (the x == 0x10000 wrap) included."""
    u = np.arange(1 << 16, dtype=np.uint32)
    got = _np(crush.crush_ln(torch.from_numpy(u.astype(np.int64))))
    assert np.array_equal(got, np.asarray(jcrush.crush_ln(u)))
    want = np.array([nt.crush_ln(int(v)) for v in u], dtype=np.int64)
    assert np.array_equal(got, want)


def test_ln_tables_equal_jax_and_the_c_header(tmp_path):
    for mine, theirs in zip(crush.ln_tables(), jcrush._ln_tables()):
        assert np.array_equal(mine, theirs)
    header = tmp_path / "crush_ln_tables.h"
    gen_tables.emit_c(str(header))
    shipped = (nt.SOURCES[1]).read_text()
    assert header.read_text() == shipped


#: weights at the corners of the 16.16 range and of the division
WEIGHT_CORNERS = [0, 1, 2, 3, 5, 7, 0xFFFE, 0xFFFF, 0x10000, 0x10001,
                  2**24 - 1, 2**24, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]


def test_straw2_draw_over_the_weight_corner_lattice():
    """Every corner weight against inputs whose hashes span the whole
    16-bit ln domain (numerators 2^48 - ln from 2^28 to 2^48)."""
    rng = np.random.default_rng(43)
    n = 2048
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    ids = rng.integers(0, 2**32, n, dtype=np.uint32)
    r = rng.integers(0, 16, n, dtype=np.uint32)
    u = _np(crush.hash32_3(x, ids, r)) & 0xFFFF
    assert u.min() < 64 and u.max() > 0xFFC0
    for w in WEIGHT_CORNERS:
        wv = np.full(n, w, dtype=np.uint32)
        got = _np(crush.straw2_draw(x, ids, r, wv))
        assert np.array_equal(got, np.asarray(
            jcrush.straw2_draw(x, ids, r, wv))), w
        for i in range(0, n, 211):
            assert got[i] == nt.straw2_draw(int(x[i]), int(ids[i]),
                                            int(r[i]), w)


def test_straw2_draw_random_weights():
    rng = np.random.default_rng(44)
    x = rng.integers(0, 2**32, 512, dtype=np.uint32)
    ids = rng.integers(0, 2**32, 512, dtype=np.uint32)
    r = rng.integers(0, 16, 512, dtype=np.uint32)
    w = rng.integers(0, 2**20, 512, dtype=np.uint32)
    w[::17] = 0  # zero-weight items can never win
    got = _np(crush.straw2_draw(x, ids, r, w))
    assert np.array_equal(got, np.asarray(jcrush.straw2_draw(x, ids, r, w)))
    for i in range(512):
        assert got[i] == jnt.straw2_draw(int(x[i]), int(ids[i]), int(r[i]),
                                         int(w[i]))


@pytest.mark.parametrize("n_items", [1, 7, 64, 1000])
def test_straw2_bulk_equals_jax_and_host(n_items):
    rng = np.random.default_rng(n_items)
    items = np.arange(n_items, dtype=np.int32)
    ids = rng.integers(-2**31, 2**31, n_items).astype(np.int32)
    weights = rng.integers(1, 0x40000, n_items, dtype=np.uint32)
    if n_items > 3:
        weights[3] = 0
        weights[1] = weights[2]  # equal weights: first wins on equal draws
    xs = rng.integers(0, 2**32, 2000, dtype=np.uint32)
    got = crush.straw2_bulk(items, weights, xs, r=2, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, jcrush.straw2_bulk(items, weights, xs, r=2))
    assert np.array_equal(got, nt.straw2_bulk(items, weights, xs, r=2))
    with_ids = crush.straw2_bulk(items, weights, xs, r=5, ids=ids,
                                 device="cpu")
    assert np.array_equal(with_ids, jcrush.straw2_bulk(items, weights, xs,
                                                       r=5, ids=ids))


def test_straw2_all_zero_bucket_returns_slot_zero():
    items = np.array([9, 4, 6], dtype=np.int32)
    xs = np.arange(100, dtype=np.uint32)
    got = crush.straw2_bulk(items, np.zeros(3, np.uint32), xs, device="cpu")
    assert (got == 9).all()
    assert np.array_equal(got, nt.straw2_bulk(items, np.zeros(3, np.uint32),
                                              xs))


def test_straw2_chunked_plain_equals_one_pass(monkeypatch):
    rng = np.random.default_rng(45)
    items = np.arange(50, dtype=np.int32)
    weights = rng.integers(1, 0x40000, 50, dtype=np.uint32)
    xs = rng.integers(0, 2**32, 3001, dtype=np.uint32)
    whole = crush.straw2_bulk(items, weights, xs, r=1, device="cpu")
    monkeypatch.setattr(crush, "_PLAIN_CHUNK", 700)  # 14 x per chunk
    assert np.array_equal(crush.straw2_bulk(items, weights, xs, r=1,
                                            device="cpu"), whole)


def test_straw2_distribution_follows_weights():
    items = np.arange(4, dtype=np.int32)
    weights = (np.array([1, 2, 3, 4]) * 0x10000).astype(np.uint32)
    xs = np.random.default_rng(46).integers(0, 2**32, 40_000, dtype=np.uint32)
    counts = np.bincount(crush.straw2_bulk(items, weights, xs, device="cpu"),
                         minlength=4)
    np.testing.assert_allclose(counts / counts.sum(),
                               np.array([1, 2, 3, 4]) / 10, atol=0.01)


def test_straw2_choose_checks_its_operands():
    t = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        crush.straw2_choose(t.long(), t, t, t, 0)
    with pytest.raises(ValueError, match="bucket"):
        crush.straw2_choose(t, t[:2], t, t, 0)
    with pytest.raises(ValueError, match="bucket"):
        crush.straw2_choose(t[:0], t[:0], t[:0], t, 0)
