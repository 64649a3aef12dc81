"""The port's GF(2) XOR schedule (``ceph_tpu_torch.ops.gf2``) against the
JAX package's (``ceph_tpu.ops.gf2``) on the CPU: ``xor_plan`` on the host,
the plain torch version of K5 (csrc/gf2_xor.cu, which runs only on the
card), the cell entry and the encode + CRC, at the edges the kernel has
to hold (one term, an all-pad row, odd row lengths, one stripe, extra
batch dimensions). Inputs come from numpy seeds and cross as uint32.
Tolerance: exact equality (the functions are integer-only)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import bitmatrix_plugin as jbm
from ceph_tpu.ops import gf2 as jgf2
from ceph_tpu_torch import kernels
from ceph_tpu_torch.device import tensor_to_words, words_to_tensor
from ceph_tpu_torch.ec import bitmatrix_plugin as bm
from ceph_tpu_torch.ops import gf2
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)

#: (technique, k, m, w) of every bitmatrix code the codec tests run.
CODES = [
    ("blaum_roth", 3, 2, 4), ("blaum_roth", 4, 2, 4), ("blaum_roth", 4, 2, 6),
    ("blaum_roth", 5, 2, 6), ("blaum_roth", 6, 2, 6),
    ("liberation", 3, 2, 3), ("liberation", 4, 2, 5), ("liberation", 5, 2, 5),
    ("liberation", 6, 2, 7), ("liberation", 7, 2, 7),
    ("liber8tion", 3, 2, 8), ("liber8tion", 5, 2, 8), ("liber8tion", 8, 2, 8),
    ("cauchy_bm", 4, 2, 8), ("cauchy_bm", 4, 3, 8), ("cauchy_bm", 5, 3, 8),
    ("cauchy_bm", 6, 3, 8),
]


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def port(plan, rows_u32: np.ndarray) -> np.ndarray:
    return tensor_to_words(gf2.gf2_apply(plan, words_to_tensor(rows_u32,
                                                               "cpu")))


def jax_apply(plan, rows_u32: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(jgf2.gf2_apply)(jnp.asarray(plan),
                                              jnp.asarray(rows_u32)))


@pytest.mark.parametrize("tech,k,m,w", CODES)
def test_xor_plan_matches_jax(tech, k, m, w):
    """The encode matrix, its plan and the recovery plans of every
    two-erasure pattern equal the JAX package's."""
    mat = bm._bitmatrix(tech, k, m, w)
    np.testing.assert_array_equal(mat, jbm._bitmatrix(tech, k, m, w))
    plan = gf2.xor_plan(mat)
    np.testing.assert_array_equal(plan, jgf2.xor_plan(mat))
    assert plan.dtype == np.int32
    for erase in itertools.combinations(range(k + m), 2):
        present = tuple(i for i in range(k + m) if i not in erase)[:k]
        np.testing.assert_array_equal(
            bm._want_xor_plan(tech, k, m, w, present, erase),
            jbm._want_xor_plan(tech, k, m, w, present, erase))


def test_xor_plan_pads_short_and_empty_rows():
    mat = np.array([[1, 0, 1, 1], [0, 0, 0, 0], [0, 1, 0, 0]], np.uint8)
    plan = gf2.xor_plan(mat)
    np.testing.assert_array_equal(plan, [[0, 2, 3], [4, 4, 4], [1, 4, 4]])
    np.testing.assert_array_equal(plan, jgf2.xor_plan(mat))
    empty = np.zeros((2, 5), np.uint8)
    np.testing.assert_array_equal(gf2.xor_plan(empty), [[5], [5]])
    np.testing.assert_array_equal(gf2.xor_plan(empty), jgf2.xor_plan(empty))


#: name: (plan rows R, terms T, input rows C, leading shape, row length L)
EDGES = {
    "one_term": (6, 1, 5, (3,), 16),
    "all_pad_row": (4, 3, 6, (2,), 12),
    "odd_L": (5, 4, 7, (3,), 7),
    "L_one": (3, 2, 4, (2,), 1),
    "one_stripe": (8, 5, 9, (1,), 20),
    "extra_batch_dims": (4, 3, 6, (2, 3), 9),
    "no_batch_dims": (3, 3, 5, (), 11),
    "wide_T": (2, 24, 24, (2,), 8),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_gf2_apply_plain_matches_jax_at_the_edges(name):
    r, t, c, lead, length = EDGES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    plan = rng.integers(0, c + 1, (r, t), dtype=np.int32)
    if name == "all_pad_row":
        plan[1] = c  # a row made only of pads: zeros
    if name == "wide_T":
        plan[0] = np.arange(c)  # every input once
    rows = words(rng, lead + (c, length))
    got = port(plan, rows)
    assert got.shape == lead + (r, length)
    np.testing.assert_array_equal(got, jax_apply(plan, rows))
    np.testing.assert_array_equal(got, jgf2.gf2_apply_np(plan, rows))
    np.testing.assert_array_equal(got, gf2.gf2_apply_np(plan, rows))
    if name == "all_pad_row":
        assert not got[..., 1, :].any()


@pytest.mark.parametrize("tech,k,m,w", CODES[::2])
def test_gf2_encode_cells_matches_jax(tech, k, m, w):
    plan = gf2.xor_plan(bm._bitmatrix(tech, k, m, w))
    rng = np.random.default_rng(k * 100 + w)
    for lead, per_row in (((3,), 5), ((1,), 1), ((2, 2), 3)):
        cells = words(rng, lead + (k, w * per_row))
        got = tensor_to_words(gf2.gf2_encode_cells(
            plan, w, m, words_to_tensor(cells, "cpu")))
        want = np.asarray(jgf2.jit_gf2_apply(plan, w)(jnp.asarray(cells)))
        np.testing.assert_array_equal(got, want)
        # the host engine on the same cells as bytes
        u8 = cells.view(np.uint8).reshape(lead + (k, 4 * w * per_row))
        np.testing.assert_array_equal(
            got.view(np.uint8).reshape(lead + (m, -1)),
            gf2.gf2_encode_cells_np(plan, w, u8))


def test_gf2_encode_cells_is_a_view_split():
    """The cell -> packet-row split copies nothing: it reshapes."""
    plan = gf2.xor_plan(bm._bitmatrix("liberation", 4, 2, 5))
    x = words_to_tensor(words(np.random.default_rng(1), (2, 4, 10)), "cpu")
    seen = []
    real = gf2.gf2_apply

    def spy(p, rows):
        seen.append(rows)
        return real(p, rows)

    gf2.gf2_apply = spy
    try:
        gf2.gf2_encode_cells(plan, 5, 2, x)
    finally:
        gf2.gf2_apply = real
    assert seen[0].data_ptr() == x.data_ptr()
    assert tuple(seen[0].shape) == (2, 20, 2)
    with pytest.raises(ValueError):
        gf2.gf2_encode_cells(plan, 5, 2, x[..., :9])  # 9 words, w=5


@pytest.mark.parametrize("tech,k,m,w", [("liber8tion", 8, 2, 8),
                                         ("cauchy_bm", 4, 3, 8),
                                         ("blaum_roth", 6, 2, 6)])
def test_encode_with_crcs_matches_jax(tech, k, m, w):
    plan = gf2.xor_plan(bm._bitmatrix(tech, k, m, w))
    rng = np.random.default_rng(w * 7 + k)
    cells = words(rng, (3, k, w * 6))
    cell_bytes = 4 * w * 6
    parity, crcs = gf2.encode_with_crcs(plan, w, m, cell_bytes,
                                        words_to_tensor(cells, "cpu"))
    jparity, jcrcs = jgf2.jit_encode_with_crcs(plan, w, cell_bytes)(
        jnp.asarray(cells))
    np.testing.assert_array_equal(tensor_to_words(parity), np.asarray(jparity))
    np.testing.assert_array_equal(tensor_to_words(crcs), np.asarray(jcrcs))


def test_host_engine_copies_match_jax():
    rng = np.random.default_rng(5)
    plan = gf2.xor_plan(bm._bitmatrix("cauchy_bm", 4, 3, 8))
    rows = rng.integers(0, 256, (300, 32, 6), dtype=np.uint8)
    for fn in ("gf2_apply_np", "gf2_apply_np_blocked"):
        np.testing.assert_array_equal(getattr(gf2, fn)(plan, rows),
                                      getattr(jgf2, fn)(plan, rows))
    np.testing.assert_array_equal(
        gf2.gf2_apply_np_blocked(plan, rows, block=7),
        gf2.gf2_apply_np(plan, rows))
    cells = rng.integers(0, 256, (5, 4, 64), dtype=np.uint8)
    np.testing.assert_array_equal(gf2.gf2_encode_cells_np(plan, 8, cells),
                                  jgf2.gf2_encode_cells_np(plan, 8, cells))


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel wrapper; the wrapper takes
    CUDA tensors only."""
    def boom(*_a, **_k):
        raise AssertionError("the kernel wrapper was called for the CPU")

    monkeypatch.setattr(kernels, "gf2_xor", boom)
    plan = np.array([[0, 1], [2, 3]], np.int32)
    rows = words(np.random.default_rng(2), (2, 3, 4))
    np.testing.assert_array_equal(port(plan, rows), jax_apply(plan, rows))
    monkeypatch.undo()
    x = words_to_tensor(rows, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gf2_xor(x, torch.from_numpy(plan))


def test_bad_plans_and_rows_raise():
    rows = words_to_tensor(words(np.random.default_rng(3), (2, 3, 4)), "cpu")
    with pytest.raises(ValueError):
        gf2.gf2_apply(np.array([[0, 4]], np.int32), rows)  # 4 > C
    with pytest.raises(ValueError):
        gf2.gf2_apply(np.array([[-1, 0]], np.int32), rows)
    with pytest.raises(ValueError):
        gf2.gf2_apply(np.zeros((2, 0), np.int32), rows)  # T = 0
    with pytest.raises(TypeError):
        gf2.gf2_apply(np.array([[0]], np.int32), rows.to(torch.int64))
    with pytest.raises(ValueError):
        gf2.gf2_apply(np.array([[0]], np.int32), rows.to("meta"))
