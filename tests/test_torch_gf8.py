"""The port's host GF(2^8) math equals the JAX package's, bit for bit
(tolerance: exact equality, integer arithmetic)."""
import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf8 as jgf8
from ceph_tpu_torch.ops import gf8
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


def test_tables_and_scalar_ops():
    assert np.array_equal(gf8.mul_table(), jgf8.mul_table())
    for a in range(256):
        for b in (0, 1, 2, 0x1D, 0x80, 0xFF):
            assert gf8.gf_mul(a, b) == jgf8.gf_mul(a, b)
        if a:
            assert gf8.gf_inv(a) == jgf8.gf_inv(a)
        assert gf8.gf_pow(a, 7) == jgf8.gf_pow(a, 7)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (6, 3), (8, 3), (8, 4),
                                 (10, 4), (12, 4)])
@pytest.mark.parametrize("technique", ["vandermonde_rs_matrix",
                                       "cauchy_rs_matrix",
                                       "cauchy_good_matrix"])
def test_coding_matrices(technique, k, m):
    assert np.array_equal(getattr(gf8, technique)(k, m),
                          getattr(jgf8, technique)(k, m))


@pytest.mark.parametrize("k", [2, 4, 8, 10])
def test_raid6_and_parity_only(k):
    assert np.array_equal(gf8.raid6_matrix(k), jgf8.raid6_matrix(k))
    assert np.array_equal(gf8.parity_only_matrix(k),
                          jgf8.parity_only_matrix(k))


@pytest.mark.parametrize("technique", ["vandermonde_rs_matrix",
                                       "cauchy_rs_matrix",
                                       "cauchy_good_matrix"])
def test_decode_matrix_every_pattern_k4_m2(technique):
    import itertools

    gen = getattr(gf8, technique)(4, 2)
    for present in itertools.permutations(range(6), 4):
        want = jgf8.decode_matrix(gen, 4, list(present))
        assert np.array_equal(gf8.decode_matrix(gen, 4, list(present)), want)


def test_decode_matrix_k8_m3_and_errors():
    gen = gf8.vandermonde_rs_matrix(8, 3)
    rng = np.random.default_rng(3)
    for _ in range(20):
        present = list(rng.permutation(11)[:8])
        assert np.array_equal(gf8.decode_matrix(gen, 8, present),
                              jgf8.decode_matrix(gen, 8, present))
    with pytest.raises(ValueError):
        gf8.decode_matrix(gen, 8, [0, 1, 2])
    with pytest.raises(ValueError):
        gf8.decode_matrix(gen, 8, [0, 0, 1, 2, 3, 4, 5, 6])


def test_matmul_inverse_and_solve():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    b = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    assert np.array_equal(gf8.gf_matmul(a, b), jgf8.gf_matmul(a, b))
    sq = gf8.cauchy_rs_matrix(4, 4)
    assert np.array_equal(gf8.gf_mat_inv(sq), jgf8.gf_mat_inv(sq))
    rhs = rng.integers(0, 256, (4, 2), dtype=np.uint8)
    assert np.array_equal(gf8.gf_solve(sq, rhs), jgf8.gf_solve(sq, rhs))
