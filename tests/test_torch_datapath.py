"""The port's write/repair steps against the JAX datapath on the same
example batch, with the coding matrix and stripe data handed over through
``ceph_tpu_torch.convert``. Tolerance: exact equality (integers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.models import datapath as jdp
from ceph_tpu_torch import convert
from ceph_tpu_torch.models import datapath
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


@pytest.fixture(params=["reed_sol_van", "cauchy"])
def pair(request):
    jparams = jdp.ECParams(k=8, m=3, chunk_bytes=4096,
                           technique=request.param)
    params = convert.params_from_reference(8, 3, 4096, request.param,
                                           jparams.matrix)
    return jparams, params


def test_example_batch_is_the_reference_batch(pair):
    jparams, params = pair
    want = np.asarray(jdp.example_batch(jparams, batch=4, seed=0))
    got = datapath.example_batch(params, batch=4, seed=0, device="cpu")
    assert np.array_equal(convert.batch_to_numpy(got), want)


def test_write_step_matches_jax(pair):
    jparams, params = pair
    raw = np.asarray(jdp.example_batch(jparams, batch=4, seed=0))
    jparity, jcrcs = jdp.write_step(jparams, jnp.asarray(raw))
    parity, crcs = datapath.write_step(params,
                                       convert.batch_to_device(raw, "cpu"))
    assert parity.shape == (4, 3, 1024) and crcs.shape == (4, 11)
    assert np.array_equal(convert.batch_to_numpy(parity), np.asarray(jparity))
    assert np.array_equal(convert.batch_to_numpy(crcs), np.asarray(jcrcs))


@pytest.mark.parametrize("present", [(0, 2, 3, 4, 5, 7, 8, 9),
                                     (10, 9, 8, 0, 1, 2, 3, 4)])
def test_repair_step_matches_jax(pair, present):
    jparams, params = pair
    raw = np.asarray(jdp.example_batch(jparams, batch=4, seed=1))
    jparity, _ = jdp.write_step(jparams, jnp.asarray(raw))
    surv = np.concatenate([raw, np.asarray(jparity)], axis=1)[:, list(present)]
    jdata, jcrcs = jdp.repair_step(jparams, present, jnp.asarray(surv))
    data, crcs = datapath.repair_step(params, present,
                                      convert.batch_to_device(surv, "cpu"))
    assert np.array_equal(convert.batch_to_numpy(data), raw)
    assert np.array_equal(convert.batch_to_numpy(data), np.asarray(jdata))
    assert np.array_equal(convert.batch_to_numpy(crcs), np.asarray(jcrcs))


def test_params_from_reference_rejects_a_foreign_matrix():
    jparams = jdp.ECParams(k=4, m=2, chunk_bytes=4096)
    bad = jparams.matrix.copy()
    bad[0, 0] ^= 1
    with pytest.raises(ValueError, match="differs"):
        convert.params_from_reference(4, 2, 4096, "reed_sol_van", bad)
    with pytest.raises(ValueError, match="differs"):
        convert.params_from_reference(4, 2, 4096, "reed_sol_van",
                                      jparams.matrix[:1])
    with pytest.raises(TypeError):
        convert.batch_to_device(np.zeros(4, np.int64), "cpu")
