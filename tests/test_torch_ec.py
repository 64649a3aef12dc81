"""The port's rs_tpu / isa codecs on the CPU: every rs_tpu entry of the
golden corpus reproduces its pinned hashes, and the byte and batched APIs
equal the JAX codec's outputs. Tolerance: exact equality (bytes)."""
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import load_codec as jload_codec
from ceph_tpu_torch.convert import batch_to_device, batch_to_numpy
from ceph_tpu_torch.ec import ECError, load_codec
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)

CORPUS_PATH = os.path.join(os.path.dirname(__file__), "corpus",
                           "ec_corpus.json")
with open(CORPUS_PATH) as f:
    CORPUS = json.load(f)
RS_KEYS = [k for k in sorted(CORPUS)
           if CORPUS[k]["profile"].get("plugin") == "rs_tpu"]


def payload(size: int) -> bytes:
    return np.random.default_rng(0xEC0DE + size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("key", RS_KEYS)
def test_corpus_rs_tpu(key):
    """The same replay as tests/test_corpus.py, through the port."""
    entry = CORPUS[key]
    profile = dict(entry["profile"])
    profile["backend"] = "device"
    codec = load_codec(profile, device="cpu")
    n = entry["n"]
    assert codec.get_chunk_count() == n
    for size_s, pinned in entry["sizes"].items():
        size = int(size_s)
        assert codec.get_chunk_size(size) == pinned["chunk_size"]
        encoded = codec.encode(list(range(n)), payload(size))
        got = [hashlib.sha256(encoded[i].tobytes()).hexdigest()[:24]
               for i in range(n)]
        assert got == pinned["chunks"], f"ENCODING DRIFT: {profile} {size}"


PROFILES = [
    {"plugin": "rs_tpu", "k": "8", "m": "3"},
    {"plugin": "rs_tpu", "k": "4", "m": "2", "technique": "cauchy_good"},
    {"plugin": "jerasure", "k": "5", "m": "2", "technique": "reed_sol_r6_op"},
    {"plugin": "rs_tpu", "k": "4", "m": "2", "mapping": "_DD_DD"},
    {"plugin": "rs_tpu", "k": "3", "m": "2",
     "jerasure-per-chunk-alignment": "true"},
    {"plugin": "isa", "k": "6", "m": "3", "technique": "cauchy"},
    {"plugin": "isa_tpu", "k": "7", "m": "3"},
]


@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: "&".join(
    f"{k}={v}" for k, v in sorted(p.items())))
def test_byte_api_matches_jax(profile):
    codec = load_codec(profile, device="cpu")
    jcodec = jload_codec(profile)
    assert codec.get_profile() == jcodec.get_profile()
    assert codec.get_chunk_mapping() == jcodec.get_chunk_mapping()
    n = codec.get_chunk_count()
    rng = np.random.default_rng(n)
    obj = rng.integers(0, 256, 10007, dtype=np.uint8).tobytes()
    enc = codec.encode(range(n), obj)
    jenc = jcodec.encode(range(n), obj)
    assert sorted(enc) == sorted(jenc)
    for i in enc:
        assert np.array_equal(enc[i], jenc[i]), i
    lost = list(rng.permutation(n)[:codec.m])
    have = {i: c for i, c in enc.items() if i not in lost}
    dec = codec.decode(range(n), have)
    jdec = jcodec.decode(range(n), have)
    for i in range(n):
        assert np.array_equal(dec[i], jdec[i]), i
        assert np.array_equal(dec[i], enc[i]), i
    assert np.array_equal(codec.decode_concat(have),
                          jcodec.decode_concat(have))
    assert (codec.minimum_to_decode(lost, have)
            == jcodec.minimum_to_decode(lost, have))


def test_decode_chunks_with_unaligned_length():
    codec = load_codec({"plugin": "rs_tpu", "k": "4", "m": "2"}, device="cpu")
    jcodec = jload_codec({"plugin": "rs_tpu", "k": "4", "m": "2"})
    data = np.random.default_rng(5).integers(0, 256, (4, 13), dtype=np.uint8)
    assert np.array_equal(codec.encode_chunks(data), jcodec.encode_chunks(data))
    full = np.concatenate([data, codec.encode_chunks(data)])
    present = [1, 3, 4, 5]
    got = codec.decode_chunks(present, full[present])
    want = jcodec.decode_chunks(present, full[present])
    assert sorted(got) == sorted(want)
    for i in got:
        assert np.array_equal(got[i], want[i])


def test_batched_api_matches_jax():
    profile = {"plugin": "rs_tpu", "k": "8", "m": "3"}
    codec = load_codec(profile, device="cpu")
    jcodec = jload_codec(profile)
    rng = np.random.default_rng(21)
    data = rng.integers(0, 2**32, (3, 8, 256), dtype=np.uint32)
    parity = codec.encode_batch(data)
    assert np.array_equal(batch_to_numpy(parity),
                          np.asarray(jcodec.encode_batch(jnp.asarray(data))))
    p2, crcs = codec.encode_crc_batch(batch_to_device(data, "cpu"), 1024)
    jp, jcrcs = jcodec.encode_crc_batch(jnp.asarray(data), 1024)
    assert np.array_equal(batch_to_numpy(p2), np.asarray(jp))
    assert np.array_equal(batch_to_numpy(crcs), np.asarray(jcrcs))
    full = np.concatenate([data, batch_to_numpy(parity)], axis=1)
    present = (0, 2, 3, 4, 5, 6, 7, 8)
    surv = full[:, list(present)]
    for want in (None, (1, 9), (9, 1, 10)):
        got = codec.decode_batch(present, batch_to_device(surv, "cpu"), want)
        ref = jcodec.decode_batch(present, jnp.asarray(surv), want)
        assert np.array_equal(batch_to_numpy(got), np.asarray(ref)), want
        rows = range(8) if want is None else want
        assert np.array_equal(batch_to_numpy(got), full[:, list(rows)])
    assert np.array_equal(codec.decode_matrix_for(present, (1, 9)),
                          jcodec.decode_matrix_for(present, (1, 9)))


@pytest.mark.parametrize("profile,match", [
    # the bit-matrix techniques hand over to the bitmatrix codec, which
    # refuses the geometries its constructions do not cover
    ({"plugin": "rs_tpu", "technique": "liber8tion", "m": "3"}, "RAID6"),
    ({"plugin": "rs_tpu", "technique": "liberation", "w": "6"}, "prime w"),
    ({"plugin": "rs_tpu", "technique": "blaum_roth", "w": "5"}, "w\\+1 prime"),
    ({"plugin": "rs_tpu", "technique": "nope"}, "not supported"),
    ({"plugin": "rs_tpu", "k": "200", "m": "60"}, "k\\+m"),
    ({"plugin": "rs_tpu", "w": "16"}, "w=8"),
    ({"plugin": "isa", "technique": "reed_sol_r6_op"}, "isa technique"),
    ({"plugin": "rs_tpu", "backend": "tpu"}, "device\\|host\\|auto"),
])
def test_profiles_refused(profile, match):
    with pytest.raises(ECError, match=match):
        load_codec(profile, device="cpu")


def test_unknown_plugin_and_registry_names():
    from ceph_tpu_torch.ec import instance

    assert {"rs_tpu", "jerasure", "isa", "isa_tpu", "bitmatrix", "clay",
            "lrc", "shec"} <= set(instance().names())
    with pytest.raises(KeyError):
        load_codec({"plugin": "nope"}, device="cpu")
