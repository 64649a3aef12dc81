"""The port's other codec families on the CPU: bitmatrix (blaum_roth,
liberation, liber8tion, cauchy_bm), Clay, LRC and SHEC.

Three kinds of case:
- the cases of ``test_bitmatrix.py``, ``test_clay.py`` and
  ``test_lrc_shec.py``, one for one, through the port's ``load_codec``
  with ``device="cpu"``;
- twins: one profile and the same seeded object through both packages'
  ``load_codec``, comparing ``encode``, ``decode``, ``minimum_to_decode``,
  ``minimum_to_decode_with_cost`` and, for Clay, the repair reads and
  bytes;
- the replay of the non-rs keys of ``tests/corpus/ec_corpus.json``, as
  ``test_corpus.py`` does, through the port.

Tolerance: exact equality (bytes)."""
import hashlib
import itertools
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec import load_codec as jload_codec
from ceph_tpu_torch.ec import ECError
from ceph_tpu_torch.ec import load_codec as _load_codec
from ceph_tpu_torch.ec.bitmatrix_plugin import (BitmatrixCodec, _bitmatrix,
                                                _recovery_plan)
from ceph_tpu_torch.ec.shec_plugin import _shec_matrix, _window
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)

CORPUS_PATH = os.path.join(os.path.dirname(__file__), "corpus",
                           "ec_corpus.json")
with open(CORPUS_PATH) as f:
    CORPUS = json.load(f)
OTHER_KEYS = [k for k in sorted(CORPUS)
              if CORPUS[k]["profile"].get("plugin") != "rs_tpu"]


def load_codec(profile):
    return _load_codec(profile, device="cpu")


# ------------------------------------------------------------ bitmatrix
# (test_bitmatrix.py)

BM_RNG = np.random.default_rng(99)


def roundtrip_all_patterns(codec, max_erasures=None):
    n = codec.get_chunk_count()
    m = max_erasures or codec.m
    size = codec.get_chunk_size(1) * codec.k
    obj = BM_RNG.integers(0, 256, size, dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(n)), obj)
    for r in range(1, m + 1):
        for erase in itertools.combinations(range(n), r):
            avail = {i: encoded[i] for i in range(n) if i not in erase}
            decoded = codec.decode(list(erase), avail)
            for i in erase:
                np.testing.assert_array_equal(
                    decoded[i], encoded[i],
                    err_msg=f"erase={erase} chunk={i}")
    return encoded


@pytest.mark.parametrize("k,w", [(3, 4), (4, 4), (4, 6), (6, 6)])
def test_blaum_roth_mds(k, w):
    roundtrip_all_patterns(load_codec({
        "plugin": "bitmatrix", "technique": "blaum_roth",
        "k": str(k), "m": "2", "w": str(w)}))


@pytest.mark.parametrize("k,w", [(3, 3), (4, 5), (5, 5), (7, 7)])
def test_liberation_mds(k, w):
    roundtrip_all_patterns(load_codec({
        "plugin": "bitmatrix", "technique": "liberation",
        "k": str(k), "m": "2", "w": str(w)}))


@pytest.mark.parametrize("k", [3, 5, 8])
def test_liber8tion_mds(k):
    roundtrip_all_patterns(load_codec({
        "plugin": "bitmatrix", "technique": "liber8tion",
        "k": str(k), "m": "2"}))


@pytest.mark.parametrize("k,m", [(4, 2), (5, 3)])
def test_cauchy_bitmatrix_mds(k, m):
    roundtrip_all_patterns(load_codec({
        "plugin": "bitmatrix", "technique": "cauchy_bm",
        "k": str(k), "m": str(m)}))


def test_every_pattern_invertible_exhaustive():
    for technique, k, m, w in [("blaum_roth", 6, 2, 6),
                               ("liberation", 7, 2, 7),
                               ("liber8tion", 8, 2, 8),
                               ("cauchy_bm", 6, 3, 8)]:
        for present in itertools.combinations(range(k + m), k):
            _recovery_plan(technique, k, m, w, present)  # raises if not


def test_jerasure_technique_dispatch():
    codec = load_codec({"plugin": "jerasure", "technique": "liberation",
                        "k": "4", "m": "2", "w": "5"})
    assert isinstance(codec, BitmatrixCodec)
    assert codec.device == torch.device("cpu")
    roundtrip_all_patterns(codec)
    codec2 = load_codec({"plugin": "jerasure", "technique": "blaum_roth",
                         "k": "4", "m": "2", "w": "4"})
    assert isinstance(codec2, BitmatrixCodec)
    # the profile the acceptance names, w at its default
    codec3 = load_codec({"plugin": "jerasure", "technique": "liberation",
                         "k": "4", "m": "2"})
    assert isinstance(codec3, BitmatrixCodec) and codec3.w == 7


def test_parameter_validation():
    with pytest.raises(ECError):
        _bitmatrix("liberation", 4, 2, 6)  # w not prime
    with pytest.raises(ECError):
        _bitmatrix("blaum_roth", 4, 2, 5)  # w+1 not prime
    with pytest.raises(ECError):
        _bitmatrix("liberation", 8, 2, 7)  # k > w
    with pytest.raises(ECError):
        _bitmatrix("blaum_roth", 4, 3, 6)  # m != 2
    with pytest.raises(ECError):
        _bitmatrix("liber8tion", 4, 2, 7)  # w != 8


def test_xor_only_parity_row():
    codec = load_codec({"plugin": "bitmatrix", "technique": "liberation",
                        "k": "4", "m": "2", "w": "5"})
    size = codec.get_chunk_size(1) * 4
    obj = BM_RNG.integers(0, 256, size, dtype=np.uint8).tobytes()
    enc = codec.encode(list(range(6)), obj)
    p = np.bitwise_xor.reduce([enc[i] for i in range(4)])
    np.testing.assert_array_equal(enc[4], p)


# ----------------------------------------------------------------- Clay
# (test_clay.py)

CLAY_RNG = np.random.default_rng(777)


def make_clay(k, m, d=None):
    prof = {"plugin": "clay", "k": str(k), "m": str(m)}
    if d is not None:
        prof["d"] = str(d)
    return load_codec(prof)


def test_clay_parameters():
    c = make_clay(4, 2)
    assert (c.q, c.t, c.nu) == (2, 3, 0)
    assert c.get_sub_chunk_count() == 8
    c2 = make_clay(8, 4)
    assert (c2.q, c2.t, c2.nu) == (4, 3, 0)
    assert c2.get_sub_chunk_count() == 64
    c3 = make_clay(3, 3, d=4)
    assert (c3.q, c3.t, c3.nu) == (2, 3, 0)
    c4 = make_clay(4, 3)
    assert (c4.q, c4.nu, c4.t) == (3, 2, 3)
    assert c4.get_sub_chunk_count() == 27
    assert c4.mds.device == torch.device("cpu")  # made on Clay's device
    with pytest.raises(ECError):
        make_clay(4, 2, d=7)


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (3, 2, 4), (2, 2, 3)])
def test_clay_roundtrip_all_patterns(k, m, d):
    codec = make_clay(k, m, d)
    n = k + m
    size = codec.get_chunk_size(1) * k
    obj = CLAY_RNG.integers(0, 256, size, dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(n)), obj)
    for r in range(1, m + 1):
        for erase in itertools.combinations(range(n), r):
            avail = {i: encoded[i] for i in range(n) if i not in erase}
            decoded = codec.decode(list(erase), avail)
            for i in erase:
                np.testing.assert_array_equal(
                    decoded[i], encoded[i],
                    err_msg=f"k={k} m={m} erase={erase} chunk {i}")


def test_clay_roundtrip_with_shortening():
    codec = make_clay(4, 3)
    obj = CLAY_RNG.integers(0, 256, codec.get_chunk_size(1) * 4,
                            dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(7)), obj)
    for erase in [(0,), (5,), (0, 6), (1, 2, 3)]:
        avail = {i: encoded[i] for i in range(7) if i not in erase}
        decoded = codec.decode(list(erase), avail)
        for i in erase:
            np.testing.assert_array_equal(decoded[i], encoded[i])


def test_clay_decode_concat_roundtrip():
    codec = make_clay(4, 2)
    obj = CLAY_RNG.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(6)), obj)
    got = codec.decode_concat({i: encoded[i] for i in [0, 2, 3, 4]})
    assert bytes(got[: len(obj)]) == obj


def test_clay_repair_subchunk_runs():
    codec = make_clay(4, 2)
    assert codec.get_repair_subchunks(0) == [(0, 4)]
    assert codec.get_repair_subchunks(1) == [(4, 4)]
    assert codec.get_repair_subchunks(2) == [(0, 2), (4, 2)]
    assert codec.get_repair_subchunks(5) == [(1, 1), (3, 1), (5, 1), (7, 1)]


def test_clay_minimum_to_decode_repair_case():
    codec = make_clay(4, 2)
    need = codec.minimum_to_decode([0], [1, 2, 3, 4, 5])
    assert len(need) == codec.d == 5
    runs = next(iter(need.values()))
    assert sum(c for _, c in runs) == codec.get_sub_chunk_count() // codec.q
    need2 = codec.minimum_to_decode([0, 1], [2, 3, 4, 5])
    assert all(v == [(0, 8)] for v in need2.values())


def helper_slices(codec, encoded, plan) -> dict:
    sub = len(encoded[0].tobytes()) // codec.get_sub_chunk_count()
    return {c: b"".join(encoded[c].tobytes()[o * sub:(o + n) * sub]
                        for o, n in runs)
            for c, runs in plan.items()}


@pytest.mark.parametrize("lost", [0, 1, 2, 3, 4, 5])
def test_clay_repair_single_loss_bit_exact(lost):
    codec = make_clay(4, 2)
    obj = CLAY_RNG.integers(0, 256, codec.get_chunk_size(1) * 4,
                            dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(6)), obj)
    avail = sorted(set(range(6)) - {lost})
    plan = codec.minimum_to_decode([lost], avail)
    assert lost not in plan and len(plan) == codec.d
    helper_bytes = helper_slices(codec, encoded, plan)
    assert all(len(b) == len(encoded[0].tobytes()) // codec.q
               for b in helper_bytes.values())
    repaired = codec.repair([lost], helper_bytes)
    np.testing.assert_array_equal(repaired[lost], encoded[lost],
                                  err_msg=f"lost={lost}")


def test_clay_repair_with_shortening():
    codec = make_clay(4, 3)
    obj = CLAY_RNG.integers(0, 256, codec.get_chunk_size(1) * 4,
                            dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(7)), obj)
    for lost in (0, 3, 6):
        avail = sorted(set(range(7)) - {lost})
        plan = codec.minimum_to_decode([lost], avail)
        if lost not in plan and len(plan) == codec.d:
            repaired = codec.repair([lost], helper_slices(codec, encoded,
                                                          plan))
            np.testing.assert_array_equal(repaired[lost], encoded[lost])


def test_clay_repair_bandwidth_beats_mds():
    codec = make_clay(8, 4)
    assert codec.d / codec.q < codec.k
    assert codec.d / codec.q == 2.75


def test_clay_decode_dispatches_to_repair_via_chunk_size():
    codec = make_clay(4, 2)
    chunk_size = codec.get_chunk_size(4096)
    obj = CLAY_RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(6)), obj)
    lost = 2
    plan = codec.minimum_to_decode([lost], sorted(set(range(6)) - {lost}))
    out = codec.decode([lost], helper_slices(codec, encoded, plan),
                       chunk_size=chunk_size)
    np.testing.assert_array_equal(out[lost], encoded[lost])


# ---------------------------------------------------------- LRC + SHEC
# (test_lrc_shec.py)

LS_RNG = np.random.default_rng(123)


def roundtrip(codec, obj: bytes, erase: set[int]) -> None:
    n = codec.get_chunk_count()
    encoded = codec.encode(list(range(n)), obj)
    assert set(encoded) == set(range(n))
    avail = {i: encoded[i] for i in range(n) if i not in erase}
    want = sorted(erase) or list(range(n))
    need = codec.minimum_to_decode(want, sorted(avail))
    assert set(need) <= set(avail), "plan demands an erased chunk"
    decoded = codec.decode(want, {i: avail[i] for i in need})
    for i in want:
        np.testing.assert_array_equal(decoded[i], encoded[i],
                                      err_msg=f"chunk {i}, erase {erase}")


LRC_DOCS = {"plugin": "lrc", "mapping": "__DD__DD",
            "layers": '[["_cDD_cDD", ""], ["cDDD____", ""], ["____cDDD", ""]]'}


def test_lrc_docs_example_roundtrip():
    codec = load_codec(LRC_DOCS)
    assert codec.k == 4 and codec.get_chunk_count() == 8
    assert all(layer.codec.device == torch.device("cpu")
               for layer in codec.layers)  # inner codecs on LRC's device
    obj = LS_RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    for erase in ([set()] + [{i} for i in range(8)]
                  + [{2, 7}, {0, 4}, {1, 5}, {3, 6}]):
        roundtrip(codec, obj, erase)


def test_lrc_local_repair_reads_fewer():
    codec = load_codec(LRC_DOCS)
    assert set(codec.minimum_to_decode([7], [0, 1, 2, 3, 4, 5, 6])) <= {4, 5, 6}
    assert set(codec.minimum_to_decode([2], [0, 1, 3, 4, 5, 6, 7])) <= {0, 1, 3}


def test_lrc_kml_generation():
    codec = load_codec({"plugin": "lrc", "k": "4", "m": "2", "l": "3"})
    assert codec.k == 4 and codec.get_chunk_count() == 8
    assert codec.profile["mapping"] == "DD__DD__"
    obj = LS_RNG.integers(0, 256, 8192, dtype=np.uint8).tobytes()
    for erase in [set(), {0}, {3}, {6}, {0, 4}, {2, 5}]:
        roundtrip(codec, obj, erase)
    need = codec.minimum_to_decode([0], list(range(1, 8)))
    assert len(need) == 3 and set(need) <= {1, 2, 3}


def test_lrc_kml_validation():
    with pytest.raises(ECError):
        load_codec({"plugin": "lrc", "k": "4", "m": "2", "l": "5"})
    with pytest.raises(ECError):
        load_codec({"plugin": "lrc", "k": "4", "m": "2"})
    with pytest.raises(ECError):
        load_codec({"plugin": "lrc", "k": "2", "m": "1", "l": "3",
                    "mapping": "DD_"})


def test_lrc_unrecoverable():
    with pytest.raises(ECError):
        load_codec(LRC_DOCS).minimum_to_decode([2], [0, 4, 5])


def test_lrc_layered_chain_repair():
    obj = LS_RNG.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    roundtrip(load_codec(LRC_DOCS), obj, {0, 2})


def test_shec_window_semantics():
    assert _window(0, 6, 3, 2) == {0, 1, 2, 3}
    assert _window(1, 6, 3, 2) == {2, 3, 4, 5}
    assert _window(2, 6, 3, 2) == {4, 5, 0, 1}


def test_shec_matrix_windows_zeroed():
    mat = _shec_matrix(6, 3, 2, True)
    for r in range(3):
        cover = _window(r, 6, 3, 2)
        for j in range(6):
            assert (mat[r, j] != 0) == (j in cover)


@pytest.mark.parametrize("technique", ["single", "multiple"])
def test_shec_roundtrip_single_erasures(technique):
    codec = load_codec({"plugin": "shec", "k": "6", "m": "3", "c": "2",
                        "technique": technique})
    obj = LS_RNG.integers(0, 256, 6 * 512, dtype=np.uint8).tobytes()
    for i in range(9):
        roundtrip(codec, obj, {i})


def test_shec_roundtrip_c_erasures():
    codec = load_codec({"plugin": "shec", "k": "4", "m": "3", "c": "2"})
    obj = LS_RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    for erase in itertools.combinations(range(7), 2):
        roundtrip(codec, obj, set(erase))


def test_shec_local_repair_reads_fewer_than_k():
    codec = load_codec({"plugin": "shec", "k": "6", "m": "3", "c": "2",
                        "technique": "single"})
    need = codec.minimum_to_decode([0], [1, 2, 3, 4, 5, 6, 7, 8])
    assert len(need) <= 4 and 0 not in need


def test_shec_defaults():
    codec = load_codec({"plugin": "shec"})
    assert (codec.k, codec.m, codec.c) == (4, 3, 2)
    obj = b"shec-default" * 300
    roundtrip(codec, obj, {1})
    roundtrip(codec, obj, {5})


# ---------------------------------------------------------------- twins

TWIN_PROFILES = [
    {"plugin": "jerasure", "technique": "liberation", "k": "4", "m": "2"},
    {"plugin": "jerasure", "technique": "liber8tion", "k": "8", "m": "2"},
    {"plugin": "jerasure", "technique": "blaum_roth", "k": "6", "m": "2"},
    {"plugin": "bitmatrix", "technique": "cauchy_bm", "k": "5", "m": "3"},
    {"plugin": "bitmatrix", "technique": "liberation", "k": "4", "m": "2",
     "mapping": "_DD_DD"},
    {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
    {"plugin": "clay", "k": "4", "m": "3"},
    {"plugin": "clay", "k": "3", "m": "2", "d": "3"},
    {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    LRC_DOCS,
    {"plugin": "shec", "k": "6", "m": "3", "c": "2", "technique": "single"},
    {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
]


def profile_id(p):
    return "&".join(f"{k}={v}" for k, v in sorted(p.items())
                    if k != "layers")


@pytest.mark.parametrize("profile", TWIN_PROFILES, ids=profile_id)
def test_twin_matches_jax(profile):
    """Encode, decode and read plans of one profile and one object equal
    the JAX package's."""
    codec, jcodec = load_codec(profile), jload_codec(profile)
    assert codec.get_profile() == jcodec.get_profile()
    assert codec.get_chunk_mapping() == jcodec.get_chunk_mapping()
    n = codec.get_chunk_count()
    assert n == jcodec.get_chunk_count()
    assert codec.get_sub_chunk_count() == jcodec.get_sub_chunk_count()
    rng = np.random.default_rng(n * 31 + codec.k)
    obj = rng.integers(0, 256, 3 * codec.get_chunk_size(1) * codec.k + 11,
                       dtype=np.uint8).tobytes()
    assert codec.get_chunk_size(len(obj)) == jcodec.get_chunk_size(len(obj))
    enc = codec.encode(range(n), obj)
    jenc = jcodec.encode(range(n), obj)
    assert sorted(enc) == sorted(jenc)
    for i in enc:
        np.testing.assert_array_equal(enc[i], jenc[i], err_msg=str(i))
    m = codec.get_coding_chunk_count()
    for r in range(1, min(m, 2) + 1):
        for erase in itertools.combinations(range(n), r):
            avail = sorted(set(range(n)) - set(erase))
            try:
                jneed = jcodec.minimum_to_decode(list(erase), avail)
            except Exception as e:  # the JAX codec cannot decode it
                with pytest.raises(type(e)):
                    codec.minimum_to_decode(list(erase), avail)
                continue
            assert codec.minimum_to_decode(list(erase), avail) == jneed
            cost = {c: (c * 7) % 5 for c in avail}
            assert (codec.minimum_to_decode_with_cost(list(erase), cost)
                    == jcodec.minimum_to_decode_with_cost(list(erase), cost))
            have = {i: enc[i] for i in avail}
            dec = codec.decode(list(erase), have)
            jdec = jcodec.decode(list(erase), have)
            assert sorted(dec) == sorted(jdec)
            for i in dec:
                np.testing.assert_array_equal(dec[i], jdec[i])
                np.testing.assert_array_equal(dec[i], enc[i])


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (4, 3, 6), (3, 2, 4)])
def test_twin_clay_repair_bytes_match_jax(k, m, d):
    """Every single-loss repair: the same helpers, sub-chunk runs and
    helper bytes as the JAX package, the same rebuilt chunk, and the
    helper bytes a d/q fraction of what an RS decode reads (k chunks)."""
    prof = {"plugin": "clay", "k": str(k), "m": str(m), "d": str(d)}
    codec, jcodec = load_codec(prof), jload_codec(prof)
    n = k + m
    obj = np.random.default_rng(k + m + d).integers(
        0, 256, 2 * codec.get_chunk_size(1) * k, dtype=np.uint8).tobytes()
    enc = codec.encode(range(n), obj)
    chunk = len(enc[0])
    for lost in range(n):
        avail = sorted(set(range(n)) - {lost})
        plan = codec.minimum_to_decode([lost], avail)
        assert plan == jcodec.minimum_to_decode([lost], avail)
        if not codec.is_repair({lost}, set(avail)):
            continue
        helpers = helper_slices(codec, enc, plan)
        helper_bytes = sum(len(b) for b in helpers.values())
        assert helper_bytes == d * chunk // codec.q
        assert helper_bytes < k * chunk
        got = codec.repair([lost], helpers)[lost]
        np.testing.assert_array_equal(got, jcodec.repair([lost],
                                                         helpers)[lost])
        np.testing.assert_array_equal(got, enc[lost])


# --------------------------------------------------------------- corpus


def payload(size: int) -> bytes:
    return np.random.default_rng(0xEC0DE + size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def test_corpus_has_the_other_families():
    plugins = sorted({CORPUS[k]["profile"]["plugin"] for k in OTHER_KEYS})
    assert plugins == ["clay", "lrc", "shec"]
    assert len(OTHER_KEYS) == 7


@pytest.mark.parametrize("key", OTHER_KEYS)
def test_corpus_other_families(key):
    """The same replay as tests/test_corpus.py, through the port."""
    entry = CORPUS[key]
    codec = load_codec(dict(entry["profile"]))
    n = entry["n"]
    assert codec.get_chunk_count() == n
    for size_s, pinned in entry["sizes"].items():
        size = int(size_s)
        assert codec.get_chunk_size(size) == pinned["chunk_size"]
        encoded = codec.encode(list(range(n)), payload(size))
        got = [hashlib.sha256(encoded[i].tobytes()).hexdigest()[:24]
               for i in range(n)]
        assert got == pinned["chunks"], f"ENCODING DRIFT: {key} {size}"
