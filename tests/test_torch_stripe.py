"""The port's stripe layout (``ceph_tpu_torch.cluster.stripe``) against
``ceph_tpu.cluster.stripe``: stripe units, spans, the cell round trip,
per-cell CRCs and hinfo, and ``Overlay`` (ops, apply, covers/slice,
scatter) against both the JAX package's Overlay and a plain bytearray
shadow model, on the same seeded inputs. Tolerance: exact equality."""
import random

import numpy as np
import pytest
import torch

from ceph_tpu.cluster import stripe as jst
from ceph_tpu.ec import load_codec as jload_codec
from ceph_tpu_torch.cluster import stripe as st
from ceph_tpu_torch.ec import load_codec
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


@pytest.mark.parametrize("profile", [
    {"plugin": "rs_tpu", "k": "3", "m": "2"},
    {"plugin": "rs_tpu", "k": "8", "m": "3"},
    {"plugin": "rs_tpu", "k": "5", "m": "2",
     "jerasure-per-chunk-alignment": "true"},
    {"plugin": "isa", "k": "6", "m": "3"},
])
@pytest.mark.parametrize("requested", [1, 1000, 4096, 65536])
def test_effective_stripe_unit(profile, requested):
    codec = load_codec(profile, device="cpu")
    want = jst.effective_stripe_unit(jload_codec(dict(profile)), requested)
    su = st.effective_stripe_unit(codec, requested)
    assert su == want
    assert codec.get_chunk_size(codec.k * su) == su
    assert st.DEFAULT_STRIPE_UNIT == jst.DEFAULT_STRIPE_UNIT == 4096


def test_spans_and_sizes():
    rng = np.random.default_rng(5)
    for _ in range(200):
        k, m, su = (int(v) for v in rng.integers(1, 9, 3))
        su *= 4
        si, jsi = st.StripeInfo(k, m, su), jst.StripeInfo(k, m, su)
        assert si.width == jsi.width
        size = int(rng.integers(0, 20 * si.width))
        off = int(rng.integers(0, 20 * si.width))
        ln = int(rng.integers(-2, 5 * si.width))
        assert si.nstripes(size) == jsi.nstripes(size)
        assert si.shard_size(size) == jsi.shard_size(size)
        assert si.stripe_span(off, ln) == jsi.stripe_span(off, ln)


@pytest.mark.parametrize("k,su,length", [(2, 8, 40), (3, 4096, 30000),
                                         (8, 4096, 3 * 8 * 4096)])
def test_cells_round_trip_and_crcs(k, su, length):
    rng = np.random.default_rng(length)
    si, jsi = st.StripeInfo(k, 2, su), jst.StripeInfo(k, 2, su)
    data = rng.integers(0, 256, length, dtype=np.uint8)
    s1 = si.nstripes(length)
    cells = si.to_cells(data, 0, s1)
    assert np.array_equal(cells, jsi.to_cells(data, 0, s1))
    flat = si.from_cells(cells)
    assert np.array_equal(flat[:length], data) and not flat[length:].any()
    shard = np.ascontiguousarray(cells[:, 1, :]).reshape(-1)
    crcs = st.StripeInfo.cell_crcs(shard, su)
    assert crcs.dtype == np.uint32
    assert np.array_equal(crcs, jst.StripeInfo.cell_crcs(shard, su))
    assert si.crc_of_cell(cells[0, 0]) == jsi.crc_of_cell(cells[0, 0])


@pytest.mark.parametrize("su", [4, 512, 4096])
def test_hinfo_and_zero_cell(su):
    crcs = np.random.default_rng(su).integers(0, 2**32, 9, dtype=np.uint32)
    raw = st.enc_hinfo(crcs)
    assert raw == jst.enc_hinfo(crcs)
    assert np.array_equal(st.dec_hinfo(raw), crcs)
    assert st.dec_hinfo(raw).dtype == jst.dec_hinfo(raw).dtype
    assert st.zero_cell_crc(su) == jst.zero_cell_crc(su)
    assert st.zero_cell_crc(su) == st.StripeInfo(1, 0, su).crc_of_cell(
        np.zeros(su, np.uint8))


def _shadow(ops, old=b""):
    """Plain model: the same ops on a bytearray."""
    data = bytearray(old)
    for op, *args in ops:
        if op == "truncate":
            (size,) = args
            if size < len(data):
                del data[size:]
            else:
                data.extend(b"\0" * (size - len(data)))
            continue
        off, payload = args
        if op == "zero":
            payload = b"\0" * payload
        end = off + len(payload)
        if len(data) < end:
            data.extend(b"\0" * (end - len(data)))
        data[off:end] = payload
    return data


def _random_ops(rng, n, span):
    ops = []
    for _ in range(n):
        kind = rng.choice(["write", "zero", "truncate"])
        if kind == "write":
            ops.append(("write", int(rng.integers(0, span)),
                        rng.integers(0, 256, int(rng.integers(1, span // 6)),
                                     dtype=np.uint8).tobytes()))
        elif kind == "zero":
            ops.append(("zero", int(rng.integers(0, span)),
                        int(rng.integers(1, span // 6))))
        else:
            ops.append(("truncate", int(rng.integers(0, span + span // 8))))
    return ops


@pytest.mark.parametrize("seed", range(10))
def test_overlay_against_reference_and_shadow(seed):
    rng = np.random.default_rng(seed)
    old = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    ops = _random_ops(rng, 14, 4000)
    ov, jov = st.Overlay(len(old)), jst.Overlay(len(old))
    for op, *args in ops:
        getattr(ov, op)(*args)
        getattr(jov, op)(*args)
    want = bytes(_shadow(ops, old))
    assert bytes(ov.apply(old)) == want
    assert ov.size == jov.size == len(want)
    assert ov.extents() == jov.extents()
    assert ov.written_ranges() == jov.written_ranges()
    assert (ov.empty, ov.truncated) == (jov.empty, jov.truncated)
    for _ in range(20):
        a = int(rng.integers(0, ov.size + 1))
        b = int(rng.integers(a, ov.size + 1))
        assert ov.apply_range(a, b, old[a:]) == want[a:b]
        assert ov.apply_range(a, b, old[a:]) == jov.apply_range(a, b, old[a:])
        assert ov.covers(a, b - a) == jov.covers(a, b - a)
        if ov.covers(a, b - a):
            assert ov.slice(a, b - a) == want[a:b] == jov.slice(a, b - a)


def test_overlay_write_snapshots_mutable_payloads():
    payload = bytearray(b"abcd")
    ov = st.Overlay(0)
    ov.write(0, payload)
    payload[:] = b"zzzz"
    assert bytes(ov.apply(b"")) == b"abcd"
    assert st.Overlay(5).empty and not ov.empty


@pytest.mark.parametrize("seed", range(6))
def test_overlay_scatter_against_reference(seed):
    """scatter into shard-major staging rows equals the JAX package's
    scatter and the per-stripe apply_range oracle, over random op mixes
    with misaligned extents and partially covered stripes."""
    rng = random.Random(20261016 + seed)
    for _trial in range(25):
        k = rng.choice([2, 3, 8])
        su = rng.choice([4, 16, 64])
        si = st.StripeInfo(k, rng.choice([1, 2]), su)
        jsi = jst.StripeInfo(si.k, si.m, su)
        width = si.width
        old_size = rng.randrange(0, 6 * width)
        old = bytes(rng.randrange(1, 256) for _ in range(old_size))
        ov, jov = st.Overlay(old_size), jst.Overlay(old_size)
        for _ in range(rng.randrange(0, 6)):
            op = rng.choice(["write", "zero", "truncate"])
            off = rng.randrange(0, 8 * width)
            ln = rng.randrange(1, 3 * width)
            args = {"write": (off, bytes(rng.randrange(1, 256)
                                         for _ in range(ln))),
                    "zero": (off, ln),
                    "truncate": (rng.randrange(0, 8 * width),)}[op]
            getattr(ov, op)(*args)
            getattr(jov, op)(*args)
        nst = si.nstripes(ov.size)
        tlist = sorted({s for off, ln in ov.written_ranges()
                        for s in range(*si.stripe_span(off, ln)) if s < nst})
        # every touched stripe's old bytes, one run per stripe
        old_runs = [(s, old[s * width:(s + 1) * width]) for s in tlist
                    if s * width < old_size]
        dst = np.zeros((k, len(tlist), su), dtype=np.uint8)
        jdst = np.zeros_like(dst)
        got = ov.scatter(dst, tlist, si, old_runs)
        assert got == jov.scatter(jdst, tlist, jsi, old_runs)
        np.testing.assert_array_equal(dst, jdst)
        final = bytes(ov.apply(old))
        for i, s in enumerate(tlist):
            row = np.zeros(width, np.uint8)
            part = np.frombuffer(final[s * width:(s + 1) * width], np.uint8)
            row[:part.size] = part
            np.testing.assert_array_equal(dst[:, i, :], row.reshape(k, su))
