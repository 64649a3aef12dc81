"""The port's Checksummer against ``ceph_tpu.checksum.Checksummer``: both
values of ``device`` on ``calculate`` and ``verify`` (the C++ core, and
the batched CRC path on the Checksummer's device, here the plain version
on the CPU) against both of the reference's paths, for every algorithm;
the device is resolved at the first ``device=True`` call, so a host-only
Checksummer (and a store that checksums on the host) needs no card.
Tolerance: exact equality (integer checksums)."""
import numpy as np
import pytest
import torch

from ceph_tpu.checksum import Checksummer as JChecksummer
from ceph_tpu_torch.checksum import ALGORITHMS, Checksummer, csum_value_size
from ceph_tpu_torch.ops import crc32c as crc_ops
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)


@pytest.mark.parametrize("alg", ["crc32c", "crc32c_16", "crc32c_8"])
@pytest.mark.parametrize("block", [512, 4096, 65536])
def test_calculate_matches_jax(alg, block):
    rng = np.random.default_rng(block)
    data = rng.integers(0, 256, block * 6, dtype=np.uint8)
    cs = Checksummer(alg, block, device="cpu")
    ref = JChecksummer(alg, block)
    host = ref.calculate(data)
    dev = ref.calculate(data, device=True)
    for device in (False, True):
        got = cs.calculate(data, device=device)
        assert got.dtype == host.dtype and got.shape == (6,)
        assert np.array_equal(got, host)
        assert np.array_equal(got, dev)
    assert csum_value_size(alg) == host.dtype.itemsize


@pytest.mark.parametrize("alg", ALGORITHMS)
@pytest.mark.parametrize("device", [False, True])
def test_every_algorithm_both_engines_match_jax(alg, device):
    """Each algorithm on the engine ``device`` picks, against the
    reference on the same keyword (xxhash and none ignore it in both)."""
    data = np.random.default_rng(11).integers(0, 256, 1024 * 7,
                                              dtype=np.uint8)
    calls = []
    batch = crc_ops.crc32c_batch

    def counted(*a, **k):
        calls.append(k["device"])
        return batch(*a, **k)

    cs = Checksummer(alg, 1024, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(crc_ops, "crc32c_batch", counted)
        got = cs.calculate(data, device=device)
    want = JChecksummer(alg, 1024).calculate(data, device=device)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # only device=True on the crc32c family takes the batched CRC path
    assert len(calls) == (device and alg.startswith("crc32c"))
    assert cs.verify(data, got, device=device) == (-1, None)


def test_init_value_and_bytes_input():
    data = bytes(range(256)) * 64
    for init in (0, 0x1234, None):
        cs = Checksummer("crc32c", 1024, init_value=init, device="cpu")
        want = JChecksummer("crc32c", 1024, init_value=init).calculate(data)
        assert np.array_equal(cs.calculate(data), want)
        assert np.array_equal(cs.calculate(data, device=True), want)


@pytest.mark.parametrize("device", [False, True])
def test_verify_contract(device):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 4096 * 5, dtype=np.uint8)
    cs = Checksummer("crc32c", 4096, device="cpu")
    jcs = JChecksummer("crc32c", 4096)
    csums = cs.calculate(data, device=device)
    assert (cs.verify(data, csums, device=device) == (-1, None)
            == jcs.verify(data, csums, device=device))
    bad = data.copy()
    bad[4096 * 3 + 17] ^= 0x40
    off, val = cs.verify(bad, csums, device=device)
    for jdev in (False, True):
        joff, jval = jcs.verify(bad, csums, device=jdev)
        assert (off, val) == (joff, jval) and off == 4096 * 3
    with pytest.raises(ValueError):
        cs.verify(data, csums[:2], device=device)


def test_none_unaligned_and_unported():
    cs = Checksummer("none", 4096, device="cpu")
    assert cs.calculate(b"x" * 4096).size == 0
    assert cs.calculate(b"x" * 4096, device=True).size == 0
    for device in (False, True):
        with pytest.raises(ValueError):
            Checksummer("crc32c", 4096, device="cpu").calculate(
                b"x" * 100, device=device)
    with pytest.raises(ValueError):
        Checksummer("crc32c", 1000, device="cpu")
    with pytest.raises(ValueError):
        Checksummer("md5", 4096, device="cpu")
    for alg in ("xxhash32", "xxhash64"):  # ported: the C++ host core
        data = b"x" * 4096 * 3
        got = Checksummer(alg, 4096, device="cpu").calculate(data)
        assert np.array_equal(got, JChecksummer(alg, 4096).calculate(data))


@pytest.mark.parametrize("alg", ["xxhash32", "xxhash64"])
@pytest.mark.parametrize("init", [None, 0, 0x1234])
def test_xxhash_matches_jax(alg, init):
    data = np.random.default_rng(7).integers(0, 256, 512 * 5, dtype=np.uint8)
    cs = Checksummer(alg, 512, init_value=init, device="cpu")
    want = JChecksummer(alg, 512, init_value=init).calculate(data)
    got = cs.calculate(data)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(cs.calculate(data, device=True), want)
    assert csum_value_size(alg) == got.dtype.itemsize
    assert cs.verify(data, got) == (-1, None)
    bad = data.copy()
    bad[512 * 2] ^= 1
    assert cs.verify(bad, got)[0] == 1024


def test_host_checksummer_needs_no_card(monkeypatch):
    """With no device named and no card, a Checksummer is built and
    computes on the host; the first device=True call raises, and so does
    every later one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.random.default_rng(5).integers(0, 256, 4096 * 3,
                                             dtype=np.uint8)
    cs = Checksummer()
    want = JChecksummer().calculate(data)
    assert np.array_equal(cs.calculate(data), want)
    assert cs.verify(data, want) == (-1, None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="CUDA"):
            cs.calculate(data, device=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            cs.verify(data, want, device=True)
    assert cs.device is None


def test_device_resolved_at_first_device_call(monkeypatch):
    cs = Checksummer(device="cpu")
    assert cs.device == "cpu"  # as given: nothing resolved yet
    cs.calculate(np.zeros(4096, np.uint8), device=True)
    assert cs.device == torch.device("cpu")
    assert cs.torch_device() is cs.device


def test_stores_on_the_host_need_no_card(tmp_path, monkeypatch):
    """Both durable stores build their Checksummer with no device, as the
    reference's do: on a box with no card they run on the C++ core, and
    only device_csum=True asks for the card (and raises)."""
    from ceph_tpu_torch.store import create
    from ceph_tpu_torch.store import transaction as tx

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = tx.Transaction().create_collection("c").write("c", b"o", 0,
                                                      b"q" * 9000)
    for kind in ("walstore", "bluestore"):
        s = create(kind, str(tmp_path / kind))
        s.apply_transaction(t)
        assert s.read("c", b"o") == b"q" * 9000
        s.umount()
        s = create(kind, str(tmp_path / f"{kind}-dev"), device_csum=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            s.apply_transaction(t)
            s.umount()  # WalStore checksums at its checkpoint
