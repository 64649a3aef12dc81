"""The port's corpus generator (ceph_tpu_torch/tools/gen_ec_corpus.py)
against the JAX package's (tools/gen_ec_corpus.py) and the checked-in
golden corpus, on the CPU (the plain versions), and phase ``corpus`` of
``chip_smoke.py`` rehearsed on the CPU."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu_torch.tools import gen_ec_corpus as port
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "corpus" / "ec_corpus.json"


def _reference():
    spec = importlib.util.spec_from_file_location(
        "ref_gen_ec_corpus", ROOT / "tools" / "gen_ec_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_matrix_sizes_and_payload_are_the_reference_s():
    ref = _reference()
    assert port.MATRIX == ref.MATRIX
    assert port.SIZES == ref.SIZES
    for size in port.SIZES:
        assert port.payload(size) == ref.payload(size)
    assert [port.profile_key(p) for p in port.MATRIX] == [
        ref.profile_key(p) for p in ref.MATRIX]


@pytest.mark.parametrize("profile", port.MATRIX, ids=port.profile_key)
def test_encode_entry_equals_the_reference(profile):
    """Each config's chunk sizes and chunk hashes at the three object
    sizes, through the port's codec on the CPU and the JAX package's."""
    assert port.encode_entry(profile, device="cpu") == \
        _reference().encode_entry(profile)


def test_check_on_the_cpu_exits_0(capsys):
    assert port.main(["--check", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"corpus clean: {len(port.MATRIX)} configs x 3 sizes"
    per_config = lines[:-1]
    assert len(per_config) == len(port.MATRIX)
    for profile, line in zip(port.MATRIX, per_config):
        assert line.startswith(port.profile_key(profile) + ": pinned ok, ")
        if profile["plugin"] == "shec":
            assert line.endswith("backend=device n/a: shec runs on the host "
                                 "only")
        else:
            assert line.endswith("backend=device ok")


def test_check_prints_a_line_per_drifting_size(tmp_path, monkeypatch,
                                               capsys):
    """A corpus with one chunk hash changed fails the check, and the
    drift names the config, the arm and the size (both arms for a config
    that also runs with backend=device)."""
    want = json.loads(CORPUS.read_text())
    key = port.profile_key(port.MATRIX[2])
    want[key]["sizes"]["4096"]["chunks"][1] = "0" * 24
    bad = tmp_path / "ec_corpus.json"
    bad.write_text(json.dumps(want))
    monkeypatch.setattr(port, "CORPUS_PATH", bad)
    assert port.main(["--check", "--device", "cpu"]) == 1
    drift = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("DRIFT")]
    assert drift == [
        f"DRIFT pinned {key} size 4096: chunk_size 512 (pinned 512), "
        "chunks [1] differ",
        f"DRIFT backend=device {key} size 4096: chunk_size 512 (pinned "
        "512), chunks [1] differ"]


def test_write_equals_the_checked_in_corpus_byte_for_byte(tmp_path):
    out = tmp_path / "corpus" / "ec_corpus.json"
    assert port.main(["--out", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == CORPUS.read_bytes()


def test_writing_needs_out():
    with pytest.raises(SystemExit) as e:
        port.main(["--device", "cpu"])
    assert e.value.code == 2


def test_corpus_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.corpus_phase`` on ``device="cpu"``: the corpus with no
    drift in either arm and K1 launched, the probe's verdict with both
    engines' seconds and K1 and K2 launched, the lint with no unbaselined
    finding; then it asks for K1 and K2 at the probe's batch and K1 at the
    corpus's largest byte-API shape (the timing needs CUDA events, so
    ``time_ms``, ``profile_steps`` and ``batch_times`` are stubbed)."""
    import chip_smoke
    from test_torch_mds_twin import _count_launches

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _count_launches(monkeypatch)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: 1.0)
    monkeypatch.setattr(chip_smoke, "profile_steps", lambda fn, **kw: {
        **{k: None for k in chip_smoke.PROFILE_CLOCK}, "ms_per_step": {},
        "idle_share": None})
    timed = []

    def batch_times(dev, rng, codec, b, su, tag, cases):
        timed.append((tag, codec.k, codec.m, b, su, cases))
        return {f"{c}_{tag}": {"stripes": b} for c in cases}
    monkeypatch.setattr(chip_smoke, "batch_times", batch_times)
    out = chip_smoke.corpus_phase("cpu", np.random.default_rng(7),
                                  device="cpu")
    assert out["verdict"] in ("device", "host")
    assert set(out["probe"]) == {"probe_data_bytes", "device_s", "host_s",
                                 "device_mib_s", "host_mib_s"}
    assert out["probe"]["probe_data_bytes"] == 4 << 20
    assert out["by_part"]["corpus"]["gf_matmul"] > 0
    assert out["by_part"]["corpus"]["crc32c"] == 0  # no CRC in the byte API
    assert out["by_part"]["probe"]["gf_matmul"] == 3  # warm-up + 2 runs
    assert out["by_part"]["probe"]["crc32c"] == 3
    assert timed == [("probe", 8, 2, 64, 8192, ("write", "crc")),
                     ("corpus", 8, 4, 1, 8224, ("write",))]
    assert set(out["seconds"]) == {"corpus", "probe", "times", "lint",
                                   "total"}
