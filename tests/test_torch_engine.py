"""The port's EC engine probe (ceph_tpu_torch/ec/engine.py) and the four
codecs that resolve ``backend=auto`` through it, on the CPU."""
import pytest
import torch

from ceph_tpu_torch.ec import engine, load_codec
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)

#: rs_tpu and lrc default to "auto", bitmatrix and clay to "device" (as
#: in the JAX package), so each names it
AUTO_PROFILES = {
    "rs_tpu": {"plugin": "rs_tpu", "k": "4", "m": "2", "backend": "auto"},
    "bitmatrix": {"plugin": "jerasure", "technique": "liberation",
                  "k": "4", "m": "2", "backend": "auto"},
    "clay": {"plugin": "clay", "k": "4", "m": "2", "backend": "auto"},
    "lrc": {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
            "backend": "auto"},
}


@pytest.fixture(autouse=True)
def fresh_probe(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_EC_ENGINE", raising=False)
    engine.reset_probe()
    engine.last_probe.clear()
    yield
    engine.reset_probe()
    engine.last_probe.clear()


def _no_probe(monkeypatch):
    def probe(device=None):
        raise AssertionError("the probe ran")
    monkeypatch.setattr(engine, "_probe", probe)


@pytest.mark.parametrize("forced", ["device", "host"])
def test_env_override_skips_the_probe_and_reset_drops_the_cache(
        monkeypatch, forced):
    _no_probe(monkeypatch)
    monkeypatch.setenv("CEPH_TPU_EC_ENGINE", forced)
    assert engine.data_path_engine() == forced
    assert engine.last_probe == {}
    other = "host" if forced == "device" else "device"
    monkeypatch.setenv("CEPH_TPU_EC_ENGINE", other)
    assert engine.data_path_engine() == forced  # cached once a process
    engine.reset_probe()
    assert engine.data_path_engine() == other


def test_probe_runs_once_and_is_cached(monkeypatch):
    calls = []

    def probe(device=None):
        calls.append(device)
        return "host"
    monkeypatch.setattr(engine, "_probe", probe)
    assert engine.data_path_engine("cuda") == "host"
    assert engine.data_path_engine("cuda") == "host"
    assert calls == ["cuda"]


def test_probe_on_the_cpu_fills_last_probe_with_the_reference_keys():
    """The device arm on the CPU runs the plain versions of K1 and K2;
    the keys of ``last_probe`` are the ones the JAX package's probe
    fills where its device is available."""
    from ceph_tpu.ec import engine as ref

    verdict = engine._probe(torch.device("cpu"))
    assert verdict in ("device", "host")
    ref.last_probe.clear()
    ref._probe()
    assert set(engine.last_probe) == set(ref.last_probe)
    assert engine.last_probe["probe_data_bytes"] == \
        ref.last_probe["probe_data_bytes"] == 4 << 20
    assert engine.last_probe["device_s"] > 0
    assert engine.last_probe["host_s"] > 0
    want = "device" if engine.last_probe["device_s"] < \
        engine.last_probe["host_s"] else "host"
    assert verdict == want


def test_no_card_raises_and_never_answers_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.data_path_engine()
    assert engine.last_probe == {}
    with pytest.raises(RuntimeError, match="CUDA"):
        engine._probe()
    # no answer was cached: the next call raises again
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.data_path_engine()


@pytest.mark.parametrize("name", sorted(AUTO_PROFILES))
def test_auto_on_the_cpu_resolves_to_device_without_probing(monkeypatch,
                                                            name):
    _no_probe(monkeypatch)
    codec = load_codec(dict(AUTO_PROFILES[name]), device="cpu")
    assert codec.backend == "auto"
    assert codec.resolved_backend() == "device"


@pytest.mark.parametrize("name", sorted(AUTO_PROFILES))
@pytest.mark.parametrize("verdict", ["device", "host"])
def test_auto_on_a_cuda_codec_follows_the_probe(monkeypatch, name,
                                                verdict):
    """A codec on a CUDA device sends ``auto`` through the probe (asked
    for that device); forced backends never probe."""
    asked = []

    def probe(device=None):
        asked.append(device)
        return verdict
    monkeypatch.setattr(engine, "_probe", probe)
    codec = load_codec(dict(AUTO_PROFILES[name]), device="cpu")
    codec.device = torch.device("cuda")
    assert codec.resolved_backend() == verdict
    assert asked == [torch.device("cuda")]
    for forced in ("device", "host"):
        codec.backend = forced
        assert codec.resolved_backend() == forced
    assert len(asked) == 1
