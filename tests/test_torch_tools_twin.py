"""The same argv through the JAX package's CLIs (``tools/*.py``) and the
port's (``ceph_tpu_torch.tools``), with equal output required; and a
``rados --data-dir`` written by either package's CLI read back exactly
by the other's.

- ``crushtool``: ``--build`` (the map's bytes), ``-d`` (the text), and
  ``--test --show-utilization --show-bad-mappings`` on the host oracle
  for both rules; ``--test --device`` on each package's bulk engine (the
  reference's on JAX's CPU, the port's ``--device cpu`` on the plain
  version of K4).
- ``osdmaptool``: ``--createsimple`` (the map's bytes), ``--print``,
  ``--test-map-pgs`` and ``--test-map-object``.
- ``dencoder``: ``list`` and ``selftest``. The reference's ``selftest``
  has no sample for 30 of the registered message types and exits 1
  before it round-trips any (ROADMAP §3); the port's copy does the same,
  and ``chip_smoke.py`` round-trips every registered type through
  ``dencoder dump`` instead.
- ``rados --data-dir``: a replicated and an EC pool on BlueStoreLite; the
  reference's CLI writes and the port's (``--device cpu``) reads, then
  the other way round, and ``ls``/``stat``/``df`` agree.

Tolerance: exact. Each CLI runs through its ``main(argv)`` in this
process; the lines that name a path name the same path in both runs.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from ceph_tpu_torch.tools import crushtool as t_crushtool
from ceph_tpu_torch.tools import dencoder as t_dencoder
from ceph_tpu_torch.tools import osdmaptool as t_osdmaptool
from ceph_tpu_torch.tools import rados as t_rados

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(_TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _without_probe_types(monkeypatch) -> None:
    """Take out of both packages' message registries, for one test, the
    probe types other test files register (TYPE 0x7F00 and up), which a
    worker that ran them still holds: dencoder lists every registered
    type."""
    from ceph_tpu.msg import messages as jmessages
    from ceph_tpu_torch.msg import messages

    for registry in (jmessages._REGISTRY, messages._REGISTRY):
        for t in [t for t in registry if t >= 0x7F00]:
            monkeypatch.delitem(registry, t)


def _both(capsys, ref, port, argv, port_extra=()):
    """(rc, stdout, stderr) of the reference's CLI and of the port's on
    argv."""
    capsys.readouterr()
    rc_ref = ref.main(list(argv))
    ref_io = capsys.readouterr()
    rc_port = port.main(list(argv) + list(port_extra))
    port_io = capsys.readouterr()
    return ((rc_ref, ref_io.out, ref_io.err),
            (rc_port, port_io.out, port_io.err))


def test_crushtool_equal_output(tmp_path, capsys):
    ref = _load("crushtool")
    m = str(tmp_path / "map.bin")
    for argv in (["--build", "-o", m, "--num-osds", "24",
                  "--per-host", "4"],):
        want, got = _both(capsys, ref, t_crushtool, argv)
        assert got == want
    ref_bytes = open(m, "rb").read()
    assert t_crushtool.main(["--build", "-o", m, "--num-osds", "24",
                             "--per-host", "4"]) == 0
    assert open(m, "rb").read() == ref_bytes
    want, got = _both(capsys, ref, t_crushtool, ["-d", m])
    assert got == want and "rule" in want[1]
    for rule, rep in ((0, 3), (1, 6)):
        argv = ["--test", "-i", m, "--rule", str(rule), "--num-rep",
                str(rep), "--max-x", "2048", "--show-utilization",
                "--show-bad-mappings"]
        want, got = _both(capsys, ref, t_crushtool, argv)
        assert got == want, rule
        assert f"{2048} inputs: placed" in want[1]
        # the bulk engine: the reference's on JAX, the port's plain K4
        dev_want, dev_got = _both(capsys, ref, t_crushtool,
                                  argv + ["--device"], ["cpu"])
        assert dev_got == dev_want == want, rule


def test_osdmaptool_equal_output(tmp_path, capsys):
    ref = _load("osdmaptool")
    m = str(tmp_path / "osdmap.bin")
    want, got = _both(capsys, ref, t_osdmaptool,
                      ["--createsimple", "12", "-o", m, "--pg-num", "64"])
    assert got == want
    ref_bytes = open(m, "rb").read()
    t_osdmaptool.main(["--createsimple", "12", "-o", m, "--pg-num", "64"])
    assert open(m, "rb").read() == ref_bytes
    for argv in (["--print", m], ["--test-map-pgs", m, "--pool", "1"],
                 ["--test-map-object", "obj-17", "--pool", "1", m]):
        want, got = _both(capsys, ref, t_osdmaptool, argv)
        assert got == want, argv
        assert want[0] == 0 and want[1], argv


@pytest.mark.parametrize("verb", ["list", "selftest"])
def test_dencoder_equal_output(capsys, monkeypatch, verb):
    _without_probe_types(monkeypatch)
    ref = _load("dencoder")
    want, got = _both(capsys, ref, t_dencoder, [verb])
    assert got == want
    if verb == "list":
        assert want[0] == 0 and want[1].count("\n") >= 50
    else:
        assert want[0] == 1 and want[2].startswith("NO SAMPLE for ")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_rados_data_dir_crosses_packages(tmp_path, capsys, writer):
    """One package's ``rados`` CLI makes pools and writes objects in a
    durable dir; the other's reads every object back exactly, and both
    list, stat and df it alike."""
    ref = _load("rados")
    d = str(tmp_path / "cluster")
    base = ["--data-dir", d, "--osds", "5", "--dev-size", "64"]
    cpu = ["--device", "cpu"]
    w, w_extra = (ref, []) if writer == "reference" else (t_rados, cpu)
    r, r_extra = (t_rados, cpu) if writer == "reference" else (ref, [])
    rng = np.random.default_rng(7)
    blobs = {("rp", "a"): rng.bytes(70_001), ("rp", "b"): rng.bytes(4096),
             ("ecp", "c"): rng.bytes(200_003), ("ecp", "d"): rng.bytes(1)}
    assert w.main(base + w_extra + ["mkpool", "rp", "3"]) == 0
    assert w.main(base + w_extra + ["mkpool", "ecp", "--ec-k", "3",
                                    "--ec-m", "2"]) == 0
    for (pool, name), data in blobs.items():
        src = tmp_path / f"{pool}.{name}.in"
        src.write_bytes(data)
        assert w.main(base + w_extra + ["put", pool, name, str(src)]) == 0
    for (pool, name), data in blobs.items():
        out = tmp_path / f"{pool}.{name}.out"
        assert r.main(base + r_extra + ["get", pool, name, str(out)]) == 0
        assert out.read_bytes() == data, (pool, name)
    for argv in (["ls", "rp"], ["ls", "ecp"], ["stat", "ecp", "c"],
                 ["df"]):
        capsys.readouterr()
        assert w.main(base + w_extra + argv) == 0
        want = capsys.readouterr().out
        assert r.main(base + r_extra + argv) == 0
        assert capsys.readouterr().out == want, argv


def test_tools_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.tools_phase`` on ``device="cpu"``, small: every CLI
    runs through its ``main`` and every check of the phase holds
    (crushtool's counts equal the bulk engine's rows, osdmaptool's
    mappings the library's, rados bench's seq reads the written bytes,
    rbd's exports exact, the PG surgery, every message type through
    ``dencoder dump``, ceph's status, tree and pools, swarm without op
    errors, K1, K2 and K4 launched). The timings need CUDA events, so
    ``time_ms``, ``profile_steps`` and ``batch_times`` are stubbed."""
    import chip_smoke
    from test_torch_mds_twin import _count_launches

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    _count_launches(monkeypatch)
    _without_probe_types(monkeypatch)
    for name, value in (("TL_CRUSH_X", 1024), ("TL_CRUSH_HEAD", 256),
                        ("TL_BENCH_S", 1), ("TL_BENCH_T", 4),
                        ("TL_BENCH_BYTES", 256 << 10),
                        ("TL_BENCH_DEV_MIB", 64), ("TL_RBD_BYTES", 4 << 20),
                        ("TL_RBD_MUT_BYTES", 64 << 10),
                        ("TL_RBD_DEV_MIB", 64), ("TL_FREE_BYTES", 1 << 30),
                        ("TL_SWARM_ARGV", [
                            "--clients", "40", "--duration", "0.5",
                            "--osds", "6", "--objects", "1000",
                            "--rados-clients", "1", "--window", "64"])):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: 1.0)
    monkeypatch.setattr(chip_smoke, "profile_steps", lambda fn, **kw: {
        **{k: None for k in chip_smoke.PROFILE_CLOCK}, "ms_per_step": {}})
    timed = []

    def batch_times(dev, rng, codec, b, su, tag, cases):
        timed.append((tag, b, su, cases))
        return {f"{tag}_{c}": {"stripes": b} for c in cases}
    monkeypatch.setattr(chip_smoke, "batch_times", batch_times)
    out = chip_smoke.tools_phase("cpu", np.random.default_rng(7),
                                 device="cpu")
    lines = out["lines"]
    assert list(lines) == ["crushtool", "osdmaptool", "rados_bench", "rbd",
                           "objectstore_tool", "dencoder", "ceph", "swarm"]
    assert lines["rados_bench"]["seq"]["reads_equal"] > 0
    assert lines["dencoder"]["dumped_round_trip"] == \
        lines["dencoder"]["types"] >= 50
    assert lines["ceph"]["tree_osds_up"] == chip_smoke.CL_OSDS
    for key in ("gf_matmul", "crc32c", "crush_rule"):
        assert out["launches"][key] > 0, key
    assert [t[0] for t in timed] == ["tools_bench_wb"]
    assert set(out["timed"]) >= {"crush_rule_tools_replicated",
                                 "crush_rule_tools_ec_8_3"}
