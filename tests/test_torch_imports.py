"""The port stands alone: no JAX, nothing of ceph_tpu, and no silent drop
to the CPU when a card was expected."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ceph_tpu_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_nothing_of_ceph_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'jaxlib' "
        "or n == 'ceph_tpu' or n.startswith('ceph_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_static_scan_no_ceph_tpu_or_jax_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ceph_tpu"), (path, name)


def test_no_device_and_no_card_raises(monkeypatch):
    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.device import resolve
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.models import datapath
    from ceph_tpu_torch.ops import crc32c

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_codec({"plugin": "rs_tpu", "k": "8", "m": "3"})
    with pytest.raises(RuntimeError, match="CUDA"):
        Checksummer("crc32c", 4096).calculate(np.zeros(4096, np.uint8),
                                              device=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        crc32c.crc32c_batch(np.zeros((1, 8), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        datapath.example_batch(datapath.ECParams(chunk_bytes=64))
    assert resolve("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
