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


def test_cluster_with_no_device_and_no_card_raises(monkeypatch):
    """The cluster tier resolves its device when it is built: with none
    named and no card, a TestCluster, an OSD, a client and the thrash
    runner raise instead of running on the CPU."""
    from ceph_tpu_torch.cluster import OSDLite, RadosClient, TestCluster
    from ceph_tpu_torch.msg.messenger import LocalBus
    from ceph_tpu_torch.tools import thrash

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TestCluster(n_osds=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDLite(LocalBus(), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        RadosClient(LocalBus())
    with pytest.raises(RuntimeError, match="CUDA"):
        thrash.main(["--seed", "1"])
    assert TestCluster(n_osds=3, device="cpu").device == torch.device("cpu")


PROCESS_TIER = ("ceph_tpu_torch.cluster.paxos_mon",
                "ceph_tpu_torch.cluster.daemon",
                "ceph_tpu_torch.cluster.procstart")


@pytest.mark.parametrize("module", PROCESS_TIER)
def test_process_tier_module_is_the_ports_own(module):
    """The process tier's three modules are among the port's, and none
    of them names JAX or the JAX package (the subprocess and static
    scans above cover them too)."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    for name in _imported_names(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "ceph_tpu"), name


def test_process_tier_with_no_device_and_no_card_raises(monkeypatch,
                                                        tmp_path):
    """A ProcCluster resolves its device when it is built, like a
    TestCluster; the MDS role raises (its module is not ported), while
    ``--proc`` runs; ``--chip-loss`` (ported with ``parallel/``) with no
    device and no card raises, as the in-process arm does."""
    import asyncio

    from ceph_tpu_torch.cluster.procstart import ProcCluster
    from ceph_tpu_torch.tools import thrash

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcCluster(str(tmp_path / "a"), n_osds=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        thrash.main(["--seed", "1", "--proc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        thrash.main(["--seed", "1", "--chip-loss"])
    c = ProcCluster(str(tmp_path / "b"), n_osds=3, device="cpu")
    assert c.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        asyncio.run(c.start_mds(0, pool=1))


def test_a_cuda_daemon_with_no_card_exits_nonzero(tmp_path):
    """``--device cuda`` with no card: the OSD daemon exits with an
    error before it boots (no .ready marker), never carrying on on the
    CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    book = tmp_path / "book"
    book.mkdir()
    res = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.cluster.daemon", "--role",
         "osd", "--id", "0", "--book", str(book), "--store-dir",
         str(tmp_path), "--n-osds", "1", "--device", "cuda"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert not (book / "osd.0.ready").exists()


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


MESH_TIER = ("ceph_tpu_torch.parallel", "ceph_tpu_torch.parallel.runtime",
             "ceph_tpu_torch.parallel.shard_comm",
             "ceph_tpu_torch.ops.xor_combine",
             "ceph_tpu_torch.tools.dryrun_multichip",
             "ceph_tpu_torch.tools.thrash")


@pytest.mark.parametrize("module", MESH_TIER)
def test_mesh_tier_module_is_the_ports_own(module):
    """The multi-device data plane's modules and its two tools are among
    the port's (so the subprocess and static scans above cover them), and
    none of them names JAX or the JAX package."""
    assert module in _port_modules()
    rel = module.replace(".", "/")
    path = ROOT / (rel + ".py")
    if not path.exists():
        path = ROOT / rel / "__init__.py"
    for name in _imported_names(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "ceph_tpu"), name


def test_a_mesh_with_no_device_and_no_card_raises(monkeypatch):
    """With no device named and no card, a mesh, the dry run and the
    serving mesh raise instead of running on the CPU."""
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.parallel import runtime
    from ceph_tpu_torch.tools import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.get_devices(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.serving_mesh(8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip.dryrun_multichip(2)


SERVICES_TIER = ("ceph_tpu_torch.osdc", "ceph_tpu_torch.osdc.striper",
                 "ceph_tpu_torch.osdc.striped_client",
                 "ceph_tpu_torch.osdc.object_cacher",
                 "ceph_tpu_torch.services", "ceph_tpu_torch.services.rbd",
                 "ceph_tpu_torch.services.rbd_crypto",
                 "ceph_tpu_torch.services.mirror",
                 "ceph_tpu_torch.services.fs",
                 "ceph_tpu_torch.services.sqlite_vfs",
                 "ceph_tpu_torch.services.rgw_acl",
                 "ceph_tpu_torch.services.rgw",
                 "ceph_tpu_torch.services.rgw_swift",
                 "ceph_tpu_torch.services.rgw_notify",
                 "ceph_tpu_torch.services.rgw_sync",
                 "ceph_tpu_torch.mgr_modules.dashboard",
                 "ceph_tpu_torch.mgr_modules.rgw_lc")


@pytest.mark.parametrize("module", SERVICES_TIER)
def test_services_tier_module_is_the_ports_own(module):
    """The client library above RadosClient (``osdc/``, ``services/``)
    and the two mgr modules that stand on it are among the port's (so the
    subprocess and static scans above cover them), none of them names
    JAX or the JAX package, and every one of them resolves to a file of
    the port when it is imported."""
    import importlib

    assert module in _port_modules()
    rel = module.replace(".", "/")
    path = ROOT / (rel + ".py")
    if not path.exists():
        path = ROOT / rel / "__init__.py"
    for name in _imported_names(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "ceph_tpu"), name
    mod = importlib.import_module(module)
    assert Path(mod.__file__).resolve() == path.resolve()


def test_dashboard_and_rgw_lc_use_the_ports_rgw():
    """The dashboard serves through rgw's own ``HttpFrontend`` and rgw_lc
    builds its RGWLite from the port's rgw, as the reference's modules
    do."""
    import inspect

    from ceph_tpu_torch.mgr_modules import dashboard, rgw_lc
    from ceph_tpu_torch.services import rgw

    assert dashboard.HttpFrontend is rgw.HttpFrontend
    assert "NotImplementedError" not in inspect.getsource(rgw_lc)


def test_rbd_crypto_imports_without_cryptography():
    """``cryptography`` is imported where a cipher is built, not when
    ``rbd_crypto`` is imported: with the package hidden the module
    imports, and building a cipher raises ImportError (the H100 machine
    has no ``cryptography``)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'cryptography' or name.startswith('cryptography.'):\n"
        "            raise ImportError('hidden: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from ceph_tpu_torch.services import rbd_crypto\n"
        "try:\n"
        "    rbd_crypto._aes_gcm(b'k' * 32)\n"
        "except ImportError as e:\n"
        "    print('raised', e)\n"
        "else:\n"
        "    raise SystemExit('no ImportError at use')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "raised hidden: cryptography" in res.stdout
