"""The cases of ``tests/test_tools.py`` on the port's CLIs
(``ceph_tpu_torch.tools.rados``, ``.objectstore_tool`` and ``.rbd``),
each cluster on ``--device cpu`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

CLI tools: rados (put/get/ls/df/bench — src/tools/rados +
obj_bencher roles) and objectstore_tool (offline PG surgery —
ceph_objectstore_tool role). Each invocation is a fresh process-style
main() call against durable BlueStoreLite state, so the tools also
exercise cold cluster restart.
"""
import json
import os

import pytest
import torch

from ceph_tpu_torch.tools import objectstore_tool as ost
from ceph_tpu_torch.tools import rados
from ceph_tpu_torch.tools import rbd as rbd_cli

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

#: every cluster of these cases on the kernels' plain versions
CPU = ["--device", "cpu"]


def test_rados_put_get_ls_df_roundtrip(tmp_path, capsys):
    d = str(tmp_path / "cluster")
    base = ["--data-dir", d, "--osds", "5", "--dev-size", "64"] + CPU
    assert rados.main(base + ["mkpool", "ecp", "--ec-k", "3",
                              "--ec-m", "2"]) == 0
    payload = os.urandom(50_000)
    src = tmp_path / "in.bin"
    src.write_bytes(payload)
    assert rados.main(base + ["put", "ecp", "obj1", str(src)]) == 0
    assert rados.main(base + ["put", "ecp", "obj2", str(src)]) == 0
    out = tmp_path / "out.bin"
    capsys.readouterr()
    assert rados.main(base + ["get", "ecp", "obj1", str(out)]) == 0
    assert out.read_bytes() == payload
    assert rados.main(base + ["ls", "ecp"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["obj1", "obj2"]
    assert rados.main(base + ["stat", "ecp", "obj1"]) == 0
    assert "size 50000" in capsys.readouterr().out
    assert rados.main(base + ["df"]) == 0
    df = capsys.readouterr().out
    assert "ecp" in df and "100000" in df
    assert rados.main(base + ["rm", "ecp", "obj2"]) == 0
    assert rados.main(base + ["ls", "ecp"]) == 0
    assert capsys.readouterr().out.splitlines() == ["obj1"]


def test_rados_bench_write_then_read(tmp_path, capsys):
    base = ["--osds", "4"] + CPU  # MemStore throwaway cluster
    assert rados.main(base + ["bench", "bp", "1", "write",
                              "-b", "65536", "-t", "4"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "write" and res["ops"] > 0
    assert res["mb_per_sec"] > 0 and res["avg_lat_ms"] > 0
    # seq needs the written objects -> durable dir variant
    d = str(tmp_path / "bcluster")
    base = ["--data-dir", d, "--osds", "4", "--dev-size", "64"] + CPU
    assert rados.main(base + ["bench", "bp", "1", "write",
                              "-b", "16384", "-t", "4"]) == 0
    capsys.readouterr()
    assert rados.main(base + ["bench", "bp", "1", "seq", "-t", "4"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "seq" and res["ops"] > 0


def test_objectstore_tool_surgery(tmp_path, capsys):
    """Export a PG from one (downed) OSD store, wipe it, re-import —
    the disaster-recovery arc the reference tool exists for."""
    d = str(tmp_path / "cluster")
    base = ["--data-dir", d, "--osds", "4", "--dev-size", "64"] + CPU
    assert rados.main(base + ["mkpool", "rp", "3"]) == 0
    payload = os.urandom(9000)
    src = tmp_path / "in.bin"
    src.write_bytes(payload)
    assert rados.main(base + ["put", "rp", "victim", str(src)]) == 0
    capsys.readouterr()

    pgid = None
    for i in range(4):  # find an OSD holding a replica
        tb = ["--data-path", os.path.join(d, f"osd.{i}"),
              "--type", "bluestore"]
        assert ost.main(tb + ["--op", "list"]) == 0
        rows = [json.loads(ln) for ln in
                capsys.readouterr().out.splitlines()]
        pgids = {cid for cid, oid in rows if oid == "victim"}
        if pgids:
            pgid = pgids.pop()
            break
    assert pgid is not None, "no OSD holds the object?"

    assert ost.main(tb + ["--op", "info", "--pgid", pgid]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["objects"] >= 1

    exp = str(tmp_path / "pg.export")
    assert ost.main(tb + ["--op", "export", "--pgid", pgid,
                          "--file", exp]) == 0
    assert ost.main(tb + ["--op", "remove", "--pgid", pgid]) == 0
    capsys.readouterr()
    assert ost.main(tb + ["--op", "list"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert pgid not in {cid for cid, _ in rows}

    assert ost.main(tb + ["--op", "import", "--file", exp]) == 0
    out = str(tmp_path / "got.bin")
    assert ost.main(tb + ["--op", "get-bytes", "--pgid", pgid,
                          "--obj", "victim", "--file", out]) == 0
    assert open(out, "rb").read() == payload

    # importing over an existing PG is refused (log would go stale)
    with pytest.raises(SystemExit, match="already exists"):
        ost.main(tb + ["--op", "import", "--file", exp])

    # corrupt export is rejected
    blob = bytearray(open(exp, "rb").read())
    blob[10] ^= 1
    bad = str(tmp_path / "bad.export")
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(SystemExit, match="corrupt"):
        ost.main(tb + ["--op", "import", "--file", bad])



def test_rbd_cli_lifecycle(tmp_path, capsys):
    """rbd CLI (src/tools/rbd role): create/import/export/snap/clone/
    encryption over durable state, each call a cold cluster restart."""
    # the `encryption format`/`--encryption-passphrase-file` legs ride
    # the optional `cryptography` package — skip in minimal containers
    pytest.importorskip("cryptography")
    d = str(tmp_path / "cluster")
    base = ["--data-dir", d, "--osds", "4"] + CPU
    img = os.urandom(200_000)
    src = tmp_path / "disk.img"
    src.write_bytes(img)
    out = tmp_path / "out.img"
    assert rbd_cli.main(base + ["mkpool", "rbd"]) == 0
    assert rbd_cli.main(base + ["create", "rbd/disk",
                                "--size", "1M"]) == 0
    assert rbd_cli.main(base + ["ls", "rbd"]) == 0
    assert "disk" in capsys.readouterr().out
    assert rbd_cli.main(base + ["import", "rbd/disk", str(src)]) == 0
    assert rbd_cli.main(base + ["export", "rbd/disk", str(out)]) == 0
    assert out.read_bytes()[:len(img)] == img
    # snapshot, mutate, clone from the snap: clone sees the snap state
    assert rbd_cli.main(base + ["snap", "create", "rbd/disk@s1"]) == 0
    mut = tmp_path / "mut.img"
    mut.write_bytes(b"\xaa" * 1000)
    assert rbd_cli.main(base + ["import", "rbd/disk", str(mut)]) == 0
    assert rbd_cli.main(base + ["clone", "rbd/disk@s1",
                                "rbd/child"]) == 0
    assert rbd_cli.main(base + ["flatten", "rbd/child"]) == 0
    assert rbd_cli.main(base + ["export", "rbd/child", str(out)]) == 0
    assert out.read_bytes()[:len(img)] == img  # pre-mutation content
    assert rbd_cli.main(base + ["info", "rbd/disk"]) == 0
    assert "size" in capsys.readouterr().out
    # encrypted image: format once, encrypted import/export round-trips
    pf = tmp_path / "pass.txt"
    pf.write_text("s3kr1t\n")
    assert rbd_cli.main(base + ["create", "rbd/vault",
                                "--size", "1M"]) == 0
    assert rbd_cli.main(base + ["encryption", "format", "rbd/vault",
                                str(pf)]) == 0
    assert rbd_cli.main(base + ["import", "rbd/vault", str(src),
                                "--passphrase-file", str(pf)]) == 0
    assert rbd_cli.main(base + ["export", "rbd/vault", str(out),
                                "--passphrase-file", str(pf)]) == 0
    assert out.read_bytes()[:len(img)] == img
    # without the passphrase the export is ciphertext
    assert rbd_cli.main(base + ["export", "rbd/vault", str(out)]) == 0
    assert out.read_bytes()[:len(img)] != img
    assert rbd_cli.main(base + ["rm", "rbd/child"]) == 0
    capsys.readouterr()  # drop the rm confirmation
    assert rbd_cli.main(base + ["ls", "rbd"]) == 0
    outtxt = capsys.readouterr().out
    assert "child" not in outtxt and "vault" in outtxt
