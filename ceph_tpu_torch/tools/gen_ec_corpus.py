#!/usr/bin/env python3
"""Generate the EC golden-bytes corpus (the ceph-erasure-code-corpus +
ceph_erasure_code_non_regression role, src/test/erasure-code/
ceph_erasure_code_non_regression.cc).

For every (plugin, technique/config, k, m, object size) in the matrix,
encode a deterministic seeded payload with the HOST reference path and
pin the SHA-256 of every chunk. tests/test_corpus.py re-encodes with
both host and device backends and fails on any byte drift — encodings
are an on-disk format: once written, future kernels must reproduce
them forever.

Run: python -m ceph_tpu_torch.tools.gen_ec_corpus --check [--device D]
     python -m ceph_tpu_torch.tools.gen_ec_corpus --out PATH [--device D]
Corpus lives at tests/corpus/ec_corpus.json (checked in).

ceph_tpu_torch's own copy of ``tools/gen_ec_corpus.py``: the same
``MATRIX``, ``SIZES``, ``payload`` and ``encode_entry``, over
``ceph_tpu_torch.ec.load_codec`` on ``--device`` (the CUDA card when it
is left out; ``--device cpu`` runs the plain versions). Changed:

- ``--check`` replays every entry twice and writes nothing: once as the
  corpus pins it, and once more with ``backend=device`` for every plugin
  whose port takes that key (rs_tpu, lrc, clay; shec runs on the host
  only, and its line says so). It prints a line per config, and a line
  per config, size and arm that drifts.
- Writing needs ``--out``: this tool never rewrites the checked-in
  corpus.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

from ..ec import load_codec

CORPUS_PATH = (Path(__file__).resolve().parents[2] / "tests" / "corpus"
               / "ec_corpus.json")

SIZES = (31, 4096, 65537)

MATRIX: list[dict] = []
for technique in ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                  "cauchy_good"):
    for k, m in ((2, 1), (4, 2), (8, 3), (8, 4)):
        if technique == "reed_sol_r6_op" and m != 2:
            continue
        MATRIX.append({
            "plugin": "rs_tpu", "technique": technique,
            "k": str(k), "m": str(m), "backend": "host",
        })
MATRIX += [
    {"plugin": "lrc", "mapping": "__DD__DD",
     "layers": '[["_cDD_cDD", ""], ["cDDD____", ""], ["____cDDD", ""]]'},
    {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    {"plugin": "shec", "k": "6", "m": "3", "c": "2",
     "technique": "single"},
    {"plugin": "clay", "k": "4", "m": "2"},
    {"plugin": "clay", "k": "3", "m": "2", "d": "4"},
    {"plugin": "clay", "k": "4", "m": "3"},
]

#: plugins whose port takes ``backend=device`` (shec has no backend key)
DEVICE_PLUGINS = ("rs_tpu", "lrc", "clay")


def profile_key(profile: dict) -> str:
    return "&".join(f"{k}={v}" for k, v in sorted(profile.items()))


def payload(size: int) -> bytes:
    return np.random.default_rng(0xEC0DE + size).integers(
        0, 256, size, dtype=np.uint8
    ).tobytes()


def encode_entry(profile: dict, device=None) -> dict:
    codec = load_codec(dict(profile), device=device)
    n = codec.get_chunk_count()
    sizes = {}
    for size in SIZES:
        encoded = codec.encode(list(range(n)), payload(size))
        sizes[str(size)] = {
            "chunk_size": codec.get_chunk_size(size),
            "chunks": [
                hashlib.sha256(encoded[i].tobytes()).hexdigest()[:24]
                for i in range(n)
            ],
        }
    return {"profile": profile, "n": n, "sizes": sizes}


def _drifts(arm: str, key: str, got: dict, want: dict) -> list[str]:
    """A line per size at which ``got`` differs from the pinned entry."""
    if got["n"] != want["n"]:
        return [f"DRIFT {arm} {key}: {got['n']} chunks, pinned {want['n']}"]
    out = []
    for size, pinned in want["sizes"].items():
        have = got["sizes"][size]
        if have != pinned:
            bad = [i for i, (a, b) in enumerate(zip(have["chunks"],
                                                    pinned["chunks"]))
                   if a != b]
            out.append(f"DRIFT {arm} {key} size {size}: chunk_size "
                       f"{have['chunk_size']} (pinned "
                       f"{pinned['chunk_size']}), chunks {bad} differ")
    return out


def check(want: dict, device=None) -> tuple[list[str], list[str]]:
    """Replay every MATRIX entry against the corpus ``want`` -> (a line
    per config, the drift lines)."""
    lines: list[str] = []
    keys = {profile_key(p) for p in MATRIX}
    drift = [f"DRIFT pinned {key}: not in the matrix"
             for key in sorted(want) if key not in keys]
    for profile in MATRIX:
        key = profile_key(profile)
        if key not in want:
            drift.append(f"DRIFT pinned {key}: not in the corpus")
            continue
        found = _drifts("pinned", key, encode_entry(profile, device),
                        want[key])
        arms = ["pinned " + ("drift" if found else "ok")]
        if profile["plugin"] in DEVICE_PLUGINS:
            dev_profile = {**profile, "backend": "device"}
            dev = _drifts("backend=device", key,
                          encode_entry(dev_profile, device), want[key])
            found += dev
            arms.append("backend=device " + ("drift" if dev else "ok"))
        else:
            arms.append(f"backend=device n/a: {profile['plugin']} runs "
                        "on the host only")
        drift += found
        lines.append(f"{key}: " + ", ".join(arms))
    return lines, drift


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="gen_ec_corpus")
    ap.add_argument("--check", action="store_true",
                    help="verify against the existing corpus, no write")
    ap.add_argument("--out", default=None,
                    help="write the corpus to this path")
    ap.add_argument("--device", default=None,
                    help="torch device of the codecs (default: the card)")
    args = ap.parse_args(argv)
    if args.check:
        with open(CORPUS_PATH) as f:
            want = json.load(f)
        lines, drift = check(want, args.device)
        for line in lines + drift:
            print(line)
        if drift:
            print("CORPUS DRIFT DETECTED", file=sys.stderr)
            return 1
        print(f"corpus clean: {len(MATRIX)} configs x {len(SIZES)} sizes")
        return 0
    if args.out is None:
        ap.error("writing needs --out (the checked-in corpus is never "
                 "rewritten)")
    corpus = {profile_key(p): encode_entry(p, args.device) for p in MATRIX}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(corpus, f, indent=1, sort_keys=True)
    print(f"wrote {len(corpus)} configs to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
