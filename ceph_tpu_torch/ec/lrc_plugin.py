"""LRC plugin: layered locally-repairable codes (the lrc role,
src/erasure-code/lrc/ErasureCodeLrc.cc semantics, 859 LoC there).

The code is described by a ``mapping`` string (one char per stored
chunk position: 'D' = object data, anything else = coding/unused) and
ordered ``layers``, each a (pattern, inner-profile) pair over the same
positions: 'D' = input to that layer's inner codec, 'c' = coding chunk
computed and stored at that position, '_' = not involved. Layers apply
in order at encode time, so a later layer may consume an earlier
layer's coding chunk as its data (doc/rados/operations/
erasure-code-lrc.rst "Erasure coding and decoding algorithm").

k/m/l profiles generate the same low-level config the reference's
parse_kml emits: local_group_count = (k+m)/l groups, mapping
``D*(k/g) + '_'*(m/g) + '_'`` per group, one global layer with the
'_' slots as its coding positions, and one local-parity layer per
group (``'D'*l + 'c'``).

Repair planning is an iterative fixpoint over layers (smallest inner-k
first, so a local group repairs its own loss without touching other
groups — the whole point of LRC): any layer with >= inner-k positions
available can rebuild its span; newly repaired chunks unlock further
layers. minimum_to_decode reports only chunks that must actually be
READ (reconstructed intermediates are free).

Device stance: inner layers default to the rs_tpu matrix codec, made on
the LRC codec's own torch device, so every layer's encode is the same
GF(2^8) kernel; a layer pattern is just a gather over the stripe's chunk
rows. The batched API (``encode_crc_batch`` / ``decode_batch``) runs the
composite generator through ``ops.rs`` on the codec's device: the GF(2^8)
and CRC32C kernels on the card, their plain versions on the CPU.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import rs
from . import ECError, ErasureCode, _as_u8
from .registry import register


@dataclass
class Layer:
    pattern: str
    data_pos: list[int]  # positions read as inner data (in pattern order)
    coding_pos: list[int]  # positions written as inner coding
    codec: object  # inner ErasureCode (k=#data_pos, m=#coding_pos)

    @property
    def span(self) -> list[int]:
        return self.data_pos + self.coding_pos


def _parse_layer_profile(spec: str) -> dict[str, str]:
    """'plugin=isa technique=cauchy' -> profile dict."""
    out: dict[str, str] = {}
    for tok in spec.split():
        if "=" not in tok:
            raise ECError(f"bad layer profile token {tok!r}")
        key, val = tok.split("=", 1)
        out[key] = val
    return out


class LRCCodec(ErasureCode):
    def init(self, profile) -> None:
        super().init(profile)
        if any(x in self.profile for x in ("k", "m", "l")):
            self._generate_kml()
        mapping = self.profile.get("mapping")
        layers_raw = self.profile.get("layers")
        if not mapping or not layers_raw:
            raise ECError(
                "lrc profile needs mapping+layers, or k, m and l"
            )
        data_pos = [p for p, ch in enumerate(mapping) if ch == "D"]
        self.k = len(data_pos)
        self.m = len(mapping) - self.k
        if not self.k:
            raise ECError(f"mapping {mapping!r} has no data positions")
        self.mapping = mapping
        self._parse_mapping()  # sets chunk_mapping = data_pos + coding_pos

        try:
            layer_list = json.loads(layers_raw)
        except json.JSONDecodeError as e:
            raise ECError(f"layers is not valid JSON: {e}") from None
        if not isinstance(layer_list, list) or not layer_list:
            raise ECError("layers must be a non-empty JSON list")
        self.layers: list[Layer] = []
        for entry in layer_list:
            if not (isinstance(entry, list) and len(entry) >= 1):
                raise ECError(f"bad layer entry {entry!r}")
            pattern = entry[0]
            spec = entry[1] if len(entry) > 1 else ""
            if len(pattern) != len(mapping):
                raise ECError(
                    f"layer pattern {pattern!r} length != mapping length "
                    f"{len(mapping)}"
                )
            d = [p for p, ch in enumerate(pattern) if ch == "D"]
            c = [p for p, ch in enumerate(pattern) if ch == "c"]
            if not d or not c:
                raise ECError(
                    f"layer {pattern!r} needs at least one D and one c"
                )
            inner_profile = _parse_layer_profile(spec)
            inner_profile.setdefault("plugin", "rs_tpu")
            if inner_profile["plugin"] == "jerasure":
                inner_profile["plugin"] = "rs_tpu"
            if "backend" in self.profile:
                inner_profile.setdefault("backend", self.profile["backend"])
            inner_profile["k"] = str(len(d))
            inner_profile["m"] = str(len(c))
            from .registry import load_codec

            self.layers.append(
                Layer(pattern, d, c,
                      load_codec(inner_profile, device=self.device))
            )
        # repair preference: cheapest (smallest inner k) layers first —
        # the locality win the plugin exists for
        self._repair_order = sorted(
            range(len(self.layers)),
            key=lambda i: len(self.layers[i].data_pos),
        )
        # Composite generator: every layer is a bytewise GF(2^8)
        # matrix code, so the layered composition is one too — feeding
        # the identity through the layer stack reads the (m, k)
        # generator off byte-by-byte. This is what lets LRC stripes
        # ride the SAME fused encode+CRC / stacked-decode device
        # pipeline as rs_tpu (encode_crc_batch below), while
        # minimum_to_decode keeps planning locality-sized reads.
        self.matrix = self.encode_chunks(np.eye(self.k, dtype=np.uint8))
        self.backend = self.profile.get("backend", "auto")
        if self.backend not in ("device", "host", "auto"):
            raise ECError(
                f"backend must be device|host|auto, not {self.backend!r}")
        self._rmat_cache: dict[tuple, np.ndarray] = {}

    #: bytewise GF(2^8) linearity (every layer is), so cell/range
    #: slicing is a codeword transform — same stance as rs_plugin
    bytewise_linear = True

    #: locality plans fetch FEWER than k chunks; the batched decode
    #: must receive every fetched row, not the first k
    decode_uses_all_rows = True

    def profile_key_extra(self) -> tuple:
        """Same (k, m) with different mapping/layers is a different
        code — the ECBatcher bucket key appends the layout."""
        return (self.mapping, self.profile.get("layers", ""))

    # --------------------------------------------------- batched (device)

    def resolved_backend(self) -> str:
        """"host" for backend=host, else "device" (``auto`` included: the
        port runs on the card and has no host-vs-device probe)."""
        return "host" if self.backend == "host" else "device"

    def encode_crc_batch(self, data, cell_bytes: int):
        """(B, k, W) words -> (parity, per-cell CRCs): one launch of each
        kernel via the composite generator (rs_plugin shape; parity rows
        come out in chunk_mapping coding order)."""
        return rs.encode_with_crcs(self.matrix, cell_bytes, self._words(data))

    def decode_batch(self, present: tuple[int, ...], surviving,
                     want: tuple[int, ...] | None = None) -> torch.Tensor:
        """(B, p, W) survivor words (GENERATOR indices in ``present``
        order — p may be smaller than k for a local repair) ->
        (B, len(want), W), one stacked matmul."""
        if want is None:
            want = tuple(range(self.k))
        rmat = self.decode_matrix_for(tuple(present), tuple(want))
        return rs.gf_matmul(rmat, self._words(surviving))

    def decode_matrix_for(self, present, want) -> np.ndarray:
        """Recovery matrix over an arbitrary decodable subset: solve
        x @ G[present] = G[want] over GF(2^8) (gf8.gf_solve). Unlike
        the MDS square inverse, ``present`` may be any spanning set —
        including a local group smaller than k. Raises when the subset
        cannot determine a wanted row (callers then re-plan)."""
        from ..ops import gf8 as _gf8

        key = (tuple(present), tuple(want))
        rmat = self._rmat_cache.get(key)
        if rmat is None:
            gen = np.vstack([np.eye(self.k, dtype=np.uint8),
                             self.matrix])
            # transpose: solve G[present].T @ X = G[want].T, columns
            # of X are each wanted row's coefficients over survivors
            rmat = np.ascontiguousarray(_gf8.gf_solve(
                gen[list(present)].T, gen[list(want)].T).T)
            self._rmat_cache[key] = rmat
        return rmat

    def _generate_kml(self) -> None:
        """parse_kml role: k/m/l -> generated mapping + layers."""
        if "mapping" in self.profile or "layers" in self.profile:
            raise ECError(
                "mapping/layers cannot be set when k, m, l are set"
            )
        k = self.to_int("k", 0)
        m = self.to_int("m", 0)
        l = self.to_int("l", 0)  # noqa: E741 (reference parameter name)
        if not (k and m and l):
            raise ECError("all of k, m, l must be set")
        if (k + m) % l:
            raise ECError("k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups or m % groups:
            raise ECError("k and m must be multiples of (k + m) / l")
        kg, mg = k // groups, m // groups
        self.profile["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        global_pat = ("D" * kg + "c" * mg + "_") * groups
        layer_list = [[global_pat, ""]]
        for i in range(groups):
            pat = "".join(
                ("D" * l + "c") if i == j else "_" * (l + 1)
                for j in range(groups)
            )
            layer_list.append([pat, ""])
        self.profile["layers"] = json.dumps(layer_list)

    # ------------------------------------------------------ encode path

    def encode(self, want_to_encode, data):
        """Pad + split into k data chunks at the D positions, then run
        every layer in order (a layer may consume earlier coding)."""
        raw = _as_u8(data)
        blocksize = self.get_chunk_size(raw.size)
        padded = np.zeros(blocksize * self.k, dtype=np.uint8)
        padded[: raw.size] = raw
        data_chunks = padded.reshape(self.k, blocksize)
        by_pos: dict[int, np.ndarray] = {
            self.chunk_index(i): data_chunks[i] for i in range(self.k)
        }
        self._run_layers(by_pos)
        want = set(want_to_encode)
        return {p: c for p, c in by_pos.items() if p in want}

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        """(k, L) -> (m, L) coding rows in chunk_mapping coding order
        (the base-class seam; encode() above is the primary path)."""
        by_pos = {
            self.chunk_index(i): np.ascontiguousarray(
                data_chunks[i], dtype=np.uint8
            )
            for i in range(self.k)
        }
        self._run_layers(by_pos)
        coding_positions = [self.chunk_index(self.k + j)
                            for j in range(self.m)]
        return np.stack([by_pos[p] for p in coding_positions])

    def _run_layers(self, by_pos: dict[int, np.ndarray]) -> None:
        for layer in self.layers:
            try:
                stack = np.stack([by_pos[p] for p in layer.data_pos])
            except KeyError as e:
                raise ECError(
                    f"layer {layer.pattern!r} input position {e} not yet "
                    f"computed (layer order broken)"
                ) from None
            coding = layer.codec.encode_chunks(stack)
            for idx, p in enumerate(layer.coding_pos):
                by_pos[p] = coding[idx]

    # ------------------------------------------------------ decode path

    def _repair_plan(self, want: set[int], available: set[int]):
        """-> (reads, steps). steps = [(layer, use_positions)] applied in
        order; each rebuilds that layer's whole span from use_positions.
        reads ⊆ available is what must actually be fetched."""
        have = set(available)
        reads = set(want & have)
        steps: list[tuple[Layer, list[int]]] = []
        while not want <= have:
            progress = False
            for li in self._repair_order:
                layer = self.layers[li]
                span = layer.span
                missing = [p for p in span if p not in have]
                if not missing:
                    continue
                present = [p for p in span if p in have]
                kk = len(layer.data_pos)
                if len(present) < kk:
                    continue
                # prefer chunks already scheduled for reading, then data
                use = sorted(
                    present,
                    key=lambda p: (p not in reads and p in available, p),
                )[:kk]
                steps.append((layer, use))
                reads |= {p for p in use if p in available}
                have |= set(span)
                progress = True
                if want <= have:
                    break
            if not progress:
                raise ECError(
                    f"cannot decode {sorted(want)}: available "
                    f"{sorted(available)} insufficient for every layer"
                )
        return reads, steps

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return {c: [(0, 1)] for c in sorted(want)}
        reads, _ = self._repair_plan(want, avail)
        return {c: [(0, 1)] for c in sorted(reads)}

    def decode(self, want_to_read, chunks):
        want = set(want_to_read)
        by_pos: dict[int, np.ndarray] = {
            p: _as_u8(c) for p, c in chunks.items()
        }
        if want <= set(by_pos):
            return {p: by_pos[p] for p in sorted(want)}
        _, steps = self._repair_plan(want, set(by_pos))
        for layer, use in steps:
            # inner index space: data positions first (pattern order),
            # then coding positions
            inner_index = {p: i for i, p in enumerate(layer.span)}
            present = [inner_index[p] for p in use]
            stack = np.stack([by_pos[p] for p in use])
            rebuilt = layer.codec.decode_chunks(present, stack)
            for p in layer.span:
                if p not in by_pos:
                    by_pos[p] = rebuilt[inner_index[p]]
        missing = want - set(by_pos)
        if missing:
            raise ECError(f"repair plan left {sorted(missing)} missing")
        return {p: by_pos[p] for p in sorted(want)}


register("lrc", LRCCodec)
