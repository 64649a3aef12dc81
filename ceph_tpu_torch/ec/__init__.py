"""Erasure-code codec layer: interface, base semantics, plugin registry.

Mirrors the reference's codec seam (ErasureCodeInterface.h:170-462 and the
shared base-class behavior in ErasureCode.cc) so everything above it — the
EC backend, tools, tests — programs against the same contract:

- ``init(profile)`` / ``get_profile``
- ``get_chunk_count / get_data_chunk_count / get_coding_chunk_count /
  get_sub_chunk_count``
- ``get_chunk_size(object_size)`` — alignment-padded ceil-division
  (ErasureCodeJerasure.cc:80-102 semantics)
- ``minimum_to_decode(want, available)`` — with per-chunk sub-chunk
  (offset, count) pairs for regenerating codes (ErasureCodeInterface.h:297)
- ``encode(want_to_encode, data)`` — pad + split + encode_chunks
  (ErasureCode.cc:156-203: last data chunk zero-padded to blocksize)
- ``decode(want_to_read, chunks)`` — passthrough when everything wanted is
  available, else decode_chunks (ErasureCode.cc:205)
- ``get_chunk_mapping`` — profile "mapping" D/_ remap (ErasureCode.cc:260)

Under the hood a codec runs its math on one torch device, fixed when it is
made (``load_codec(profile, device=None)``: the CUDA card unless the caller
names another). Besides the byte-oriented host API it exposes a batched
device API (``encode_batch`` / ``decode_batch`` over (B, k, W) packed-word
tensors) that the data path uses to amortize dispatch over many stripes.

Chunks host-side are numpy uint8 arrays keyed by chunk index in dicts,
standing in for the reference's map<int, bufferlist>.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from ..device import resolve, words_to_tensor


class ECError(Exception):
    pass


class ErasureCode:
    """Base codec: profile parsing, padding, passthrough-decode logic."""

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve(device)
        self.profile: dict[str, str] = {}
        self.chunk_mapping: list[int] = []
        self.k = 0
        self.m = 0

    # -------------------------------------------------- contract surface

    def init(self, profile: Mapping[str, str]) -> None:
        """Parse/validate profile. Subclasses call super().init first, set
        k/m, then call _parse_mapping() (it validates against k+m)."""
        self.profile = dict(profile)

    def get_profile(self) -> dict[str, str]:
        return self.profile

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return 1  # scalar codes; CLAY overrides (ErasureCodeInterface.h:259)

    #: When True, get_chunk_size aligns each chunk (ISA-L style,
    #: ErasureCodeIsa.cc:66-79); when False, the whole padded object is
    #: aligned (jerasure style, ErasureCodeJerasure.cc:95-102).
    per_chunk_alignment = False

    def get_alignment(self) -> int:
        """Padded-object (or per-chunk) alignment. Plugins override with
        reference-exact values (e.g. k*w*4 for jerasure matrix codes);
        results must stay multiples of 4 (4*k object-aligned) so chunks
        pack into uint32 words for the device kernels."""
        return 4 * self.k

    def get_chunk_size(self, object_size: int) -> int:
        """ErasureCodeJerasure.cc:80-102 semantics, both branches."""
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = -(-object_size // self.k)
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        if alignment % self.k:
            raise ECError(f"alignment {alignment} not a multiple of k={self.k}")
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        return padded // self.k

    def chunk_index(self, i: int) -> int:
        """Generator index -> stored position (ErasureCodeInterface.h:448)."""
        return self.chunk_mapping[i] if self.chunk_mapping else i

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    def _position_to_generator(self, pos: int) -> int:
        """Stored position -> generator index (inverse of chunk_index)."""
        if not self.chunk_mapping:
            return pos
        try:
            return self.chunk_mapping.index(pos)
        except ValueError:
            raise ECError(f"chunk position {pos} out of range") from None

    # ------------------------------------------------------- minimum sets

    def _minimum_raw(self, want: set[int], available: set[int]) -> list[int]:
        """Chunk indices to fetch: wanted ones when present, else the first
        k available (ErasureCode::_minimum_to_decode semantics)."""
        if want <= available:
            return sorted(want)
        avail = sorted(available)
        if len(avail) < self.k:
            raise ECError(
                f"cannot decode {sorted(want)} from {avail}: "
                f"need {self.k}, have {len(avail)}"
            )
        return avail[: self.k]

    def minimum_to_decode(
        self, want_to_read: Iterable[int], available: Iterable[int]
    ) -> dict[int, list[tuple[int, int]]]:
        """chunk -> [(sub_chunk_offset, count)] (ErasureCodeInterface.h:297).

        Indices are stored positions (like encode's output keys); scalar
        codes always want the whole chunk: [(0, 1)]. The first-k-available
        choice is made directly in stored-position space, matching
        ErasureCode::_minimum_to_decode (ErasureCode.cc) — no generator
        translation (decode_chunks translates internally where needed).
        """
        chosen = self._minimum_raw(set(want_to_read), set(available))
        return {c: [(0, self.get_sub_chunk_count())] for c in chosen}

    def minimum_to_decode_with_cost(
        self, want_to_read: Iterable[int], available: Mapping[int, int]
    ) -> dict[int, list[tuple[int, int]]]:
        """Pick the cheapest k among available (cost map), keeping wanted
        chunks that are present (ErasureCodeInterface.h:300-330)."""
        want = set(want_to_read)
        if want <= set(available):
            return {c: [(0, self.get_sub_chunk_count())] for c in sorted(want)}
        by_cost = sorted(available, key=lambda c: (available[c], c))
        if len(by_cost) < self.k:
            raise ECError(f"need {self.k} chunks, have {len(by_cost)}")
        chosen = by_cost[: self.k]
        return {c: [(0, self.get_sub_chunk_count())] for c in sorted(chosen)}

    # ------------------------------------------------------ encode/decode

    def encode(
        self, want_to_encode: Iterable[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        """Pad + split ``data`` into k chunks, compute m coding chunks,
        return {chunk_index: chunk} restricted to want_to_encode."""
        raw = _as_u8(data)
        blocksize = self.get_chunk_size(raw.size)
        padded = np.zeros(blocksize * self.k, dtype=np.uint8)
        padded[: raw.size] = raw
        chunks = padded.reshape(self.k, blocksize)
        encoded: dict[int, np.ndarray] = {
            self.chunk_index(i): chunks[i] for i in range(self.k)
        }
        coding = self.encode_chunks(chunks)
        for j in range(self.m):
            encoded[self.chunk_index(self.k + j)] = coding[j]
        want = set(want_to_encode)
        return {i: c for i, c in encoded.items() if i in want}

    def decode(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
    ) -> dict[int, np.ndarray]:
        """ErasureCode::_decode: passthrough if every wanted chunk is
        available, else reconstruct from any k chunks.

        Keys of ``chunks`` and returned dict are stored positions (the
        same space as encode's output); decode_chunks itself works in
        generator space, so positions are translated both ways here.
        """
        want = set(want_to_read)
        have = set(chunks)
        if want <= have:
            return {i: _as_u8(chunks[i]) for i in sorted(want)}
        # Fetch-set choice happens in stored-position space (same choice
        # minimum_to_decode makes); decode_chunks works in generator space,
        # so the chosen positions are translated at the boundary.
        use_pos = self._minimum_raw(want, have)
        use = [self._position_to_generator(p) for p in use_pos]
        decoded = self.decode_chunks(
            use, np.stack([_as_u8(chunks[p]) for p in use_pos])
        )
        out: dict[int, np.ndarray] = {}
        for p in sorted(want):
            g = self._position_to_generator(p)
            if p in have:
                out[p] = _as_u8(chunks[p])
            elif g < self.k + self.m:
                out[p] = decoded[g]
            else:
                raise ECError(f"chunk index {p} out of range")
        return out

    def decode_concat(
        self, chunks: Mapping[int, np.ndarray]
    ) -> np.ndarray:
        """Concatenated data chunks in mapping order, padding included
        (ErasureCodeInterface.h:460; caller trims to object size)."""
        want = [self.chunk_index(i) for i in range(self.k)]
        decoded = self.decode(want, chunks)
        return np.concatenate([decoded[i] for i in want])

    def _words(self, data) -> torch.Tensor:
        """A (B, C, W) batch for the batched API as int32 words: a tensor
        as given, numpy uint32 copied to the codec's device."""
        if isinstance(data, torch.Tensor):
            return data
        return words_to_tensor(np.asarray(data), self.device)

    # ---------------------------------------------- subclass obligations

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        """(k, L) uint8 -> (m, L) uint8 coding chunks."""
        raise NotImplementedError

    def decode_chunks(
        self, present: list[int], chunks: np.ndarray
    ) -> dict[int, np.ndarray]:
        """Rebuild every chunk from k surviving ones.

        present: chunk indices of the rows of ``chunks`` (k, L).
        Returns {chunk_index: (L,) uint8} for all k+m chunks.
        """
        raise NotImplementedError

    # ------------------------------------------------------------ helpers

    def _parse_mapping(self) -> None:
        """Profile "mapping" of D (data) / other (coding) position chars
        (ErasureCode::to_mapping, ErasureCode.cc:260-283). Called by
        subclasses after k/m are known; validates length and D count."""
        self.chunk_mapping = []
        mapping = self.profile.get("mapping")
        if not mapping:
            return
        data_pos = [p for p, ch in enumerate(mapping) if ch == "D"]
        coding_pos = [p for p, ch in enumerate(mapping) if ch != "D"]
        if len(mapping) != self.k + self.m or len(data_pos) != self.k:
            raise ECError(
                f"mapping {mapping!r} must have length k+m={self.k + self.m} "
                f"with exactly k={self.k} 'D' positions"
            )
        self.chunk_mapping = data_pos + coding_pos

    def to_int(self, name: str, default: int) -> int:
        v = self.profile.get(name, "")
        if v == "":
            self.profile[name] = str(default)
            return default
        try:
            return int(v)
        except ValueError as e:
            raise ECError(f"profile {name}={v!r} is not an integer") from e

    def to_bool(self, name: str, default: bool) -> bool:
        v = self.profile.get(name, "")
        if v == "":
            self.profile[name] = "true" if default else "false"
            return default
        return v in ("yes", "true", "1")


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)


from .registry import PluginRegistry, instance, load_codec  # noqa: E402,F401
from . import rs_plugin, isa_plugin  # noqa: E402,F401  (self-registering)
from . import lrc_plugin, shec_plugin, clay_plugin  # noqa: E402,F401
from . import bitmatrix_plugin  # noqa: E402,F401
