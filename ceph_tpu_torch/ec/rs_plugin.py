"""Reed-Solomon codec plugin ("rs_tpu") — the jerasure-role plugin.

Covers the reference's matrix techniques (ErasureCodeJerasure.h:23-246):
reed_sol_van, reed_sol_r6_op, cauchy_orig, cauchy_good. reed_sol_van and
reed_sol_r6_op are byte-wise GF(2^8) matrix codes exactly as in the
reference; cauchy_orig/cauchy_good use the same Cauchy generator matrices
applied byte-wise (the reference runs them as bit-matrix schedule codes,
so those shards are not wire-compatible with reference-written ones).

Profile ``backend`` picks the engine:
- ``device`` and ``auto`` (the default): the byte API ``encode_chunks`` /
  ``decode_chunks`` runs ``ops.rs.gf_matmul`` on the codec's torch device
  -- the CUDA kernel on the card, its plain version on the CPU (the JAX
  package sends that to its C++ host core).
- ``host``: the byte API runs on the port's C++ host core
  (``native.rs_matmul``).
The EC batcher asks ``resolved_backend``: "host" encodes and decodes with
``native.rs_encode`` / ``native.rs_matmul``, "device" on the kernels.
``auto`` on the card resolves through the host-vs-device probe
(``ec/engine.py``), as in the JAX package; on the CPU it is "device".

Beside the byte API is the batched API the EC backend uses:
``encode_batch`` / ``encode_crc_batch`` / ``decode_batch`` over (B, k, W)
stripe batches on the codec's torch device, one kernel launch for the
whole batch, whatever the backend.

The bit-matrix technique family (liberation, blaum_roth, liber8tion,
cauchy_bm) hands the codec over to ``bitmatrix_plugin.BitmatrixCodec`` at
``init``, as the JAX package does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native
from ..device import words_to_tensor
from ..ops import gf8, rs
from . import ECError, ErasureCode
from .registry import register

TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good")


@functools.lru_cache(maxsize=256)
def _matrix_for(technique: str, k: int, m: int) -> np.ndarray:
    if technique == "reed_sol_van":
        return gf8.vandermonde_rs_matrix(k, m)
    if technique == "reed_sol_r6_op":
        return gf8.raid6_matrix(k)
    if technique == "cauchy_orig":
        return gf8.cauchy_rs_matrix(k, m)
    if technique == "cauchy_good":
        return gf8.cauchy_good_matrix(k, m)
    raise ECError(
        f"technique {technique!r} not supported (know {TECHNIQUES})"
    )


@functools.lru_cache(maxsize=4096)
def _decode_matrix_cached(
    technique: str, k: int, m: int, present: tuple[int, ...]
) -> np.ndarray:
    """Per-erasure-pattern recovery matrix (the ErasureCodeIsaTableCache
    role: matrix inversion amortized across ops with the same pattern)."""
    return gf8.decode_matrix(_matrix_for(technique, k, m), k, present)


@functools.lru_cache(maxsize=4096)
def _want_matrix_cached(
    technique: str, k: int, m: int,
    present: tuple[int, ...], want: tuple[int, ...],
) -> np.ndarray:
    """Recovery matrix producing exactly the ``want`` rows (generator
    indices; parity rows allowed) from k survivors in ``present`` order.
    A wanted parity row j is coding_matrix[j-k] @ recovery_matrix — the
    composition folds host-side, so rebuilding a lost parity chunk is
    still one device matmul."""
    rmat = _decode_matrix_cached(technique, k, m, present)
    mat = _matrix_for(technique, k, m)
    rows = [
        rmat[w] if w < k
        else gf8.gf_matmul(mat[w - k : w - k + 1], rmat)[0]
        for w in want
    ]
    return np.ascontiguousarray(np.stack(rows))


LARGEST_VECTOR_WORDSIZE = 16  # reference ErasureCodeJerasure.cc:30


class RSCodec(ErasureCode):
    """Systematic RS over GF(2^8) with pluggable matrix technique."""

    DEFAULT_K = 7
    DEFAULT_M = 3
    DEFAULT_TECHNIQUE = "reed_sol_van"
    W = 8

    #: GF(2^8) matrix codes act independently on every byte position, so
    #: any slicing of chunks (cells, ranges) encodes/decodes identically
    #: to the whole — the property the stripe-RMW data path relies on.
    bytewise_linear = True

    def init(self, profile) -> None:
        super().init(profile)
        self.technique = self.profile.get(
            "technique", self.DEFAULT_TECHNIQUE
        )
        # jerasure's bit-matrix technique family dispatches to the
        # bitmatrix codec (ErasureCodeJerasure.h:163-246 techniques)
        from .bitmatrix_plugin import BitmatrixCodec

        if self.technique in BitmatrixCodec.DEFAULT_W:
            self.__class__ = BitmatrixCodec
            return self.init(profile)
        self.profile.setdefault("technique", self.technique)
        self.k = self.to_int("k", self.DEFAULT_K)
        self.m = self.to_int("m", self.DEFAULT_M)
        if self.technique == "reed_sol_r6_op":
            self.m = 2  # RAID6 P+Q (ErasureCodeJerasureReedSolomonRAID6)
            self.profile["m"] = "2"
        w = self.to_int("w", 8)
        if w != 8:
            raise ECError(f"only w=8 is supported, got w={w}")
        if self.k < 1 or self.m < 1 or self.k + self.m > 256:
            raise ECError(f"bad k={self.k} m={self.m} (k+m <= 256)")
        self.backend = self.profile.get("backend", "auto")
        if self.backend not in ("device", "host", "auto"):
            raise ECError(
                f"backend must be device|host|auto, not {self.backend!r}")
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", False
        )
        self.matrix = _matrix_for(self.technique, self.k, self.m)
        self._parse_mapping()

    def get_alignment(self) -> int:
        """Reference-exact (ErasureCodeJerasure.cc:174-184 for the matrix
        techniques): w=8 makes (w*4) % 16 == 0, so the shared branch is
        k*w*sizeof(int) = 32k and per-chunk is w*16 = 128."""
        if self.per_chunk_alignment:
            return self.W * LARGEST_VECTOR_WORDSIZE
        return self.k * self.W * 4

    # ----------------------------------------------------- byte interface

    def resolved_backend(self) -> str:
        """The engine the EC batcher runs this codec on: "device"/"host"
        as configured, or for "auto" on a CUDA device the
        measured-economics probe (ec/engine.py — link bandwidth decides).
        "auto" on the CPU is "device": the plain versions, as the tests
        hold them."""
        if self.backend == "auto" and self.device.type == "cuda":
            from . import engine

            return engine.data_path_engine(self.device)
        return "host" if self.backend == "host" else "device"

    def _bytes_matmul(self, matrix: np.ndarray, chunks: np.ndarray) -> np.ndarray:
        """(C, L) uint8 -> (R, L) uint8: the C++ host core for
        backend=host, else gf_matmul on the codec's device. L need not be
        a multiple of 4: the byte-wise code is blind to zero padding,
        which is trimmed off again."""
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        if self.backend == "host":
            return native.rs_matmul(matrix, chunks)
        n = chunks.shape[-1]
        tail = -n % 4
        if tail:
            chunks = np.pad(chunks, ((0, 0), (0, tail)))
        x = words_to_tensor(rs.pack_u32(chunks), self.device)
        out = rs.gf_matmul(matrix, x)
        return rs.unpack_u32(out.cpu().numpy().view(np.uint32))[:, :n]

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        """(k, L) uint8 -> (m, L) uint8 coding chunks."""
        return self._bytes_matmul(self.matrix, data_chunks)

    def decode_chunks(self, present, chunks: np.ndarray):
        present = list(present)
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        if chunks.shape[0] != self.k or len(present) != self.k:
            raise ValueError(
                f"need exactly k={self.k} surviving chunks, got "
                f"{chunks.shape[0]} chunks / {len(present)} indices")
        rmat = _decode_matrix_cached(self.technique, self.k, self.m,
                                     tuple(present))
        data = self._bytes_matmul(rmat, chunks)
        out = {i: data[i] for i in range(self.k)}
        missing_parity = set(range(self.k, self.k + self.m)) - set(present)
        if missing_parity:
            coding = self.encode_chunks(data)
            for j in missing_parity:
                out[j] = coding[j - self.k]
        for row, idx in enumerate(present):
            if idx >= self.k:
                out[idx] = chunks[row]
        return out

    # --------------------------------------------------------- batched

    def encode_batch(self, data) -> torch.Tensor:
        """(B, k, W) words -> (B, m, W) parity, one kernel launch."""
        return rs.encode(self.matrix, self._words(data))

    def encode_crc_batch(self, data, cell_bytes: int):
        """(B, k, W) words -> (parity (B, m, W), crcs (B, k+m)): parity and
        the per-cell CRC32Cs of data+parity, one launch of each kernel."""
        return rs.encode_with_crcs(self.matrix, cell_bytes, self._words(data))

    def encode_crc_batch_mesh(self, data, cell_bytes: int, mesh):
        """encode_crc_batch over a (stripe, width) device mesh: the
        (B, k, W) uint32 batch is staged slot-resident (``chunk_batch``),
        each slot encodes and checksums the block it holds, and both
        results come back as MESH-SHARDED arrays for per-slot consumption
        (parallel/runtime.py)."""
        from ..parallel import runtime

        return runtime.mesh_encode_crc_batch(mesh, self.matrix,
                                             cell_bytes, data)

    def decode_batch_mesh(self, present: tuple[int, ...], surviving,
                          want: tuple[int, ...], mesh, method: str):
        """Collective repair: the stacked recovery matmul for ``want``
        rows from ``present`` survivors, distributed over the mesh —
        survivors resident one chunk-group per width slot, partials
        XOR-combined by ``method`` (allgather / psum_bits) instead of
        gathered through messenger fan-in. Returns the (B, R, W) result
        batch-sharded."""
        from ..parallel import runtime

        rmat = self.decode_matrix_for(present, want)
        return runtime.mesh_decode_cells(mesh, rmat, surviving, method)

    def decode_batch(self, present: tuple[int, ...], surviving,
                     want: tuple[int, ...] | None = None) -> torch.Tensor:
        """(B, k, W) survivors (rows in ``present`` order) -> (B, k, W)
        recovered data, or — with ``want`` — exactly those generator rows
        (parity rows fold into the matrix)."""
        if want is None:
            rmat = _decode_matrix_cached(
                self.technique, self.k, self.m, tuple(present)
            )
        else:
            rmat = self.decode_matrix_for(present, want)
        return rs.gf_matmul(rmat, self._words(surviving))

    def decode_matrix_for(self, present, want) -> np.ndarray:
        """Host recovery matrix mapping survivors (``present`` order,
        generator indices) to the ``want`` generator rows."""
        return _want_matrix_cached(self.technique, self.k, self.m,
                                   tuple(present), tuple(want))


register("rs_tpu", RSCodec)
register("jerasure", RSCodec)  # reference profile-name compatibility
