"""CLAY plugin: coupled-layer MSR regenerating code (the clay role,
src/erasure-code/clay/ErasureCodeClay.cc semantics; construction from
the public Clay-codes paper, FAST'18).

Parameters (k, m, d): d helpers repair a single lost chunk reading only
1/q of each helper (q = d-k+1) — repair bandwidth d/q sub-chunks vs the
k full chunks an MDS code needs. Internally the k+m (+nu virtual
shortening) chunks sit on a q×t grid of nodes (node = y*q + x,
t = (k+m+nu)/q); each chunk splits into q^t sub-chunks, one per
"plane" z (base-q digit vector z_vec, z_vec[0] most significant).

Structure:
- Uncoupled layer U: per plane z, the q*t node values form one MDS
  codeword (scalar RS with k+nu data, m parity) — decode_uncoupled.
- Coupling: node (x,y) in plane z pairs with node (z_vec[y], y) in the
  companion plane z_sw (digit y swapped to x). The pair's coupled
  values (C, C') and uncoupled values (U, U') form a tiny k=2,m=2 RS
  codeword [C_first, C_second, U_first, U_second] (first = lower x),
  so any two determine the others — the pairwise transform (PFT).
  Vertices with x == z_vec[y] ("dots") are unpaired: C == U.
- decode_layered recovers erasures plane by plane in increasing
  intersection score (number of erased dots in the plane), converting
  C→U for known nodes, MDS-decoding U for erased ones, then U→C.
- Single-chunk repair reads only the q^(t-1) planes with
  z_vec[y_lost] == x_lost from each of d helpers
  (get_repair_subchunks runs) and rebuilds the lost chunk's other
  planes through the pair partners in its own row.

Device stance: every per-plane MDS decode with the same erasure pattern
is the same GF(2^8) matmul — and all sub-chunk values are BYTEWISE lanes
of that algebra, so planes of an intersection-score round AND whole
stripe batches stack along the value axis into ONE matmul
(``_round_mds``). The batched entry points (``encode_crc_batch`` /
``decode_batch`` / ``repair_batch``) take (B, rows, W) int32 word
tensors, bring them to the host, flatten the cell batch into the last
axis of the layered-decode grid, run the exact same pairwise-transform +
layered recovery machinery, and dispatch each score round's MDS as one
stacked recovery matmul: ``ops.rs.gf_matmul`` on the codec's torch
device (the GF(2^8) kernel on the card) on the "device" backend, the C++
host core on the "host" one, whatever the batch's size. The encode's
per-cell CRC32Cs run on the CRC32C kernel over data and parity where
they lie.
Results come back as int32 tensors on the codec's device. The codec is
**cellwise**: each stripe_unit cell is an independent codeword of q^t
sub-chunks, which is what admits it to the striped cell data path; the
scalar host path below stays the bit-exactness oracle the device path
is gated on.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import native
from ..device import tensor_to_words, words_to_tensor
from ..ops import crc32c as crc_ops
from ..ops import gf8, rs
from . import ECError, ErasureCode, _as_u8
from .registry import load_codec, register


@functools.lru_cache(maxsize=32)
def _pft_matrix() -> np.ndarray:
    """4x2 over GF(2^8): chunk_i = M[i] @ [A, B] for the pair code
    [C_first, C_second, U_first, U_second] (k=2, m=2 reed_sol_van)."""
    gen = gf8.vandermonde_rs_matrix(2, 2)
    return np.vstack([np.eye(2, dtype=np.uint8), gen])


def _pft_solve(known: dict[int, np.ndarray], want: list[int]) -> dict[int, np.ndarray]:
    """Solve the pair code: any 2 known chunk roles -> wanted roles."""
    m4 = _pft_matrix()
    rows = sorted(known)[:2]
    sub = m4[rows]
    inv = gf8.gf_mat_inv(sub)
    ab = gf8.gf_matmul(inv, np.stack([known[r] for r in rows]))
    return {w: gf8.gf_matmul(m4[w][None], ab)[0] for w in want}


class CLAYCodec(ErasureCode):
    DEFAULT_K = 4
    DEFAULT_M = 2

    #: each stripe_unit cell is an independent codeword (q^t
    #: sub-chunks) — admits the codec to the striped cell data path
    #: (osd.sinfo_for); arbitrary byte slicing is NOT a codeword
    #: transform, cells are
    cellwise_codeword = True

    #: decode_batch derives the erasure set as the COMPLEMENT of
    #: ``present``, so the PG must hand it every fetched row, not the
    #: first k (fewer erasures = smaller per-plane MDS)
    decode_uses_all_rows = True

    def init(self, profile) -> None:
        super().init(profile)
        self.k = self.to_int("k", self.DEFAULT_K)
        self.m = self.to_int("m", self.DEFAULT_M)
        self.d = self.to_int("d", self.k + self.m - 1)
        self.backend = self.profile.get("backend", "device")
        if self.backend not in ("device", "host", "auto"):
            raise ECError(
                f"backend must be device|host|auto, not {self.backend!r}")
        if self.k < 2 or self.m < 1:
            raise ECError(f"bad clay k={self.k} m={self.m}")
        if not (self.k <= self.d <= self.k + self.m - 1):
            raise ECError(
                f"d={self.d} must be in [k={self.k}, k+m-1="
                f"{self.k + self.m - 1}]"
            )
        self.q = self.d - self.k + 1
        km = self.k + self.m
        self.nu = (self.q - km % self.q) % self.q
        if km + self.nu > 254:
            raise ECError("k+m+nu must be <= 254")
        self.t = (km + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t
        scalar = self.profile.get("scalar_mds", "rs_tpu")
        if scalar == "jerasure":
            scalar = "rs_tpu"
        technique = self.profile.get("technique", "reed_sol_van")
        self.mds = load_codec({
            "plugin": scalar, "technique": technique,
            "k": str(self.k + self.nu), "m": str(self.m),
            "backend": "host",
        }, device=self.device)
        self._parse_mapping()

    # ------------------------------------------------------------ layout

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def profile_key_extra(self) -> tuple:
        """d selects a different grid geometry at the same (k, m) —
        the ECBatcher bucket key appends this."""
        return (self.d,)

    def resolved_backend(self) -> str:
        """Engine for the BATCHED cell APIs: routes the stacked
        per-round MDS matmuls through the device kernels ("device") or
        the multithreaded C++ host core ("host"); "auto" on a CUDA
        device follows the link-economics probe (ec/engine.py), on the
        CPU it is "device". The pairwise transforms are host table
        lookups either way."""
        if self.backend == "auto" and self.device.type == "cuda":
            from . import engine

            return engine.data_path_engine(self.device)
        return "host" if self.backend == "host" else "device"

    def get_alignment(self) -> int:
        # every sub-chunk must stay word-aligned: chunk splits into
        # q^t sub-chunks (get_chunk_size role, ErasureCodeClay.cc:90)
        return self.sub_chunk_no * self.k * 4

    def _node(self, chunk: int) -> int:
        """Chunk index (0..k+m) -> grid node id (virtual nu inserted
        between data and parity)."""
        return chunk if chunk < self.k else chunk + self.nu

    def _chunk(self, node: int) -> int | None:
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None  # virtual shortening node
        return node - self.nu

    def _z_vec(self, z: int) -> list[int]:
        out = [0] * self.t
        for i in range(self.t):
            out[self.t - 1 - i] = z % self.q
            z //= self.q
        return out

    def _z_sw(self, z: int, y: int, new_digit: int, old_digit: int) -> int:
        return z + (new_digit - old_digit) * self.q ** (self.t - 1 - y)

    # ------------------------------------------------------ pairwise ops

    def _pair(self, x: int, y: int, z: int, z_vec: list[int]):
        """Canonical pair for vertex (x, y, z): returns
        ((node_first, z_first), (node_second, z_second)) ordered by x;
        None for unpaired dots (x == z_vec[y])."""
        x2 = z_vec[y]
        if x2 == x:
            return None
        z_sw = self._z_sw(z, y, x, x2)
        a = (y * self.q + x, z)
        b = (y * self.q + x2, z_sw)
        return (a, b) if x < x2 else (b, a)

    # ------------------------------------------------------ encode path

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data_chunks = np.ascontiguousarray(data_chunks, dtype=np.uint8)
        L = data_chunks.shape[1]
        C = self._grid(L)
        for i in range(self.k):
            C[i] = self._split(data_chunks[i])
        erased = {self._node(self.k + j) for j in range(self.m)}
        self._decode_layered(erased, C, L)
        return np.stack([
            self._join(C[self._node(self.k + j)]) for j in range(self.m)
        ])

    def decode_chunks(self, present, chunks: np.ndarray):
        present = list(present)
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        L = chunks.shape[1]
        C = self._grid(L)
        for row, idx in enumerate(present):
            C[self._node(idx)] = self._split(chunks[row])
        erased = {
            self._node(i) for i in range(self.k + self.m)
            if i not in present
        }
        self._decode_layered(erased, C, L)
        return {
            i: self._join(C[self._node(i)])
            for i in range(self.k + self.m)
        }

    def _grid(self, L: int) -> np.ndarray:
        if L % self.sub_chunk_no:
            raise ECError(
                f"chunk length {L} not a multiple of sub_chunk_count "
                f"{self.sub_chunk_no}"
            )
        return np.zeros(
            (self.q * self.t, self.sub_chunk_no, L // self.sub_chunk_no),
            dtype=np.uint8,
        )

    def _split(self, chunk: np.ndarray) -> np.ndarray:
        return chunk.reshape(self.sub_chunk_no, -1)

    @staticmethod
    def _join(grid_row: np.ndarray) -> np.ndarray:
        return grid_row.reshape(-1)

    # --------------------------------------------------- layered decode

    def _decode_layered(self, erased: set[int], C: np.ndarray,
                        L: int, device: bool = False) -> None:
        """decode_layered role: recover C rows for `erased` nodes (grid
        node ids) in place. U is materialized alongside. The last grid
        axis is a flat value lane (scalar callers: one sub-chunk;
        batched callers: the whole stripe batch) — every transform is
        bytewise, so the same code serves both."""
        q, t = self.q, self.t
        erased = set(erased)
        # pad erasures to exactly m with parity nodes (recomputable)
        for i in range(self.k + self.nu, q * t):
            if len(erased) >= self.m:
                break
            erased.add(i)
        if len(erased) > self.m:
            raise ECError(
                f"{len(erased)} erasures exceed m={self.m}"
            )
        U = np.zeros_like(C)
        order = self._plane_order(erased)
        for iscore in range(t + 1):
            planes = [z for z in range(self.sub_chunk_no)
                      if order[z] == iscore]
            # two passes per score round (the reference's two z-loops):
            # every plane of the round completes its MDS before any
            # U->C recovery runs, because a double-erased pair's
            # conversion needs the companion plane's MDS output from
            # the SAME round. Planes of a round have no mutual deps,
            # so the round's MDS solves stack into ONE matmul.
            for z in planes:
                self._plane_c_to_u(erased, z, C, U)
            self._round_mds(erased, planes, U, device)
            for z in planes:
                self._plane_u_to_c(erased, z, C, U)

    def _plane_order(self, erased: set[int]) -> list[int]:
        order = []
        for z in range(self.sub_chunk_no):
            zv = self._z_vec(z)
            order.append(
                sum(1 for i in erased if i % self.q == zv[i // self.q])
            )
        return order

    def _plane_c_to_u(self, erased, z, C, U) -> None:
        """decode_erasures' first half: U for every non-erased node of
        plane z from coupled values (companion C recovered in an
        earlier, lower-score plane when its node is erased)."""
        zv = self._z_vec(z)
        for y in range(self.t):
            for x in range(self.q):
                node = y * self.q + x
                if node in erased:
                    continue
                pair = self._pair(x, y, z, zv)
                if pair is None:  # dot: C == U
                    U[node, z] = C[node, z]
                    continue
                me = 0 if pair[0] == (node, z) else 1
                known = {me: C[node, z],
                         1 - me: C[pair[1 - me][0], pair[1 - me][1]]}
                U[node, z] = _pft_solve(known, [2 + me])[2 + me]

    def _round_mds(self, erased, planes: list[int], U,
                   device: bool = False) -> None:
        """decode_uncoupled, stacked: ONE recovery matmul rebuilds the
        erased nodes' U values across every plane of a score round —
        the per-plane MDS decodes share the erasure pattern, and the
        values are bytewise GF(2^8) lanes, so they concatenate along
        the value axis (this is where a stripe batch amortizes too:
        the lane axis already carries B stripes)."""
        if not planes or not erased:
            return
        present_nodes = [i for i in range(self.q * self.t)
                         if i not in erased]
        want_nodes = sorted(erased)
        # mds generator index: node order = grid order (data+virtual
        # first, then parity) — identical index spaces by construction
        stack = np.stack([U[i][planes] for i in present_nodes])
        flat = np.ascontiguousarray(stack).reshape(
            len(present_nodes), -1)
        out = self._mds_matmul(tuple(present_nodes),
                               tuple(want_nodes), flat, device)
        out = out.reshape(len(want_nodes), len(planes), -1)
        for wi, i in enumerate(want_nodes):
            for zi, z in enumerate(planes):
                U[i, z] = out[wi, zi]

    def _mds_matmul(self, present: tuple[int, ...],
                    want: tuple[int, ...], flat: np.ndarray,
                    device: bool) -> np.ndarray:
        """(P, L) survivor values -> (len(want), L) rebuilt values via
        the cached recovery matrix: a wanted parity node folds into the
        matrix (rs_plugin.decode_matrix_for), so the whole round is one
        stacked matmul — on the device kernels when the batched path
        asked for them (a lane count that is no word multiple is padded
        with zero lanes, which the bytewise matmul keeps apart), else
        the multithreaded C++ host core."""
        rmat = self.mds.decode_matrix_for(present, want)
        lanes = flat.shape[1]
        if device and lanes:
            if lanes % 4:
                flat = np.pad(flat, ((0, 0), (0, -lanes % 4)))
            x = words_to_tensor(rs.pack_u32(flat), self.device)
            out = rs.unpack_u32(tensor_to_words(rs.gf_matmul(rmat, x)))
            return out[:, :lanes]
        return native.rs_matmul(rmat, np.ascontiguousarray(flat),
                                threads=os.cpu_count() or 1)

    def _plane_u_to_c(self, erased, z, C, U) -> None:
        """decode_layered's recovery loop: C for erased nodes of plane
        z (dots copy, type-1 solves with the known companion C, double
        erasures convert both from U)."""
        zv = self._z_vec(z)
        for node in erased:
            x, y = node % self.q, node // self.q
            pair = self._pair(x, y, z, zv)
            if pair is None:
                C[node, z] = U[node, z]
                continue
            node_sw = y * self.q + zv[y]
            z_sw = self._z_sw(z, y, x, zv[y])
            me = 0 if pair[0] == (node, z) else 1
            if node_sw not in erased:
                known = {2 + me: U[node, z],
                         1 - me: C[node_sw, z_sw]}
                C[node, z] = _pft_solve(known, [me])[me]
            elif zv[y] < x:
                # both pair members erased: both U known; convert once
                known = {2: U[pair[0][0], pair[0][1]],
                         3: U[pair[1][0], pair[1][1]]}
                out = _pft_solve(known, [0, 1])
                C[pair[0][0], pair[0][1]] = out[0]
                C[pair[1][0], pair[1][1]] = out[1]

    # ---------------------------------------------------------- repair

    def is_repair(self, want_to_read, available) -> bool:
        """Repair path applies for a single loss when the lost node's
        whole x-row survives and >= d chunks are available
        (ErasureCodeClay::is_repair)."""
        want = set(want_to_read)
        avail = set(available)
        if want <= avail or len(want) != 1:
            return False
        lost = next(iter(want))
        node = self._node(lost)
        y = node // self.q
        for x in range(self.q):
            other = y * self.q + x
            chunk = self._chunk(other)
            if chunk is None or chunk == lost:
                continue
            if chunk not in avail:
                return False
        return len(avail) >= self.d

    def get_repair_subchunks(self, lost_chunk: int) -> list[tuple[int, int]]:
        """(offset, count) runs of the repair planes — z with
        z_vec[y_lost] == x_lost (get_repair_subchunks role)."""
        node = self._node(lost_chunk)
        y, x = node // self.q, node % self.q
        seq = self.q ** (self.t - 1 - y)
        runs = []
        index = x * seq
        for _ in range(self.q ** y):
            runs.append((index, seq))
            index += self.q * seq
        return runs

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return {c: [(0, self.sub_chunk_no)] for c in sorted(want)}
        if self.is_repair(want, avail):
            lost = next(iter(want))
            runs = self.get_repair_subchunks(lost)
            node = self._node(lost)
            y = node // self.q
            chosen: list[int] = []
            for x in range(self.q):  # same-row nodes are mandatory
                chunk = self._chunk(y * self.q + x)
                if chunk is not None and chunk != lost:
                    chosen.append(chunk)
            for c in sorted(avail):
                if len(chosen) >= self.d:
                    break
                if c not in chosen:
                    chosen.append(c)
            return {c: list(runs) for c in sorted(chosen[: self.d])}
        return super().minimum_to_decode(want, avail)

    def decode(self, want_to_read, chunks, chunk_size: int | None = None):
        """Full decode, or the bandwidth-optimal repair path when the
        caller passed repair-plane slices (detected via chunk_size like
        the reference's decode(…, chunk_size))."""
        want = set(want_to_read)
        first = next(iter(chunks.values()), None)
        if (chunk_size is not None and first is not None
                and len(_as_u8(first)) < chunk_size
                and self.is_repair(want, set(chunks))):
            return self.repair(want, chunks)
        return super().decode(want, chunks)

    def repair(self, want_to_read, chunks):
        """Rebuild one lost chunk from d helpers' repair-plane slices
        (repair_one_lost_chunk role)."""
        want = set(want_to_read)
        if len(want) != 1 or len(chunks) < self.d:
            raise ECError("repair needs exactly 1 want and d helpers")
        lost = next(iter(want))
        n_rep = self.sub_chunk_no // self.q
        helpers: dict[int, np.ndarray] = {}
        for c, buf in chunks.items():
            arr = _as_u8(buf)
            if arr.size % n_rep:
                raise ECError("helper slice not a repair-plane multiple")
            helpers[self._node(c)] = arr.reshape(n_rep, -1)
        c_lost = self._repair_core(lost, helpers)
        return {lost: c_lost.reshape(-1)}

    def _repair_core(self, lost: int, helpers: dict[int, np.ndarray],
                     device: bool = False) -> np.ndarray:
        """The plane machinery of repair_one_lost_chunk, over flat
        value lanes: ``helpers`` maps grid node -> (n_rep, L) values
        of its repair planes (ascending z); returns the lost chunk's
        C as (sub_chunk_no, L). L is one sub-chunk for the scalar
        path, B*sub_chunk for the batched one — every transform is
        bytewise so both ride the same code, and each score round's
        MDS solves stack into one matmul (_round_mds)."""
        lost_node = self._node(lost)
        q, t = self.q, self.t
        y0, x0 = lost_node // q, lost_node % q
        repair_planes = [
            z for z in range(self.sub_chunk_no)
            if self._z_vec(z)[y0] == x0
        ]
        plane_row = {z: i for i, z in enumerate(repair_planes)}
        n_rep = len(repair_planes)
        sc = next(iter(helpers.values())).shape[1]
        for v in range(self.k, self.k + self.nu):
            helpers[v] = np.zeros((n_rep, sc), dtype=np.uint8)
        aloof = {
            self._node(c) for c in range(self.k + self.m)
            if c != lost and self._node(c) not in helpers
        }
        erased = {y0 * q + x for x in range(q)} | aloof
        # lost row (q nodes) + aloof (k+m-1-d) = m exactly when d
        # helpers answered — the MDS per plane tolerates no more
        if len(erased) > self.m:
            raise ECError("too many erasures for repair")
        U = np.zeros((q * t, self.sub_chunk_no, sc), dtype=np.uint8)
        C_lost = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        # plane order: intersection score over {lost row? no — lost +
        # aloof dots} (reference counts recovered_data + aloof).
        # Cross-plane reads (an aloof companion's U) always address a
        # STRICTLY lower score — the aloof dot counts in this plane's
        # score and not in the companion's — so planes of one score
        # round are independent and the round's MDS stacks.
        def score(z):
            zv = self._z_vec(z)
            s = sum(1 for n in aloof if n % q == zv[n // q])
            if zv[y0] == x0:
                s += 1
            return s

        rounds: dict[int, list[int]] = {}
        for z in repair_planes:
            rounds.setdefault(score(z), []).append(z)
        for iscore in sorted(rounds):
            planes = rounds[iscore]
            # U at every helper/virtual node of the round's planes
            for z in planes:
                zv = self._z_vec(z)
                for y in range(t):
                    for x in range(q):
                        node = y * q + x
                        if node in erased:
                            continue
                        pair = self._pair(x, y, z, zv)
                        if pair is None:
                            U[node, z] = helpers[node][plane_row[z]]
                            continue
                        node_sw = y * q + zv[y]
                        z_sw = self._z_sw(z, y, x, zv[y])
                        me = 0 if pair[0] == (node, z) else 1
                        if node_sw in aloof:
                            known = {me: helpers[node][plane_row[z]],
                                     3 - me: U[node_sw, z_sw]}
                        else:
                            known = {me: helpers[node][plane_row[z]],
                                     1 - me:
                                     helpers[node_sw][plane_row[z_sw]]}
                        U[node, z] = _pft_solve(known, [2 + me])[2 + me]
            # one stacked MDS for every erased node of every plane in
            # the round
            self._round_mds(erased, planes, U, device)
            # recover lost C: directly on repair planes, via row pair
            # partners on companion planes
            for z in planes:
                zv = self._z_vec(z)
                for node in erased:
                    if node in aloof:
                        continue
                    x, y = node % q, node // q
                    if zv[y] == x:  # the lost node itself (dot here)
                        C_lost[z] = U[node, z]
                        continue
                    # row companion: node_sw is the lost node
                    z_sw = self._z_sw(z, y, x, zv[y])
                    pair = self._pair(x, y, z, zv)
                    me = 0 if pair[0] == (node, z) else 1
                    known = {me: helpers[node][plane_row[z]],
                             2 + me: U[node, z]}
                    C_lost[z_sw] = _pft_solve(known, [1 - me])[1 - me]
        return C_lost

    # ------------------------------------------------- batched cell APIs

    def _cells_to_lanes(self, rows: np.ndarray) -> np.ndarray:
        """(B, n, su) uint8 cells -> (n, sub_chunk_no, B*sc) grid rows:
        the stripe batch folds into the value lane so the layered
        machinery runs once for the whole batch."""
        b, n, su = rows.shape
        sc = su // self.sub_chunk_no
        return np.ascontiguousarray(
            rows.reshape(b, n, self.sub_chunk_no, sc)
            .transpose(1, 2, 0, 3)).reshape(n, self.sub_chunk_no,
                                            b * sc)

    def _lanes_to_cells(self, grid_rows: np.ndarray,
                        b: int) -> np.ndarray:
        """(n, sub_chunk_no, B*sc) grid rows -> (B, n, su) uint8."""
        n, subs, lane = grid_rows.shape
        sc = lane // b
        return np.ascontiguousarray(
            grid_rows.reshape(n, subs, b, sc)
            .transpose(2, 0, 1, 3)).reshape(b, n, subs * sc)

    def _layered_batch(self, present: tuple[int, ...],
                       cells: np.ndarray, want: tuple[int, ...],
                       device: bool) -> np.ndarray:
        """(B, len(present), su) uint8 survivors -> (B, len(want), su)
        via one batch-wide layered decode."""
        b, _, su = cells.shape
        if su % self.sub_chunk_no:
            raise ECError(
                f"cell size {su} not a multiple of sub_chunk_count "
                f"{self.sub_chunk_no}")
        lanes = self._cells_to_lanes(cells)
        C = np.zeros((self.q * self.t, self.sub_chunk_no,
                      lanes.shape[-1]), dtype=np.uint8)
        for row, chunk in enumerate(present):
            C[self._node(chunk)] = lanes[row]
        erased = {
            self._node(i) for i in range(self.k + self.m)
            if i not in present
        }
        self._decode_layered(erased, C, su, device=device)
        out = np.stack([C[self._node(g)] for g in want])
        return self._lanes_to_cells(out, b)

    def _host_cells(self, data) -> np.ndarray:
        """(B, C, W) words, a tensor or numpy uint32 -> (B, C, 4W) uint8
        on the host (the reference's ``np.asarray``)."""
        words = (tensor_to_words(data) if isinstance(data, torch.Tensor)
                 else np.asarray(data, dtype=np.uint32))
        return rs.unpack_u32(words)

    def _device_words(self, cells: np.ndarray) -> torch.Tensor:
        """(B, C, su) uint8 on the host -> int32 words on the codec's
        device."""
        return words_to_tensor(rs.pack_u32(cells), self.device)

    def encode_crc_batch(self, data, cell_bytes: int):
        """(B, k, W) words -> (parity (B, m, W), crcs (B, k+m)) on the
        codec's device. The layered construction runs once for the
        whole batch with each score round's MDS as one stacked matmul;
        the per-cell hinfo CRC32Cs come from one CRC kernel launch over
        data and parity where they lie, rs_plugin-shaped."""
        cells = self._host_cells(data)
        parity = self._encode_cells(
            cells, device=self.resolved_backend() == "device")
        pwords = self._device_words(parity)
        crcs = crc_ops.crc32c_cells_device(self._words(data),
                                           int(cell_bytes), pwords)
        return pwords, crcs

    def _encode_cells(self, cells: np.ndarray,
                      device: bool) -> np.ndarray:
        present = tuple(range(self.k))
        want = tuple(range(self.k, self.k + self.m))
        return self._layered_batch(present, cells, want, device)

    def decode_batch(self, present: tuple[int, ...], surviving,
                     want: tuple[int, ...] | None = None) -> torch.Tensor:
        """(B, k', W) survivor words (rows in ``present`` order, any
        k' >= k) -> (B, len(want), W) words on the codec's device."""
        if want is None:
            want = tuple(range(self.k))
        cells = self._host_cells(surviving)
        out = self._layered_batch(
            tuple(present), cells, tuple(want),
            device=self.resolved_backend() == "device")
        return self._device_words(out)

    def repair_batch(self, present: tuple[int, ...], surviving,
                     want: tuple[int, ...]) -> torch.Tensor:
        """Bandwidth-optimal single-loss repair, batched: surviving
        (B, d, W/q) words — each helper row is its cell's repair
        planes (ascending z, 1/q of the cell); returns the rebuilt
        FULL cells (B, 1, W) as words on the codec's device. One
        recovery storm's stripes amortize into each score round's
        stacked matmul."""
        slices = self._host_cells(surviving)  # (B, d, su/q)
        out = self._repair_cells(
            tuple(present), slices, tuple(want),
            device=self.resolved_backend() == "device")
        return self._device_words(out)

    def _repair_cells(self, present: tuple[int, ...],
                      slices: np.ndarray, want: tuple[int, ...],
                      device: bool) -> np.ndarray:
        if len(want) != 1 or len(present) < self.d:
            raise ECError("repair needs exactly 1 want and d helpers")
        lost = want[0]
        b, _, slice_bytes = slices.shape
        n_rep = self.sub_chunk_no // self.q
        if slice_bytes % n_rep:
            raise ECError("helper slice not a repair-plane multiple")
        sc = slice_bytes // n_rep
        helpers = {
            self._node(c):
            np.ascontiguousarray(
                slices[:, row].reshape(b, n_rep, sc)
                .transpose(1, 0, 2)).reshape(n_rep, b * sc)
            for row, c in enumerate(present)
        }
        c_lost = self._repair_core(lost, helpers, device=device)
        return self._lanes_to_cells(c_lost[None], b)  # (B, 1, su)

    # ------------------------------------------------- batched (host)

    def encode_cells_host(self, cells: np.ndarray) -> np.ndarray:
        """(B, k, su) uint8 -> (B, m, su) uint8 — the batcher's host
        engine (same layered machinery, C++ host matmuls)."""
        return self._encode_cells(
            np.ascontiguousarray(cells, dtype=np.uint8), device=False)

    def decode_cells_host(self, present: tuple[int, ...],
                          want: tuple[int, ...],
                          cells: np.ndarray) -> np.ndarray:
        return self._layered_batch(
            tuple(present),
            np.ascontiguousarray(cells, dtype=np.uint8),
            tuple(want), device=False)

    def repair_cells_host(self, present: tuple[int, ...],
                          want: tuple[int, ...],
                          cells: np.ndarray) -> np.ndarray:
        return self._repair_cells(
            tuple(present),
            np.ascontiguousarray(cells, dtype=np.uint8),
            tuple(want), device=False)


register("clay", CLAYCodec)
