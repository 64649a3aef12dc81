"""SHEC plugin: shingled erasure code (the shec role,
src/erasure-code/shec/ErasureCodeShec.cc semantics).

Profile (k, m, c): k data chunks, m parity chunks, durability c. Each
parity covers only a cyclic *shingle* window of the data chunks —
the generator matrix is a Vandermonde RS coding matrix with entries
outside each parity's window zeroed (shec_reedsolomon_coding_matrix
rule): parity r of a group with (mg, cg) covers data columns in the
cyclic range [r*k/mg, (r+cg)*k/mg). technique=single uses one group
(m, c); technique=multiple (the default) splits parities into two
groups (m1,c1)+(m2,c2) chosen to minimize the reference's
recovery-efficiency metric (shec_calc_recovery_efficiency1: average
of per-data-chunk best window lengths plus window costs, / (k+m)).

The win over plain RS: recovering one lost data chunk reads only the
chunks of one covering parity's window (< k reads). minimum_to_decode
searches parity subsets for the plan with fewest reads, the
shec_make_decoding_matrix mindup search role.

Decode is a GF(2^8) linear solve restricted to the chosen parity rows
and erased columns. The whole codec runs on the host, numpy over
ops/gf8.py, as in the JAX package: it has no batched device API.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np

from ..ops import gf8
from . import ECError, ErasureCode
from .registry import register


def _window(rr: int, k: int, mg: int, cg: int) -> set[int]:
    """Data columns parity rr of group (mg, cg) covers (cyclic)."""
    start = (rr * k) // mg % k
    end = ((rr + cg) * k) // mg % k
    span = ((rr + cg) * k) // mg - (rr * k) // mg
    if span >= k or start == end:
        return set(range(k))
    cols = set()
    cc = start
    while cc != end:
        cols.add(cc)
        cc = (cc + 1) % k
    return cols


def _efficiency(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """shec_calc_recovery_efficiency1 metric (lower = better)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    best = [10**8] * k
    total = 0
    for mg, cg, base in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(mg):
            span = ((rr + cg) * k) // mg - (rr * k) // mg
            for cc in _window(rr, k, mg, cg):
                best[cc] = min(best[cc], span)
            total += span
    return (total + sum(best)) / (k + m1 + m2)


@functools.lru_cache(maxsize=128)
def _shec_matrix(k: int, m: int, c: int, single: bool) -> np.ndarray:
    """(m, k) generator: Vandermonde coding rows windowed to shingles."""
    if single:
        m1, c1 = 0, 0
    else:
        best_key, best_e = None, 100.0
        for c1_try in range(c // 2 + 1):
            for m1_try in range(m + 1):
                c2, m2 = c - c1_try, m - m1_try
                if m1_try < c1_try or m2 < c2:
                    continue
                if (m1_try == 0) != (c1_try == 0) or (m2 == 0) != (c2 == 0):
                    continue
                e = _efficiency(k, m1_try, m2, c1_try, c2)
                if e < 0:
                    continue
                if best_e - e > 1e-12 and e < best_e:
                    best_e = e
                    best_key = (m1_try, c1_try)
        if best_key is None:
            raise ECError(f"no valid shec layout for k={k} m={m} c={c}")
        m1, c1 = best_key
    m2, c2 = m - m1, c - c1
    mat = gf8.vandermonde_rs_matrix(k, m).copy()
    for mg, cg, base in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(mg):
            cover = _window(rr, k, mg, cg)
            for cc in range(k):
                if cc not in cover:
                    mat[base + rr, cc] = 0
    return mat


class SHECCodec(ErasureCode):
    DEFAULT_K = 4
    DEFAULT_M = 3
    DEFAULT_C = 2

    def init(self, profile) -> None:
        super().init(profile)
        self.k = self.to_int("k", self.DEFAULT_K)
        self.m = self.to_int("m", self.DEFAULT_M)
        self.c = self.to_int("c", self.DEFAULT_C)
        technique = self.profile.get("technique", "multiple")
        if technique not in ("single", "multiple"):
            raise ECError(f"shec technique must be single|multiple, "
                          f"not {technique!r}")
        self.profile.setdefault("technique", technique)
        if not (0 < self.c <= self.m <= self.k + self.m <= 256):
            raise ECError(f"bad shec k={self.k} m={self.m} c={self.c}")
        if self.c > self.m:
            raise ECError("c must not exceed m")
        w = self.to_int("w", 8)
        if w != 8:
            raise ECError(f"only w=8 supported, got {w}")
        self.matrix = _shec_matrix(
            self.k, self.m, self.c, technique == "single"
        )
        self._parse_mapping()

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data_chunks = np.ascontiguousarray(data_chunks, dtype=np.uint8)
        return gf8.gf_matmul(self.matrix, data_chunks)

    # --------------------------------------------------------- planning

    def _parity_cols(self, row: int) -> list[int]:
        return [j for j in range(self.k) if self.matrix[row, j]]

    def _plan(self, want: set[int], available: set[int]):
        """Choose parity rows + data reads covering the erasures with
        the fewest total chunk reads (the mindup search). Returns
        (reads, parity_rows, erased_data) or raises."""
        k = self.k
        erased_data = sorted(
            j for j in want if j < k and j not in available
        )
        erased_parity = [
            j - k for j in want if j >= k and j not in available
        ]
        # parities needed to recompute erased parity rows: all their
        # data columns must end up known
        need_cols: set[int] = set(erased_data)
        for r in erased_parity:
            need_cols |= set(self._parity_cols(r))
        avail_parities = [
            r for r in range(self.m) if (k + r) in available
        ]
        # unknown data columns that must be solved for
        unknown = sorted(
            c for c in need_cols if c not in available
        )
        if not unknown:
            reads = set(want & available) | (need_cols & available)
            return reads, [], []
        # exhaustive subset search for the fewest-reads plan (the
        # reference walks all 2^m parity patterns tracking mindup)
        best = None
        for count in range(len(unknown), len(avail_parities) + 1):
            for rows in itertools.combinations(avail_parities, count):
                cols: set[int] = set(unknown)
                for r in rows:
                    cols |= set(self._parity_cols(r))
                solve_cols = sorted(c for c in cols if c not in available)
                if len(solve_cols) > count:
                    continue
                sub = self.matrix[np.ix_(rows, solve_cols)]
                # solvable iff rank == #unknowns over GF(2^8)
                if _gf_rank(sub) < len(solve_cols):
                    continue
                # an erased parity is recomputed from its whole window,
                # so those columns must be read too (need_cols)
                reads = (
                    {k + r for r in rows}
                    | ((cols | need_cols) & available)
                    | (want & available)
                )
                if best is None or len(reads) < best[0]:
                    best = (len(reads), reads, list(rows), solve_cols)
        if best is None:
            raise ECError(
                f"shec cannot decode {sorted(want)} from "
                f"{sorted(available)}"
            )
        return best[1], best[2], best[3]

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return {c: [(0, 1)] for c in sorted(want)}
        reads, _, _ = self._plan(want, avail)
        return {c: [(0, 1)] for c in sorted(reads)}

    # ----------------------------------------------------------- decode

    def decode(self, want_to_read, chunks):
        from . import _as_u8

        want = set(want_to_read)
        by_pos = {p: _as_u8(c) for p, c in chunks.items()}
        if want <= set(by_pos):
            return {p: by_pos[p] for p in sorted(want)}
        reads, rows, solve_cols = self._plan(want, set(by_pos))
        k = self.k
        if solve_cols:
            # rhs_r = parity_r - sum_{known j} M[r,j] d_j ; pick
            # len(solve_cols) independent rows and invert
            sub_all = self.matrix[np.ix_(rows, solve_cols)]
            pick = _independent_rows(sub_all, len(solve_cols))
            rows = [rows[i] for i in pick]
            sub = self.matrix[np.ix_(rows, solve_cols)]
            length = len(next(iter(by_pos.values())))
            rhs = np.zeros((len(rows), length), dtype=np.uint8)
            for i, r in enumerate(rows):
                acc = by_pos[k + r].copy()
                for j in self._parity_cols(r):
                    if j in solve_cols:
                        continue
                    acc = acc ^ gf8.gf_matmul(
                        np.array([[self.matrix[r, j]]], dtype=np.uint8),
                        by_pos[j][None],
                    )[0]
                rhs[i] = acc
            inv = gf8.gf_mat_inv(sub)
            solved = gf8.gf_matmul(inv, rhs)
            for idx, cj in enumerate(solve_cols):
                by_pos[cj] = solved[idx]
        # recompute erased parity chunks from (now) known data
        for p in sorted(want):
            if p >= k and p not in by_pos:
                r = p - k
                cols = self._parity_cols(r)
                coeff = self.matrix[r, cols][None]
                stack = np.stack([by_pos[j] for j in cols])
                by_pos[p] = gf8.gf_matmul(coeff, stack)[0]
        missing = want - set(by_pos)
        if missing:
            raise ECError(f"shec decode left {sorted(missing)}")
        return {p: by_pos[p] for p in sorted(want)}

    def decode_chunks(self, present, chunks):
        by_pos = {p: chunks[i] for i, p in enumerate(present)}
        return self.decode(range(self.k + self.m), by_pos)


def _gf_rank(mat: np.ndarray) -> int:
    """Row-echelon rank over GF(2^8)."""
    a = mat.astype(np.uint8).copy()
    rows, cols = a.shape
    rank = 0
    for c in range(cols):
        pivot = next(
            (r for r in range(rank, rows) if a[r, c]), None
        )
        if pivot is None:
            continue
        a[[rank, pivot]] = a[[pivot, rank]]
        inv = gf8.gf_inv(int(a[rank, c]))
        a[rank] = _row_scale(a[rank], inv)
        for r in range(rows):
            if r != rank and a[r, c]:
                a[r] = a[r] ^ _row_scale(a[rank], int(a[r, c]))
        rank += 1
        if rank == rows:
            break
    return rank


def _row_scale(row: np.ndarray, s: int) -> np.ndarray:
    return np.array([gf8.gf_mul(int(x), s) for x in row], dtype=np.uint8)


def _independent_rows(mat: np.ndarray, need: int) -> list[int]:
    """Indices of `need` linearly independent rows of mat (greedy)."""
    picked: list[int] = []
    for i in range(mat.shape[0]):
        trial = picked + [i]
        if _gf_rank(mat[trial]) == len(trial):
            picked = trial
            if len(picked) == need:
                return picked
    raise ECError("insufficient independent parity rows")


register("shec", SHECCodec)
