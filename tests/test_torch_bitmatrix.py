"""The host-built B operands of the two CUDA kernels, run through a plain
torch emulation of each kernel's arithmetic in the kernel's own K and N
order (gather the A operand, sum popc(a & b) over the K-steps, keep the low
bit, pack; for CRC the joins), against the JAX package: the Pallas kernels
in interpret mode, the XLA paths and the lifted bit-matrix. Tolerance:
exact equality (integer-only arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import crc32c as jcrc
from ceph_tpu.ops import rs as jrs
from ceph_tpu_torch import kernels
from ceph_tpu_torch.convert import batch_to_device, batch_to_numpy
from ceph_tpu_torch.ops import crc32c as crc
from ceph_tpu_torch.ops import rs
from test_torch_native import jax_native_whole  # noqa: F401

# The emulations are small tensor ops: one intra-op thread each keeps the
# parallel test workers from spinning every core.
torch.set_num_threads(1)

M32 = 0xFFFFFFFF


def _u64(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy words as int64 tensor values in [0, 2^32)."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64))


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def gf_emulation(matrix: np.ndarray, x: np.ndarray) -> np.ndarray:
    """csrc/gf_matmul.cu's arithmetic: x (B, C, W) uint32 -> (B, R, W).

    A row = one word column, K-step k = words of inputs 8k..8k+7 (fragment
    half h, lane t in group: input 8k + 4h + t); D column n of n-tile j of
    quad q = output row 4q + (n >> 1), bit 2j + (n & 1)."""
    rows, cols = matrix.shape
    b, _, w = x.shape
    frags = _u64(rs.b1_fragments(matrix))  # (quads, ksteps, 16, 32, 2)
    quads, ksteps = frags.shape[:2]
    xp = torch.zeros((b, ksteps * 8, w), dtype=torch.int64)
    xp[:, :cols] = _u64(x)
    a = xp.reshape(b, ksteps, 2, 4, 1, w)  # [b, k, h, t, (n), w]
    out = torch.zeros((b, quads * 4, w), dtype=torch.int64)
    for q in range(quads):
        for j in range(16):
            f = frags[q, :, j].reshape(ksteps, 8, 4, 2)  # [k, n, t, h]
            f = f.permute(0, 3, 2, 1).reshape(1, ksteps, 2, 4, 8, 1)
            acc = _popc(a & f).sum(dim=(1, 2, 3))  # (b, n, w)
            for n in range(8):
                bit = 2 * j + (n & 1)
                out[:, 4 * q + (n >> 1)] |= (acc[:, n] & 1) << bit
    return out[:, :rows].numpy().astype(np.uint32)


def _apply(cols: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x)
    for b in range(32):
        acc ^= ((x >> b) & 1) * int(cols[b])
    return acc


def crc_emulation(*sources: np.ndarray) -> np.ndarray:
    """csrc/crc32c.cu's arithmetic over one or two (B, r, W) uint32 cell
    batches read where they lie -> (B, sum r) seed-0 CRCs.

    Rows of seg words (front-padded), K-step kk of 32-word chunk ch =
    word 8t + 4h + kk of the chunk; D column n of n-tile j = crc bit
    8(n >> 1) + 2j + (n & 1); segments of a row joined by Z_{4 seg}, rows
    of a blob by the tree levels."""
    b, _, w = sources[0].shape
    blobs = np.concatenate([s.reshape(b, -1, w) for s in sources],
                           axis=1).reshape(-1, w)
    seg, subs, nseg = crc.crc_plan(w)
    frags = _u64(crc.b1_fragments(seg))  # (ch, kk, j, lane, h)
    z = crc.join_columns(w)
    n = blobs.shape[0]
    padded = torch.zeros((n, nseg * subs * seg), dtype=torch.int64)
    padded[:, nseg * subs * seg - w:] = _u64(blobs)
    chunks = seg // 32
    # [blob, row, sub, ch, t, h, kk] -> [.., ch, kk, h, t]
    a = padded.reshape(n, nseg, subs, chunks, 4, 2, 4).permute(
        0, 1, 2, 3, 6, 5, 4)
    sub = torch.zeros((n, nseg, subs), dtype=torch.int64)
    for j in range(4):
        for col in range(8):
            f = frags[:, :, j, 4 * col:4 * col + 4, :]  # [ch, kk, t, h]
            f = f.permute(0, 1, 3, 2)  # [ch, kk, h, t]
            acc = _popc(a & f).sum(dim=(3, 4, 5, 6))
            bit = 8 * (col >> 1) + 2 * j + (col & 1)
            sub |= (acc & 1) << bit
    rows = torch.zeros((n, nseg), dtype=torch.int64)
    for l in range(subs):
        rows = _apply(z[0], rows) ^ sub[:, :, l]
    level = 0
    while rows.shape[1] > 1:
        rows = _apply(z[1 + level], rows[:, 0::2]) ^ rows[:, 1::2]
        level += 1
    return rows[:, 0].numpy().astype(np.uint32).reshape(b, -1)


def _jax_crc0(words: np.ndarray) -> np.ndarray:
    """The JAX package's XLA fold; it takes a power-of-two word count, so
    front-pad with zero words (neutral from state 0)."""
    w = words.shape[-1]
    pad = (1 << (w - 1).bit_length()) - w
    padded = np.concatenate(
        [np.zeros(words.shape[:-1] + (pad,), np.uint32), words], axis=-1)
    return np.asarray(jcrc._crc0_words(jnp.asarray(padded)))


def _gf_matrix(rng, r, c):
    mat = rng.integers(0, 256, (r, c), dtype=np.uint8)
    mat[0] = 0  # a zero row
    mat[-1, 0] = 0  # coefficient 0
    mat[-1, -1] = 1  # coefficient 1
    return mat


@pytest.mark.parametrize("w", [1, 257, 1000])
@pytest.mark.parametrize("r,c", [(3, 8), (8, 8), (1, 2), (2, 5), (16, 40),
                                 (4, 240)])
def test_gf_emulation_against_jax(r, c, w):
    rng = np.random.default_rng(1000 * r + c + w)
    mat = _gf_matrix(rng, r, c)
    x = rng.integers(0, 2**32, (2, c, w), dtype=np.uint32)
    got = gf_emulation(mat, x)
    mxu = np.asarray(jrs.gf_matmul_u32_mxu(mat, jnp.asarray(x)))
    assert np.array_equal(got, mxu)
    if w != 1000 or c <= 8:  # Pallas interpret: keep the large cases lean
        pallas = np.asarray(jrs.gf_matmul_pallas(mat, jnp.asarray(x),
                                                 interpret=True))
        assert np.array_equal(got, pallas)
    assert np.array_equal(got, batch_to_numpy(
        rs.gf_matmul(mat, batch_to_device(x, "cpu"))))


@pytest.mark.parametrize("r,c", [(3, 8), (8, 8), (2, 5), (16, 40), (4, 240)])
def test_lifted_bitmatrix_and_fragments(r, c):
    rng = np.random.default_rng(r + c)
    mat = _gf_matrix(rng, r, c)
    assert np.array_equal(rs.lift_bitmatrix(mat),
                          jrs._lift_bitmatrix(mat).astype(np.uint8))
    frags = rs.b1_fragments(mat)
    assert frags.shape == (-(-r // 4), -(-c // 8), 16, 32, 2)
    assert frags.dtype == np.uint32
    # rows past R and inputs past C stay zero in B
    bits = np.unpackbits(frags.view(np.uint8), bitorder="little").reshape(
        frags.shape + (32,))
    lanes = np.arange(32)
    for q in range(frags.shape[0]):
        dead_row = 4 * q + ((lanes >> 2) >> 1) >= r
        assert not bits[q][:, :, dead_row].any()
    for k in range(frags.shape[1]):
        for h in range(2):
            dead_in = 8 * k + 4 * h + (lanes & 3) >= c
            assert not bits[:, k, :, dead_in, h].any()


@pytest.mark.parametrize("w", [1, 3, 100, 257, 16384])
def test_crc_emulation_against_jax(w):
    rng = np.random.default_rng(w + 5)
    words = rng.integers(0, 2**32, (2, w), dtype=np.uint32)
    got = crc_emulation(words[:, None, :])[:, 0]
    assert np.array_equal(got, _jax_crc0(words))
    if w <= 257:
        pallas = np.asarray(jcrc.crc32c_words_pallas(jnp.asarray(words),
                                                     interpret=True))
        assert np.array_equal(got, pallas)


@pytest.mark.parametrize("w", [1, 100, 257, 1024])
def test_two_source_crcs_equal_crcs_of_the_concatenation(w):
    rng = np.random.default_rng(w + 9)
    data = rng.integers(0, 2**32, (2, 4, w), dtype=np.uint32)
    parity = rng.integers(0, 2**32, (2, 3, w), dtype=np.uint32)
    cat = np.concatenate([data, parity], axis=1)
    want = _jax_crc0(cat)
    assert np.array_equal(crc_emulation(data, parity), want)
    got = crc.crc0_cells(batch_to_device(data, "cpu"),
                         batch_to_device(parity, "cpu"))
    assert np.array_equal(batch_to_numpy(got), want)
    seeded = crc.crc32c_cells_device(batch_to_device(data, "cpu"), 4 * w,
                                     batch_to_device(parity, "cpu"))
    assert np.array_equal(batch_to_numpy(seeded),
                          np.asarray(jcrc.crc32c_cells_device(
                              jnp.asarray(cat), 4 * w)))


def test_crc_rows_of_several_segments(monkeypatch):
    """A row longer than one B operand (subs > 1) joins its segments with
    Z_{4 seg}; shrink the kernel's limits to reach that at a small W."""
    monkeypatch.setattr(kernels, "CRC_MAX_SEG", 32)
    monkeypatch.setattr(kernels, "CRC_ROWS", 4)
    w = 300
    assert crc.crc_plan(w) == (32, 3, 4)
    words = np.random.default_rng(3).integers(0, 2**32, (2, w),
                                              dtype=np.uint32)
    want = np.array([jcrc.crc32c_np(b.tobytes(), 0) for b in words],
                    dtype=np.uint32)
    assert np.array_equal(crc_emulation(words[:, None, :])[:, 0], want)


@pytest.mark.parametrize("w", [1, 2, 31, 32, 33, 100, 511, 512, 513, 16384,
                               131072, 131073, 1 << 20, 3_000_001])
def test_crc_plan(w):
    seg, subs, nseg = crc.crc_plan(w)
    assert seg % 32 == 0 and 32 <= seg <= kernels.CRC_MAX_SEG
    assert nseg & (nseg - 1) == 0 and 1 <= nseg <= kernels.CRC_ROWS
    assert subs >= 1 and nseg * subs * seg >= w
    slack = 32 if subs == 1 else seg  # front padding stays small
    assert nseg * subs * seg - w < nseg * (slack + 1)
    assert crc.join_columns(w).shape == (kernels.CRC_LEVELS + 1, 32)
