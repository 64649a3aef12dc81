"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point (K6,
``xor_combine.cu``, has four: one ``Kernel`` each, sharing one library). At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``ceph_tpu_torch/build/`` (named by a digest of its source, every
``csrc`` header it includes and the flags, so a changed source or header
is rebuilt) and loaded with ``ctypes``. Pointers and the
stream pass as ``c_void_p``; the stream is PyTorch's current one. The C
entry point returns ``cudaGetLastError()`` and the wrapper raises on a
nonzero value.

The wrappers take CUDA tensors only. A missing ``nvcc``, a failed build and
a refused launch all raise: nothing here falls back to a plain version.
The ops modules choose between a kernel and its plain version by the
device of the tensor they were given.

Each ``Kernel`` counts its successful launches in ``launches`` (a plain
integer, bumped under the kernel's lock: the EC batcher launches from
several executor threads at once), so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Rows (blob segments) a crc32c.cu block takes at once (its kThreads):
#: the most rows one blob is cut into.
CRC_ROWS = 256
#: log2(CRC_ROWS): the most join levels, one Z operator each.
CRC_LEVELS = 8
#: Most words per segment in crc32c.cu (its kMaxSeg): 64 KiB of B operand.
CRC_MAX_SEG = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
        "ceph_tpu_torch are built at first use on a machine with the "
        "CUDA toolkit")


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def files(self) -> list[Path]:
        """The source and every header it includes from ``csrc``,
        transitively, in the order first met."""
        seen, todo = [], [self.source]
        while todo:
            path = todo.pop(0)
            if path in seen:
                continue
            seen.append(path)
            todo += [CSRC / name for name in _INCLUDE.findall(path.read_text())
                     if (CSRC / name).is_file()]
        return seen

    @property
    def library(self) -> Path:
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in self.files())
            + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD / f"{self.source.stem}-{digest}.so"

    def _start_build(self) -> tuple[subprocess.Popen, Path] | None:
        lib = self.library
        if lib.exists():
            return None
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {self.source.name} (exit "
                f"{proc.returncode}):\n{out}")
        os.replace(tmp, self.library)

    def _bind(self):
        lib = ctypes.CDLL(str(self.library))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def load(self):
        """The bound C entry point, building the library if needed."""
        with self._lock:
            if self._fn is None:
                self._finish_build(self._start_build())
                self._fn = self._bind()
            return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the entry point on ``device``'s current stream; raise on a
        nonzero CUDA error, else count the launch."""
        fn = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError_t {rc}")
        with self._lock:
            self.launches += 1


GF_MATMUL = Kernel("gf_matmul", "gf_matmul.cu", "gf_matmul_launch",
                   [_P, _P, _P, _I, _I, _I, _L, _P])
CRC32C = Kernel("crc32c", "crc32c.cu", "crc32c_launch",
                [_P, _I, _P, _I, _L, _L, _P, _P, _P, _I, _I, _I, _P])
STRAW2 = Kernel("straw2", "straw2.cu", "straw2_launch",
                [_P, _P, _P, _I, _P, _L, _U, _P, _P, _P])
CRUSH_RULE = Kernel("crush_rule", "crush_rule.cu", "crush_rule_launch",
                    [_P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P])
GF2_XOR = Kernel("gf2_xor", "gf2_xor.cu", "gf2_xor_launch",
                 [_P, _P, _P, _L, _I, _I, _I, _L, _P])
#: K6, csrc/xor_combine.cu: four entry points of one library.
XOR_FOLD = Kernel("xor_fold", "xor_combine.cu", "xor_fold_launch",
                  [_P, _P, _I, _L, _P])
BIT_PLANES = Kernel("bit_planes", "xor_combine.cu", "bit_planes_launch",
                    [_P, _P, _L, _P])
PLANE_PARITY_PACK = Kernel("plane_parity_pack", "xor_combine.cu",
                           "plane_parity_pack_launch", [_P, _P, _I, _L, _P])
CRC_JOIN = Kernel("crc_join", "xor_combine.cu", "crc_join_launch",
                  [_P, _P, _P, _I, _L, _U, _P])
KERNELS = (GF_MATMUL, CRC32C, STRAW2, CRUSH_RULE, GF2_XOR, XOR_FOLD,
           BIT_PLANES, PLANE_PARITY_PACK, CRC_JOIN)


def build_all() -> float:
    """Compile every kernel library not yet built, one ``nvcc`` per
    source, all started together; load every entry point. Returns the
    wall seconds it took."""
    t0 = time.perf_counter()
    started, building = [], set()
    for k in KERNELS:
        if k._fn is None:  # the first entry of a source starts its build
            lib = k.library
            started.append((k, None if lib in building else k._start_build()))
            building.add(lib)
    errors = []
    for k, s in started:  # wait for every nvcc, even after a failure
        with k._lock:
            try:
                k._finish_build(s)
                k._fn = k._bind()
            except (RuntimeError, OSError) as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def reset_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0


def _check_words(t: torch.Tensor, ndim: int, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32 packed words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def gf_matmul(x: torch.Tensor, frags: torch.Tensor, rows: int) -> torch.Tensor:
    """x (B, C, W) int32 words on the card, frags the kernel's B operand
    (ceil(rows/4), ceil(C/8), 16, 32, 2) int32 (ops/rs.py b1_fragments) ->
    (B, rows, W) int32: the GF(2^8) product, on the kernel."""
    _check_words(x, 3, "x")
    _check_words(frags, 5, "frags")
    b, cols, w = x.shape
    want = (-(-rows // 4), -(-cols // 8), 16, 32, 2)
    if tuple(frags.shape) != want or frags.device != x.device:
        raise ValueError(f"frags {tuple(frags.shape)} on {frags.device} do "
                         f"not fit x {tuple(x.shape)} on {x.device} and "
                         f"{rows} rows")
    out = torch.empty((b, rows, w), dtype=torch.int32, device=x.device)
    GF_MATMUL.launch(x.device, x.data_ptr(), out.data_ptr(), frags.data_ptr(),
                     b, rows, cols, w)
    return out


#: Most input rows gf2_xor.cu takes: one 4 B word of each row in its 32 KiB
#: of shared memory.
GF2_MAX_ROWS = 8192


def gf2_xor(rows: torch.Tensor, plan: torch.Tensor) -> torch.Tensor:
    """rows (N, C, L) int32 words on the card, plan (R, T) int32 gather
    indices on the same card (index C: the zero row; ops/gf2.py xor_plan)
    -> (N, R, L) int32, out[n, r] = XOR over t of rows_ext[n, plan[r, t]],
    on the kernel."""
    _check_words(rows, 3, "rows")
    _check_words(plan, 2, "plan")
    if plan.device != rows.device or plan.shape[1] < 1:
        raise ValueError(f"plan {tuple(plan.shape)} on {plan.device} does not "
                         f"fit rows {tuple(rows.shape)} on {rows.device}")
    n, c, l = rows.shape
    r, t = plan.shape
    if c > GF2_MAX_ROWS:
        raise ValueError(f"{c} input rows: the kernel takes at most "
                         f"{GF2_MAX_ROWS}")
    out = torch.empty((n, r, l), dtype=torch.int32, device=rows.device)
    GF2_XOR.launch(rows.device, rows.data_ptr(), out.data_ptr(),
                   plan.data_ptr(), n, c, r, t, l)
    return out


def crc32c(src0: torch.Tensor, src1: torch.Tensor | None, frags: torch.Tensor,
           zcols: torch.Tensor, seg: int, subs: int,
           log_nseg: int) -> torch.Tensor:
    """Seed-0 CRC32Cs of the cells of src0 (B, r0, W) and, if given, src1
    (B, r1, W), int32 on the card, read where they lie -> (B, r0 + r1)
    int32, on the kernel. ``frags`` (seg/32, 4, 4, 32, 2) and ``zcols``
    (CRC_LEVELS + 1, 32) come from ops/crc32c.py for this W and cut."""
    _check_words(src0, 3, "src0")
    if src1 is not None:
        _check_words(src1, 3, "src1")
        if (src1.shape[0] != src0.shape[0] or src1.shape[2] != src0.shape[2]
                or src1.device != src0.device):
            raise ValueError(f"src1 {tuple(src1.shape)} on {src1.device} does "
                             f"not pair with src0 {tuple(src0.shape)} on "
                             f"{src0.device}")
    _check_words(frags, 5, "frags")
    _check_words(zcols, 2, "zcols")
    b, r0, w = src0.shape
    r1 = 0 if src1 is None else src1.shape[1]
    if w < 1 or r0 < 1:
        raise ValueError(f"src0 {tuple(src0.shape)} holds no cell words")
    if (tuple(frags.shape) != (seg // 32, 4, 4, 32, 2)
            or tuple(zcols.shape) != (CRC_LEVELS + 1, 32)
            or frags.device != src0.device or zcols.device != src0.device):
        raise ValueError("CRC operands do not fit the kernel")
    out = torch.empty((b, r0 + r1), dtype=torch.int32, device=src0.device)
    CRC32C.launch(src0.device, src0.data_ptr(), r0,
                  None if src1 is None else src1.data_ptr(), r1, b, w,
                  out.data_ptr(), frags.data_ptr(), zcols.data_ptr(), seg,
                  subs, log_nseg)
    return out


#: Widest row crush_rule.cu takes (its kMaxRep): rs codecs take
#: k + m <= 256.
CRUSH_MAX_REP = 256
#: Most lanes of crush_rule.cu that carry one input (its kMaxGroup): a warp.
CRUSH_MAX_GROUP = 32
#: The rule operand of crush_rule.cu (its struct Rule), in order.
CRUSH_RULE_PARAMS = ("root_bno", "firstn", "leaf", "numrep", "choose_type",
                     "tries", "recurse_tries", "vary_r", "stable",
                     "max_depth", "nb", "mi", "nw", "group")


def _check_vec(t: torch.Tensor, dtype, what: str, device=None) -> None:
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def straw2(items: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
           xs: torch.Tensor, r: int, tables: torch.Tensor) -> torch.Tensor:
    """One straw2 choose per x on the kernel: items/ids (n,) int32,
    weights (n,) int32 holding uint32 16.16, xs (N,) int32 holding uint32,
    tables (514,) int64 (ops/crush.py kernel_tables) -> (N,) int32."""
    dev = xs.device
    for t, what in ((items, "items"), (ids, "ids"), (weights, "weights"),
                    (xs, "xs")):
        _check_vec(t, torch.int32, what, dev)
        if t.dim() != 1:
            raise ValueError(f"{what} must be 1-D, got {tuple(t.shape)}")
    _check_vec(tables, torch.int64, "tables", dev)
    n = items.shape[0]
    if n < 1 or ids.shape[0] != n or weights.shape[0] != n:
        raise ValueError(f"bucket of {n} items, {ids.shape[0]} ids and "
                         f"{weights.shape[0]} weights")
    if tables.shape != (514,):
        raise ValueError(f"tables {tuple(tables.shape)} are not (514,)")
    out = torch.empty(xs.shape[0], dtype=torch.int32, device=dev)
    STRAW2.launch(dev, items.data_ptr(), ids.data_ptr(), weights.data_ptr(),
                  n, xs.data_ptr(), xs.shape[0], r & 0xFFFFFFFF,
                  tables.data_ptr(), out.data_ptr())
    return out


def crush_rule(items: torch.Tensor, weights: torch.Tensor,
               sizes: torch.Tensor, btype: torch.Tensor,
               dev_weights: torch.Tensor, xs: torch.Tensor,
               tables: torch.Tensor, params: dict,
               draws: torch.Tensor | None = None) -> torch.Tensor:
    """crush_do_rule for every x on the kernel: the CompiledMap's items
    and weights (nb, mi) int32 (weights holding uint32 16.16), sizes and
    btype (nb,) int32, the reweight vector (nw,) int32 holding uint32,
    xs (N,) int32 holding uint32, tables as ``straw2``; ``params`` gives
    every name of CRUSH_RULE_PARAMS but nb, mi and nw (``group``: the
    lanes that carry one input) -> (N, numrep) int32 rows. ``draws``, a
    (1,) int64 tensor on the card, if given, gains the number of straw2
    draws the launch made."""
    dev = xs.device
    for t, what in ((items, "items"), (weights, "weights"), (sizes, "sizes"),
                    (btype, "btype"), (dev_weights, "dev_weights"),
                    (xs, "xs")):
        _check_vec(t, torch.int32, what, dev)
    _check_vec(tables, torch.int64, "tables", dev)
    if items.dim() != 2 or weights.shape != items.shape:
        raise ValueError(f"items {tuple(items.shape)} and weights "
                         f"{tuple(weights.shape)} must be one (nb, mi)")
    nb, mi = items.shape
    if (sizes.shape != (nb,) or btype.shape != (nb,) or dev_weights.dim() != 1
            or xs.dim() != 1 or tables.shape != (514,)):
        raise ValueError("CRUSH operands do not fit the kernel")
    numrep, group = params["numrep"], params["group"]
    if not 1 <= numrep <= CRUSH_MAX_REP:
        raise ValueError(f"numrep {numrep} outside 1..{CRUSH_MAX_REP}")
    if not 1 <= group <= CRUSH_MAX_GROUP or group & (group - 1):
        raise ValueError(f"group {group} is not a power of two in "
                         f"1..{CRUSH_MAX_GROUP}")
    vals = dict(params, nb=nb, mi=mi, nw=dev_weights.shape[0])
    packed = (ctypes.c_int * len(CRUSH_RULE_PARAMS))(
        *[int(vals[k]) for k in CRUSH_RULE_PARAMS])
    if draws is not None:
        _check_vec(draws, torch.int64, "draws", dev)
        if draws.shape != (1,):
            raise ValueError(f"draws {tuple(draws.shape)} is not (1,)")
    out = torch.empty((xs.shape[0], numrep), dtype=torch.int32, device=dev)
    CRUSH_RULE.launch(dev, items.data_ptr(), weights.data_ptr(),
                      sizes.data_ptr(), btype.data_ptr(),
                      dev_weights.data_ptr(), xs.data_ptr(), xs.shape[0],
                      tables.data_ptr(), out.data_ptr(), packed,
                      None if draws is None else draws.data_ptr())
    return out


def _check_k6(t: torch.Tensor, dtype, shape_ndim: int, what: str,
              device=None) -> None:
    _check_vec(t, dtype, what, device)
    if t.dim() != shape_ndim:
        raise ValueError(f"{what} must be {shape_ndim}-D, got shape "
                         f"{tuple(t.shape)}")


def xor_fold(parts: torch.Tensor) -> torch.Tensor:
    """parts (n, N) int32 words on the card -> (N,) int32, the XOR of the
    n rows, on K6."""
    _check_k6(parts, torch.int32, 2, "parts")
    n, length = parts.shape
    if n < 1:
        raise ValueError("xor_fold needs at least one row")
    out = torch.empty(length, dtype=torch.int32, device=parts.device)
    XOR_FOLD.launch(parts.device, parts.data_ptr(), out.data_ptr(), n, length)
    return out


def bit_planes(x: torch.Tensor) -> torch.Tensor:
    """x (N,) int32 words on the card -> (32, N) uint8, plane b holding
    bit b of each word, on K6."""
    _check_k6(x, torch.int32, 1, "x")
    planes = torch.empty((32, x.shape[0]), dtype=torch.uint8, device=x.device)
    BIT_PLANES.launch(x.device, x.data_ptr(), planes.data_ptr(), x.shape[0])
    return planes


def plane_parity_pack(planes: torch.Tensor) -> torch.Tensor:
    """planes (n, 32, N) uint8 on the card -> (N,) int32 whose bit b is the
    parity of the n planes' sum at (b, i), on K6."""
    _check_k6(planes, torch.uint8, 3, "planes")
    n, bits, length = planes.shape
    if n < 1 or bits != 32:
        raise ValueError(f"planes {tuple(planes.shape)} are not (n, 32, N)")
    out = torch.empty(length, dtype=torch.int32, device=planes.device)
    PLANE_PARITY_PACK.launch(planes.device, planes.data_ptr(), out.data_ptr(),
                             n, length)
    return out


#: Most segments crc_join takes (its kMaxSegments): their columns sit in
#: 32 KiB of shared memory.
CRC_JOIN_MAX_SEGMENTS = 256


def crc_join(parts: torch.Tensor, zcols: torch.Tensor,
             seed_term: int) -> torch.Tensor:
    """parts (w, M) int32 seed-0 segment CRCs on the card, zcols (w, 32)
    int32 columns of each segment's shift operator, seed_term the cell's
    seed contribution -> (M,) int32 CRCs, on K6."""
    _check_k6(parts, torch.int32, 2, "parts")
    _check_k6(zcols, torch.int32, 2, "zcols", parts.device)
    w, m = parts.shape
    if not 1 <= w <= CRC_JOIN_MAX_SEGMENTS or tuple(zcols.shape) != (w, 32):
        raise ValueError(f"parts {tuple(parts.shape)} and zcols "
                         f"{tuple(zcols.shape)} do not fit the kernel")
    out = torch.empty(m, dtype=torch.int32, device=parts.device)
    CRC_JOIN.launch(parts.device, parts.data_ptr(), zcols.data_ptr(),
                    out.data_ptr(), w, m, seed_term & 0xFFFFFFFF)
    return out
