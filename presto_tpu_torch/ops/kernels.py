"""Hand-written CUDA kernels, their wrappers and their plain versions.

Counterpart of presto_tpu/ops/pallas_kernels.py. Each kernel's source
lives in ops/csrc/ and is compiled with nvcc for sm_90a on first use
into presto_tpu_torch/build/ (keyed by a hash of the source and flags),
then bound through ctypes to its plain C entry points.

The TPU's limb_partial_sums has two counterparts: limb_partial_sums,
its literal port (per-tile sums of a stacked limb matrix, the group-by's
wide form), and fused_limb_sums, which takes the aggregates' own lanes
and splits the limbs inside the kernel (the narrow form, the default).

A wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors; there is no fallback from a
failed launch. Each wrapper counts its launches in a module-level
integer, so a run can show that it went through the kernel, and hands
each launch to `TRACE_HOOK` when one is set: the kernel audit
(audit/core.py) records a launch, which never reaches the PyTorch
dispatcher, as one op of its trace.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import torch

from ..int128 import _lshr, limbs_of_i64

__all__ = ["limb_partial_sums", "limb_partial_sums_reference",
           "fused_limb_sums", "fused_limb_sums_reference", "LimbRequest",
           "source_field", "limb_count", "contains_bytes",
           "contains_bytes_reference", "build_library", "KERNELS",
           "SUM_TILE", "FUSED_MAX_ROWS_PER_BLOCK", "LAUNCHES", "TRACE_HOOK"]

SUM_TILE = 1024
MAX_GROUPS = 64

# launches of each kernel since the counts were last set to 0
LAUNCHES: Dict[str, int] = {"limb_partial_sums": 0, "fused_limb_sums": 0,
                            "contains_bytes": 0}

# hook(kernel name, tensors read, tensors written) called after each
# launch; None (the default) costs one truth test per launch
TRACE_HOOK = None

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_SMEM_BUDGET = 96 * 1024  # two blocks per SM at the widest tables
_WARPS = 8                # must match kWarps in the source

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_library(name: str) -> str:
    """Compile csrc/<name>.cu into build/<name>-<hash>.so unless that
    file exists; returns its path. The compiler's report (registers,
    shared memory, spills) is kept beside it as <name>-<hash>.log.
    Different kernels may build at the same time, from several
    threads."""
    if name not in _build_locks:
        raise ValueError(f"no kernel source {name!r}; the kernels are "
                         f"{KERNELS}")
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
    stem = os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:16]}")
    so = stem + ".so"
    with _build_locks[name]:
        if os.path.exists(so):
            return so
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{stem}.{os.getpid()}.tmp.so"
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        with open(stem + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    return so


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# the C entry points of each library and their argument types
_SIGNATURES = {
    "limb_partial_sums": {
        "limb_partial_sums_i16": [_P, _P, _P, _LL, _I, _I, _I, _P],
        "limb_partial_sums_f32": [_P, _P, _P, _LL, _I, _I, _I, _P],
    },
    "fused_limb_sums": {
        "fused_limb_sums": [_P, _LL, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P],
    },
    "contains_bytes": {
        "contains_bytes_u8": [_P, _P, ctypes.c_char_p, _I, _P, _LL, _I, _P],
        "contains_bytes_max_width": [],
    },
}


KERNELS = tuple(_SIGNATURES)
_build_locks = {name: threading.Lock() for name in KERNELS}


# seconds this process has spent building and loading kernel libraries
# (a first use pays nvcc, or the load of a cached build); the runner
# reads the delta around each dispatch as the query's compile time
BUILD_SECONDS = {"total": 0.0}


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(build_library(name))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        BUILD_SECONDS["total"] += time.perf_counter() - t0
    return lib


# ---------------------------------------------------------------------------
# limb_partial_sums
# ---------------------------------------------------------------------------

def _check_limb_args(ids: torch.Tensor, limbs: torch.Tensor, groups: int):
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if limbs.dtype not in (torch.int16, torch.float32):
        raise TypeError("limbs must be int16 (8-bit limbs) or float32 "
                        f"(13-bit limbs), got {limbs.dtype}")
    if ids.dim() != 1 or limbs.dim() != 2 or limbs.shape[0] != ids.shape[0]:
        raise ValueError(f"shapes: ids {tuple(ids.shape)}, limbs "
                         f"{tuple(limbs.shape)}")
    if not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"groups must lie in [1, {MAX_GROUPS}], got "
                         f"{groups}")
    if limbs.shape[1] < 1:
        raise ValueError("limbs must have at least one column")
    if ids.device != limbs.device:
        raise ValueError(f"ids on {ids.device}, limbs on {limbs.device}")


def limb_partial_sums(ids: torch.Tensor, limbs: torch.Tensor,
                      groups: int) -> torch.Tensor:
    """(ceil(n / 1024), G, L) float32 per-tile partial sums of `limbs`
    grouped by `ids`; ids outside [0, G) contribute nothing. Every
    entry is an exact integer below 2^23 in magnitude."""
    _check_limb_args(ids, limbs, groups)
    if limbs.device.type == "cpu":
        return limb_partial_sums_reference(ids, limbs, groups)
    if limbs.device.type != "cuda":
        raise ValueError(f"no kernel for device {limbs.device}")
    if not (ids.is_contiguous() and limbs.is_contiguous()):
        raise ValueError("ids and limbs must be contiguous")
    n, L = limbs.shape
    tiles = -(-n // SUM_TILE)
    out = torch.empty((tiles, groups, L), dtype=torch.float32,
                      device=limbs.device)
    if n == 0:
        return out
    chunk = min(L, _SMEM_BUDGET // (_WARPS * groups * 4))
    lib = _library("limb_partial_sums")
    fn = lib.limb_partial_sums_i16 if limbs.dtype == torch.int16 \
        else lib.limb_partial_sums_f32
    with torch.cuda.device(limbs.device):
        stream = torch.cuda.current_stream(limbs.device).cuda_stream
        err = fn(ids.data_ptr(), limbs.data_ptr(), out.data_ptr(), n, groups,
                 L, chunk, stream)
    if err != 0:
        raise RuntimeError(f"limb_partial_sums launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["limb_partial_sums"] += 1
    if TRACE_HOOK is not None:
        TRACE_HOOK("limb_partial_sums", (ids, limbs), (out,))
    return out


def limb_partial_sums_reference(ids: torch.Tensor, limbs: torch.Tensor,
                                groups: int) -> torch.Tensor:
    """Plain PyTorch version: pad to whole tiles, then per tile the
    float32 product one_hot(ids)^T @ limbs, as the TPU kernel computes
    it. Exact: one-hot entries are 0/1 and every partial sum is an
    integer below 2^24 (float32 matmuls must not run in TF32)."""
    n, L = limbs.shape
    tiles = -(-n // SUM_TILE)
    pad = tiles * SUM_TILE - n
    ids_p = torch.nn.functional.pad(ids, (0, pad), value=groups)
    lm = torch.nn.functional.pad(limbs.to(torch.float32), (0, 0, 0, pad))
    gidx = torch.arange(groups, dtype=torch.int32, device=ids.device)
    onehot = (ids_p.reshape(tiles, SUM_TILE, 1) == gidx).to(torch.float32)
    return torch.bmm(onehot.transpose(1, 2), lm.reshape(tiles, SUM_TILE, L))


# ---------------------------------------------------------------------------
# fused_limb_sums
# ---------------------------------------------------------------------------

FUSED_MAX_ROWS_PER_BLOCK = 1 << 24  # int32 limb sums stay exact up to here
LIMB_BITS = 7                       # limbs held in s8: every one in [-128, 127]

# the C entry's kinds of source lane; a (hi, lo) pair is kind 5
_KINDS = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
          torch.int64: 4}
_INT128 = 5
_MAX_SHIFT = 127

# the C entry's own refusals (negative codes), by code
_FUSED_REFUSED = {
    -1: "bad arguments",
    -2: "more than 16 sources, 128 requests or 256 limbs",
    -3: "a lane that is not 16-byte aligned",
    -4: "sources and limbs that do not fit one block's shared memory",
    -5: f"blocks that would sum more than {FUSED_MAX_ROWS_PER_BLOCK} rows "
        "each (int32 limb sums would not be exact)",
}

Source = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class LimbRequest(NamedTuple):
    """One per-group sum of fused_limb_sums: bits [shift, shift + bits)
    of source `source` as an unsigned field, or with `remainder` every
    bit from `shift` up, signed; zero where the bool source `mask` is
    False (-1: no mask)."""
    source: int
    mask: int
    shift: int
    bits: int
    remainder: bool


def limb_count(bits: int) -> int:
    return max(-(-int(bits) // LIMB_BITS), 1)


def source_field(source: Source, shift: int, bits: int,
                 remainder: bool) -> torch.Tensor:
    """The int64 field a request takes from a source lane (bool, int8-64)
    or from the (hi, lo) int64 pair of a 128-bit value, before its mask."""
    if isinstance(source, tuple):
        hi, lo = source
        if shift >= 64:
            x = hi >> (shift - 64)
        elif shift == 0:
            x = lo
        else:
            x = _lshr(lo, shift) | (hi << (64 - shift))
    else:
        x = source.to(torch.int64) >> min(shift, 63)
    if not remainder and bits < 64:
        x = x & ((1 << bits) - 1)
    return x


def _source_lanes(source: Source) -> List[torch.Tensor]:
    return list(source) if isinstance(source, tuple) else [source]


# one launch's limits, as ops/csrc/fused_limb_sums.cu checks them: its
# sources, requests and 7-bit limbs, and the shared memory of its
# descriptors (2,880 bytes), two stages of 1,024 rows (the int32 ids
# and every source lane) and the limb tile (a 1,040-byte column per limb,
# 8 a tile, and one spare)
FUSED_MAX_SOURCES, FUSED_MAX_REQUESTS, FUSED_MAX_LIMBS = 16, 128, 256
_FUSED_MAX_SMEM, _FUSED_CHUNK, _FUSED_COLUMN, _FUSED_DESC = \
    232448, 1024, 1040, 2880


def source_bytes(source: Source) -> int:
    """Bytes a row of a source lane (a 128-bit pair: both lanes)."""
    return sum(t.element_size() for t in _source_lanes(source))


def fused_fits(nsources: int, row_bytes: int, nrequests: int,
               limbs: int) -> bool:
    """Whether one fused_limb_sums launch takes `nsources` sources of
    `row_bytes` bytes a row together, `nrequests` requests and `limbs`
    7-bit limbs (the kernel refuses more)."""
    smem = _FUSED_DESC + 2 * (4 + row_bytes) * _FUSED_CHUNK + \
        (-(-limbs // 8) * 8 + 1) * _FUSED_COLUMN + _FUSED_CHUNK
    return (nsources <= FUSED_MAX_SOURCES and
            nrequests <= FUSED_MAX_REQUESTS and limbs <= FUSED_MAX_LIMBS
            and smem <= _FUSED_MAX_SMEM)


def _check_fused_args(ids: torch.Tensor, sources: Sequence[Source],
                      requests: Sequence[LimbRequest], groups: int):
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"ids must be (n,) int32, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"groups must lie in [1, {MAX_GROUPS}], got "
                         f"{groups}")
    if not sources or not requests:
        raise ValueError("fused_limb_sums needs a source and a request")
    for s in sources:
        if isinstance(s, tuple):
            if len(s) != 2 or any(t.dtype != torch.int64 for t in s):
                raise TypeError("a 128-bit source is an (hi, lo) pair of "
                                "int64 lanes")
        elif s.dtype not in _KINDS:
            raise TypeError(f"source lanes are bool or int8-64, got "
                            f"{s.dtype}")
        for t in _source_lanes(s):
            if t.shape != ids.shape:
                raise ValueError(f"a source of shape {tuple(t.shape)} for "
                                 f"{tuple(ids.shape)} ids")
            if t.device != ids.device:
                raise ValueError(f"ids on {ids.device}, a source on "
                                 f"{t.device}")
    for r in requests:
        if not 0 <= r.source < len(sources):
            raise ValueError(f"request {r} names no source")
        if r.mask != -1 and not (0 <= r.mask < len(sources) and not
                                 isinstance(sources[r.mask], tuple) and
                                 sources[r.mask].dtype == torch.bool):
            raise ValueError(f"request {r}: a mask is a bool source")
        if not (0 <= r.shift <= _MAX_SHIFT and 1 <= r.bits <= 64):
            raise ValueError(f"request {r}: shift must lie in [0, 127] and "
                             "bits in [1, 64]")
    # the kernel's own limits hold for the plain version too, so that a
    # caller the CPU tests pass does not meet them first on the card
    if not fused_fits(len(sources), sum(map(source_bytes, sources)),
                      len(requests),
                      sum(limb_count(r.bits) for r in requests)):
        raise ValueError(f"fused_limb_sums refused: {_FUSED_REFUSED[-2]} "
                         "or the shared memory they need")


def _recombine(tot: torch.Tensor) -> torch.Tensor:
    """(G, R, J) int64 limb totals -> (G, R): sum_j tot[..., j] << 7j,
    wrapping like int64 sums do."""
    shifts = LIMB_BITS * torch.arange(tot.shape[2], dtype=torch.int64,
                                      device=tot.device)
    return (tot << shifts).sum(dim=2)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The lane itself, or a fresh (aligned) copy when its data does not
    start on 16 bytes, as the kernel's 16-byte copies need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_limb_sums(ids: torch.Tensor, sources: Sequence[Source],
                    requests: Sequence[LimbRequest], groups: int,
                    blocks: int = 0) -> torch.Tensor:
    """(G, R) int64: for every request, the exact sum of its field over
    the rows of each group (ids outside [0, G) contribute nothing), the
    limb split and the sums in one pass over the source lanes. `blocks`
    sets the kernel's grid (0: as many blocks as the card holds at
    once)."""
    _check_fused_args(ids, sources, requests, groups)
    if ids.device.type == "cpu":
        return fused_limb_sums_reference(ids, sources, requests, groups)
    if ids.device.type != "cuda":
        raise ValueError(f"no kernel for device {ids.device}")
    J = max(limb_count(r.bits) for r in requests)
    out = torch.zeros((groups, len(requests), J), dtype=torch.int64,
                      device=ids.device)
    ids = _aligned(ids)
    lanes: List[torch.Tensor] = []
    kinds = []
    for s in sources:
        if isinstance(s, tuple):
            hi, lo = s
            lanes += [_aligned(lo), _aligned(hi)]  # the C entry takes lo first
            kinds.append(_INT128)
        else:
            lanes += [_aligned(s), s]
            kinds.append(_KINDS[s.dtype])
    ptrs = (ctypes.c_void_p * len(lanes))(*[t.data_ptr() for t in lanes])
    kind_arr = (ctypes.c_int * len(kinds))(*kinds)
    fields = [v for r in requests
              for v in (r.source, r.mask, r.shift, r.bits, int(r.remainder))]
    req_arr = (ctypes.c_int * len(fields))(*fields)
    lib = _library("fused_limb_sums")
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.fused_limb_sums(
            ids.data_ptr(), ids.shape[0], groups, len(sources), ptrs,
            kind_arr, len(requests), req_arr, J, out.data_ptr(), blocks,
            stream)
    if err < 0:
        raise ValueError(f"fused_limb_sums refused: {_FUSED_REFUSED[err]}")
    if err != 0:
        raise RuntimeError(f"fused_limb_sums launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["fused_limb_sums"] += 1
    if TRACE_HOOK is not None:
        TRACE_HOOK("fused_limb_sums", (ids, *lanes), (out,))
    return _recombine(out)


def fused_limb_sums_reference(ids: torch.Tensor, sources: Sequence[Source],
                              requests: Sequence[LimbRequest],
                              groups: int) -> torch.Tensor:
    """Plain PyTorch version: materialise each request's s8 limbs (7-bit,
    low limbs unsigned, the last the signed remainder) from the same
    descriptors and sum them per group exactly in int64."""
    J = max(limb_count(r.bits) for r in requests)
    idx = torch.where((ids >= 0) & (ids < groups), ids, groups).to(
        torch.int64)
    tot = torch.zeros((groups + 1, len(requests), J), dtype=torch.int64,
                      device=ids.device)
    for ri, r in enumerate(requests):
        x = source_field(sources[r.source], r.shift, r.bits, r.remainder)
        if r.mask != -1:
            x = torch.where(sources[r.mask], x, 0)
        nl = limb_count(r.bits)
        for j, limb in enumerate(limbs_of_i64(x, LIMB_BITS, nl)):
            tot[:, ri, j] = torch.zeros(
                groups + 1, dtype=torch.int64, device=ids.device).index_add_(
                    0, idx, limb.to(torch.int8).to(torch.int64))
    return _recombine(tot[:groups])


# ---------------------------------------------------------------------------
# contains_bytes
# ---------------------------------------------------------------------------

# the C entry's own refusals (negative codes), by code
_CONTAINS_REFUSED = {
    -1: "bad arguments",
    -2: "a needle longer than the kernel takes (kMaxNeedle)",
    -3: "a row too wide for one block's shared memory (three one-row "
        "stages, the needle, the queues and the flags in 227 KB)",
}


def _check_contains_args(chars: torch.Tensor, lengths: torch.Tensor,
                         needle: bytes):
    if chars.dtype != torch.uint8 or chars.dim() != 2:
        raise TypeError(f"chars must be a 2-D uint8 matrix, got "
                        f"{chars.dtype} {tuple(chars.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != chars.shape[:1]:
        raise TypeError(f"lengths must be ({chars.shape[0]},) int32, got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if not isinstance(needle, (bytes, bytearray)):
        raise TypeError(f"needle must be bytes, got {type(needle)}")
    if chars.device != lengths.device:
        raise ValueError(f"chars on {chars.device}, lengths on "
                         f"{lengths.device}")


def contains_bytes(chars: torch.Tensor, lengths: torch.Tensor,
                   needle: bytes) -> torch.Tensor:
    """(N,) bool: `needle` occurs within the first lengths[i] bytes of
    row i of the (N, W) chars matrix. A needle longer than W gives all
    False without a launch; an empty needle matches every row (W >= 1)
    whose length is not negative. The kernel takes needles of up to
    1024 bytes and rows as wide as its shared memory allows (about
    75,000 bytes: contains_bytes_max_width() of its library), at any
    base alignment; it raises ValueError beyond those."""
    _check_contains_args(chars, lengths, needle)
    n, w = chars.shape
    L = len(needle)
    if max(L, 1) > w:
        return torch.zeros(n, dtype=torch.bool, device=chars.device)
    if chars.device.type == "cpu":
        return contains_bytes_reference(chars, lengths, needle)
    if chars.device.type != "cuda":
        raise ValueError(f"no kernel for device {chars.device}")
    if not (chars.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("chars and lengths must be contiguous")
    out = torch.empty(n, dtype=torch.bool, device=chars.device)
    if n == 0:
        return out
    lib = _library("contains_bytes")
    with torch.cuda.device(chars.device):
        stream = torch.cuda.current_stream(chars.device).cuda_stream
        err = lib.contains_bytes_u8(chars.data_ptr(), lengths.data_ptr(),
                                    bytes(needle), L, out.data_ptr(), n, w,
                                    stream)
    if err < 0:
        limit = f" (W up to {lib.contains_bytes_max_width()})" \
            if err == -3 else ""
        raise ValueError(f"contains_bytes refused W={w}, L={L}: "
                         f"{_CONTAINS_REFUSED[err]}{limit}")
    if err != 0:
        raise RuntimeError(f"contains_bytes launch failed: CUDA error {err}")
    LAUNCHES["contains_bytes"] += 1
    if TRACE_HOOK is not None:
        TRACE_HOOK("contains_bytes", (chars, lengths), (out,))
    return out


def contains_bytes_reference(chars: torch.Tensor, lengths: torch.Tensor,
                             needle: bytes) -> torch.Tensor:
    """Plain PyTorch version: the window gather of contains_pattern's
    XLA form, (N, windows, L) bytes against the needle, with the
    kernel's empty-needle rule (L = 0 matches at window 0)."""
    n, w = chars.shape
    L = len(needle)
    if max(L, 1) > w:
        return torch.zeros(n, dtype=torch.bool, device=chars.device)
    windows = w - L + 1
    start = torch.arange(windows, dtype=torch.int64, device=chars.device)
    idx = start[:, None] + torch.arange(L, dtype=torch.int64,
                                        device=chars.device)[None, :]
    pat = torch.tensor(list(needle), dtype=torch.uint8, device=chars.device)
    match = (chars[:, idx] == pat).all(dim=2)  # (N, windows)
    ends_ok = (start + L)[None, :] <= lengths[:, None].to(torch.int64)
    return (match & ends_ok).any(dim=1)
