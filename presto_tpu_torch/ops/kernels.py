"""Hand-written CUDA kernels, their wrappers and their plain versions.

Counterpart of presto_tpu/ops/pallas_kernels.py. Each kernel's source
lives in ops/csrc/ and is compiled with nvcc for sm_90a on first use
into presto_tpu_torch/build/ (keyed by a hash of the source and flags),
then bound through ctypes to its plain C entry points.

A wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors; there is no fallback from a
failed launch. Each wrapper counts its launches in a module-level
integer, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

__all__ = ["limb_partial_sums", "limb_partial_sums_reference",
           "build_library", "SUM_TILE", "LAUNCHES"]

SUM_TILE = 1024
MAX_GROUPS = 64

# launches of each kernel since the counts were last set to 0
LAUNCHES: Dict[str, int] = {"limb_partial_sums": 0}

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_SMEM_BUDGET = 96 * 1024  # two blocks per SM at the widest tables
_WARPS = 8                # must match kWarps in the source

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_library(name: str) -> str:
    """Compile csrc/<name>.cu into build/<name>-<hash>.so unless that
    file exists; returns its path. The compiler's report (registers,
    shared memory, spills) is kept beside it as <name>-<hash>.log."""
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
    stem = os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:16]}")
    so = stem + ".so"
    with _build_lock:
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


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_library(name))
        for fn in ("limb_partial_sums_i16", "limb_partial_sums_f32"):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
        _libs[name] = lib
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
