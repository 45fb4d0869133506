"""ctypes bindings of the host serde kernels (native/serde_kernels.cpp).

Counterpart of presto_tpu/native/kernels.py. The library is compiled
at first use with the host C++ compiler (`$CXX`, else g++; the flags
of presto_tpu/native/Makefile) into presto_tpu_torch/build/, keyed by
a hash of the source and the flags, and loaded once per process. A
failed build or load raises with the compiler's output: there is no
numpy stand-in for the LZ4 codec, and serde/pages.py packs and
unpacks non-null values through this library whichever device ran
the query.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["pack_nonnull", "unpack_nonnull", "lz4_compress",
           "lz4_decompress", "build_library"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "serde_kernels.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build_library() -> str:
    """Compile serde_kernels.cpp into build/serde_kernels-<hash>.so
    unless that file exists; returns its path. Several processes may
    build at once: each writes its own temporary file and renames it."""
    cxx = os.environ.get("CXX", "g++")
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode())
    stem = os.path.join(_BUILD, f"serde_kernels-{digest.hexdigest()[:16]}")
    so = stem + ".so"
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    try:
        proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run the host C++ compiler {cxx!r} for "
                           f"{_SRC}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {_SRC}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            P, I32, I64 = ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64
            lib.pack_nonnull.restype = I64
            lib.pack_nonnull.argtypes = [P, P, I64, I32, P]
            lib.unpack_nonnull.restype = None
            lib.unpack_nonnull.argtypes = [P, P, I64, I32, P]
            lib.lz4_compress.restype = I64
            lib.lz4_compress.argtypes = [P, I64, P, I64]
            lib.lz4_decompress.restype = I64
            lib.lz4_decompress.argtypes = [P, I64, P, I64]
            _lib = lib
    return _lib


def pack_nonnull(values: np.ndarray, nulls: np.ndarray) -> bytes:
    """The bytes of `values` at the rows whose null flag is 0, densely
    (a 1-D array; other shapes take numpy, as in the reference). A
    column without nulls is its own bytes: one copy, no loop."""
    values = np.ascontiguousarray(values)
    nulls = np.ascontiguousarray(nulls, dtype=np.uint8)
    if values.ndim != 1:
        return values[~nulls.astype(bool)].tobytes()
    if not nulls.any():
        return values.tobytes()
    lib = _load()
    width = values.dtype.itemsize
    out = np.empty(values.shape[0] * width, dtype=np.uint8)
    n = lib.pack_nonnull(values.ctypes.data_as(ctypes.c_char_p),
                         nulls.ctypes.data_as(ctypes.c_char_p),
                         values.shape[0], width,
                         out.ctypes.data_as(ctypes.c_char_p))
    return out[: n * width].tobytes()


def unpack_nonnull(packed: np.ndarray, nulls: np.ndarray) -> np.ndarray:
    """Spread dense non-null values back over every row (zeros at the
    nulls), into a new array."""
    nulls_b = np.ascontiguousarray(nulls, dtype=np.uint8)
    packed = np.ascontiguousarray(packed)
    if not nulls_b.any():
        return packed.copy()
    lib = _load()
    out = np.empty(nulls_b.shape[0], dtype=packed.dtype)
    lib.unpack_nonnull(packed.ctypes.data_as(ctypes.c_char_p),
                       nulls_b.ctypes.data_as(ctypes.c_char_p),
                       nulls_b.shape[0], packed.dtype.itemsize,
                       out.ctypes.data_as(ctypes.c_char_p))
    return out


def lz4_compress(data: bytes) -> bytes:
    """One LZ4 block (the public block format) of `data`."""
    lib = _load()
    cap = len(data) + len(data) // 255 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.lz4_compress(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError("lz4_compress: destination too small")
    return out.raw[:n]


def lz4_decompress(data: bytes, uncompressed_size: int) -> bytes:
    """The `uncompressed_size` bytes of one LZ4 block; ValueError when
    the block is malformed or does not fill exactly that size."""
    lib = _load()
    out = ctypes.create_string_buffer(max(uncompressed_size, 1))
    n = lib.lz4_decompress(data, len(data), out, uncompressed_size)
    if n != uncompressed_size:
        raise ValueError("lz4_decompress: malformed block")
    return out.raw[:uncompressed_size]
