"""SerializedPage wire format: the byte contract of the worker exchange.

Counterpart of presto_tpu/serde/pages.py (`PageCodec`, `serialize_page`,
`serialize_batch`, `deserialize_page`, `deserialize_to_arrays`), written
from the public format specification
(presto-docs/src/main/sphinx/develop/serialized-page.rst):

  header: rows(i32) codec(u8: 1=compressed 2=encrypted 4=checksummed)
          uncompressed_size(i32) size(i32) checksum(u64-le)
  then:   column_count(i32), per column: name_len(i32) + encoding name
          + encoding-specific payload.

The checksum is CRC32 over [payload, codec, rows, uncompressed_size].
A page is byte-equal to the reference's for the same columns and
codec, so either package reads the other's pages.

Encodings: BYTE/SHORT/INT/LONG/INT128_ARRAY, VARIABLE_WIDTH, ARRAY,
MAP and ROW both ways; DICTIONARY and RLE are read. Non-null fixed
width values are packed and unpacked by the host serde kernels
(native/serde_kernels.cpp, built at first use), as the reference does
where its library is built. Compression: zstd through `zstandard`
where it imports, else zlib (the reference's rule, with the same codec
flags), zlib, and lz4, the LZ4 block codec of the same host library
(a page is byte-equal to the reference's).
"""

from __future__ import annotations

import dataclasses
import struct
import time
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import failpoints
from .. import types as T
from ..block import Batch, to_numpy
from ..native import kernels as nk

__all__ = ["PageCodec", "serialize_page", "deserialize_page",
           "serialize_batch", "deserialize_to_arrays", "deserialize_block"]

_COMPRESSED = 1
_ENCRYPTED = 2
_CHECKSUMMED = 4
_HEADER = 21  # struct "<iBiiq"

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_zstd_mod = None  # unresolved; False once the import failed


def _zstd():
    """The `zstandard` module, or None where it is not installed (the
    codec then degrades to zlib). A failed import is remembered: it
    would otherwise be retried on every page."""
    global _zstd_mod
    if _zstd_mod is None:
        try:
            import zstandard
            _zstd_mod = zstandard
        except ImportError:
            _zstd_mod = False
    return _zstd_mod or None


def _bounded_zlib(payload: bytes, uncompressed_size: int) -> bytes:
    """zlib inflate bounded by the page's declared size: a page that
    inflates past it, or a stream that ends early, is refused."""
    d = zlib.decompressobj()
    out = d.decompress(payload, uncompressed_size + 1)
    if len(out) > uncompressed_size:
        raise ValueError(
            "zlib page inflates past its declared uncompressed size "
            f"({uncompressed_size} bytes)")
    if not d.eof:
        raise ValueError(
            "truncated zlib page: stream ended before its compressed "
            "data was complete")
    return out


_FIXED_ENC = {1: b"BYTE_ARRAY", 2: b"SHORT_ARRAY", 4: b"INT_ARRAY",
              8: b"LONG_ARRAY", 16: b"INT128_ARRAY"}
_ENC_WIDTH = {v: k for k, v in _FIXED_ENC.items()}
_INT_OF_WIDTH = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


@dataclasses.dataclass
class PageCodec:
    compression: Optional[str] = None  # None | "zstd" | "zlib" | "lz4"
    checksum: bool = True

    def compress(self, payload: bytes) -> bytes:
        if self.compression == "zstd":
            z = _zstd()
            if z is None:
                return zlib.compress(payload)
            return z.ZstdCompressor().compress(payload)
        if self.compression == "zlib":
            return zlib.compress(payload)
        if self.compression == "lz4":
            return nk.lz4_compress(payload)
        raise ValueError(self.compression)

    def decompress(self, payload: bytes, uncompressed_size: int) -> bytes:
        if self.compression == "zstd":
            # a node without zstandard sends zlib under the zstd codec:
            # the frame magic tells the two apart
            if payload[:4] != _ZSTD_MAGIC:
                return _bounded_zlib(payload, uncompressed_size)
            z = _zstd()
            if z is None:
                raise RuntimeError(
                    "page is zstd-compressed but the `zstandard` "
                    "module is not installed on this node")
            return z.ZstdDecompressor().decompress(
                payload, max_output_size=uncompressed_size)
        if self.compression == "zlib":
            return _bounded_zlib(payload, uncompressed_size)
        if self.compression == "lz4":
            return nk.lz4_decompress(payload, uncompressed_size)
        raise ValueError(self.compression)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _bitpack_nulls(nulls: np.ndarray) -> bytes:
    """The has-nulls byte, then the flags packed eight to a byte, the
    first row in the high bit (the spec's order)."""
    if not nulls.any():
        return b"\x00"
    return b"\x01" + np.packbits(np.asarray(nulls, dtype=np.uint8)).tobytes()


def _enc(name: bytes) -> bytes:
    return struct.pack("<i", len(name)) + name


def _serialize_fixed(values: np.ndarray, nulls: np.ndarray) -> bytes:
    if values.dtype == np.bool_:
        values = values.astype(np.int8)
    return b"".join([_enc(_FIXED_ENC[values.dtype.itemsize]),
                     struct.pack("<i", values.shape[0]),
                     _bitpack_nulls(nulls),
                     nk.pack_nonnull(values, nulls)])


def _serialize_int128(vals: np.ndarray, nulls: np.ndarray) -> bytes:
    """Long decimals: INT128_ARRAY of (lo, hi) u64 pairs per non-null
    row; `vals` holds Python ints (or int64s)."""
    nn = [int(v) for v, m in zip(vals, nulls) if not m]
    mask = (1 << 64) - 1
    pairs = np.array([(v & mask, (v >> 64) & mask) for v in nn],
                     dtype=np.uint64).reshape(-1, 2)
    return b"".join([_enc(_FIXED_ENC[16]), struct.pack("<i", len(vals)),
                     _bitpack_nulls(nulls), pairs.tobytes()])


def _serialize_varwidth(vals: np.ndarray, nulls: np.ndarray) -> bytes:
    """`vals`: an object array of str or bytes. The offsets are each
    row's END offset (the spec)."""
    encoded = [b"" if (m or v is None)
               else (v.encode("utf-8") if isinstance(v, str) else bytes(v))
               for v, m in zip(vals, nulls)]
    lengths = np.array([len(b) for b in encoded], dtype=np.int64)
    blob = b"".join(encoded)
    return b"".join([_enc(b"VARIABLE_WIDTH"), struct.pack("<i", len(vals)),
                     np.cumsum(lengths).astype(np.int32).tobytes(),
                     _bitpack_nulls(nulls), struct.pack("<i", len(blob)),
                     blob])


def _serialize_column(ty: T.Type, vals, nulls) -> bytes:
    """One column by its type: the encoding the reference picks."""
    nulls = np.asarray(nulls, dtype=bool)
    if ty.is_string:
        return _serialize_varwidth(np.asarray(vals, dtype=object), nulls)
    if ty.base == "array":
        return _serialize_array(np.asarray(vals, dtype=object), nulls, ty)
    if ty.base == "map":
        return _serialize_map(np.asarray(vals, dtype=object), nulls, ty)
    if ty.base == "row":
        return _serialize_row(np.asarray(vals, dtype=object), nulls, ty)
    if ty.is_decimal and not ty.is_short_decimal:
        return _serialize_int128(np.asarray(vals, dtype=object), nulls)
    return _serialize_fixed(np.asarray(vals, dtype=ty.to_dtype()), nulls)


def _serialize_array(vals: np.ndarray, nulls: np.ndarray,
                     ty: T.Type) -> bytes:
    """ARRAY (ArrayBlockEncoding.java): the flattened element block,
    the row count, N+1 offsets, the null flags."""
    flat, offsets = [], [0]
    for v, m in zip(vals, nulls):
        if not (m or v is None):
            flat.extend(v)
        offsets.append(len(flat))
    fnulls = np.array([e is None for e in flat], dtype=bool)
    elem_ty = ty.element_type
    if elem_ty.is_string:
        fvals = np.array(["" if e is None else e for e in flat],
                         dtype=object)
    elif elem_ty.is_decimal and not elem_ty.is_short_decimal:
        fvals = np.array([0 if e is None else e for e in flat],
                         dtype=object)
    else:
        fvals = np.array([0 if e is None else e for e in flat],
                         dtype=elem_ty.to_dtype())
    return b"".join([_enc(b"ARRAY"),
                     _serialize_column(elem_ty, fvals, fnulls),
                     struct.pack("<i", len(vals)),
                     np.asarray(offsets, dtype=np.int32).tobytes(),
                     _bitpack_nulls(nulls)])


def _serialize_map(vals: np.ndarray, nulls: np.ndarray,
                   ty: T.Type) -> bytes:
    """MAP (MapBlockEncoding.java): the key block, the value block, the
    hash table's length (-1: none), the row count, N+1 offsets, the
    null flags. `vals`: an object array of dicts."""
    flat_k, flat_v, flat_vn, offsets = [], [], [], [0]
    for v, m in zip(vals, nulls):
        if not (m or v is None):
            for k, x in v.items():
                flat_k.append(k)
                flat_v.append(0 if x is None else x)
                flat_vn.append(x is None)
        offsets.append(len(flat_k))
    return b"".join([
        _enc(b"MAP"),
        _serialize_column(ty.key_type, flat_k,
                          np.zeros(len(flat_k), dtype=bool)),
        _serialize_column(ty.value_type, flat_v,
                          np.asarray(flat_vn, dtype=bool)),
        struct.pack("<i", -1),
        struct.pack("<i", len(vals)),
        np.asarray(offsets, dtype=np.int32).tobytes(),
        _bitpack_nulls(nulls)])


def _serialize_row(vals: np.ndarray, nulls: np.ndarray,
                   ty: T.Type) -> bytes:
    """ROW (RowBlockEncoding.java): the field count, each field's block
    over the non-null rows, the row count, N+1 offsets, the null
    flags. `vals`: an object array of tuples."""
    present = [v for v, m in zip(vals, nulls) if not (m or v is None)]
    offsets = np.concatenate([[0], np.cumsum(
        [0 if (m or v is None) else 1 for v, m in zip(vals, nulls)])])
    parts = [_enc(b"ROW"), struct.pack("<i", len(ty.field_types))]
    for fi, fty in enumerate(ty.field_types):
        fvals = [v[fi] for v in present]
        parts.append(_serialize_column(
            fty, [0 if x is None else x for x in fvals],
            np.array([x is None for x in fvals], dtype=bool)))
    parts += [struct.pack("<i", len(vals)),
              offsets.astype(np.int32).tobytes(), _bitpack_nulls(nulls)]
    return b"".join(parts)


def _checksum(payload: bytes, codec_flags: int, rows: int,
              uncompressed: int) -> int:
    crc = zlib.crc32(payload)
    crc = zlib.crc32(struct.pack("<B", codec_flags), crc)
    crc = zlib.crc32(struct.pack("<i", rows), crc)
    return zlib.crc32(struct.pack("<i", uncompressed), crc)


def _observe_serde(op: str, seconds: float, nbytes: int) -> None:
    """A page's serde work, as in the reference: the
    presto_tpu_page_serde_seconds histogram, and the datapath hop
    (serialization `exchange_serialize`, deserialization `decode`) over
    the page's wire bytes."""
    from ..exec.datapath import record_hop
    from ..server.metrics import observe_histogram
    observe_histogram("presto_tpu_page_serde_seconds", seconds,
                      labels={"op": op})
    record_hop("exchange_serialize" if op == "serialize" else "decode",
               nbytes, seconds)


def serialize_page(columns: Sequence[Tuple[T.Type, np.ndarray, np.ndarray]],
                   codec: PageCodec = PageCodec()) -> bytes:
    """(type, values, nulls) per column -> one SerializedPage. The
    payload is compressed only where that makes it smaller."""
    t_page0 = time.time()
    rows = len(columns[0][1]) if columns else 0
    payload = b"".join([struct.pack("<i", len(columns))] +
                       [_serialize_column(ty, v, n)
                        for ty, v, n in columns])
    uncompressed = len(payload)
    flags = 0
    if codec.compression:
        compressed = codec.compress(payload)
        if len(compressed) < uncompressed:
            payload = compressed
            flags |= _COMPRESSED
    checksum = 0
    if codec.checksum:
        flags |= _CHECKSUMMED
        checksum = _checksum(payload, flags, rows, uncompressed)
    page = struct.pack("<iBiiq", rows, flags, uncompressed, len(payload),
                       checksum) + payload
    if failpoints.ARMED:
        # corrupt_page flips payload bytes after the checksum is stamped
        page = failpoints.hit("serde.serialize", page)
    _observe_serde("serialize", time.time() - t_page0, len(page))
    return page


def serialize_batch(batch: Batch, codec: PageCodec = PageCodec()) -> bytes:
    """The ACTIVE rows of a device batch as one page: the wire format
    has no padding."""
    act = batch.active.cpu().numpy()
    cols = []
    for c in range(batch.num_columns):
        v, n = to_numpy(batch.column(c))
        cols.append((batch.column(c).type, v[act], n[act]))
    return serialize_page(cols, codec)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _bitunpack_nulls(buf: memoryview, pos: int, rows: int
                     ) -> Tuple[np.ndarray, int]:
    has = buf[pos]
    pos += 1
    if not has:
        return np.zeros(rows, dtype=bool), pos
    nbytes = (rows + 7) // 8
    bits = np.unpackbits(np.frombuffer(buf[pos:pos + nbytes], dtype=np.uint8))
    return bits[:rows].astype(bool), pos + nbytes


def _item(v):
    return v.item() if isinstance(v, np.generic) else v


def _i32(mv: memoryview, pos: int) -> Tuple[int, int]:
    return struct.unpack_from("<i", mv, pos)[0], pos + 4


def _offsets(mv: memoryview, pos: int, rows: int) -> Tuple[np.ndarray, int]:
    n = (rows + 1) * 4
    return np.frombuffer(mv[pos:pos + n], dtype=np.int32), pos + n


def _decode_fixed(mv, pos, width, ty):
    rows, pos = _i32(mv, pos)
    nulls, pos = _bitunpack_nulls(mv, pos, rows)
    n_nonnull = rows - int(nulls.sum())
    if width == 16:
        # INT128_ARRAY: (lo, hi) pairs -> Python ints in an object array
        pairs = np.frombuffer(mv[pos:pos + n_nonnull * 16],
                              dtype=np.int64).reshape(-1, 2)
        pos += n_nonnull * 16
        vals = np.zeros(rows, dtype=object)
        vals[~nulls] = [int(hi) * (1 << 64) + int(lo)
                        for lo, hi in zip(pairs[:, 0].astype(np.uint64),
                                          pairs[:, 1])]
        return (vals, nulls), pos
    dt = np.dtype(ty.to_dtype()) if ty is not None \
        else np.dtype(_INT_OF_WIDTH[width])
    raw = np.frombuffer(mv[pos:pos + n_nonnull * width],
                        dtype=dt if dt.itemsize == width
                        else _INT_OF_WIDTH[width])
    pos += n_nonnull * width
    vals = nk.unpack_nonnull(raw, nulls)
    if dt == np.bool_:
        vals = vals.astype(bool)
    elif vals.dtype != dt and dt.itemsize == width:
        vals = vals.view(dt)
    return (vals, nulls), pos


def _decode_varwidth(mv, pos):
    rows, pos = _i32(mv, pos)
    ends = np.frombuffer(mv[pos:pos + rows * 4], dtype=np.int32)
    pos += rows * 4
    nulls, pos = _bitunpack_nulls(mv, pos, rows)
    blob_len, pos = _i32(mv, pos)
    blob = bytes(mv[pos:pos + blob_len])
    pos += blob_len
    starts = np.concatenate([[0], ends[:-1]]) if rows else ends
    vals = np.array([blob[s:e].decode("utf-8", "replace")
                     for s, e in zip(starts, ends)], dtype=object)
    return (vals, nulls), pos


def _nested_type(ty, base):
    return ty if ty is not None and ty.base == base else None


def deserialize_block(mv: memoryview, pos: int, ty: Optional[T.Type]):
    """One block at `pos` -> ((values, nulls), the position after it).
    `ty` picks the dtype: the encoding alone cannot tell BIGINT from
    DOUBLE."""
    name_len, pos = _i32(mv, pos)
    enc = bytes(mv[pos:pos + name_len])
    pos += name_len
    if enc in _ENC_WIDTH:
        return _decode_fixed(mv, pos, _ENC_WIDTH[enc], ty)
    if enc == b"VARIABLE_WIDTH":
        return _decode_varwidth(mv, pos)
    if enc == b"DICTIONARY":
        rows, pos = _i32(mv, pos)
        (dvals, dnulls), pos = deserialize_block(mv, pos, ty)
        idx = np.frombuffer(mv[pos:pos + rows * 4], dtype=np.int32)
        pos += rows * 4 + 24  # the indices, then the dictionary's id
        return (dvals[idx], dnulls[idx]), pos
    if enc == b"RLE":
        rows, pos = _i32(mv, pos)
        (dvals, dnulls), pos = deserialize_block(mv, pos, ty)
        return (np.repeat(dvals[:1], rows), np.repeat(dnulls[:1], rows)), pos
    if enc == b"ARRAY":
        aty = _nested_type(ty, "array")
        (evals, enulls), pos = deserialize_block(
            mv, pos, aty.element_type if aty else None)
        rows, pos = _i32(mv, pos)
        offsets, pos = _offsets(mv, pos, rows)
        nulls, pos = _bitunpack_nulls(mv, pos, rows)
        vals = np.empty(rows, dtype=object)
        for i in range(rows):
            vals[i] = None if nulls[i] else [
                None if enulls[k] else _item(evals[k])
                for k in range(offsets[i], offsets[i + 1])]
        return (vals, nulls), pos
    if enc == b"MAP":
        mty = _nested_type(ty, "map")
        (kvals, _kn), pos = deserialize_block(
            mv, pos, mty.key_type if mty else None)
        (vvals, vnulls), pos = deserialize_block(
            mv, pos, mty.value_type if mty else None)
        ht_len, pos = _i32(mv, pos)
        if ht_len >= 0:
            pos += ht_len * 4  # a precomputed hash table: skipped
        rows, pos = _i32(mv, pos)
        offsets, pos = _offsets(mv, pos, rows)
        nulls, pos = _bitunpack_nulls(mv, pos, rows)
        vals = np.empty(rows, dtype=object)
        for i in range(rows):
            vals[i] = None if nulls[i] else {
                _item(kvals[k]): None if vnulls[k] else _item(vvals[k])
                for k in range(offsets[i], offsets[i + 1])}
        return (vals, nulls), pos
    if enc == b"ROW":
        nfields, pos = _i32(mv, pos)
        rty = _nested_type(ty, "row")
        ftys = rty.field_types if rty else [None] * nfields
        fcols = []
        for fi in range(nfields):
            col, pos = deserialize_block(mv, pos, ftys[fi])
            fcols.append(col)
        rows, pos = _i32(mv, pos)
        offsets, pos = _offsets(mv, pos, rows)
        nulls, pos = _bitunpack_nulls(mv, pos, rows)
        vals = np.empty(rows, dtype=object)
        for i in range(rows):
            k = offsets[i]
            vals[i] = None if nulls[i] else tuple(
                None if fn[k] else _item(fv[k]) for fv, fn in fcols)
        return (vals, nulls), pos
    raise NotImplementedError(f"block encoding {enc!r}")


def deserialize_page(buf: bytes, types: Sequence[T.Type],
                     codec: PageCodec = PageCodec()
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One page -> (values, nulls) per column; the checksum is checked
    before anything is decoded."""
    t_page0 = time.time()
    if failpoints.ARMED:
        buf = failpoints.hit("serde.deserialize", buf)
    rows, flags, uncompressed, size, checksum = \
        struct.unpack_from("<iBiiq", buf)
    payload = bytes(memoryview(buf)[_HEADER:_HEADER + size])
    if flags & _CHECKSUMMED:
        want = _checksum(payload, flags, rows, uncompressed)
        if want != checksum:
            raise ValueError(f"page checksum mismatch: {want} != {checksum}")
    if flags & _ENCRYPTED:
        raise NotImplementedError("encrypted pages")
    if flags & _COMPRESSED:
        payload = codec.decompress(payload, uncompressed)
    mv = memoryview(payload)
    ncols, pos = _i32(mv, 0)
    out = []
    for ci in range(ncols):
        col, pos = deserialize_block(mv, pos,
                                     types[ci] if ci < len(types) else None)
        out.append(col)
    _observe_serde("deserialize", time.time() - t_page0, len(buf))
    return out


def deserialize_to_arrays(buf: bytes, types: Sequence[T.Type],
                          codec: PageCodec = PageCodec()):
    return deserialize_page(buf, types, codec)
