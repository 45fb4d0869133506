"""Device-resident columnar data model over torch tensors.

Counterpart of presto_tpu/block.py (Column, StringColumn, Int128Column,
Batch and the host <-> device staging helpers), with plain dataclasses
in place of JAX pytrees and an explicit `device` on every staging call:
`None` means CUDA, and a CUDA device that is not there raises.

* A `Column` is a flat value tensor plus a bool null mask.
* A `StringColumn` is a padded `(N, L)` uint8 matrix plus lengths.
* An `Int128Column` is a long decimal as two int64 lanes: `hi` and `lo`.
  The reference's `lo` lane is uint64; torch has no unsigned 64-bit
  shifts or compares, so `lo` holds the same bits as an int64 pattern
  (int128.py does the unsigned arithmetic on those patterns).
* A `DictionaryColumn` is indices into a flat dictionary column; the
  operators decode it where they read values.
* An `ArrayColumn` is a fixed-fanout array per row, an `(N, K)` element
  matrix (K the batch's largest cardinality); approx_distinct's HLL
  registers use the same layout (`array(tinyint)`, K = 2048).
* A `MapColumn` is the same layout with `(N, K)` keys and values, and a
  `RowColumn` one child block per field.
* A `Batch` is equal-capacity columns plus an `active` row mask: rows
  past the live count, and rows a filter dropped, are inactive.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import types as T

__all__ = ["Column", "StringColumn", "Int128Column", "DictionaryColumn",
           "ArrayColumn", "MapColumn", "RowColumn", "Batch", "Block",
           "decoded",
           "torch_dtype", "resolve_device", "from_numpy", "batch_from_numpy",
           "to_numpy", "gather_block", "pad_chars", "null_like",
           "concat_batches", "pinned_staging"]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(dt)]


@dataclasses.dataclass
class Column:
    """Fixed-width column: `values` (N,), `nulls` (N,) bool (True = NULL).
    Value slots under a null are unspecified but finite."""
    values: torch.Tensor
    nulls: torch.Tensor
    type: T.Type

    def __len__(self):
        return self.values.shape[0]


@dataclasses.dataclass
class StringColumn:
    """Padded strings: `chars` (N, L) uint8 with zeros past each row's
    length, `lengths` (N,) int32, `nulls` (N,) bool."""
    chars: torch.Tensor
    lengths: torch.Tensor
    nulls: torch.Tensor
    type: T.Type

    def __len__(self):
        return self.chars.shape[0]

    @property
    def max_len(self) -> int:
        return self.chars.shape[1]


@dataclasses.dataclass
class Int128Column:
    """Long decimal lanes: value = hi * 2^64 + lo (two's complement),
    `lo` held as the int64 bit pattern of the unsigned low word."""
    hi: torch.Tensor
    lo: torch.Tensor
    nulls: torch.Tensor
    type: T.Type

    def __len__(self):
        return self.hi.shape[0]


@dataclasses.dataclass
class DictionaryColumn:
    """Row i's value is dictionary[indices[i]]; `nulls` is the row's
    own mask (a NULL row may point at any dictionary slot)."""
    indices: torch.Tensor
    dictionary: Union[Column, StringColumn]
    nulls: torch.Tensor
    type: T.Type

    def __len__(self):
        return self.indices.shape[0]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    def decode(self) -> Union[Column, StringColumn]:
        """The flat column: one gather through the dictionary."""
        d = self.dictionary
        if isinstance(d, StringColumn):
            return StringColumn(d.chars[self.indices],
                                d.lengths[self.indices], self.nulls,
                                self.type)
        return Column(d.values[self.indices], self.nulls, self.type)


@dataclasses.dataclass
class ArrayColumn:
    """Fixed-fanout arrays: row i's array is elements[i, :lengths[i]];
    `elements` and `elem_nulls` (N, K), `lengths` (N,) int32, `nulls`
    (N,) bool."""
    elements: torch.Tensor
    elem_nulls: torch.Tensor
    lengths: torch.Tensor
    nulls: torch.Tensor
    type: T.Type

    def __len__(self):
        return self.elements.shape[0]

    @property
    def capacity(self) -> int:
        return self.elements.shape[0]

    @property
    def max_cardinality(self) -> int:
        return self.elements.shape[1]


@dataclasses.dataclass
class MapColumn:
    """Fixed-fanout maps: row i's entries are (keys[i, j], values[i, j])
    for j < lengths[i]. Keys are never NULL (the SQL contract); keys,
    values and `value_nulls` are (N, K)."""
    keys: torch.Tensor
    values: torch.Tensor
    value_nulls: torch.Tensor
    lengths: torch.Tensor
    nulls: torch.Tensor
    type: T.Type

    def __len__(self):
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def max_cardinality(self) -> int:
        return self.keys.shape[1]


@dataclasses.dataclass
class RowColumn:
    """A struct: one child block per field and the row's own null
    mask."""
    fields: Tuple["Block", ...]
    nulls: torch.Tensor
    type: T.Type

    def __len__(self):
        return self.nulls.shape[0]

    @property
    def capacity(self) -> int:
        return self.nulls.shape[0]

    def field(self, i: int) -> "Block":
        return self.fields[i]


Block = Union[Column, StringColumn, Int128Column, DictionaryColumn,
              ArrayColumn, MapColumn, RowColumn]


def decoded(b: Block) -> Block:
    """`b` with a dictionary decoded, for the operators that read
    values."""
    return b.decode() if isinstance(b, DictionaryColumn) else b


@dataclasses.dataclass
class Batch:
    """Equal-capacity columns and the active-row mask every op honours."""
    columns: Tuple[Block, ...]
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: int) -> Block:
        return self.columns[i]

    def with_active(self, active: torch.Tensor) -> "Batch":
        return Batch(self.columns, active)


# --------------------------------------------------------------------------
# Host <-> device staging
# --------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def _pad_cast(arr: np.ndarray, capacity: int, dt, fill=0) -> np.ndarray:
    """Allocate the (capacity, ...) staging buffer at the target dtype
    once and slice-assign into it (one host copy, not cast-then-pad)."""
    dt = np.dtype(dt)
    n = arr.shape[0]
    if n == capacity and arr.dtype == dt:
        return arr
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=dt)
    out[:n] = arr
    return out


_PINNED = contextvars.ContextVar("pinned_staging", default=False)


@contextlib.contextmanager
def pinned_staging():
    """Within the block, staging onto a CUDA device copies each host
    array into page-locked memory and enqueues its copy to the device
    without waiting for it, so that the host can generate the next
    split while the card works on this one (exec/streaming.py). The
    caching host allocator keeps a pinned buffer until its copy is
    done."""
    token = _PINNED.set(True)
    try:
        yield
    finally:
        _PINNED.reset(token)


def _put(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if _PINNED.get() and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _encode_strings(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Object array of str/None -> ((n, w) uint8 chars, (n,) int32
    lengths), UTF-8, None as the empty string. ASCII text takes a
    vectorized path through numpy's fixed-width bytes (whose trailing
    NULs are padding, as in any staged chars matrix); anything
    else encodes row by row."""
    n = values.shape[0]
    if n == 0:
        return np.zeros((0, 1), np.uint8), np.zeros(0, np.int32)
    missing = np.equal(values, None)
    text = np.where(missing, "", values) if missing.any() else values
    try:
        fixed = text.astype(np.bytes_)
    except UnicodeEncodeError:
        fixed = None
    if fixed is not None:
        chars = fixed.view(np.uint8).reshape(n, fixed.dtype.itemsize)
        return chars, np.char.str_len(fixed).astype(np.int32)
    encoded = [b"" if v is None else str(v).encode("utf-8") for v in values]
    max_len = max((len(b) for b in encoded), default=1) or 1
    chars = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, b in enumerate(encoded):
        chars[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    return chars, lengths


def from_numpy(ty: T.Type, values: np.ndarray,
               nulls: Optional[np.ndarray] = None,
               capacity: Optional[int] = None, physical_dtype=None,
               device=None) -> Block:
    """Stage one host column on `device` (None: CUDA). Strings arrive as an object
    array of str, long decimals as Python ints or any int64-safe array;
    arrays, maps and rows as object arrays of lists, dicts and tuples,
    None for a NULL (row or element). `physical_dtype` stages a
    fixed-width column at a narrower range-proven lane (plan/widths.py);
    the logical `ty` is unchanged and compute sites widen first."""
    device = resolve_device(device)
    n = values.shape[0]
    capacity = capacity or n
    if ty.base in ("array", "map", "row"):
        top = np.zeros(n, dtype=bool) if nulls is None else \
            np.asarray(nulls, dtype=bool).copy()
        top |= np.array([v is None for v in values], dtype=bool)
        stage = {"array": _stage_array, "map": _stage_map,
                 "row": _stage_row}[ty.base]
        return stage(ty, list(values), top, capacity, device)
    if nulls is None:
        if values.dtype == object:
            nulls = np.equal(values, None).astype(bool)
        else:
            nulls = np.zeros(n, dtype=bool)
    nulls_t = _put(_pad_cast(np.asarray(nulls, dtype=bool), capacity, bool,
                             fill=True), device)
    if ty.is_string:
        chars, lengths = _encode_strings(values)
        return StringColumn(_put(_pad_cast(chars, capacity, np.uint8), device),
                            _put(_pad_cast(lengths, capacity, np.int32),
                                 device),
                            nulls_t, ty)
    if ty.is_decimal and not ty.is_short_decimal:
        from .int128 import python_to_int128
        if values.dtype == object:
            hi, lo = python_to_int128(list(values))
        else:
            v = np.asarray(values, dtype=np.int64)
            hi, lo = v >> 63, v
        return Int128Column(_put(_pad_cast(hi, capacity, np.int64), device),
                            _put(_pad_cast(lo, capacity, np.int64), device),
                            nulls_t, ty)
    dt = np.dtype(physical_dtype) if physical_dtype is not None \
        else ty.to_dtype()
    return Column(_put(_pad_cast(values, capacity, dt), device), nulls_t, ty)


def _fanout(rows) -> int:
    """K of a fixed-fanout block: the largest cardinality, at least 1."""
    return max((len(r) for r in rows if r is not None), default=1) or 1


def _stage_array(ty, rows, top, capacity, device) -> "ArrayColumn":
    k = _fanout(rows)
    elems = np.zeros((capacity, k), dtype=ty.element_type.to_dtype())
    enulls = np.ones((capacity, k), dtype=bool)
    lengths = np.zeros(capacity, dtype=np.int32)
    for i, r in enumerate(rows):
        if top[i]:
            continue
        lengths[i] = len(r)
        for j, v in enumerate(r):
            if v is not None:
                elems[i, j] = v
                enulls[i, j] = False
    return ArrayColumn(_put(elems, device), _put(enulls, device),
                       _put(lengths, device),
                       _put(_pad_cast(top, capacity, bool, fill=True),
                            device), ty)


def _stage_map(ty, rows, top, capacity, device) -> "MapColumn":
    k = _fanout(rows)
    keys = np.zeros((capacity, k), dtype=ty.key_type.to_dtype())
    vals = np.zeros((capacity, k), dtype=ty.value_type.to_dtype())
    vnulls = np.ones((capacity, k), dtype=bool)
    lengths = np.zeros(capacity, dtype=np.int32)
    for i, r in enumerate(rows):
        if top[i]:
            continue
        lengths[i] = len(r)
        for j, (kk, vv) in enumerate(r.items()):
            keys[i, j] = kk
            if vv is not None:
                vals[i, j] = vv
                vnulls[i, j] = False
    return MapColumn(_put(keys, device), _put(vals, device),
                     _put(vnulls, device), _put(lengths, device),
                     _put(_pad_cast(top, capacity, bool, fill=True), device),
                     ty)


def _stage_row(ty, rows, top, capacity, device) -> "RowColumn":
    """Each field stages as a column of its own; a NULL row's fields
    are NULL."""
    fields = []
    for fi, fty in enumerate(ty.field_types):
        col = np.empty(len(rows), dtype=object)
        col[:] = [None if t else r[fi] for r, t in zip(rows, top)]
        fnulls = np.array([v is None for v in col], dtype=bool)
        if fty.is_fixed_width and not (fty.is_decimal
                                       and not fty.is_short_decimal):
            col = np.array([0 if v is None else v for v in col],
                           dtype=fty.to_dtype())
        fields.append(from_numpy(fty, col, fnulls, capacity,
                                 device=device))
    return RowColumn(tuple(fields),
                     _put(_pad_cast(top, capacity, bool, fill=True), device),
                     ty)


def batch_from_numpy(types: Sequence[T.Type], arrays: Sequence[np.ndarray],
                     nulls: Optional[Sequence[Optional[np.ndarray]]] = None,
                     capacity: Optional[int] = None, physical_dtypes=None,
                     device=None) -> Batch:
    """Stage equal-length host columns as one Batch on `device` (None:
    CUDA); rows past the live count are inactive."""
    device = resolve_device(device)
    n = arrays[0].shape[0]
    capacity = capacity or n
    nulls = nulls or [None] * len(arrays)
    physical_dtypes = physical_dtypes or [None] * len(arrays)
    cols = tuple(from_numpy(t, a, m, capacity, physical_dtype=p,
                            device=device)
                 for t, a, m, p in zip(types, arrays, nulls,
                                       physical_dtypes))
    active = np.zeros(capacity, dtype=bool)
    active[:n] = True
    b = Batch(cols, _put(active, device))
    # the live row count, known here on the host: what the ledgers
    # record for a staged scan without reading the mask back
    b.live_rows = n
    return b


def to_numpy(block: Block) -> Tuple[np.ndarray, np.ndarray]:
    """Fetch (values, nulls) to the host. Strings come back as an object
    array of str, long decimals as an object array of Python ints,
    arrays, maps and rows as object arrays of lists, dicts (in entry
    order) and tuples, None for NULL."""
    if isinstance(block, DictionaryColumn):
        return to_numpy(block.decode())
    nulls = block.nulls.cpu().numpy()
    if isinstance(block, ArrayColumn):
        elems = block.elements.cpu().numpy()
        enulls = block.elem_nulls.cpu().numpy()
        lengths = block.lengths.cpu().numpy()
        vals = np.empty(len(lengths), dtype=object)
        for i in range(len(lengths)):
            vals[i] = None if nulls[i] else [
                None if enulls[i, j] else elems[i, j].item()
                for j in range(lengths[i])]
        return vals, nulls
    if isinstance(block, MapColumn):
        keys = block.keys.cpu().numpy()
        mvals = block.values.cpu().numpy()
        vnulls = block.value_nulls.cpu().numpy()
        lengths = block.lengths.cpu().numpy()
        vals = np.empty(len(lengths), dtype=object)
        for i in range(len(lengths)):
            vals[i] = None if nulls[i] else {
                keys[i, j].item(): None if vnulls[i, j]
                else mvals[i, j].item() for j in range(lengths[i])}
        return vals, nulls
    if isinstance(block, RowColumn):
        fvals = [to_numpy(f) for f in block.fields]
        vals = np.empty(len(nulls), dtype=object)
        for i in range(len(nulls)):
            vals[i] = None if nulls[i] else tuple(
                None if fn[i] else (fv[i].item()
                                    if isinstance(fv[i], np.generic)
                                    else fv[i])
                for fv, fn in fvals)
        return vals, nulls
    if isinstance(block, StringColumn):
        return _decode_strings(block.chars.cpu().numpy(),
                               block.lengths.cpu().numpy()), nulls
    if isinstance(block, Int128Column):
        from .int128 import int128_to_python
        return int128_to_python(block.hi.cpu().numpy(),
                                block.lo.cpu().numpy()), nulls
    return block.values.cpu().numpy(), nulls


def _decode_strings(chars: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """(n, w) chars and lengths -> object array of str. ASCII rows with
    no NUL inside their length decode in one vectorized pass (numpy's
    fixed-width bytes, whose trailing NULs are padding); anything else
    row by row as UTF-8."""
    n, w = chars.shape
    live = np.arange(w) < lengths[:, None]
    text = np.where(live, chars, 0).astype(np.uint8)
    if n and w and text.max() < 128 and not (live & (text == 0)).any():
        # each fixed-width row decodes straight to a Python str in the
        # object array: one conversion, no intermediate unicode array
        return np.frompyfunc(bytes.decode, 1, 1)(text.view(f"S{w}").ravel())
    return np.array([chars[i, :lengths[i]].tobytes().decode("utf-8",
                                                            "replace")
                     for i in range(n)], dtype=object)


def pad_chars(c: StringColumn, width: int) -> StringColumn:
    """The same strings in a chars matrix `width` bytes wide (zero
    padded); `width` may not be narrower than the column."""
    extra = width - c.chars.shape[1]
    if extra == 0:
        return c
    if extra < 0:
        raise ValueError(f"cannot narrow a {c.chars.shape[1]}-byte column "
                         f"to {width}")
    return StringColumn(torch.nn.functional.pad(c.chars, (0, extra)),
                        c.lengths, c.nulls, c.type)


def _fanout_gather(b, idx, valid, nulls, fields):
    """gather_block of an array or map: every (N, K) tensor of `fields`
    by row; an invalid output row is NULL and empty."""
    lengths = b.lengths[idx]
    if valid is not None:
        lengths = torch.where(valid, lengths, 0)
    return dataclasses.replace(
        b, **{f: getattr(b, f)[idx] for f in fields}, lengths=lengths,
        nulls=nulls)


def gather_block(b: Block, idx: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> Block:
    """Row gather for every Block kind. `valid=None` is a pure
    permutation (a dictionary gathers its indices); with a mask,
    invalid output rows become NULL (and empty, for strings, arrays
    and maps; a row's fields NULL too)."""
    if isinstance(b, DictionaryColumn):
        if valid is None:
            return DictionaryColumn(b.indices[idx], b.dictionary,
                                    b.nulls[idx], b.type)
        b = b.decode()
    nulls = b.nulls[idx]
    if valid is not None:
        nulls = torch.where(valid, nulls, True)
    if isinstance(b, StringColumn):
        lengths = b.lengths[idx]
        if valid is not None:
            lengths = torch.where(valid, lengths, 0)
        return StringColumn(b.chars[idx], lengths, nulls, b.type)
    if isinstance(b, ArrayColumn):
        return _fanout_gather(b, idx, valid, nulls,
                              ("elements", "elem_nulls"))
    if isinstance(b, MapColumn):
        return _fanout_gather(b, idx, valid, nulls,
                              ("keys", "values", "value_nulls"))
    if isinstance(b, RowColumn):
        return RowColumn(tuple(gather_block(f, idx, valid)
                               for f in b.fields), nulls, b.type)
    if isinstance(b, Int128Column):
        return Int128Column(b.hi[idx], b.lo[idx], nulls, b.type)
    return Column(b.values[idx], nulls, b.type)


def null_like(b: Block) -> Block:
    """An all-NULL block with the same capacity, type and layout as `b`
    (GroupIdNode's dropped-key columns); strings, arrays and maps are
    empty, and a row's fields NULL."""
    b = decoded(b)
    ones = torch.ones_like(b.nulls)
    if isinstance(b, StringColumn):
        return StringColumn(b.chars, torch.zeros_like(b.lengths), ones,
                            b.type)
    if isinstance(b, (ArrayColumn, MapColumn)):
        return dataclasses.replace(b, lengths=torch.zeros_like(b.lengths),
                                   nulls=ones)
    if isinstance(b, RowColumn):
        return RowColumn(tuple(null_like(f) for f in b.fields), ones, b.type)
    if isinstance(b, Int128Column):
        return Int128Column(b.hi, b.lo, ones, b.type)
    return Column(b.values, ones, b.type)


def _cat_fanout(blocks, fields):
    """concat of arrays or maps: each (N, K) tensor of `fields` padded
    to the widest K."""
    k = max(b.max_cardinality for b in blocks)
    return dataclasses.replace(
        blocks[0],
        **{f: torch.cat([torch.nn.functional.pad(
            getattr(b, f), (0, k - b.max_cardinality)) for b in blocks])
           for f in fields},
        lengths=torch.cat([b.lengths for b in blocks]),
        nulls=torch.cat([b.nulls for b in blocks]))


def _cat_blocks(blocks: Sequence[Block]) -> Block:
    blocks = [decoded(b) for b in blocks]
    b0 = blocks[0]
    nulls = torch.cat([b.nulls for b in blocks])
    if isinstance(b0, StringColumn):
        width = max(b.max_len for b in blocks)
        return StringColumn(
            torch.cat([pad_chars(b, width).chars for b in blocks]),
            torch.cat([b.lengths for b in blocks]), nulls, b0.type)
    if isinstance(b0, ArrayColumn):
        return _cat_fanout(blocks, ("elements", "elem_nulls"))
    if isinstance(b0, MapColumn):
        return _cat_fanout(blocks, ("keys", "values", "value_nulls"))
    if isinstance(b0, RowColumn):
        return RowColumn(tuple(_cat_blocks([b.fields[fi] for b in blocks])
                               for fi in range(len(b0.fields))),
                         nulls, b0.type)
    if isinstance(b0, Int128Column):
        return Int128Column(torch.cat([b.hi for b in blocks]),
                            torch.cat([b.lo for b in blocks]), nulls,
                            b0.type)
    # torch.cat widens narrow lanes to their common dtype
    return Column(torch.cat([b.values for b in blocks]), nulls, b0.type)


def concat_batches(batches: Sequence[Batch]) -> Batch:
    """The rows of `batches` one after another (UNION ALL): capacities
    add, string columns pad to the widest chars matrix and arrays and
    maps to the widest K, and dictionaries decode."""
    return Batch(tuple(_cat_blocks([b.columns[ci] for b in batches])
                       for ci in range(batches[0].num_columns)),
                 torch.cat([b.active for b in batches]))
