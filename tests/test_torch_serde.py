"""SerializedPages of the port (presto_tpu_torch/serde) against the
reference's (presto_tpu/serde).

The cases of tests/test_serde.py, but the native-library ones, run
against the port; then, for seeded columns of every block kind, with
and without NULLs, under no codec, zstd, zlib and lz4, the two
packages must write byte-equal pages, and each must decode the
other's.
"""

import zlib

import numpy as np
import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu import types as RT
from presto_tpu.serde import PageCodec as RCodec
from presto_tpu.serde import deserialize_page as r_deserialize
from presto_tpu.serde import serialize_page as r_serialize

from presto_tpu_torch import types as T
from presto_tpu_torch.block import batch_from_numpy
from presto_tpu_torch.serde import (PageCodec, deserialize_page,
                                    serialize_batch, serialize_page)


def roundtrip(columns, codec=PageCodec()):
    buf = serialize_page(columns, codec)
    return buf, deserialize_page(buf, [c[0] for c in columns], codec)


def test_fixed_width_roundtrip_all_widths():
    rng = np.random.default_rng(3)
    cols = [
        (T.BOOLEAN, rng.integers(0, 2, 10).astype(bool), np.zeros(10, bool)),
        (T.TINYINT, rng.integers(-100, 100, 10).astype(np.int8),
         np.zeros(10, bool)),
        (T.SMALLINT, rng.integers(-1000, 1000, 10).astype(np.int16),
         np.zeros(10, bool)),
        (T.INTEGER, rng.integers(-10**6, 10**6, 10).astype(np.int32),
         np.zeros(10, bool)),
        (T.BIGINT, rng.integers(-10**12, 10**12, 10).astype(np.int64),
         np.zeros(10, bool)),
        (T.DOUBLE, rng.normal(size=10), np.zeros(10, bool)),
    ]
    _, out = roundtrip(cols)
    for (ty, v, n), (gv, gn) in zip(cols, out):
        np.testing.assert_array_equal(gv, v)
        assert gv.dtype == v.dtype
        assert not gn.any()


def test_nulls_roundtrip_spec_example():
    # the spec's example: 10 rows, NULL at 1, 4, 6, 7 and 9
    nulls = np.zeros(10, dtype=bool)
    nulls[[1, 4, 6, 7, 9]] = True
    vals = np.arange(10, dtype=np.int32) * 11
    buf, out = roundtrip([(T.INTEGER, vals, nulls)])
    gv, gn = out[0]
    np.testing.assert_array_equal(gn, nulls)
    np.testing.assert_array_equal(gv[~nulls], vals[~nulls])
    # header(21) + ncols(4) + enclen(4) + "INT_ARRAY"(9) + rows(4)
    # + hasnull(1) + bits(2) + five values(20)
    assert len(buf) == 21 + 4 + 4 + 9 + 4 + 1 + 2 + 20


def test_varchar_roundtrip():
    vals = np.array(["Denali", None, "Reinier", "Whitney", None, "Bona",
                     None, None, "Bear", None], dtype=object)
    nulls = np.array([v is None for v in vals])
    _, out = roundtrip([(T.varchar(10), vals, nulls)])
    gv, gn = out[0]
    np.testing.assert_array_equal(gn, nulls)
    assert list(gv[~gn]) == ["Denali", "Reinier", "Whitney", "Bona", "Bear"]


def test_checksum_detects_corruption():
    vals = np.arange(16, dtype=np.int64)
    buf = serialize_page([(T.BIGINT, vals, np.zeros(16, bool))])
    corrupted = bytearray(buf)
    corrupted[40] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        deserialize_page(bytes(corrupted), [T.BIGINT])


def test_compression_zstd_and_zlib():
    vals = np.zeros(10000, dtype=np.int64)  # compresses well
    for comp in ["zstd", "zlib"]:
        codec = PageCodec(compression=comp)
        buf = serialize_page([(T.BIGINT, vals, np.zeros(10000, bool))], codec)
        assert len(buf) < 10000 * 8 // 10
        out = deserialize_page(buf, [T.BIGINT], codec)
        np.testing.assert_array_equal(out[0][0], vals)


def test_zstd_codec_reads_zlib_fallback_pages():
    # a node without zstandard sends zlib under the zstd codec
    payload = np.arange(1000, dtype=np.int64).tobytes()
    out = PageCodec(compression="zstd").decompress(zlib.compress(payload),
                                                   len(payload))
    assert out == payload


def test_zlib_fallback_page_bounded_by_declared_size():
    bomb = zlib.compress(b"\x00" * (1 << 20))
    with pytest.raises(ValueError, match="declared"):
        PageCodec(compression="zstd").decompress(bomb, 100)
    with pytest.raises(ValueError, match="declared"):
        PageCodec(compression="zlib").decompress(bomb, 100)
    data = bytes(i % 251 for i in range(1200))
    whole = zlib.compress(data)
    assert len(whole) > 100
    with pytest.raises(ValueError, match="truncated"):
        PageCodec(compression="zlib").decompress(
            whole[:len(whole) // 2], len(data))


def test_serialize_batch_compacts_active():
    b = batch_from_numpy([T.BIGINT], [np.arange(5, dtype=np.int64)],
                         capacity=16, device="cpu")
    out = deserialize_page(serialize_batch(b), [T.BIGINT])
    np.testing.assert_array_equal(out[0][0], np.arange(5))


def test_lz4_names_the_native_serde_kernels():
    """An lz4 page's payload is one block of the host serde kernels'
    LZ4 codec, the library built from native/serde_kernels.cpp."""
    import os
    from presto_tpu_torch.native import kernels as nk
    assert os.path.basename(nk.build_library()).startswith("serde_kernels-")
    cols = [(T.BIGINT, np.arange(4096, dtype=np.int64) % 7,
             np.zeros(4096, bool))]
    plain = serialize_page(cols, PageCodec())[21:]
    packed = serialize_page(cols, PageCodec(compression="lz4"))[21:]
    assert len(packed) < len(plain) // 4
    assert nk.lz4_decompress(packed, len(plain)) == plain


def test_wire_format_roundtrip():
    """tests/test_map_row.py's case: MAP and ROW columns through the
    MapBlockEncoding and RowBlockEncoding layouts."""
    map_t = T.parse_type("map(bigint,bigint)")
    row_t = T.parse_type("row(bigint,varchar)")
    maps = np.array([{1: 10, 2: None}, None, {7: 70}], dtype=object)
    rows = np.array([(1, "ab"), (2, None), None], dtype=object)
    page = serialize_page([(map_t, maps, np.array([False, True, False])),
                           (row_t, rows, np.array([False, False, True]))])
    (mv, mn), (rv, rn) = deserialize_page(page, [map_t, row_t])
    assert mv[0] == {1: 10, 2: None} and mv[1] is None and mv[2] == {7: 70}
    assert rv[0] == (1, "ab") and rv[1] == (2, None) and rv[2] is None
    assert list(mn) == [False, True, False]
    assert list(rn) == [False, False, True]


# ---------------------------------------------------------------------------
# byte equality with the reference
# ---------------------------------------------------------------------------

N = 37
_STRINGS = ["", "a", "MAIL", "DELIVER IN PERSON", "été", "x" * 40]


def _column(kind: str, rng):
    """(type signature, values) of one seeded column."""
    if kind == "boolean":
        return kind, rng.integers(0, 2, N).astype(bool)
    if kind in ("tinyint", "smallint", "integer", "bigint"):
        dt = {"tinyint": np.int8, "smallint": np.int16,
              "integer": np.int32, "bigint": np.int64}[kind]
        info = np.iinfo(dt)
        return kind, rng.integers(info.min, info.max, N, dtype=dt)
    if kind == "double":
        return kind, rng.normal(size=N) * 1e6
    if kind == "real":
        return kind, rng.normal(size=N).astype(np.float32)
    if kind == "date":
        return kind, rng.integers(0, 20000, N).astype(np.int32)
    if kind == "decimal(12,2)":
        return kind, rng.integers(-10**11, 10**11, N).astype(np.int64)
    if kind == "decimal(38,2)":
        vals = np.empty(N, dtype=object)
        vals[:] = [int(a) * (10 ** 20) + int(b) for a, b in zip(
            rng.integers(-10**15, 10**15, N), rng.integers(0, 10**18, N))]
        return kind, vals
    if kind == "varchar(25)":
        return kind, np.array([_STRINGS[i] for i in
                               rng.integers(0, len(_STRINGS), N)],
                              dtype=object)
    if kind == "array(bigint)":
        vals = np.empty(N, dtype=object)
        vals[:] = [[int(x) if x % 5 else None
                    for x in rng.integers(0, 100, int(k))]
                   for k in rng.integers(0, 4, N)]
        return kind, vals
    if kind == "map(bigint,double)":
        vals = np.empty(N, dtype=object)
        vals[:] = [{int(k): (float(k) / 3 if k % 4 else None)
                    for k in rng.choice(50, int(n), replace=False)}
                   for n in rng.integers(0, 4, N)]
        return kind, vals
    if kind == "row(bigint,varchar)":
        vals = np.empty(N, dtype=object)
        vals[:] = [(int(a), None if a % 3 == 0 else _STRINGS[a % 6])
                   for a in rng.integers(0, 1000, N)]
        return kind, vals
    raise AssertionError(kind)


KINDS = ["boolean", "tinyint", "smallint", "integer", "bigint", "double",
         "real", "date", "decimal(12,2)", "decimal(38,2)", "varchar(25)",
         "array(bigint)", "map(bigint,double)", "row(bigint,varchar)"]
CODECS = [None, "zstd", "zlib", "lz4"]


def _cols(kinds, with_nulls, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in kinds:
        sig, vals = _column(k, rng)
        nulls = rng.random(N) < 0.3 if with_nulls else np.zeros(N, bool)
        if vals.dtype == object:
            vals = vals.copy()
            vals[nulls] = None
        out.append((sig, vals, nulls))
    return out


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: str(c))
@pytest.mark.parametrize("with_nulls", [False, True],
                         ids=["dense", "nulls"])
@pytest.mark.parametrize("kind", KINDS)
def test_pages_byte_equal_to_the_reference(kind, with_nulls, codec):
    cols = _cols([kind], with_nulls, seed=KINDS.index(kind))
    port = serialize_page([(T.parse_type(s), v, n) for s, v, n in cols],
                          PageCodec(compression=codec))
    ref = r_serialize([(RT.parse_type(s), v, n) for s, v, n in cols],
                      RCodec(compression=codec))
    assert port == ref
    # each package decodes the other's page to the same values
    got = deserialize_page(ref, [T.parse_type(cols[0][0])],
                           PageCodec(compression=codec))
    want = r_deserialize(port, [RT.parse_type(cols[0][0])],
                         RCodec(compression=codec))
    (gv, gn), (wv, wn) = got[0], want[0]
    np.testing.assert_array_equal(gn, wn)
    assert gv.dtype == wv.dtype
    live = ~gn
    assert all(_same(_py(a), _py(b)) for a, b in zip(gv[live], wv[live]))


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: str(c))
def test_a_page_of_every_kind_byte_equal(codec):
    cols = _cols(KINDS, True, seed=99)
    port = serialize_page([(T.parse_type(s), v, n) for s, v, n in cols],
                          PageCodec(compression=codec))
    ref = r_serialize([(RT.parse_type(s), v, n) for s, v, n in cols],
                      RCodec(compression=codec))
    assert port == ref
    back = deserialize_page(ref, [T.parse_type(s) for s, _, _ in cols],
                            PageCodec(compression=codec))
    assert len(back) == len(KINDS)


def test_empty_page_byte_equal():
    cols = [("bigint", np.zeros(0, np.int64), np.zeros(0, bool)),
            ("varchar", np.zeros(0, dtype=object), np.zeros(0, bool))]
    assert serialize_page([(T.parse_type(s), v, n) for s, v, n in cols]) \
        == r_serialize([(RT.parse_type(s), v, n) for s, v, n in cols])
