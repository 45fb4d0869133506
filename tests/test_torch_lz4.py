"""The port's host serde kernels (presto_tpu_torch/native) against the
reference's (presto_tpu/native).

The cases of tests/test_lz4.py run through the port's library. Then,
for seeded random, repetitive and overlapping buffers, the port's LZ4
blocks are byte-equal to the reference's and each package decompresses
the other's; pack_nonnull and unpack_nonnull write the bytes of their
numpy definitions for every fixed width (1, 2, 4, 8 and 16 bytes).
(The lz4 pages of every block kind are held byte-equal in
tests/test_torch_serde.py.)
"""

import numpy as np
import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.native import kernels as ref_nk

from presto_tpu_torch import types as T
from presto_tpu_torch.native import kernels as nk
from presto_tpu_torch.serde import PageCodec, deserialize_page, serialize_page


def _buffers(case):
    rng = np.random.default_rng(case)
    return [
        b"", b"a", b"hello world " * 1000,
        bytes(rng.integers(0, 256, 10000, dtype=np.uint8)),
        b"ab" * 5000,  # matches whose offset is below their length
        bytes(rng.integers(0, 4, 50000, dtype=np.uint8)),
        b"x" * 70000 + bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
        np.arange(40000, dtype=np.int64).tobytes(),
        bytes(rng.integers(0, 256, 17, dtype=np.uint8)) * 4001,
    ][case]


CASES = range(9)


@pytest.mark.parametrize("case", CASES)
def test_lz4_roundtrip(case):
    data = _buffers(case)
    assert nk.lz4_decompress(nk.lz4_compress(data), len(data)) == data


@pytest.mark.parametrize("case", CASES)
def test_lz4_blocks_equal_to_the_reference(case):
    data = _buffers(case)
    port, ref = nk.lz4_compress(data), ref_nk.lz4_compress(data)
    assert port == ref
    assert ref_nk.lz4_decompress(port, len(data)) == data
    assert nk.lz4_decompress(ref, len(data)) == data


def test_lz4_compresses_repetitive():
    data = b"hello world " * 1000
    assert len(nk.lz4_compress(data)) < len(data) // 10


@pytest.mark.parametrize("block,size", [
    (b"\xff\xff\xff\xff", 100),                # literal run past the end
    (b"\x10a\x05\x00", 10),                    # offset past the output
    (b"\x10a\x00\x00", 10),                    # offset 0
    (nk.lz4_compress(b"abcdefgh" * 10), 79),   # one byte short
    (nk.lz4_compress(b"abcdefgh" * 10), 81)],  # one byte long
    ids=["run", "offset", "zero-offset", "short", "long"])
def test_lz4_rejects_malformed(block, size):
    with pytest.raises(ValueError):
        nk.lz4_decompress(block, size)
    with pytest.raises(ValueError):
        ref_nk.lz4_decompress(block, size)


def test_lz4_page_codec():
    vals = np.arange(20000, dtype=np.int64) % 17
    codec = PageCodec(compression="lz4")
    buf = serialize_page([(T.BIGINT, vals, np.zeros(20000, bool))], codec)
    assert len(buf) < 20000 * 8 // 3
    out = deserialize_page(buf, [T.BIGINT], codec)
    np.testing.assert_array_equal(out[0][0], vals)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.float32, np.float64, np.bool_,
                                   np.complex128])
@pytest.mark.parametrize("null_share", [0.0, 0.3, 1.0])
def test_pack_and_unpack_equal_their_numpy_definitions(dtype, null_share):
    rng = np.random.default_rng(7)
    n = 1001
    vals = rng.integers(-100, 100, n).astype(dtype)
    nulls = rng.random(n) < null_share
    packed = nk.pack_nonnull(vals, nulls)
    assert packed == vals[~nulls].tobytes()
    assert packed == ref_nk.pack_nonnull(vals, nulls)
    dense = np.frombuffer(packed, dtype=vals.dtype)
    out = nk.unpack_nonnull(dense, nulls)
    want = np.zeros(n, dtype=vals.dtype)
    want[~nulls] = vals[~nulls]
    assert out.dtype == want.dtype and out.flags.writeable
    assert out.tobytes() == want.tobytes()


def test_library_builds_into_the_port_build_directory():
    import os
    path = nk.build_library()
    assert os.path.dirname(path).endswith(os.path.join("presto_tpu_torch",
                                                       "build"))
    assert nk.build_library() == path  # keyed by the source: built once
