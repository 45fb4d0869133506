"""The port's string expressions and substring search against
presto_tpu's: LIKE, string comparison, SWITCH/WHEN and contains_pattern.

The same strings, made from a seed with numpy, are staged by both
packages and go through the reference's function and the port's
counterpart on the CPU. Results must be equal exactly.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.expr import call, const, input_ref, special
from presto_tpu.expr import compile as RC
from presto_tpu.expr.functions import contains_pattern as ref_contains
from presto_tpu.ops.pallas_kernels import contains_bytes as ref_kernel

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import ir as PIR
from presto_tpu_torch.expr.functions import contains_pattern
from presto_tpu_torch.ops import kernels as K

WORDS = ["", "a", "abc", "abcabc", "xabcx", "PROMO BRUSHED TIN",
         "STANDARD POLISHED", "promo", "a_c", "a%c", "ab", "bca",
         "the special requests sleep", "BUILDING", "BUILDINGS", "BUILD"]


def _column(seed, n=300, width=24, null_rate=0.1):
    rng = np.random.default_rng(seed)
    s = np.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                 dtype=object)
    s[rng.random(n) < null_rate] = None
    ty = f"varchar({width})"
    return (RB.from_numpy(RT.parse_type(ty), s, capacity=n + 4),
            PB.from_numpy(PT.parse_type(ty), s, capacity=n + 4,
                          device="cpu"))


LIKE_PATTERNS = ["abc", "a%", "%c", "%bc%", "a_c", "_b%", "%a%c%", "a%b%c",
                 "a%c%", "%", "%%", "", "PROMO%", "%PROMO%", "%S_N%",
                 "%special%sleep", "x" * 30, "%" + "y" * 30 + "%", "_",
                 "___", "%_"]


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_like_matches_reference(pattern):
    """Anchored and unanchored, '_', several '%', '', '%' alone, and
    patterns wider than the column."""
    rcol, pcol = _column(seed=1)
    want = np.asarray(RC._like(rcol, pattern))
    got = PC._like(pcol, pattern).numpy()
    np.testing.assert_array_equal(got, want)


def _batches(seed):
    rcol, pcol = _column(seed=seed, width=10)
    rng = np.random.default_rng(seed + 100)
    n = len(pcol)
    big = np.array([int(v) * (1 << 66) + 7 for v in
                    rng.integers(-3, 3, n)], dtype=object)
    small = rng.integers(-10 ** 6, 10 ** 6, n)
    rb = RB.Batch((rcol, RB.from_numpy(RT.decimal(38, 4), big),
                   RB.from_numpy(RT.BIGINT, small)), RB.from_numpy(
        RT.BOOLEAN, np.ones(n, bool)).values)
    pb = PB.Batch((pcol, PB.from_numpy(PT.decimal(38, 4), big, device="cpu"),
                   PB.from_numpy(PT.BIGINT, small, device="cpu")),
                  torch.ones(n, dtype=torch.bool))
    return rb, pb


def _same_block(ref, port):
    rv, rn = RB.to_numpy(ref)
    pv, pn = PB.to_numpy(port)
    np.testing.assert_array_equal(rn, pn)
    live = ~rn
    assert [v for v, keep in zip(rv, live) if keep] == \
        [v for v, keep in zip(pv, live) if keep]


def _port_expr(e):
    from presto_tpu.expr import ir as RIR
    return PIR.from_json(RIR.to_json(e))


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge"])
def test_string_compare_against_a_shorter_constant(op):
    """q3's mktsegment = 'BUILDING': a varchar(10) column against a
    varchar(8) literal, and the order comparisons."""
    rb, pb = _batches(seed=2)
    e = call(op, RT.BOOLEAN, input_ref(0, RT.varchar(10)),
             const("BUILDING", RT.varchar(8)))
    _same_block(RC.evaluate(e, rb), PC.evaluate(_port_expr(e), pb))


def _switches():
    d4 = RT.decimal(38, 4)
    like = call("like", RT.BOOLEAN, input_ref(0, RT.varchar(10)),
                const("BUILD%", RT.varchar(6)))
    searched = special(
        "SWITCH", d4, const(True, RT.BOOLEAN),
        special("WHEN", d4, like, input_ref(1, d4)),
        call("cast", d4, const(0, RT.BIGINT)))
    no_else = special(
        "SWITCH", RT.BIGINT, const(True, RT.BOOLEAN),
        special("WHEN", RT.BIGINT, like, input_ref(2, RT.BIGINT)))
    simple = special(
        "SWITCH", RT.varchar(10), input_ref(0, RT.varchar(10)),
        special("WHEN", RT.varchar(10), const("abc", RT.varchar(3)),
                const("three", RT.varchar(5))),
        special("WHEN", RT.varchar(10), const("", RT.varchar(0)),
                const("empty", RT.varchar(5))),
        input_ref(0, RT.varchar(10)))
    return [searched, no_else, simple]


@pytest.mark.parametrize("expr", _switches(),
                         ids=["searched_int128", "no_else", "simple_varchar"])
def test_switch_when_matches_reference(expr):
    """q14's CASE WHEN type LIKE 'PROMO%' THEN <decimal(38, 4)> ELSE
    CAST(0 AS decimal(38, 4)) END, a CASE with no ELSE (NULL), and a
    simple CASE over strings; every branch is computed, then selected."""
    rb, pb = _batches(seed=3)
    _same_block(RC.evaluate(expr, rb), PC.evaluate(_port_expr(expr), pb))


CONTAINS_CASES = [
    # tests/test_pallas_kernels.py: a corpus of 700 rows and three needles
    ("corpus", b"PROMO"), ("corpus", b"x"), ("corpus", b"special requests"),
    # a needle wider than the column
    ("narrow", b"x" * 64),
    # bytes past lengths[i] must not match
    ("prefix", b"PROMO"),
    # the empty needle: the kernel's answer (every row)
    ("corpus", b""),
    # periodic rows of 'a': both end bytes match at every window
    ("periodic", b"aaab"), ("periodic", b"aaaaaaaa"),
    # UTF-8 text: needle bytes >= 0x80
    ("utf8", "é".encode()),
]


def _contains_column(kind):
    from presto_tpu import types as T
    if kind == "corpus":
        rng = np.random.default_rng(5)
        words = ["PROMO BRUSHED TIN", "STANDARD POLISHED", "xylophone",
                 "the special requests sleep", "", "PROM", "special request",
                 "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaa"]
        strings = [words[i] for i in rng.integers(0, len(words), 700)]
    elif kind == "narrow":
        strings = ["abc", "defg"]
    elif kind == "periodic":
        strings = ["a" * k for k in range(33)]
    elif kind == "utf8":
        strings = ["café", "naïve é", "e", "", "ée", "résumé café"]
    else:
        strings = ["PROMO", "PRO"]
    vals = np.array(strings, dtype=object)
    return (RB.from_numpy(T.varchar(32), vals),
            PB.from_numpy(PT.varchar(32), vals, device="cpu"))


@pytest.mark.parametrize("kind,needle", CONTAINS_CASES,
                         ids=[f"{k}-{n.decode()[:8] or 'empty'}"
                              for k, n in CONTAINS_CASES])
def test_contains_pattern_matches_the_reference_kernel(kind, needle):
    rcol, pcol = _contains_column(kind)
    want = np.asarray(ref_kernel(rcol.chars, rcol.lengths, needle,
                                 interpret=True))
    got = contains_pattern(pcol, needle).numpy()
    np.testing.assert_array_equal(got, want)
    lengths = np.asarray(rcol.lengths)
    if needle:
        # the reference's XLA form agrees wherever the needle is not empty
        np.testing.assert_array_equal(
            got, np.asarray(ref_contains(rcol, needle)))
    else:
        # known reference-side difference: the XLA form answers False for
        # an empty row, the kernel (and SQL's '' LIKE '%%') True
        xla = np.asarray(ref_contains(rcol, needle))
        np.testing.assert_array_equal(xla, lengths > 0)
        assert got.all()


def test_contains_bytes_edges_on_the_plain_version():
    """Needle as wide as the column, W = 1, a tile-ragged n, and lengths
    outside [0, W]: the plain version (what a CPU tensor takes) equals a
    Python oracle."""
    rng = np.random.default_rng(9)
    for n, w, needle in ((1001, 7, b"ab"), (513, 1, b"a"), (600, 5, b"abcab"),
                         (300, 5, b"")):
        chars = rng.integers(97, 99, (n, w)).astype(np.uint8)
        lengths = rng.integers(-1, w + 2, n).astype(np.int32)
        got = K.contains_bytes(torch.from_numpy(chars),
                               torch.from_numpy(lengths), needle).numpy()
        want = [needle in bytes(chars[i, :max(min(lengths[i], w), 0)])
                and lengths[i] >= 0 for i in range(n)]
        np.testing.assert_array_equal(got, want)


def test_contains_bytes_refuses_what_the_kernel_does_not_take():
    chars = torch.zeros((4, 3), dtype=torch.uint8)
    lengths = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        K.contains_bytes(chars.to(torch.int16), lengths, b"a")
    with pytest.raises(TypeError):
        K.contains_bytes(chars, lengths.to(torch.int64), b"a")
    with pytest.raises(TypeError):
        K.contains_bytes(chars, lengths, "a")
    with pytest.raises(ValueError, match="no kernel"):
        K.contains_bytes(chars.to("meta"), lengths.to("meta"), b"a")


def _planted(rng, n, w, needle, alphabet, zero_pad=False, share=0.3):
    """(chars, lengths): random bytes from `alphabet`, lengths in
    [-1, w + 1], the needle written at a random start in about `share` of
    the rows, and with zero_pad every byte past lengths[i] set to 0."""
    alphabet = np.frombuffer(alphabet, np.uint8)
    chars = alphabet[rng.integers(0, alphabet.size, (n, w))]
    lengths = rng.integers(-1, w + 2, n).astype(np.int32)
    L = len(needle)
    if 0 < L <= w:
        rows = np.flatnonzero(rng.random(n) < share)
        starts = rng.integers(0, w - L + 1, rows.size)
        chars[rows[:, None], starts[:, None] + np.arange(L)] = \
            np.frombuffer(needle, np.uint8)
    if zero_pad:
        chars[np.arange(w)[None, :] >= lengths[:, None]] = 0
    return chars, lengths


def _every_length_and_start(w, needle):
    """A row for every length in [-1, w + 1] and every start of the
    needle, over a background of '.'."""
    L = len(needle)
    cases = [(ln, s) for ln in range(-1, w + 2) for s in range(w - L + 1)]
    chars = np.full((len(cases), w), ord("."), np.uint8)
    for i, (_, s) in enumerate(cases):
        chars[i, s:s + L] = np.frombuffer(needle, np.uint8)
    return chars, np.array([ln for ln, _ in cases], np.int32)


def _offset_view(a, off):
    """a's values in a view `off` elements into a larger flat array, as a
    chars or lengths tensor whose base is not 16-byte aligned."""
    flat = np.zeros(a.size + off, a.dtype)
    flat[off:] = a.reshape(-1)
    return torch.from_numpy(flat)[off:].view(a.shape)


def _hazard(case):
    """(chars, lengths, needle) of one case the redesigned kernel must
    get right, at a small size."""
    rng = np.random.default_rng(sum(map(ord, case)))
    kind, _, arg = case.partition(":")
    if kind == "needle":  # needle lengths around word edges, and the longest
        L = int(arg)
        w, n = (40, 500) if L <= 9 else (100, 200) if L <= 33 else (1100, 40)
        needle = bytes(rng.integers(97, 100, L).astype(np.uint8))
        return (*_planted(rng, n, w, needle, b"abc"), needle)
    if kind == "padded":  # bytes >= 0x80 and NUL over zero-padded rows
        w, needle, alphabet = {
            "high": (37, b"\xff\x80\xc3\xa9", b"\x00\x80\xff\xc3\xa9"),
            "0x80": (38, b"\x80", b"\x00\x7f\x80\xff"),
            "nul": (39, b"\x00", b"\x00a"),
            "a-nul": (39, b"a\x00", b"\x00a"),
            "nul5": (38, b"\x00" * 5, b"\x00a"),
            "nul-ff": (5, b"\x00\xff", b"\x00\xff")}[arg]
        return (*_planted(rng, 400, w, needle, alphabet, zero_pad=True),
                needle)
    if kind == "wide":  # several steps a row, and one row a tile
        w = int(arg)
        n, needle = (200, b"abc") if w < 9000 else (3, b"xyz")
        return (*_planted(rng, n, w, needle, b"abcxyz", share=0.5), needle)
    if kind == "rows":  # n = 1 and n smaller than one tile
        n = int(arg)
        chars, lengths = _planted(rng, n, 38, b"special", b"spe", share=0.5)
        return chars, np.maximum(lengths, 30), b"special"
    if kind == "every-length":
        return (*_every_length_and_start(38, b"special"), b"special")
    if kind == "periodic":
        lengths = rng.integers(-1, 66, 300).astype(np.int32)
        needle = {"aaab": b"aaab", "a8": b"a" * 8,
                  "a30ba": b"a" * 30 + b"ba"}[arg]
        return np.full((300, 64), ord("a"), np.uint8), lengths, needle
    raise ValueError(case)


HAZARDS = ([f"needle:{L}" for L in (1, 2, 3, 4, 5, 7, 8, 9, 31, 32, 33,
                                    1024)]
           + [f"padded:{k}" for k in ("high", "0x80", "nul", "a-nul", "nul5",
                                      "nul-ff")]
           + ["wide:300", "wide:9000", "rows:1", "rows:100", "every-length"]
           + [f"periodic:{k}" for k in ("aaab", "a8", "a30ba")])


@pytest.mark.parametrize("case", HAZARDS)
@pytest.mark.parametrize("base", ["aligned", "offset"])
def test_contains_bytes_hazards_match_the_reference_kernel(case, base):
    """The cases the word-wide scan treats apart (needle lengths around
    4-byte words and the 1024-byte limit, bytes >= 0x80 and NUL over zero
    padding, W not a multiple of 4, rows of many windows, one row a tile,
    n = 1, every length at every start, periodic rows), in the port's
    plain version against the reference kernel in interpret mode (a
    Python oracle for the 1024-byte needle, too slow there), with chars
    and lengths at aligned bases and at offsets into larger arrays."""
    chars, lengths, needle = _hazard(case)
    if base == "aligned":
        c, l = torch.from_numpy(chars), torch.from_numpy(lengths)
    else:
        c, l = _offset_view(chars, 3), _offset_view(lengths, 1)
    got = K.contains_bytes(c, l, needle).numpy()
    w = chars.shape[1]
    oracle = [ln >= 0 and needle in bytes(chars[i, :max(min(ln, w), 0)])
              for i, ln in enumerate(lengths)]
    np.testing.assert_array_equal(got, oracle)
    if len(needle) < 1024:
        want = np.asarray(ref_kernel(jnp.asarray(chars), jnp.asarray(lengths),
                                     needle, interpret=True))
        np.testing.assert_array_equal(got, want)
