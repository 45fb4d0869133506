"""The port's string, varbinary, JSON, regex and geo functions against
the reference's, expression by expression (inputs and comparison of
tests/_torch_functions_common.py: exact, but the geo functions of
TRANSCENDENTAL within 1e-12 * max(1, |want|)), the regex DFA of
ops/regex.py against the reference's DFA and its kernel, and the
per-row host kernels (JSON, regex capture, digests), whose row errors
are SQL NULL in both packages."""

import re

import numpy as np
import pytest
import torch

from _torch_functions_common import (REL, batches, call, check, const,
                                     port_expr, ref, ty)

from presto_tpu.expr import compile as RC
from presto_tpu.ops import regex as RR
from presto_tpu_torch import block as PB
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import functions as PF
from presto_tpu_torch.ops import regex as PR

BIG, VC = ty("bigint"), ty("varchar")
BOOL, VB, JS = ty("boolean"), ty("varbinary"), ty("json")


def _c(v):
    return const(v, ty(f"varchar({max(len(v), 1)})"))


STRINGS = {
    "length": call("length", BIG, ref("words")),
    "upper": call("upper", ty("varchar(16)"), ref("words")),
    "lower": call("lower", ty("varchar(16)"), ref("words")),
    "trim": call("trim", ty("varchar(16)"), ref("words")),
    "ltrim": call("ltrim", ty("varchar(16)"), ref("words")),
    "rtrim": call("rtrim", ty("varchar(16)"), ref("words")),
    "reverse": call("reverse", ty("varchar(16)"), ref("words")),
    "chr": call("chr", ty("varchar(1)"), ref("small")),
    "codepoint": call("codepoint", BIG, ref("words")),
    "substr": call("substr", ty("varchar(16)"), ref("words"), ref("div")),
    "substr_length": call("substr", ty("varchar(16)"), ref("words"),
                          ref("small"), ref("div")),
    "concat": call("concat", ty("varchar(20)"), ref("words"),
                   ref("needle")),
    "starts_with_const": call("starts_with", BOOL, ref("words"), _c("the")),
    "starts_with_column": call("starts_with", BOOL, ref("words"),
                               ref("needle")),
    "starts_with_wider": call("starts_with", BOOL, ref("needle"),
                              ref("words")),
    "ends_with_const": call("ends_with", BOOL, ref("words"), _c("ly")),
    "ends_with_column": call("ends_with", BOOL, ref("words"),
                             ref("needle")),
    "ends_with_wider": call("ends_with", BOOL, ref("needle"), ref("words")),
    "strpos_const": call("strpos", BIG, ref("words"), _c("e")),
    "strpos_column": call("strpos", BIG, ref("words"), ref("needle")),
    "position": call("position", BIG, ref("words"), _c("-")),
    "strpos_too_wide": call("strpos", BIG, ref("needle"),
                            _c("needle longer than the column")),
    "to_hex": call("to_hex", ty("varchar(32)"), ref("words")),
    "from_hex": call("from_hex", VB, ref("hex")),
    "to_utf8": call("to_utf8", VB, ref("words")),
    "from_utf8": call("from_utf8", ty("varchar(8)"), ref("hex")),
    "hex_round_trip": call("from_utf8", ty("varchar(16)"),
                           call("from_hex", VB, call("to_hex", VC,
                                                     ref("words")))),
}
for _i in (1, 2, 3, 5):
    for _d in ("-", ",", " "):
        STRINGS[f"split_part[{_d}{_i}]"] = call(
            "split_part", ty("varchar(16)"), ref("words"), _c(_d),
            const(_i, BIG))


@pytest.mark.parametrize("name", sorted(STRINGS))
def test_strings_match_reference(name):
    check(STRINGS[name])


HOST = {
    "json_parse": call("json_parse", JS, ref("docs")),
    "json_format": call("json_format", ty("varchar(48)"),
                        call("json_parse", JS, ref("docs"))),
    "json_extract": call("json_extract", JS, ref("docs"), _c("$.a.b")),
    "json_extract_root": call("json_extract", JS, ref("docs"), _c("$")),
    "json_extract_scalar": call("json_extract_scalar", ty("varchar(48)"),
                                ref("docs"), _c("$.a.b[1]")),
    "json_extract_scalar_key": call("json_extract_scalar",
                                    ty("varchar(48)"), ref("docs"),
                                    _c('$["s"]')),
    "json_extract_scalar_float": call("json_extract_scalar",
                                      ty("varchar(48)"), ref("docs"),
                                      _c("$.a")),
    "json_extract_bad_path": call("json_extract", JS, ref("docs"),
                                  _c("a.b")),
    "json_array_length": call("json_array_length", BIG, ref("docs")),
    "json_size": call("json_size", BIG, ref("docs"), _c("$.a")),
    "json_size_root": call("json_size", BIG, ref("docs"), _c("$")),
    "json_array_contains_number": call("json_array_contains", BOOL,
                                       ref("docs"), ref("small")),
    "json_array_contains_bool": call("json_array_contains", BOOL,
                                     ref("docs"), ref("bool")),
    "json_array_contains_string": call("json_array_contains", BOOL,
                                       ref("docs"), _c("2")),
    "is_json_scalar": call("is_json_scalar", BOOL, ref("docs")),
    "regexp_extract": call("regexp_extract", VC, ref("words"),
                           _c(r"[a-z]+")),
    "regexp_extract_group": call("regexp_extract", VC, ref("words"),
                                 _c(r"(\w)(\w+)"), const(2, BIG)),
    "regexp_extract_bad_group": call("regexp_extract", VC, ref("words"),
                                     _c(r"(\w)"), const(3, BIG)),
    "regexp_position": call("regexp_position", BIG, ref("words"),
                            _c(r"\d")),
    "regexp_count": call("regexp_count", BIG, ref("words"), _c(r"[aeiou]")),
    "regexp_replace": call("regexp_replace", VC, ref("words"),
                           _c(r"(\w)(\w)"), _c("$2$1")),
    "regexp_replace_delete": call("regexp_replace", VC, ref("words"),
                                  _c(r"\s")),
    "md5": call("md5", VB, call("to_utf8", VB, ref("words"))),
    "sha1_hex": call("to_hex", VC, call("sha1", VB, ref("words"))),
    "sha256_hex": call("to_hex", VC, call("sha256", VB, ref("words"))),
    "sha512_hex": call("to_hex", VC, call("sha512", VB, ref("words"))),
    "crc32": call("crc32", BIG, call("to_utf8", VB, ref("words"))),
}


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_functions_match_reference(name):
    """A row whose Python raises (malformed JSON, a bad path or group) is
    NULL in both, as SQL's error-to-NULL contract of the reference."""
    if name == "md5":
        rb, pb = batches()
        r = RC.evaluate(HOST[name], rb)
        p = PC.evaluate(port_expr(HOST[name]), pb)
        assert p.nulls.tolist() == np.asarray(r.nulls).tolist()
        live = ~p.nulls
        assert (p.chars[live].numpy() ==
                np.asarray(r.chars)[live.numpy()]).all()
        return
    check(HOST[name])


def test_host_kernels_keep_the_device_of_their_input():
    col = PB.from_numpy(VC, np.array(["a1", None, "b"], dtype=object),
                        device="cpu")
    out = PF.lookup("regexp_count").fn(BIG, col, PB.from_numpy(
        VC, np.array(["\\d"] * 3, dtype=object), device="cpu"))
    assert out.values.device == col.chars.device
    assert out.nulls.tolist() == [False, True, False]


GEO = {
    "great_circle_distance": call("great_circle_distance", ty("double"),
                                  ref("lat"), ref("lon"), ref("pos"),
                                  ref("dbl")),
    "bing_tile_x": call("bing_tile_x", BIG, ref("lat"), ref("lon"),
                        ref("zoom")),
    "bing_tile_y": call("bing_tile_y", BIG, ref("lat"), ref("lon"),
                        ref("zoom")),
    "bing_tile_quadkey_at": call("bing_tile_quadkey_at", ty("varchar(23)"),
                                 ref("lat"), ref("lon"), ref("zoom")),
}


@pytest.mark.parametrize("name", sorted(GEO))
def test_geo_matches_reference(name):
    """Within 1e-12 * max(1, |want|) for the distance; the tile numbers
    and quadkeys, floors of transcendental results, equal exactly on
    these inputs (none sits on a tile edge)."""
    check(GEO[name], rel=REL if name == "great_circle_distance" else None)


# tests/test_regex_datefmt.py's pattern and string corpus
CORPUS = ["", "a", "ab", "abc", "xabcy", "aaab", "b", "ba", "hello world",
          "42", "x42y", "a1b2", "AbC", "abab", "aab", "  ", "a-b", "zzz",
          "special requests", "nospecial", "1994-01-01", "foo_bar"]
PATTERNS = ["abc", "^abc", "abc$", "^abc$", "a.c", "a*", "a+b", "ab?c",
            "[abc]+", "[^abc]+", "[a-z]+[0-9]", "\\d+", "\\w+", "\\s",
            "a|b", "(ab)+", "(?:ab|ba)c?", "a{2,3}b", "a{2}b", "x\\d{2}y",
            "^$", "^\\d{4}-\\d{2}-\\d{2}$", "special.*requests",
            "(fur|blith)ely [a-z]{2,6} (dep|req|pac)", "[a-c-]", "a{2,}",
            "\\.", "[\\d\\s]+$", "(a|)b"]


def _chars(strings):
    w = max((len(s.encode()) for s in strings), default=1) or 1
    chars = np.zeros((len(strings), w), dtype=np.uint8)
    lengths = np.zeros(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        b = s.encode()
        chars[i, :len(b)] = list(b)
        lengths[i] = len(b)
    return chars, lengths


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_equals_the_reference_dfa_and_python_re(pattern):
    import jax.numpy as jnp
    table, acc = PR.compile_dfa(pattern)
    rtable, racc = RR.compile_dfa(pattern)
    assert np.array_equal(table, rtable) and np.array_equal(acc, racc)
    chars, lengths = _chars(CORPUS)
    got = PR.regexp_like_kernel(torch.from_numpy(chars),
                                torch.from_numpy(lengths), table, acc)
    want = RR.regexp_like_kernel(jnp.asarray(chars), jnp.asarray(lengths),
                                 rtable, racc)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == [re.search(pattern, s) is not None
                            for s in CORPUS]


@pytest.mark.parametrize("pattern", ["a(?=b)", "a{100}", "(a", "abc\\",
                                     "a{x}", "[abc", "*a", "a{3,2}",
                                     "[ab]*a[ab]{8}"])
def test_patterns_the_reference_refuses_raise_unsupported(pattern):
    """Beyond the syntax or the 255-state budget: RegexUnsupported in
    both, never a fallback to Python's re."""
    with pytest.raises(RR.RegexUnsupported):
        RR.compile_dfa.__wrapped__(pattern)
    with pytest.raises(PR.RegexUnsupported):
        PR.compile_dfa.__wrapped__(pattern)


@pytest.mark.parametrize("pattern", [r"^\w+ \w+$", r"[0-9]", "e.*e",
                                     r"(?:the|-)\s?", r"\s{2}"])
def test_regexp_like_through_evaluate_matches_reference(pattern):
    check(call("regexp_like", BOOL, ref("words"), _c(pattern)))


def test_regexp_like_refuses_what_the_reference_refuses():
    expr = call("regexp_like", BOOL, ref("words"), _c("(unclosed"))
    rb, pb = batches()
    with pytest.raises(RR.RegexUnsupported):
        RC.evaluate(expr, rb)
    with pytest.raises(PR.RegexUnsupported):
        PC.evaluate(port_expr(expr), pb)
    not_const = call("regexp_like", BOOL, ref("words"), ref("needle"))
    with pytest.raises(AssertionError):
        RC.evaluate(not_const, rb)
    with pytest.raises(NotImplementedError, match="constant"):
        PC.evaluate(port_expr(not_const), pb)


@pytest.mark.parametrize("delim,index", [("--", 1), ("-", 0)])
def test_split_part_refuses_what_the_reference_refuses(delim, index):
    expr = call("split_part", VC, ref("words"), _c(delim), const(index, BIG))
    rb, pb = batches()
    with pytest.raises(AssertionError):
        RC.evaluate(expr, rb)
    with pytest.raises((NotImplementedError, ValueError)):
        PC.evaluate(port_expr(expr), pb)
