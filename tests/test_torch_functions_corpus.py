"""The function corpus (presto_tpu_torch/queries/functions.json,
written by scripts/make_functions_corpus.py) through the port.

* Every flat statement of the reference's function tests returns the
  reference's committed rows at sf 0.01, exactly (a transcendental
  double within 1e-12 * max(1, |want|)).
* The statements over arrays, maps, rows and lambdas ("later") return
  the reference's committed rows at sf 0.01, nested values in exact
  form.
* The timed statements return the reference's rows at sf 0.01 (double
  sums within rel 1e-9: the two packages add in another order).
* Drift guards: a few statements re-planned by the reference equal the
  committed plans; the port's registry is the reference's; every
  function (the 14 nested ones too) and every name `evaluate`
  dispatches is exercised by these tests or the corpus.
"""

import json
import os
import re
import sys

import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.expr import functions as RF
from presto_tpu.plan import nodes as RN

from presto_tpu_torch.exec import run_query
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.expr import functions as PF
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.queries import exact_rows, load_functions_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_functions_corpus as MFC  # noqa: E402

CORPUS = load_functions_corpus()
DISPATCHED = ("regexp_like", "at_timezone", "regexp_replace", "date_format",
              "date_add", "date_trunc", "date_diff", "split_part",
              "array_constructor", "sequence")
# the reference's functions over arrays, maps and rows
NESTED = ("array_distinct", "array_max", "array_min", "array_position",
          "array_sort", "array_sum", "cardinality", "contains", "element_at",
          "map_keys", "map_values", "row_field", "row_pack", "slice")
# the lambdas over arrays the corpus's SQL reaches (the map lambdas have
# no SQL type rule in the reference: tests/test_torch_lambdas.py)
ARRAY_LAMBDAS = ("transform", "filter", "reduce", "any_match", "all_match",
                 "none_match")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Several test files share the machine's cores under xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_rows(plan_json, sf):
    res = run_query(from_json(plan_json), sf=sf, device="cpu", prepared=True)
    return exact_rows(res.columns, res.nulls, res.types, res.row_count)


def _close(got, want, rel=1e-9):
    """Rows equal, but doubles (float.hex strings) within `rel`."""
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if isinstance(w, str) and w.startswith(("0x", "-0x")) and \
                    isinstance(g, str):
                gf, wf = float.fromhex(g), float.fromhex(w)
                assert abs(gf - wf) <= rel * max(1.0, abs(wf)), (g, w)
            else:
                assert g == w


@pytest.mark.parametrize("name", sorted(CORPUS["statements"]))
def test_statement_returns_the_reference_rows(name):
    """Exact, but a double within 1e-12 * max(1, |want|): the
    transcendental functions of scalar_math (sin, log2, cbrt, atan2,
    log) may differ in the last bit between XLA's and torch's math."""
    e = CORPUS["statements"][name]
    _close(_port_rows(e["plan"], e["sf"]), e["rows"], rel=1e-12)


@pytest.mark.parametrize("name", sorted(CORPUS["later"]))
def test_later_statement_names_its_roadmap_item(name):
    """A statement over arrays, maps, rows or lambdas returns the
    reference's rows exactly (the name is from before the nested half
    was ported, when these named their ROADMAP item)."""
    e = CORPUS["later"][name]
    assert _port_rows(e["plan"], e["sf"]) == e["rows"]


@pytest.mark.parametrize("name", sorted(CORPUS["timed"]))
def test_timed_statement_returns_the_reference_rows(name):
    e = CORPUS["timed"][name]
    got = _port_rows(e["plan"], e["sf"])
    assert got
    _close(got, e["rows"])


def test_corpus_holds_the_scripts_statements():
    assert set(CORPUS["statements"]) == set(MFC.STATEMENTS)
    assert set(CORPUS["later"]) == set(MFC.LATER)
    assert set(CORPUS["timed"]) == set(MFC.TIMED)
    for e in CORPUS["timed"].values():
        assert e["sf"] == MFC.SF_SMALL and e["sf1"] == MFC.SF1
        assert e["rows_sf1"] and e["plan_sf1"]
    for group in ("statements", "later", "timed"):
        for name, e in CORPUS[group].items():
            want = {**MFC.STATEMENTS, **MFC.LATER, **MFC.TIMED}[name]
            assert e["sql"] == want


def _strip_ids(v):
    if isinstance(v, dict):
        return {k: _strip_ids(x) for k, x in v.items() if k != "id"}
    if isinstance(v, list):
        return [_strip_ids(x) for x in v]
    return v


@pytest.mark.parametrize("group,name,key", [
    ("statements", "tz_cast_to_local", "plan"),
    ("statements", "json_scalar_index", "plan"),
    ("statements", "values_union", "plan"),
    ("statements", "regexp_like_clerk", "plan"),
    ("later", "lambda_captures", "plan"),
    ("timed", "fn_math", "plan"),
    ("timed", "fn_arrays", "plan"),
    ("timed", "fn_unnest", "plan_sf1"),
    ("timed", "fn_sample", "plan"),
    ("timed", "fn_strings", "plan_sf1"),
])
def test_committed_plan_is_the_reference_plan(group, name, key):
    """Drift guard: the reference plans the statement again, as the
    script does, and its JSON equals the committed one, node ids
    aside."""
    e = CORPUS[group][name]
    sf = e["sf1"] if key == "plan_sf1" else e["sf"]
    plan = MFC.prepared(name, e["sql"], sf)
    assert _strip_ids(json.loads(json.dumps(RN.to_json(plan)))) == \
        _strip_ids(e[key])


def test_registry_is_the_reference_registry_minus_the_nested_names():
    """The port's registry is the reference's, the 14 nested names
    included (the name is from before they were ported)."""
    assert set(PF.REGISTRY) == set(RF.REGISTRY)
    for name in NESTED:
        assert PF.lookup(name).name == name


def _call_names(j, out):
    if isinstance(j, dict):
        if j.get("@type") == "call":
            out.add(j["displayName"].lower())
        for v in j.values():
            _call_names(v, out)
    elif isinstance(j, list):
        for v in j:
            _call_names(v, out)
    return out


def test_every_flat_function_and_dispatched_name_is_exercised():
    """Each registered name, the 14 nested ones too, is called by a
    case of the tests/test_torch_functions*.py and
    tests/test_torch_nested_functions.py files (a quoted name there) or
    by a committed statement; each name `evaluate` dispatches, and each
    array lambda, is a committed statement's call and the port's
    dispatch table's."""
    here = os.path.dirname(os.path.abspath(__file__))
    text = ""
    for f in os.listdir(here):
        if re.fullmatch(r"test_torch_(nested_)?functions.*\.py", f):
            with open(os.path.join(here, f)) as fh:
                text += fh.read()
    called = set()
    for group in ("statements", "later", "timed"):
        for e in CORPUS[group].values():
            _call_names(e["plan"], called)
    quoted = set(re.findall(r'"([a-z_0-9$]+)"', text))
    missing = sorted(n for n in PF.REGISTRY
                     if not n.startswith("$operator$")
                     and n not in quoted | called)
    assert not missing, missing
    assert set(NESTED) <= set(PF.REGISTRY)
    assert set(DISPATCHED) | set(ARRAY_LAMBDAS) <= called
    assert set(DISPATCHED) <= set(PC._BY_NAME)
    assert set(ARRAY_LAMBDAS) <= set(PC._ARRAY_LAMBDAS)
