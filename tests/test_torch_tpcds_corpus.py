"""The reference's 99-query TPC-DS corpus through the port, on the CPU
(q1-q33; test_torch_tpcds_corpus2.py runs q34-q71 and the drift guard,
test_torch_tpcds_q72.py q72, test_torch_tpcds_corpus3.py q73-q99).

Each committed small plan (presto_tpu_torch/queries/tpcds.json, the
reference's prepare_plan at the query's suite scale factor, written by
scripts/make_tpcds_corpus.py) runs through presto_tpu_torch.run_query
on the CPU and must return the reference's committed rows: integers,
decimals and strings exactly, doubles bit for bit, except in the
queries of DOUBLES_WITHIN_RTOL, held within rel 1e-9: their doubles
differ from the reference's in the last bit or two, because the
reference's compiled plans turn a division by the constant 10^scale
(decimal to double) into a multiplication by its reciprocal (XLA's
algebraic simplifier), which the port does not, and because the port
adds double sums in another order.
"""

import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)

from presto_tpu_torch.exec import run_query
from presto_tpu_torch.plan import from_json
from presto_tpu_torch.queries import exact_rows, load_tpcds_corpus

CORPUS = load_tpcds_corpus()
NAMES = sorted(CORPUS, key=lambda q: int(q[1:]))
# queries whose doubles are held within rel 1e-9 instead of bit for
# bit (see the module's docstring)
DOUBLES_WITHIN_RTOL = {"q2", "q12", "q20", "q31", "q36", "q58", "q59",
                       "q61", "q66", "q83", "q98"}


def _close(got, want, rel=1e-9):
    """Rows in exact form equal, doubles (float.hex) within `rel`."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, str) and isinstance(b, str) and \
                    b.startswith(("0x", "-0x")) and a != b:
                x, y = float.fromhex(a), float.fromhex(b)
                if abs(x - y) > rel * abs(y):
                    return False
            elif a != b:
                return False
    return True


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: the port's CPU plans are
    many small ops, which several threads a worker only oversubscribe
    under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def check_query(name):
    """The committed small plan of `name` through the port on the CPU
    returns the reference's committed rows."""
    e = CORPUS[name]
    res = run_query(from_json(e["plan"]), sf=e["sf"], device="cpu",
                    prepared=True,
                    default_join_capacity=e["join_capacity"])
    assert res.names == e["names"]
    assert [str(t) for t in res.types] == e["types"]
    got = exact_rows(res.columns, res.nulls, res.types, res.row_count)
    if name in DOUBLES_WITHIN_RTOL:
        assert _close(got, e["rows"]), name
    else:
        assert got == e["rows"], name


def corpus_slice(lo, hi):
    return [n for n in NAMES if lo <= int(n[1:]) <= hi]


@pytest.mark.parametrize("name", corpus_slice(1, 33))
def test_tpcds_query_returns_the_reference_rows(name):
    check_query(name)


def test_the_corpus_holds_every_query():
    from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES
    assert set(NAMES) == set(TPCDS_QUERIES) and len(NAMES) == 99
