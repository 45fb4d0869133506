"""The port's TPC-DS connector against presto_tpu's, and the narrow-width
inference of a connector without range statistics.

Every table's generated columns at sf 0.01, and store_sales at sf 0.1,
must equal the reference's array for array; the generator must give
the same arrays under two PYTHONHASHSEEDs (its hashing is crc32
salted, never Python's str hash); schema, row counts, column types and
the distinct-count statistics must match, also as plan/stats.py
traces them through a plan. The tpcds connector has no column_range:
its scans stage at their logical widths instead of raising.
"""

import hashlib
import os
import subprocess
import sys
import types as pytypes

import numpy as np
import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.connectors import tpcds as rds
from presto_tpu.exec.runner import prepare_plan
from presto_tpu.plan import nodes as RN
from presto_tpu.plan import stats as RS
from presto_tpu.sql import plan_sql

from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import catalog
from presto_tpu_torch.connectors import tpcds as pds
from presto_tpu_torch.plan import from_json, stats as PS
from presto_tpu_torch.plan import widths as PW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_columns(table, sf):
    cols = [c for c, _ in rds.TPCDS_SCHEMA[table]]
    want = rds.generate_columns(table, sf, cols)
    got = pds.generate_columns(table, sf, cols)
    assert list(got) == cols
    for c in cols:
        assert got[c].dtype == want[c].dtype, (table, c)
        assert np.array_equal(got[c], want[c]), (table, c)


@pytest.mark.parametrize("table", sorted(rds.TPCDS_SCHEMA))
def test_every_table_equals_the_reference_at_sf_001(table):
    assert catalog("tpcds") is pds
    assert pds.table_row_count(table, 0.01) == \
        rds.table_row_count(table, 0.01)
    assert pds.table_row_count(table, 1.0) == rds.table_row_count(table, 1.0)
    assert [(c, str(t)) for c, t in pds.TPCDS_SCHEMA[table]] == \
        [(c, str(t)) for c, t in rds.TPCDS_SCHEMA[table]]
    for c, _ in rds.TPCDS_SCHEMA[table]:
        assert pds.column_type(table, c) == \
            PT.parse_type(str(rds.column_type(table, c)))
        for sf in (0.01, 1.0):
            assert pds.column_distinct_count(table, c, sf) == \
                rds.column_distinct_count(table, c, sf), (table, c, sf)
    _same_columns(table, 0.01)


def test_store_sales_equals_the_reference_at_sf_01():
    _same_columns("store_sales", 0.1)


_DIGEST = """
import hashlib, sys
sys.path.insert(0, {repo!r})
from presto_tpu_torch.connectors import tpcds
h = hashlib.sha256()
for t in ("store_sales", "item", "customer_address", "date_dim"):
    data = tpcds.generate_columns(t, 0.01, [c for c, _ in tpcds.TPCDS_SCHEMA[t]])
    for c in sorted(data):
        a = data[c]
        h.update(repr(list(a)).encode() if a.dtype == object else a.tobytes())
print(h.hexdigest())
"""


def test_generation_is_the_same_under_two_hash_seeds():
    digests = []
    for seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": seed}
        out = subprocess.run([sys.executable, "-c",
                              _DIGEST.format(repo=REPO)], env=env,
                             capture_output=True, text=True, timeout=300,
                             check=True)
        digests.append(out.stdout.strip())
    h = hashlib.sha256()
    for t in ("store_sales", "item", "customer_address", "date_dim"):
        data = rds.generate_columns(t, 0.01,
                                    [c for c, _ in rds.TPCDS_SCHEMA[t]])
        for c in sorted(data):
            a = data[c]
            h.update(repr(list(a)).encode() if a.dtype == object
                     else a.tobytes())
    assert digests[0] == digests[1] == h.hexdigest()


def test_a_connector_without_column_range_stages_at_logical_widths(
        monkeypatch):
    """infer_table_widths guards the connector's column_range as the
    reference does: none at all, or a KeyError for the column, means
    no proven range, so the scan keeps its logical lanes."""
    cols = ["ss_item_sk", "ss_quantity", "ss_sold_date_sk"]
    tys = [pds.column_type("store_sales", c) for c in cols]
    assert not hasattr(pds, "column_range")
    assert PW.infer_table_widths("tpcds", "store_sales", cols, tys, 1.0) \
        is None
    scan = from_json(RN.to_json(RN.TableScanNode(
        "tpcds", "store_sales", cols,
        [rds.column_type("store_sales", c) for c in cols])))
    assert PW.annotate_widths(scan, 1.0).physical_dtypes is None

    def missing(table, column, sf):
        raise KeyError(column)

    ranged = pytypes.SimpleNamespace(
        column_range=lambda t, c, sf: (0, 100) if c == "a" else missing(
            t, c, sf))
    monkeypatch.setattr("presto_tpu_torch.connectors.catalog",
                        lambda name: ranged)
    assert PW.infer_table_widths("x", "t", ["a", "b"],
                                 [PT.BIGINT, PT.BIGINT], 1.0) == ("int8",
                                                                  None)
    monkeypatch.setattr("presto_tpu_torch.connectors.catalog",
                        lambda name: pytypes.SimpleNamespace())
    assert PW.infer_table_widths("x", "t", ["a"], [PT.BIGINT], 1.0) is None


@pytest.mark.parametrize("query", ["q3", "q27", "q98"])
def test_distinct_estimates_match_the_reference(query):
    """estimate_distinct over every node and channel of a prepared plan
    (q27 has a GroupId, q98 a Window)."""
    from presto_tpu.queries.tpcds_queries import TPCDS_QUERIES
    ref = prepare_plan(plan_sql(TPCDS_QUERIES[query], catalog="tpcds"),
                       sf=0.01)
    port = from_json(RN.to_json(ref))
    checked = 0
    stack = [(ref, port)]
    while stack:
        r, p = stack.pop()
        for ch in range(len(r.output_types())):
            want = RS.estimate_distinct(r, ch, 1.0)
            assert PS.estimate_distinct(p, ch, 1.0) == want, (query, r, ch)
            checked += want is not None
        stack.extend(zip(r.sources, p.sources))
    assert checked > 0
