"""Concurrent-query batching of the port (presto_tpu_torch/exec/
batching.py) held against the reference's (presto_tpu/exec/
batching.py), on the CPU at sf 0.01.

The reference's own cases (tests/test_query_batching.py) run over the
port's modules through tests/_torch_ledger_common.py, with their 400 ms
formation window and `batch_hot_min` 1, less one: the kernel-mode case
flips PRESTO_TPU_SMALLG, a kernel form of the reference's that the port
does not have; it runs here with PRESTO_TPU_NARROW, a mode the port
reads. Then, across the packages:

  * `parameterize_plan` (through each executor's `_prepare`) gives the
    reference's template JSON, parameter values and types, and template
    fingerprint (the batch key's first part) for the lookup, dashboard
    and lineitem families of scripts/loadgen.py and the 22 prepared
    TPC-H plans;
  * batched port rows equal the reference's serial rows bit for bit
    (integers, decimals and strings exactly; these families hold no
    double, and any would compare as float.hex, bit for bit, which is
    within the reference's own tolerance);
  * the `dispatcher.batch_collapse` failpoint gives the same rows, and
    `batching_totals` counts the batch and the collapse as the
    reference's does;
  * the statement server's documents carry `batchSize`, the history
    record `batchFingerprint`, and /v1/cluster the live `batching`
    entry in the reference's shape.
"""

import json
import urllib.request

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from _torch_ledger_common import (all_test_names,  # noqa: F401
                                  reference_cases)
from _torch_sql_common import canonical, plan_differences

_FILE = "test_query_batching.py"
_LEFT_OUT = {"test_differing_kernel_mode_envs_never_cobatch"}

globals().update(reference_cases(
    _FILE, [n for n in all_test_names(_FILE) if n not in _LEFT_OUT]))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: six xdist workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SF = 0.01
LOOKUP = "SELECT custkey, name, acctbal FROM customer WHERE custkey = {}"
DASH = ("SELECT orderpriority, count(*) AS c, sum(totalprice) AS s "
        "FROM orders WHERE custkey = {} "
        "GROUP BY orderpriority ORDER BY orderpriority")
LINEITEM = ("SELECT sum(extendedprice * discount) FROM lineitem "
            "WHERE discount BETWEEN 0.05 AND 0.07 AND quantity < {}")


def test_differing_kernel_mode_envs_never_cobatch_in_the_port(monkeypatch):
    """The reference's case over a kernel mode the port reads: the batch
    key, and the key one text prepares to, change with it."""
    from presto_tpu_torch.exec.batching import (BatchingExecutor,
                                                get_batching_executor)
    monkeypatch.delenv("PRESTO_TPU_NARROW", raising=False)
    k1 = BatchingExecutor._batch_key("fp", SF, 1 << 16)
    monkeypatch.setenv("PRESTO_TPU_NARROW", "0")
    k2 = BatchingExecutor._batch_key("fp", SF, 1 << 16)
    assert k1 != k2
    ex = get_batching_executor()

    def key_of(text):
        return ex._prepare(text, sf=SF, session={}, max_groups=None,
                           join_capacity=None, catalog="tpch")[3]

    monkeypatch.delenv("PRESTO_TPU_NARROW", raising=False)
    ka = key_of(LOOKUP.format(5))
    monkeypatch.setenv("PRESTO_TPU_NARROW", "0")
    kb = key_of(LOOKUP.format(5))
    assert ka != kb


# -- across the packages ----------------------------------------------------

def _tpch_texts():
    from presto_tpu.queries.tpch_sql import TPCH_QUERIES
    out = []
    for n in sorted(TPCH_QUERIES):
        q = TPCH_QUERIES[n]
        out.append((f"q{n}", q.text, q.max_groups, q.join_capacity))
    return out


_TEXTS = [("lookup", LOOKUP.format(42), None, None),
          ("lookup_null", LOOKUP.format("NULL"), None, None),
          ("dashboard", DASH.format(7), None, None),
          ("lineitem", LINEITEM.format(24), None, None)] + _tpch_texts()


@pytest.mark.parametrize("name,text,max_groups,join_capacity", _TEXTS,
                         ids=[t[0] for t in _TEXTS])
def test_template_params_and_fingerprint_equal_the_reference(
        name, text, max_groups, join_capacity):
    from presto_tpu.exec.batching import BatchingExecutor as RefExecutor
    from presto_tpu.plan import nodes as RN

    from presto_tpu_torch.exec.batching import BatchingExecutor
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.plan import nodes as PN
    kw = dict(sf=SF, session={}, max_groups=max_groups,
              join_capacity=join_capacity, catalog=None)
    _, ref_tpl, ref_vals, ref_key = RefExecutor()._prepare(text, **kw)
    _, tpl, vals, key = BatchingExecutor()._prepare(text, **kw)
    want = canonical(PN.to_json(PN.from_json(RN.to_json(ref_tpl))))
    got = canonical(PN.to_json(tpl))
    assert plan_differences(got, want) is None
    assert vals == ref_vals
    assert key[0] == plan_fingerprint(tpl)
    # the reference's fingerprint of its template as JSON reads it (a
    # subtree it shares in memory is hashed as a copy, as the port's is)
    from presto_tpu.exec.plan_cache import plan_fingerprint as ref_fp
    assert key[0] == ref_fp(RN.from_json(RN.to_json(ref_tpl)))
    if not name.startswith("q"):
        assert vals, f"{name}: nothing lifted"


def _exact(res):
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    types = [PT.parse_type(str(t)) for t in res.types]
    return (list(res.names), [str(t) for t in res.types],
            exact_rows(res.columns, res.nulls, types, res.row_count))


_FAMILIES = {"lookup": (LOOKUP, (42, "NULL", 99999)),
             "dashboard": (DASH, (4, 10, 99999)),
             "lineitem": (LINEITEM, (1, 24, 50))}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_batched_rows_equal_the_reference_serial_rows(family):
    from presto_tpu.sql import sql as ref_sql

    from presto_tpu_torch.exec.batching import (BatchingExecutor,
                                                batching_totals,
                                                clear_batching)
    clear_batching()
    template, keys = _FAMILIES[family]
    texts = [template.format(k) for k in keys]
    got = BatchingExecutor().bench_dispatch(texts, sf=SF, device="cpu")
    t = batching_totals()
    assert t["batches"] == 1 and t["batched_queries"] == len(texts)
    assert t["collapses"] == {"failpoint": 0, "overflow": 0, "error": 0}
    for text, res in zip(texts, got):
        want = ref_sql(text, sf=SF, session={"query_batching": "false"})
        assert _exact(res) == _exact(want), text
    clear_batching()


def test_collapse_failpoint_rows_and_totals_equal_the_reference():
    """One formed batch forced to collapse in each package: the same
    rows, the batch never counted as dispatched, one `failpoint`
    collapse in both totals."""
    from presto_tpu import failpoints as ref_fp
    from presto_tpu.exec import batching as RB

    from presto_tpu_torch import failpoints
    from presto_tpu_torch.exec import batching as PB
    texts = [DASH.format(k) for k in (3, 8, 99999)]
    rows = {}
    for fp, mod, kw in ((ref_fp, RB, {}), (failpoints, PB,
                                           {"device": "cpu"})):
        mod.clear_batching()
        fp.disarm_all()
        fp.arm("dispatcher.batch_collapse", "error(RuntimeError):once")
        try:
            out = mod.BatchingExecutor().bench_dispatch(texts, sf=SF, **kw)
        finally:
            fp.disarm_all()
        rows[mod.__name__] = [_exact(r) for r in out]
        t = mod.batching_totals()
        assert t["batches"] == 0 and t["batched_queries"] == 0
        assert t["collapses"] == {"failpoint": 1, "overflow": 0,
                                  "error": 0}
        mod.clear_batching()
    assert rows[PB.__name__] == rows[RB.__name__]


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def test_statement_documents_carry_the_batch():
    """Three dashboard statements co-batched through the port's
    statement server (its threads, a 400 ms window, batch_hot_min 1):
    each query's document has batchSize 3, its history record the
    template's fingerprint, and /v1/cluster's `batching` entry the
    reference's keys, counting the batch."""
    import threading
    import time

    from presto_tpu.server.statement import StatementServer as RefServer

    from presto_tpu_torch.client import execute
    from presto_tpu_torch.exec.batching import (clear_batching,
                                                template_fp_of)
    from presto_tpu_torch.server.history import get_history_archive
    from presto_tpu_torch.server.statement import StatementServer
    clear_batching()
    session = {"sf": str(SF), "batch_window_ms": "400",
               "batch_hot_min": "1"}
    texts = [DASH.format(k) for k in (2, 5, 11)]
    with StatementServer(sf=SF, device="cpu") as srv, \
            RefServer(sf=SF).start() as ref:
        out = [None] * len(texts)

        def run(i):
            out[i] = execute(srv.url, texts[i], session=session)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(texts))]
        threads[0].start()
        time.sleep(0.1)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(120)
        for c in out:
            doc = _get(f"{srv.url}/v1/query/{c.query_id}")
            assert doc["batchSize"] == 3, doc["batchSize"]
            assert template_fp_of(c.query_id)
        records = {r["queryId"]: r for r in get_history_archive().records()}
        rec = records[out[0].query_id]
        assert rec["batchFingerprint"] == template_fp_of(out[0].query_id)
        assert rec["batchSize"] == 3
        got = _get(f"{srv.url}/v1/cluster")["batching"]
        want = _get(f"{ref.url}/v1/cluster")["batching"]
        assert set(got) == set(want)
        assert got["batchesDispatched"] >= 1 and got["lastBatchSize"] == 3
        assert set(got["collapses"]) == set(want["collapses"])
    clear_batching()
