"""The port's lock-order witness (presto_tpu_torch/utils/locks.py) and
its OrderedLock sites, held against the reference's.

The reference's own cases (tests/test_lockwatch.py) run over the port's
modules through tests/_torch_ledger_common.py, less two: the
LOCK_ORDER.json case, which needs the static lint of ROADMAP item 16b,
and the scrape-script case, which drives the reference's
scripts/scrape_metrics.py. Then: every OrderedLock site of the reference
has its counterpart in the port under the same name (an AST scan of
both packages); the two witnesses give the same violation records for
the same inversions; and an armed cluster of two port workers behind
the port's coordinator runs TPC-H q1 at sf 0.01 through the statement
tier's protocol and the coordinator's fragments with 0 violations.
"""

import ast
import os
import threading

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from _torch_ledger_common import (all_test_names,  # noqa: F401
                                  reference_cases)

_FILE = "test_lockwatch.py"
_LEFT_OUT = {"test_lock_order_artifact_matches_source_and_is_cycle_free",
             "test_scrape_metrics_locks_section"}

globals().update(reference_cases(
    _FILE, [n for n in all_test_names(_FILE) if n not in _LEFT_OUT]))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lock_names(pkg: str):
    """{(module path under the package, OrderedLock name)} of every
    `OrderedLock("...")` call in the package's sources."""
    root = os.path.join(REPO, pkg)
    out = set()
    for d, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py") or f == "locks.py":
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if rel.startswith("lint"):
                continue
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and \
                        getattr(node.func, "id", None) == "OrderedLock" \
                        and node.args and \
                        isinstance(node.args[0], ast.Constant):
                    out.add((rel, node.args[0].value))
    return out


def test_every_ordered_lock_of_the_reference_has_its_counterpart():
    ref = _lock_names("presto_tpu")
    mine = _lock_names("presto_tpu_torch")
    assert len(ref) >= 50
    assert ref <= mine, sorted(ref - mine)
    assert {name for _rel, name in mine} == {name for _rel, name in ref}


def _inversions(locks_mod):
    """Drive the same three inversions (direct, transitive, from a
    second thread) through a package's witness; its records and the
    order graph among the test's own locks (the flight recorder's
    locks, which the violation events take, are each package's own)."""
    locks_mod.reset_witness()
    locks_mod.arm_witness()
    try:
        a, b, c = (locks_mod.OrderedLock(f"x.{n}") for n in "abc")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with b:
            with a:
                pass
        t = threading.Thread(target=lambda: _nest(c, a), name="inverter")
        t.start()
        t.join()
        return [{k: v for k, v in r.items()
                 if k not in ("site", "reverseSite")}
                for r in locks_mod.witness_violations()], \
            {a: [b for b in bs if b.startswith("x.")]
             for a, bs in locks_mod.witness_edges().items()
             if a.startswith("x.")}
    finally:
        locks_mod.disarm_witness()
        locks_mod.reset_witness()


def _nest(outer, inner):
    with outer:
        with inner:
            pass


def test_violation_records_equal_the_reference():
    from presto_tpu.utils import locks as ref_locks

    from presto_tpu_torch.utils import locks
    mine, mine_edges = _inversions(locks)
    ref, ref_edges = _inversions(ref_locks)
    assert mine == ref and len(mine) == 2
    assert mine_edges == ref_edges


def test_armed_port_cluster_runs_q1_with_zero_violations():
    """Discovery, two port workers and the port's coordinator, and the
    statement tier with its protocol, all with the witness ARMED: q1 at
    sf 0.01 distributed over the workers, and q1 through POST
    /v1/statement, finish with no inversion, and every tier's
    /v1/metrics shows the witness armed."""
    import urllib.request

    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.plan.distribute import add_exchanges
    from presto_tpu_torch.server import Coordinator, TpuWorkerServer
    from presto_tpu_torch.server.discovery import DiscoveryServer
    from presto_tpu_torch.server.metrics import parse_prometheus
    from presto_tpu_torch.server.statement import StatementServer
    from presto_tpu_torch.sql import plan_sql
    from presto_tpu_torch.utils import locks
    q1 = ("SELECT returnflag, linestatus, sum(quantity) AS q, "
          "count(*) AS c FROM lineitem WHERE shipdate <= date "
          "'1998-09-02' GROUP BY returnflag, linestatus")
    locks.reset_witness()
    locks.arm_witness()
    base = locks.witness_violations_total()
    disc = DiscoveryServer().start()
    workers = [TpuWorkerServer(sf=SF, device="cpu",
                               discovery_url=disc.url).start()
               for _ in range(2)]
    stmt = StatementServer(sf=SF, device="cpu").start()
    try:
        plan = add_exchanges(plan_sql(q1, max_groups=16))
        got, names = Coordinator(discovery_url=disc.url).execute(plan,
                                                                 sf=SF)
        assert names == ["returnflag", "linestatus", "q", "c"]
        assert len(got[0][0]) == 4
        rows = StatementClient(stmt.url, q1).drain().data
        assert len(rows) == 4
        for url in [stmt.url] + [w.url for w in workers]:
            with urllib.request.urlopen(f"{url}/v1/metrics",
                                        timeout=10) as r:
                fams = parse_prometheus(r.read().decode())
            assert fams["presto_tpu_lock_order_violations_total"][""] \
                == base, url
            assert fams["presto_tpu_lock_witness_armed"][""] == 1, url
    finally:
        stmt.stop()
        for w in workers:
            w.stop()
        disc.stop()
        locks.disarm_witness()
    assert locks.witness_violations_total() == base, \
        locks.witness_violations()
    assert locks.witness_edges(), "the armed run took no nested locks"
    locks.reset_witness()
