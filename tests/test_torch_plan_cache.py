"""The compiled-plan cache of the port (presto_tpu_torch/exec/
plan_cache.py) held against the reference's, on the CPU at sf 0.01.

The reference's own cases (tests/test_plan_cache.py) run over the
port's modules through tests/_torch_ledger_common.py, less one: the
case that bypasses the cache with `capacity_hints`, a keyword the
port's run_query does not take; it runs here with `scan_ranges`, the
port's keyword named by node id. Then: `system.plan_cache` has the
reference's columns and answers the cache's counts, the cache's key
takes the kernel modes the reference keys on (PRESTO_TPU_FUSION and
PRESTO_TPU_BATCHING among them), a hit charges no compile stage, and
the cache stays within its bound.
"""

import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from _torch_ledger_common import (all_test_names,  # noqa: F401
                                  port_sql, reference_cases)

_FILE = "test_plan_cache.py"
_LEFT_OUT = {"test_cache_bypassed_with_node_id_hints"}

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
Q = ("SELECT returnflag, count(*) AS c, sum(quantity) AS q FROM lineitem "
     "WHERE quantity > 10 GROUP BY returnflag ORDER BY returnflag")


def test_cache_bypassed_with_node_id_scan_ranges():
    """scan_ranges name THIS plan's node ids, so the run lowers its own
    plan and leaves the cache untouched."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.plan_cache import cache_stats
    from presto_tpu_torch.exec.planner import scan_leaves
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    root = prepare_plan(plan_sql(Q), SF)
    scan = scan_leaves(root)[0]
    before = cache_stats()
    res = run_query(root, sf=SF, device="cpu", prepared=True,
                    scan_ranges={scan.id: (0, 30000)})
    assert res.row_count >= 1
    assert cache_stats() == before
    assert res.query_stats.stages["compile"].compile_us > 0


def test_system_plan_cache_answers_in_the_reference_columns():
    from presto_tpu.connectors.system import SCHEMA as REF_SCHEMA

    from presto_tpu_torch.connectors.system import SCHEMA
    from presto_tpu_torch.exec.plan_cache import (cache_stats,
                                                  clear_plan_cache)
    assert [(k, str(v)) for k, v in SCHEMA["plan_cache"].items()] == \
        [(k, str(v)) for k, v in REF_SCHEMA["plan_cache"].items()]
    clear_plan_cache()
    port_sql(Q)
    port_sql(Q)
    assert cache_stats() == {"entries": 1, "hits": 1, "misses": 1}
    res = port_sql("SELECT entries, hits, misses FROM system.plan_cache")
    assert res.names == ["entries", "hits", "misses"]
    # the scan stages before the statement's own plan is looked up
    assert res.rows() == [(1, 1, 1)]
    assert cache_stats()["misses"] == 2


def test_kernel_modes_key_the_cache(monkeypatch):
    """Each mode of KERNEL_MODE_ENVS, the reference's names, keys apart:
    a plan lowered under PRESTO_TPU_FUSION=0 or PRESTO_TPU_BATCHING=0
    misses where it hit before."""
    from presto_tpu.exec.plan_cache import KERNEL_MODE_ENVS as REF_ENVS

    from presto_tpu_torch.exec.plan_cache import (KERNEL_MODE_ENVS,
                                                  cache_stats,
                                                  cached_compile,
                                                  clear_plan_cache)
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    assert set(KERNEL_MODE_ENVS) <= set(REF_ENVS)
    assert {"PRESTO_TPU_FUSION", "PRESTO_TPU_BATCHING"} <= \
        {name for name, _ in KERNEL_MODE_ENVS}
    root = prepare_plan(plan_sql(Q), SF)
    clear_plan_cache()
    for env in ("PRESTO_TPU_FUSION", "PRESTO_TPU_BATCHING"):
        monkeypatch.delenv(env, raising=False)
    cached_compile(root)
    cached_compile(root)
    assert cache_stats() == {"entries": 1, "hits": 1, "misses": 1}
    monkeypatch.setenv("PRESTO_TPU_FUSION", "0")
    cached_compile(root)
    monkeypatch.setenv("PRESTO_TPU_BATCHING", "0")
    cached_compile(root)
    assert cache_stats() == {"entries": 3, "hits": 1, "misses": 3}
    clear_plan_cache()


def test_a_hit_charges_no_compile_stage_and_the_same_rows():
    from presto_tpu_torch.exec.plan_cache import clear_plan_cache
    clear_plan_cache()
    cold = port_sql(Q)
    warm = port_sql(Q)
    assert cold.query_stats.stages["compile"].compile_us > 0
    assert "compile" not in warm.query_stats.stages
    assert cold.rows() == warm.rows()


@pytest.mark.parametrize("limb_form", ["narrow", "wide"])
def test_limb_form_and_sharing_key_apart(limb_form):
    """The port's two lowering inputs the reference has no counterpart
    for: the limb form, and which node ids a plan shares."""
    from presto_tpu_torch.exec.plan_cache import (_sharing_key,
                                                  cache_stats,
                                                  cached_compile,
                                                  clear_plan_cache)
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.plan import nodes as PN
    from presto_tpu_torch.sql import plan_sql
    clear_plan_cache()
    root = prepare_plan(plan_sql(Q), SF)
    cached_compile(root, limb_form=limb_form)
    other = "wide" if limb_form == "narrow" else "narrow"
    cached_compile(root, limb_form=other)
    assert cache_stats()["misses"] == 2
    # a self-join read from JSON with one scan id under both sides
    # shares the scan (one batch staged); with two ids it does not
    j = PN.to_json(prepare_plan(plan_sql(
        "SELECT count(*) FROM nation a JOIN nation b "
        "ON a.nationkey = b.nationkey"), SF))
    two = PN.from_json(j)
    assert set(_sharing_key(two)) == {-1}  # no repeated id

    def relabel(v):
        if isinstance(v, dict):
            if v.get("@type") == "tablescan":
                v = dict(v, id="scan")
            return {k: relabel(x) for k, x in v.items()}
        if isinstance(v, list):
            return [relabel(x) for x in v]
        return v
    one = PN.from_json(relabel(j))
    assert _sharing_key(one) != _sharing_key(two)
    clear_plan_cache()


def test_the_cache_stays_within_its_bound():
    from presto_tpu_torch.exec import plan_cache
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.sql import plan_sql
    plan_cache.clear_plan_cache()
    for k in range(plan_cache._MAX_ENTRIES + 3):
        plan_cache.cached_compile(prepare_plan(plan_sql(
            f"SELECT count(*) FROM nation WHERE regionkey < {k}"), SF))
    st = plan_cache.cache_stats()
    assert st["entries"] == plan_cache._MAX_ENTRIES
    assert st["misses"] == plan_cache._MAX_ENTRIES + 3
    plan_cache.clear_plan_cache()
