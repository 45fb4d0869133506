"""The port's verifier over its mesh: presto_tpu_torch/verifier.py.

`verify_corpus` runs each statement of the verifier corpus (the
reference's 22 `DEFAULT_CORPUS` statements and its TPC-DS star shape)
on one CPU device (the control) and on eight CPU workers, and every
mesh result must equal the control's rows exactly; a few statements
also stream in splits. `check_plan_determinism` plans each statement
three times; `cluster_urls` (the worker tier) is refused by name.
"""

import pytest
import torch

from presto_tpu import verifier as ref_verifier

from presto_tpu_torch import verifier

from _torch_mesh_common import port_mesh

STATEMENTS = list(verifier.DEFAULT_CORPUS) + list(verifier.TPCDS_CORPUS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_corpus_is_the_references():
    assert verifier.DEFAULT_CORPUS == ref_verifier.DEFAULT_CORPUS
    assert verifier.TPCDS_CORPUS == ref_verifier.TPCDS_CORPUS
    assert len(STATEMENTS) == 23


@pytest.mark.parametrize("i", range(len(STATEMENTS)),
                         ids=[f"s{i}" for i in range(len(STATEMENTS))])
def test_mesh_equals_the_control(i):
    r, = verifier.verify_corpus([STATEMENTS[i]], sf=0.01, mesh=port_mesh(),
                                device="cpu")
    assert r.ok, r.detail
    assert r.configs == ["control", "mesh"]


@pytest.mark.parametrize("i", [0, 1, 3, 9, 14])
def test_streaming_equals_the_control(i):
    r, = verifier.verify_corpus([STATEMENTS[i]], sf=0.01, split_rows=8192,
                                device="cpu")
    assert r.ok, r.detail
    assert r.configs == ["control", "streaming"]


@pytest.mark.parametrize("text", [
    "SELECT orderkey FROM orders ORDER BY orderkey LIMIT 0",
    "SELECT DISTINCT orderkey FROM (SELECT orderkey FROM orders "
    "ORDER BY orderkey LIMIT 0) t",
    "SELECT orderkey FROM (SELECT orderkey FROM orders ORDER BY orderkey "
    "LIMIT 0) t ORDER BY orderkey DESC",
], ids=["topn_0", "distinct_over_limit_0", "merge_over_limit_0"])
def test_batches_without_rows_cross_the_mesh(text):
    """A TopN of 0 rows leaves each worker a batch of capacity 0, which
    the REPARTITION under a DISTINCT and the range exchange of a MERGE
    must pass on."""
    r, = verifier.verify_corpus([text], sf=0.01, mesh=port_mesh(),
                                device="cpu")
    assert r.ok, r.detail


def test_a_failing_configuration_is_recorded_not_raised():
    r, = verifier.verify_corpus(["SELECT nothing FROM nowhere_at_all"],
                                sf=0.01, mesh=port_mesh(2), device="cpu")
    assert not r.ok and "errors" in r.detail


def test_plans_are_deterministic_and_the_worker_tier_is_refused():
    """A cluster that refuses every connection is a failed
    configuration, recorded and not raised (the worker tier runs the
    statement otherwise: tests/test_torch_coordinator.py)."""
    assert verifier.check_plan_determinism(STATEMENTS) == []
    r, = verifier.verify_corpus(STATEMENTS[:1], sf=0.01, device="cpu",
                                cluster_urls=["http://127.0.0.1:1"])
    assert not r.ok and "cluster" in r.detail
