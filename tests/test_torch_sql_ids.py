"""Node ids of the plans the port's front door prepares.

The plan passes copy nodes with dataclasses.replace, which keeps the
id of a node they change, so that one id can name two different nodes;
everything the port keys by node id (lowering, the capacity ladder,
dynamic filters) would then reuse one node's output for the other.
`prepare_plan` ends by giving every distinct node its own id, by the
rule `from_json` reads plan JSON with. In 22 plans of the corpora the
passes leave an id on several nodes (tests/_torch_sql_common.py::
SHARED_ID_*): before the relabelling each has such an id, after it none
has. Thirteen of the shared-id plans run on the CPU and equal the
reference's rows, half here and half in tests/test_torch_sql_ids2.py.

Not run, by name (their plans are held to the reference's above and in
tests/test_torch_sql_planner.py; their runs, 1.5-35 s each on the CPU,
would pass the tests' time budget): TPC-DS q11, q23, q24, q31, q39, q57,
q59, q64, q74.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import (SHARED_ID_TPCDS, SHARED_ID_TPCH,  # noqa
                               ids_on_several_nodes, shared_id_rows_case)

from presto_tpu_torch.exec.runner import prepare_plan  # noqa: E402
from presto_tpu_torch.plan.reorder import reorder_joins  # noqa: E402
from presto_tpu_torch.plan.rules import optimize_plan  # noqa: E402
from presto_tpu_torch.plan.stats import refine_capacities  # noqa: E402
from presto_tpu_torch.plan.widths import annotate_widths  # noqa: E402
from presto_tpu_torch.queries import (load_corpus,  # noqa: E402
                                      load_tpcds_corpus)
from presto_tpu_torch.sql import plan_sql  # noqa: E402

NOT_RUN = {"q11", "q23", "q24", "q31", "q39", "q57", "q59", "q64",
           "q74"}
RUN = [f"tpch_{q}" for q in SHARED_ID_TPCH] + \
    [f"tpcds_{q}" for q in SHARED_ID_TPCDS if q not in NOT_RUN]
RUN_HERE, RUN_IN_IDS2 = RUN[0::2], RUN[1::2]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: several threads a worker
    only oversubscribe the cores under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plannings():
    """(id, text, catalog, sf, max_groups, join_capacity, session) of
    each shared-id plan at SF1 (the timed TPC-DS plan) and at the
    TPC-DS suite's scale factor."""
    out = []
    tpch = load_corpus()
    for q in SHARED_ID_TPCH:
        e = tpch[q]
        out.append((f"tpch_{q}_sf1", e["sql"], None, 1.0, e["max_groups"],
                    e["join_capacity"], None))
    tpcds = load_tpcds_corpus()
    for q in SHARED_ID_TPCDS:
        e = tpcds[q]
        session = {"join_reordering_strategy": "NONE"} if q == "q24" \
            else None
        out.append((f"tpcds_{q}_timed", e["sql"], "tpcds", e["timed_sf"],
                    e["timed_max_groups"], e["timed_join_capacity"],
                    session))
        out.append((f"tpcds_{q}_suite", e["sql"], "tpcds", e["sf"],
                    e["max_groups"], e["join_capacity"], session))
    return out


PLANNINGS = _plannings()


def _passes(root, sf, session):
    """prepare_plan's passes without its relabelling."""
    root = optimize_plan(root)
    if not session:
        rr = reorder_joins(root, sf)
        root = optimize_plan(rr) if rr is not root else rr
    return annotate_widths(refine_capacities(root, sf), sf)


@pytest.mark.parametrize("name,text,catalog,sf,mg,jc,session", PLANNINGS,
                         ids=[p[0] for p in PLANNINGS])
def test_prepare_plan_gives_every_node_its_own_id(name, text, catalog, sf,
                                                  mg, jc, session):
    def plan():
        return plan_sql(text, max_groups=mg, join_capacity=jc,
                        catalog=catalog)
    assert ids_on_several_nodes(_passes(plan(), sf, session)), \
        "the passes no longer leave an id on several nodes"
    assert ids_on_several_nodes(prepare_plan(plan(), sf,
                                             session=session)) == []


def test_the_runs_are_split_between_the_two_files():
    assert len(RUN) == 13 and set(RUN_HERE).isdisjoint(RUN_IN_IDS2)


@pytest.mark.parametrize("name", RUN_HERE)
def test_shared_id_plan_rows_equal_the_reference(name):
    shared_id_rows_case(name)
