"""TPC-H q1-q11 at sf 0.01 as SQL text through the port's front door
(`presto_tpu_torch.sql`, on the CPU) and the reference's
(`presto_tpu.sql.sql`): the same rows. The queries are split over two
files so that the parallel test run spreads them."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import tpch_rows_case  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: several threads a worker
    only oversubscribe the cores under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", range(1, 12), ids=lambda n: f"q{n}")
def test_tpch_rows_through_sql_equal_the_reference(n):
    tpch_rows_case(n)
