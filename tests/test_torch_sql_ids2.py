"""The second half of tests/test_torch_sql_ids.py's runs: shared-id
plans planned by the port from their text, run on the CPU, equal to
the reference's rows."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import shared_id_rows_case  # noqa: E402
from test_torch_sql_ids import RUN_IN_IDS2  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs: several threads a worker
    only oversubscribe the cores under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", RUN_IN_IDS2)
def test_shared_id_plan_rows_equal_the_reference(name):
    shared_id_rows_case(name)
