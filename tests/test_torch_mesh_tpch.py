"""TPC-H on the port's mesh against the port on one device: a third
of the 22 queries (balanced by their cost on the CPU; the others in
tests/test_torch_mesh_tpch2.py and ..._tpch3.py).

Each query's text, with the corpus's capacities, runs through the
port's `sql` at sf 0.01 on eight CPU workers (prepare_plan adds the
exchanges; every REMOTE exchange moves rows between the workers) and
on one CPU device, and the rows must be equal, exactly. The reference
holds the mesh's rows of q1, q3 and q21 in
tests/test_torch_mesh_reference*.py.
"""

import pytest
import torch

from _torch_mesh_common import assert_tpch_mesh_equals_one_device

QUERIES = (16, 5, 12, 2, 22, 18, 13, 4, 6, 1, 11)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", QUERIES, ids=lambda n: f"q{n}")
def test_mesh_rows_equal_one_device(n):
    assert_tpch_mesh_equals_one_device(n)
