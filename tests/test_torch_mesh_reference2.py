"""Mesh rows of the port against the reference's mesh rows: TPC-H q21
(AssignUniqueId, the worker salted into its high bits) and q3 with
PARTITIONED joins (both sides of each join repartitioned by its keys),
through both packages' `sql(mesh=)` over eight CPU workers, in order.
The other cases: tests/test_torch_mesh_reference.py."""

import pytest

from test_torch_mesh_reference import (  # noqa: F401  (a fixture)
    assert_mesh_rows_equal_the_references, one_torch_thread, tpch_case)

CASES = {"q21": tpch_case(21),
         "q3_partitioned": tpch_case(
             3, join_distribution_type="PARTITIONED")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_rows_equal_the_references(mesh8, name):
    assert_mesh_rows_equal_the_references(mesh8, *CASES[name])
