"""The reference's TPC-DS corpus through the port, on the CPU: q73-q99
(tests/test_torch_tpcds_corpus.py holds the rest and says how)."""

import pytest

from test_torch_tpcds_corpus import (check_query, corpus_slice,
                                     one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("name", corpus_slice(73, 99))
def test_tpcds_query_returns_the_reference_rows(name):
    check_query(name)
