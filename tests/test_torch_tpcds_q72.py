"""TPC-DS q72 through the port, on the CPU, against the reference's
committed rows at its suite sf 0.1 (tests/test_torch_tpcds_corpus.py
says how). Its plan joins catalog_sales with inventory on the item
alone, so the ladder climbs to a 16.8M-row join, which every later
join of the plan gathers again: about three minutes of one CPU thread,
85 s of three. The file runs it alone, on three torch threads, beside
the corpus files' one thread each."""

import pytest
import torch

from test_torch_tpcds_corpus import check_query, corpus_slice

Q72_THREADS = 3


@pytest.fixture(autouse=True, scope="module")
def three_torch_threads():
    """Three torch threads while the module runs: with the other test
    workers on one thread each, the host's cores are not
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(Q72_THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", corpus_slice(72, 72))
def test_tpcds_query_returns_the_reference_rows(name):
    check_query(name)
