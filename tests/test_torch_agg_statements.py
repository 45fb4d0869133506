"""The aggregate statements of the SF1 corpus and the plan pieces of
two-stage aggregation through the port on the CPU, against presto_tpu.

The statements of scripts/make_tpch_corpus.py::AGGREGATES (the hash-slot
group-by with min_by/max_by/checksum/corr/geometric_mean, the moments
on the sorted path, approx_distinct grouped and global) and their
two-stage forms (add_exchanges) equal the reference's rows at sf 0.01:
exactly, doubles within rel 1e-9. Also: ExchangeNode JSON, the second
channel of min_by/max_by/corr in the JSON, PARTIAL output types, and
an INTERMEDIATE step between PARTIAL and FINAL.
"""

import json
import math

import pytest

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
from presto_tpu.exec import run_query as ref_run_query
from presto_tpu.plan import nodes as RN

from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import run_query
from presto_tpu_torch.ops.aggregation import AggSpec
from presto_tpu_torch.plan import from_json, to_json
from presto_tpu_torch.plan import nodes as PN

from make_tpch_corpus import AGGREGATES, TWO_STAGE, prepared_entry
from test_torch_two_stage import SF, _exact, _two_stage_json

REL = 1e-9  # the reference's tolerance for reordered moment sums


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, str) and b.startswith(("0x", "-0x")):
                assert math.isclose(float.fromhex(a), float.fromhex(b),
                                    rel_tol=REL), (g, w)
            else:
                assert a == b, (g, w)


AGGREGATE_ENTRIES = sorted(AGGREGATES) + \
    [a + TWO_STAGE for a in sorted(AGGREGATES)]


@pytest.mark.parametrize("name", AGGREGATE_ENTRIES)
def test_aggregate_statement_returns_the_reference_rows(name):
    """Integers, strings, booleans and HLL estimates exact; the moment
    doubles (corr, geometric_mean, stddev, var) within rel 1e-9."""
    prepared = prepared_entry(name, SF)
    want = ref_run_query(prepared, sf=SF, prepared=True)
    assert want.row_count > 0
    got = run_query(from_json(RN.to_json(prepared)), sf=SF, device="cpu",
                    prepared=True)
    assert got.names == list(want.names)
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    _same_rows(_exact(got), _exact(want))


def test_exchange_json_round_trips_like_the_reference():
    """Every exchange kind the reference writes (REPARTITION with its
    slot capacity, GATHER, REPLICATE, MERGE with sort keys) reads into an
    ExchangeNode and writes back the same JSON."""
    kinds = set()
    for n in (1, 2, 3):
        plan = _two_stage_json(f"q{n}")
        assert to_json(from_json(plan)) == plan
        stack = [from_json(plan)]
        while stack:
            node = stack.pop()
            if isinstance(node, PN.ExchangeNode):
                kinds.add(node.kind)
                assert node.scope == "REMOTE"
                assert node.output_types() == node.source.output_types()
            stack.extend(node.sources)
    assert kinds == {"REPARTITION", "GATHER", "REPLICATE", "MERGE"}


def test_second_channel_survives_the_json():
    """min_by/max_by and corr name a second input: from_json keeps its
    channel and type (they were dropped before), to_json writes them."""
    plan = _two_stage_json("agg_hash")
    root = from_json(plan)
    aggs = []
    stack = [root]
    while stack:
        node = stack.pop()
        if isinstance(node, PN.AggregationNode):
            aggs.append(node)
        stack.extend(node.sources)
    assert {a.step for a in aggs} == {"PARTIAL", "FINAL"}
    for a in aggs:
        by = {s.name: s for s in a.aggregates}
        assert by["min_by"].second_type == PT.decimal(12, 2)
        assert by["max_by"].second_type == PT.decimal(12, 2)
        assert by["corr"].second_channel is not None
        assert by["min_by"].second_channel != by["min_by"].input_channel
    assert to_json(root) == plan
    spec = AggSpec("max_by", 0, PT.BIGINT, second_channel=3,
                   second_type=PT.DOUBLE)
    j = PN._agg_to_json(spec)
    assert j == {"name": "max_by", "input": 0, "type": "bigint",
                 "secondChannel": 3, "secondType": "double"}
    assert PN._agg_from_json(j) == spec


def test_partial_output_types_are_the_state_layout():
    """A PARTIAL node's output types are its state columns (avg: sum and
    count; min_by: value and order; approx_distinct: its registers),
    as the reference's."""
    for name in ("agg_hash", "approx_distinct", "q1"):
        ref = prepared_entry(name + TWO_STAGE, SF)
        port = from_json(RN.to_json(ref))
        stack = [(ref, port)]
        while stack:
            r, p = stack.pop()
            assert [str(t) for t in p.output_types()] == \
                [str(t) for t in r.output_types()], type(p).__name__
            stack.extend(zip(r.sources, p.sources))


def test_intermediate_step_matches_the_reference():
    """PARTIAL -> INTERMEDIATE -> FINAL: the INTERMEDIATE step merges
    state tables into the same state layout (no finalize), for the
    moments, min_by/max_by and the HLL registers too."""
    import dataclasses
    for name in ("agg_hash", "approx_distinct", "q1"):
        plan = prepared_entry(name + TWO_STAGE, SF)
        stack, final = [plan], None
        while stack:
            node = stack.pop()
            if isinstance(node, RN.AggregationNode) and node.step == "FINAL":
                final = node
            stack.extend(node.sources)
        inter = dataclasses.replace(final, source=final.source,
                                    step="INTERMEDIATE", id=final.id + "i")
        # the FINAL now reads the INTERMEDIATE's merged states
        final.source = inter
        want = ref_run_query(plan, sf=SF, prepared=True)
        got = run_query(from_json(RN.to_json(plan)), sf=SF, device="cpu",
                        prepared=True)
        assert '"INTERMEDIATE"' in json.dumps(RN.to_json(plan))
        _same_rows(_exact(got), _exact(want))
