"""The 14 functions over arrays, maps and rows, ARRAY[...], sequence
and row_field through the port's `evaluate`, against presto_tpu's on
the same seeded batch (tests/_torch_nested_common.py): NULL and empty
arrays, NULL elements, negative, zero and out-of-range indexes (and one
that wraps when read as int32), slices from start 0, doubles with NaN,
-0.0 and infinities, captured columns staged at narrow lanes, and K
from 1 to 8. Every result is held exactly, doubles bit for bit.

The reference's own cases (tests/test_arrays_unnest.py's function
case) are here too, on the port alone, with their expected values.
"""

import numpy as np
import pytest
import torch

from _torch_nested_common import (CH, KS, PB, PC, RB, RC, batches, call,
                                  canon, check, const, input_ref, port_expr,
                                  ref, ty)

B, D, I, BOOL = ty("bigint"), ty("double"), ty("integer"), ty("boolean")
AB, AD, AI = ty("array(bigint)"), ty("array(double)"), ty("array(integer)")


def _cases():
    a, d, m = ref("arr"), ref("darr"), ref("map")
    return {
        "cardinality_array": call("cardinality", B, a),
        "cardinality_map": call("cardinality", B, m),
        "element_at_array": call("element_at", B, a, ref("idx")),
        "element_at_double_array": call("element_at", D, d, ref("x")),
        "element_at_map": call("element_at", B, m, ref("x")),
        "element_at_double_map": call("element_at", D, ref("dmap"),
                                      ref("x")),
        "contains": call("contains", BOOL, a, ref("x")),
        "contains_double": call("contains", BOOL, d, ref("dx")),
        "array_max": call("array_max", B, a),
        "array_min": call("array_min", B, a),
        "array_max_double": call("array_max", D, d),
        "array_min_double": call("array_min", D, d),
        "array_position": call("array_position", B, a, ref("x")),
        "array_position_double": call("array_position", B, d, ref("dx")),
        "array_sum": call("array_sum", B, a),
        "array_sum_double": call("array_sum", D, d),
        "array_sum_integer": call("array_sum", B, ref("iarr")),
        "array_sort": call("array_sort", AB, a),
        "array_sort_double": call("array_sort", AD, d),
        "array_sort_integer": call("array_sort", AI, ref("iarr")),
        "array_distinct": call("array_distinct", AB, a),
        "array_distinct_double": call("array_distinct", AD, d),
        "slice": call("slice", AB, a, ref("idx"), ref("len")),
        "slice_double": call("slice", AD, d, ref("x"), ref("len")),
        "map_keys": call("map_keys", AB, m),
        "map_values": call("map_values", AB, m),
        "map_values_double": call("map_values", AD, ref("dmap")),
        "row_field_0": call("row_field", B, ref("row"), const(0, I)),
        "row_field_1": call("row_field", ty("varchar(4)"), ref("row"),
                            const(1, I)),
        "row_pack": call("row_pack", ty("row(bigint,double)"), ref("x"),
                         ref("dx")),
        "array_constructor": call("array_constructor", AB, ref("x"),
                                  ref("narrow"), ref("wide"),
                                  const(None, B)),
        "array_constructor_double": call("array_constructor", AD, ref("dx"),
                                         const(2.5, D)),
        "array_constructor_empty": call("array_constructor",
                                        ty("array(unknown)")),
        "sequence_up": call("sequence", AB, const(1, B), const(8, B)),
        "sequence_down": call("sequence", AB, const(5, B), const(-2, B)),
        "sequence_step": call("sequence", AB, const(1, B), const(10, B),
                              const(3, B)),
        "sequence_one": call("sequence", AB, const(3, B), const(3, B)),
        "last_of_sorted_constructor": call(
            "element_at", B, call("array_sort", AB, call(
                "array_constructor", AB, ref("x"), ref("wide"),
                ref("narrow"))), const(-1, B)),
        "distinct_of_slice": call("cardinality", B, call(
            "array_distinct", AB, call("slice", AB, ref("arr"), const(1, B),
                                       const(3, B)))),
        "position_in_map_keys": call("array_position", B, call(
            "map_keys", AB, ref("map")), ref("x")),
    }


CASES = _cases()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_function_equals_the_reference(name, k):
    check(CASES[name], seed=1, k=k)


@pytest.mark.parametrize("largest", [True, False])
def test_array_max_min_of_integer_arrays_widen_first(largest):
    """The reference takes the int64 extreme as the identity of an
    int32 array, where it wraps to 0 or -1 (array_max of [-7] is 0,
    ROADMAP queue 3); the port widens the lanes first, so its answer is
    the true extreme, held against Python's."""
    name = "array_max" if largest else "array_min"
    for k in KS:
        _, pb = batches(1, k)
        out = PC.evaluate(port_expr(call(name, I, ref("iarr"))), pb)
        got, nulls = PB.to_numpy(out)
        arrays, _ = PB.to_numpy(pb.column(CH["iarr"]))
        for i in range(len(arrays)):
            live = [v for v in (arrays[i] or []) if v is not None]
            assert bool(nulls[i]) == (not live)
            if live:
                assert got[i] == (max(live) if largest else min(live))


def test_registered_row_field_reads_the_index_column():
    """The registered row_field (reached without `evaluate`'s
    interception) takes its index from the column's first lane."""
    from presto_tpu.expr import functions as RF
    from presto_tpu_torch.expr import functions as PF
    rb, pb = batches(1, 3)
    ch = CH["row"]
    ridx = RC.evaluate(const(1, I), rb)
    pidx = PC.evaluate(port_expr(const(1, I)), pb)
    r = RF.lookup("row_field").fn(ty("varchar(4)"), rb.column(ch), ridx)
    p = PF.lookup("row_field").fn(ty("varchar(4)"), pb.column(ch), pidx)
    assert [canon(v) for v in RB.to_numpy(r)[0]] == \
        [canon(v) for v in PB.to_numpy(p)[0]]


def test_element_at_reads_the_index_as_int32():
    """An index of 2^32 + 1 wraps to 1, as in the reference."""
    _, pb = batches(1, 4)
    idx = call("element_at", B, ref("arr"), const((1 << 32) + 1, B))
    one = call("element_at", B, ref("arr"), const(1, B))
    a = PB.to_numpy(PC.evaluate(port_expr(idx), pb))
    b = PB.to_numpy(PC.evaluate(port_expr(one), pb))
    np.testing.assert_array_equal(a[1], b[1])
    assert [canon(v) for v in a[0][~a[1]]] == [canon(v) for v in b[0][~b[1]]]


def test_slice_from_start_zero_is_null():
    """Presto raises on start 0; the reference, and the port, give
    NULL."""
    _, pb = batches(1, 4)
    out = PC.evaluate(port_expr(call("slice", AB, ref("arr"), const(0, B),
                                     const(2, B))), pb)
    assert bool(out.nulls.all())


def test_array_of_strings_is_refused_as_in_the_reference():
    _, pb = batches(1, 2)
    with pytest.raises(NotImplementedError, match="strings"):
        PC.evaluate(port_expr(call("array_constructor",
                                   ty("array(varchar(4))"),
                                   const("ab", ty("varchar(4)")))), pb)


def test_reference_array_cases_on_the_port():
    """tests/test_arrays_unnest.py::test_cardinality_element_at_contains
    on the port."""
    col = PB.from_numpy(ty("array(bigint)"), np.array(
        [[10, 20, 30], [], None, [5]], dtype=object), device="cpu")
    ids = PB.from_numpy(B, np.arange(4, dtype=np.int64), device="cpu")
    b = PB.Batch((ids, col), torch.ones(4, dtype=torch.bool))
    x = input_ref(1, ty("array(bigint)"))

    def ev(e):
        return PB.to_numpy(PC.evaluate(port_expr(e), b))

    v, n = ev(call("cardinality", B, x))
    assert list(v[:2]) == [3, 0] and n[2]
    v, n = ev(call("element_at", B, x, const(2, B)))
    assert v[0] == 20 and n[1] and n[2] and n[3]
    v, n = ev(call("element_at", B, x, const(-1, B)))
    assert v[0] == 30 and v[3] == 5
    v, n = ev(call("contains", BOOL, x, const(20, B)))
    assert v[0] and not v[1] and not v[3]
    v, n = ev(call("array_max", B, x))
    assert v[0] == 30 and n[1] and n[2]
