"""The lambda functions through the port's `evaluate` against
presto_tpu's on the same seeded batch (tests/_torch_nested_common.py):
transform, filter, reduce, any_match, all_match and none_match over
arrays, and transform_values, transform_keys and map_filter over maps,
with captured columns (some staged at narrow lanes), NULL arrays and
elements, NULL predicates, K from 1 to 8, a lambda inside a lambda,
and reduce states that change type between steps. Results are held
exactly, doubles bit for bit.

Also the lambda wire format (`lambda`, `lambdavar`) and the batch
parameter's (`param`), which reads as the reference writes it and
evaluates only inside a bound_params scope, which exec/batching.py
opens.
"""

import pytest
import torch

from presto_tpu.expr import ir as RIR
from presto_tpu.expr.ir import Lambda, LambdaVariable

from _torch_nested_common import (KS, PB, PC, PIR, batches, call, canon,
                                  check, const, port_expr, ref, special, ty)

B, D, I, BOOL = ty("bigint"), ty("double"), ty("integer"), ty("boolean")
AB, AD = ty("array(bigint)"), ty("array(double)")
MB, MD = ty("map(bigint,bigint)"), ty("map(bigint,double)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Several test files share the machine's cores under xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lam(ret, params, body):
    return Lambda(ret, tuple(params), body)


def var(name, t):
    return LambdaVariable(t, name)


X, S, K, V = var("x", B), var("s", B), var("k", B), var("v", B)


def _cases():
    dx = var("x", D)
    return {
        "transform_captures": call("transform", AB, ref("arr"), lam(
            B, "x", call("add", B, call("multiply", B, X, ref("narrow")),
                         ref("wide")))),
        "transform_double": call("transform", AD, ref("darr"), lam(
            D, "x", call("multiply", D, dx, const(2.0, D)))),
        "transform_to_boolean": call("transform", ty("array(boolean)"),
                                     ref("arr"), lam(BOOL, "x", special(
                                         "IS_NULL", BOOL, X))),
        "transform_constant": call("transform", AB, ref("arr"),
                                   lam(B, "x", const(7, B))),
        "filter": call("filter", AB, ref("arr"), lam(
            BOOL, "x", call("gt", BOOL, X, ref("x")))),
        "filter_double": call("filter", AD, ref("darr"), lam(
            BOOL, "x", call("gt", BOOL, dx, const(0.0, D)))),
        "reduce_sum": call("reduce", B, ref("arr"), const(0, I), lam(
            B, "sx", call("add", B, S, X)), lam(B, "s", S)),
        "reduce_double_state": call("reduce", D, ref("arr"), const(0.0, D),
                                    lam(D, "sx", call("add", D, var("s", D),
                                                      X)),
                                    lam(D, "s", var("s", D))),
        "reduce_bigint_to_double": call(
            "reduce", D, ref("arr"), const(0, B),
            lam(D, "sx", call("add", D, S, call("multiply", D, X,
                                                 const(0.5, D)))),
            lam(D, "s", var("s", D))),
        "reduce_output_lambda": call("reduce", B, ref("arr"), ref("x"), lam(
            B, "sx", call("multiply", B, S, call("add", B, X, const(1, B)))),
            lam(B, "s", call("add", B, S, ref("wide")))),
        "any_match": call("any_match", BOOL, ref("arr"), lam(
            BOOL, "x", call("gt", BOOL, X, ref("x")))),
        "all_match": call("all_match", BOOL, ref("arr"), lam(
            BOOL, "x", call("gt", BOOL, X, ref("x")))),
        "none_match": call("none_match", BOOL, ref("arr"), lam(
            BOOL, "x", call("eq", BOOL, X, ref("x")))),
        "all_match_double": call("all_match", BOOL, ref("darr"), lam(
            BOOL, "x", call("ge", BOOL, dx, ref("dx")))),
        "lambda_in_lambda": call("transform", AB, ref("arr"), lam(
            B, "x", call("reduce", B, call("sequence", AB, const(1, B),
                                           const(3, B)), X,
                         lam(B, "sy", call("add", B, S, call(
                             "multiply", B, var("y", B), ref("x")))),
                         lam(B, "s", S)))),
        "cardinality_of_filter": call("cardinality", B, call(
            "filter", AB, call("transform", AB, call(
                "sequence", AB, const(1, B), const(8, B)),
                lam(B, "x", call("multiply", B, X, ref("narrow")))),
            lam(BOOL, "x", call("gt", BOOL, X, const(10, B))))),
        "transform_values": call("transform_values", MB, ref("map"), lam(
            B, "kv", call("add", B, V, call("multiply", B, K, ref("x"))))),
        "transform_values_double": call(
            "transform_values", MD, ref("dmap"),
            lam(D, "kv", call("multiply", D, var("v", D), const(2.0, D)))),
        "transform_keys": call("transform_keys", MB, ref("map"), lam(
            B, "kv", call("multiply", B, K, const(2, B)))),
        "transform_keys_duplicate": call("transform_keys", MB, ref("map"),
                                         lam(B, "kv", call(
                                             "modulus", B, K, const(3, B)))),
        "transform_keys_null": call("transform_keys", MB, ref("map"),
                                    lam(B, "kv", V)),
        "map_filter": call("map_filter", MB, ref("map"), lam(
            BOOL, "kv", call("gt", BOOL, V, const(0, B)))),
        "map_filter_captures": call("map_filter", MD, ref("dmap"), lam(
            BOOL, "kv", call("gt", BOOL, K, ref("x")))),
    }


CASES = _cases()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_lambda_equals_the_reference(name, k):
    check(CASES[name], seed=2, k=k)


def test_reduce_state_of_bigint_and_double_agree():
    """A bigint 0 and a double 0.0 as the initial state give the same
    double sums: the state widens when the step's result does."""
    _, pb = batches(2, 5)
    step = lam(D, "sx", call("add", D, var("s", D), X))
    out = lam(D, "s", var("s", D))
    a = PC.evaluate(port_expr(call("reduce", D, ref("arr"), const(0, B),
                                   step, out)), pb)
    b = PC.evaluate(port_expr(call("reduce", D, ref("arr"), const(0.0, D),
                                   step, out)), pb)
    assert a.values.dtype == torch.float64
    assert [canon(v) for v in PB.to_numpy(a)[0]] == \
        [canon(v) for v in PB.to_numpy(b)[0]]


def test_lambda_json_is_the_reference_json():
    for name in ("reduce_output_lambda", "transform_values"):
        j = RIR.to_json(CASES[name])
        assert PIR.to_json(PIR.from_json(j)) == j


def test_param_is_refused_naming_batching():
    """A `param` reads as the reference's JSON; evaluated outside a
    bound_params scope it is refused, naming exec/batching.py, as the
    reference refuses it; inside one it is the bound value."""
    from presto_tpu_torch.block import Batch
    from presto_tpu_torch.expr.compile import bound_params, evaluate
    j = RIR.to_json(RIR.BatchParam(B, 0))
    p = PIR.from_json(j)
    assert isinstance(p, PIR.BatchParam) and p.index == 0
    assert PIR.to_json(p) == j
    batch = Batch((), torch.ones(4, dtype=torch.bool))
    with pytest.raises(RuntimeError, match=r"exec/batching\.py"):
        evaluate(p, batch)
    with bound_params([(torch.tensor(7), torch.tensor(False))]):
        col = evaluate(p, batch)
    assert col.values.tolist() == [7] * 4 and not col.nulls.any()
