"""SQL analyzer + logical planner: AST -> typed plan.

The port's copy of presto_tpu/sql/planner.py. It resolves names
against the port's catalogs, infers types (Presto's decimal rules,
simplified division scale), detects aggregates, and emits the
reference's plan shapes (scan -> filter -> project -> aggregate ->
having -> project -> sort/topN/limit), joins left-deep in FROM order.
`sql()` is the one-call front door: meta statements, planning,
`prepare_plan` and the run on the port's device.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..expr import ir as E
from ..ops.aggregation import AggSpec
from ..plan import nodes as N
from . import parser as P

__all__ = ["plan_sql", "sql"]

_AGG_NAMES = {"sum", "count", "min", "max", "avg", "approx_distinct",
              "bool_and", "bool_or", "arbitrary", "every", "any_value",
              "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
              "var_pop", "corr", "covar_samp", "covar_pop", "regr_slope",
              "regr_intercept", "geometric_mean", "checksum", "min_by",
              "max_by"}

# aggregates taking a second input column (value, order) / (y, x)
_TWO_ARG_AGGS = {"min_by", "max_by", "corr", "covar_samp", "covar_pop",
                 "regr_slope", "regr_intercept"}


@dataclasses.dataclass
class _Scope:
    """Name -> (channel, type); qualified and unqualified forms."""
    channels: Dict[str, int]
    types: List[T.Type]

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[int, T.Type]:
        key = ".".join(parts).lower()
        if key in self.channels:
            ch = self.channels[key]
            return ch, self.types[ch]
        raise KeyError(f"column {key!r} not found; have {sorted(self.channels)}")


def _days(lit: str) -> int:
    return int((np.datetime64(lit) - np.datetime64("1970-01-01")).astype(int))


class _Analyzer:
    def __init__(self, query: P.Query, sf_catalog: str = "tpch"):
        self.q = query
        self.catalog = sf_catalog
        # id(WindowExpr) -> (channel, type) once a window stage planned
        self.window_channels: Dict[int, Tuple[int, T.Type]] = {}
        # id(InSubquery/Exists) -> mask expression, for subqueries in
        # DISJUNCTIVE predicate positions (planned as semijoin mask
        # columns before the enclosing predicate lowers)
        self.subquery_masks: Dict[int, E.RowExpression] = {}

    # -- expression lowering ------------------------------------------------

    def lower(self, node, scope: _Scope) -> E.RowExpression:
        if not isinstance(node, (str, int, float)) and \
                id(node) in self.subquery_masks:
            return self.subquery_masks[id(node)]
        if isinstance(node, P.WindowExpr):
            hit = self.window_channels.get(id(node))
            if hit is None:
                raise NotImplementedError(
                    "window expression outside the planned window stage")
            return E.input_ref(*hit)
        if isinstance(node, P.Literal):
            return self._literal(node)
        if isinstance(node, P.Name):
            lvars = getattr(scope, "lambda_vars", None)
            if lvars and len(node.parts) == 1 \
                    and node.parts[0].lower() in lvars:
                nm = node.parts[0].lower()
                return E.LambdaVariable(lvars[nm], nm)
            ch, ty = scope.resolve(node.parts)
            return E.input_ref(ch, ty)
        if isinstance(node, P.BinOp):
            return self._binop(node, scope)
        if isinstance(node, P.NotOp):
            a = self.lower(node.arg, scope)
            return E.call("not", T.BOOLEAN, a)
        if isinstance(node, P.Between):
            e = E.special("BETWEEN", T.BOOLEAN, self.lower(node.value, scope),
                          *(self._coerce_pair(self.lower(node.value, scope),
                                              self.lower(x, scope))[1]
                            for x in (node.lo, node.hi)))
            return E.call("not", T.BOOLEAN, e) if node.negate else e
        if isinstance(node, P.InList):
            v = self.lower(node.value, scope)
            items = [self._coerce_pair(v, self.lower(x, scope))[1]
                     for x in node.items]
            e = E.special("IN", T.BOOLEAN, v, *items)
            return E.call("not", T.BOOLEAN, e) if node.negate else e
        if isinstance(node, P.Like):
            v = self.lower(node.value, scope)
            e = E.call("like", T.BOOLEAN, v,
                       E.const(node.pattern, T.varchar(len(node.pattern))))
            return E.call("not", T.BOOLEAN, e) if node.negate else e
        if isinstance(node, P.IsNull):
            e = E.special("IS_NULL", T.BOOLEAN, self.lower(node.value, scope))
            return E.call("not", T.BOOLEAN, e) if node.negate else e
        if isinstance(node, P.Case):
            whens = []
            for c, r in node.whens:
                whens.append((self.lower(c, scope), self.lower(r, scope)))
            default = self.lower(node.default, scope) if node.default else None
            rty = _case_result_type([r for _, r in whens]
                                    + ([default] if default else []))
            args: List[E.RowExpression] = []
            if node.operand is not None:
                args.append(self.lower(node.operand, scope))
            else:
                args.append(E.const(True, T.BOOLEAN))
            for c, r in whens:
                args.append(E.special("WHEN", rty, c, _cast_branch(r, rty)))
            if default is not None:
                args.append(_cast_branch(default, rty))
            return E.special("SWITCH", rty, *args)
        if isinstance(node, P.Cast):
            v = self.lower(node.value, scope)
            ty = T.parse_type(node.type_name)
            return E.call("try_cast" if node.safe else "cast", ty, v)
        if isinstance(node, P.Func):
            return self._func(node, scope)
        raise NotImplementedError(f"cannot lower {node}")

    def _literal(self, lit: P.Literal) -> E.Constant:
        if lit.kind == "int":
            return E.const(lit.value, T.BIGINT)
        if lit.kind.startswith("decimal:"):
            scale = int(lit.kind.split(":")[1])
            return E.const(lit.value, T.decimal(38, scale))
        if lit.kind == "string":
            return E.const(lit.value, T.varchar(max(len(lit.value), 1)))
        if lit.kind == "bool":
            return E.const(lit.value, T.BOOLEAN)
        if lit.kind == "null":
            return E.const(None, T.UNKNOWN)
        if lit.kind == "date":
            return E.const(_days(lit.value), T.DATE)
        if lit.kind == "interval":
            n, unit = lit.value
            unit = unit.lower()
            if unit in ("year", "month"):
                months = n * 12 if unit == "year" else n
                return E.const(months, T.INTERVAL_YM)
            us = {"week": 7 * 86_400_000_000, "day": 86_400_000_000,
                  "hour": 3_600_000_000, "minute": 60_000_000,
                  "second": 1_000_000, "millisecond": 1_000}.get(unit)
            if us is None:
                raise NotImplementedError(f"interval unit {unit!r}")
            return E.const(n * us, T.INTERVAL_DS)
        if lit.kind == "timestamp":
            micros, key = _parse_ts_literal(lit.value)
            if key is None:
                return E.const(micros, T.TIMESTAMP)
            return E.const((micros << 12) | key, T.TIMESTAMP_TZ)
        if lit.kind == "time":
            return E.const(_parse_time_literal(lit.value), T.TIME)
        raise NotImplementedError(lit.kind)

    def _coerce_pair(self, a: E.RowExpression, b: E.RowExpression):
        """Implicit coercions for comparisons: align string widths, keep
        numerics (comparison kernels rescale internally)."""
        return a, b

    def _binop(self, node: P.BinOp, scope: _Scope) -> E.RowExpression:
        op = node.op
        if op in ("and", "or"):
            return E.special(op.upper(), T.BOOLEAN,
                             self.lower(node.left, scope),
                             self.lower(node.right, scope))
        a = self.lower(node.left, scope)
        b = self.lower(node.right, scope)
        if op in ("=", "<>", "!=", "<", "<=", ">", ">="):
            name = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt",
                    "<=": "le", ">": "gt", ">=": "ge"}[op]
            return E.call(name, T.BOOLEAN, a, b)
        # datetime +/- interval, interval +/- interval,
        # datetime - datetime -> INTERVAL DAY TO SECOND
        _DT = ("date", "time", "timestamp", "timestamp with time zone")
        _IV = ("interval year to month", "interval day to second")
        if op in ("+", "-"):
            if a.type.base in _DT and b.type.base in _IV:
                if a.type.base == "date" \
                        and b.type.base == "interval day to second" \
                        and isinstance(b, E.Constant) \
                        and b.value is not None \
                        and b.value % 86_400_000_000 != 0:
                    raise ValueError(
                        "Cannot add hour, minutes or seconds to a date")
                rhs = E.call("negate", b.type, b) if op == "-" else b
                return E.call("datetime_interval_add",
                              _dt_plus_interval_type(a.type, b.type),
                              a, rhs)
            if op == "+" and a.type.base in _IV and b.type.base in _DT:
                return E.call("datetime_interval_add",
                              _dt_plus_interval_type(b.type, a.type), b, a)
            if a.type.base in _IV and b.type.base == a.type.base:
                return E.call("add" if op == "+" else "subtract",
                              a.type, a, b)
            if op == "-" and a.type.base in _DT and b.type.base in _DT \
                    and "time" not in (a.type.base, b.type.base):
                return E.call("datetime_diff_micros", T.INTERVAL_DS, a, b)
        name = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide",
                "%": "modulus"}[op]
        rty = self._arith_type(name, a.type, b.type)
        return E.call(name, rty, a, b)

    def _arith_type(self, name: str, t1: T.Type, t2: T.Type) -> T.Type:
        if t1.is_floating or t2.is_floating:
            return T.DOUBLE
        if t1.is_decimal or t2.is_decimal:
            s1 = t1.scale if t1.is_decimal else 0
            s2 = t2.scale if t2.is_decimal else 0
            if name in ("add", "subtract"):
                return T.decimal(38, max(s1, s2))
            if name == "multiply":
                return T.decimal(38, s1 + s2)
            if name == "divide":
                # the reference computes precision-aware decimal scales on
                # int128; on int64 lanes the dividend rescale overflows for
                # wide operands, so SQL-level decimal division yields DOUBLE
                # (exact decimal division survives where scales stay small,
                # e.g. the avg finalizer)
                return T.DOUBLE
            if name == "modulus":
                return T.decimal(38, max(s1, s2))
        if t1.is_integral and t2.is_integral:
            return T.BIGINT
        if t1.base == "date" and t2.base == "date" and name == "subtract":
            return T.BIGINT
        return t1 if t1.is_numeric else t2

    def _func(self, node: P.Func, scope: _Scope) -> E.RowExpression:
        name = node.name
        if any(isinstance(a, P.Lambda) for a in node.args):
            return self._lambda_func(node, scope)
        args = [self.lower(a, scope) for a in node.args
                if not isinstance(a, P.Star)]
        # special forms spelled as functions (branch types align to the
        # common type, same as CASE -- see _case_result_type)
        if name == "coalesce":
            rty = _case_result_type(args)
            return E.special("COALESCE", rty,
                             *[_cast_branch(a, rty) for a in args])
        if name == "nullif":
            rty = _case_result_type(args[:1])
            return E.special("NULL_IF", rty, *args)
        if name == "if":
            rty = _case_result_type(args[1:])
            return E.special("IF", rty,
                             args[0], *[_cast_branch(a, rty)
                                        for a in args[1:]])
        if name == "try":
            if len(args) != 1:
                raise ValueError("TRY requires exactly one argument")
            # kernels are total (errors produce NULL lanes, never raise),
            # so TRY is the identity on this engine
            return args[0]
        udf_hit = None
        if "." in name:
            from .udf import get_function_namespace_manager
            udf_hit = get_function_namespace_manager().lookup(name)
            if udf_hit is None:
                raise NotImplementedError(f"no function {name!r}")
        if udf_hit is not None:
            return self._expand_udf(udf_hit, args)
        if name in ("now", "current_timestamp"):
            from .. import tz as _tz
            return E.const(_statement_now_us() << 12 | _tz.UTC_KEY,
                           T.TIMESTAMP_TZ)
        if name == "current_date":
            return E.const(_statement_now_us() // 86_400_000_000, T.DATE)
        if name == "localtimestamp":
            return E.const(_statement_now_us(), T.TIMESTAMP)
        try:
            rty = self._func_type(name, args)
        except NotImplementedError:
            # unqualified SQL-invoked functions resolve AFTER builtins
            # (presto.default namespace; the reference's resolution
            # order)
            from .udf import get_function_namespace_manager
            udf = get_function_namespace_manager().lookup(name)
            if udf is None:
                raise
            return self._expand_udf(udf, args)
        return E.call(name, rty, *args)

    def _expand_udf(self, udf, args: List[E.RowExpression]
                    ) -> E.RowExpression:
        """SQL-invoked function: inline the body with parameters bound
        to the lowered argument expressions (a typed macro -- the UDF
        dissolves before XLA sees the plan). Arguments coerce to the
        declared parameter types (mismatches are plan-time errors);
        substitution is scope-aware (lambda parameters shadowing a UDF
        parameter are NOT captured); recursion is rejected."""
        from .udf import body_ast as _body_ast
        if len(args) != len(udf.parameters):
            raise ValueError(
                f"{udf.qualified_name} takes {len(udf.parameters)} "
                f"argument(s), got {len(args)}")
        in_progress = _UDF_EXPANDING.get()
        if udf.qualified_name in in_progress:
            raise ValueError(
                f"recursive SQL function {udf.qualified_name!r}")
        token = _UDF_EXPANDING.set(in_progress | {udf.qualified_name})
        try:
            ls = _Scope({}, [])
            ls.lambda_vars = {p: ty for p, ty in udf.parameters}
            body = self.lower(_body_ast(udf), ls)
        finally:
            _UDF_EXPANDING.reset(token)
        binding = {}
        for (pname, pty), a in zip(udf.parameters, args):
            if a.type != pty:
                compatible = (a.type.is_numeric and pty.is_numeric) or                     (a.type.is_string and pty.is_string) or                     a.type == T.UNKNOWN
                if not compatible:
                    raise ValueError(
                        f"{udf.qualified_name} parameter {pname!r} is "
                        f"{pty}, got {a.type}")
                a = E.call("cast", pty, a)
            binding[pname] = a

        body = _substitute_capture_free(body, binding)
        if body.type != udf.return_type:
            body = E.call("cast", udf.return_type, body)
        return body

    def _lambda_func(self, node: P.Func, scope: _Scope) -> E.RowExpression:
        """Array/map higher-order functions (ArrayTransformFunction.java
        family): lambda bodies lower with parameters as LambdaVariables;
        captures stay plain InputReferences of the enclosing scope."""
        name = node.name

        def lower_lambda(lam: P.Lambda, param_types) -> E.Lambda:
            assert len(lam.params) == len(param_types), \
                f"{name} lambda takes {len(param_types)} parameter(s)"
            import copy
            ls = _Scope(dict(scope.channels), list(scope.types))
            ls.lambda_vars = {**(getattr(scope, "lambda_vars", None) or {}),
                              **dict(zip(lam.params, param_types))}
            body = self.lower(lam.body, ls)
            return E.Lambda(body.type, tuple(lam.params), body)

        arr = self.lower(node.args[0], scope)
        if arr.type.base == "map":
            kty, vty = arr.type.key_type, arr.type.value_type
            if name == "transform_values":
                lam = lower_lambda(node.args[1], [kty, vty])
                return E.call("transform_values", T.map_of(kty, lam.type),
                              arr, lam)
            if name == "transform_keys":
                lam = lower_lambda(node.args[1], [kty, vty])
                return E.call("transform_keys", T.map_of(lam.type, vty),
                              arr, lam)
            if name == "map_filter":
                lam = lower_lambda(node.args[1], [kty, vty])
                return E.call("map_filter", arr.type, arr, lam)
            raise NotImplementedError(f"lambda function {name!r} over map")
        if arr.type.base != "array":
            raise NotImplementedError(f"{name} over {arr.type}")
        ety = arr.type.element_type
        if name == "transform":
            lam = lower_lambda(node.args[1], [ety])
            return E.call("transform", T.array_of(lam.type), arr, lam)
        if name == "filter":
            lam = lower_lambda(node.args[1], [ety])
            return E.call("filter", arr.type, arr, lam)
        if name in ("any_match", "all_match", "none_match"):
            lam = lower_lambda(node.args[1], [ety])
            return E.call(name, T.BOOLEAN, arr, lam)
        if name == "reduce":
            init = self.lower(node.args[1], scope)
            comb = lower_lambda(node.args[2], [init.type, ety])
            if comb.type != init.type:
                raise NotImplementedError(
                    "reduce state type must stay fixed "
                    f"({init.type} vs {comb.type})")
            out = lower_lambda(node.args[3], [init.type])
            return E.call("reduce", out.type, arr, init, comb, out)
        raise NotImplementedError(f"lambda function {name!r}")

    def _func_type(self, name: str, args: List[E.RowExpression]) -> T.Type:
        if name in ("timezone_hour", "timezone_minute"):
            if args[0].type.base != "timestamp with time zone":
                raise NotImplementedError(
                    f"{name} needs TIMESTAMP WITH TIME ZONE, "
                    f"got {args[0].type}")
            return T.BIGINT
        if name in ("year", "month", "day", "quarter", "length", "strpos",
                    "position", "codepoint", "day_of_week", "day_of_year",
                    "date_diff", "sign", "hour", "minute", "second",
                    "millisecond", "json_array_length", "json_size",
                    "crc32", "regexp_position", "regexp_count"):
            return T.BIGINT
        if name == "at_timezone":
            return T.TIMESTAMP_TZ
        if name in ("json_parse", "json_extract"):
            return T.JSON
        if name == "json_format":
            return T.varchar(args[0].type.max_length)
        if name == "json_extract_scalar":
            return T.varchar(args[0].type.max_length)
        if name in ("json_array_contains", "is_json_scalar"):
            return T.BOOLEAN
        if name in ("regexp_extract", "regexp_replace"):
            return T.varchar()
        if name == "to_hex":
            w = args[0].type.max_length
            return T.varchar(2 * w if w < T.UNBOUNDED_LENGTH else w)
        if name in ("from_hex", "to_utf8", "md5", "sha1", "sha256",
                    "sha512"):
            return T.VARBINARY
        if name == "from_utf8":
            return T.varchar(args[0].type.max_length)
        if name in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                    "substr", "split_part"):
            return args[0].type
        if name == "regexp_like":
            return T.BOOLEAN
        if name == "date_format":
            width = 32
            if isinstance(args[1], E.Constant):
                from ..expr.functions import date_format_width
                width = date_format_width(str(args[1].value))
            return T.varchar(width)
        if name == "concat":
            width = sum(a.type.max_length if a.type.is_string else 8
                        for a in args)
            return T.varchar(width)
        if name == "great_circle_distance":
            return T.DOUBLE
        if name in ("bing_tile_x", "bing_tile_y"):
            return T.BIGINT
        if name == "bing_tile_quadkey_at":
            return T.varchar(23)
        if name in ("sqrt", "exp", "ln", "log10", "power", "pow",
                    "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
                    "sinh", "cosh", "tanh", "cbrt", "log2", "log",
                    "degrees", "radians", "to_unixtime"):
            return T.DOUBLE
        if name in ("is_nan", "is_finite", "is_infinite", "ends_with"):
            return T.BOOLEAN
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_not", "bitwise_left_shift",
                    "bitwise_right_shift", "bitwise_right_shift_arithmetic",
                    "bit_count", "array_position"):
            return T.BIGINT
        if name == "array_sum":
            ety = args[0].type.element_type
            return T.DOUBLE if ety.is_floating else T.BIGINT
        if name == "mod":
            return args[0].type
        if name == "from_unixtime":
            return T.TIMESTAMP
        if name in ("abs", "negate", "floor", "ceil", "ceiling", "round",
                    "truncate", "greatest", "least"):
            return args[0].type
        if name in ("date_trunc", "last_day_of_month", "date_add"):
            return T.DATE
        if name in ("like", "starts_with", "is_distinct_from", "not"):
            return T.BOOLEAN
        if name == "chr":
            return T.varchar(1)
        if name == "cast":
            return args[0].type
        if name == "cardinality":
            return T.BIGINT
        if name == "array_constructor":
            ety = _case_result_type(args) if args else T.UNKNOWN
            return T.array_of(ety)
        if name == "sequence":
            return T.array_of(T.BIGINT)
        if name in ("array_distinct", "array_sort", "slice"):
            return args[0].type
        if name == "element_at":
            t0 = args[0].type
            if t0.base == "map":
                return t0.value_type
            if t0.base == "array":
                return t0.element_type
            raise NotImplementedError(f"element_at over {t0}")
        if name == "contains":
            return T.BOOLEAN
        if name == "map_keys":
            return T.array_of(args[0].type.key_type)
        if name == "map_values":
            return T.array_of(args[0].type.value_type)
        raise NotImplementedError(f"no type rule for function {name!r}")

    # -- aggregate detection ------------------------------------------------

    def find_aggs(self, node, window_args: bool = False) -> List[P.Func]:
        """Collect group-aggregate calls. Window expressions are NOT
        group aggregates themselves; with window_args=True (a GROUP BY
        is present) the aggregates INSIDE a window's arguments/clauses
        are collected (q53's avg(sum(x)) OVER shape), else the whole
        window subtree is skipped (q12's sum(x) OVER over detail rows)."""
        out = []

        def walk(n):
            if isinstance(n, P.WindowExpr):
                if window_args:
                    for a in n.func.args:
                        if dataclasses.is_dataclass(a):
                            walk(a)
                    for p in n.partition_by:
                        if dataclasses.is_dataclass(p):
                            walk(p)
                    for o in n.order_by:
                        if dataclasses.is_dataclass(o.expr):
                            walk(o.expr)
                return
            if isinstance(n, (P.InSubquery, P.Exists, P.ScalarSubquery)):
                return  # subqueries aggregate in their own scope
            if isinstance(n, P.Func) and n.name in _AGG_NAMES:
                out.append(n)
                return  # no nested aggs
            for f in dataclasses.fields(n) if dataclasses.is_dataclass(n) else []:
                v = getattr(n, f.name)
                if dataclasses.is_dataclass(v):
                    walk(v)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if dataclasses.is_dataclass(x):
                            walk(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if dataclasses.is_dataclass(y):
                                    walk(y)
        if dataclasses.is_dataclass(node):
            walk(node)
        return out


# UDF names whose expansion is in progress (recursion detection)
_UDF_EXPANDING: contextvars.ContextVar = contextvars.ContextVar(
    "udf_expanding", default=frozenset())

_FRESH = [0]


def _free_lambda_vars(e) -> set:
    """Names of LambdaVariables FREE in `e` (not bound by a Lambda
    inside `e`)."""
    if isinstance(e, E.LambdaVariable):
        return {e.name}
    if isinstance(e, E.Lambda):
        return _free_lambda_vars(e.body) - set(e.parameters)
    out = set()
    for c in e.children():
        out |= _free_lambda_vars(c)
    return out


def _rename_lambda_vars(e, mapping: dict):
    """Alpha-rename: LambdaVariable occurrences of `mapping` keys take
    the new names; inner lambdas rebinding a key shadow it."""
    if isinstance(e, E.LambdaVariable):
        if e.name in mapping:
            return E.LambdaVariable(e.type, mapping[e.name])
        return e
    if isinstance(e, E.Lambda):
        inner = {k: v for k, v in mapping.items()
                 if k not in e.parameters}
        nb = _rename_lambda_vars(e.body, inner) if inner else e.body
        return e if nb is e.body else E.Lambda(e.type, e.parameters, nb)
    if isinstance(e, E.Call):
        na = tuple(_rename_lambda_vars(x, mapping) for x in e.arguments)
        return e if na == e.arguments else E.Call(e.type, e.name, na)
    if isinstance(e, E.SpecialForm):
        na = tuple(_rename_lambda_vars(x, mapping) for x in e.arguments)
        return e if na == e.arguments else \
            E.SpecialForm(e.type, e.form, na)
    return e


def _substitute_capture_free(e, bnd: dict):
    """Capture-avoiding substitution of LambdaVariables: (a) lambda
    parameters shadowing a binding key bind tighter (the key is not
    substituted inside), and (b) lambda parameters colliding with a
    FREE variable of a substituted value are alpha-renamed first, so a
    caller's lambda variable is never captured by a UDF body lambda."""
    if isinstance(e, E.LambdaVariable):
        return bnd.get(e.name, e)
    if isinstance(e, E.Lambda):
        inner = {k: v for k, v in bnd.items() if k not in e.parameters}
        if not inner:
            return e
        free = set()
        for v in inner.values():
            free |= _free_lambda_vars(v)
        ren = {}
        params = list(e.parameters)
        for i, pname in enumerate(params):
            if pname in free:
                _FRESH[0] += 1
                ren[pname] = f"{pname}__a{_FRESH[0]}"
                params[i] = ren[pname]
        body = _rename_lambda_vars(e.body, ren) if ren else e.body
        nb = _substitute_capture_free(body, inner)
        if nb is e.body and not ren:
            return e
        return E.Lambda(e.type, tuple(params), nb)
    if isinstance(e, E.Call):
        na = tuple(_substitute_capture_free(x, bnd) for x in e.arguments)
        return e if na == e.arguments else E.Call(e.type, e.name, na)
    if isinstance(e, E.SpecialForm):
        na = tuple(_substitute_capture_free(x, bnd) for x in e.arguments)
        return e if na == e.arguments else \
            E.SpecialForm(e.type, e.form, na)
    return e


def _dt_plus_interval_type(dt: T.Type, iv: T.Type) -> T.Type:
    """Result type of datetime + interval: every datetime keeps its
    type (DateTimeOperators.java -- date + interval day-to-second stays
    DATE; sub-day components are rejected at plan time in _binop, the
    'Cannot add hour, minutes or seconds to a date' rule)."""
    return dt


def _parse_ts_literal(s: str):
    """TIMESTAMP 'YYYY-MM-DD hh:mm:ss[.fff][ zone]' -> (utc_micros,
    zone_key or None)."""
    import datetime as _dt
    import re as _re
    from .. import tz as _tz
    s = s.strip()
    key = None
    m = _re.match(r"^(.*?)(?:\s+([A-Za-z_/]+(?:/[A-Za-z_]+)?)|"
                  r"\s*([+-]\d{2}:?\d{2}))$", s)
    body = s
    if m and (m.group(2) or m.group(3)):
        try:
            key = _tz.zone_key(m.group(2) or m.group(3))
            body = m.group(1).strip()
        except ValueError:
            key = None  # not a zone suffix after all
    if " " not in body and "T" not in body:
        body += " 00:00:00"
    d = _dt.datetime.fromisoformat(body)
    micros = (int(_dt.datetime(d.year, d.month, d.day,
                               tzinfo=_dt.timezone.utc).timestamp())
              * 1_000_000
              + (d.hour * 3600 + d.minute * 60 + d.second) * 1_000_000
              + d.microsecond)
    if key is not None:
        # wall clock in `zone` -> UTC instant
        micros -= (key - _tz.UTC_KEY) * 60_000_000
    return micros, key


def _parse_time_literal(s: str) -> int:
    import datetime as _dt
    t = _dt.time.fromisoformat(s.strip())
    return ((t.hour * 3600 + t.minute * 60 + t.second) * 1_000_000
            + t.microsecond)


def _agg_output_type(name: str, input_type: Optional[T.Type]) -> T.Type:
    if name == "count" or name == "approx_distinct":
        return T.BIGINT
    if name in ("bool_and", "bool_or", "every"):
        return T.BOOLEAN
    if name in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
                "var_pop", "corr", "covar_samp", "covar_pop", "regr_slope",
                "regr_intercept", "geometric_mean"):
        return T.DOUBLE
    if name == "checksum":
        return T.BIGINT
    if name == "sum":
        if input_type.is_decimal:
            return T.decimal(38, input_type.scale)
        if input_type.is_floating:
            return T.DOUBLE
        return T.BIGINT
    if name == "avg":
        if input_type.is_decimal:
            return T.decimal(38, input_type.scale)
        return T.DOUBLE
    return input_type  # min/max/arbitrary


# Session catalog search path (the reference resolves unqualified table
# names against the session catalog/schema; `USE tpcds.sf1` analog).
_SEARCH_PATH: contextvars.ContextVar = contextvars.ContextVar(
    "search_path", default=("tpch", "tpcds", "memory"))

# CTE plan-once cache, scoped to one plan_sql call: the parser inlines a
# WITH binding as the SAME Query AST object at every reference, so
# planning memoizes on that object identity and all references share ONE
# plan subtree. The plan becomes a DAG; lowering traces shared nodes
# once (exec/planner memoizes by node identity), so a CTE referenced k
# times is scanned and computed once -- the LogicalCteOptimizer analog,
# realized by compiler-level sharing instead of materialization.
# one clock read per statement: every now()/current_* occurrence in a
# statement sees the SAME instant (the reference fixes the session start
# time per query)
_STMT_NOW_US: contextvars.ContextVar = contextvars.ContextVar(
    "stmt_now_us", default=None)


def _statement_now_us() -> int:
    v = _STMT_NOW_US.get()
    if v is None:
        import time
        v = time.time_ns() // 1000
    return v


_SUBPLAN_CACHE: contextvars.ContextVar = contextvars.ContextVar(
    "subplan_cache", default=None)


def plan_sql(query_text: str, max_groups: int = 1 << 16,
             join_capacity: Optional[int] = None,
             catalog: Optional[str] = None) -> N.PlanNode:
    """SQL text -> plan tree rooted at OutputNode. `catalog` moves that
    catalog to the front of the table-name search path."""
    ast = P.parse_sql(query_text)
    token = None
    if catalog is not None:
        path = (catalog,) + tuple(c for c in _SEARCH_PATH.get()
                                  if c != catalog)
        token = _SEARCH_PATH.set(path)
    cache_token = _SUBPLAN_CACHE.set({})
    import time as _time
    now_token = _STMT_NOW_US.set(_time.time_ns() // 1000)
    try:
        if isinstance(ast, (P.Insert, P.CreateTableAs, P.DropTable,
                            P.Delete, P.Update)):
            return _plan_write(ast, max_groups, join_capacity)
        node, names = _plan_any(ast, max_groups, join_capacity)
    finally:
        _SUBPLAN_CACHE.reset(cache_token)
        _STMT_NOW_US.reset(now_token)
        if token is not None:
            _SEARCH_PATH.reset(token)
    if isinstance(node, N.OutputNode):
        return node
    return N.OutputNode(node, names)


def _writable_target(name: str):
    """'memory.t' or bare 't' -> (connector, table). Writable catalogs
    expose the sink contract (begin_insert/...; ConnectorPageSink
    analog): memory and parquet; the generator connectors stay
    read-only, like the reference's tpch/tpcds connectors."""
    if "." in name:
        conn, table = name.split(".", 1)
    else:
        conn, table = "memory", name
    from ..connectors import catalog as get_cat
    try:
        writable = hasattr(get_cat(conn), "begin_insert")
    except KeyError:
        writable = False
    if not writable:
        raise NotImplementedError(
            f"catalog {conn!r} is read-only; writes go to the memory "
            "or parquet connectors")
    return conn, table


def _plan_write(ast, max_groups: int, join_capacity):
    """INSERT / CTAS / DROP TABLE -> TableWriter/TableFinish/Ddl plans
    (LogicalPlanner.createTableWriterPlan / DataDefinitionTask analog)."""
    from ..connectors import catalog as get_catalog

    if isinstance(ast, P.DropTable):
        conn, table = _writable_target(ast.table)
        return N.OutputNode(N.DdlNode("drop_table", conn, table,
                                      ast.if_exists), ["result"])

    if isinstance(ast, (P.Delete, P.Update)):
        # DELETE/UPDATE as table rewrites: the source computes the
        # table's columns + a trailing BOOLEAN `changed`
        # (NULL predicate = not changed, SQL's WHERE semantics)
        conn, table = _writable_target(ast.table)
        try:
            schema = get_catalog(conn).SCHEMA[table]
        except KeyError:
            raise KeyError(f"memory table {table!r} does not exist") \
                from None
        cols = list(schema)
        tys = [schema[c] for c in cols]
        scan = N.TableScanNode(conn, table, cols, tys)
        bare = table
        chans = {}
        for i, c in enumerate(cols):
            chans[c] = i
            chans[f"{bare}.{c}"] = i
            chans[f"{conn}.{bare}.{c}"] = i
        scope = _Scope(chans, tys)
        an = _Analyzer(None)
        if ast.where is None:
            changed = E.const(True, T.BOOLEAN)
        else:
            p = an.lower(ast.where, scope)
            changed = E.special("COALESCE", T.BOOLEAN, p,
                                E.const(False, T.BOOLEAN))
        if isinstance(ast, P.Delete):
            exprs = [E.input_ref(i, tys[i]) for i in range(len(cols))]
        else:
            assigns = {}
            for c, e in ast.assignments:
                if c not in schema:
                    raise KeyError(f"column {c!r} not in table {table!r}")
                ne = an.lower(e, scope)
                if ne.type != schema[c]:
                    ne = E.call("cast", schema[c], ne)
                assigns[c] = ne
            exprs = []
            for i, c in enumerate(cols):
                old = E.input_ref(i, tys[i])
                if c in assigns:
                    exprs.append(E.special("IF", tys[i], changed,
                                           assigns[c], old))
                else:
                    exprs.append(old)
        proj = N.ProjectNode(scan, exprs + [changed])
        node = N.TableRewriteNode(
            proj, conn, table,
            "delete" if isinstance(ast, P.Delete) else "update")
        return N.OutputNode(node, ["rows"])

    if isinstance(ast, P.CreateTableAs):
        conn, table = _writable_target(ast.table)
        if ast.if_not_exists and table in get_catalog(conn).SCHEMA:
            # no-op create: zero rows written (reference behavior)
            return N.OutputNode(N.ValuesNode([T.BIGINT], [[0]]), ["rows"])
        node, names = _plan_any(ast.query, max_groups, join_capacity)
        node = _strip_output(node)
        types = node.output_types()
        writer = N.TableWriterNode(node, conn, table, list(names))
        finish = N.TableFinishNode(writer, conn, table, create=True,
                                   create_columns=list(names),
                                   create_types=list(types))
        return N.OutputNode(finish, ["rows"])

    # INSERT
    conn, table = _writable_target(ast.table)
    mod = get_catalog(conn)
    try:
        schema = mod.SCHEMA[table]
    except KeyError:
        raise KeyError(f"memory table {table!r} does not exist") from None
    target_cols = list(schema)
    target_types = [schema[c] for c in target_cols]
    insert_cols = ast.columns or target_cols
    for c in insert_cols:
        if c not in schema:
            raise KeyError(f"column {c!r} not in table {table!r}")

    if isinstance(ast.query, P.ValuesRows):
        an = _Analyzer(None)
        scope = _Scope({}, [])
        rows = []
        for row in ast.query.rows:
            if len(row) != len(insert_cols):
                raise ValueError(
                    f"INSERT row arity {len(row)} != column count "
                    f"{len(insert_cols)}")
            rows.append([an.lower(cell, scope) for cell in row])
        # VALUES rows lower to constants; ship them as a ValuesNode in
        # INSERT-column order
        const_rows = []
        for row in rows:
            vals = []
            for e in row:
                if not isinstance(e, E.Constant):
                    raise NotImplementedError(
                        "INSERT ... VALUES cells must be literals")
                vals.append(e)
            const_rows.append(vals)
        src_types = [_common_values_type([r[i] for r in const_rows],
                                         schema[insert_cols[i]])
                     for i in range(len(insert_cols))]
        node = N.ValuesNode(
            src_types,
            [[_coerce_const(e, ty) for e, ty in zip(r, src_types)]
             for r in const_rows])
        names = list(insert_cols)
    else:
        node, names = _plan_any(ast.query, max_groups, join_capacity)
        node = _strip_output(node)
        if len(node.output_types()) != len(insert_cols):
            raise ValueError(
                f"INSERT query produces {len(node.output_types())} "
                f"columns, expected {len(insert_cols)}")

    # project to the FULL target layout: insert columns from the query
    # (cast to the declared type), unmentioned columns as typed NULLs
    src_types = node.output_types()
    exprs = []
    for c, ty in zip(target_cols, target_types):
        if c in insert_cols:
            ch = insert_cols.index(c)
            e = E.input_ref(ch, src_types[ch])
            if src_types[ch] != ty:
                e = E.call("cast", ty, e)
            exprs.append(e)
        else:
            exprs.append(E.const(None, ty))
    proj = N.ProjectNode(node, exprs)
    writer = N.TableWriterNode(proj, conn, table, target_cols)
    # the GATHER seam lets the fragmenter fan writers out per worker
    # while the finish (count sum) runs once (ScaledWriterScheduler's
    # writer-stage/commit-stage split, minus the scaling policy)
    gather = N.ExchangeNode(writer, kind="GATHER", scope="REMOTE")
    finish = N.TableFinishNode(gather, conn, table)
    return N.OutputNode(finish, ["rows"])


def _common_values_type(consts, target_ty: T.Type) -> T.Type:
    """Type a VALUES column: the target type when every literal can
    coerce to it, else the literals' own type."""
    return target_ty


def _coerce_const(e: "E.Constant", ty: T.Type):
    """Literal -> target-type python value (the implicit INSERT
    coercions: integer->decimal scaling, string width, date)."""
    v = e.value
    if v is None:
        return None
    if ty.is_decimal:
        if e.type.is_decimal:
            return v * 10 ** (ty.scale - e.type.scale) \
                if ty.scale >= e.type.scale else \
                _exact_downscale(v, e.type.scale - ty.scale)
        if e.type.is_integral:
            return int(v) * 10 ** ty.scale
        raise TypeError(f"cannot coerce {e.type} literal to {ty}")
    if ty.is_integral or ty.base in ("date", "timestamp"):
        return int(v)
    if ty.is_floating:
        return float(v)
    return v


def _exact_downscale(v: int, drop: int) -> int:
    q, r = divmod(v, 10 ** drop)
    if r:
        raise ValueError(f"literal loses precision at scale -{drop}")
    return q


def _plan_any(ast, max_groups: int, join_capacity: Optional[int]):
    """Query | SetQuery -> (plan node, output names)."""
    if isinstance(ast, P.SetQuery):
        lf, ln = _plan_any(ast.left, max_groups, join_capacity)
        rt, rn = _plan_any(ast.right, max_groups, join_capacity)
        lf = _strip_output(lf)
        rt = _strip_output(rt)
        lt, rtt = lf.output_types(), rt.output_types()
        ncols = len(lt)
        assert ncols == len(rtt), "set operation requires equal column counts"
        for i, (a, b) in enumerate(zip(lt, rtt)):
            assert a.base == b.base or (a.is_numeric and b.is_numeric), \
                f"set operation column {i} type mismatch: {a} vs {b}"
        if ast.op == "union":
            node = N.UnionNode([lf, rt])
            if not ast.all:
                node = N.DistinctNode(node, max_groups=max_groups)
            return node, ln
        # INTERSECT / EXCEPT. Set semantics: distinct left, membership
        # test against right over all channels (NULLs compare EQUAL).
        # Bag (ALL) semantics: tag every row with its occurrence index
        # (row_number over the full row), then the SAME membership test
        # on (row, occurrence) keeps/drops exactly min/excess
        # multiplicities -- the classic tagging decorrelation.
        if ast.all:
            all_chs = list(range(ncols))
            lf = N.RowNumberNode(lf, all_chs, [], max_partitions=max_groups)
            rt = N.RowNumberNode(rt, all_chs, [], max_partitions=max_groups)
            key_chs = all_chs + [ncols]  # row + occurrence tag
            left_in = lf
        else:
            key_chs = list(range(ncols))
            left_in = N.DistinctNode(lf, max_groups=max_groups)
        sj = N.SemiJoinNode(left_in, rt, key_chs, key_chs,
                            null_keys_match=True)
        mask_ch = len(left_in.output_types())
        mask = E.input_ref(mask_ch, T.BOOLEAN)
        pred = mask if ast.op == "intersect" else \
            E.call("not", T.BOOLEAN, mask)
        f = N.FilterNode(sj, pred)
        proj = N.ProjectNode(f, [
            E.input_ref(i, lt[i]) for i in range(ncols)])
        return proj, ln
    return _plan_query(ast, max_groups, join_capacity)


def _strip_output(node: N.PlanNode) -> N.PlanNode:
    return node.source if isinstance(node, N.OutputNode) else node


def _is_single_row(node: N.PlanNode) -> bool:
    """Provably AT-MOST-one-row plan: a global (keyless) aggregation
    under row-count-preserving-or-reducing wrappers. A const-key inner
    join against such a side IS the cross product (0 or 1 matches per
    probe row), so the q61/q90-style scalar-report cross joins are
    safe."""
    if isinstance(node, (N.ProjectNode, N.OutputNode, N.FilterNode,
                         N.LimitNode)):
        return _is_single_row(node.sources[0])
    return (isinstance(node, N.AggregationNode)
            and not node.group_channels
            and node.step in ("SINGLE", "FINAL"))


def _expand_grouping_sets(q: P.Query):
    """ROLLUP/CUBE/GROUPING SETS -> (query with flattened GROUP BY,
    kept-index subsets). The single-pass GroupIdNode expansion replaces
    the k+1-pass UNION rewrite (match: spi/plan/GroupIdNode.java via
    StatementAnalyzer's grouping-set analysis)."""
    g = q.group_by[0]
    if isinstance(g, P.Rollup):
        items = list(g.items)
        sets = [list(range(k)) for k in range(len(items), -1, -1)]
    elif isinstance(g, P.Cube):
        import itertools
        items = list(g.items)
        idx = range(len(items))
        sets = [list(c) for r in range(len(items), -1, -1)
                for c in itertools.combinations(idx, r)]
    else:  # GroupingSets
        items = []
        sets = []
        for s in g.sets:
            one = []
            for e in s:
                for i, it in enumerate(items):
                    if it == e:
                        one.append(i)
                        break
                else:
                    items.append(e)
                    one.append(len(items) - 1)
            sets.append(one)
    return dataclasses.replace(q, group_by=items), sets


def _plan_query(q: P.Query, max_groups: int = 1 << 16,
                join_capacity: Optional[int] = None) -> N.PlanNode:
    grouping_sets = None
    if len(q.group_by) == 1 and isinstance(
            q.group_by[0], (P.Rollup, P.Cube, P.GroupingSets)):
        q, grouping_sets = _expand_grouping_sets(q)
    an = _Analyzer(q)

    # FROM: scans with pruned columns. First collect every referenced name.
    tables: List[P.TableRef] = [q.table] + [j.table for j in q.joins]

    def find_table(name: str):
        # resolution follows the session catalog search path (the
        # reference resolves unqualified names against the session's
        # catalog/schema; both catalogs define e.g. `customer`, and the
        # earlier catalog in the path wins deterministically). A dotted
        # name ("memory.t") names the catalog explicitly.
        from ..connectors import catalogs
        cats = catalogs()
        if "." in name:
            cat, bare = name.split(".", 1)
            if cat not in cats:
                raise KeyError(f"unknown catalog {cat!r}")
            sch = cats[cat].SCHEMA
            if bare not in sch:
                raise KeyError(f"table {bare!r} not in catalog {cat!r}")
            return cat, bare, dict(sch[bare])
        search_path = _SEARCH_PATH.get()
        for cat in search_path:
            sch = cats[cat].SCHEMA
            if name in sch:
                return cat, name, dict(sch[name])
        raise KeyError(f"table {name!r} not found in catalogs {search_path}")

    table_catalog = {}
    table_schemas = {}
    derived_plans: Dict[str, Tuple[N.PlanNode, List[str]]] = {}
    for t in tables:
        if t.subquery is not None:
            # derived table / inlined CTE: plan the sub-select; its
            # output names+types form the "schema". A CTE referenced
            # more than once shares ONE planned subtree (plan-once
            # cache keyed on AST object identity -- see _SUBPLAN_CACHE)
            cache = _SUBPLAN_CACHE.get()
            hit = cache.get(id(t.subquery)) if cache is not None else None
            if hit is not None:
                sub_node, sub_names = hit
            else:
                sub_node, sub_names = _plan_any(t.subquery, max_groups,
                                                join_capacity)
                sub_node = _strip_output(sub_node)
                if cache is not None:
                    cache[id(t.subquery)] = (sub_node, sub_names)
            sub_types = sub_node.output_types()
            table_catalog[t.name] = None
            table_schemas[t.name] = {n.lower(): ty for n, ty in
                                     zip(sub_names, sub_types)}
            derived_plans[t.name] = (sub_node,
                                     [n.lower() for n in sub_names])
        elif t.name == "$dual":
            # FROM-less SELECT: a one-row zero-column source (the
            # reference's single-row ValuesNode for SELECT <exprs>)
            table_catalog[t.name] = None
            table_schemas[t.name] = {}
            derived_plans[t.name] = (N.ValuesNode([], [[]]), [])
        else:
            cat, bare, sch = find_table(t.name)
            table_catalog[t.name] = (cat, bare)
            table_schemas[t.name] = sch

    referenced: Dict[str, List[str]] = {t.name: [] for t in tables}

    def note_name(parts: Tuple[str, ...]):
        parts = tuple(p.lower() for p in parts)
        if len(parts) == 2:
            alias, col = parts
            for t in tables:
                if (t.alias or t.name) == alias and col in table_schemas[t.name]:
                    if col not in referenced[t.name]:
                        referenced[t.name].append(col)
                    return
            raise KeyError(f"unknown qualified column {'.'.join(parts)}")
        col = parts[0]
        hits = [t for t in tables if col in table_schemas[t.name]]
        if not hits:
            raise KeyError(f"unknown column {col}")
        if len(hits) > 1:
            raise KeyError(f"ambiguous column {col}")
        if col not in referenced[hits[0].name]:
            referenced[hits[0].name].append(col)

    def collect_names(n, shadowed=frozenset()):
        if isinstance(n, P.Name):
            if len(n.parts) == 1 and n.parts[0].lower() in shadowed:
                return  # a lambda parameter, not a column
            note_name(n.parts)
        elif isinstance(n, P.Lambda):
            collect_names(n.body,
                          shadowed | {p.lower() for p in n.params})
        elif isinstance(n, P.InSubquery):
            collect_names(n.value)  # the subquery has its own table scope
        elif isinstance(n, P.ScalarSubquery):
            # self-contained except for correlated equalities
            _note_correlated(n.query, note_name)
        elif isinstance(n, P.Exists):
            _note_correlated(n.query, note_name)
        elif dataclasses.is_dataclass(n):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if dataclasses.is_dataclass(v):
                    collect_names(v, shadowed)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if dataclasses.is_dataclass(x):
                            collect_names(x, shadowed)
                        elif isinstance(x, tuple):
                            for y in x:
                                if dataclasses.is_dataclass(y):
                                    collect_names(y, shadowed)

    for item in q.select.items:
        collect_names(item.expr)
    for j in q.joins:
        collect_names(j.condition)
    aliases = {(_item_name(it, i)) for i, it in enumerate(q.select.items)}
    for e in ([q.where] if q.where else []) + q.group_by + \
            ([q.having] if q.having else []):
        collect_names(e)
    for o in q.order_by:
        # select aliases shadow table columns in ORDER BY scope
        if isinstance(o.expr, P.Name) and len(o.expr.parts) == 1 and \
                o.expr.parts[0].lower() in aliases:
            continue
        collect_names(o.expr)

    # -- WHERE-conjunct classification: predicate pushdown + join graph --
    # The PredicatePushDown / EliminateCrossJoins analog
    # (sql/planner/optimizations/PredicatePushDown.java,
    # iterative/rule/EliminateCrossJoins.java): for all-inner queries,
    # single-table WHERE conjuncts are planned as filters directly above
    # that table's scan, and two-table column equalities become edges of
    # a join graph. Comma-style FROM lists (the TPC-DS benchmark shape)
    # are joined greedily over that graph -- largest table first (it
    # stays the probe side; each dimension becomes a build side),
    # smallest connected candidate next -- so generated query text never
    # plans a cross product or builds on the fact table.
    all_inner = all(j.kind in ("inner", "cross") for j in q.joins)
    has_cross = any(j.kind == "cross" for j in q.joins)
    alias_list = [(t.alias or t.name) for t in tables]

    def _resolve_alias(parts) -> Optional[Tuple[str, str]]:
        parts = tuple(p.lower() for p in parts)
        if len(parts) == 2:
            a, col = parts
            for t in tables:
                if (t.alias or t.name) == a and col in table_schemas[t.name]:
                    return a, col
            return None
        col = parts[0]
        hits = [t for t in tables if col in table_schemas[t.name]]
        if len(hits) == 1:
            return (hits[0].alias or hits[0].name), col
        return None

    def _names_in(n, out: List[P.Name]) -> bool:
        """Collect every Name under `n`; False if a subquery lurks."""
        if isinstance(n, (P.InSubquery, P.ScalarSubquery, P.Exists)):
            return False
        if isinstance(n, P.Name):
            out.append(n)
            return True
        ok = True
        if dataclasses.is_dataclass(n):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                for x in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(x, tuple):
                        for y in x:
                            if dataclasses.is_dataclass(y):
                                ok = _names_in(y, out) and ok
                    elif dataclasses.is_dataclass(x):
                        ok = _names_in(x, out) and ok
        return ok

    pushed: Dict[str, list] = {a: [] for a in alias_list}
    edges: List[Tuple[str, str, str, str]] = []
    where_rest: list = []

    def _classify(c, allow_edges: bool):
        if isinstance(c, P.BinOp) and c.op == "or":
            # hoist branch-common conjuncts (join predicates hide inside
            # every OR branch in TPC-DS text -- q13/q25/q48 shape)
            common, rest = _extract_common_or(c)
            if common:
                for x in common:
                    _classify(x, allow_edges)
                if rest is not None:
                    _classify(rest, allow_edges)
                return
        names: List[P.Name] = []
        if not _names_in(c, names):
            where_rest.append(c)
            return
        resolved = [_resolve_alias(nm.parts) for nm in names]
        if any(r is None for r in resolved) or not resolved:
            where_rest.append(c)
            return
        aliases_here = {r[0] for r in resolved}
        if len(aliases_here) == 1:
            pushed[next(iter(aliases_here))].append(c)
            return
        if allow_edges and len(aliases_here) == 2 and \
                isinstance(c, P.BinOp) and c.op == "=" and \
                isinstance(c.left, P.Name) and isinstance(c.right, P.Name):
            la, lc = _resolve_alias(c.left.parts)
            ra, rc = _resolve_alias(c.right.parts)
            edges.append((la, lc, ra, rc))
            return
        where_rest.append(c)

    if all_inner:
        for c in (_conjuncts(q.where) if q.where is not None else []):
            _classify(c, allow_edges=has_cross)
        if has_cross:
            for j in q.joins:
                if j.condition is not None:
                    for c in _conjuncts(j.condition):
                        _classify(c, allow_edges=True)
    else:
        where_rest = _conjuncts(q.where) if q.where is not None else []

    # build scans + running scope over the join chain
    def scan_for(t: P.TableRef) -> Tuple[N.PlanNode, List[str], List[T.Type]]:
        if t.name in derived_plans:
            sub_node, sub_cols = derived_plans[t.name]
            tys = [table_schemas[t.name][c] for c in sub_cols]
            return sub_node, sub_cols, tys
        cols = referenced[t.name] or [next(iter(table_schemas[t.name]))]
        tys = [table_schemas[t.name][c] for c in cols]
        cat, bare = table_catalog[t.name]
        return (N.TableScanNode(cat, bare, cols, tys),
                cols, tys)

    def scan_planned(t: P.TableRef):
        """Scan with this table's pushed-down WHERE filters applied."""
        snode, cols, tys = scan_for(t)
        a = t.alias or t.name
        filters = pushed.get(a, [])
        if filters:
            ch = {f"{a}.{c}": i for i, c in enumerate(cols)}
            for i, c in enumerate(cols):
                ch.setdefault(c, i)
            sc = _Scope(ch, list(tys))
            for c in filters:
                snode = N.FilterNode(snode, an.lower(c, sc))
        return snode, cols, tys

    def make_scope() -> _Scope:
        channels: Dict[str, int] = {}
        seen_unqualified: Dict[str, int] = {}
        for i, (alias, c) in enumerate(scope_entries):
            channels[f"{alias}.{c}"] = i
            seen_unqualified[c] = seen_unqualified.get(c, 0) + 1
        for i, (alias, c) in enumerate(scope_entries):
            if seen_unqualified[c] == 1:
                channels[c] = i
        return _Scope(channels, types)

    scope_entries: List[Tuple[str, str]] = []
    types: List[T.Type] = []

    if has_cross:
        if not all_inner:
            raise NotImplementedError(
                "comma/CROSS JOIN mixed with outer joins")

        def _weight(t: P.TableRef) -> float:
            if t.subquery is not None:
                return 0.0
            from ..connectors import catalogs as _cats
            try:
                cat, bare = table_catalog[t.name]
                return float(_cats()[cat].table_row_count(bare, 1.0))
            except KeyError:  # a derived or unknown table
                return 1.0

        start = max(tables, key=_weight)  # ties: first in FROM order
        node, cols0, tys0 = scan_planned(start)
        scope_entries += [((start.alias or start.name), c) for c in cols0]
        types += tys0
        joined = {start.alias or start.name}
        remaining = [t for t in tables if t is not start]
        used_edges: set = set()
        while remaining:
            cands = [t for t in remaining
                     if any((e[0] == (t.alias or t.name) and e[2] in joined)
                            or (e[2] == (t.alias or t.name) and e[0] in joined)
                            for e in edges)]
            if not cands:
                # a PROVABLY single-row side (global-aggregate derived
                # table: the q61/q90/q28 "ratio of two scalar reports"
                # shape) cross-joins via a constant key broadcast -- the
                # row count cannot explode. Anything else is a real
                # cross product and stays rejected.
                single = [t for t in remaining
                          if t.name in derived_plans
                          and _is_single_row(derived_plans[t.name][0])]
                if single:
                    nxt = single[0]
                    a = nxt.alias or nxt.name
                    right, rcols, rtys = scan_planned(nxt)
                    nl = len(types)
                    left_p = N.ProjectNode(node, [
                        E.input_ref(i, types[i]) for i in range(nl)
                    ] + [E.const(0, T.BIGINT)])
                    right_p = N.ProjectNode(right, [
                        E.input_ref(i, rtys[i]) for i in range(len(rtys))
                    ] + [E.const(0, T.BIGINT)])
                    j = N.JoinNode(left_p, right_p, [nl], [len(rtys)],
                                   "inner", "broadcast",
                                   right_output_channels=list(
                                       range(len(rtys))),
                                   out_capacity=join_capacity)
                    node = N.ProjectNode(j, [
                        E.input_ref(i, types[i]) for i in range(nl)
                    ] + [E.input_ref(nl + 1 + i, rtys[i])
                         for i in range(len(rtys))])
                    scope_entries += [(a, c) for c in rcols]
                    types += rtys
                    joined.add(a)
                    remaining.remove(nxt)
                    continue
                raise NotImplementedError(
                    "cross product (no equi-join predicate connects "
                    f"{[t.alias or t.name for t in remaining]} to {joined})")
            nxt = min(cands, key=_weight)
            a = nxt.alias or nxt.name
            right, rcols, rtys = scan_planned(nxt)
            lkeys, rkeys = [], []
            for ei, e in enumerate(edges):
                if ei in used_edges:
                    continue
                la, lc, ra, rc = e
                if la == a and ra in joined:
                    la, lc, ra, rc = ra, rc, la, lc
                if ra == a and la in joined:
                    lkeys.append(scope_entries.index((la, lc)))
                    rkeys.append(rcols.index(rc))
                    used_edges.add(ei)
            if not lkeys:
                raise NotImplementedError(
                    f"join graph edge resolution failed for {a}")
            node = N.JoinNode(node, right, lkeys, rkeys, "inner",
                              "partitioned", out_capacity=join_capacity)
            scope_entries += [(a, c) for c in rcols]
            types += rtys
            joined.add(a)
            remaining.remove(nxt)
        if len(used_edges) != len(edges):
            raise NotImplementedError("unconsumed join-graph edge")
    else:
        node, cols0, tys0 = scan_planned(q.table)
        scope_entries += [((q.table.alias or q.table.name), c) for c in cols0]
        types += tys0

        for j in q.joins:
            right, rcols, rtys = scan_planned(j.table)
            # extract equi-join keys from the ON conjunction
            left_scope = make_scope()
            r_alias = j.table.alias or j.table.name
            r_channels = {f"{r_alias}.{c}": i for i, c in enumerate(rcols)}
            for i, c in enumerate(rcols):
                r_channels.setdefault(c, i)
            conds = _conjuncts(j.condition)
            lkeys, rkeys, residual = [], [], []
            for c in conds:
                if isinstance(c, P.BinOp) and c.op == "=" and \
                        isinstance(c.left, P.Name) and \
                        isinstance(c.right, P.Name):
                    lparts = ".".join(c.left.parts).lower()
                    rparts = ".".join(c.right.parts).lower()
                    if lparts in left_scope.channels and rparts in r_channels:
                        lkeys.append(left_scope.channels[lparts])
                        rkeys.append(r_channels[rparts])
                        continue
                    if rparts in left_scope.channels and lparts in r_channels:
                        lkeys.append(left_scope.channels[rparts])
                        rkeys.append(r_channels[lparts])
                        continue
                residual.append(c)
            assert lkeys, f"no equi-join keys in ON {j.condition}"
            # Residual (non-equi) ON conjuncts: for INNER joins a
            # post-join filter is equivalent; for OUTER joins it is NOT
            # (it would drop the preserved side's unmatched rows), so
            # single-side residuals push below the join onto the
            # NON-preserved side (valid: rows failing them simply do not
            # match) and anything else is rejected. Reference:
            # PredicatePushDown.processInnerJoin/processOuterJoin.
            post_join = []
            r_scope = _Scope(dict(r_channels), list(rtys))
            for r in residual:
                names: List[P.Name] = []
                _names_in(r, names)
                keys_ = [".".join(nm.parts).lower() for nm in names]
                only_right = all(k_ in r_channels for k_ in keys_)
                only_left = all(k_ in left_scope.channels for k_ in keys_)
                if j.kind in ("inner", "left") and only_right:
                    right = N.FilterNode(right, an.lower(r, r_scope))
                elif j.kind in ("inner", "right") and only_left:
                    node = N.FilterNode(node, an.lower(r, left_scope))
                elif j.kind == "inner":
                    post_join.append(r)
                else:
                    raise NotImplementedError(
                        f"{j.kind.upper()} JOIN with a residual ON "
                        f"condition that references the preserved side "
                        f"(it cannot be pushed below the join without "
                        f"dropping unmatched rows): {r}")
            node = N.JoinNode(node, right, lkeys, rkeys, j.kind, "partitioned",
                              out_capacity=join_capacity)
            scope_entries += [(r_alias, c) for c in rcols]
            types += rtys
            scope = make_scope()
            for r in post_join:
                node = N.FilterNode(node, an.lower(r, scope))

    scope = make_scope()

    if where_rest:
        # plain conjuncts first: shrink rows before the semijoin probes
        conjs = where_rest

        _MIRROR = {"<": ">", ">": "<", "<=": ">=", ">=": "<=",
                   "=": "=", "<>": "<>", "!=": "!="}

        def _normalize_scalar_side(c):
            # (SELECT ...) op expr  ->  expr mirrored-op (SELECT ...)
            if isinstance(c, P.BinOp) and c.op in _MIRROR and \
                    isinstance(c.left, P.ScalarSubquery) and \
                    not isinstance(c.right, P.ScalarSubquery):
                return P.BinOp(_MIRROR[c.op], c.right, c.left)
            return c

        conjs = [_normalize_scalar_side(c) for c in conjs]

        def has_scalar_sub(c):
            return isinstance(c, P.BinOp) and \
                isinstance(c.right, P.ScalarSubquery)

        def is_exists(c):
            return isinstance(c, P.Exists) or \
                (isinstance(c, P.NotOp) and isinstance(c.arg, P.Exists))

        def is_disjunctive_sub(c):
            """Subqueries in non-conjunct positions (under OR/CASE/...):
            the q45 `zip IN (...) OR id IN (subquery)` / q10
            `EXISTS(...) OR EXISTS(...)` family."""
            if isinstance(c, P.InSubquery) or has_scalar_sub(c) or \
                    is_exists(c):
                return False
            subs: list = []
            _embedded_subqueries(c, subs)
            return bool(subs)

        for c in [c for c in conjs
                  if not isinstance(c, P.InSubquery) and not has_scalar_sub(c)
                  and not is_exists(c) and not is_disjunctive_sub(c)]:
            node = N.FilterNode(node, an.lower(c, scope))
        for c in [c for c in conjs if is_exists(c)]:
            negate = isinstance(c, P.NotOp)
            ex = c.arg if negate else c
            node = _decorrelate_exists(an, node, scope, tables,
                                       table_schemas, ex.query, negate,
                                       max_groups, join_capacity)
        for c in [c for c in conjs if has_scalar_sub(c)]:
            sub_q2 = c.right.query
            corr, residual2 = ([], [])
            if isinstance(sub_q2, P.Query):
                corr, residual2 = _split_correlations(sub_q2, tables,
                                                      table_schemas)
            if corr:
                node = _decorrelate_scalar_agg(
                    an, node, scope, tables, table_schemas,
                    an.lower(c.left, scope), c.op, sub_q2, max_groups,
                    join_capacity, corr, residual2)
            else:
                node = _attach_scalar_filter(node, an.lower(c.left, scope),
                                             c.op, c.right, max_groups,
                                             join_capacity)
        for c in [c for c in conjs if isinstance(c, P.InSubquery)]:
                # uncorrelated IN subquery -> SemiJoinNode + mask filter
                # (IN-predicate planning, sql/planner's apply/semijoin path)
                sub_node, _sub_names = _plan_any(c.query, max_groups,
                                                 join_capacity)
                sub_node = _strip_output(sub_node)
                assert len(sub_node.output_types()) == 1, \
                    "IN subquery must produce one column"
                v = an.lower(c.value, scope)
                assert isinstance(v, E.InputReference), \
                    "IN subquery value must be a column (round 1)"
                nch = len(scope.types)
                sj = N.SemiJoinNode(node, sub_node, v.channel, 0)
                mask = E.input_ref(nch, T.BOOLEAN)
                # the mask carries IN's 3VL NULL; plain Kleene NOT keeps
                # NOT IN correct (NULL rows fail the filter either way)
                pred = E.call("not", T.BOOLEAN, mask) if c.negate else mask
                f = N.FilterNode(sj, pred)
                node = N.ProjectNode(f, [
                    E.input_ref(i, scope.types[i]) for i in range(nch)])
        for c in [c for c in conjs if is_disjunctive_sub(c)]:
            # subqueries under OR/CASE: plan each as a semijoin MASK
            # column, register the mask against the AST node, lower the
            # whole predicate (masks substitute in), then drop the masks
            # (the reference routes these through ApplyNode ->
            # TransformCorrelatedInPredicateToJoin and keeps the
            # 'subquery as boolean expression' semantics; same here)
            subs: list = []
            _embedded_subqueries(c, subs)
            base_types = node.output_types()
            base_nch = len(base_types)
            cur = base_nch
            for s in subs:
                if isinstance(s, P.InSubquery):
                    sub_node, _ = _plan_any(s.query, max_groups,
                                            join_capacity)
                    sub_node = _strip_output(sub_node)
                    assert len(sub_node.output_types()) == 1, \
                        "IN subquery must produce one column"
                    v = an.lower(s.value, scope)
                    assert isinstance(v, E.InputReference), \
                        "IN subquery value must be a column"
                    node = N.SemiJoinNode(node, sub_node, v.channel, 0)
                    mask = E.input_ref(cur, T.BOOLEAN)
                    an.subquery_masks[id(s)] = \
                        E.call("not", T.BOOLEAN, mask) if s.negate else mask
                elif isinstance(s, P.Exists):
                    sub_q3 = s.query
                    assert isinstance(sub_q3, P.Query), \
                        "EXISTS over set operations: later"
                    if sub_q3.group_by or sub_q3.having is not None:
                        raise NotImplementedError(
                            "EXISTS over GROUP BY in disjunction")
                    corr3, residual3 = _split_correlations(
                        sub_q3, tables, table_schemas)
                    if not corr3:
                        raise NotImplementedError(
                            "uncorrelated EXISTS in disjunction")
                    inner_aliases3 = {(t.alias or t.name).lower()
                                      for t in [sub_q3.table]
                                      + [j.table for j in sub_q3.joins]}
                    if any(_has_outer_name(r, tables, table_schemas,
                                           inner_aliases3, sub_q3)
                           for r in residual3):
                        raise NotImplementedError(
                            "correlated residual predicates under EXISTS "
                            "in disjunction")
                    sub_ast3 = dataclasses.replace(
                        sub_q3,
                        select=P.Select([P.SelectItem(inner, None)
                                         for _, inner in corr3], False),
                        where=_and_all(residual3),
                        order_by=[], limit=None)
                    sub_node, _ = _plan_any(sub_ast3, max_groups,
                                            join_capacity)
                    sub_node = _strip_output(sub_node)
                    outer_chs = [an.lower(nm, scope).channel
                                 for nm, _ in corr3]
                    node = N.SemiJoinNode(node, sub_node, outer_chs,
                                          list(range(len(corr3))))
                    mask = E.input_ref(cur, T.BOOLEAN)
                    # EXISTS is two-valued: a NULL mask (null outer key)
                    # means no match -> FALSE
                    an.subquery_masks[id(s)] = E.special(
                        "COALESCE", T.BOOLEAN, mask,
                        E.const(False, T.BOOLEAN))
                else:  # ScalarSubquery inside an expression (BETWEEN
                    # bounds, arithmetic): attach its single-row value
                    if isinstance(s.query, P.Query):
                        corr_sv, _ = _split_correlations(s.query, tables,
                                                         table_schemas)
                        if corr_sv:
                            raise NotImplementedError(
                                "correlated scalar subquery in "
                                "expression position")
                    node, vty = _attach_scalar_value(node, s, max_groups,
                                                     join_capacity)
                    an.subquery_masks[id(s)] = E.input_ref(cur, vty)
                cur += 1
            pred = an.lower(c, scope)
            node = N.ProjectNode(
                N.FilterNode(node, pred),
                [E.input_ref(i, base_types[i]) for i in range(base_nch)])

    # window expressions (possibly nested inside select items or ORDER
    # BY, over base rows OR over aggregation output)
    win_list: list = []
    for item in q.select.items:
        _collect_windows(item.expr, win_list)
    for o in q.order_by:
        _collect_windows(o.expr, win_list)

    # aggregation? (aggregates inside window ARGUMENTS count when the
    # query aggregates -- a GROUP BY, or any group aggregate outside a
    # window; see find_aggs)
    wargs = bool(q.group_by)
    if not wargs:
        probe = [a for item in q.select.items
                 for a in an.find_aggs(item.expr)]
        probe += an.find_aggs(q.having) if q.having else []
        wargs = bool(probe)
    select_aggs: List[P.Func] = []
    for item in q.select.items:
        select_aggs += an.find_aggs(item.expr, window_args=wargs)
    having_aggs = an.find_aggs(q.having) if q.having else []
    order_aggs = [a for o in q.order_by
                  for a in an.find_aggs(o.expr, window_args=wargs)]
    all_aggs = select_aggs + having_aggs + order_aggs

    if win_list and not (all_aggs or q.group_by):
        # windows over detail rows: plan the stage here; the select
        # items then lower normally with WindowExpr channel intercepts
        node, win_map = _plan_window_stages(
            node, win_list, lambda ast: an.lower(ast, scope))
        an.window_channels.update(win_map)

    if all_aggs or q.group_by:
        node, scope, agg_map, key_map = _plan_aggregation(
            an, node, scope, q, all_aggs, max_groups,
            grouping_sets=grouping_sets)
        node, out_exprs, names, having_e, having_subs = _plan_agg_outputs(
            an, q, scope, agg_map, key_map, grouping_sets=grouping_sets,
            node=node, win_list=win_list)
        if having_e is not None:
            node = N.FilterNode(node, having_e)
        for lhs, op, sub in having_subs:
            # HAVING <agg-expr> op (SELECT ...): attach the 1-row scalar
            # to the group table via a const-key broadcast join, filter,
            # and project the agg layout back (q11 shape)
            if isinstance(sub.query, P.Query):
                corr_h, _ = _split_correlations(sub.query, tables,
                                                table_schemas)
                if corr_h:
                    raise NotImplementedError(
                        "correlated scalar subquery in HAVING is not "
                        "supported (decorrelate over the aggregate output "
                        "is a ROADMAP item)")
            node = _attach_scalar_filter(node, lhs, op, sub, max_groups,
                                         join_capacity)
    else:
        # SELECT-position uncorrelated scalar subqueries (the q9 CASE-
        # bucket shape): attach each as a broadcast single-row value
        # channel, registered so an.lower substitutes the channel ref
        sel_subs: list = []
        for item in q.select.items:
            _embedded_subqueries(item.expr, sel_subs)
        for s in sel_subs:
            if id(s) in an.subquery_masks:
                continue
            if not isinstance(s, P.ScalarSubquery):
                raise NotImplementedError(
                    "IN/EXISTS subqueries in SELECT position")
            if isinstance(s.query, P.Query):
                corr_s, _ = _split_correlations(s.query, tables,
                                                table_schemas)
                if corr_s:
                    raise NotImplementedError(
                        "correlated scalar subquery in SELECT position")
            cur_w = len(node.output_types())
            node, vty = _attach_scalar_value(node, s, max_groups,
                                             join_capacity)
            an.subquery_masks[id(s)] = E.input_ref(cur_w, vty)
        out_exprs = []
        names = []
        for i, item in enumerate(q.select.items):
            if isinstance(item.expr, P.Star):
                for ch, (alias, c) in enumerate(scope_entries):
                    out_exprs.append(E.input_ref(ch, types[ch]))
                    names.append(c)
                continue
            e = an.lower(item.expr, scope)
            out_exprs.append(e)
            names.append(_item_name(item, i))

    # ORDER BY/LIMIT operate on the projected outputs; project first.
    # `source_scope` (pre-projection channels) stays available because
    # hidden ORDER BY expressions are spliced INTO the projection and
    # must be lowered in the source channel space, not the output's.
    source_scope = scope
    node = N.ProjectNode(node, out_exprs)
    out_types = [e.type for e in out_exprs]
    scope = _Scope({n.lower(): i for i, n in enumerate(names)}, out_types)

    if q.having is not None and not (all_aggs or q.group_by):
        raise ValueError("HAVING without aggregation")

    if q.select.distinct:
        node = N.DistinctNode(node, max_groups=max_groups)

    if q.order_by:
        keys = []
        for o in q.order_by:
            if isinstance(o.expr, P.Name) and \
                    ".".join(o.expr.parts).lower() in scope.channels:
                ch = scope.channels[".".join(o.expr.parts).lower()]
            elif isinstance(o.expr, P.Literal) and o.expr.kind == "int":
                ch = int(o.expr.value) - 1
            else:
                # expression order key: append a hidden projection channel
                # (source channel space -- it joins out_exprs)
                e = _relower_output(an, o.expr, q, source_scope, out_exprs)
                out_exprs = out_exprs + [e]
                node = _replace_projection(node, out_exprs)
                ch = len(out_exprs) - 1
            keys.append((ch, o.descending, o.nulls_last))
        if q.limit is not None:
            node = N.TopNNode(node, keys, q.limit)
        else:
            node = N.SortNode(node, keys)
        if len(out_exprs) > len(names):
            # drop hidden ORDER BY channels after the sort consumed them
            node = N.ProjectNode(node, [
                E.input_ref(i, out_exprs[i].type) for i in range(len(names))])
    elif q.limit is not None:
        node = N.LimitNode(node, q.limit)

    return node, names


_WINDOW_FN_TYPES = {"row_number": T.BIGINT, "rank": T.BIGINT,
                    "dense_rank": T.BIGINT, "ntile": T.BIGINT,
                    "percent_rank": T.DOUBLE, "cume_dist": T.DOUBLE,
                    "count": T.BIGINT}


def _collect_windows(e, out: list):
    """Every WindowExpr under `e` (windows cannot nest)."""
    if isinstance(e, P.WindowExpr):
        out.append(e)
        return
    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(x, tuple):
                for y in x:
                    _collect_windows(y, out)
            else:
                _collect_windows(x, out)


def _frame_of(w, order_keys=None, pre_exprs=None) -> object:
    """WindowExpr.frame (parser form) -> the kernel's frame spec.
    Value RANGE frames scale their offsets into the single ascending
    numeric order key's representation (scaled decimals, day numbers)."""
    fr = getattr(w, "frame", None)
    if fr is None:
        return "range_current"
    mode, s, e = fr
    if mode == "range":
        if s is None and e == 0:
            return "range_current"
        if s is None and e is None:
            return "full"
        # value-offset RANGE frame: needs exactly one ASC order key of
        # a numeric/temporal type (the SQL rule)
        if not order_keys or len(order_keys) != 1:
            raise NotImplementedError(
                "RANGE value frames require exactly one ORDER BY key")
        ch, desc, _nl = order_keys[0]
        if desc:
            raise NotImplementedError(
                "RANGE value frames over DESC order keys")
        ty = pre_exprs[ch].type
        if not (ty.is_numeric or ty.base in ("date", "timestamp")):
            raise NotImplementedError(
                f"RANGE value frame over {ty} order key")
        if ty.is_decimal and not ty.is_short_decimal:
            raise NotImplementedError(
                "RANGE value frame over long-decimal order key")

        def conv(x):
            if x is None or x == 0:
                return 0 if x == 0 else None
            if ty.is_decimal:
                return int(round(x * 10 ** ty.scale))
            if ty.is_floating:
                return float(x)
            if x != int(x):
                raise ValueError(
                    f"RANGE offset {x} is fractional but the order key "
                    f"is {ty}")
            return int(x)
        return ("range", conv(s), conv(e))
    for b in (s, e):
        if b is not None and b != int(b):
            raise ValueError("ROWS frame offsets must be integers")
    if s is None and e is None:
        return "full"  # whole partition: cheaper non-tuple kernel path
    return ("rows", s, e)


def _plan_window_stages(node, win_list, lower_expr):
    """Plan every WindowExpr in `win_list`, chaining one WindowNode
    stage per DISTINCT OVER clause (each stage's identity prefix keeps
    the original channel space valid, so later stages and the final
    projection lower against unchanged channel numbers)."""
    groups: List[list] = []
    for w in win_list:
        for g in groups:
            if g[0].partition_by == w.partition_by \
                    and g[0].order_by == w.order_by:
                g.append(w)
                break
        else:
            groups.append([w])
    win_map: Dict[int, Tuple[int, T.Type]] = {}
    for g in groups:
        node, m = _plan_window_stage(node, g, lower_expr,
                                     node.output_types())
        win_map.update(m)
    return node, win_map


def _plan_window_stage(node, win_list, lower_expr, base_types):
    """Append ONE WindowNode computing the WindowExprs in `win_list`
    (all sharing one OVER clause). The pre-projection starts with
    IDENTITY refs of the node's whole channel space, so downstream
    lowering keeps using the same channel numbers; window outputs
    append after. `lower_expr(ast)` lowers a scalar AST in that space
    (an.lower over the base scope, or the aggregation output rewriter).
    Returns (node, {id(WindowExpr): (channel, type)})."""
    w0 = win_list[0]
    pre_exprs: List[E.RowExpression] = [
        E.input_ref(i, t) for i, t in enumerate(base_types)]

    def chan_of(expr_ast) -> int:
        e = lower_expr(expr_ast)
        pre_exprs.append(e)
        return len(pre_exprs) - 1

    part_chans = [chan_of(p) for p in w0.partition_by]
    order_keys = []
    for o in w0.order_by:
        order_keys.append((chan_of(o.expr), o.descending, o.nulls_last))

    functions = []
    win_out_types = []
    for w in win_list:
        f = w.func
        name = f.name
        in_ch = None
        buckets = 0
        if name == "ntile":
            arg = f.args[0]
            assert isinstance(arg, P.Literal) and arg.kind == "int"
            buckets = int(arg.value)
        elif name in ("lag", "lead", "nth_value"):
            if name != "nth_value" and len(f.args) > 2:
                raise NotImplementedError(
                    "lag/lead default-value argument is not supported yet")
            if name == "nth_value" and len(f.args) != 2:
                raise ValueError("nth_value requires exactly two arguments")
            in_ch = chan_of(f.args[0])
            if len(f.args) > 1:
                arg = f.args[1]
                assert isinstance(arg, P.Literal) and arg.kind == "int", \
                    f"{name} offset must be an integer literal"
                buckets = int(arg.value)  # generic int param slot
                if name == "nth_value" and buckets < 1:
                    raise ValueError("nth_value offset must be at least 1")
            else:
                buckets = 1
        elif f.args and not isinstance(f.args[0], P.Star):
            in_ch = chan_of(f.args[0])
        frame = _frame_of(w, order_keys, pre_exprs)
        if name in ("lag", "lead", "nth_value"):
            oty = pre_exprs[in_ch].type
        elif name in _WINDOW_FN_TYPES and not (name == "count" and in_ch is not None):
            oty = _WINDOW_FN_TYPES[name]
        elif name == "count":
            oty = T.BIGINT
        elif name == "sum":
            oty = pre_exprs[in_ch].type
            if oty.is_decimal:
                oty = T.decimal(38, oty.scale)
            elif oty.is_integral:
                oty = T.BIGINT
        elif name == "avg":
            ity = pre_exprs[in_ch].type
            oty = T.decimal(38, ity.scale) if ity.is_decimal else T.DOUBLE
        else:  # min/max/first_value/last_value
            oty = pre_exprs[in_ch].type
        functions.append((name, in_ch, oty, frame, buckets))
        win_out_types.append(oty)

    node = N.ProjectNode(node, pre_exprs)
    node = N.WindowNode(node, part_chans, order_keys, functions)
    nwpre = len(pre_exprs)
    win_map = {id(w): (nwpre + k, win_out_types[k])
               for k, w in enumerate(win_list)}
    return node, win_map


_CMP_NAMES = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt",
              "<=": "le", ">": "gt", ">=": "ge"}


def _note_correlated(sub_q, note_name):
    """Record the CORRELATED outer columns of a subquery: every name
    under its WHERE that does not bind to an inner table (covers
    residual predicates like q16's `cs1.cs_warehouse_sk <>
    cs2.cs_warehouse_sk`, not just `=` correlations). Names that raise
    KeyError against the outer schemas are inner-only and skipped."""
    if not isinstance(sub_q, P.Query) or sub_q.where is None:
        return

    def walk(n):
        if isinstance(n, P.Name):
            if len(n.parts) == 1 and _inner_binds(sub_q, n.parts[0].lower()):
                return  # innermost scope wins for unqualified names
            try:
                note_name(n.parts)
            except KeyError:
                pass
            return
        if isinstance(n, P.InSubquery):
            walk(n.value)  # the IN's left operand is THIS scope's
            return  # (the subquery body collects on its own pass)
        if isinstance(n, (P.Exists, P.ScalarSubquery)):
            return  # deeper scopes collect on their own pass
        for x in _child_nodes(n):
            walk(x)

    walk(sub_q.where)


def _inner_binds(sub_q, col: str) -> bool:
    """Can an unqualified column bind to one of the subquery's tables?
    SQL scoping prefers the INNERMOST binding, so this check runs before
    any outer-schema lookup. Derived inner tables conservatively bind
    everything (their schema isn't known without planning)."""
    from ..connectors import catalogs
    cats = catalogs()
    for t in [sub_q.table] + [j.table for j in sub_q.joins]:
        if t.subquery is not None:
            return True
        for cat in cats.values():
            if t.name in cat.SCHEMA and col in dict(cat.SCHEMA[t.name]):
                return True
    return False


def _split_correlations(sub_q, outer_tables, outer_schemas):
    """Partition a subquery's WHERE into equality correlations
    [(outer Name, inner Name)] and residual inner-only conjuncts."""
    inner_aliases = {(t.alias or t.name).lower()
                     for t in [sub_q.table] + [j.table for j in sub_q.joins]}
    outer_aliases = {(t.alias or t.name).lower() for t in outer_tables}

    def side_of(nm: P.Name):
        if len(nm.parts) == 2:
            a = nm.parts[0].lower()
            if a in inner_aliases:
                return "inner"
            if a in outer_aliases:
                return "outer"
            return None
        col = nm.parts[0].lower()
        if _inner_binds(sub_q, col):  # innermost scope binds first
            return "inner"
        in_outer = any(col in outer_schemas[t.name] for t in outer_tables)
        return "outer" if in_outer else "inner"

    corr, residual = [], []
    for conj in (_conjuncts(sub_q.where) if sub_q.where is not None else []):
        if isinstance(conj, P.BinOp) and conj.op == "=" and \
                isinstance(conj.left, P.Name) and \
                isinstance(conj.right, P.Name):
            sides = (side_of(conj.left), side_of(conj.right))
            if sides == ("outer", "inner"):
                corr.append((conj.left, conj.right))
                continue
            if sides == ("inner", "outer"):
                corr.append((conj.right, conj.left))
                continue
        residual.append(conj)
    return corr, residual


def _decorrelate_scalar_agg(an, node, scope, outer_tables, outer_schemas,
                            lhs, op, sub_q, max_groups, join_capacity,
                            corr, residual):
    """`expr op (SELECT agg... WHERE inner.k = outer.k ...)` -> group the
    subquery by its correlation columns, LEFT-join on them, compare
    (TransformCorrelatedScalarAggregationToJoin analog). Outer rows with
    no inner group see a NULL scalar (comparison filters them) -- except
    pure count aggregates, whose empty-group value is 0 via COALESCE."""
    assert corr, "not a correlated scalar aggregate"
    if sub_q.group_by:
        raise NotImplementedError(
            "correlated scalar subquery with its own GROUP BY (multi-row "
            "per outer key) is not supported")
    if any(_has_outer_name(c, outer_tables, outer_schemas,
                           {(t.alias or t.name).lower() for t in
                            [sub_q.table] + [j.table for j in sub_q.joins]},
                           sub_q) for c in residual):
        raise NotImplementedError(
            "correlated scalar subquery with non-equality correlations")
    sub_ast = dataclasses.replace(
        sub_q,
        select=P.Select([P.SelectItem(inner, f"_corr{i}")
                         for i, (_, inner) in enumerate(corr)]
                        + list(sub_q.select.items), False),
        where=_and_all(residual),
        group_by=[inner for _, inner in corr],
        order_by=[], limit=None)
    sub_node, _ = _plan_any(sub_ast, max_groups, join_capacity)
    sub_node = _strip_output(sub_node)
    subt = sub_node.output_types()
    ncorr = len(corr)
    assert len(subt) == ncorr + 1, "scalar subquery must produce one column"

    outer_chs = []
    for outer_nm, _ in corr:
        e = an.lower(outer_nm, scope)
        assert isinstance(e, E.InputReference)
        outer_chs.append(e.channel)

    ntypes = node.output_types()
    nch = len(ntypes)
    joined = N.JoinNode(node, sub_node, outer_chs, list(range(ncorr)),
                        "left", "broadcast",
                        right_output_channels=[ncorr],
                        out_capacity=join_capacity)
    scalar_ref = E.input_ref(nch, subt[ncorr])
    sub_aggs = _Analyzer(sub_q).find_aggs(sub_q.select.items[0].expr)
    if sub_aggs and all(a.name == "count" for a in sub_aggs):
        # count over an empty correlation group is 0, not NULL
        scalar_ref = E.special("COALESCE", subt[ncorr], scalar_ref,
                               E.const(0, subt[ncorr]))
    f = N.FilterNode(joined, E.call(_CMP_NAMES[op], T.BOOLEAN, lhs,
                                    scalar_ref))
    return N.ProjectNode(f, [E.input_ref(i, ntypes[i]) for i in range(nch)])


def _and_all(conjs):
    out = None
    for c in conjs:
        out = c if out is None else P.BinOp("and", out, c)
    return out


def _has_outer_name(conj, outer_tables, outer_schemas, inner_aliases,
                    sub_q):
    """Does this conjunct reference any OUTER column? (Innermost scope
    binds unqualified names first, mirroring _split_correlations.)"""
    outer_aliases = {(t.alias or t.name).lower() for t in outer_tables}
    found = []

    def walk(n):
        if isinstance(n, P.Name):
            if len(n.parts) == 2:
                a = n.parts[0].lower()
                if a in outer_aliases and a not in inner_aliases:
                    found.append(n)
            else:
                col = n.parts[0].lower()
                if not _inner_binds(sub_q, col) and \
                        any(col in outer_schemas[t.name]
                            for t in outer_tables):
                    found.append(n)
        elif dataclasses.is_dataclass(n):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if dataclasses.is_dataclass(v):
                    walk(v)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if dataclasses.is_dataclass(x):
                            walk(x)

    walk(conj)
    return bool(found)


def _child_nodes(c):
    """Every dataclass child of an AST node, including those inside
    list/tuple fields and (cond, result) pair tuples -- the ONE shared
    iteration body for this module's recursive AST walkers."""
    if not dataclasses.is_dataclass(c):
        return
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(x, tuple):
                for y in x:
                    if dataclasses.is_dataclass(y):
                        yield y
            elif dataclasses.is_dataclass(x):
                yield x


def _case_result_type(branches) -> T.Type:
    """Common result type across conditional branches (SWITCH/IF/
    COALESCE/NULL_IF -- the coercion the reference's TypeCoercer
    applies): the WIDEST numeric type wins so no branch is narrowed
    (mixed float+fixed -> DOUBLE; any decimal -> decimal at the widest
    precision class and scale; mixed integrals -> BIGINT). Typed-NULL
    branches don't vote."""
    types = [b.type for b in branches
             if not (isinstance(b, E.Constant) and b.value is None)
             and b.type != T.UNKNOWN]
    if not types:
        return branches[0].type if branches else T.UNKNOWN
    if all(t == types[0] for t in types):
        return types[0]
    if any(t.is_floating for t in types):
        return T.DOUBLE if any(t.is_numeric for t in types) else types[0]
    if any(t.is_decimal for t in types):
        scale = max(t.scale for t in types if t.is_decimal)
        prec = max(t.precision for t in types if t.is_decimal)
        return T.decimal(38 if prec > 18 else 18, scale)
    if all(t.is_integral for t in types):
        return T.BIGINT
    return types[0]


def _cast_branch(e: E.RowExpression, rty: T.Type) -> E.RowExpression:
    """Align one CASE branch to the common type: typed NULLs re-type in
    place, everything else casts through the kernel (a same-type cast
    is the identity)."""
    if e.type == rty:
        return e
    if isinstance(e, E.Constant) and e.value is None:
        return E.const(None, rty)
    return E.call("cast", rty, e)


def _embedded_subqueries(c, out):
    """Subquery nodes nested anywhere under `c` (descent stops at each:
    a subquery's own subqueries belong to its scope)."""
    if isinstance(c, (P.InSubquery, P.Exists, P.ScalarSubquery)):
        out.append(c)
        return
    for x in _child_nodes(c):
        _embedded_subqueries(x, out)


def _broadcast_scalar(node: N.PlanNode, sub: "P.ScalarSubquery",
                      max_groups: int, join_capacity: Optional[int]):
    """Shared EnforceSingleRow + cross-join shape for scalar subqueries
    in expression position: collapse the subresult to (value, count)
    through a 1-group aggregation and broadcast-join it on a constant
    key. Returns (joined, value_ref, count_ref, outer_types)."""
    sub_node, _ = _plan_any(sub.query, max_groups, join_capacity)
    sub_node = _strip_output(sub_node)
    subt = sub_node.output_types()
    assert len(subt) == 1, "scalar subquery must produce one column"
    sub_one = N.AggregationNode(
        sub_node, [],
        [AggSpec("min", 0, subt[0]),
         AggSpec("count_star", None, T.BIGINT)],
        step="SINGLE", max_groups=1)
    ntypes = node.output_types()
    nch = len(ntypes)
    left = N.ProjectNode(node, [
        E.input_ref(i, ntypes[i]) for i in range(nch)
    ] + [E.const(1, T.BIGINT)])
    right = N.ProjectNode(sub_one, [E.const(1, T.BIGINT),
                                    E.input_ref(0, subt[0]),
                                    E.input_ref(1, T.BIGINT)])
    joined = N.JoinNode(left, right, [nch], [0], "inner", "broadcast",
                        right_output_channels=[1, 2],
                        out_capacity=join_capacity)
    return (joined, E.input_ref(nch + 1, subt[0]),
            E.input_ref(nch + 2, T.BIGINT), ntypes)


def _attach_scalar_value(node: N.PlanNode, sub: "P.ScalarSubquery",
                         max_groups: int, join_capacity: Optional[int]):
    """Append an UNCORRELATED scalar subquery's value as one new channel
    (scalar subqueries in SELECT/expression position). An empty
    subresult yields NULL per spec; a multi-row subresult also yields
    NULL (the reference raises SCALAR_SUBQUERY_MULTIPLE_ROWS -- routing
    that through the jit-safe error channel is a ROADMAP item). Returns
    (new_node, value_type); the value channel is the last output."""
    joined, value_ref, count_ref, ntypes = _broadcast_scalar(
        node, sub, max_groups, join_capacity)
    nch = len(ntypes)
    guarded = E.special(
        "IF", value_ref.type,
        E.call("eq", T.BOOLEAN, count_ref, E.const(1, T.BIGINT)),
        value_ref, E.const(None, value_ref.type))
    out = N.ProjectNode(joined, [
        E.input_ref(i, ntypes[i]) for i in range(nch)] + [guarded])
    return out, value_ref.type


def _decorrelate_exists(an, node, scope, outer_tables, outer_schemas,
                        sub_q, negate, max_groups, join_capacity):
    """EXISTS/NOT EXISTS with equality correlations -> semi/anti join;
    additional CORRELATED residual predicates (e.g. q21's
    `l2.suppkey <> l1.suppkey`) decorrelate through the general
    unique-id route: join candidates on the equalities, filter the
    residuals over the combined row, and semi-join outer rows on their
    unique ids (TransformCorrelated* rule family)."""
    assert isinstance(sub_q, P.Query), "EXISTS over set operations: later"
    corr, residual = _split_correlations(sub_q, outer_tables, outer_schemas)
    assert corr, ("EXISTS subquery has no `inner.col = outer.col` equality "
                  "correlation; general correlated subqueries are a ROADMAP "
                  "item")
    inner_aliases = {(t.alias or t.name).lower()
                     for t in [sub_q.table] + [j.table for j in sub_q.joins]}
    if sub_q.group_by or sub_q.having is not None:
        raise NotImplementedError(
            "EXISTS over GROUP BY/HAVING subqueries is not supported yet")
    # ORDER BY/LIMIT inside EXISTS don't affect (non)emptiness: drop them
    # rather than letting a LIMIT truncate the filtering side globally
    sub_q = dataclasses.replace(sub_q, order_by=[], limit=None)
    corr_residual = [c for c in residual
                     if _has_outer_name(c, outer_tables, outer_schemas,
                                        inner_aliases, sub_q)]
    inner_residual = [c for c in residual if c not in corr_residual]

    ntypes = node.output_types()
    nch = len(ntypes)

    if not corr_residual:
        # pure equi-correlation: direct semi/anti join
        sub_ast = dataclasses.replace(
            sub_q,
            select=P.Select([P.SelectItem(inner, None) for _, inner in corr],
                            False),
            where=_and_all(inner_residual))
        sub_node, _ = _plan_any(sub_ast, max_groups, join_capacity)
        sub_node = _strip_output(sub_node)
        outer_chs = [an.lower(nm, scope).channel for nm, _ in corr]
        sj = N.SemiJoinNode(node, sub_node, outer_chs,
                            list(range(len(corr))))
        mask = E.input_ref(nch, T.BOOLEAN)
    else:
        # general route: tag outer rows with unique ids, join candidate
        # inner rows on the equalities, filter correlated residuals over
        # the combined row, and test uid membership
        node_u = N.AssignUniqueIdNode(node)
        uid_ch = nch

        # inner select: equality columns first, then every inner column
        # the correlated residuals need
        inner_needed: List[P.Name] = []

        def collect_inner(n):
            if isinstance(n, P.Name):
                if (len(n.parts) == 2 and n.parts[0].lower() in inner_aliases):
                    if n.parts not in [x.parts for x in inner_needed]:
                        inner_needed.append(n)
            elif dataclasses.is_dataclass(n):
                for f in dataclasses.fields(n):
                    v = getattr(n, f.name)
                    if dataclasses.is_dataclass(v):
                        collect_inner(v)
                    elif isinstance(v, (list, tuple)):
                        for x in v:
                            if dataclasses.is_dataclass(x):
                                collect_inner(x)
        for c in corr_residual:
            collect_inner(c)
        sub_ast = dataclasses.replace(
            sub_q,
            select=P.Select([P.SelectItem(inner, None) for _, inner in corr]
                            + [P.SelectItem(nm, None) for nm in inner_needed],
                            False),
            where=_and_all(inner_residual))
        sub_node, _ = _plan_any(sub_ast, max_groups, join_capacity)
        sub_node = _strip_output(sub_node)
        subt = sub_node.output_types()
        ncorr = len(corr)
        outer_chs = [an.lower(nm, scope).channel for nm, _ in corr]
        joined = N.JoinNode(node_u, sub_node, outer_chs,
                            list(range(ncorr)), "inner", "broadcast",
                            right_output_channels=list(
                                range(ncorr, len(subt))),
                            out_capacity=join_capacity)
        # combined scope: outer channels as-is, appended inner columns
        comb_channels = dict(scope.channels)
        comb_types = list(ntypes) + [T.BIGINT] + \
            [subt[ncorr + i] for i in range(len(inner_needed))]
        for i, nm in enumerate(inner_needed):
            comb_channels[".".join(nm.parts).lower()] = nch + 1 + i
        comb_scope = _Scope(comb_channels, comb_types)
        pred = an.lower(_and_all(corr_residual), comb_scope)
        survivors = N.ProjectNode(N.FilterNode(joined, pred),
                                  [E.input_ref(uid_ch, T.BIGINT)])
        sj = N.SemiJoinNode(node_u, survivors, uid_ch, 0)
        mask = E.input_ref(nch + 1, T.BOOLEAN)

    if negate:
        # NOT EXISTS: "no matching row" -- a NULL mask (null outer key)
        # means no match and must KEEP the row (unlike NOT IN)
        pred = E.call("not", T.BOOLEAN, E.special(
            "COALESCE", T.BOOLEAN, mask, E.const(False, T.BOOLEAN)))
    else:
        pred = mask
    f = N.FilterNode(sj, pred)
    return N.ProjectNode(f, [E.input_ref(i, ntypes[i]) for i in range(nch)])


def _attach_scalar_filter(node: N.PlanNode, lhs: E.RowExpression, op: str,
                          sub: "P.ScalarSubquery", max_groups: int,
                          join_capacity: Optional[int]) -> N.PlanNode:
    """Filter `node` rows by `lhs op (scalar subquery)`: the subresult is
    collapsed to (value, count) through a 1-group aggregation (provably
    one build row; rows drop when count != 1 -- EnforceSingleRow's error
    lands with task-level error channels), broadcast-joined on a
    constant key, compared, and the original channel layout projected
    back."""
    joined, scalar_ref, count_ref, ntypes = _broadcast_scalar(
        node, sub, max_groups, join_capacity)
    nch = len(ntypes)
    f = N.FilterNode(joined, E.special(
        "AND", T.BOOLEAN,
        E.call("le", T.BOOLEAN, count_ref, E.const(1, T.BIGINT)),
        E.call(_CMP_NAMES[op], T.BOOLEAN, lhs, scalar_ref)))
    return N.ProjectNode(f, [
        E.input_ref(i, ntypes[i]) for i in range(nch)])


def _item_name(item: P.SelectItem, i: int) -> str:
    if item.alias:
        return item.alias
    if isinstance(item.expr, P.Name):
        return item.expr.parts[-1].lower()
    return f"_col{i}"


def _replace_projection(node: N.PlanNode, exprs) -> N.PlanNode:
    # node is ... -> ProjectNode (possibly wrapped); round 1: node IS the
    # projection (order-by rewrite happens right after projecting)
    assert isinstance(node, N.ProjectNode)
    return N.ProjectNode(node.source, list(exprs))


def _relower_output(an, expr, q, source_scope, out_exprs):
    """Produce a SOURCE-channel-space expression for an ORDER BY key that
    is spliced into the output projection: an identical select
    expression reuses its already-lowered form; otherwise the key
    lowers against the pre-projection scope."""
    for i, item in enumerate(q.select.items):
        if item.expr == expr:
            return out_exprs[i]
    return an.lower(expr, source_scope)


def _conjuncts(e) -> List[object]:
    if isinstance(e, P.BinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _disjuncts(e) -> List[object]:
    if isinstance(e, P.BinOp) and e.op == "or":
        return _disjuncts(e.left) + _disjuncts(e.right)
    return [e]


def _extract_common_or(c):
    """OR(A AND X, A AND Y) -> ([A], OR(X, Y)).

    The LogicalRowExpressions.extractCommonPredicates analog
    (presto-expressions/.../LogicalRowExpressions.java): TPC-DS text
    hides join predicates inside every branch of an OR (q13/q25/q48
    shape); hoisting the branch-common conjuncts exposes them to the
    join-graph/pushdown classifier. Pure Kleene-logic distributivity,
    so 3VL NULL semantics are preserved. Returns ([], c) when nothing
    is common; residual None when some branch becomes empty (the OR is
    implied by the common part)."""
    ds = _disjuncts(c)
    if len(ds) < 2:
        return [], c
    branch_conjs = [_conjuncts(d) for d in ds]
    common = []
    for cand in branch_conjs[0]:
        if all(any(cand == other for other in bc) for bc in branch_conjs[1:]):
            if not any(cand == x for x in common):
                common.append(cand)
    if not common:
        return [], c
    residuals = []
    for bc in branch_conjs:
        rem = [x for x in bc if not any(x == y for y in common)]
        if not rem:
            return common, None  # a branch reduced to TRUE
        r = rem[0]
        for x in rem[1:]:
            r = P.BinOp("and", r, x)
        residuals.append(r)
    new_or = residuals[0]
    for r in residuals[1:]:
        new_or = P.BinOp("or", new_or, r)
    return common, new_or


def _plan_aggregation(an, node, scope, q, all_aggs, max_groups,
                      grouping_sets=None):
    """Emit pre-projection (+ GroupIdNode for grouping sets) +
    AggregationNode; returns (node, post_scope, agg result channel map,
    group key channel map)."""
    # pre-projection: group keys then agg inputs
    pre_exprs: List[E.RowExpression] = []
    key_map: Dict[int, int] = {}  # index in q.group_by -> channel
    for i, g in enumerate(q.group_by):
        if isinstance(g, P.Literal) and g.kind == "int":
            item = q.select.items[int(g.value) - 1].expr
            e = an.lower(item, scope)
        else:
            e = an.lower(g, scope)
        key_map[i] = len(pre_exprs)
        pre_exprs.append(e)
    specs: List[AggSpec] = []
    agg_map: Dict[int, Tuple[int, AggSpec]] = {}  # id(ast) -> (state ch, spec)
    # grouping sets add a hidden group-id KEY channel after the keys
    state_ch = len(q.group_by) + (1 if grouping_sets is not None else 0)
    seen_asts: List[Tuple[object, int, AggSpec]] = []
    for f in all_aggs:
        # dedupe textually identical aggregates (the q12 family names
        # sum(x) three times: select item, ratio numerator, window arg)
        # so the kernel computes each once
        dup = next(((ch, sp) for ast, ch, sp in seen_asts if ast == f),
                   None)
        if dup is not None:
            agg_map[id(f)] = dup
            continue
        name = f.name
        if name == "count" and (not f.args or isinstance(f.args[0], P.Star)):
            spec = AggSpec("count_star", None, T.BIGINT)
        else:
            arg = an.lower(f.args[0], scope)
            in_ch = len(pre_exprs)
            pre_exprs.append(arg)
            aname = name
            if name == "count" and f.distinct:
                aname = "count_distinct"
            if name in _TWO_ARG_AGGS:
                if len(f.args) != 2:
                    raise ValueError(f"{name} takes two arguments")
                arg2 = an.lower(f.args[1], scope)
                ch2 = len(pre_exprs)
                pre_exprs.append(arg2)
                spec = AggSpec(aname, in_ch,
                               _agg_output_type(name, arg.type),
                               second_channel=ch2, second_type=arg2.type)
            else:
                spec = AggSpec(aname, in_ch,
                               _agg_output_type(name, arg.type))
        specs.append(spec)
        agg_map[id(f)] = (state_ch, spec)
        seen_asts.append((f, state_ch, spec))
        state_ch += 1  # SINGLE-step aggregations emit finalized columns
    node = N.ProjectNode(node, pre_exprs)
    nkeys = len(q.group_by)
    if grouping_sets is not None:
        node = N.GroupIdNode(node, [list(s) for s in grouping_sets])
        group_channels = list(range(nkeys)) + [len(pre_exprs)]
        eff_max_groups = max_groups * len(grouping_sets)
    else:
        group_channels = list(range(nkeys))
        eff_max_groups = max_groups
    agg = N.AggregationNode(node, group_channels, specs,
                            step="SINGLE", max_groups=eff_max_groups)
    return agg, scope, agg_map, key_map


def _plan_agg_outputs(an, q, pre_scope, agg_map, key_map,
                      grouping_sets=None, node=None, win_list=None):
    """Post-aggregation projection: replace aggregate calls with refs to
    the aggregation node's finalized output channels (avg/variance
    finalization happens inside the SINGLE/FINAL aggregation step —
    ops.aggregation.finalize_states), group-by expressions with key
    channels. grouping(col) lowers to a SWITCH over the hidden gid key
    channel (the reference evaluates it from GroupIdNode's set index the
    same way). Window expressions over the aggregation (q53's
    avg(sum(x)) OVER shape) plan as a WindowNode stage above the
    aggregate (after HAVING, per SQL evaluation order); their args/
    partition/order lower through this same rewriter.

    Returns (node, out_exprs, names, having_e, having_subs); having_e
    is None when it was already applied (window staging consumed it)."""
    agg_node_types: Dict[int, T.Type] = {}
    # the ONE window-channel registry lives on the analyzer, so both
    # this rewriter and an.lower (hidden ORDER BY keys) resolve the
    # same planned windows
    window_channels = an.window_channels

    def finalize(f: P.Func) -> E.RowExpression:
        ch, spec = agg_map[id(f)]
        return E.input_ref(ch, spec.output_type)

    def rewrite(nde, scope_keys) -> E.RowExpression:
        if isinstance(nde, P.WindowExpr):
            hit = window_channels.get(id(nde))
            if hit is None:
                raise NotImplementedError(
                    "window expression outside the planned window stage")
            return E.input_ref(*hit)
        if isinstance(nde, P.Func) and id(nde) in agg_map:
            return finalize(nde)
        if isinstance(nde, P.Func) and nde.name == "grouping":
            if grouping_sets is None:
                raise ValueError("grouping() requires GROUP BY "
                                 "ROLLUP/CUBE/GROUPING SETS")
            arg = nde.args[0]
            for ki, g in enumerate(q.group_by):
                if g == arg:
                    break
            else:
                raise ValueError(f"grouping() argument {arg} is not a "
                                 "grouping column")
            gid_ref = E.input_ref(len(q.group_by), T.BIGINT)
            sw = [E.const(True, T.BOOLEAN)]
            for si, s in enumerate(grouping_sets):
                sw.append(E.special(
                    "WHEN", T.BIGINT,
                    E.call("eq", T.BOOLEAN, gid_ref,
                           E.const(si, T.BIGINT)),
                    E.const(0 if ki in s else 1, T.BIGINT)))
            return E.special("SWITCH", T.BIGINT, *sw)
        # group key expression?
        for i, g in enumerate(q.group_by):
            if nde == g or (isinstance(g, P.Literal) and g.kind == "int"
                            and q.select.items[int(g.value) - 1].expr == nde):
                ch = key_map[i]
                return E.input_ref(ch, scope_keys[ch])
        if isinstance(nde, P.BinOp):
            l = rewrite(nde.left, scope_keys)
            r = rewrite(nde.right, scope_keys)
            if nde.op in ("and", "or"):
                return E.special(nde.op.upper(), T.BOOLEAN, l, r)
            if nde.op in ("=", "<>", "!=", "<", "<=", ">", ">="):
                name = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt",
                        "<=": "le", ">": "gt", ">=": "ge"}[nde.op]
                return E.call(name, T.BOOLEAN, l, r)
            name = {"+": "add", "-": "subtract", "*": "multiply",
                    "/": "divide", "%": "modulus"}[nde.op]
            return E.call(name, an._arith_type(name, l.type, r.type), l, r)
        if isinstance(nde, P.Literal):
            return an._literal(nde)
        if isinstance(nde, P.Func):
            args = [rewrite(a, scope_keys) for a in nde.args]
            return E.call(nde.name, an._func_type(nde.name, args), *args)
        if isinstance(nde, P.Cast):
            v = rewrite(nde.value, scope_keys)
            return E.call("cast", T.parse_type(nde.type_name), v)
        if isinstance(nde, P.Case):
            whens = [(rewrite(c, scope_keys), rewrite(r, scope_keys))
                     for c, r in nde.whens]
            default = rewrite(nde.default, scope_keys) \
                if nde.default is not None else None
            rty = _case_result_type([r for _, r in whens]
                                    + ([default] if default else []))
            args = [rewrite(nde.operand, scope_keys)
                    if nde.operand is not None else E.const(True, T.BOOLEAN)]
            for c, r in whens:
                args.append(E.special("WHEN", rty, c, _cast_branch(r, rty)))
            if default is not None:
                args.append(_cast_branch(default, rty))
            return E.special("SWITCH", rty, *args)
        if isinstance(nde, P.IsNull):
            e = E.special("IS_NULL", T.BOOLEAN, rewrite(nde.value, scope_keys))
            return E.call("not", T.BOOLEAN, e) if nde.negate else e
        if isinstance(nde, P.Between):
            v = rewrite(nde.value, scope_keys)
            e = E.special("BETWEEN", T.BOOLEAN, v,
                          rewrite(nde.lo, scope_keys),
                          rewrite(nde.hi, scope_keys))
            return E.call("not", T.BOOLEAN, e) if nde.negate else e
        raise NotImplementedError(
            f"expression over aggregates not supported: {nde}")

    # key channel types come from the pre-projection
    nkeys = len(q.group_by)
    key_types: Dict[int, T.Type] = {}
    for i, g in enumerate(q.group_by):
        if isinstance(g, P.Literal) and g.kind == "int":
            e = an.lower(q.select.items[int(g.value) - 1].expr, pre_scope)
        else:
            e = an.lower(g, pre_scope)
        key_types[key_map[i]] = e.type

    having_e = None
    having_scalar_subs = []
    if q.having is not None:
        for conj in _conjuncts(q.having):
            if isinstance(conj, P.BinOp) and \
                    isinstance(conj.right, P.ScalarSubquery):
                # lhs rewritten over agg channels; subquery planned by
                # the caller (needs join plumbing above the agg node)
                having_scalar_subs.append(
                    (rewrite(conj.left, key_types), conj.op, conj.right))
            else:
                e = rewrite(conj, key_types)
                having_e = e if having_e is None else \
                    E.special("AND", T.BOOLEAN, having_e, e)

    if win_list:
        # SQL evaluation order: HAVING restricts groups BEFORE window
        # functions see them
        if having_scalar_subs:
            raise NotImplementedError(
                "window functions with HAVING scalar subqueries")
        if having_e is not None:
            node = N.FilterNode(node, having_e)
            having_e = None
        node, win_map = _plan_window_stages(
            node, win_list, lambda ast: rewrite(ast, key_types))
        window_channels.update(win_map)

    out_exprs, names = [], []
    for i, item in enumerate(q.select.items):
        e = rewrite(item.expr, key_types)
        out_exprs.append(e)
        names.append(_item_name(item, i))
    return node, out_exprs, names, having_e, having_scalar_subs


def sql(query_text: str, sf: float = 0.01, device=None,
        max_groups: int = 1 << 16, join_capacity: Optional[int] = None,
        catalog: Optional[str] = None, **kwargs):
    """One-call SQL execution over the session catalogs: meta
    statements (PREPARE, EXECUTE, DEALLOCATE, SHOW, DESCRIBE, CREATE
    and DROP FUNCTION), then `plan_sql`, then `run_query` on `device`
    (CUDA unless the caller names another), which prepares the plan.
    PREPARE and DEALLOCATE return an empty result."""
    from ..exec import run_query
    from .statements import _DEFAULT_PREPARED, preprocess
    pre = preprocess(query_text, catalog=catalog or "tpch",
                     prepared=_DEFAULT_PREPARED)
    if pre.ack is not None:
        from ..exec.runner import QueryResult
        return QueryResult([], [], [pre.ack], 0)
    query_text = pre.text
    root = plan_sql(query_text, max_groups=max_groups,
                    join_capacity=join_capacity, catalog=catalog)
    if join_capacity is not None:
        kwargs.setdefault("default_join_capacity", join_capacity)
    return run_query(root, sf=sf, device=device, **kwargs)
