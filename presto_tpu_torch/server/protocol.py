"""Presto protocol adapter: a real coordinator's documents in, the
port's plan out.

Counterpart of presto_tpu/server/protocol.py (the
PrestoToVeloxQueryPlan.cpp analog): a TaskUpdateRequest
(server/TaskUpdateRequest.java:50-55: session, extraCredentials, the
fragment as base64 JSON bytes, sources, outputIds, tableWriteInfo)
parses through the generated envelope mirrors
(protocol_structs.py, from protocol_vocab.json), and its PlanFragment
(PlanFragment.java:50, the spi/plan JSON vocabulary) translates into
the port's channel-indexed plan nodes. A construct outside the
supported vocabulary raises ProtocolUnsupported naming it: the
PlanChecker's rejection, which routes the fragment to another
cluster. TaskInfo and TaskStatus documents are written with the
spec's field names.

Symbols resolve once, at ingest: the protocol ships variable
references and per-node output layouts, and translation turns them
into channel indices. Constants arrive as base64 single-row blocks,
decoded by the port's serde (serde/pages.py implements that spec).
An aggregate's mask (Aggregation.getMask()) becomes its AggSpec's
`mask_channel`, and approx_percentile's constant fraction its
`parameter`; the port's plan JSON writes both.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..expr import ir as E
from ..ops.aggregation import AggSpec, state_width
from ..plan import nodes as N

__all__ = ["ProtocolUnsupported", "parse_task_update_request",
           "translate_fragment", "translate_row_expression",
           "decode_constant_block", "task_info_json", "task_status_json"]


class ProtocolUnsupported(ValueError):
    """A protocol construct outside the supported slice (PlanChecker
    rejection: route this fragment to a Java worker)."""


# ---------------------------------------------------------------------------
# types, constants, expressions
# ---------------------------------------------------------------------------


def _type_of(sig: str) -> T.Type:
    try:
        return T.parse_type(sig)
    except Exception as e:  # noqa: BLE001
        raise ProtocolUnsupported(f"type signature {sig!r}: {e}") from e


def decode_constant_block(b64: str, ty: T.Type):
    """ConstantExpression.valueBlock: a base64 single-row block in the
    spec's block-encoding format ([len][encoding name][payload])."""
    from ..serde.pages import deserialize_block

    buf = base64.b64decode(b64)
    (vals, nulls), _pos = deserialize_block(memoryview(buf), 0, ty)
    if len(vals) == 0 or (len(nulls) and nulls[0]):
        return None
    v = vals[0]
    if isinstance(v, (np.generic,)):
        v = v.item()
    return v


_OPERATORS = {
    "$operator$equal": "eq", "$operator$not_equal": "ne",
    "$operator$less_than": "lt", "$operator$less_than_or_equal": "le",
    "$operator$greater_than": "gt", "$operator$greater_than_or_equal": "ge",
    "$operator$add": "add", "$operator$subtract": "subtract",
    "$operator$multiply": "multiply", "$operator$divide": "divide",
    "$operator$modulus": "modulus", "$operator$negation": "negate",
    "$operator$cast": "cast", "$operator$between": None,  # special-cased
    "not": "not",
}


def _function_name(handle: dict) -> str:
    sig = handle.get("signature", {})
    name = sig.get("name", "")
    if name.startswith("presto.default."):
        name = name[len("presto.default."):]
    return name


def translate_row_expression(j: dict, layout: Dict[str, Tuple[int, T.Type]]
                             ) -> E.RowExpression:
    t = j.get("@type")
    if t == "variable":
        ch, ty = _lookup(layout, j["name"])
        return E.input_ref(ch, ty)
    if t == "constant":
        ty = _type_of(j["type"])
        return E.const(decode_constant_block(j["valueBlock"], ty), ty)
    if t == "call":
        name = _function_name(j.get("functionHandle", {})) or \
            j.get("displayName", "").lower()
        rty = _type_of(j["returnType"])
        args = [translate_row_expression(a, layout)
                for a in j.get("arguments", [])]
        if name == "$operator$between":
            return E.special("BETWEEN", T.BOOLEAN, *args)
        mapped = _OPERATORS.get(name, name)
        if mapped is None or mapped.startswith("$"):
            raise ProtocolUnsupported(f"function {name!r}")
        return E.call(mapped, rty, *args)
    if t == "special":
        form = j.get("form")
        rty = _type_of(j["returnType"])
        args = [translate_row_expression(a, layout)
                for a in j.get("arguments", [])]
        if form in ("AND", "OR", "IF", "SWITCH", "WHEN", "COALESCE", "IN",
                    "IS_NULL", "NULL_IF", "BETWEEN"):
            return E.special(form, rty, *args)
        raise ProtocolUnsupported(f"special form {form!r}")
    raise ProtocolUnsupported(f"row expression @type {t!r}")


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


def _node_kind(j: dict) -> str:
    t = j.get("@type", "")
    return t.rsplit(".", 1)[-1]  # ".FilterNode" / full class name / bare


def _vars(lst) -> List[Tuple[str, T.Type]]:
    return [(v["name"], _type_of(v["type"])) for v in lst]


def _layout_of(pairs: List[Tuple[str, T.Type]]
               ) -> Dict[str, Tuple[int, T.Type]]:
    return {name: (i, ty) for i, (name, ty) in enumerate(pairs)}


def _lookup(layout: Dict[str, Tuple[int, T.Type]], name: str
            ) -> Tuple[int, T.Type]:
    """Layout resolution that honors the PlanChecker contract: a missing
    variable means the fragment is outside the slice (fall back to a
    Java worker), never an internal KeyError."""
    hit = layout.get(name)
    if hit is None:
        raise ProtocolUnsupported(
            f"variable {name!r} not in source layout {sorted(layout)}")
    return hit


# Presto's tpch column names carry the table prefix (l_orderkey); this
# engine's tpch schema is unprefixed (generator.py) -- strip it.
_TPCH_PREFIXES = ("l_", "o_", "c_", "p_", "s_", "ps_", "n_", "r_")


def _tpch_column(name: str) -> str:
    for p in _TPCH_PREFIXES:
        if name.startswith(p):
            return name[len(p):]
    return name


def _strip_type_suffix(key: str) -> str:
    # assignment keys look like "sum_20<double>"
    return key.split("<", 1)[0]


def _ordering_keys(scheme: dict, layout) -> List[Tuple[int, bool, bool]]:
    """OrderingScheme JSON -> engine (channel, descending, nulls_last)
    triples."""
    keys = []
    for ob in scheme.get("orderBy", []):
        v = ob.get("variable", ob)
        order = ob.get("sortOrder", "ASC_NULLS_LAST")
        keys.append((_lookup(layout, v["name"])[0],
                     order.startswith("DESC"), order.endswith("NULLS_LAST")))
    return keys


def _project_to(src: N.PlanNode, src_out: List[Tuple[str, T.Type]],
                want: List[Tuple[str, T.Type]]
                ) -> Tuple[N.PlanNode, List[Tuple[str, T.Type]]]:
    """Select/reorder `src` columns to the `want` layout (identity when
    already aligned) -- how outputVariables contracts are honored."""
    if [n for n, _ in src_out] == [n for n, _ in want]:
        return src, src_out
    layout = _layout_of(src_out)
    exprs = []
    for name, _ty in want:
        ch, ty = _lookup(layout, name)
        exprs.append(E.input_ref(ch, ty))
    return N.ProjectNode(src, exprs), [(n, e.type)
                                       for (n, _), e in zip(want, exprs)]


# ranking-family window functions take their frame from the partition
# itself; the reference always ships them with a default frame
_RANKING_WINDOW_FUNCS = ("row_number", "rank", "dense_rank",
                         "percent_rank", "cume_dist", "ntile",
                         "lag", "lead")


def _window_frame(fj: dict, fname: str):
    """WindowNode.Frame JSON -> engine frame descriptor."""
    if fname in _RANKING_WINDOW_FUNCS:
        return "range_current"
    t = fj.get("type", "RANGE")
    st, et = fj.get("startType"), fj.get("endType")
    if st == "UNBOUNDED_PRECEDING" and et == "UNBOUNDED_FOLLOWING":
        return "full"
    if t == "RANGE":
        if st == "UNBOUNDED_PRECEDING" and et == "CURRENT_ROW":
            return "range_current"
        raise ProtocolUnsupported(f"RANGE frame {st}..{et}")
    if t == "ROWS":
        def bound(side, orig):
            if side in ("UNBOUNDED_PRECEDING", "UNBOUNDED_FOLLOWING"):
                return None
            if side == "CURRENT_ROW":
                return 0
            if side in ("PRECEDING", "FOLLOWING"):
                # bound values ship as pre-projected variables; the
                # original literal text rides originalStart/EndValue
                s = str(orig) if orig is not None else ""
                if not s.lstrip("-").isdigit():
                    raise ProtocolUnsupported(
                        f"non-literal ROWS frame bound {orig!r}")
                k = int(s)
                return -k if side == "PRECEDING" else k
            raise ProtocolUnsupported(f"frame bound type {side!r}")
        return ("rows", bound(st, fj.get("originalStartValue")),
                bound(et, fj.get("originalEndValue")))
    raise ProtocolUnsupported(f"window frame type {t!r}")


def translate_node(j: dict) -> Tuple[N.PlanNode, List[Tuple[str, T.Type]]]:
    """Reference plan-node JSON -> (engine node, output layout)."""
    kind = _node_kind(j)

    if kind == "TableScanNode":
        table = j.get("table", {})
        handle = table.get("connectorHandle", {})
        connector = table.get("connectorId", handle.get("@type"))
        if connector not in ("tpch", "tpcds"):
            raise ProtocolUnsupported(
                f"connector {connector!r} (tpch/tpcds supported)")
        table_name = handle.get("tableName") or handle.get("table")
        if not table_name:
            raise ProtocolUnsupported("table handle without tableName")
        out = _vars(j["outputVariables"])
        assignments = j.get("assignments", {})
        columns = []
        for name, _ty in out:
            col = None
            for k, h in assignments.items():
                if _strip_type_suffix(k) == name:
                    col = h.get("columnName") or h.get("name")
                    break
            col = col or name
            if connector == "tpch":
                col = _tpch_column(col)
            columns.append(col)
        node = N.TableScanNode(connector, table_name, columns,
                               [ty for _, ty in out])
        return node, out

    if kind == "ValuesNode":
        out = _vars(j["outputVariables"])
        rows = []
        for r in j.get("rows", []):
            row = []
            for cell, (_n, ty) in zip(r, out):
                if cell.get("@type") != "constant":
                    raise ProtocolUnsupported("non-constant VALUES cell")
                row.append(decode_constant_block(cell["valueBlock"], ty))
            rows.append(row)
        return N.ValuesNode([ty for _, ty in out], rows), out

    if kind == "FilterNode":
        src, src_out = translate_node(j["source"])
        pred = translate_row_expression(j["predicate"], _layout_of(src_out))
        return N.FilterNode(src, pred), src_out

    if kind == "ProjectNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        assignments = j["assignments"].get("assignments", j["assignments"])
        exprs, out = [], []
        for key, ex in assignments.items():
            name = _strip_type_suffix(key)
            e = translate_row_expression(ex, layout)
            exprs.append(e)
            out.append((name, e.type))
        return N.ProjectNode(src, exprs), out

    if kind == "AggregationNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        gs = j.get("groupingSets", {})
        if gs.get("groupingSetCount", 1) != 1 or gs.get("globalGroupingSets"):
            raise ProtocolUnsupported(
                "multiple grouping sets arrive via GroupIdNode")
        keys = []
        out: List[Tuple[str, T.Type]] = []
        for v in gs.get("groupingKeys", []):
            ch, ty = _lookup(layout, v["name"])
            keys.append(ch)
            out.append((v["name"], ty))
        step = j.get("step", "SINGLE")
        specs = []
        agg_srcs = []  # per agg: (state src channel, declared type) @FINAL
        n_markers = 0  # MarkDistinct wrappers appended below src
        for key, agg in j.get("aggregations", {}).items():
            name = _strip_type_suffix(key)
            call = agg.get("call", agg)
            fname = _function_name(call.get("functionHandle",
                                            agg.get("functionHandle", {})))
            rty = _type_of(call["returnType"])
            args = call.get("arguments", [])
            if agg.get("orderBy"):
                raise ProtocolUnsupported("ordered aggregation")
            mask_ch = None
            if agg.get("mask") is not None:
                # Aggregation.getMask(): a BOOLEAN column (the
                # coordinator's MarkDistinct / FILTER lowering) gating
                # which rows this aggregate consumes
                mask_ch, mty = _lookup(layout, agg["mask"]["name"])
                if not mty.base == "boolean":
                    raise ProtocolUnsupported(
                        f"non-boolean aggregation mask {agg['mask']!r}")
            if agg.get("distinct"):
                if mask_ch is not None:
                    raise ProtocolUnsupported("DISTINCT with explicit mask")
                if fname in ("count", "approx_distinct"):
                    fname = "count_distinct"
                elif step == "SINGLE" and len(args) == 1 and \
                        args[0].get("@type") == "variable":
                    # worker-side MultipleDistinctAggregationToMarkDistinct
                    # analog: mark first (group keys, arg) occurrences,
                    # aggregate only marked rows
                    ch, _ty = _lookup(layout, args[0]["name"])
                    src = N.MarkDistinctNode(src, key_channels=keys + [ch])
                    mask_ch = len(src_out) + n_markers
                    n_markers += 1
                else:
                    raise ProtocolUnsupported(
                        f"DISTINCT {fname!r} at step {step}")
            parameter = None
            if fname == "approx_percentile" and len(args) == 2 and \
                    args[1].get("@type") == "constant":
                # the fraction: a constant second argument
                parameter = float(decode_constant_block(
                    args[1]["valueBlock"], _type_of(args[1]["type"])))
                args = args[:1]
            if fname == "count" and not args:
                spec = AggSpec("count_star", None, T.BIGINT,
                               mask_channel=mask_ch)
                agg_srcs.append((None, None))
            else:
                if len(args) != 1 or args[0].get("@type") != "variable":
                    raise ProtocolUnsupported(
                        f"aggregation argument shape for {fname!r}")
                ch, aty = _lookup(layout, args[0]["name"])
                spec = AggSpec(fname, ch, rty, parameter=parameter,
                               mask_channel=mask_ch)
                agg_srcs.append((ch, aty))
            if step != "SINGLE" and spec.canonical in ("min_by", "max_by",
                                                       "count_distinct",
                                                       "approx_percentile"):
                raise ProtocolUnsupported(
                    f"{fname} intermediate states over the wire")
            if step == "INTERMEDIATE":
                raise ProtocolUnsupported("INTERMEDIATE aggregation step")
            specs.append(spec)
            out.append((name, spec.output_type))

        names = [n for n, _ in out[len(keys):]]
        if step == "FINAL" and any(state_width(s) > 1 for s in specs):
            # multi-column states arrive packed as ONE row-typed variable
            # per aggregate (the reference's serialized accumulator
            # shape); unpack with row_field before the engine's merge
            proj_exprs = [E.input_ref(ch, layout_ty)
                          for ch, layout_ty in
                          [_lookup(layout, v["name"])
                           for v in gs.get("groupingKeys", [])]]
            for spec, (src_ch, decl_ty) in zip(specs, agg_srcs):
                w = state_width(spec)
                if w == 1:
                    proj_exprs.append(E.input_ref(src_ch, decl_ty))
                    continue
                if decl_ty is None or decl_ty.base != "row" or \
                        len(decl_ty.field_types) != w:
                    raise ProtocolUnsupported(
                        f"{spec.name} FINAL expects a row({w} fields) "
                        f"state, got {decl_ty}")
                for i, ft in enumerate(decl_ty.field_types):
                    proj_exprs.append(E.call(
                        "row_field", ft,
                        E.input_ref(src_ch, decl_ty),
                        E.const(i, T.INTEGER)))
            proj = N.ProjectNode(src, proj_exprs)
            node = N.AggregationNode(proj, list(range(len(keys))), specs,
                                     step="FINAL")
            return node, out
        node = N.AggregationNode(src, keys, specs, step=step)
        if step == "PARTIAL":
            # emit ONE variable per aggregate: multi-column states pack
            # into a row-typed column (row_pack) for the wire
            otys = node.output_types()
            exprs = [E.input_ref(i, otys[i]) for i in range(len(keys))]
            out2 = list(out[:len(keys)])
            ch = len(keys)
            for spec, name in zip(specs, names):
                w = state_width(spec)
                if w == 1:
                    exprs.append(E.input_ref(ch, otys[ch]))
                    out2.append((name, otys[ch]))
                else:
                    fts = otys[ch:ch + w]
                    rty = T.row_of(*fts)
                    exprs.append(E.call(
                        "row_pack", rty,
                        *[E.input_ref(ch + i, fts[i]) for i in range(w)]))
                    out2.append((name, rty))
                ch += w
            if any(state_width(s) > 1 for s in specs):
                return N.ProjectNode(node, exprs), out2
            return node, out2
        return node, out

    if kind == "LimitNode":
        src, src_out = translate_node(j["source"])
        return N.LimitNode(src, int(j["count"])), src_out

    if kind in ("SortNode", "TopNNode"):
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        scheme = j.get("orderingScheme", {})
        sort_keys = []
        for ob in scheme.get("orderBy", []):
            v = ob.get("variable", ob)
            ch, _ty = _lookup(layout, v["name"])
            order = ob.get("sortOrder") or \
                scheme.get("orderings", {}).get(v["name"], "ASC_NULLS_LAST")
            sort_keys.append((ch, order.startswith("DESC"),
                              order.endswith("NULLS_LAST")))
        if kind == "TopNNode":
            return N.TopNNode(src, sort_keys, int(j["count"])), src_out
        return N.SortNode(src, sort_keys), src_out

    if kind == "ExchangeNode":
        sources = j.get("sources", [])
        scope = j.get("scope", "REMOTE")
        ex_type = j.get("type", "REPARTITION")
        if not sources and scope.upper().startswith("LOCAL"):
            # a source-less LOCAL exchange is an intra-task pipeline
            # seam (LocalExchange source operator); this engine fuses
            # local pipelines into one program, so the seam carries no
            # operator -- stand it in as a typed empty source (only
            # isolated node fixtures ship this shape; complete
            # fragments wire real sources)
            out = _vars(j.get("partitioningScheme", {})
                        .get("outputLayout", []))
            node = N.ValuesNode([ty for _, ty in out], [])
            return N.ExchangeNode(node, kind="REPARTITION",
                                  scope="LOCAL"), out
        if len(sources) != 1:
            raise ProtocolUnsupported(
                f"exchange with {len(sources)} sources")
        src, src_out = translate_node(sources[0])
        if scope.upper().startswith("LOCAL"):
            return N.ExchangeNode(src, kind="REPARTITION", scope="LOCAL"), \
                src_out
        scheme = j.get("partitioningScheme", {})
        layout = _layout_of(src_out)
        if ex_type == "GATHER":
            ordering = j.get("orderingScheme")
            if ordering:
                # a merging gather (MergeOperator edge): keep the order
                sort_keys = []
                for ob in ordering.get("orderBy", []):
                    v = ob.get("variable", ob)
                    order = ob.get("sortOrder", "ASC_NULLS_LAST")
                    sort_keys.append((_lookup(layout, v["name"])[0],
                                      order.startswith("DESC"),
                                      order.endswith("NULLS_LAST")))
                return N.ExchangeNode(src, kind="MERGE", scope="REMOTE",
                                      sort_keys=sort_keys), src_out
            return N.ExchangeNode(src, kind="GATHER", scope="REMOTE"), src_out
        if ex_type == "REPARTITION":
            args = scheme.get("partitioning", {}).get("arguments", [])
            chans = []
            for a in args:
                if a.get("@type") != "variable":
                    raise ProtocolUnsupported("non-variable partition arg")
                chans.append(_lookup(layout, a["name"])[0])
            return N.ExchangeNode(src, kind="REPARTITION", scope="REMOTE",
                                  partition_channels=chans), src_out
        if ex_type == "REPLICATE":
            return N.ExchangeNode(src, kind="REPLICATE", scope="REMOTE"), \
                src_out
        raise ProtocolUnsupported(f"exchange type {ex_type!r}")

    if kind == "RemoteSourceNode":
        out = _vars(j["outputVariables"])
        frag_ids = j.get("sourceFragmentIds", [])
        fid = int(frag_ids[0]) if frag_ids else -1
        return N.RemoteSourceNode([ty for _, ty in out], fid), out

    if kind == "OutputNode":
        src, src_out = translate_node(j["source"])
        return N.OutputNode(src, list(j.get("columnNames", []))), src_out

    if kind == "JoinNode":
        # PrestoToVeloxQueryPlan.cpp:60 analog: equi-criteria to engine
        # key channels, outputVariables honored via projection
        left, left_out = translate_node(j["left"])
        right, right_out = translate_node(j["right"])
        jt = j.get("type", "INNER").upper()
        if jt not in ("INNER", "LEFT", "RIGHT", "FULL"):
            raise ProtocolUnsupported(f"join type {jt!r}")
        criteria = j.get("criteria", [])
        if not criteria:
            raise ProtocolUnsupported("cross join (no equi criteria)")
        llay, rlay = _layout_of(left_out), _layout_of(right_out)
        lkeys = [_lookup(llay, c["left"]["name"])[0] for c in criteria]
        rkeys = [_lookup(rlay, c["right"]["name"])[0] for c in criteria]
        dist = j.get("distributionType") or "PARTITIONED"
        node = N.JoinNode(left, right, lkeys, rkeys, join_type=jt.lower(),
                          distribution="broadcast" if dist == "REPLICATED"
                          else "partitioned")
        comb = left_out + right_out
        filt = j.get("filter")
        if filt is not None:
            if jt != "INNER":
                raise ProtocolUnsupported(
                    f"residual join filter on {jt} join (post-filter "
                    "changes outer-join semantics)")
            node = N.FilterNode(node, translate_row_expression(
                filt, _layout_of(comb)))
        want = _vars(j["outputVariables"])
        return _project_to(node, comb, want)

    if kind == "SemiJoinNode":
        src, src_out = translate_node(j["source"])
        filt, filt_out = translate_node(j["filteringSource"])
        slay, flay = _layout_of(src_out), _layout_of(filt_out)
        s_ch = _lookup(slay, j["sourceJoinVariable"]["name"])[0]
        f_ch = _lookup(flay, j["filteringSourceJoinVariable"]["name"])[0]
        node = N.SemiJoinNode(src, filt, s_ch, f_ch)
        out = src_out + [(j["semiJoinOutput"]["name"], T.BOOLEAN)]
        return node, out

    if kind == "WindowNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        spec = j.get("specification", {})
        parts = [_lookup(layout, v["name"])[0]
                 for v in spec.get("partitionBy", [])]
        order = _ordering_keys(spec.get("orderingScheme") or {}, layout)
        functions, out = [], list(src_out)
        for key, fn_j in j.get("windowFunctions", {}).items():
            if fn_j.get("ignoreNulls"):
                raise ProtocolUnsupported("IGNORE NULLS window function")
            fc = fn_j.get("functionCall", {})
            fname = _function_name(fc.get("functionHandle", {}))
            rty = _type_of(fc["returnType"])
            args = fc.get("arguments", [])

            def const_int(a):
                if a.get("@type") != "constant":
                    raise ProtocolUnsupported(
                        "non-constant window function parameter")
                v = decode_constant_block(a["valueBlock"],
                                          _type_of(a["type"]))
                return int(v)

            ch, k = None, None
            if fname in ("lag", "lead"):
                if not args or args[0].get("@type") != "variable":
                    raise ProtocolUnsupported(f"{fname} argument shape")
                ch = _lookup(layout, args[0]["name"])[0]
                if len(args) > 2:
                    raise ProtocolUnsupported(f"{fname} default value")
                if len(args) == 2:
                    k = const_int(args[1])
            elif fname == "nth_value":
                if len(args) != 2 or args[0].get("@type") != "variable":
                    raise ProtocolUnsupported("nth_value argument shape")
                ch = _lookup(layout, args[0]["name"])[0]
                k = const_int(args[1])
            elif fname == "ntile":
                if len(args) != 1:
                    raise ProtocolUnsupported("ntile argument shape")
                k = const_int(args[0])
            elif fname in ("row_number", "rank", "dense_rank",
                           "percent_rank", "cume_dist"):
                pass
            elif fname in ("sum", "count", "avg", "min", "max",
                           "first_value", "last_value"):
                if len(args) != 1 or args[0].get("@type") != "variable":
                    raise ProtocolUnsupported(f"window {fname} args")
                ch = _lookup(layout, args[0]["name"])[0]
            else:
                raise ProtocolUnsupported(f"window function {fname!r}")
            frame = _window_frame(fn_j.get("frame", {}), fname)
            functions.append((fname, ch, rty, frame, k))
            out.append((_strip_type_suffix(key), rty))
        node = N.WindowNode(src, parts, order, functions)
        return node, out

    if kind == "RowNumberNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        parts = [_lookup(layout, v["name"])[0]
                 for v in j.get("partitionBy", [])]
        node = N.RowNumberNode(src, parts, [],
                               j.get("maxRowCountPerPartition"))
        out = list(src_out)
        if not j.get("partial"):
            out.append((j["rowNumberVariable"]["name"], T.BIGINT))
            return node, out
        # partial: the row-number column is consumed, not emitted
        return _project_to(node, src_out + [("$row_number", T.BIGINT)],
                           src_out)

    if kind == "TopNRowNumberNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        if j.get("rankingType", "ROW_NUMBER") != "ROW_NUMBER":
            raise ProtocolUnsupported(
                f"ranking function {j.get('rankingType')!r}")
        spec = j.get("specification", {})
        parts = [_lookup(layout, v["name"])[0]
                 for v in spec.get("partitionBy", [])]
        order = _ordering_keys(spec.get("orderingScheme") or {}, layout)
        node = N.RowNumberNode(src, parts, order,
                               int(j["maxRowCountPerPartition"]))
        if j.get("partial"):
            return _project_to(node, src_out + [("$row_number", T.BIGINT)],
                               src_out)
        out = src_out + [(j["rowNumberVariable"]["name"], T.BIGINT)]
        return node, out

    if kind == "MarkDistinctNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        chans = [_lookup(layout, v["name"])[0]
                 for v in j.get("distinctVariables", [])]
        node = N.MarkDistinctNode(src, key_channels=chans)
        return node, src_out + [(j["markerVariable"]["name"], T.BOOLEAN)]

    if kind == "DistinctLimitNode":
        src, src_out = translate_node(j["source"])
        want = _vars(j["distinctVariables"])
        proj, proj_out = _project_to(src, src_out, want)
        node = N.LimitNode(
            N.DistinctNode(proj, list(range(len(proj_out)))),
            int(j["limit"]))
        return node, proj_out

    if kind == "GroupIdNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        sets = j.get("groupingSets", [])
        gcols = {_strip_type_suffix(k): v
                 for k, v in j.get("groupingColumns", {}).items()}
        grouping_out: List[Tuple[str, T.Type]] = []
        seen = set()
        for s in sets:
            for v in s:
                if v["name"] not in seen:
                    seen.add(v["name"])
                    grouping_out.append((v["name"], _type_of(v["type"])))
        agg_args = _vars(j.get("aggregationArguments", []))
        # project the source to [grouping inputs][agg args]
        exprs = []
        for name, _ty in grouping_out:
            inp = gcols.get(name)
            if inp is None:
                raise ProtocolUnsupported(
                    f"grouping output {name!r} missing from "
                    "groupingColumns")
            ch, ty = _lookup(layout, inp["name"])
            exprs.append(E.input_ref(ch, ty))
        for name, _ty in agg_args:
            ch, ty = _lookup(layout, name)
            exprs.append(E.input_ref(ch, ty))
        proj = N.ProjectNode(src, exprs)
        pos = {name: i for i, (name, _) in enumerate(grouping_out)}
        node = N.GroupIdNode(proj, grouping_sets=[
            [pos[v["name"]] for v in s] for s in sets])
        out = grouping_out + agg_args + \
            [(j["groupIdVariable"]["name"], T.BIGINT)]
        return node, out

    if kind == "UnnestNode":
        src, src_out = translate_node(j["source"])
        layout = _layout_of(src_out)
        unnest_vars = j.get("unnestVariables", {})
        if len(unnest_vars) != 1:
            raise ProtocolUnsupported(
                f"unnest of {len(unnest_vars)} columns (single ARRAY "
                "supported)")
        arr_key, elems = next(iter(unnest_vars.items()))
        arr_name = _strip_type_suffix(arr_key)
        arr_ch, arr_ty = _lookup(layout, arr_name)
        if arr_ty.base == "array":
            if len(elems) != 1:
                raise ProtocolUnsupported(
                    f"array unnest emitting {len(elems)} columns")
        elif arr_ty.base == "map":
            if len(elems) != 2:
                raise ProtocolUnsupported(
                    f"map unnest emitting {len(elems)} columns")
        else:
            raise ProtocolUnsupported(f"unnest of {arr_ty.base!r}")
        repl = _vars(j.get("replicateVariables", []))
        proj, _ = _project_to(src, src_out, repl + [(arr_name, arr_ty)])
        ordinality = j.get("ordinalityVariable")
        node = N.UnnestNode(proj, array_channel=len(repl),
                            with_ordinality=ordinality is not None)
        out = repl + [(e["name"], _type_of(e["type"])) for e in elems]
        if ordinality is not None:
            out.append((ordinality["name"], T.BIGINT))
        return node, out

    raise ProtocolUnsupported(f"plan node {j.get('@type')!r}")


def translate_fragment(j: dict) -> Tuple[N.PlanNode, dict]:
    """PlanFragment JSON -> (engine plan root, fragment info). Accepts
    the fragment object directly or its base64-encoded bytes (the
    TaskUpdateRequest wire form). The envelope validates through the
    GENERATED PlanFragment mirror (protocol_structs.py) before node
    translation."""
    if isinstance(j, str):
        j = json.loads(base64.b64decode(j))
    from .protocol_structs import PlanFragment as _PF
    frag = _PF.from_dict(j)
    if not isinstance(frag.tableScanSchedulingOrder, list):
        raise ProtocolUnsupported(
            "PlanFragment.tableScanSchedulingOrder must be a list")
    root, _out = translate_node(j["root"])
    info = {
        "id": j.get("id"),
        "partitioning": (j.get("partitioning", {})
                         .get("connectorHandle", {}).get("partitioning")),
        "tableScanSchedulingOrder": j.get("tableScanSchedulingOrder", []),
        "scaleFactor": _find_scale(j["root"]),
    }
    return root, info


def _find_scale(j):
    """The tpch/tpcds connector handles carry scaleFactor; splits are
    assigned separately, so the fragment-level value seeds the worker's
    generator."""
    if isinstance(j, dict):
        if "scaleFactor" in j:
            return j["scaleFactor"]
        for v in j.values():
            r = _find_scale(v)
            if r is not None:
                return r
    elif isinstance(j, list):
        for v in j:
            r = _find_scale(v)
            if r is not None:
                return r
    return None


def parse_task_update_request(j: dict) -> dict:
    """TaskUpdateRequest JSON (server/TaskUpdateRequest.java:50-55) ->
    {plan, fragmentInfo, splits, outputBuffers, session}. The envelope
    parses through the GENERATED struct mirrors (protocol_structs.py,
    from protocol_vocab.json -- the presto_protocol_core.yml codegen
    approach); plan-node translation stays in this module. Raises
    ProtocolUnsupported outside the slice."""
    from .protocol_structs import Split as _Split
    from .protocol_structs import TaskUpdateRequest as _TUR
    req = _TUR.from_dict(j)
    out: dict = {"plan": None, "fragmentInfo": None}
    if req.fragment is not None:
        out["plan"], out["fragmentInfo"] = translate_fragment(req.fragment)
    splits = []
    raw_sources = j.get("sources") or []
    for src, raw_src in zip(req.sources, raw_sources):
        raw_splits = raw_src.get("splits") or []
        for sched, raw_sched in zip(src.splits, raw_splits):
            s = sched.split
            if s is None:
                # the flat wire form: split fields inline on the
                # ScheduledSplit entry
                s = _Split.from_dict(raw_sched)
            splits.append({
                "planNodeId": src.planNodeId,
                "sequenceId": sched.sequenceId,
                "connectorId": s.connectorId,
                "connectorSplit": s.connectorSplit,
            })
    out["splits"] = splits
    b = req.outputIds
    out["outputBuffers"] = {
        "type": None if b is None else b.type,
        "buffers": {} if b is None else (b.buffers or {}),
        "noMoreBufferIds": False if b is None else b.noMoreBufferIds,
    }
    out["session"] = {
        "queryId": req.session.queryId if req.session else None,
        "user": req.session.user if req.session else None,
        "systemProperties": (req.session.systemProperties or {})
        if req.session else {},
    }
    return out


# ---------------------------------------------------------------------------
# TaskInfo / TaskStatus (spec field names; TaskInfo.json shape)
# ---------------------------------------------------------------------------

_STATE_MAP = {"PENDING": "PLANNED", "RUNNING": "RUNNING",
              "FINISHED": "FINISHED", "FAILED": "FAILED",
              "ABORTED": "ABORTED", "CANCELED": "CANCELED"}


def task_status_json(task_id: str, state: str, worker_uri: str,
                     version: int = 1,
                     memory_bytes: int = 0,
                     failures: Optional[List[str]] = None) -> dict:
    return {
        "taskInstanceIdLeastSignificantBits": 0,
        "taskInstanceIdMostSignificantBits": 0,
        "version": version,
        "state": _STATE_MAP.get(state, state),
        "self": f"{worker_uri}/v1/task/{task_id}",
        "completedDriverGroups": [],
        "failures": [{"message": m, "type": "USER_ERROR"}
                     for m in (failures or [])],
        "queuedPartitionedDrivers": 0,
        "runningPartitionedDrivers": 1 if state == "RUNNING" else 0,
        "outputBufferUtilization": 0.0,
        "outputBufferOverutilized": False,
        "physicalWrittenDataSizeInBytes": 0,
        "memoryReservationInBytes": memory_bytes,
        "systemMemoryReservationInBytes": 0,
        "fullGcCount": 0,
        "fullGcTimeInMillis": 0,
        "peakNodeTotalMemoryReservationInBytes": memory_bytes,
        "totalCpuTimeInNanos": 0,
        "taskAgeInMillis": 0,
        "queuedPartitionedSplitsWeight": 0,
        "runningPartitionedSplitsWeight": 0,
    }


def task_info_json(task_id: str, state: str, worker_uri: str,
                   node_id: str, last_heartbeat_ms: int,
                   rows: int = 0, version: int = 1,
                   memory_bytes: int = 0,
                   failures: Optional[List[str]] = None,
                   query_stats: Optional[dict] = None) -> dict:
    """`query_stats`: a QueryStats.to_json() document from the task's
    execution; its wall/peak-memory/input-rows map onto the spec's
    TaskStats field names so a reference coordinator reads real numbers
    (elapsed nanos, memory reservation, raw input positions)."""
    qs = query_stats or {}
    staging = (qs.get("stages") or {}).get("staging") or {}
    # a staged 0 is a real measurement (empty split), not "missing"
    input_rows = int(staging["rows"]) if "rows" in staging else rows
    elapsed_ns = int(qs.get("wallUs", 0)) * 1000
    mem = int(qs.get("peakMemoryBytes", memory_bytes) or memory_bytes)
    done = state in ("FINISHED", "FAILED", "ABORTED", "CANCELED")
    return {
        "taskId": task_id,
        "taskStatus": task_status_json(task_id, state, worker_uri,
                                       version, memory_bytes, failures),
        "lastHeartbeatInMillis": last_heartbeat_ms,
        "outputBuffers": {
            "type": "PARTITIONED",
            "state": "FINISHED" if done else "OPEN",
            "canAddBuffers": False,
            "canAddPages": not done,
            "totalBufferedBytes": 0,
            "totalBufferedPages": 0,
            "totalRowsSent": rows,
            "totalPagesSent": 1 if rows else 0,
            "buffers": [],
        },
        "noMoreSplits": [],
        "stats": {
            "createTimeInMillis": last_heartbeat_ms,
            "elapsedTimeInNanos": elapsed_ns,
            "queuedTimeInNanos": 0,
            "totalDrivers": 1,
            "queuedDrivers": 0,
            "runningDrivers": 0 if done else 1,
            "blockedDrivers": 0,
            "completedDrivers": 1 if done else 0,
            "totalSplits": 1,
            "queuedSplits": 0,
            "runningSplits": 0 if done else 1,
            "completedSplits": 1 if done else 0,
            "cumulativeUserMemory": 0.0,
            "userMemoryReservationInBytes": mem,
            "revocableMemoryReservationInBytes": 0,
            "systemMemoryReservationInBytes": 0,
            "rawInputPositions": input_rows,
            "processedInputPositions": input_rows,
            "outputPositions": rows,
        },
        "needsPlan": False,
        "nodeId": node_id,
    }
