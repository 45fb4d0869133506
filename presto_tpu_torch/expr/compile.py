"""RowExpression evaluation over a Batch: the PageFilter/PageProjection
analog.

Counterpart of presto_tpu/expr/compile.py (`evaluate`, `_eval_special`
for AND/BETWEEN, `_constant_block`, `compile_filter`,
`compile_projections`). PyTorch runs eagerly, so "compiling" an
expression is binding it into a closure over the tree.

Null semantics are Presto's three-valued logic: a scalar call is NULL
when any argument is; AND is Kleene.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import Batch, Block, Column, torch_dtype
from . import functions as F
from .ir import Call, Constant, InputReference, RowExpression, SpecialForm

__all__ = ["compile_filter", "compile_projections", "evaluate"]


def _constant_block(c: Constant, capacity: int, device) -> Block:
    """A literal broadcast to the batch: one element expanded to
    `capacity` rows (a view, no per-row storage)."""
    ty = c.type
    if c.value is None or not ty.is_fixed_width:
        raise NotImplementedError(
            f"constant {c} is not ported yet (ROADMAP queue 1 item 10: "
            "breadth)")
    v = c.value
    if ty.base == "date" and isinstance(v, str):
        v = int((np.datetime64(v) - np.datetime64("1970-01-01")).astype(int))
    values = torch.full((1,), v, dtype=torch_dtype(ty.to_dtype()),
                        device=device)
    no_nulls = torch.zeros(1, dtype=torch.bool, device=device)
    return Column(values.expand(capacity), no_nulls.expand(capacity), ty)


def evaluate(expr: RowExpression, batch: Batch) -> Block:
    if isinstance(expr, InputReference):
        return batch.column(expr.channel)
    if isinstance(expr, Constant):
        return _constant_block(expr, batch.capacity, batch.active.device)
    if isinstance(expr, SpecialForm):
        return _eval_special(expr, batch)
    if isinstance(expr, Call):
        args = [evaluate(a, batch) for a in expr.arguments]
        sf = F.lookup(expr.name.lower())
        out = sf.fn(expr.type, *args)
        if sf.null_fn is not None:
            out = _with_nulls(out, sf.null_fn(expr.type, *args))
        return out
    raise TypeError(f"cannot evaluate {type(expr)}")


def _with_nulls(b: Block, nulls: torch.Tensor) -> Block:
    return dataclasses.replace(b, nulls=nulls)


def _bool(b: Block):
    """(value, null) lanes of a boolean block; values under null are
    False."""
    return b.values & ~b.nulls, b.nulls


def _eval_special(expr: SpecialForm, batch: Batch) -> Block:
    form, args = expr.form, expr.arguments
    if form == "AND":
        # Kleene: FALSE if any FALSE; else NULL if any NULL; else TRUE
        any_false, any_null = None, None
        for a in args:
            bv, bn = _bool(evaluate(a, batch))
            f = ~bv & ~bn
            any_false = f if any_false is None else (any_false | f)
            any_null = bn if any_null is None else (any_null | bn)
        nulls = ~any_false & any_null
        return Column(~any_false & ~nulls, nulls, expr.type)
    if form == "BETWEEN":
        x = evaluate(args[0], batch)
        lo = evaluate(args[1], batch)
        hi = evaluate(args[2], batch)
        ge = F.lookup("ge").fn(T.BOOLEAN, x, lo)
        le = F.lookup("le").fn(T.BOOLEAN, x, hi)
        n = x.nulls | lo.nulls | hi.nulls
        return Column(ge.values & le.values & ~n, n, expr.type)
    raise NotImplementedError(f"special form {form} is not ported yet "
                              "(ROADMAP queue 1 item 10: breadth)")


def compile_filter(expr: RowExpression) -> Callable[[Batch], Batch]:
    """Rows failing the predicate (FALSE or NULL) become inactive; the
    selection stays a mask, no compaction."""
    def run(batch: Batch) -> Batch:
        out = evaluate(expr, batch)
        return batch.with_active(batch.active & out.values & ~out.nulls)
    return run


def compile_projections(exprs: Sequence[RowExpression]
                        ) -> Callable[[Batch], Batch]:
    """Each expression becomes an output column; the mask rides along."""
    def run(batch: Batch) -> Batch:
        return Batch(tuple(evaluate(e, batch) for e in exprs), batch.active)
    return run
