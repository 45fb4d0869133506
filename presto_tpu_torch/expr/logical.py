"""Logical RowExpression utilities: conjunct/disjunct algebra, NNF/CNF/
DNF rewrites, the generic tree rewriter and constant folding.

The port's copy of presto_tpu/expr/logical.py, the helpers the plan
passes and the SQL planner lean on. `fold_constants` evaluates a
constant subtree with the port's own `evaluate` over a one-row CPU
batch, so planning makes no device round trip.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Set

from .. import types as T
from . import ir as E

__all__ = ["conjuncts", "disjuncts", "and_all", "or_all", "negate",
           "to_nnf", "to_cnf", "to_dnf", "rewrite_bottom_up",
           "map_input_channels", "input_channels", "fold_constants",
           "TRUE", "FALSE"]

TRUE = E.const(True, T.BOOLEAN)
FALSE = E.const(False, T.BOOLEAN)


def _flatten(e: E.RowExpression, form: str, out: List[E.RowExpression]):
    if isinstance(e, E.SpecialForm) and e.form == form:
        for a in e.arguments:
            _flatten(a, form, out)
    else:
        out.append(e)


def conjuncts(e: E.RowExpression) -> List[E.RowExpression]:
    """Flatten nested ANDs into a list (TRUE vanishes)."""
    out: List[E.RowExpression] = []
    _flatten(e, "AND", out)
    return [c for c in out
            if not (isinstance(c, E.Constant) and c.value is True)]


def disjuncts(e: E.RowExpression) -> List[E.RowExpression]:
    """Flatten nested ORs into a list (FALSE vanishes)."""
    out: List[E.RowExpression] = []
    _flatten(e, "OR", out)
    return [d for d in out
            if not (isinstance(d, E.Constant) and d.value is False)]


def _combine(form: str, terms: Sequence[E.RowExpression],
             empty: E.Constant) -> E.RowExpression:
    terms = list(terms)
    if not terms:
        return empty
    acc = terms[0]
    for t in terms[1:]:
        acc = E.special(form, T.BOOLEAN, acc, t)
    return acc


def and_all(terms: Iterable[E.RowExpression]) -> E.RowExpression:
    return _combine("AND", list(terms), TRUE)


def or_all(terms: Iterable[E.RowExpression]) -> E.RowExpression:
    return _combine("OR", list(terms), FALSE)


def negate(e: E.RowExpression) -> E.RowExpression:
    """NOT e, simplifying double negation."""
    if isinstance(e, E.Call) and e.name == "not":
        return e.arguments[0]
    if isinstance(e, E.Constant) and e.type.base == "boolean" \
            and e.value is not None:
        return E.const(not e.value, T.BOOLEAN)
    return E.call("not", T.BOOLEAN, e)


def to_nnf(e: E.RowExpression) -> E.RowExpression:
    """Negation normal form: push NOT down to atoms (De Morgan). Only
    AND/OR/NOT structure is rewritten; everything else is an atom.
    Kleene 3VL-safe: De Morgan and double negation hold under NULLs."""
    if isinstance(e, E.Call) and e.name == "not":
        a = e.arguments[0]
        if isinstance(a, E.SpecialForm) and a.form in ("AND", "OR"):
            form = "OR" if a.form == "AND" else "AND"
            args = [to_nnf(negate(x)) for x in a.arguments]
            return _combine(form, args, TRUE if form == "AND" else FALSE)
        if isinstance(a, E.Call) and a.name == "not":
            return to_nnf(a.arguments[0])
        return e
    if isinstance(e, E.SpecialForm) and e.form in ("AND", "OR"):
        return _combine(e.form, [to_nnf(x) for x in e.arguments],
                        TRUE if e.form == "AND" else FALSE)
    return e


_MAX_TERMS = 128  # clause-explosion cap (LogicalRowExpressions' guard)


def _cross(groups: List[List[E.RowExpression]], cap: int
           ) -> List[List[E.RowExpression]]:
    acc: List[List[E.RowExpression]] = [[]]
    for g in groups:
        nxt = [base + [t] for base in acc for t in g]
        if len(nxt) > cap:
            raise _Explosion()
        acc = nxt
    return acc


class _Explosion(Exception):
    pass


def to_cnf(e: E.RowExpression, max_terms: int = _MAX_TERMS
           ) -> E.RowExpression:
    """Conjunctive normal form (AND of ORs). Returns the input unchanged
    if the rewrite would exceed `max_terms` clauses."""
    try:
        return and_all(or_all(c) for c in _cnf_clauses(to_nnf(e), max_terms))
    except _Explosion:
        return e


def _cnf_clauses(e, cap) -> List[List[E.RowExpression]]:
    if isinstance(e, E.SpecialForm) and e.form == "AND":
        out = []
        for a in e.arguments:
            out.extend(_cnf_clauses(a, cap))
            if len(out) > cap:
                raise _Explosion()
        return out
    if isinstance(e, E.SpecialForm) and e.form == "OR":
        # OR over children's CNFs: distribute (cross product of clauses)
        groups = [[or_all(cl) for cl in _cnf_clauses(a, cap)]
                  for a in e.arguments]
        return [[t for t in combo] for combo in _cross(groups, cap)]
    return [[e]]


def to_dnf(e: E.RowExpression, max_terms: int = _MAX_TERMS
           ) -> E.RowExpression:
    """Disjunctive normal form (OR of ANDs), same cap behavior."""
    try:
        return or_all(and_all(c) for c in _dnf_clauses(to_nnf(e), max_terms))
    except _Explosion:
        return e


def _dnf_clauses(e, cap) -> List[List[E.RowExpression]]:
    if isinstance(e, E.SpecialForm) and e.form == "OR":
        out = []
        for a in e.arguments:
            out.extend(_dnf_clauses(a, cap))
            if len(out) > cap:
                raise _Explosion()
        return out
    if isinstance(e, E.SpecialForm) and e.form == "AND":
        groups = [[and_all(cl) for cl in _dnf_clauses(a, cap)]
                  for a in e.arguments]
        return [[t for t in combo] for combo in _cross(groups, cap)]
    return [[e]]


# ---- generic rewriting ----------------------------------------------------

def rewrite_bottom_up(e: E.RowExpression,
                      fn: Callable[[E.RowExpression], E.RowExpression]
                      ) -> E.RowExpression:
    """Rebuild the children first, then apply `fn` to the (possibly
    rebuilt) node."""
    if isinstance(e, E.Call):
        args = tuple(rewrite_bottom_up(a, fn) for a in e.arguments)
        if args != e.arguments:
            e = E.Call(e.type, e.name, args)
    elif isinstance(e, E.SpecialForm):
        args = tuple(rewrite_bottom_up(a, fn) for a in e.arguments)
        if args != e.arguments:
            e = E.SpecialForm(e.type, e.form, args)
    elif isinstance(e, E.Lambda):
        body = rewrite_bottom_up(e.body, fn)
        if body is not e.body:
            e = E.Lambda(e.type, e.parameters, body)
    return fn(e)


def map_input_channels(e: E.RowExpression, mapping) -> E.RowExpression:
    """Renumber InputReferences through `mapping` (dict or callable)."""
    get = mapping.__getitem__ if hasattr(mapping, "__getitem__") else mapping

    def fn(x):
        if isinstance(x, E.InputReference):
            return E.InputReference(x.type, get(x.channel))
        return x
    return rewrite_bottom_up(e, fn)


def input_channels(e: E.RowExpression) -> Set[int]:
    """All input channels referenced under `e`."""
    out: Set[int] = set()

    def walk(x):
        if isinstance(x, E.InputReference):
            out.add(x.channel)
        for c in x.children():
            walk(c)
    walk(e)
    return out


# What folding a constant subtree may raise where the port refuses or
# cannot compute it at plan time: a cast or function it does not run
# (NotImplementedError: CAST(varchar AS bigint) without the string-parse
# kernels, a cast to an unbounded varchar), and a string result that is
# not UTF-8 (UnicodeDecodeError: substr of a multibyte character). The
# subtree then stays symbolic, as the reference leaves it, and the run
# evaluates it.
_UNFOLDABLE_ERRORS = (NotImplementedError, UnicodeDecodeError)


def fold_constants(e: E.RowExpression) -> E.RowExpression:
    """Evaluate constant subtrees at plan time with the registered
    kernels over a one-row CPU batch, so that plan-time and run-time
    values come from the same code. Subtrees containing input
    references, lambdas, or non-scalar/long-decimal results are left
    alone, as are those whose evaluation raises one of
    `_UNFOLDABLE_ERRORS`."""
    def foldable(x: E.RowExpression) -> bool:
        if isinstance(x, E.Constant):
            return True
        if isinstance(x, (E.InputReference, E.Lambda, E.LambdaVariable)):
            return False
        if not isinstance(x, (E.Call, E.SpecialForm)):
            return False
        ty = x.type
        if not (ty.is_fixed_width or ty.is_string):
            return False  # arrays/maps/rows stay symbolic
        if ty.is_decimal and not ty.is_short_decimal:
            return False  # int128 lanes have no scalar Constant lane
        if isinstance(x, E.Call) and x.name.lower() in _UNFOLDABLE:
            return False
        return all(foldable(c) for c in x.children())

    def fold_one(x: E.RowExpression) -> E.RowExpression:
        """Evaluate one maximal foldable subtree (one evaluation per
        subtree, not per interior node)."""
        import torch

        from ..block import Batch, StringColumn
        from .compile import evaluate
        try:
            blk = evaluate(x, Batch((), torch.ones(1, dtype=torch.bool)))
            if bool(blk.nulls[0]):
                return E.const(None, x.type)
            if isinstance(blk, StringColumn):
                ln = int(blk.lengths[0])
                # a Constant's string is UTF-8: a result that is not
                # (a byte-indexed substr of a multibyte char) stays
                # symbolic, or the folded value would differ from the
                # run's bytes
                v = bytes(blk.chars[0, :ln].tolist()).decode("utf-8")
            else:
                v = blk.values[0].item()
        except _UNFOLDABLE_ERRORS:
            return x
        return E.const(v, x.type)

    def walk(x: E.RowExpression) -> E.RowExpression:
        if isinstance(x, (E.Call, E.SpecialForm)) and foldable(x):
            return fold_one(x)  # maximal subtree: one evaluation
        if isinstance(x, E.Call):
            na = tuple(walk(a) for a in x.arguments)
            return x if na == x.arguments else E.Call(x.type, x.name, na)
        if isinstance(x, E.SpecialForm):
            na = tuple(walk(a) for a in x.arguments)
            return x if na == x.arguments else \
                E.SpecialForm(x.type, x.form, na)
        if isinstance(x, E.Lambda):
            nb = walk(x.body)
            return x if nb is x.body else \
                E.Lambda(x.type, x.parameters, nb)
        return x

    return walk(e)


# functions that do not fold at plan time (an interception that needs
# the batch's state)
_UNFOLDABLE = {"row_field"}
