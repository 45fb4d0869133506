"""Expression rewriting: the port's copy of what it needs from
presto_tpu/expr/logical.py, which is `rewrite_bottom_up` (lambda
binding substitutes a lambda's variables with it). The rest of that
module, the plan passes' expression logic, comes with the port's own
SQL front door (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

from typing import Callable

from . import ir as E

__all__ = ["rewrite_bottom_up"]


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
