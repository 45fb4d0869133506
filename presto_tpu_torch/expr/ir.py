"""The relational expression IR: Presto's RowExpression family.

The port's own copy of presto_tpu/expr/ir.py: input references,
constants, calls, special forms, and lambdas with their variables.
The reference's batch parameter (`param`, the literal slots of
exec/batching.py) is not ported yet. The JSON shape is the
reference's, so a plan fragment written by presto_tpu reads here
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from .. import types as T

__all__ = ["RowExpression", "InputReference", "Constant", "Call",
           "SpecialForm", "Lambda", "LambdaVariable", "input_ref", "const",
           "call", "special", "from_json", "to_json"]


@dataclasses.dataclass(frozen=True)
class RowExpression:
    type: T.Type

    def children(self) -> Tuple["RowExpression", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class InputReference(RowExpression):
    """Input channel `channel` of the operator's input row."""
    channel: int = 0

    def __str__(self):
        return f"$in{self.channel}:{self.type}"


@dataclasses.dataclass(frozen=True)
class Constant(RowExpression):
    """A literal in the device representation (decimals pre-scaled to
    int, dates as epoch days or an ISO string); None is a typed NULL."""
    value: Any = None

    @property
    def is_null(self) -> bool:
        return self.value is None

    def __str__(self):
        return f"{self.value!r}:{self.type}"


@dataclasses.dataclass(frozen=True)
class Call(RowExpression):
    """Scalar function call, resolved by name in expr/functions.py."""
    name: str = ""
    arguments: Tuple[RowExpression, ...] = ()

    def children(self):
        return self.arguments

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.arguments))})"


@dataclasses.dataclass(frozen=True)
class LambdaVariable(RowExpression):
    """A lambda parameter inside a Lambda body; not an input channel."""
    name: str = ""

    def __str__(self):
        return f"{self.name}:{self.type}"


@dataclasses.dataclass(frozen=True)
class Lambda(RowExpression):
    """`parameters -> body`; `type` is the body's type. InputReferences
    in the body capture channels of the enclosing row."""
    parameters: Tuple[str, ...] = ()
    body: RowExpression = None

    def children(self):
        return (self.body,)

    def __str__(self):
        return f"({', '.join(self.parameters)}) -> {self.body}"


FORMS = ("IF", "NULL_IF", "SWITCH", "WHEN", "IS_NULL", "COALESCE", "IN",
         "AND", "OR", "DEREFERENCE", "ROW_CONSTRUCTOR", "BIND", "BETWEEN")


@dataclasses.dataclass(frozen=True)
class SpecialForm(RowExpression):
    """Non-function forms with their own null semantics (AND/OR are
    Kleene three-valued logic)."""
    form: str = ""
    arguments: Tuple[RowExpression, ...] = ()

    def __post_init__(self):
        if self.form not in FORMS:
            raise ValueError(f"unknown special form {self.form!r}")

    def children(self):
        return self.arguments

    def __str__(self):
        return f"{self.form}({', '.join(map(str, self.arguments))})"


def input_ref(channel: int, ty: T.Type) -> InputReference:
    return InputReference(ty, channel)


def const(value: Any, ty: T.Type) -> Constant:
    return Constant(ty, value)


def call(name: str, ty: T.Type, *args: RowExpression) -> Call:
    return Call(ty, name, tuple(args))


def special(form: str, ty: T.Type, *args: RowExpression) -> SpecialForm:
    return SpecialForm(ty, form, tuple(args))


def to_json(e: RowExpression) -> dict:
    if isinstance(e, InputReference):
        return {"@type": "input", "channel": e.channel, "type": str(e.type)}
    if isinstance(e, Constant):
        return {"@type": "constant", "value": e.value, "type": str(e.type)}
    if isinstance(e, Call):
        return {"@type": "call", "displayName": e.name,
                "returnType": str(e.type),
                "arguments": [to_json(a) for a in e.arguments]}
    if isinstance(e, SpecialForm):
        return {"@type": "special", "form": e.form,
                "returnType": str(e.type),
                "arguments": [to_json(a) for a in e.arguments]}
    if isinstance(e, Lambda):
        return {"@type": "lambda", "returnType": str(e.type),
                "parameters": list(e.parameters), "body": to_json(e.body)}
    if isinstance(e, LambdaVariable):
        return {"@type": "lambdavar", "name": e.name, "type": str(e.type)}
    raise TypeError(type(e))


def from_json(j: dict) -> RowExpression:
    t = j["@type"]
    if t == "input":
        return InputReference(T.parse_type(j["type"]), j["channel"])
    if t == "constant":
        return Constant(T.parse_type(j["type"]), j["value"])
    if t == "call":
        return Call(T.parse_type(j["returnType"]), j["displayName"],
                    tuple(from_json(a) for a in j["arguments"]))
    if t == "special":
        return SpecialForm(T.parse_type(j["returnType"]), j["form"],
                           tuple(from_json(a) for a in j["arguments"]))
    if t == "lambda":
        return Lambda(T.parse_type(j["returnType"]), tuple(j["parameters"]),
                      from_json(j["body"]))
    if t == "lambdavar":
        return LambdaVariable(T.parse_type(j["type"]), j["name"])
    if t == "param":
        raise NotImplementedError(
            "'param' expressions are not ported yet (ROADMAP queue 1 "
            "item 12: exec/batching.py)")
    raise ValueError(f"unknown RowExpression kind {t!r}")
