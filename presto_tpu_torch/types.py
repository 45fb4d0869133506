"""SQL type system: the port's own copy of presto_tpu/types.py.

Host-only (numpy dtypes, no device arrays). Kept as a copy rather than
an import so the PyTorch package stands alone; it must stay in step
with presto_tpu/types.py, which the tests hold it against.

Reference surface: presto-common/src/main/java/com/facebook/presto/common/type/
(~80 files: BigintType, DoubleType, VarcharType, DecimalType, ArrayType, ...)
and the type-signature parser the native worker keeps in
presto-native-execution/presto_cpp/main/types/TypeParser.cpp.

Device mapping: integral SQL types map to the narrowest integer dtype;
DECIMAL(p, s) is a scaled int64 for p <= 18 and a (hi, lo) int64 lane
pair for p > 18 (block.Int128Column); VARCHAR/CHAR are padded uint8
matrices plus a length vector; DATE is days since epoch (int32).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import numpy as np

__all__ = [
    "Type",
    "BOOLEAN", "TINYINT", "SMALLINT", "INTEGER", "BIGINT",
    "REAL", "DOUBLE", "DATE", "TIME", "TIMESTAMP", "TIMESTAMP_TZ",
    "VARBINARY", "JSON", "INTERVAL_YM", "INTERVAL_DS", "UNKNOWN",
    "varchar", "char", "decimal", "array_of", "map_of", "row_of",
    "parse_type",
]


@dataclasses.dataclass(frozen=True)
class Type:
    """A SQL type. `base` is the lowercase base name ("bigint", "varchar",
    "decimal", "array", ...); `parameters` hold numeric or nested-type
    parameters exactly as in a Presto TypeSignature."""

    base: str
    parameters: Tuple[object, ...] = ()

    # ---- classification -------------------------------------------------
    @property
    def is_integral(self) -> bool:
        return self.base in ("tinyint", "smallint", "integer", "bigint")

    @property
    def is_floating(self) -> bool:
        return self.base in ("real", "double")

    @property
    def is_decimal(self) -> bool:
        return self.base == "decimal"

    @property
    def is_string(self) -> bool:
        """Types stored as (padded uint8 char matrix, lengths): text,
        raw bytes (VARBINARY) and canonical JSON text share the layout;
        semantic distinctions live in the function layer."""
        return self.base in ("varchar", "char", "varbinary", "json")

    @property
    def is_numeric(self) -> bool:
        return self.is_integral or self.is_floating or self.is_decimal

    @property
    def is_fixed_width(self) -> bool:
        return not (self.is_string or self.base in ("array", "map", "row"))

    # ---- decimal helpers ------------------------------------------------
    @property
    def precision(self) -> int:
        assert self.is_decimal
        return int(self.parameters[0])

    @property
    def scale(self) -> int:
        assert self.is_decimal
        return int(self.parameters[1])

    @property
    def is_short_decimal(self) -> bool:
        return self.is_decimal and self.precision <= 18

    # ---- string helpers -------------------------------------------------
    @property
    def max_length(self) -> int:
        """Declared length for varchar(n)/char(n); UNBOUNDED_LENGTH if none."""
        if self.parameters:
            return int(self.parameters[0])
        return UNBOUNDED_LENGTH

    # ---- container helpers ----------------------------------------------
    @property
    def element_type(self) -> "Type":
        assert self.base == "array"
        return self.parameters[0]

    @property
    def key_type(self) -> "Type":
        assert self.base == "map"
        return self.parameters[0]

    @property
    def value_type(self) -> "Type":
        assert self.base == "map"
        return self.parameters[1]

    @property
    def field_types(self) -> Tuple["Type", ...]:
        assert self.base == "row"
        return tuple(p[1] if isinstance(p, tuple) else p for p in self.parameters)

    # ---- dtype mapping --------------------------------------------------
    def to_dtype(self) -> np.dtype:
        """numpy dtype of the on-device value array for this type."""
        d = _DTYPES.get(self.base)
        if d is not None:
            return np.dtype(d)
        if self.is_decimal:
            # long decimals (p > 18) live as Int128Column (hi, lo) lane
            # pairs on device (block.py); host-side long-decimal arrays
            # are object arrays of exact Python ints. int64 here is the
            # dtype of each LANE (and the staging dtype for values that
            # happen to fit 64 bits).
            return np.dtype(np.int64)
        if self.is_string:
            return np.dtype(np.uint8)
        raise ValueError(f"no device dtype for type {self}")

    # ---- display --------------------------------------------------------
    def __str__(self) -> str:
        if not self.parameters:
            return self.base
        if self.base == "varchar" and self.parameters[0] == UNBOUNDED_LENGTH:
            return "varchar"
        parts = []
        for p in self.parameters:
            if isinstance(p, tuple):  # row field (name, type)
                parts.append(f"{p[0]} {p[1]}")
            else:
                parts.append(str(p))
        return f"{self.base}({', '.join(parts)})"

    def __repr__(self) -> str:
        return f"Type[{self}]"


UNBOUNDED_LENGTH = 2**31 - 1

_DTYPES = {
    "boolean": np.bool_,
    "tinyint": np.int8,
    "smallint": np.int16,
    "integer": np.int32,
    "bigint": np.int64,
    "real": np.float32,
    "double": np.float64,
    "date": np.int32,
    "time": np.int64,                     # micros since midnight
    "timestamp": np.int64,                # micros since epoch
    # packed (utc_micros << 12) | zone_key -- the reference's
    # TimestampWithTimeZoneType packing (millis<<12|key) adapted to this
    # engine's micros; comparisons/keys unpack to the instant
    "timestamp with time zone": np.int64,
    "interval year to month": np.int64,   # months
    "interval day to second": np.int64,   # micros
    "unknown": np.bool_,
}

BOOLEAN = Type("boolean")
TINYINT = Type("tinyint")
SMALLINT = Type("smallint")
INTEGER = Type("integer")
BIGINT = Type("bigint")
REAL = Type("real")
DOUBLE = Type("double")
DATE = Type("date")
TIME = Type("time")
TIMESTAMP = Type("timestamp")
TIMESTAMP_TZ = Type("timestamp with time zone")
VARBINARY = Type("varbinary")
JSON = Type("json")
INTERVAL_YM = Type("interval year to month")
INTERVAL_DS = Type("interval day to second")
UNKNOWN = Type("unknown")  # the NULL literal's type


def varchar(length: int = UNBOUNDED_LENGTH) -> Type:
    return Type("varchar", (length,))


def char(length: int) -> Type:
    return Type("char", (length,))


def decimal(precision: int, scale: int) -> Type:
    return Type("decimal", (precision, scale))


def array_of(elem: Type) -> Type:
    return Type("array", (elem,))


def map_of(key: Type, value: Type) -> Type:
    return Type("map", (key, value))


def row_of(*fields) -> Type:
    """row_of(T1, T2) or row_of(("name", T1), ...)."""
    return Type("row", tuple(fields))


# --------------------------------------------------------------------------
# Type-signature parsing (TypeParser.cpp / TypeSignature.parse analog).
# Grammar: base ( "(" param ("," param)* ")" )?  where param is an integer,
# a nested signature, or `name type` for row fields.
# --------------------------------------------------------------------------

_TOKEN = re.compile(r"\s*([(),]|[^\s(),]+)")

# multiword base names fold to one token for the parser, then unfold
_MULTIWORD = {
    "timestamp with time zone": "timestamp_with_time_zone",
    "interval year to month": "interval_year_to_month",
    "interval day to second": "interval_day_to_second",
}
_UNFOLD = {v: k for k, v in _MULTIWORD.items()}


def parse_type(signature: str) -> Type:
    for phrase, folded in _MULTIWORD.items():
        signature = re.sub(re.escape(phrase), folded, signature,
                           flags=re.IGNORECASE)
    tokens = [_UNFOLD.get(t.lower(), t) for t in _TOKEN.findall(signature)]
    ty, rest = _parse(tokens)
    if rest:
        raise ValueError(f"trailing tokens in type signature {signature!r}: {rest}")
    return ty


def _parse(tokens):
    if not tokens:
        raise ValueError("empty type signature")
    base = tokens[0].lower()
    tokens = tokens[1:]
    if not tokens or tokens[0] != "(":
        return _finish(base, ()), tokens
    tokens = tokens[1:]  # consume "("
    params = []
    while True:
        if tokens and tokens[0] == ")":
            tokens = tokens[1:]
            break
        if tokens and tokens[0].isdigit():
            # could be `123` param or a quoted field name; integers only here
            params.append(int(tokens[0]))
            tokens = tokens[1:]
        else:
            # row field may be `name type`; detect by lookahead
            if base == "row" and len(tokens) >= 2 and tokens[1] not in ("(", ")", ","):
                name = tokens[0]
                ty, tokens = _parse(tokens[1:])
                params.append((name, ty))
            else:
                ty, tokens = _parse(tokens)
                params.append(ty)
        if tokens and tokens[0] == ",":
            tokens = tokens[1:]
    return _finish(base, tuple(params)), tokens


def _finish(base: str, params: tuple) -> Type:
    if base == "varchar" and not params:
        return varchar()
    return Type(base, params)
