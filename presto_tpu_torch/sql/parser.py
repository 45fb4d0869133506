"""SQL frontend: lexer + recursive-descent parser for the SELECT subset.

The port's copy of presto_tpu/sql/parser.py, unchanged: the engine's
executable subset of Presto's grammar (SqlBase.g4),

  SELECT [DISTINCT] items FROM t [[AS] a] [joins] [WHERE e]
  [GROUP BY es] [HAVING e] [ORDER BY es [ASC|DESC] [NULLS F/L]] [LIMIT n]

with WITH, set operations, subqueries, window functions, lambdas and
the write statements (INSERT, CREATE TABLE AS, DELETE, UPDATE, DROP
TABLE); expressions: arithmetic, comparisons, AND/OR/NOT, BETWEEN, IN,
LIKE, IS [NOT] NULL, CASE, CAST, function calls, DATE/INTERVAL
literals, qualified names.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

__all__ = ["parse_sql", "Query", "Select", "TableRef", "Join", "OrderItem",
           "Literal", "Name", "Func", "BinOp", "NotOp", "Between", "InList",
           "Like", "IsNull", "Case", "Cast", "Star"]


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Literal:
    value: object
    kind: str  # "int" | "decimal" | "string" | "bool" | "null" | "date" | "interval_day"


@dataclasses.dataclass
class Name:
    parts: Tuple[str, ...]  # ("t", "col") or ("col",)


@dataclasses.dataclass
class Star:
    pass


@dataclasses.dataclass
class Func:
    name: str
    args: List[object]
    distinct: bool = False


@dataclasses.dataclass
class BinOp:
    op: str
    left: object
    right: object


@dataclasses.dataclass
class Lambda:
    """x -> body or (x, y) -> body (array/map higher-order args)."""
    params: List[str]
    body: object


@dataclasses.dataclass
class NotOp:
    arg: object


@dataclasses.dataclass
class Between:
    value: object
    lo: object
    hi: object
    negate: bool = False


@dataclasses.dataclass
class InList:
    value: object
    items: List[object]
    negate: bool = False


@dataclasses.dataclass
class Like:
    value: object
    pattern: str
    negate: bool = False


@dataclasses.dataclass
class IsNull:
    value: object
    negate: bool = False


@dataclasses.dataclass
class Case:
    operand: Optional[object]
    whens: List[Tuple[object, object]]
    default: Optional[object]


@dataclasses.dataclass
class Cast:
    value: object
    type_name: str
    safe: bool = False  # TRY_CAST: out-of-domain -> NULL


@dataclasses.dataclass
class WindowExpr:
    func: "Func"
    partition_by: List[object]
    order_by: List["OrderItem"]
    # None = default (RANGE UNBOUNDED PRECEDING..CURRENT ROW with ORDER
    # BY, full partition without); else ("rows"|"range", start, end)
    # where start/end is None (unbounded) or a signed row offset
    # (negative = PRECEDING, 0 = CURRENT ROW, positive = FOLLOWING)
    frame: object = None


@dataclasses.dataclass
class SelectItem:
    expr: object
    alias: Optional[str]


@dataclasses.dataclass
class TableRef:
    name: str
    alias: Optional[str]
    subquery: Optional[object] = None  # derived table: (SELECT ...) alias


@dataclasses.dataclass
class Join:
    kind: str  # "inner" | "left" | "right" | "full" | "cross"
    table: TableRef
    condition: object


@dataclasses.dataclass
class OrderItem:
    expr: object
    descending: bool
    nulls_last: bool


@dataclasses.dataclass
class Select:
    items: List[SelectItem]
    distinct: bool


@dataclasses.dataclass
class InSubquery:
    value: object
    query: "Query"
    negate: bool = False


@dataclasses.dataclass
class ScalarSubquery:
    query: object  # Query | SetQuery


@dataclasses.dataclass
class Exists:
    query: "Query"
    negate: bool = False


@dataclasses.dataclass
class Rollup:
    items: List[object]


@dataclasses.dataclass
class Cube:
    items: List[object]


@dataclasses.dataclass
class GroupingSets:
    sets: List[List[object]]


@dataclasses.dataclass
class Query:
    select: Select
    table: TableRef
    joins: List[Join]
    where: Optional[object]
    group_by: List[object]
    having: Optional[object]
    order_by: List[OrderItem]
    limit: Optional[int]


@dataclasses.dataclass
class Insert:
    """INSERT INTO t [(cols)] (SELECT ... | VALUES (...), ...)."""
    table: str                      # bare or catalog-qualified name
    columns: Optional[List[str]]
    query: object                   # Query | SetQuery | ValuesRows


@dataclasses.dataclass
class ValuesRows:
    rows: List[List[object]]        # expression ASTs per cell


@dataclasses.dataclass
class CreateTableAs:
    table: str
    query: object
    if_not_exists: bool = False


@dataclasses.dataclass
class DropTable:
    table: str
    if_exists: bool = False


@dataclasses.dataclass
class Delete:
    """DELETE FROM t [WHERE p]."""
    table: str
    where: object = None


@dataclasses.dataclass
class Update:
    """UPDATE t SET c = e [, ...] [WHERE p]."""
    table: str
    assignments: List[Tuple[str, object]] = dataclasses.field(
        default_factory=list)
    where: object = None


@dataclasses.dataclass
class SetQuery:
    """UNION / INTERSECT / EXCEPT of two query terms."""
    op: str                 # "union" | "intersect" | "except"
    all: bool               # UNION ALL vs set semantics
    left: object            # Query | SetQuery
    right: object


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<number>\d+(?:\.\d+)?)
    | (?P<string>'(?:[^']|'')*')
    | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><>|!=|>=|<=|->|=|<|>|\+|-|\*|/|%|\(|\)|,|\.|\[|\])
    )""", re.VERBOSE)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "limit", "as", "and", "or", "not", "between", "in", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "join", "inner", "left",
    "on", "true", "false", "asc", "desc", "nulls", "first", "last", "date",
    "interval", "day", "month", "year", "extract", "outer", "over",
    "partition", "union", "intersect", "except", "all", "with", "exists",
    "try_cast",
}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize at: {text[pos:pos + 30]!r}")
        pos = m.end()
        if m.lastgroup == "number":
            out.append(("number", m.group("number")))
        elif m.lastgroup == "string":
            out.append(("string", m.group("string")[1:-1].replace("''", "'")))
        elif m.lastgroup == "ident":
            word = m.group("ident")
            if word.lower() in _KEYWORDS:
                out.append(("kw", word.lower()))
            else:
                out.append(("ident", word))
        else:
            out.append(("op", m.group("op")))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *words) -> Optional[str]:
        k, v = self.peek()
        if k == "kw" and v in words:
            self.next()
            return v
        return None

    def accept_ident(self, *words) -> Optional[str]:
        """Soft keywords: contextual words (AT TIME ZONE, ...) that stay
        usable as column names elsewhere."""
        k, v = self.peek()
        if k == "ident" and v.lower() in words:
            self.next()
            return v.lower()
        return None

    def expect_kw(self, word: str):
        if not self.accept_kw(word):
            raise ValueError(f"expected {word.upper()}, got {self.peek()}")

    def accept_ctx_kw(self, word: str, before_op: Optional[str] = None,
                      before_kw: Optional[str] = None,
                      before_ident: Optional[str] = None) -> bool:
        """Contextual (non-reserved) keyword: matches an identifier token
        case-insensitively, optionally only when the NEXT token is the
        given operator/keyword -- Presto keeps words like ROLLUP and
        CROSS usable as plain identifiers (SqlBase.g4 nonReserved rule)."""
        k, v = self.peek()
        if k == "ident" and v.lower() == word:
            if before_op is not None:
                k2, v2 = self.toks[self.i + 1]
                if not (k2 == "op" and v2 == before_op):
                    return False
            if before_kw is not None:
                k2, v2 = self.toks[self.i + 1]
                if not (k2 == "kw" and v2 == before_kw):
                    return False
            if before_ident is not None:
                k2, v2 = self.toks[self.i + 1]
                if not (k2 == "ident" and v2.lower() == before_ident):
                    return False
            self.next()
            return True
        return False

    def _paren_expr_list(self) -> List[object]:
        self.expect_op("(")
        items = [self.expr()]
        while self.accept_op(","):
            items.append(self.expr())
        self.expect_op(")")
        return items

    def _grouping_set(self) -> List[object]:
        """One GROUPING SETS element: (a, b) | (single) | () | bare expr."""
        if self.accept_op("("):
            if self.accept_op(")"):
                return []
            items = [self.expr()]
            while self.accept_op(","):
                items.append(self.expr())
            self.expect_op(")")
            return items
        return [self.expr()]

    def accept_op(self, *ops) -> Optional[str]:
        k, v = self.peek()
        if k == "op" and v in ops:
            self.next()
            return v
        return None

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise ValueError(f"expected {op!r}, got {self.peek()}")

    def expect_ident(self) -> str:
        k, v = self.next()
        if k not in ("ident", "kw"):  # allow keywords as identifiers sparingly
            raise ValueError(f"expected identifier, got {(k, v)}")
        return v

    # -- expressions --------------------------------------------------------

    def expr(self):
        # lambda arguments: x -> body  |  (x, y) -> body
        k, v = self.peek()
        if k == "ident" and self.toks[self.i + 1] == ("op", "->"):
            self.next()
            self.next()
            return Lambda([v.lower()], self.expr())
        if (k, v) == ("op", "("):
            j = self.i + 1
            params = []
            while self.toks[j][0] == "ident":
                params.append(self.toks[j][1].lower())
                j += 1
                if self.toks[j] == ("op", ","):
                    j += 1
                    continue
                break
            if params and self.toks[j] == ("op", ")") \
                    and self.toks[j + 1] == ("op", "->"):
                self.i = j + 2
                return Lambda(params, self.expr())
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.accept_kw("or"):
            left = BinOp("or", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.accept_kw("and"):
            left = BinOp("and", left, self.not_expr())
        return left

    def not_expr(self):
        if self.accept_kw("not"):
            return NotOp(self.not_expr())
        return self.predicate()

    def predicate(self):
        left = self.additive()
        negate = bool(self.accept_kw("not"))
        if self.accept_kw("between"):
            lo = self.additive()
            self.expect_kw("and")
            hi = self.additive()
            return Between(left, lo, hi, negate)
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.peek() == ("kw", "select"):
                sub = self.query()  # set-op subqueries terminate on ")"
                self.expect_op(")")
                return InSubquery(left, sub, negate)
            items = [self.expr()]
            while self.accept_op(","):
                items.append(self.expr())
            self.expect_op(")")
            return InList(left, items, negate)
        if self.accept_kw("like"):
            k, v = self.next()
            assert k == "string", "LIKE pattern must be a string literal"
            return Like(left, v, negate)
        if self.accept_kw("is"):
            neg = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return IsNull(left, neg)
        assert not negate, "dangling NOT"
        op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
        if op:
            return BinOp(op, left, self.additive())
        return left

    def additive(self):
        left = self.multiplicative()
        while True:
            op = self.accept_op("+", "-")
            if not op:
                return left
            left = BinOp(op, left, self.multiplicative())

    def multiplicative(self):
        left = self.unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return left
            left = BinOp(op, left, self.unary())

    def unary(self):
        if self.accept_op("-"):
            return Func("negate", [self.unary()])
        e = self.primary()
        # postfix subscript a[i] (1-based; element_at semantics) and
        # AT TIME ZONE 'zone' -- both bind tighter than arithmetic
        while True:
            if self.accept_op("["):
                idx = self.expr()
                k2, v2 = self.next()
                assert (k2, v2) == ("op", "]"), "expected ] after subscript"
                e = Func("element_at", [e, idx])
                continue
            mark = self.i
            if self.accept_ident("at"):
                if self.accept_ident("time") and self.accept_ident("zone"):
                    k, v = self.next()
                    assert k == "string", "AT TIME ZONE needs a zone string"
                    e = Func("at_timezone", [e, Literal(v, "string")])
                    continue
                self.i = mark  # a column actually named "at"
            break
        return e

    def primary(self):
        k, v = self.peek()
        if k == "number":
            self.next()
            if "." in v:
                scale = len(v.split(".")[1])
                return Literal(int(v.replace(".", "")), f"decimal:{scale}")
            return Literal(int(v), "int")
        if k == "string":
            self.next()
            return Literal(v, "string")
        if k == "kw" and v in ("true", "false"):
            self.next()
            return Literal(v == "true", "bool")
        if k == "kw" and v == "null":
            self.next()
            return Literal(None, "null")
        if k == "kw" and v == "date":
            self.next()
            kk, vv = self.next()
            assert kk == "string"
            return Literal(vv, "date")
        if k == "ident" and v.lower() in ("timestamp", "time") \
                and self.toks[self.i + 1][0] == "string":
            self.next()
            _, vv = self.next()
            return Literal(vv, v.lower())
        if k == "kw" and v == "interval":
            self.next()
            kk, vv = self.next()
            assert kk == "string"
            unit = self.next()[1]  # day | month | year
            return Literal((int(vv), unit), "interval")
        if k == "kw" and v in ("cast", "try_cast"):
            self.next()
            self.expect_op("(")
            e = self.expr()
            self.expect_kw("as")
            tname = self._type_name()
            self.expect_op(")")
            return Cast(e, tname, safe=(v == "try_cast"))
        if k == "kw" and v == "case":
            return self._case()
        if k == "kw" and v == "exists":
            self.next()
            self.expect_op("(")
            sub = self.query()
            self.expect_op(")")
            return Exists(sub)
        if k == "kw" and v == "extract":
            self.next()
            self.expect_op("(")
            unit = self.next()[1]
            self.expect_kw("from")
            e = self.expr()
            self.expect_op(")")
            return Func(unit.lower(), [e])
        if k == "op" and v == "(":
            self.next()
            if self.peek() == ("kw", "select"):
                sub = self.query()
                self.expect_op(")")
                return ScalarSubquery(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if k == "op" and v == "*":
            self.next()
            return Star()
        if k == "ident" and v.lower() == "array" \
                and self.toks[self.i + 1] == ("op", "["):
            self.next()
            self.next()
            items = []
            if self.peek() != ("op", "]"):
                items.append(self.expr())
                while self.accept_op(","):
                    items.append(self.expr())
            k2, v2 = self.next()
            assert (k2, v2) == ("op", "]"), "expected ] in ARRAY literal"
            return Func("array_constructor", items)
        if k == "ident" and v.lower() in ("current_timestamp",
                                          "current_date", "localtimestamp") \
                and self.toks[self.i + 1] != ("op", "("):
            self.next()
            return Func(v.lower(), [])
        if k in ("ident", "kw"):
            self.next()
            if self.peek() == ("op", "("):
                self.next()
                distinct = bool(self.accept_kw("distinct"))
                args: List[object] = []
                if self.peek() != ("op", ")"):
                    args.append(self.expr())
                    while self.accept_op(","):
                        args.append(self.expr())
                self.expect_op(")")
                fn = Func(v.lower(), args, distinct)
                if self.accept_kw("over"):
                    self.expect_op("(")
                    part: List[object] = []
                    order: List[OrderItem] = []
                    if self.accept_kw("partition"):
                        self.expect_kw("by")
                        part.append(self.expr())
                        while self.accept_op(","):
                            part.append(self.expr())
                    if self.accept_kw("order"):
                        self.expect_kw("by")
                        order.append(self._order_item())
                        while self.accept_op(","):
                            order.append(self._order_item())
                    frame = self._window_frame()
                    self.expect_op(")")
                    return WindowExpr(fn, part, order, frame)
                return fn
            parts = [v]
            while self.accept_op("."):
                parts.append(self.expect_ident())
            if len(parts) > 1 and self.peek() == ("op", "("):
                # qualified function call (namespace-managed UDFs:
                # catalog.schema.fn(...))
                self.next()
                args: List[object] = []
                if self.peek() != ("op", ")"):
                    args.append(self.expr())
                    while self.accept_op(","):
                        args.append(self.expr())
                self.expect_op(")")
                return Func(".".join(p.lower() for p in parts), args)
            return Name(tuple(parts))
        raise ValueError(f"unexpected token {(k, v)}")

    def _type_name(self) -> str:
        name = self.expect_ident()
        # multiword type names: TIMESTAMP WITH TIME ZONE,
        # INTERVAL YEAR TO MONTH / DAY TO SECOND, DOUBLE PRECISION
        low = name.lower()
        if low == "timestamp" and self.peek() == ("kw", "with"):
            self.next()
            for w in ("time", "zone"):
                t = self.next()[1].lower()
                assert t == w, f"expected {w!r} in type name, got {t!r}"
            name = "timestamp with time zone"
        elif low == "interval":
            a = self.next()[1].lower()
            self.expect_ident()  # TO
            b = self.next()[1].lower()
            name = f"interval {a} to {b}"
        elif low == "double" and self.peek()[1] == "precision":
            self.next()
            name = "double"
        if self.accept_op("("):
            params = [self.next()[1]]
            while self.accept_op(","):
                params.append(self.next()[1])
            self.expect_op(")")
            return f"{name}({', '.join(params)})"
        return name

    def _case(self):
        self.expect_kw("case")
        operand = None
        if not (self.peek() == ("kw", "when")):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            c = self.expr()
            self.expect_kw("then")
            r = self.expr()
            whens.append((c, r))
        default = None
        if self.accept_kw("else"):
            default = self.expr()
        self.expect_kw("end")
        return Case(operand, whens, default)

    # -- query --------------------------------------------------------------

    def query(self, allow_setops: bool = True):
        # standard precedence: INTERSECT binds tighter than UNION/EXCEPT
        left = self._intersect_term()
        while allow_setops:
            op = self.accept_kw("union", "except")
            if not op:
                break
            is_all = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self._intersect_term()
            left = SetQuery(op, is_all, left, right)
        return left

    def _intersect_term(self):
        left = self._query_term()
        while self.accept_kw("intersect"):
            is_all = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self._query_term()
            left = SetQuery("intersect", is_all, left, right)
        return left

    def _query_term(self) -> Query:
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        if self.accept_kw("from"):
            table = self._table_ref()
        else:
            # FROM-less SELECT: one synthetic single-row source (the
            # reference plans these over a one-row ValuesNode); the
            # normal WHERE/ORDER BY/LIMIT clause loop still applies
            table = TableRef("$dual", None)
        joins = []
        while True:
            # comma-separated FROM items / CROSS JOIN: a join with no ON
            # condition; equi-keys come from WHERE conjuncts (the
            # planner's join-graph extraction, TPC-DS benchmark style)
            if self.accept_op(","):
                joins.append(Join("cross", self._table_ref(), None))
                continue
            if self.accept_ctx_kw("cross", before_kw="join"):
                self.expect_kw("join")
                joins.append(Join("cross", self._table_ref(), None))
                continue
            kind = None
            if self.accept_kw("inner"):
                kind = "inner"
                self.expect_kw("join")
            elif self.accept_kw("left"):
                kind = "left"
                self.accept_kw("outer")
                self.expect_kw("join")
            elif self.accept_ctx_kw("right", before_kw="join") or \
                    self.accept_ctx_kw("right", before_kw="outer"):
                kind = "right"
                self.accept_kw("outer")
                self.expect_kw("join")
            elif self.accept_ctx_kw("full", before_kw="join") or \
                    self.accept_ctx_kw("full", before_kw="outer"):
                kind = "full"
                self.accept_kw("outer")
                self.expect_kw("join")
            elif self.accept_kw("join"):
                kind = "inner"
            if kind is None:
                break
            t = self._table_ref()
            self.expect_kw("on")
            cond = self.expr()
            joins.append(Join(kind, t, cond))
        where = self.expr() if self.accept_kw("where") else None
        group_by: List[object] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            if self.accept_ctx_kw("rollup", before_op="("):
                group_by.append(Rollup(self._paren_expr_list()))
            elif self.accept_ctx_kw("cube", before_op="("):
                group_by.append(Cube(self._paren_expr_list()))
            elif self.accept_ctx_kw("grouping", before_kw=None,
                                    before_ident="sets"):
                self.next()  # the already-matched SETS token
                self.expect_op("(")
                sets = [self._grouping_set()]
                while self.accept_op(","):
                    sets.append(self._grouping_set())
                self.expect_op(")")
                group_by.append(GroupingSets(sets))
            else:
                group_by.append(self.expr())
                while self.accept_op(","):
                    group_by.append(self.expr())
        having = self.expr() if self.accept_kw("having") else None
        order_by: List[OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self._order_item())
            while self.accept_op(","):
                order_by.append(self._order_item())
        limit = None
        if self.accept_kw("limit"):
            k, v = self.next()
            assert k == "number"
            limit = int(v)
        return Query(Select(items, distinct), table, joins, where, group_by,
                     having, order_by, limit)

    def _select_item(self) -> SelectItem:
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek()[0] == "ident":
            alias = self.next()[1]
        return SelectItem(e, alias)

    def _implicit_alias(self) -> Optional[str]:
        """An identifier alias -- but not the contextual keywords CROSS/
        RIGHT/FULL when they introduce the next join (Presto keeps them
        non-reserved; SqlBase.g4 nonReserved)."""
        if self.peek()[0] != "ident":
            return None
        w = self.peek()[1].lower()
        if w in ("cross", "right", "full"):
            k2, v2 = self.toks[self.i + 1]
            if k2 == "kw" and v2 in ("join", "outer"):
                return None
        return self.next()[1]

    def _table_ref(self) -> TableRef:
        if self.accept_op("("):
            sub = self.query()
            self.expect_op(")")
            alias = None
            if self.accept_kw("as"):
                alias = self.expect_ident()
            else:
                alias = self._implicit_alias()
            if not alias:
                raise ValueError("derived table requires an alias")
            return TableRef(alias.lower(), alias, subquery=sub)
        name = self.expect_ident()
        # catalog-qualified reference: memory.t (two parts; deeper
        # schemas collapse into the catalog-level names this engine uses)
        while True:
            k, v = self.peek()
            if not (k == "op" and v == "."):
                break
            k2, _v2 = self.toks[self.i + 1]
            if k2 != "ident":
                break
            self.next()
            name += "." + self.expect_ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        else:
            alias = self._implicit_alias()
        if alias is None and "." in name:
            alias = name.rsplit(".", 1)[1]  # bare table name qualifies
        return TableRef(name.lower(), alias)

    def _window_frame(self):
        """[ROWS|RANGE [BETWEEN] bound [AND bound]] inside OVER (...).
        bound: UNBOUNDED PRECEDING|FOLLOWING, CURRENT ROW, n
        PRECEDING|FOLLOWING. Returns None or (mode, start, end)."""
        mode = None
        if self.accept_ctx_kw("rows"):
            mode = "rows"
        elif self.accept_ctx_kw("range"):
            mode = "range"
        if mode is None:
            return None

        def bound():
            if self.accept_ctx_kw("unbounded"):
                which = self.next()[1].lower()
                assert which in ("preceding", "following"), which
                return "unbounded_precede" if which == "preceding" \
                    else "unbounded_follow"
            if self.accept_ctx_kw("current"):
                k, v = self.next()
                assert v.lower() == "row", (k, v)
                return 0
            k, v = self.next()
            assert k == "number", f"expected frame bound, got {(k, v)}"
            n = float(v) if "." in v else int(v)  # RANGE takes decimals
            which = self.next()[1].lower()
            assert which in ("preceding", "following"), which
            return -n if which == "preceding" else n

        if self.accept_kw("between"):
            start = bound()
            self.expect_kw("and")
            end = bound()
        else:
            start = bound()
            end = 0  # implicit CURRENT ROW
        # normalize to (mode, start, end) with None = unbounded on that
        # side; the invalid corner sentinels are rejected, not coerced
        if start == "unbounded_follow":
            raise ValueError("frame start cannot be UNBOUNDED FOLLOWING")
        if end == "unbounded_precede":
            raise ValueError("frame end cannot be UNBOUNDED PRECEDING")
        start_v = None if start == "unbounded_precede" else start
        end_v = None if end == "unbounded_follow" else end
        # ANSI ordering rule: a bounded start must not sit after a
        # bounded end (covers ROWS n FOLLOWING => implicit CURRENT ROW
        # end, and BETWEEN CURRENT ROW AND n PRECEDING)
        if start_v is not None and end_v is not None and start_v > end_v:
            raise ValueError("window frame start cannot follow frame end")
        return (mode, start_v, end_v)

    def _order_item(self) -> OrderItem:
        e = self.expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        else:
            self.accept_kw("asc")
        nulls_last = True  # presto default for ASC; DESC default NULLS LAST too
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_last = False
            else:
                self.expect_kw("last")
        return OrderItem(e, desc, nulls_last)


def parse_expression(text: str):
    """Parse ONE scalar expression (SQL-invoked function bodies)."""
    p = _Parser(_tokenize(text))
    e = p.expr()
    k, v = p.peek()
    if k != "eof":
        raise ValueError(f"trailing tokens in expression at {(k, v)}")
    return e


def parse_sql(text: str):
    p = _Parser(_tokenize(text))
    k, v = p.peek()
    if k == "ident" and v.lower() in ("insert", "create", "drop",
                                      "delete", "update"):
        return _parse_dml(p, v.lower())
    ctes = {}
    if p.accept_kw("with"):
        while True:
            name = p.expect_ident().lower()
            p.expect_kw("as")
            p.expect_op("(")
            ctes[name] = p.query()
            p.expect_op(")")
            if not p.accept_op(","):
                break
    q = p.query()
    k, v = p.peek()
    if k != "eof":
        raise ValueError(f"trailing tokens at {(k, v)}")
    if ctes:
        # earlier CTEs are visible inside later CTE bodies (no recursion)
        names = list(ctes)
        for i, n in enumerate(names):
            _inline_ctes(ctes[n], {m: ctes[m] for m in names[:i]})
        _inline_ctes(q, ctes)
    return q


def _parse_dml(p: "_Parser", first: str):
    """INSERT INTO / CREATE TABLE [IF NOT EXISTS] t AS / DROP TABLE
    [IF EXISTS] t. The write verbs are contextual identifiers (like the
    reference's nonReserved words), matched case-insensitively."""

    def ctx(word):
        k, v = p.peek()
        if k == "ident" and v.lower() == word:
            p.next()
            return True
        return False

    def expect_ctx(word):
        if not ctx(word):
            raise ValueError(f"expected {word.upper()}, got {p.peek()}")

    def qualified_name() -> str:
        name = p.expect_ident()
        while True:
            k, v = p.peek()
            if k == "op" and v == ".":
                p.next()
                name += "." + p.expect_ident()
            else:
                return name.lower()

    p.next()  # consume the verb
    if first == "insert":
        expect_ctx("into")
        table = qualified_name()
        columns = None
        if p.accept_op("("):
            columns = [p.expect_ident().lower()]
            while p.accept_op(","):
                columns.append(p.expect_ident().lower())
            p.expect_op(")")
        if ctx("values"):
            rows = []
            while True:
                p.expect_op("(")
                row = [p.expr()]
                while p.accept_op(","):
                    row.append(p.expr())
                p.expect_op(")")
                rows.append(row)
                if not p.accept_op(","):
                    break
            query = ValuesRows(rows)
        else:
            query = p.query()
        k, _ = p.peek()
        if k != "eof":
            raise ValueError(f"trailing tokens at {p.peek()}")
        return Insert(table, columns, query)
    if first == "create":
        expect_ctx("table")
        if_not_exists = False
        if ctx("if"):
            p.expect_kw("not")
            p.expect_kw("exists")
            if_not_exists = True
        table = qualified_name()
        p.expect_kw("as")
        q = p.query()
        k, _ = p.peek()
        if k != "eof":
            raise ValueError(f"trailing tokens at {p.peek()}")
        return CreateTableAs(table, q, if_not_exists)
    if first == "delete":
        p.expect_kw("from")
        table = qualified_name()
        where = None
        if p.accept_kw("where"):
            where = p.expr()
        k, _ = p.peek()
        if k != "eof":
            raise ValueError(f"trailing tokens at {p.peek()}")
        return Delete(table, where)
    if first == "update":
        table = qualified_name()
        expect_ctx("set")
        assignments = []
        while True:
            col = p.expect_ident().lower()
            p.expect_op("=")
            assignments.append((col, p.expr()))
            if not p.accept_op(","):
                break
        where = None
        if p.accept_kw("where"):
            where = p.expr()
        k, _ = p.peek()
        if k != "eof":
            raise ValueError(f"trailing tokens at {p.peek()}")
        return Update(table, assignments, where)
    # DROP TABLE [IF EXISTS] t
    expect_ctx("table")
    if_exists = False
    if ctx("if"):
        p.expect_kw("exists")
        if_exists = True
    table = qualified_name()
    k, _ = p.peek()
    if k != "eof":
        raise ValueError(f"trailing tokens at {p.peek()}")
    return DropTable(table, if_exists)


def _inline_ctes(q, ctes):
    """CTEs inline as derived tables at each reference -- anywhere in the
    AST, including FROM clauses of scalar/IN subqueries (the reference's
    default; materialized CTEs are an optimizer feature)."""
    seen = set()

    def visit(obj):
        if id(obj) in seen or not dataclasses.is_dataclass(obj):
            return
        seen.add(id(obj))
        if isinstance(obj, TableRef):
            if obj.subquery is None and obj.name in ctes:
                obj.subquery = ctes[obj.name]
            if obj.subquery is not None:
                visit(obj.subquery)
            return
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                visit(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if dataclasses.is_dataclass(x):
                        visit(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            if dataclasses.is_dataclass(y):
                                visit(y)

    visit(q)
