"""The port's file connectors (localfile, parquet, ORC, the lake sink)
and scan predicate pushdown, on the CPU, against presto_tpu.

The files are written once under pytest's temporary directory (the
tpch generator's columns at sf 0.01, and the small tables of the
reference's tests) and registered in both packages' connectors. Each
statement of tests/test_parquet.py, test_parquet_first_class.py and
test_localfile.py runs through `presto_tpu.sql` and
`presto_tpu_torch.sql(..., device="cpu")`: the rows must be equal
(doubles too: these statements sum few values in one order), so must
the parquet row groups read out of the total, and the prepared plans'
JSON (ids renumbered), which carries each scan's `pushdown` range and
no narrow lanes on a pushdown scan. The writes (CTAS, INSERT, DELETE,
UPDATE, DROP) run on parquet and ORC in both packages, each into its
own warehouse, and the tables must stay equal after every statement.

The parquet and ORC cases need pyarrow and skip without it; the
localfile cases do not.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_sql_common import assert_same_plan, exact, pinned_clock  # noqa
from _torch_sql_common import port_prepared  # noqa: E402

from presto_tpu import types as RT  # noqa: E402
from presto_tpu.connectors import localfile as rlf  # noqa: E402
from presto_tpu.connectors import tpch as rtpch  # noqa: E402
from presto_tpu.sql import sql as ref_sql  # noqa: E402

from presto_tpu_torch import sql  # noqa: E402
from presto_tpu_torch import types as PT  # noqa: E402
from presto_tpu_torch.connectors import catalogs  # noqa: E402
from presto_tpu_torch.connectors import localfile as plf  # noqa: E402
from presto_tpu_torch.plan import nodes as PN  # noqa: E402

SF = 0.01

try:
    import pyarrow  # noqa: F401
    HAVE_PYARROW = True
except ImportError:
    HAVE_PYARROW = False


def _needs_pyarrow():
    pytest.importorskip("pyarrow")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(text, **kw):
    """(reference result, port result) of one statement."""
    want = ref_sql(text, sf=SF, **kw)
    got = sql(text, sf=SF, device="cpu", **kw)
    return want, got


def _same(text, **kw):
    want, got = _both(text, **kw)
    assert list(got.names) == list(want.names)
    g, w = exact(got), exact(want)
    if "order by" in text.lower():
        assert g == w
    else:
        assert sorted(map(str, g)) == sorted(map(str, w))
    return got


# ---- localfile: the files of tests/test_localfile.py ---------------------

LOCAL_FILES = {
    "ev.csv": ("ts,user,n,price\n"
               "2024-01-01T10:00:00,alice,3,9.50\n"
               "2024-01-02T11:30:00,bob,,1.25\n"
               "not-a-time,alice,5,\n"),
    "t.csv": "a,b,c\n1,x,1.5\n2,yy,2.5\n",
    "log.jsonl": ('{"user": "a", "n": 1}\n'
                  "this is not json\n"
                  '{"user": "b", "n": 2, "extra": true}\n'
                  '{"n": 3}\n'),
    "dim.csv": "regionkey,label\n0,zero\n1,one\n2,two\n",
    "f.jsonl": ('{"f": 1.5, "b": true, "i": 2}\n'
                '{"f": 2.5, "b": false, "i": 3}\n'),
    "z.csv": "ts\n2024-01-01T10:00:00+02:00\n2024-01-01T08:00:00\n",
    "m.jsonl": '{"x": 1.5}\n{"x": "n/a"}\n',
    "m2.jsonl": '{"y": true}\n{"y": 1}\n{"y": 3}\n',
}
# table -> (file, the declared schema as type strings, or None: inferred)
LOCAL_TABLES = {
    "ev": ("ev.csv", {"ts": "timestamp", "user": "varchar(16)",
                      "n": "bigint", "price": "decimal(10,2)"}),
    "t": ("t.csv", None),
    "log": ("log.jsonl", {"user": "varchar(8)", "n": "bigint"}),
    "dim": ("dim.csv", {"regionkey": "bigint", "label": "varchar(8)"}),
    "f": ("f.jsonl", None),
    "z": ("z.csv", {"ts": "timestamp"}),
    "m": ("m.jsonl", None),
    "m2": ("m2.jsonl", None),
}

LOCAL_STATEMENTS = [
    "SELECT user, n, price FROM localfile.ev ORDER BY user, n",
    "SELECT count(ts) FROM localfile.ev",
    "SELECT user, count(*), sum(n) FROM localfile.ev GROUP BY user "
    "ORDER BY user",
    "SELECT sum(a), max(c) FROM localfile.t",
    "SELECT user, n FROM localfile.log ORDER BY n",
    "SELECT d.label, count(*) FROM nation n JOIN localfile.dim d "
    "ON n.regionkey = d.regionkey GROUP BY d.label ORDER BY d.label",
    "SELECT sum(f) FROM localfile.f",
    "SELECT count(DISTINCT ts) FROM localfile.z",
    "SELECT x FROM localfile.m ORDER BY x",
    "SELECT sum(y) FROM localfile.m2",
]


@pytest.fixture(scope="module")
def local_tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("localfile")
    for name, text in LOCAL_FILES.items():
        (d / name).write_text(text)
    schemas = {}
    for table, (fname, decl) in LOCAL_TABLES.items():
        path = str(d / fname)
        got = plf.register_table(
            table, path, schema=None if decl is None else
            {c: PT.parse_type(t) for c, t in decl.items()})
        want = rlf.register_table(
            table, path, schema=None if decl is None else
            {c: RT.parse_type(t) for c, t in decl.items()})
        schemas[table] = (got, want)
    yield schemas
    plf.reset()
    rlf.reset()


@pytest.mark.parametrize("table", sorted(LOCAL_TABLES))
def test_localfile_schema_equals_the_reference(local_tables, table):
    got, want = local_tables[table]
    assert {c: str(t) for c, t in got.items()} == \
        {c: str(t) for c, t in want.items()}
    for c in got:
        g = plf.generate_columns(table, SF, [c])[c]
        w = rlf.generate_columns(table, SF, [c])[c]
        assert g.dtype == w.dtype and g.tolist() == w.tolist()
        assert plf.generate_nulls(table, [c])[c].tolist() == \
            rlf.generate_nulls(table, [c])[c].tolist()


@pytest.mark.parametrize("text", LOCAL_STATEMENTS)
def test_localfile_rows_equal_the_reference(local_tables, text):
    _same(text)


@pytest.mark.parametrize("text", LOCAL_STATEMENTS)
def test_localfile_plan_equals_the_reference(local_tables, text):
    assert_same_plan(text, SF)


def test_localfile_rows_are_the_reference_tests_answers(local_tables):
    """tests/test_localfile.py's expected rows, from the port."""
    def port(text):
        return sql(text, sf=SF, device="cpu").rows()
    assert port(LOCAL_STATEMENTS[0]) == [("alice", 3, 950),
                                         ("alice", 5, None),
                                         ("bob", None, 125)]
    assert port(LOCAL_STATEMENTS[1]) == [(2,)]
    assert port(LOCAL_STATEMENTS[4]) == [("a", 1), ("b", 2), (None, 3),
                                         (None, None)]
    assert port(LOCAL_STATEMENTS[7]) == [(1,)]
    assert port(LOCAL_STATEMENTS[8]) == [("1.5",), ("n/a",)]
    assert port(LOCAL_STATEMENTS[9]) == [(5,)]


def test_localfile_generate_batch_stages_on_the_given_device(local_tables):
    b = plf.generate_batch("dim", SF, ["regionkey", "label"], device="cpu")
    assert b.active.device.type == "cpu" and int(b.active.sum()) == 3


# ---- parquet and ORC: the files of tests/test_parquet*.py ----------------

Q1 = """
  SELECT returnflag, linestatus, sum(quantity) AS q,
         sum(extendedprice) AS p,
         sum(extendedprice * (1 - discount)) AS disc,
         count(*) AS n
  FROM lineitem WHERE shipdate <= date '1998-09-02'
  GROUP BY returnflag, linestatus ORDER BY returnflag, linestatus
"""
Q6 = """
  SELECT sum(extendedprice * discount) AS revenue FROM lineitem
  WHERE shipdate >= date '1994-01-01' AND shipdate < date '1995-01-01'
    AND discount BETWEEN 0.05 AND 0.07 AND quantity < 24
"""
CORPUS_Q = ("SELECT sum(extendedprice * discount) FROM parquet.pq_lineitem "
            "WHERE shipdate >= date '1994-01-01' "
            "AND shipdate < date '1995-01-01' AND quantity < 24")
PRUNED_Q = ("SELECT count(*) FROM parquet.pq_lineitem "
            "WHERE orderkey < 1000")
ORC_Q = ("SELECT count(*), sum(quantity) FROM orc.orc_li "
         "WHERE shipdate < date '1995-01-01'")

# (id, text, sql() keywords): every read statement of the parquet tests
PARQUET_STATEMENTS = [
    ("q1_catalog_parquet", Q1, dict(catalog="parquet", max_groups=16)),
    ("q6_catalog_parquet", Q6, dict(catalog="parquet")),
    ("corpus_query", CORPUS_Q, {}),
    ("rowgroup_pruning", PRUNED_Q, {}),
    ("rowgroup_pruning_off", PRUNED_Q,
     dict(session={"scan_predicate_pushdown": False})),
    ("nulls", "SELECT x, s FROM parquet.t ORDER BY x NULLS FIRST", {}),
    ("orc_query", ORC_Q, {}),
]

Q1_COLS = ["orderkey", "quantity", "extendedprice", "discount", "tax",
           "returnflag", "linestatus", "shipdate", "shipmode"]


@pytest.fixture(scope="module")
def lake_tables(tmp_path_factory):
    """The parquet and ORC files of the reference's tests, written once
    by the reference's writers and registered in both packages."""
    if not HAVE_PYARROW:
        yield None
        return
    from presto_tpu.connectors import orc as rorc
    from presto_tpu.connectors import parquet as rpq

    from presto_tpu_torch.connectors import orc as porc
    from presto_tpu_torch.connectors import parquet as ppq
    d = tmp_path_factory.mktemp("lake")
    types = {c: rtpch.column_type("lineitem", c) for c in Q1_COLS}
    data = rtpch.generate_columns("lineitem", SF, Q1_COLS)
    files = []
    path = str(d / "lineitem.parquet")
    rpq.write_table(path, {c: data[c] for c in Q1_COLS}, types,
                    row_group_size=10_000)
    files.append(("parquet", "lineitem", path))
    few = ["orderkey", "quantity", "extendedprice", "discount", "shipdate"]
    path = str(d / "pq_lineitem.parquet")
    rpq.write_table(path, {c: data[c] for c in few},
                    {c: types[c] for c in few}, row_group_size=8192)
    files.append(("parquet", "pq_lineitem", path))
    path = str(d / "t.parquet")
    rpq.write_table(path, {"x": np.array([1, 2, 3], dtype=np.int64),
                           "s": np.array(["a", "b", "c"], dtype=object)},
                    {"x": RT.BIGINT, "s": RT.varchar(4)},
                    {"x": np.array([False, True, False]),
                     "s": np.array([True, False, False])})
    files.append(("parquet", "t", path))
    three = ["orderkey", "quantity", "shipdate"]
    path = str(d / "li.orc")
    rorc.write_table(path, {c: data[c] for c in three},
                     {c: types[c] for c in three})
    files.append(("orc", "orc_li", path))
    mods = {"parquet": (rpq, ppq), "orc": (rorc, porc)}
    for kind, table, path in files:
        for mod in mods[kind]:
            mod.register_table(table, path)
    yield mods
    for pair in mods.values():
        for mod in pair:
            mod.reset()


def _read_stats():
    from presto_tpu.connectors import parquet as rpq

    from presto_tpu_torch.connectors import parquet as ppq
    return rpq.read_stats, ppq.read_stats


def test_catalogs_register_the_file_connectors_as_the_reference():
    from presto_tpu.connectors import catalogs as ref_catalogs
    assert sorted(catalogs()) == sorted(ref_catalogs())
    assert "localfile" in catalogs() and "system" in catalogs()
    assert ("parquet" in catalogs()) == HAVE_PYARROW
    assert ("orc" in catalogs()) == HAVE_PYARROW


@pytest.mark.parametrize("table", ["lineitem", "pq_lineitem", "t"])
def test_parquet_schema_equals_the_reference(lake_tables, table):
    _needs_pyarrow()
    rpq, ppq = lake_tables["parquet"]
    assert {c: str(t) for c, t in ppq.SCHEMA[table].items()} == \
        {c: str(t) for c, t in rpq.SCHEMA[table].items()}
    assert ppq.table_row_count(table) == rpq.table_row_count(table)


def test_parquet_schema_inference(lake_tables):
    """tests/test_parquet.py::test_schema_inference through the port."""
    _needs_pyarrow()
    _, ppq = lake_tables["parquet"]
    sch = ppq.SCHEMA["lineitem"]
    assert sch["orderkey"] == PT.BIGINT
    assert sch["extendedprice"].is_decimal
    assert sch["shipdate"].base == "date"
    assert ppq.table_row_count("lineitem") == \
        rtpch.table_row_count("lineitem", SF)


def test_parquet_range_split_scans(lake_tables):
    """Row ranges read only the row groups they touch, and their columns
    equal the generator's and the reference's reads."""
    _needs_pyarrow()
    rpq, ppq = lake_tables["parquet"]
    n = ppq.table_row_count("lineitem")
    for start, count in ((0, n // 2), (n // 2, n - n // 2), (12_345, 777)):
        g = ppq.generate_columns("lineitem", SF, Q1_COLS, start, count)
        w = rpq.generate_columns("lineitem", SF, Q1_COLS, start, count)
        for c in Q1_COLS:
            assert g[c].tolist() == w[c].tolist(), c
    a = ppq.generate_columns("lineitem", SF, ["orderkey"], 0, n // 2)
    b = ppq.generate_columns("lineitem", SF, ["orderkey"], n // 2, n - n // 2)
    whole = rtpch.generate_columns("lineitem", SF, ["orderkey"])
    assert np.array_equal(np.concatenate([a["orderkey"], b["orderkey"]]),
                          whole["orderkey"])


@pytest.mark.parametrize("pred", [None, ("orderkey", 1, 100),
                                  ("orderkey", None, 30_000),
                                  ("quantity", 4900, None),
                                  ("shipdate", 9000, 9100)])
def test_row_groups_matching_equals_the_reference(lake_tables, pred):
    _needs_pyarrow()
    rpq, ppq = lake_tables["parquet"]
    assert ppq.row_groups_matching("lineitem", pred) == \
        rpq.row_groups_matching("lineitem", pred)
    if pred == ("orderkey", 1, 100):  # orderkey is monotone: it prunes
        assert len(ppq.row_groups_matching("lineitem", pred)) < \
            len(ppq.row_groups_matching("lineitem", None))


@pytest.mark.parametrize("name,text,kw", PARQUET_STATEMENTS,
                         ids=[s[0] for s in PARQUET_STATEMENTS])
def test_lake_rows_and_row_groups_equal_the_reference(lake_tables, name,
                                                      text, kw):
    _needs_pyarrow()
    ref_stats, port_stats = _read_stats()
    ref_stats.update(groups_total=0, groups_read=0)
    want = ref_sql(text, sf=SF, **kw)
    want_stats = dict(ref_stats)
    port_stats.update(groups_total=0, groups_read=0)
    got = sql(text, sf=SF, device="cpu", **kw)
    assert list(got.names) == list(want.names)
    assert exact(got) == exact(want)
    assert dict(port_stats) == want_stats
    if name == "rowgroup_pruning":
        assert want_stats["groups_read"] < want_stats["groups_total"]


@pytest.mark.parametrize("name,text,kw", PARQUET_STATEMENTS,
                         ids=[s[0] for s in PARQUET_STATEMENTS])
def test_lake_plan_equals_the_reference(lake_tables, name, text, kw):
    """The prepared plan JSON is the reference's, `pushdown` included."""
    _needs_pyarrow()
    assert_same_plan(text, SF, **kw)


def _scans(plan):
    out, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, PN.TableScanNode):
            out.append(n)
        for s in n.sources:
            walk(s)
    walk(plan)
    return out


@pytest.mark.parametrize("name,text,kw", PARQUET_STATEMENTS,
                         ids=[s[0] for s in PARQUET_STATEMENTS])
def test_pushdown_scans_get_no_narrow_lanes(lake_tables, name, text, kw):
    _needs_pyarrow()
    with pinned_clock():
        plan = port_prepared(text, SF, max_groups=kw.get("max_groups",
                                                         1 << 16),
                             catalog=kw.get("catalog"),
                             session=kw.get("session"))
    scans = [s for s in _scans(plan) if s.connector == "parquet"]
    pushed = [s for s in scans if s.pushdown is not None]
    if name in ("q1_catalog_parquet", "q6_catalog_parquet", "corpus_query",
                "rowgroup_pruning"):
        assert pushed, name
    if name == "rowgroup_pruning":
        assert pushed[0].pushdown == ("orderkey", None, 1000)
    if name == "rowgroup_pruning_off":
        assert not pushed
    for s in pushed:
        assert s.physical_dtypes is None


def test_parquet_nulls_round_trip_through_the_ports_writer(tmp_path):
    """tests/test_parquet.py::test_nulls_round_trip, written by the port
    and read by both packages."""
    _needs_pyarrow()
    from presto_tpu.connectors import parquet as rpq

    from presto_tpu_torch.connectors import parquet as ppq
    path = str(tmp_path / "t2.parquet")
    ppq.write_table(path, {"x": np.array([1, 2, 3], dtype=np.int64),
                           "s": np.array(["a", "b", "c"], dtype=object)},
                    {"x": PT.BIGINT, "s": PT.varchar(4)},
                    {"x": np.array([False, True, False]),
                     "s": np.array([True, False, False])})
    ppq.register_table("t2", path)
    rpq.register_table("t2", path)
    try:
        got = _same("SELECT x, s FROM parquet.t2 ORDER BY x NULLS FIRST")
        assert got.rows() == [(None, "b"), (1, None), (3, "c")]
    finally:
        ppq.unregister_table("t2")
        rpq.unregister_table("t2")


# ---- the writer sink: CTAS, INSERT, DELETE, UPDATE, DROP -----------------

# name -> (catalog, table, statements); each runs in order
WRITE_SEQUENCES = {
    "parquet_ctas_insert": ("parquet", "ct", [
        "CREATE TABLE parquet.ct AS SELECT nationkey, name FROM nation "
        "WHERE nationkey < 5",
        "SELECT count(*) FROM parquet.ct",
        "INSERT INTO parquet.ct SELECT nationkey, name FROM nation "
        "WHERE nationkey >= 5 AND nationkey < 8",
        "SELECT count(*) FROM parquet.ct",
        "SELECT nationkey, name FROM parquet.ct ORDER BY nationkey",
        "DROP TABLE parquet.ct"]),
    "parquet_delete_update": ("parquet", "du", [
        "CREATE TABLE parquet.du AS SELECT nationkey, regionkey FROM nation",
        "DELETE FROM parquet.du WHERE regionkey = 0",
        "SELECT count(*) FROM parquet.du",
        "UPDATE parquet.du SET regionkey = 99 WHERE nationkey < 5",
        "SELECT count(*) FROM parquet.du WHERE regionkey = 99",
        "SELECT nationkey, regionkey FROM parquet.du ORDER BY nationkey",
        "DROP TABLE parquet.du"]),
    "orc_ctas_insert_delete": ("orc", "t", [
        "CREATE TABLE orc.t AS SELECT nationkey, regionkey FROM nation",
        "SELECT count(*) FROM orc.t",
        "INSERT INTO orc.t SELECT nationkey + 100, regionkey FROM nation "
        "WHERE nationkey < 3",
        "SELECT count(*) FROM orc.t",
        "DELETE FROM orc.t WHERE nationkey >= 100",
        "SELECT count(*) FROM orc.t",
        "UPDATE orc.t SET regionkey = 7 WHERE nationkey < 4",
        "SELECT nationkey, regionkey FROM orc.t ORDER BY nationkey",
        "DROP TABLE orc.t"]),
    "parquet_lineitem_ctas_q1": ("parquet", "li_q1", [
        "CREATE TABLE parquet.li_q1 AS SELECT returnflag, linestatus, "
        "quantity, extendedprice, discount, tax, shipdate FROM lineitem",
        "SELECT returnflag, linestatus, sum(quantity), "
        "sum(extendedprice * (1 - discount) * (1 + tax)), count(*) "
        "FROM parquet.li_q1 WHERE shipdate <= date '1998-09-02' "
        "GROUP BY returnflag, linestatus ORDER BY returnflag, linestatus",
        "DROP TABLE parquet.li_q1"]),
}


@pytest.mark.parametrize("seq", sorted(WRITE_SEQUENCES))
def test_lake_writes_equal_the_reference(tmp_path, seq):
    """Each statement through both packages, each writing into its own
    warehouse: the same prepared plan, the same counts and rows after
    every step, the same files, the data version advanced by every
    commit, and DROP removes the table from both."""
    _needs_pyarrow()
    from presto_tpu.connectors import orc as rorc
    from presto_tpu.connectors import parquet as rpq

    from presto_tpu_torch.connectors import orc as porc
    from presto_tpu_torch.connectors import parquet as ppq
    kind, table, statements = WRITE_SEQUENCES[seq]
    rmod, pmod = {"parquet": (rpq, ppq), "orc": (rorc, porc)}[kind]
    for side, mod in (("ref", rmod), ("port", pmod)):
        (tmp_path / side).mkdir()
        mod.set_warehouse(str(tmp_path / side))
    try:
        version = None
        for text in statements:
            assert_same_plan(text, SF)
            want, got = _both(text)
            assert exact(got) == exact(want), text
            if text.startswith("DROP"):
                assert table not in pmod.SCHEMA
                assert table not in rmod.SCHEMA
            elif not text.startswith("SELECT"):
                assert pmod.data_version(table) != version
                version = pmod.data_version(table)
            assert sorted(os.listdir(tmp_path / "port")) == \
                sorted(os.listdir(tmp_path / "ref"))
    finally:
        for mod in (rmod, pmod):
            mod.set_warehouse(None)
            mod.reset()


def test_lake_ctas_rows_are_the_reference_tests_answers(tmp_path):
    """tests/test_parquet_first_class.py's expected counts, from the
    port alone."""
    _needs_pyarrow()
    from presto_tpu_torch.connectors import orc as porc
    from presto_tpu_torch.connectors import parquet as ppq

    def port(text):
        return sql(text, sf=SF, device="cpu").rows()
    ppq.set_warehouse(str(tmp_path))
    porc.set_warehouse(str(tmp_path))
    try:
        port("CREATE TABLE parquet.ct AS SELECT nationkey, name FROM nation "
             "WHERE nationkey < 5")
        assert port("SELECT count(*) FROM parquet.ct") == [(5,)]
        port("CREATE TABLE orc.t AS SELECT nationkey, regionkey FROM nation")
        port("INSERT INTO orc.t SELECT nationkey + 100, regionkey "
             "FROM nation WHERE nationkey < 3")
        assert port("SELECT count(*) FROM orc.t") == [(28,)]
        port("DELETE FROM orc.t WHERE nationkey >= 100")
        assert port("SELECT count(*) FROM orc.t") == [(25,)]
    finally:
        for mod in (ppq, porc):
            mod.set_warehouse(None)
            mod.reset()


def test_a_ctas_that_fails_creates_no_table(tmp_path):
    """A CTAS whose SELECT does not plan leaves no table behind, as in
    the reference."""
    _needs_pyarrow()
    from presto_tpu_torch.connectors import parquet as ppq
    ppq.set_warehouse(str(tmp_path))
    try:
        with pytest.raises(KeyError):
            sql("CREATE TABLE parquet.bad AS SELECT nope FROM nation",
                sf=SF, device="cpu")
        assert "bad" not in ppq.SCHEMA
    finally:
        ppq.set_warehouse(None)
        ppq.reset()


@pytest.mark.parametrize("with_nulls", [False, True])
def test_engine_to_arrow_equals_the_reference(with_nulls):
    """The sinks' conversion gives the reference's arrow table: every
    type the engine writes, with and without NULLs."""
    _needs_pyarrow()
    from presto_tpu.connectors.parquet import engine_to_arrow as ref_e2a

    from presto_tpu_torch.connectors.parquet import engine_to_arrow
    rng = np.random.default_rng(7)
    n = 64
    cols = {
        "d": ("decimal(12,2)", rng.integers(-10**9, 10**9, n)),
        "o": ("decimal(12,2)", np.array(
            [int(x) for x in rng.integers(-10**9, 10**9, n)], dtype=object)),
        "l": ("decimal(30,3)", np.array(
            [int(x) * 10**15 for x in rng.integers(-10**9, 10**9, n)],
            dtype=object)),
        "dt": ("date", rng.integers(0, 20000, n).astype(np.int32)),
        "ts": ("timestamp", rng.integers(0, 10**15, n)),
        "s": ("varchar(5)", np.array(["a", "bb"] * (n // 2), dtype=object)),
        "i": ("integer", rng.integers(-100, 100, n).astype(np.int32)),
        "b": ("bigint", rng.integers(-100, 100, n)),
        "f": ("double", rng.random(n)),
        "bo": ("boolean", rng.random(n) < 0.5)}
    nulls = {c: rng.random(n) < 0.3 for c in cols} if with_nulls else None
    got = engine_to_arrow({c: v for c, (_, v) in cols.items()},
                          {c: PT.parse_type(t) for c, (t, _) in cols.items()},
                          nulls)
    want = ref_e2a({c: v for c, (_, v) in cols.items()},
                   {c: RT.parse_type(t) for c, (t, _) in cols.items()},
                   nulls)
    assert got.schema == want.schema
    assert got.equals(want)
