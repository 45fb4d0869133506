"""The port's date, timestamp, zoned-timestamp and interval functions
against the reference's, expression by expression (the inputs and the
comparison of tests/_torch_functions_common.py: exact), with the
calls that `evaluate` dispatches by name (date_format, date_add,
date_trunc, date_diff, at_timezone) and the port's copy of tz.py."""

import numpy as np
import pytest
import torch

from _torch_functions_common import (DAY_US, ZONES, batches, call, check,
                                     const, port_expr, ref, ty)

import presto_tpu.tz as RTZ
from presto_tpu.expr import compile as RC
from presto_tpu_torch import block as PB
from presto_tpu_torch import tz as PTZ
from presto_tpu_torch.expr import compile as PC
from presto_tpu_torch.ops import sort as PS

BIG, DATE, TS = ty("bigint"), ty("date"), ty("timestamp")
TZT = ty("timestamp with time zone")
DS, YM = ty("interval day to second"), ty("interval year to month")

FIELDS = {}
for _f in ("year", "month", "day", "day_of_month", "quarter", "day_of_week",
           "dow", "day_of_year", "doy"):
    FIELDS[f"{_f}_date"] = call(_f, BIG, ref("date"))
    FIELDS[f"{_f}_timestamp"] = call(_f, BIG, ref("ts"))
FIELDS["last_day_of_month_date"] = call("last_day_of_month", DATE,
                                        ref("date"))
FIELDS["last_day_of_month_timestamp"] = call("last_day_of_month", DATE,
                                             ref("ts"))
for _f in ("hour", "minute", "second", "millisecond"):
    for _k in ("ts", "tz", "time", "date"):
        FIELDS[f"{_f}_{_k}"] = call(_f, BIG, ref(_k))
FIELDS["timezone_hour"] = call("timezone_hour", BIG, ref("tz"))
FIELDS["timezone_minute"] = call("timezone_minute", BIG, ref("tz"))
FIELDS["from_unixtime"] = call("from_unixtime", TS, ref("dbl"))
FIELDS["from_unixtime_bigint"] = call("from_unixtime", TS, ref("small"))
FIELDS["to_unixtime"] = call("to_unixtime", ty("double"), ref("ts"))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fields_match_reference(name):
    if name == "from_unixtime":
        # a second count whose micros leave int64 (NaN, infinities,
        # 1e300) has no defined integer in either package: those lanes
        # are not compared
        rb, pb = batches()
        r = RC.evaluate(FIELDS[name], rb)
        p = PC.evaluate(port_expr(FIELDS[name]), pb)
        secs, nulls = PB.to_numpy(pb.column(2))
        keep = ~nulls & (np.abs(np.nan_to_num(secs, nan=1e300)) < 9e12)
        assert p.nulls.numpy().tolist() == np.asarray(r.nulls).tolist()
        assert p.values.numpy()[keep].tolist() == \
            np.asarray(r.values)[keep].tolist()
        return
    check(FIELDS[name])


CALLS = {}
for _fmt in ("%Y-%m-%d", "%d/%m/%y (%j)", "%H:%i:%s", "%Y%m%d %% x",
             "plain"):
    CALLS[f"date_format_date[{_fmt}]"] = call(
        "date_format", ty("varchar(32)"), ref("date"),
        const(_fmt, ty("varchar")))
    CALLS[f"date_format_timestamp[{_fmt}]"] = call(
        "date_format", ty("varchar(32)"), ref("ts"),
        const(_fmt, ty("varchar")))
for _u in ("day", "week", "month", "quarter", "year"):
    CALLS[f"date_trunc_date[{_u}]"] = call(
        "date_trunc", DATE, const(_u, ty("varchar")), ref("date"))
    CALLS[f"date_diff_date[{_u}]"] = call(
        "date_diff", BIG, const(_u, ty("varchar")), ref("date"),
        const(10957, DATE))
for _u in ("second", "minute", "hour", "day", "week", "month", "quarter",
           "year"):
    CALLS[f"date_trunc_timestamp[{_u}]"] = call(
        "date_trunc", TS, const(_u, ty("varchar")), ref("ts"))
for _u in ("millisecond", "second", "minute", "hour", "day", "week",
           "month", "quarter", "year"):
    CALLS[f"date_diff_timestamp[{_u}]"] = call(
        "date_diff", BIG, const(_u, ty("varchar")), ref("ts"),
        const(951782400123456, TS))
    CALLS[f"date_diff_date_timestamp[{_u}]"] = call(
        "date_diff", BIG, const(_u, ty("varchar")), ref("date"), ref("ts"))
for _u in ("day", "week", "month", "year"):
    CALLS[f"date_add[{_u}]"] = call("date_add", DATE,
                                    const(_u, ty("varchar")), ref("small"),
                                    ref("date"))
for _z in ("UTC", "+05:30", "-08:00", "America/New_York", "asia/kolkata",
           "GMT-03", "+0545"):
    CALLS[f"at_timezone_timestamp[{_z}]"] = call(
        "at_timezone", TZT, ref("ts"), const(_z, ty("varchar")))
    CALLS[f"at_timezone_tz[{_z}]"] = call(
        "at_timezone", TZT, ref("tz"), const(_z, ty("varchar")))


@pytest.mark.parametrize("name", sorted(CALLS))
def test_dispatched_calls_match_reference(name):
    check(CALLS[name])


INTERVALS = {
    "date_plus_days": call("datetime_interval_add", DATE, ref("date"),
                           const(3 * DAY_US, DS)),
    "date_minus_days": call("datetime_interval_add", DATE, ref("date"),
                            call("negate", DS, const(90 * DAY_US, DS))),
    "timestamp_plus_ds": call("datetime_interval_add", TS, ref("ts"),
                              ref("ds")),
    "tz_plus_ds": call("datetime_interval_add", TZT, ref("tz"), ref("ds")),
    "time_plus_ds": call("datetime_interval_add", ty("time"), ref("time"),
                         ref("ds")),
    "date_plus_ym": call("datetime_interval_add", DATE, ref("date"),
                         ref("ym")),
    "timestamp_plus_ym": call("datetime_interval_add", TS, ref("ts"),
                              ref("ym")),
    "tz_plus_ym": call("datetime_interval_add", TZT, ref("tz"), ref("ym")),
    "diff_timestamps": call("datetime_diff_micros", DS, ref("ts"),
                            const(0, TS)),
    "diff_tz": call("datetime_diff_micros", DS, ref("tz"),
                    call("at_timezone", TZT, ref("ts"),
                         const("+02:00", ty("varchar")))),
    "diff_dates": call("datetime_diff_micros", DS, ref("date"),
                       const(10957, DATE)),
}


@pytest.mark.parametrize("name", sorted(INTERVALS))
def test_interval_arithmetic_matches_reference(name):
    check(INTERVALS[name])


CASTS = [("date", "timestamp"), ("tz", "timestamp"), ("tz", "date"),
         ("tz", "time"), ("ts", "timestamp with time zone"),
         ("date", "timestamp with time zone"), ("ts", "time"),
         ("ts", "date"), ("ts", "bigint"), ("time", "bigint"),
         ("date", "bigint"), ("tz", "bigint")]


@pytest.mark.parametrize("kind,to", CASTS, ids=[f"{k}-{t}" for k, t in CASTS])
def test_datetime_casts_match_reference(kind, to):
    check(call("cast", ty(to), ref(kind)))


CMP = {}
for _op in ("eq", "lt", "ge"):
    CMP[f"{_op}_tz_tz"] = call(_op, ty("boolean"), ref("tz"),
                               call("at_timezone", TZT, ref("ts"),
                                    const("-05:00", ty("varchar"))))
    CMP[f"{_op}_date_timestamp"] = call(_op, ty("boolean"), ref("date"),
                                        ref("ts"))
    CMP[f"{_op}_tz_timestamp"] = call(_op, ty("boolean"), ref("tz"),
                                      ref("ts"))
    CMP[f"{_op}_timestamps"] = call(_op, ty("boolean"), ref("ts"),
                                    const(0, TS))
    CMP[f"{_op}_times"] = call(_op, ty("boolean"), ref("time"),
                               const(DAY_US // 2, ty("time")))


@pytest.mark.parametrize("name", sorted(CMP))
def test_datetime_comparisons_match_reference(name):
    check(CMP[name])


@pytest.mark.parametrize("call_,arg", [
    ("date_trunc", 0), ("date_diff", 0), ("date_add", 0),
    ("date_format", 1), ("at_timezone", 1)])
def test_a_unit_or_format_that_is_not_a_constant_is_refused(call_, arg):
    """The reference asserts a constant there; the port refuses the
    same expressions."""
    args = {"date_trunc": [const("day", ty("varchar")), ref("date")],
            "date_diff": [const("day", ty("varchar")), ref("date"),
                          ref("date")],
            "date_add": [const("day", ty("varchar")), ref("small"),
                         ref("date")],
            "date_format": [ref("date"), const("%Y", ty("varchar"))],
            "at_timezone": [ref("ts"), const("UTC", ty("varchar"))]}[call_]
    args[arg] = ref("words")
    ret = {"date_diff": BIG, "date_format": ty("varchar(4)"),
           "at_timezone": TZT}.get(call_, DATE)
    expr = call(call_, ret, *args)
    rb, pb = batches()
    with pytest.raises(AssertionError):
        RC.evaluate(expr, rb)
    with pytest.raises(NotImplementedError, match="constant"):
        PC.evaluate(port_expr(expr), pb)


@pytest.mark.parametrize("call_,unit", [("date_trunc", "minute"),
                                        ("date_trunc", "decade"),
                                        ("date_diff", "decade"),
                                        ("date_add", "hour"),
                                        ("date_format", "%e")])
def test_units_and_specifiers_the_reference_refuses_are_refused(call_, unit):
    args = {"date_trunc": [const(unit, ty("varchar")), ref("date")],
            "date_diff": [const(unit, ty("varchar")), ref("date"),
                          ref("date")],
            "date_add": [const(unit, ty("varchar")), ref("small"),
                         ref("date")],
            "date_format": [ref("date"), const(unit, ty("varchar"))]}[call_]
    ret = {"date_diff": BIG, "date_format": ty("varchar(4)")}.get(call_,
                                                                  DATE)
    expr = call(call_, ret, *args)
    rb, pb = batches()
    with pytest.raises(NotImplementedError):
        RC.evaluate(expr, rb)
    with pytest.raises(NotImplementedError):
        PC.evaluate(port_expr(expr), pb)


@pytest.mark.parametrize("name", ["UTC", "z", "GMT", "+05:30", "-0800",
                                  "utc+3", "GMT-11:30", "America/Chicago",
                                  "Europe/Paris", "Asia/Kolkata",
                                  "Pacific/Auckland", " universal "])
def test_zone_keys_match_reference(name):
    assert PTZ.zone_key(name) == RTZ.zone_key(name)


@pytest.mark.parametrize("name", ["Mars/Olympus", "+40", "+99:00", ""])
def test_unknown_zones_raise_like_the_reference(name):
    with pytest.raises(ValueError):
        RTZ.zone_key(name)
    with pytest.raises(ValueError):
        PTZ.zone_key(name)


def test_zoned_packing_matches_reference():
    """(micros << 12) | key: the shift back is arithmetic for pre-epoch
    instants, the key is & 4095, and the wall clock adds the offset."""
    import jax.numpy as jnp
    us = np.array([0, -1, -DAY_US - 7, 10 ** 15, -(10 ** 15), 123456789],
                  np.int64)
    for key in ZONES + [1, 4095]:
        rp = np.asarray(RTZ.pack(jnp.asarray(us), key))
        pp = PTZ.pack(torch.from_numpy(us), key)
        assert pp.tolist() == rp.tolist()
        assert PTZ.unpack_micros(pp).tolist() == us.tolist()
        assert (pp & PTZ.KEY_MASK).tolist() == \
            np.asarray(RTZ.unpack_key(jnp.asarray(rp))).tolist()
        assert PTZ.local_micros(pp).tolist() == \
            np.asarray(RTZ.local_micros(jnp.asarray(rp))).tolist()


def test_zoned_keys_order_and_group_by_the_instant():
    """The same instant in two zones is one key: the key words read the
    instant (ops/keys.py), so sorting orders instants."""
    us = np.array([5, -3, 5, 0, -3], np.int64) * 1_000_000
    keys = np.array([2048, 2048 + 60, 2048 - 300, 2048, 2048], np.int64)
    col = PB.from_numpy(TZT, (us << 12) | keys, device="cpu")
    batch = PB.Batch((col,), torch.ones(5, dtype=torch.bool))
    out = PS.sort_batch(batch, [(0, False, True)])
    got = PTZ.unpack_micros(out.column(0).values).tolist()
    assert got == sorted(us.tolist())
