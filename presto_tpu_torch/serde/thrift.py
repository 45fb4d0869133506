"""Thrift binary protocol for the TaskStatus poll.

Counterpart of presto_tpu/serde/thrift.py (the reference's optional
thrift transport for TaskStatus: ThriftTaskClient.java and the native
worker's presto_thrift.thrift). The standard TBinaryProtocol wire
format for a declared field schema: flat structs of BOOL, I32, I64,
DOUBLE, STRING and LIST<STRING>, what TaskStatus needs; unknown
incoming fields are skipped by their wire type (thrift's forward
compatibility). The worker answers `GET /v1/task/{id}/status` with
these bytes when the request says `Accept: application/x-thrift`; they
equal the reference's for the same status document.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

__all__ = ["encode_struct", "decode_struct", "TASK_STATUS_SCHEMA",
           "encode_task_status", "decode_task_status"]

# thrift type ids (TBinaryProtocol)
T_STOP, T_BOOL, T_I32, T_I64 = 0, 2, 8, 10
T_DOUBLE, T_STRING, T_LIST = 4, 11, 15

# field schema: name -> (field_id, ttype)
TASK_STATUS_SCHEMA: Dict[str, Tuple[int, int]] = {
    "taskId": (1, T_STRING),
    "state": (2, T_STRING),
    "self": (3, T_STRING),
    "version": (4, T_I64),
    "memoryReservationInBytes": (5, T_I64),
    "outputBufferUtilization": (6, T_DOUBLE),
    "outputBufferOverutilized": (7, T_BOOL),
    "runningPartitionedDrivers": (8, T_I32),
    "queuedPartitionedDrivers": (9, T_I32),
    "failureMessages": (10, T_LIST),
    "taskAgeInMillis": (11, T_I64),
}


def _enc_value(ttype: int, v, out: List[bytes]) -> None:
    if ttype == T_BOOL:
        out.append(struct.pack("!b", 1 if v else 0))
    elif ttype == T_I32:
        out.append(struct.pack("!i", int(v)))
    elif ttype == T_I64:
        out.append(struct.pack("!q", int(v)))
    elif ttype == T_DOUBLE:
        out.append(struct.pack("!d", float(v)))
    elif ttype == T_STRING:
        b = str(v).encode("utf-8")
        out.append(struct.pack("!i", len(b)))
        out.append(b)
    elif ttype == T_LIST:  # list<string>
        items = list(v or [])
        out.append(struct.pack("!bi", T_STRING, len(items)))
        for it in items:
            _enc_value(T_STRING, it, out)
    else:
        raise ValueError(f"unsupported thrift type {ttype}")


def encode_struct(doc: dict, schema: Dict[str, Tuple[int, int]]) -> bytes:
    """dict -> TBinaryProtocol struct bytes (fields in id order;
    absent/None fields are omitted, thrift optional semantics)."""
    out: List[bytes] = []
    for name, (fid, ttype) in sorted(schema.items(), key=lambda kv: kv[1]):
        v = doc.get(name)
        if v is None:
            continue
        out.append(struct.pack("!bh", ttype, fid))
        _enc_value(ttype, v, out)
    out.append(struct.pack("!b", T_STOP))
    return b"".join(out)


def _dec_value(ttype: int, buf: memoryview, pos: int):
    if ttype == T_BOOL:
        return bool(buf[pos]), pos + 1
    if ttype == T_I32:
        return struct.unpack_from("!i", buf, pos)[0], pos + 4
    if ttype == T_I64:
        return struct.unpack_from("!q", buf, pos)[0], pos + 8
    if ttype == T_DOUBLE:
        return struct.unpack_from("!d", buf, pos)[0], pos + 8
    if ttype == T_STRING:
        n = struct.unpack_from("!i", buf, pos)[0]
        pos += 4
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if ttype == T_LIST:
        et, n = struct.unpack_from("!bi", buf, pos)
        pos += 5
        items = []
        for _ in range(n):
            v, pos = _dec_value(et, buf, pos)
            items.append(v)
        return items, pos
    raise ValueError(f"unsupported thrift type {ttype}")


def _skip(ttype: int, buf: memoryview, pos: int) -> int:
    """Advance past a value of ANY thrift wire type (the standard
    forward-compatibility skip, covering types this build never emits:
    struct=12, map=13, set=14, byte=3, i16=6)."""
    if ttype == T_BOOL or ttype == 3:
        return pos + 1
    if ttype == 6:
        return pos + 2
    if ttype == T_I32:
        return pos + 4
    if ttype in (T_I64, T_DOUBLE):
        return pos + 8
    if ttype == T_STRING:
        n = struct.unpack_from("!i", buf, pos)[0]
        return pos + 4 + n
    if ttype in (T_LIST, 14):  # list / set
        et, n = struct.unpack_from("!bi", buf, pos)
        pos += 5
        for _ in range(n):
            pos = _skip(et, buf, pos)
        return pos
    if ttype == 13:  # map
        kt, vt, n = struct.unpack_from("!bbi", buf, pos)
        pos += 6
        for _ in range(n):
            pos = _skip(kt, buf, pos)
            pos = _skip(vt, buf, pos)
        return pos
    if ttype == 12:  # struct
        while True:
            ft = struct.unpack_from("!b", buf, pos)[0]
            pos += 1
            if ft == T_STOP:
                return pos
            pos += 2  # field id
            pos = _skip(ft, buf, pos)
    raise ValueError(f"cannot skip thrift type {ttype}")


def decode_struct(data: bytes, schema: Dict[str, Tuple[int, int]]) -> dict:
    """TBinaryProtocol struct bytes -> dict; unknown field ids (and
    fields of types this build does not decode) skip by wire type, the
    standard thrift forward compatibility."""
    by_id = {fid: (name, ttype) for name, (fid, ttype) in schema.items()}
    buf = memoryview(data)
    pos = 0
    out: dict = {}
    while True:
        ttype = struct.unpack_from("!b", buf, pos)[0]
        pos += 1
        if ttype == T_STOP:
            break
        fid = struct.unpack_from("!h", buf, pos)[0]
        pos += 2
        hit = by_id.get(fid)
        if hit is not None and hit[1] == ttype:
            v, pos = _dec_value(ttype, buf, pos)
            out[hit[0]] = v
        else:
            pos = _skip(ttype, buf, pos)
    return out


def encode_task_status(doc: dict, task_id: str = "") -> bytes:
    """The worker's JSON TaskStatus document -> thrift bytes."""
    flat = dict(doc)
    flat.setdefault("taskId", task_id)
    flat["failureMessages"] = [f.get("message", "")
                               for f in doc.get("failures", [])]
    return encode_struct(flat, TASK_STATUS_SCHEMA)


def decode_task_status(data: bytes) -> dict:
    out = decode_struct(data, TASK_STATUS_SCHEMA)
    out["failures"] = [{"message": m, "type": "USER_ERROR"}
                      for m in out.pop("failureMessages", [])]
    return out
