"""Time-zone keys and TIMESTAMP WITH TIME ZONE packing.

The port's own copy of presto_tpu/tz.py, trimmed to what the functions
use (the reference's zone_name and unpack_key format keys for display,
which the port does not do). A `timestamp with time zone`
lane is one int64: (UTC micros << 12) | zone key, the reference's
packing of Presto's TimestampWithTimeZoneType adapted to micros.

Zone keys: 2048 is UTC, 2048 + m a fixed offset of m minutes
(-2047..2047). Named region zones resolve through a small alias table
to their STANDARD offset, with no daylight saving time: the
reference's documented difference from Presto, kept exactly.

The packed lane is a signed int64, so `>> 12` of a pre-epoch value is
an arithmetic shift (torch's `>>` on int64 is arithmetic), and the key
is `& 4095`.
"""

from __future__ import annotations

import re

import torch

__all__ = ["UTC_KEY", "MICROS_PER_MINUTE", "KEY_MASK", "zone_key", "pack",
           "unpack_micros", "local_micros"]

UTC_KEY = 2048
MICROS_PER_MINUTE = 60_000_000
KEY_MASK = 0xFFF

# named zones -> standard offset minutes
_NAMED = {
    "utc": 0, "z": 0, "gmt": 0, "greenwich": 0, "universal": 0,
    "america/new_york": -5 * 60, "america/chicago": -6 * 60,
    "america/denver": -7 * 60, "america/los_angeles": -8 * 60,
    "europe/london": 0, "europe/paris": 60, "europe/berlin": 60,
    "europe/moscow": 3 * 60, "asia/kolkata": 5 * 60 + 30,
    "asia/shanghai": 8 * 60, "asia/tokyo": 9 * 60,
    "australia/sydney": 10 * 60, "pacific/auckland": 12 * 60,
}

_OFFSET = re.compile(r"^(?:utc|gmt)?([+-])(\d{1,2})(?::?(\d{2}))?$")


def zone_key(name: str) -> int:
    """Zone spelling -> key. Raises ValueError on unknown zones."""
    s = name.strip().lower()
    m = _OFFSET.match(s)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        minutes = sign * (int(m.group(2)) * 60 + int(m.group(3) or 0))
        if not -2047 <= minutes <= 2047:
            raise ValueError(f"zone offset out of range: {name!r}")
        return UTC_KEY + minutes
    if s in _NAMED:
        return UTC_KEY + _NAMED[s]
    raise ValueError(f"unknown time zone: {name!r}")


def pack(utc_micros: torch.Tensor, key: int) -> torch.Tensor:
    """(instant, zone) -> packed int64 lane."""
    return (utc_micros.to(torch.int64) << 12) | key


def unpack_micros(packed: torch.Tensor) -> torch.Tensor:
    """Packed lane -> UTC micros (arithmetic shift: pre-epoch instants
    stay negative)."""
    return packed.to(torch.int64) >> 12


def local_micros(packed: torch.Tensor) -> torch.Tensor:
    """Wall-clock micros in the value's own zone (what field extraction,
    date_format and date_trunc operate on)."""
    p = packed.to(torch.int64)
    offset = ((p & KEY_MASK) - UTC_KEY) * MICROS_PER_MINUTE
    return (p >> 12) + offset
