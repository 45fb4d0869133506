"""Session property readers: the port's copy of `session_flag` and
`session_value` from presto_tpu/utils/config.py.

A session is a plain dict (or any object with `.get`). Boolean
properties are parsed with the reference registry's coercion, not by
truthiness, so the string "false" turns a flag off.
"""

from __future__ import annotations

__all__ = ["session_flag", "session_value"]


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "on")


def session_flag(session, name: str, default: bool = True) -> bool:
    """A boolean session property: `default` where the session is None
    or does not set it; otherwise its value under the registry's bool
    coercion."""
    if session is None:
        return default
    try:
        v = session.get(name)
    except (KeyError, TypeError):
        return default
    if v is None:
        return default
    return v if isinstance(v, bool) else _parse_bool(v)


def session_value(session, name: str, default=None):
    """A session property as given, `default` where it is absent."""
    if session is None:
        return default
    try:
        v = session.get(name)
    except (KeyError, TypeError):
        return default
    return default if v is None else v
