"""Session property manager: rule-based defaults per user and source.

Counterpart of presto_tpu/server/session_properties.py (the
SessionPropertyConfigurationManager SPI and its file-based plugin).
Rules matched on user, source and client tags give session-property
defaults at query start; a value the client sets always wins. Matching
rules merge in order, a later one overriding an earlier one's
defaults:

    set_session_property_manager(SessionPropertyManager([
        {"user": "etl_.*", "properties": {"query_max_memory": "24GB"}},
        {"source": "dashboard", "properties": {"sf": "0.01"}},
    ]))
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

__all__ = ["SessionPropertyManager", "set_session_property_manager",
           "get_session_property_manager"]


class SessionPropertyManager:
    def __init__(self, rules: Optional[List[Dict]] = None):
        self.rules = [{
            "user": re.compile(r.get("user", ".*") + r"\Z"),
            "source": re.compile(r.get("source", ".*") + r"\Z"),
            "clientTags": set(r.get("clientTags", [])),
            "properties": dict(r.get("properties", {})),
        } for r in rules or []]

    def defaults_for(self, user: str, source: str = "",
                     client_tags: Optional[List[str]] = None) -> Dict:
        out: Dict = {}
        tags = set(client_tags or [])
        for r in self.rules:
            if not r["user"].match(user or ""):
                continue
            if not r["source"].match(source or ""):
                continue
            if r["clientTags"] and not r["clientTags"] <= tags:
                continue
            out.update(r["properties"])
        return out


_lock = threading.Lock()
_manager: Optional[SessionPropertyManager] = None


def set_session_property_manager(mgr) -> None:
    """Install the process-wide manager (rules or a manager; None
    removes it)."""
    global _manager
    with _lock:
        if mgr is None or isinstance(mgr, SessionPropertyManager):
            _manager = mgr
        else:
            _manager = SessionPropertyManager(mgr)


def get_session_property_manager() -> Optional[SessionPropertyManager]:
    return _manager
