"""Access control: who may read or write which catalog, table, column.

Counterpart of presto_tpu/server/access.py (presto-main-base's
AccessControlManager with the file-based system access control). The
check runs on the plan: `run_query` walks its scans and write targets
before anything is staged, the boundary at which the reference's
analyzer checks.

Rules are tried top down and the first that matches user, catalog and
table decides (the rules file's semantics); with no rules everything is
allowed, with rules and no match it is denied. A rule:

    {"user": "bob|analyst_.*",       # regex, default ".*"
     "catalog": "tpch",              # regex, default ".*"
     "table": "lineitem|orders",     # regex, default ".*"
     "columns": ["comment"],         # optional: only these columns
     "privileges": ["SELECT"]}       # of SELECT, INSERT, DELETE,
                                     # UPDATE, CREATE, DROP; [] = deny

The manager is process-wide (`set_access_control`), so that `sql()`,
the statement server and the worker enforce one policy.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

__all__ = ["AccessDeniedException", "AccessControlManager",
           "set_access_control", "get_access_control"]

_PRIVILEGES = ("SELECT", "INSERT", "DELETE", "UPDATE", "CREATE", "DROP")


class AccessDeniedException(PermissionError):
    """The reference's ACCESS_DENIED error."""


class AccessControlManager:
    def __init__(self, rules: Optional[List[Dict]] = None):
        self.rules = [{
            "user": re.compile(r.get("user", ".*") + r"\Z"),
            "catalog": re.compile(r.get("catalog", ".*") + r"\Z"),
            "table": re.compile(r.get("table", ".*") + r"\Z"),
            "columns": r.get("columns"),
            "privileges": {p.upper() for p in r.get("privileges", [])},
        } for r in rules or []]

    def _allowed(self, user: str, catalog: str, table: str,
                 privilege: str, column: Optional[str] = None) -> bool:
        if not self.rules:
            return True
        for r in self.rules:
            if not r["user"].match(user or ""):
                continue
            if not r["catalog"].match(catalog):
                continue
            if not r["table"].match(table):
                continue
            # the first (user, catalog, table) match decides; its column
            # list restricts within it and does not fall through
            if privilege not in r["privileges"]:
                return False
            if column is not None and r["columns"] is not None:
                return column in r["columns"]
            return True
        return False

    def _check(self, user, catalog, table, privilege, columns=()):
        if not self._allowed(user, catalog, table, privilege):
            raise AccessDeniedException(
                f"Access Denied: Cannot {privilege.lower()} "
                f"{catalog}.{table} (user {user!r})")
        for c in columns or ():
            if not self._allowed(user, catalog, table, privilege, c):
                raise AccessDeniedException(
                    f"Access Denied: Cannot {privilege.lower()} column "
                    f"{c!r} of {catalog}.{table} (user {user!r})")

    # -- the checks, by the AccessControl SPI's names ----------------------

    def check_can_select_from_columns(self, user, catalog, table, columns):
        self._check(user, catalog, table, "SELECT", columns)

    def check_can_insert_into_table(self, user, catalog, table):
        self._check(user, catalog, table, "INSERT")

    def check_can_delete_from_table(self, user, catalog, table):
        self._check(user, catalog, table, "DELETE")

    def check_can_update_table(self, user, catalog, table):
        self._check(user, catalog, table, "UPDATE")

    def check_can_create_table(self, user, catalog, table):
        self._check(user, catalog, table, "CREATE")

    def check_can_drop_table(self, user, catalog, table):
        self._check(user, catalog, table, "DROP")

    def check_plan(self, root, user: str) -> None:
        """Every TableScanNode must pass SELECT on its columns and every
        write node its write check."""
        from ..plan import nodes as N
        seen = set()

        def walk(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            if isinstance(n, N.TableScanNode):
                self.check_can_select_from_columns(
                    user, n.connector, n.table, n.columns)
            elif isinstance(n, N.TableFinishNode):
                if n.create:
                    self.check_can_create_table(user, n.connector, n.table)
                else:
                    self.check_can_insert_into_table(user, n.connector,
                                                     n.table)
            elif isinstance(n, N.TableRewriteNode):
                if n.kind == "delete":
                    self.check_can_delete_from_table(user, n.connector,
                                                     n.table)
                else:
                    self.check_can_update_table(user, n.connector, n.table)
            elif isinstance(n, N.DdlNode) and n.op == "drop_table":
                self.check_can_drop_table(user, n.connector, n.table)
            for s in n.sources:
                walk(s)

        walk(root)


_lock = threading.Lock()
_manager: Optional[AccessControlManager] = None


def set_access_control(rules_or_manager) -> None:
    """Install the process-wide policy (None removes it: allow all)."""
    global _manager
    with _lock:
        if rules_or_manager is None or \
                isinstance(rules_or_manager, AccessControlManager):
            _manager = rules_or_manager
        else:
            _manager = AccessControlManager(rules_or_manager)


def get_access_control() -> Optional[AccessControlManager]:
    return _manager
