"""A live `SCHEMA` view over a registry of file-backed tables.

The localfile, parquet and ORC connectors keep their registered tables
in a dict of entries under a lock, each entry with its "schema"
({column: Type}). `RegistrySchema` shows that dict as the mapping
table -> {column: Type} that the planner and information_schema read,
as each of the reference's file connectors does with a class of its
own.
"""

from __future__ import annotations

__all__ = ["RegistrySchema"]


class RegistrySchema(dict):
    """table -> {column: Type} over `tables` (read under `lock`)."""

    def __init__(self, tables: dict, lock):
        super().__init__()
        self._tables = tables
        self._lock = lock

    def __getitem__(self, table):
        with self._lock:
            return dict(self._tables[table]["schema"])

    def __contains__(self, table):
        with self._lock:
            return table in self._tables

    def __iter__(self):
        with self._lock:
            return iter(list(self._tables))

    def __len__(self):
        with self._lock:
            return len(self._tables)

    def keys(self):
        with self._lock:
            return list(self._tables)

    def items(self):
        return [(t, self[t]) for t in self.keys()]

    def values(self):
        return [self[t] for t in self.keys()]
