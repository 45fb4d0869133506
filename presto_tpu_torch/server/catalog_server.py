"""Catalog server: connector metadata served over HTTP.

Counterpart of presto_tpu/server/catalog_server.py (presto-main-base/
.../catalogserver/ and RemoteMetadataManager: catalog metadata resolves
through a separate service, and scans stay with the data-bearing
connectors on the workers). `CatalogServer` serves this process's
connector registry (connectors/__init__.py::catalogs) read only:

  GET /v1/catalog                                  the catalog names
  GET /v1/catalog/{name}                           its tables' columns
  GET /v1/catalog/{name}/{table}/rowcount?sf=      a table's rows
  GET /v1/catalog/{name}/{table}/ndv/{column}?sf=  a column's distinct
                                                   values

`register_remote_catalog` installs a `RemoteCatalogProxy` under a
catalog name: its SCHEMA, table_row_count and column_distinct_count
come from the server (cached for a few seconds), so planning,
SHOW/DESCRIBE and the planner's statistics work against it, and a scan
through it is refused with the reference's message.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from .. import types as T
from ..utils.locks import OrderedLock

__all__ = ["CatalogServer", "RemoteCatalogProxy", "register_remote_catalog",
           "unregister_remote_catalog"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY, as on the port's other servers
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        from ..connectors import catalog, catalogs
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        query = self.path.partition("?")[2]
        params = dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)
        try:
            if parts == ["v1", "catalog"]:
                return self._send({"catalogs": sorted(catalogs())})
            if len(parts) == 3 and parts[:2] == ["v1", "catalog"]:
                mod = catalog(parts[2])
                sch = getattr(mod, "SCHEMA", {})
                out = {t: {c: str(ty) for c, ty in dict(cols).items()}
                       for t, cols in
                       ((t, sch[t]) for t in list(sch))}
                return self._send({"schema": out})
            if len(parts) == 5 and parts[:2] == ["v1", "catalog"] and \
                    parts[4] == "rowcount":
                mod = catalog(parts[2])
                sf = float(params.get("sf", "0"))
                return self._send(
                    {"rows": int(mod.table_row_count(parts[3], sf))})
            if len(parts) == 6 and parts[:2] == ["v1", "catalog"] and \
                    parts[4] == "ndv":
                mod = catalog(parts[2])
                fn = getattr(mod, "column_distinct_count", None)
                if fn is None:
                    return self._send({"ndv": None})
                sf = float(params.get("sf", "0"))
                return self._send({"ndv": fn(parts[3], parts[5], sf)})
            return self._send({"error": "not found"}, 404)
        except KeyError as e:
            return self._send({"error": str(e)}, 404)
        except Exception as e:  # noqa: BLE001
            return self._send({"error": f"{type(e).__name__}: {e}"}, 500)


class CatalogServer:
    def __init__(self, port: int = 0):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CatalogServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class RemoteCatalogProxy:
    """RemoteMetadataManager analog: the connector metadata surface,
    HTTP-delegated with a small TTL cache (metadata reads are hot in
    planning)."""

    def __init__(self, server_url: str, remote_name: str,
                 timeout: float = 10.0, cache_ttl_s: float = 5.0):
        self.base = server_url.rstrip("/")
        self.remote_name = remote_name
        self.timeout = timeout
        self.cache_ttl_s = cache_ttl_s
        self._cache: Dict[str, tuple] = {}
        self._lock = OrderedLock("catalog_server.RemoteCatalogProxy._lock")
        self.SCHEMA = _RemoteSchema(self)

    def _get(self, path: str) -> dict:
        import time
        with self._lock:
            hit = self._cache.get(path)
            if hit is not None and time.time() - hit[0] < self.cache_ttl_s:
                return hit[1]
        with urllib.request.urlopen(self.base + path,
                                    timeout=self.timeout) as r:
            doc = json.loads(r.read())
        with self._lock:
            self._cache[path] = (time.time(), doc)
        return doc

    def _schema_doc(self) -> Dict[str, Dict[str, str]]:
        return self._get(f"/v1/catalog/{self.remote_name}")["schema"]

    def table_row_count(self, table: str, sf: float = 0.0) -> int:
        return self._get(f"/v1/catalog/{self.remote_name}/{table}"
                         f"/rowcount?sf={sf}")["rows"]

    def column_distinct_count(self, table: str, column: str,
                              sf: float = 0.0):
        ndv = self._get(f"/v1/catalog/{self.remote_name}/{table}/ndv/"
                        f"{column}?sf={sf}")["ndv"]
        if ndv is None:
            raise KeyError(column)
        return ndv

    def generate_batch(self, *a, **kw):
        raise NotImplementedError(
            "remote catalogs serve METADATA; scans run on workers with "
            "the data-bearing connector (catalogserver semantics)")

    generate_columns = generate_batch
    generate_nulls = generate_batch


class _RemoteSchema:
    def __init__(self, proxy: RemoteCatalogProxy):
        self._p = proxy

    def _doc(self):
        return self._p._schema_doc()

    def __getitem__(self, table):
        return {c: T.parse_type(sig)
                for c, sig in self._doc()[table].items()}

    def __contains__(self, table):
        return table in self._doc()

    def __iter__(self):
        return iter(sorted(self._doc()))

    def __len__(self):
        return len(self._doc())

    def keys(self):
        return sorted(self._doc())

    def items(self):
        return [(t, self[t]) for t in self.keys()]

    def values(self):
        return [self[t] for t in self.keys()]


def register_remote_catalog(name: str, server_url: str,
                            remote_name: Optional[str] = None
                            ) -> RemoteCatalogProxy:
    """Install catalog `name` backed by a catalog server's
    `remote_name` (default: same name)."""
    from ..connectors import catalogs
    proxy = RemoteCatalogProxy(server_url, remote_name or name)
    catalogs()[name] = proxy
    return proxy


def unregister_remote_catalog(name: str) -> None:
    from ..connectors import catalogs
    cats = catalogs()
    if isinstance(cats.get(name), RemoteCatalogProxy):
        del cats[name]
